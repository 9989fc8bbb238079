// Batched window sum over a flat buffer, for Hopper (sm_90a).
//
//   out[b] = sum(values[se[0][b] : se[1][b]])      (empty extent -> 0)
//
// Replaces the Pallas TPU kernel windflow_tpu/ops/pallas/window_sum.py
// (`_build`'s kernel; entry points `window_sums` / `window_sums_device`).
// The TPU kernel ran one sequential grid program per window over
// (T/128, 128) lane rows and wrote a padded [ceil8(B), 128] output; both
// the lane rows and the padding exist only for the TPU's (8, 128)
// tiling and are dropped here: values is a flat f32 [T], the extents are
// the engine's packed int32 [2, B] array, out is f32 [B].
//
// Design: one warp per window, kWarpsPerBlock windows per 256-thread
// block.  Lanes stride through [start, end) so each warp-wide load is
// 32 consecutive floats (one 128-byte line), accumulate in f32, and a
// __shfl_down_sync tree folds the warp; lane 0 writes out[b].  The sum
// is taken directly over the window (no prefix-sum differencing), so
// on integer-valued data below 2^24 it is exact.
//
// Bound: memory.  The work is one add per element inside the extents;
// the least bytes are the extents (8 B/window), the output (4 B/window)
// and each value the windows touch, read once.  Overlapping windows
// re-read shared values, which the 50 MB L2 absorbs at the main path's
// sizes.  TMA/wider loads and a block per window for long extents are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__global__ void __launch_bounds__(kThreads)
window_sum_kernel(const float* __restrict__ values, int64_t n_values,
                  const int32_t* __restrict__ se, float* __restrict__ out,
                  int n_windows) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_windows) return;  // b is uniform across the warp
  // clamp to the buffer: an out-of-range extent never reads outside it
  int64_t start = se[b];
  int64_t end = se[n_windows + b];
  start = start < 0 ? 0 : start;
  end = end > n_values ? n_values : end;
  float acc = 0.0f;
  for (int64_t i = start + lane; i < end; i += 32) acc += __ldg(values + i);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[b] = acc;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int wf_window_sum(const float* values, int64_t n_values,
                             const int32_t* se, float* out, int n_windows,
                             cudaStream_t stream) {
  if (n_windows <= 0) return 0;
  const int blocks = (n_windows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  window_sum_kernel<<<blocks, kThreads, 0, stream>>>(values, n_values, se,
                                                      out, n_windows);
  return static_cast<int>(cudaGetLastError());
}
