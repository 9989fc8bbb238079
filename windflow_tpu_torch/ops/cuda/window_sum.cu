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
// the engine's packed int32 [2, B] array, out is f32 [B].  Extents are
// clamped to [0, T]; an empty one sums to 0.
//
// Two forms, picked by the caller from the batch's widest extent (the
// reference engine switches its XLA programs at the same 32,
// `_TILE_MAX_W`); either form is right for any extent, the choice only
// sets the speed:
//
// * short extents (<= 32: the headline's 2-pane partials, mean_panes'
//   counts): a thread per window, 256 windows a block, reading se[0] and
//   se[1] coalesced and summing its few values left to right.  A warp
//   per window left 30 of 32 lanes idle and needed 8x the blocks.
// * longer extents (the pane-rebuild cell's 64 panes, raw-tuple
//   windows of thousands): a warp per window.  A scalar head up to the
//   first 16-byte boundary, then a float4 body, four loads a lane in
//   flight into two float4 accumulators (eight independent add chains),
//   then a scalar tail, all on 32-bit indices through __ldg; a
//   __shfl_xor_sync tree folds the lanes.
//
// Both sum each window directly (no prefix-sum differencing) in a fixed
// order with no atomics, so a result does not change from run to run and
// integer data below 2^24 is exact.  The order differs from the plain
// version's (and from the single-accumulator loop this kernel had
// before), so random f32 agrees to rounding, within rtol 1e-5.
//
// Bound: memory.  The work is one add per element inside the extents;
// the least bytes are the extents (8 B/window), the output (4 B/window)
// and each value the windows touch, read once.  Overlapping windows
// re-read shared values, which the 50 MB L2 serves at the main path's
// sizes.  At the headline's 4,096 two-element windows the bytes are
// ~0.02 us of HBM time and the launch itself is the floor.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__global__ void __launch_bounds__(kThreads)
window_sum_thread_kernel(const float* __restrict__ values, int n_values,
                         const int32_t* __restrict__ se,
                         float* __restrict__ out, int n_windows) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_windows) return;
  const int s = max(__ldg(se + b), 0);
  const int e = min(__ldg(se + n_windows + b), n_values);
  float acc = 0.0f;
  for (int i = s; i < e; ++i) acc += __ldg(values + i);
  out[b] = acc;
}

__global__ void __launch_bounds__(kThreads)
window_sum_warp_kernel(const float* __restrict__ values, int n_values,
                       const int32_t* __restrict__ se,
                       float* __restrict__ out, int n_windows) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_windows) return;  // b is uniform across the warp
  const int s = max(__ldg(se + b), 0);
  const int e = min(__ldg(se + n_windows + b), n_values);
  float acc = 0.0f;
  if (s < e) {
    // head: [s, a), a the first index on a 16-byte boundary (<= 3 values)
    const int mis =
        static_cast<int>((reinterpret_cast<uintptr_t>(values + s) >> 2) & 3);
    const int a = min(e, mis ? s + 4 - mis : s);
    if (s + lane < a) acc = __ldg(values + s + lane);
    // body: float4s [0, nb) from a
    const float4* p = reinterpret_cast<const float4*>(values + a);
    const int nb = (e - a) >> 2;
    float4 c0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 c1 = c0;
    int i = lane;
    for (; i + 96 < nb; i += 128) {
      const float4 u0 = __ldg(p + i);
      const float4 u1 = __ldg(p + i + 32);
      const float4 u2 = __ldg(p + i + 64);
      const float4 u3 = __ldg(p + i + 96);
      add4(c0, u0);
      add4(c1, u1);
      add4(c0, u2);
      add4(c1, u3);
    }
    for (; i < nb; i += 32) add4(c0, __ldg(p + i));
    // tail: the last (e - a) mod 4 values
    const int t = a + 4 * nb + lane;
    if (t < e) acc += __ldg(values + t);
    acc += ((c0.x + c0.y) + (c0.z + c0.w)) + ((c1.x + c1.y) + (c1.z + c1.w));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[b] = acc;
}

}  // namespace

// form: 0 a warp per window (any extent), 1 a thread per window (short
// extents).  Launches on `stream`; returns the cudaError_t of the launch
// (0 = ok), -1 for an unknown form.
extern "C" int wf_window_sum(const float* values, int64_t n_values,
                             const int32_t* se, float* out, int n_windows,
                             int form, cudaStream_t stream) {
  if (n_windows <= 0) return 0;
  // extents are int32, so no end reaches past 2^31 - 1
  const int nv = n_values > 0x7fffffff ? 0x7fffffff
                                       : static_cast<int>(n_values);
  if (form == 1) {
    const int blocks = (n_windows + kThreads - 1) / kThreads;
    window_sum_thread_kernel<<<blocks, kThreads, 0, stream>>>(
        values, nv, se, out, n_windows);
  } else if (form == 0) {
    const int blocks = (n_windows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    window_sum_warp_kernel<<<blocks, kThreads, 0, stream>>>(
        values, nv, se, out, n_windows);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
