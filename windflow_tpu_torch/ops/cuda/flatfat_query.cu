// Batched FlatFAT range query over a forest of heap-layout trees, for
// Hopper (sm_90a).
//
//   out[b] = fold(combine, leaves [starts[b], ends[b]) of tree rows[b])
//                                               (end <= start -> neutral)
//
// Replaces the Pallas TPU kernel windflow_tpu/ops/pallas/flatfat_query.py
// (`_build`'s kernel; entry point `flatfat_query_ranges`).  The TPU
// kernel ran one sequential grid program per window with the whole tree
// resident in VMEM as (2n/128, 128) lane rows, loaded each node as a
// dynamic row plus a one-hot lane extract, and wrote a padded
// [ceil8(B), 128] output.  Here the forest stays in device memory as a
// flat f32 [K, 2n] array (root at 1, leaves at [n, 2n) of each row), the
// extents are int32 [B], the optional row ids int32 [B], and out is
// f32 [B] with no padding.  The rebuild lane's single tree is K = 1 with
// no row ids.
//
// Design: one thread per window, as in the reference's
// ComputeResults_Kernel (flatfat_gpu.hpp:92-135).  Each thread walks the
// tree bottom-up for levels + 1 steps with separate left and right
// accumulators, so a non-commutative combine keeps oldest -> newest
// order.  A node is loaded only when its branch is taken (the Pallas
// kernel's unconditional load of node max(hi - 1, 0) would read outside
// a row here); extents are clamped to [0, n] and an out-of-range row id
// writes NaN, so no input makes the kernel read outside the forest.
//
// The combine is a compile-time functor: a Python callable cannot run
// in a CUDA kernel.  Instantiated for add, max and min (NaN-propagating,
// as torch.maximum / torch.minimum), and for the reference tests'
// non-commutative left_weighted(a, b) = 0.5 a + b, reached only through
// its private op code to show on the card that the walk keeps order.
//
// Bound: memory latency.  Per window the walk reads at most 2 (levels+1)
// scattered nodes (one 4-byte load per 32-byte sector) and does as many
// combines; the least bytes are the extents, row ids and output plus
// each distinct node the windows need, read once.  Windows over one key
// share their upper nodes, which the 50 MB L2 holds.  Coalescing the
// walk (a warp per window group, shared-memory staging of hot upper
// levels) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct AddOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return (a > b || isnan(a)) ? a : b;
  }
};

struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return (a < b || isnan(a)) ? a : b;
  }
};

// 0.5 * a is exact, so the fused and the unfused form round alike
struct LeftWeightedOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return __fadd_rn(__fmul_rn(a, 0.5f), b);
  }
};

template <typename Op>
__global__ void __launch_bounds__(kThreads)
flatfat_query_kernel(const float* __restrict__ tree, int64_t n_leaves,
                     int levels, int64_t n_rows,
                     const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ ends,
                     float* __restrict__ out, int64_t n_windows,
                     float neutral) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= n_windows) return;
  const Op op;
  int64_t row = rows != nullptr ? rows[b] : 0;
  if (row < 0 || row >= n_rows) {
    out[b] = nanf("");
    return;
  }
  int64_t s = starts[b];
  int64_t e = ends[b];
  s = s < 0 ? 0 : (s > n_leaves ? n_leaves : s);
  e = e < 0 ? 0 : (e > n_leaves ? n_leaves : e);
  if (e <= s) {
    out[b] = neutral;
    return;
  }
  const float* t = tree + row * 2 * n_leaves;
  int64_t lo = s + n_leaves;
  int64_t hi = e + n_leaves;
  float left = neutral;
  float right = neutral;
  for (int step = 0; step <= levels; ++step) {
    if (lo < hi && (lo & 1)) {
      left = op(left, __ldg(t + lo));
      ++lo;
    }
    if (lo < hi && (hi & 1)) {
      --hi;
      right = op(__ldg(t + hi), right);
    }
    lo >>= 1;
    hi >>= 1;
  }
  out[b] = op(left, right);
}

template <typename Op>
int launch(const float* tree, int64_t n_leaves, int levels, int64_t n_rows,
           const int32_t* rows, const int32_t* starts, const int32_t* ends,
           float* out, int64_t n_windows, float neutral,
           cudaStream_t stream) {
  const int64_t blocks = (n_windows + kThreads - 1) / kThreads;
  flatfat_query_kernel<Op><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(tree, n_leaves, levels, n_rows, rows,
                                       starts, ends, out, n_windows,
                                       neutral);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op: 0 add, 1 max, 2 min, 3 left_weighted.  `rows` may be null (one
// tree).  Launches on `stream`; returns the cudaError_t of the launch
// (0 = ok), or -1 for an unknown op code.
extern "C" int wf_flatfat_query(const float* tree, int64_t n_leaves,
                                int64_t levels, int64_t n_rows,
                                const int32_t* rows, const int32_t* starts,
                                const int32_t* ends, float* out,
                                int64_t n_windows, float neutral, int64_t op,
                                cudaStream_t stream) {
  if (n_windows <= 0) return 0;
  const int lv = static_cast<int>(levels);
  switch (op) {
    case 0:
      return launch<AddOp>(tree, n_leaves, lv, n_rows, rows, starts, ends,
                           out, n_windows, neutral, stream);
    case 1:
      return launch<MaxOp>(tree, n_leaves, lv, n_rows, rows, starts, ends,
                           out, n_windows, neutral, stream);
    case 2:
      return launch<MinOp>(tree, n_leaves, lv, n_rows, rows, starts, ends,
                           out, n_windows, neutral, stream);
    case 3:
      return launch<LeftWeightedOp>(tree, n_leaves, lv, n_rows, rows, starts,
                                    ends, out, n_windows, neutral, stream);
    default:
      return -1;
  }
}
