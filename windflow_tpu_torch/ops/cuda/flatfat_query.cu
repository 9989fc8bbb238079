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
//
// Second entry, wf_flatfat_update_query: the resident lanes' whole step
// in one launch.  It replaces the reference's fused XLA program
// `_batched_programs.update_runs_and_query` (windflow_tpu/ops/
// flatfat_jax.py:188-207: run expansion, root-path scatter rounds, then
// the Pallas/XLA query walk), which the port had run as ~120 eager torch
// launches.  One block per forest row the launch touches; a block
// (1) writes its runs' new leaves into the row in place (a run that
// crosses the ring's end is split into [s, n) and [0, s+len-n)),
// (2) recomputes their root paths level by level -- each dirty node
// interval [lo, hi) becomes [lo>>1, ((hi-1)>>1)+1), with __syncthreads
// between levels; two runs that share a parent write the same value --
// and (3) answers the row's windows against the post-update row.  A
// block touches no other row, so no grid-wide sync is needed.  A window
// arrives as (start mod n, length); one that wraps folds [s, n) and
// [0, e-n) as two pieces and combines them in time order, exactly as the
// reference combines its two pieces, so the non-commutative (and
// non-associative) left_weighted rounds alike.  The walk reads nodes the
// block has just written, so it uses plain loads after __syncthreads,
// never the non-coherent __ldg path.  Bound: latency (levels dependent
// rounds, then a dependent walk); the bytes are the new values, the
// descriptors, the dirty nodes written once and the clean nodes read
// once (siblings on the root paths, nodes the walks take) -- tens of KB
// a step on the lanes.
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

// ---------------------------------------------------------------------------
// fused root-path update + range query
// ---------------------------------------------------------------------------

constexpr int kFusedThreads = 256;

// One piece [s, e) of a row (0 <= s <= e <= n): the bit-walk of
// flatfat_query_kernel, with plain loads.
template <typename Op>
__device__ __forceinline__ float walk_piece(const float* t, int n, int levels,
                                            int s, int e, float neutral,
                                            const Op& op) {
  if (e <= s) return neutral;
  int lo = s + n;
  int hi = e + n;
  float left = neutral;
  float right = neutral;
  for (int step = 0; step <= levels; ++step) {
    if (lo < hi && (lo & 1)) {
      left = op(left, t[lo]);
      ++lo;
    }
    if (lo < hi && (hi & 1)) {
      --hi;
      right = op(t[hi], right);
    }
    lo >>= 1;
    hi >>= 1;
  }
  return op(left, right);
}

// A run the kernel takes: inside the ring and the values (any other is
// skipped, so no input makes the kernel write outside its row).
__device__ __forceinline__ bool run_ok(int s, int len, int vo, int n,
                                       int n_values) {
  return s >= 0 && s < n && len > 0 && len <= n && vo >= 0 &&
         vo <= n_values - len;
}

// Recompute nodes [lo, hi) of one level from their children.
template <typename Op>
__device__ __forceinline__ void sweep(float* t, int lo, int hi,
                                      const Op& op) {
  for (int i = lo + static_cast<int>(threadIdx.x); i < hi; i += blockDim.x)
    t[i] = op(t[2 * i], t[2 * i + 1]);
}

// groups: group_row[G] | run_ptr[G+1] | q_ptr[G+1] (CSR over the rows);
// runs: [3, R] = start mod n, length, value offset;
// queries: [3, Q] = start mod n, length, out index.
template <typename Op>
__global__ void __launch_bounds__(kFusedThreads)
flatfat_update_query_kernel(float* __restrict__ forest, int n, int levels,
                            int64_t n_rows, const int32_t* __restrict__ groups,
                            int n_groups, const int32_t* __restrict__ runs,
                            int n_runs, const int32_t* __restrict__ queries,
                            int n_queries, const float* __restrict__ values,
                            int n_values, float* __restrict__ out,
                            float neutral) {
  const Op op;
  const int g = blockIdx.x;
  const int64_t row = groups[g];
  const int* run_ptr = groups + n_groups;
  const int* q_ptr = run_ptr + n_groups + 1;
  const int r0 = run_ptr[g], r1 = run_ptr[g + 1];
  const int q0 = q_ptr[g], q1 = q_ptr[g + 1];
  const int32_t* r_start = runs;
  const int32_t* r_len = runs + n_runs;
  const int32_t* r_voff = runs + 2 * n_runs;
  const int32_t* q_start = queries;
  const int32_t* q_len = queries + n_queries;
  const int32_t* q_out = queries + 2 * n_queries;
  if (row < 0 || row >= n_rows) {  // outside the forest: touch nothing
    for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x)
      if (q_out[q] >= 0 && q_out[q] < n_queries) out[q_out[q]] = nanf("");
    return;
  }
  float* t = forest + row * 2 * static_cast<int64_t>(n);

  // 1. new leaves, run by run: a later run of the row overwrites an
  // earlier one
  for (int r = r0; r < r1; ++r) {
    const int s = r_start[r], len = r_len[r], vo = r_voff[r];
    if (!run_ok(s, len, vo, n, n_values)) continue;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      int p = s + i;
      if (p >= n) p -= n;
      t[n + p] = values[vo + i];
    }
    __syncthreads();
  }

  // 2. root paths, one level a round: the leaf intervals [n+s, n+min(e,n))
  // and, for a run past the ring's end, [n, n+e-n), shifted up a level.
  for (int lev = 1; lev <= levels; ++lev) {
    for (int r = r0; r < r1; ++r) {
      const int s = r_start[r], len = r_len[r];
      if (!run_ok(s, len, r_voff[r], n, n_values)) continue;
      const int e = s + len;  // <= 2n - 1
      const int a_hi = n + (e < n ? e : n);
      sweep(t, (n + s) >> lev, ((a_hi - 1) >> lev) + 1, op);
      if (e > n) sweep(t, n >> lev, ((e - 1) >> lev) + 1, op);
    }
    __syncthreads();
  }
  if (q1 <= q0) return;

  // 3. every window of the row against the post-update row (plain
  // loads: the block wrote it)
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    const int o = q_out[q];
    if (o < 0 || o >= n_queries) continue;
    const int s = q_start[q], len = q_len[q];
    float res;
    if (s < 0 || s >= n || len > n) {
      res = nanf("");
    } else if (len <= 0) {
      res = neutral;
    } else if (s + len < n) {
      res = walk_piece(t, n, levels, s, s + len, neutral, op);
    } else {  // wraps (or ends at n): tail then head, in time order
      res = op(walk_piece(t, n, levels, s, n, neutral, op),
               walk_piece(t, n, levels, 0, s + len - n, neutral, op));
    }
    out[o] = res;
  }
}

template <typename Op>
int launch_fused(float* forest, int n, int levels, int64_t n_rows,
                 const int32_t* groups, int n_groups, const int32_t* runs,
                 int n_runs, const int32_t* queries, int n_queries,
                 const float* values, int n_values, float* out,
                 float neutral, cudaStream_t stream) {
  flatfat_update_query_kernel<Op><<<n_groups, kFusedThreads, 0, stream>>>(
      forest, n, levels, n_rows, groups, n_groups, runs, n_runs, queries,
      n_queries, values, n_values, out, neutral);
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

// The resident lanes' step: new leaves, their root paths, then every
// window, in one launch of one block per group (forest row).  `groups`,
// `runs` and `queries` are laid out as flatfat_update_query_kernel reads
// them.  op codes as wf_flatfat_query.  Launches
// on `stream`; returns the cudaError_t of the launch (0 = ok), -1 for an
// unknown op code, -2 for sizes the kernel does not take.
extern "C" int wf_flatfat_update_query(
    float* forest, int64_t n_leaves, int64_t levels, int64_t n_rows,
    const int32_t* groups, int64_t n_groups, const int32_t* runs,
    int64_t n_runs, const int32_t* queries, int64_t n_queries,
    const float* values, int64_t n_values, float* out, float neutral,
    int64_t op, cudaStream_t stream) {
  if (n_groups <= 0) return 0;
  if (n_leaves < 2 || n_leaves > (1 << 29) || n_groups > 0x7fffffff ||
      n_runs > 0x7fffffff || n_queries > 0x7fffffff ||
      n_values > 0x7fffffff)
    return -2;
  const int n = static_cast<int>(n_leaves), lv = static_cast<int>(levels);
  const int g = static_cast<int>(n_groups), r = static_cast<int>(n_runs);
  const int q = static_cast<int>(n_queries), v = static_cast<int>(n_values);
  switch (op) {
    case 0:
      return launch_fused<AddOp>(forest, n, lv, n_rows, groups, g, runs, r,
                                 queries, q, values, v, out, neutral, stream);
    case 1:
      return launch_fused<MaxOp>(forest, n, lv, n_rows, groups, g, runs, r,
                                 queries, q, values, v, out, neutral, stream);
    case 2:
      return launch_fused<MinOp>(forest, n, lv, n_rows, groups, g, runs, r,
                                 queries, q, values, v, out, neutral, stream);
    case 3:
      return launch_fused<LeftWeightedOp>(forest, n, lv, n_rows, groups, g,
                                          runs, r, queries, q, values, v, out,
                                          neutral, stream);
    default:
      return -1;
  }
}
