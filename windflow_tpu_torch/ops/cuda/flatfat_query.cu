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
//
// Third entry, wf_flatfat_build_query: the FFAT rebuild lane's whole
// launch -- build a tree over the launch's flat buffer, answer every
// window, drop the tree -- in one cooperative launch.  It replaces the
// reference's jitted `_ffat_program` / `_ffat_pallas_program`
// (windflow_tpu/ops/window_compute.py:224, :282: the XLA level sweep,
// then the XLA or Pallas query, then where(valid, out, 0)), which the
// port had run as ~40 eager launches (a fill, a leaf copy, two launches
// a level, the query, the where).
//
//   out[b] = fold(combine, leaves[s_b, e_b))  if e_b > s_b (raw extents)
//            else 0;  extents clamped to [0, n], a clamped-empty one
//            gives the neutral, as the query kernel above.
//
// (1) Blocks loop over tiles of 1,024 leaves: a 16-byte load a thread,
// the tile's ten levels built in shared memory, written to a per-launch
// scratch array of the n inner nodes (heap indices; the leaves are not
// copied: the walk reads them from the input).  A node is always
// op(left child, right child), as build_tree's level sweep computes it,
// so the tree is bitwise the plain version's for every combine.
// (2) One grid.sync().  (Past 2^21 leaves the tile roots are themselves
// tiled, a sync a round, until at most kTopMax roots are left.)  Every
// block then rebuilds the top levels from the tile roots in its own
// shared memory: no sync a level, and no block waits on another.
// (3) A thread per window walks the tree as the query kernel does, with
// separate left and right accumulators: the ten levels inside a tile
// are loaded up front (20 independent loads, one latency instead of
// twenty), the levels above from shared memory.  Nodes written by this
// launch are read with __ldcg (L2), never __ldg.  Windows are split
// evenly over the grid so every block walks a share.
//
// Bound: bytes.  The least a launch must move is the leaves read, the
// extents read and the output written once (573,440 B at the rebuild
// lane's 2^17 leaves and 4,096 windows: 0.17 us at 3.35 TB/s); the
// scratch nodes (n floats, written once and read from L2) come on top.
// What sets the time is the launch, one grid-wide barrier and the
// walk's latency, not the bytes.  A cooperative launch keeps every block
// resident, so the barrier cannot deadlock; the grid is capped at the
// card's co-resident block count and blocks loop over tiles and windows,
// so no input needs a larger grid.
#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------------
// fused tree build + range query (the rebuild lane)
// ---------------------------------------------------------------------------

constexpr int kTileLevels = 10;
constexpr int kTile = 1 << kTileLevels;    // level nodes a tile covers
constexpr int kBuildThreads = kTile / 4;   // one float4 a thread
constexpr int kTopMax = 2048;              // tile roots kept in shared memory
constexpr int kWalksPerBlock = 32;         // windows a block takes, at least

// The ten levels above one tile of kTile nodes of a level: src[i] is the
// tile's i-th node, tile t's root is global node m_dst + t.  Local node
// j (root 1) at depth d is global ((m_dst + t) << d) + (j - 2^d).
template <typename Op>
__device__ __forceinline__ void build_tile(const float* src, bool coherent,
                                           float* nodes, int m_dst, int t,
                                           float* sh, const Op& op) {
  const float4* s4 = reinterpret_cast<const float4*>(src) +
                     static_cast<int64_t>(t) * (kTile / 4) + threadIdx.x;
  const float4 v = coherent ? __ldcg(s4) : __ldg(s4);
  sh[kTile / 2 + 2 * threadIdx.x] = op(v.x, v.y);
  sh[kTile / 2 + 2 * threadIdx.x + 1] = op(v.z, v.w);
  for (int half = kTile / 4; half >= 1; half >>= 1) {
    __syncthreads();
    for (int j = half + threadIdx.x; j < 2 * half; j += kBuildThreads)
      sh[j] = op(sh[2 * j], sh[2 * j + 1]);
  }
  __syncthreads();
  for (int j = 1 + threadIdx.x; j < kTile; j += kBuildThreads) {
    const int d = 31 - __clz(j);
    nodes[((m_dst + t) << d) + (j - (1 << d))] = sh[j];
  }
  __syncthreads();  // sh is the next tile's
}

// se: int32 [2, B] (starts, then ends); nodes: scratch [n] (inner nodes
// at heap indices 1..n-1); n a power of two >= 2 kTile.
template <typename Op>
__global__ void __launch_bounds__(kBuildThreads)
flatfat_build_query_kernel(const float* __restrict__ leaves, int n,
                           int levels, const int32_t* __restrict__ se,
                           int n_windows, float* nodes,
                           float* __restrict__ out, float neutral) {
  __shared__ float sh[2 * kTopMax];  // a tile's nodes, then the top tree
  const Op op;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  // 1. tiles, kTileLevels levels a round, until <= kTopMax roots are left
  int m = n;
  const float* src = leaves;
  bool coherent = false;  // the leaves are input; later rounds read nodes
  do {
    const int m_dst = m / kTile;
    for (int t = blockIdx.x; t < m_dst; t += gridDim.x)
      build_tile(src, coherent, nodes, m_dst, t, sh, op);
    grid.sync();
    m = m_dst;
    src = nodes + m;
    coherent = true;
  } while (m > kTopMax);

  // 2. the top tree (global nodes 1 .. 2m-1) in this block's shared memory
  const int top = 2 * m;
  for (int i = threadIdx.x; i < m; i += kBuildThreads)
    sh[m + i] = __ldcg(nodes + m + i);
  for (int half = m / 2; half >= 1; half >>= 1) {
    __syncthreads();
    for (int j = half + threadIdx.x; j < 2 * half; j += kBuildThreads)
      sh[j] = op(sh[2 * j], sh[2 * j + 1]);
  }
  __syncthreads();

  // 3. the walks, an even share of the windows a block
  const int64_t per = (n_windows + gridDim.x - 1) / gridDim.x;
  const int b1 = static_cast<int>(
      min(static_cast<int64_t>(n_windows), (blockIdx.x + 1) * per));
  for (int b = static_cast<int>(blockIdx.x * per) + threadIdx.x; b < b1;
       b += kBuildThreads) {
    const int s_raw = __ldg(se + b);
    const int e_raw = __ldg(se + n_windows + b);
    if (e_raw <= s_raw) {  // the engine's where(valid, out, 0)
      out[b] = 0.0f;
      continue;
    }
    const int s = s_raw < 0 ? 0 : (s_raw > n ? n : s_raw);
    const int e = e_raw < 0 ? 0 : (e_raw > n ? n : e_raw);
    if (e <= s) {
      out[b] = neutral;
      continue;
    }
    int lo = s + n;
    int hi = e + n;
    // the levels inside a tile: every load issued before the first use
    float lv[kTileLevels], rv[kTileLevels];
    bool tl[kTileLevels], tr[kTileLevels];
#pragma unroll
    for (int k = 0; k < kTileLevels; ++k) {
      tl[k] = lo < hi && (lo & 1);
      const int il = lo;
      if (tl[k]) ++lo;
      tr[k] = lo < hi && (hi & 1);
      if (tr[k]) --hi;
      const int ir = hi;
      lv[k] = !tl[k] ? 0.0f : (k == 0 ? __ldg(leaves + (il - n))
                                      : __ldcg(nodes + il));
      rv[k] = !tr[k] ? 0.0f : (k == 0 ? __ldg(leaves + (ir - n))
                                      : __ldcg(nodes + ir));
      lo >>= 1;
      hi >>= 1;
    }
    float left = neutral;
    float right = neutral;
#pragma unroll
    for (int k = 0; k < kTileLevels; ++k) {
      if (tl[k]) left = op(left, lv[k]);
      if (tr[k]) right = op(rv[k], right);
    }
    // the levels above: shared memory (scratch only between tiling rounds)
    for (int k = kTileLevels; k <= levels; ++k) {
      if (lo < hi && (lo & 1)) {
        left = op(left, lo < top ? sh[lo] : __ldcg(nodes + lo));
        ++lo;
      }
      if (lo < hi && (hi & 1)) {
        --hi;
        right = op(hi < top ? sh[hi] : __ldcg(nodes + hi), right);
      }
      lo >>= 1;
      hi >>= 1;
    }
    out[b] = op(left, right);
  }
}

constexpr int kMaxDevices = 64;

template <typename Op>
int launch_build_query(const float* leaves, int n, int levels,
                       const int32_t* se, int n_windows, float* nodes,
                       float* out, float neutral, cudaStream_t stream) {
  // co-resident blocks of this instantiation, once per device
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < 0 || dev >= kMaxDevices) return -2;
  if (resident[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flatfat_build_query_kernel<Op>, kBuildThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (per_sm * sms <= 0)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    resident[dev] = per_sm * sms;
  }
  int blocks = n / kTile;
  const int walk_blocks = (n_windows + kWalksPerBlock - 1) / kWalksPerBlock;
  if (walk_blocks > blocks) blocks = walk_blocks;
  if (blocks > resident[dev]) blocks = resident[dev];
  void* args[] = {&leaves, &n, &levels, &se, &n_windows, &nodes, &out,
                  &neutral};
  rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(flatfat_build_query_kernel<Op>),
      dim3(blocks), dim3(kBuildThreads), args, 0, stream);
  if (rc != cudaSuccess) cudaGetLastError();  // clear it for later launches
  return static_cast<int>(rc);
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

// The rebuild lane's launch: the tree over `leaves` [n] (n a power of
// two, 2048 <= n <= 2^30, 16-byte aligned) built into `nodes` [n]
// (scratch, this launch's alone), then every window of `se` [2, B]
// answered into `out` [B], in one cooperative launch.  op codes as
// wf_flatfat_query.  Launches on `stream`; returns the cudaError_t of
// the launch (0 = ok; cudaErrorCooperativeLaunchTooLarge when the card
// cannot hold the grid), -1 for an unknown op code, -2 for sizes the
// kernel does not take.
extern "C" int wf_flatfat_build_query(const float* leaves, int64_t n_leaves,
                                      const int32_t* se, int64_t n_windows,
                                      float* nodes, float* out, float neutral,
                                      int64_t op, cudaStream_t stream) {
  if (n_windows <= 0) return 0;
  if (n_leaves < 2 * kTile || n_leaves > (int64_t{1} << 30) ||
      (n_leaves & (n_leaves - 1)) || n_windows > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(leaves) & 15))
    return -2;
  const int n = static_cast<int>(n_leaves);
  const int lv = 31 - __builtin_clz(static_cast<unsigned>(n));
  const int b = static_cast<int>(n_windows);
  switch (op) {
    case 0:
      return launch_build_query<AddOp>(leaves, n, lv, se, b, nodes, out,
                                       neutral, stream);
    case 1:
      return launch_build_query<MaxOp>(leaves, n, lv, se, b, nodes, out,
                                       neutral, stream);
    case 2:
      return launch_build_query<MinOp>(leaves, n, lv, se, b, nodes, out,
                                       neutral, stream);
    case 3:
      return launch_build_query<LeftWeightedOp>(leaves, n, lv, se, b, nodes,
                                                out, neutral, stream);
    default:
      return -1;
  }
}
