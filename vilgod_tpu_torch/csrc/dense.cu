// Dense (all-pairs) neighbour kernels for Hopper (sm_90a): the CUDA port of
// the five dense Pallas kernels of vilgod_tpu/ops/pallas_kernels.py
//   dense_count      <- tile_radius_count   (pallas_kernels.py:93)
//                       and tile_radius_count3 (pallas_kernels.py:136)
//   dense_min_label  <- tile_min_label      (pallas_kernels.py:187)
//   dense_min_label_qd <- tile_min_label_qd (pallas_kernels.py:241)
//   dense_nearest    <- tile_nearest        (pallas_kernels.py:531)
//
// What they compute. Clouds are (8, N) float32, row-major (row c holds
// coordinate c of every point), invalid points at a far sentinel. Every
// query meets every data point. The squared distance is (q - d)^2 summed
// over rows 0..ndim-1 in that order, every product and sum rounded on its
// own (__fsub_rn / __fmul_rn / __fadd_rn, and the file builds with
// -fmad=false): the DBSCAN core levels are not nudged off the 5 mm
// lattice, so an FMA would flip pairs that sit exactly on them, and the
// plain PyTorch versions (vilgod_tpu_torch/ops/dense_kernels.py) must
// agree bit for bit.
//   count     per query, data points with dist2 <= r2 (self included);
//   count3    the same at three squared levels (in any order) -> (N, 3);
//   min_label per query, the minimum label over data points with
//             dist2 <= max(r2_q, r2_d), else big (mutual-reachability
//             linkage): dense_min_label over one cloud, dense_min_label_qd
//             a query block against a different data window;
//   nearest   per query, the least dist2 and the FIRST data index that
//             reaches it (Pallas: argmin within a tile, strict < across);
//             (inf, 0) where no dist2 is below inf (a NaN lane).
//
// What bounds them on the H100. 3 flops per coordinate and a compare per
// pair, no reuse beyond the pair, and a few MB of input: FP32 operations
// (67 TFLOP/s), not the 3.35 TB/s of HBM. With -fmad=false a pair costs
// about 10 FP32 issue slots at ndim 3, so the way under the all-pairs
// time is to leave pairs out, exactly.
//
// Kernels 6-9 (dense_count at one level and at three, dense_min_label,
// dense_nearest) run on the pair engine of span_engine.cuh (2 queries per
// thread, 16-byte broadcast loads of 4 data points, a cp.async double
// buffer) over the one span [0, nd), and decide whole tiles by bounding
// boxes first:
//  - box_kernel, launched first on the same stream, writes per warp query
//    group (64 lanes) and per 256-lane data chunk the per-coordinate min
//    and max over its lanes that are numbers in every coordinate (kernel
//    8's data boxes also only over lanes with label < big, which can
//    never lower a minimum), their largest radius2 and their count.
//  - The sentinel point (kernel 9's data). Every lane at the sentinel in
//    all ndim coordinates is the same point S. The border attach's data
//    holds its non-core lanes there, interleaved in the original order: a
//    box that took them in would span the cloud and decide nothing. So
//    kernel 9's data boxes leave those lanes out and count them (kSent);
//    S is a box of its own, taken into account where a chunk holds any.
//    The data order, and with it the lowest-index tie rule, is untouched.
//  - Per (query group, chunk) tile, tile_bounds gives L <= dist2 <= U for
//    every pair: the per-coordinate gap and reach of the two boxes, each
//    difference, square and sum rounded on its own in coordinate order.
//    Round-to-nearest is monotone and odd, so each pair's rounded
//    difference, square and sum stay between those of the boxes.
//  - Kernels 6 and 7 decide each level l_k of a tile: it adds nothing
//    where L > l_k, and the chunk's lane count to each query lane that is
//    a number where U <= l_k. A tile is skipped where no level adds
//    (kernel 6: L > r2), taken whole where every level is decided and one
//    adds (sentinel x sentinel tiles land here), and runs the pair loop,
//    which counts every level and adds nothing whole, otherwise. Kernel 8
//    skips a tile where L > max(the group's largest radius2, the chunk's).
//  - Kernel 9's threshold. nearest_bound_kernel gives each query group
//    T_g: per query lane that is a number the least U over the chunk boxes
//    (and S where a chunk holds it), each lane a box of one point, then
//    the largest over the group's lanes (-inf where it has none; those
//    lanes get (inf, 0) whatever runs). The chunk that attains a lane's
//    least U holds a point at most that far, so the lane's nearest dist2
//    is at most T_g. A tile is skipped where L > T_g strictly, and, where
//    its chunk holds S, S's own L > T_g too: every pair left out is then
//    strictly farther than its query's nearest, and every chunk holding a
//    point at the nearest distance (the first one and every tie) runs.
//  - Each block takes one chunk (blockIdx.y) against its 256 queries; each
//    warp decides the tile of its own group, so branches stay
//    warp-uniform. The block stages the chunk only when one of its warps
//    runs the pair loop, and returns at once when all four skip. The
//    blocks of one query block merge by atomicAdd into 0, atomicMin into
//    big (set by fill_kernel after the box pass), and for the nearest a
//    64-bit atomicMin on nearest_key (span_engine.cuh) into kNoNearest
//    (set by the bound pass), unpacked by nearest_unpack_kernel. One chunk
//    a block spreads the few tiles that need the pair loop over the most
//    blocks: runs of 2-32 chunks a block were slower on kernels 6 and 8
//    (PERF.md).
//  - On request (a non-null tiles), lane 0 of each warp writes its tile's
//    decision (kSkip, kWhole, kPairs) into tiles (G, C), which chip_smoke.py
//    holds against the torch mirror dense_kernels.tile_decisions.
//  - Ragged sizes: query lanes at or past nq load NaN (no compare holds;
//    nothing is written for them); nd must be a multiple of 4 with
//    16-byte aligned rows, which the wrapper ensures by padding with NaN
//    lanes (never with the sentinel: a sentinel meets a sentinel at
//    dist2 0).
//
// Kernel 12 (min_label_qd) is the first design, and its helpers (grid_for
// with a fixed 132-SM target, load_query_or0, stage, dist2, split_range)
// serve only it: one thread per query, 256 queries per block, the data
// streamed through shared memory 256 points at a time and split over
// gridDim.y, merged by atomicMin. Ragged N is masked on both axes.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError(). The
// wrapper allocates the outputs and the box scratch; dense_min_label_qd
// takes its output filled with big.

#include <stdint.h>

#include "span_engine.cuh"

namespace {

// ---- kernels 6-9: the engine with exact tile decisions by boxes ----

constexpr int kWarps = kThreads / 32;  // query groups per block
// a box: NDIM minima at [0, 6), maxima at [kMax, kMax + 6), the largest
// radius2 at kR2 (-inf: none; kernel 9's query groups: T_g), the lane
// count at kCount, the lanes at the sentinel left out of it at kSent
constexpr int kBox = 16, kMax = 6, kR2 = 12, kCount = 13, kSent = 14;
// a tile's decision, as dense_kernels.tile_decisions codes it
constexpr unsigned char kSkip = 0, kWhole = 1, kPairs = 2;
// kernel 9's bound pass stages this many chunk boxes at a time
constexpr int kBoundChunks = 256;

template <int NDIM>
struct Box {
  float lo[NDIM], hi[NDIM], r2;
  int count, sent;
};

template <int NDIM>
__device__ __forceinline__ void box_empty(Box<NDIM>& b) {
#pragma unroll
  for (int c = 0; c < NDIM; ++c) {
    b.lo[c] = INFINITY;
    b.hi[c] = -INFINITY;
  }
  b.r2 = -INFINITY;
  b.count = 0;
  b.sent = 0;
}

// Lane i of the cloud p (n lanes) joins the box when it is in range, all
// its coordinates are numbers, (with labels) its label is below big and it
// is not at the sentinel in every coordinate (a NaN sentinel: none is);
// a lane at the sentinel is counted apart.
template <int NDIM>
__device__ __forceinline__ void box_add(Box<NDIM>& b, const float* __restrict__ p,
                                        int n, int i, const float* radius2,
                                        const int* labels, int big,
                                        float sentinel) {
  if (i >= n || (labels != nullptr && labels[i] >= big)) return;
  float x[NDIM];
  bool ok = true, at_s = true;
#pragma unroll
  for (int c = 0; c < NDIM; ++c) {
    x[c] = p[(size_t)c * n + i];
    ok &= x[c] == x[c];
    at_s &= x[c] == sentinel;
  }
  if (!ok) return;
  if (at_s) {
    b.sent += 1;
    return;
  }
#pragma unroll
  for (int c = 0; c < NDIM; ++c) {
    b.lo[c] = fminf(b.lo[c], x[c]);
    b.hi[c] = fmaxf(b.hi[c], x[c]);
  }
  if (radius2 != nullptr) b.r2 = fmaxf(b.r2, radius2[i]);
  b.count += 1;
}

template <int NDIM>
__device__ __forceinline__ void box_warp_reduce(Box<NDIM>& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < NDIM; ++c) {
      b.lo[c] = fminf(b.lo[c], __shfl_xor_sync(0xffffffffu, b.lo[c], off));
      b.hi[c] = fmaxf(b.hi[c], __shfl_xor_sync(0xffffffffu, b.hi[c], off));
    }
    b.r2 = fmaxf(b.r2, __shfl_xor_sync(0xffffffffu, b.r2, off));
    b.count += __shfl_xor_sync(0xffffffffu, b.count, off);
    b.sent += __shfl_xor_sync(0xffffffffu, b.sent, off);
  }
}

template <int NDIM>
__device__ __forceinline__ void box_store(const Box<NDIM>& b, float* out) {
#pragma unroll
  for (int c = 0; c < NDIM; ++c) {
    out[c] = b.lo[c];
    out[kMax + c] = b.hi[c];
  }
  out[kR2] = b.r2;
  out[kCount] = (float)b.count;
  out[kSent] = (float)b.sent;
}

// Block b: for b < q_blocks the boxes of its 4 warp query groups (the
// lanes of the engine's query layout) -> qbox[4 b + w]; for b < d_chunks
// the box of data chunk b -> dbox[b], its lanes at d_sentinel left out
// (NaN: none). Either radius2 may be null.
template <int NDIM>
__global__ void __launch_bounds__(kThreads)
box_kernel(const float* __restrict__ q, int nq, const float* __restrict__ q_r2,
           int q_blocks, const float* __restrict__ d, int nd,
           const float* __restrict__ d_r2, const int* __restrict__ labels,
           int big, int d_chunks, float d_sentinel, float* __restrict__ qbox,
           float* __restrict__ dbox) {
  __shared__ float part[kWarps][kBox];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x;
  const float no_sentinel = __int_as_float(0x7fc00000);
  Box<NDIM> bx;
  if (b < q_blocks) {
    box_empty(bx);
#pragma unroll
    for (int i = 0; i < kQpt; ++i)
      box_add(bx, q, nq, b * kBlock + threadIdx.x + i * kThreads, q_r2,
              nullptr, big, no_sentinel);
    box_warp_reduce(bx);
    if (lane == 0) box_store(bx, qbox + (size_t)(b * kWarps + warp) * kBox);
  }
  if (b < d_chunks) {
    box_empty(bx);
#pragma unroll
    for (int i = 0; i < kQpt; ++i)
      box_add(bx, d, nd, b * kChunk + threadIdx.x + i * kThreads, d_r2,
              labels, big, d_sentinel);
    box_warp_reduce(bx);
    if (lane == 0) box_store(bx, part[warp]);
    __syncthreads();
    if (threadIdx.x == 0) {  // bx holds warp 0's box: merge the others
      for (int w = 1; w < kWarps; ++w) {
#pragma unroll
        for (int c = 0; c < NDIM; ++c) {
          bx.lo[c] = fminf(bx.lo[c], part[w][c]);
          bx.hi[c] = fmaxf(bx.hi[c], part[w][kMax + c]);
        }
        bx.r2 = fmaxf(bx.r2, part[w][kR2]);
        bx.count += (int)part[w][kCount];
        bx.sent += (int)part[w][kSent];
      }
      box_store(bx, dbox + (size_t)b * kBox);
    }
  }
}

// L and U of a (query group, chunk) tile: every pair's dist2 in [L, U].
template <int NDIM>
__device__ __forceinline__ void tile_bounds(const float* __restrict__ qb,
                                            const float* __restrict__ db,
                                            float& low, float& up) {
#pragma unroll
  for (int c = 0; c < NDIM; ++c) {
    const float g = fmaxf(0.f, fmaxf(__fsub_rn(db[c], qb[kMax + c]),
                                     __fsub_rn(qb[c], db[kMax + c])));
    const float u = fmaxf(__fsub_rn(qb[kMax + c], db[c]),
                          __fsub_rn(db[kMax + c], qb[c]));
    low = c == 0 ? __fmul_rn(g, g) : __fadd_rn(low, __fmul_rn(g, g));
    up = c == 0 ? __fmul_rn(u, u) : __fadd_rn(up, __fmul_rn(u, u));
  }
}

// The box of the one point s in every coordinate.
template <int NDIM>
__device__ __forceinline__ void point_box(float s, float (&b)[kBox]) {
#pragma unroll
  for (int c = 0; c < NDIM; ++c) b[c] = b[kMax + c] = s;
}

// Query lane qi (NaN past nq); true when all its coordinates are numbers.
template <int NDIM>
__device__ __forceinline__ bool load_query_masked(const float* __restrict__ q,
                                                  int nq, int qi,
                                                  float (&qv)[NDIM]) {
  bool ok = true;
#pragma unroll
  for (int c = 0; c < NDIM; ++c) {
    qv[c] = qi < nq ? q[(size_t)c * nq + qi] : __int_as_float(0x7fc00000);
    ok &= qv[c] == qv[c];
  }
  return ok;
}

// This warp's query group; with the block's data chunk (blockIdx.y) it
// makes the warp's tile. Every lane reads the same two boxes, so what
// follows from them is warp-uniform.
__device__ __forceinline__ int warp_group() {
  return blockIdx.x * kWarps + threadIdx.x / 32;
}

// Lane 0 of each warp writes its tile's decision into tiles (G, C) when the
// caller asked for them (a check against the torch mirror).
__device__ __forceinline__ void record(unsigned char* tiles,
                                      unsigned char code) {
  if (tiles != nullptr && threadIdx.x % 32 == 0)
    tiles[(size_t)warp_group() * gridDim.y + blockIdx.y] = code;
}

// Kernels 6 (NLEV 1, level r2) and 7 (NLEV 3, levels2): out (nq, NLEV).
template <int NDIM, int NLEV>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ q, int nq, const float* __restrict__ d,
             int nd, const float* __restrict__ qbox,
             const float* __restrict__ dbox, float r2,
             const float* __restrict__ levels2, int* __restrict__ out,
             unsigned char* __restrict__ tiles) {
  __shared__ __align__(16) float buf[2][NDIM * kChunk];
  const float* db = dbox + (size_t)blockIdx.y * kBox;
  float low, up, lv[NLEV];
  tile_bounds<NDIM>(qbox + (size_t)warp_group() * kBox, db, low, up);
  // per level: adds nothing (L > l), adds the chunk (U <= l), or undecided
  bool none = true, decided = true;
#pragma unroll
  for (int l = 0; l < NLEV; ++l) {
    lv[l] = NLEV == 1 ? r2 : levels2[l];
    none &= low > lv[l];
    decided &= low > lv[l] || up <= lv[l];
  }
  const unsigned char code = none ? kSkip : decided ? kWhole : kPairs;
  record(tiles, code);
  // the splits merge into a zeroed output: a block whose warps all skip
  // has nothing to add
  if (gridDim.y > 1 && !__syncthreads_or(code != kSkip)) return;
  // taken whole: the chunk's lane count at each level it lies within, to
  // each query lane that is a number
  const int whole = code == kWhole ? (int)db[kCount] : 0;
  const int q0 = blockIdx.x * kBlock + threadIdx.x;
  float qv[kQpt][NDIM];
  int cnt[kQpt][NLEV];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const bool ok = load_query_masked<NDIM>(q, nq, q0 + i * kThreads, qv[i]);
#pragma unroll
    for (int l = 0; l < NLEV; ++l)
      cnt[i][l] = ok && up <= lv[l] ? whole : 0;
  }
  // the block stages its chunk when one of its warps runs the pair loop
  const int c = blockIdx.y;
  const Span sp{0, nd, 0, c, c + __syncthreads_or(code == kPairs)};
  scan_span<NDIM, NDIM>(
      d, nd, nullptr, nullptr, sp, buf, [&](const float* cur, int ng, int) {
        if (code == kPairs) count_groups<NLEV, NDIM>(cur, ng, qv, lv, cnt);
      });
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = q0 + i * kThreads;
    if (qi >= nq) continue;
#pragma unroll
    for (int l = 0; l < NLEV; ++l) {
      int* o = out + (size_t)NLEV * qi + l;
      if (gridDim.y == 1)
        *o = cnt[i][l];
      else if (cnt[i][l])
        atomicAdd(o, cnt[i][l]);
    }
  }
}

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
min_label_kernel(const float* __restrict__ pts, int n,
                 const float* __restrict__ radius2,
                 const int* __restrict__ labels,
                 const float* __restrict__ qbox,
                 const float* __restrict__ dbox, int big,
                 int* __restrict__ out, unsigned char* __restrict__ tiles) {
  constexpr int kRows = NDIM + 2;  // coordinates, radius2, labels
  __shared__ __align__(16) float buf[2][kRows * kChunk];
  const float* qb = qbox + (size_t)warp_group() * kBox;
  const float* db = dbox + (size_t)blockIdx.y * kBox;
  float low, up;
  tile_bounds<NDIM>(qb, db, low, up);
  const unsigned char code = low > fmaxf(qb[kR2], db[kR2]) ? kSkip : kPairs;
  record(tiles, code);
  // the splits merge into an output set to big: a block that skips its
  // chunk has nothing to lower
  const int pairs = __syncthreads_or(code == kPairs);
  if (gridDim.y > 1 && !pairs) return;
  const int q0 = blockIdx.x * kBlock + threadIdx.x;
  float qv[kQpt][NDIM], qr2[kQpt];
  int best[kQpt];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = q0 + i * kThreads;
    load_query_masked<NDIM>(pts, n, qi, qv[i]);
    qr2[i] = qi < n ? radius2[qi] : 0.f;
    best[i] = big;
  }
  const int c = blockIdx.y;
  const Span sp{0, n, 0, c, c + pairs};
  scan_span<NDIM, kRows>(
      pts, n, radius2, labels, sp, buf, [&](const float* cur, int ng, int) {
        if (code == kPairs) min_label_groups<NDIM>(cur, ng, qv, qr2, best);
      });
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = q0 + i * kThreads;
    if (qi >= n) continue;
    if (gridDim.y == 1)
      out[qi] = best[i];
    else if (best[i] < big)
      atomicMin(out + qi, best[i]);
  }
}

// Kernel 9's bound pass, one block per 256 queries: T_g of each warp's
// query group into its box's kR2 slot (see the header), and the keys of
// the block's queries set to kNoNearest.
template <int NDIM>
__global__ void __launch_bounds__(kThreads)
nearest_bound_kernel(const float* __restrict__ q, int nq,
                     const float* __restrict__ dbox, int d_chunks,
                     float sentinel, float* __restrict__ qbox,
                     unsigned long long* __restrict__ keys) {
  __shared__ float part[kBoundChunks][2 * NDIM + 1];
  const int q0 = blockIdx.x * kBlock + threadIdx.x;
  float qv[kQpt][NDIM], t[kQpt];
  bool ok[kQpt];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    ok[i] = load_query_masked<NDIM>(q, nq, q0 + i * kThreads, qv[i]);
    t[i] = INFINITY;
    if (q0 + i * kThreads < nq) keys[q0 + i * kThreads] = kNoNearest;
  }
  bool any_s = false;
  for (int c0 = 0; c0 < d_chunks; c0 += kBoundChunks) {
    const int n = min(kBoundChunks, d_chunks - c0);
    __syncthreads();  // the previous piece is read
    for (int k = threadIdx.x; k < n * (2 * NDIM + 1); k += kThreads) {
      const int c = k / (2 * NDIM + 1), f = k % (2 * NDIM + 1);
      const float* db = dbox + (size_t)(c0 + c) * kBox;
      part[c][f] = f < NDIM       ? db[f]
                   : f < 2 * NDIM ? db[kMax + f - NDIM]
                                  : db[kSent];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      any_s |= part[c][2 * NDIM] > 0.f;
#pragma unroll
      for (int i = 0; i < kQpt; ++i) {
        // U of the one-point box qv[i] against the chunk's box
        float up;
#pragma unroll
        for (int k = 0; k < NDIM; ++k) {
          const float u = fmaxf(__fsub_rn(qv[i][k], part[c][k]),
                                __fsub_rn(part[c][NDIM + k], qv[i][k]));
          up = k == 0 ? __fmul_rn(u, u) : __fadd_rn(up, __fmul_rn(u, u));
        }
        t[i] = fminf(t[i], up);
      }
    }
  }
  float tg = -INFINITY;
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    if (any_s) {  // S: the same steps against the box of one point
      float up;
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        const float u = fmaxf(__fsub_rn(qv[i][k], sentinel),
                              __fsub_rn(sentinel, qv[i][k]));
        up = k == 0 ? __fmul_rn(u, u) : __fadd_rn(up, __fmul_rn(u, u));
      }
      t[i] = fminf(t[i], up);
    }
    if (ok[i]) tg = fmaxf(tg, t[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tg = fmaxf(tg, __shfl_xor_sync(0xffffffffu, tg, off));
  if (threadIdx.x % 32 == 0) qbox[(size_t)warp_group() * kBox + kR2] = tg;
}

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ q, int nq,
               const float* __restrict__ d, int nd,
               const float* __restrict__ qbox,
               const float* __restrict__ dbox, float sentinel,
               unsigned long long* __restrict__ keys,
               unsigned char* __restrict__ tiles) {
  __shared__ __align__(16) float buf[2][NDIM * kChunk];
  const float* qb = qbox + (size_t)warp_group() * kBox;
  const float* db = dbox + (size_t)blockIdx.y * kBox;
  const float t = qb[kR2];
  float low, up;
  tile_bounds<NDIM>(qb, db, low, up);
  bool skip = low > t;
  if (skip && db[kSent] > 0.f) {  // the chunk holds S: its L too
    float sb[kBox];
    point_box<NDIM>(sentinel, sb);
    tile_bounds<NDIM>(qb, sb, low, up);
    skip = low > t;
  }
  const unsigned char code = skip ? kSkip : kPairs;
  record(tiles, code);
  // the keys merge by atomicMin: a block whose warps all skip has nothing
  // to lower
  if (!__syncthreads_or(code == kPairs)) return;
  const int q0 = blockIdx.x * kBlock + threadIdx.x;
  float qv[kQpt][NDIM], best[kQpt];
  int bi[kQpt];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    load_query_masked<NDIM>(q, nq, q0 + i * kThreads, qv[i]);
    best[i] = INFINITY;
    bi[i] = 0;
  }
  const int c = blockIdx.y;
  const Span sp{0, nd, 0, c, c + 1};
  scan_span<NDIM, NDIM>(d, nd, nullptr, nullptr, sp, buf,
                        [&](const float* cur, int ng, int r0) {
    if (code == kPairs) nearest_groups<NDIM>(cur, ng, r0, qv, best, bi);
  });
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = q0 + i * kThreads;
    if (qi < nq && best[i] < INFINITY)
      atomicMin(keys + qi, nearest_key(best[i], bi[i]));
  }
}

// ---- kernel 12: one query per thread ----

// grid_for aims for this many blocks in all: four per SM of an H100 (132
// SMs, fixed here; the engine's kernels take their grids from the sizes)
constexpr int kTargetBlocks = 4 * 132;

template <int NDIM>
__device__ __forceinline__ void load_query_or0(const float* __restrict__ q,
                                               int nq, int qi,
                                               float (&qv)[NDIM]) {
#pragma unroll
  for (int c = 0; c < NDIM; ++c) qv[c] = qi < nq ? q[(size_t)c * nq + qi] : 0.f;
}

// Stage data points [j, j + kBlock) (those below nd) into sd.
template <int NDIM>
__device__ __forceinline__ void stage(const float* __restrict__ d, int nd,
                                      int j, float* sd) {
  const int jj = j + threadIdx.x;
  if (jj < nd) {
#pragma unroll
    for (int c = 0; c < NDIM; ++c)
      sd[c * kBlock + threadIdx.x] = d[(size_t)c * nd + jj];
  }
}

template <int NDIM>
__device__ __forceinline__ float dist2(const float (&qv)[NDIM],
                                       const float* sd, int t) {
  float diff = __fsub_rn(qv[0], sd[t]);
  float acc = __fmul_rn(diff, diff);
#pragma unroll
  for (int c = 1; c < NDIM; ++c) {
    diff = __fsub_rn(qv[c], sd[c * kBlock + t]);
    acc = __fadd_rn(acc, __fmul_rn(diff, diff));
  }
  return acc;
}

// This block's data range [j0, j1): split blockIdx.y of gridDim.y, each
// split a multiple of kBlock wide.
__device__ __forceinline__ void split_range(int nd, int chunk, int& j0,
                                            int& j1) {
  j0 = blockIdx.y * chunk;
  j1 = min(nd, j0 + chunk);
}

template <int NDIM>
__global__ void __launch_bounds__(kBlock)
min_label_qd_kernel(const float* __restrict__ q, int nq, const float* __restrict__ d,
                 int nd, int chunk, const float* __restrict__ q_r2,
                 const float* __restrict__ d_r2, const int* __restrict__ labels,
                 int big, int* __restrict__ out) {
  __shared__ float sd[NDIM * kBlock];
  __shared__ float sr2[kBlock];
  __shared__ int slab[kBlock];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  int j0, j1;
  split_range(nd, chunk, j0, j1);
  float qv[NDIM];
  load_query_or0<NDIM>(q, nq, qi, qv);
  const float qr2 = qi < nq ? q_r2[qi] : 0.f;
  int best = big;
  for (int j = j0; j < j1; j += kBlock) {
    stage<NDIM>(d, nd, j, sd);
    if (j + threadIdx.x < nd) {
      sr2[threadIdx.x] = d_r2[j + threadIdx.x];
      slab[threadIdx.x] = labels[j + threadIdx.x];
    }
    __syncthreads();
    const int tn = min(kBlock, j1 - j);
#pragma unroll 8
    for (int t = 0; t < tn; ++t) {
      // max-radius joint: HDBSCAN mutual-reachability linkage
      const float joint = fmaxf(qr2, sr2[t]);
      if (dist2<NDIM>(qv, sd, t) <= joint) best = min(best, slab[t]);
    }
    __syncthreads();
  }
  if (qi < nq && best < big) atomicMin(out + qi, best);
}

// (grid, chunk): query blocks on x, data splits on y, every split a
// multiple of kBlock wide; at least one split, at most one per data block.
// False for an empty side.
inline bool grid_for(int nq, int nd, dim3& grid, int& chunk) {
  if (nq <= 0 || nd <= 0) return false;
  const int qb = (nq + kBlock - 1) / kBlock;
  const int db = (nd + kBlock - 1) / kBlock;
  int splits = (kTargetBlocks + qb - 1) / qb;
  splits = splits > db ? db : splits;
  chunk = ((db + splits - 1) / splits) * kBlock;
  grid = dim3(qb, (nd + chunk - 1) / chunk);
  return true;
}

// The box pass of kernels 6-9 over both clouds: boxes holds the query
// groups' boxes, then the data chunks'.
struct Boxes {
  int q_blocks, d_chunks;
  float *qbox, *dbox;
  Boxes(int nq, int nd, float* boxes)
      : q_blocks((nq + kBlock - 1) / kBlock),
        d_chunks((nd + kChunk - 1) / kChunk),
        qbox(boxes),
        dbox(boxes + (size_t)q_blocks * kWarps * kBox) {}
  int blocks() const { return q_blocks > d_chunks ? q_blocks : d_chunks; }
};

}  // namespace

extern "C" {

// Kernels 6 and 7. boxes: (4 ceil(nq / 256) + ceil(nd / 256)) * 16 floats
// of scratch; levels2 null: the one level r2, out (nq,) int32; else the
// three squared levels levels2 (3,) on the card, out (nq, 3) int32; tiles
// null, or (4 ceil(nq / 256), ceil(nd / 256)) bytes for the decisions. nd
// a multiple of 4 and d's rows 16-byte aligned.
int dense_count(const float* q, int nq, const float* d, int nd, int ndim,
                float r2, const float* levels2, float* boxes, int* out,
                unsigned char* tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq <= 0 || nd <= 0 || nd % 4) return (int)cudaErrorInvalidValue;
  const Boxes bx(nq, nd, boxes);
  const dim3 grid(bx.q_blocks, bx.d_chunks);
  const int nlev = levels2 == nullptr ? 1 : 3;
  return dispatch_ndim(ndim, [&](auto nd_) {
    constexpr int N = decltype(nd_)::value;
    box_kernel<N><<<bx.blocks(), kThreads, 0, st>>>(
        q, nq, nullptr, bx.q_blocks, d, nd, nullptr, nullptr, 0, bx.d_chunks,
        NAN, bx.qbox, bx.dbox);
    if (grid.y > 1) fill(out, nlev * nq, 0, st);
    if (nlev == 1)
      count_kernel<N, 1><<<grid, kThreads, 0, st>>>(
          q, nq, d, nd, bx.qbox, bx.dbox, r2, nullptr, out, tiles);
    else
      count_kernel<N, 3><<<grid, kThreads, 0, st>>>(
          q, nq, d, nd, bx.qbox, bx.dbox, 0.f, levels2, out, tiles);
  });
}

// boxes: 5 ceil(n / 256) * 16 floats of scratch; out (n,) int32; tiles
// null, or (4 ceil(n / 256), ceil(n / 256)) bytes for the decisions. n a
// multiple of 4 and pts', radius2's and labels' rows 16-byte aligned.
int dense_min_label(const float* pts, int n, const float* radius2,
                    const int* labels, int ndim, int big, float* boxes,
                    int* out, unsigned char* tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  const Boxes bx(n, n, boxes);
  const dim3 grid(bx.q_blocks, bx.d_chunks);
  return dispatch_ndim(ndim, [&](auto nd_) {
    constexpr int N = decltype(nd_)::value;
    box_kernel<N><<<bx.blocks(), kThreads, 0, st>>>(
        pts, n, radius2, bx.q_blocks, pts, n, radius2, labels, big,
        bx.d_chunks, NAN, bx.qbox, bx.dbox);
    if (grid.y > 1) fill(out, n, big, st);
    min_label_kernel<N><<<grid, kThreads, 0, st>>>(
        pts, n, radius2, labels, bx.qbox, bx.dbox, big, out, tiles);
  });
}

// out (nq,) int32, filled with big by the caller; labels (nd,) of the data
int dense_min_label_qd(const float* q, int nq, const float* d, int nd,
                       const float* q_r2, const float* d_r2, const int* labels,
                       int ndim, int big, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunk;
  dim3 grid;
  if (!grid_for(nq, nd, grid, chunk)) return (int)cudaErrorInvalidValue;
  return dispatch_ndim(ndim, [&](auto nd_) {
    min_label_qd_kernel<decltype(nd_)::value><<<grid, kBlock, 0, st>>>(
        q, nq, d, nd, chunk, q_r2, d_r2, labels, big, out);
  });
}

// boxes and tiles as dense_count's; sentinel the coordinate of the
// sentinel point S; keys (nq,) 64-bit scratch (set by the bound pass);
// dist (nq,) f32 and idx (nq,) int32 written by the unpack pass.
int dense_nearest(const float* q, int nq, const float* d, int nd, int ndim,
                  float sentinel, float* boxes, unsigned long long* keys,
                  float* dist, int* idx, unsigned char* tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq <= 0 || nd <= 0 || nd % 4) return (int)cudaErrorInvalidValue;
  const Boxes bx(nq, nd, boxes);
  const dim3 grid(bx.q_blocks, bx.d_chunks);
  const int err = dispatch_ndim(ndim, [&](auto nd_) {
    constexpr int N = decltype(nd_)::value;
    box_kernel<N><<<bx.blocks(), kThreads, 0, st>>>(
        q, nq, nullptr, bx.q_blocks, d, nd, nullptr, nullptr, 0, bx.d_chunks,
        sentinel, bx.qbox, bx.dbox);
    nearest_bound_kernel<N><<<bx.q_blocks, kThreads, 0, st>>>(
        q, nq, bx.dbox, bx.d_chunks, sentinel, bx.qbox, keys);
    nearest_kernel<N><<<grid, kThreads, 0, st>>>(
        q, nq, d, nd, bx.qbox, bx.dbox, sentinel, keys, tiles);
  });
  if (err != (int)cudaSuccess) return err;
  nearest_unpack_kernel<<<(nq + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      keys, nq, dist, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
