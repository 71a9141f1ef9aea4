// Dense (all-pairs) neighbour kernels for Hopper (sm_90a): the CUDA port of
// the five dense Pallas kernels of vilgod_tpu/ops/pallas_kernels.py
//   dense_count      <- tile_radius_count   (pallas_kernels.py:93)
//   dense_count3     <- tile_radius_count3  (pallas_kernels.py:136)
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
//   count3    the same at three squared levels -> (N, 3);
//   min_label per query, the minimum label over data points with
//             dist2 <= max(r2_q, r2_d), else big (mutual-reachability
//             linkage): dense_min_label over one cloud, dense_min_label_qd
//             a query block against a different data window;
//   nearest   per query, the least dist2 and the FIRST data index that
//             reaches it (Pallas: argmin within a tile, strict < across).
//
// What bounds them on the H100. 3 flops per coordinate and a compare per
// pair, no reuse beyond the pair, and a few MB of input: FP32 operations
// (67 TFLOP/s), not the 3.35 TB/s of HBM. With -fmad=false a pair costs
// about 10 FP32 issue slots at ndim 3, so the way under the all-pairs
// time is to leave pairs out, exactly.
//
// Kernels 6 and 8 (dense_count, dense_min_label) run on the pair engine of
// span_engine.cuh (2 queries per thread, 16-byte broadcast loads of 4 data
// points, a cp.async double buffer) over the one span [0, nd), and decide
// whole tiles by bounding boxes first:
//  - box_kernel, launched first on the same stream, writes per warp query
//    group (64 lanes) and per 256-lane data chunk the per-coordinate min
//    and max over its lanes that are numbers in every coordinate (kernel
//    8's data boxes also only over lanes with label < big, which can
//    never lower a minimum), their largest radius2 and their count.
//  - Per (query group, chunk) tile, tile_bounds gives L <= dist2 <= U for
//    every pair: the per-coordinate gap and reach of the two boxes, each
//    difference, square and sum rounded on its own in coordinate order.
//    Round-to-nearest is monotone and odd, so each pair's rounded
//    difference, square and sum stay between those of the boxes.
//  - Kernel 6 skips a tile where L > r2, adds the chunk's lane count to
//    each query lane that is a number where U <= r2 (sentinel x sentinel
//    tiles land here), and runs the pair loop otherwise. Kernel 8 skips a
//    tile where L > max(the group's largest radius2, the chunk's).
//  - Each block takes one chunk (blockIdx.y) against its 256 queries; each
//    warp decides the tile of its own group, so branches stay
//    warp-uniform. The block stages the chunk only when one of its warps
//    runs the pair loop, and returns at once when all four skip. The
//    blocks of one query block merge by atomicAdd into 0 / atomicMin into
//    big (set by fill_kernel first). One chunk a block spreads the few
//    tiles that need the pair loop over the most blocks: runs of 2-32
//    chunks a block were slower on both kernels (PERF.md).
//  - On request (a non-null tiles), lane 0 of each warp writes its tile's
//    decision (kSkip, kWhole, kPairs) into tiles (G, C), which chip_smoke.py
//    holds against the torch mirror dense_kernels.tile_decisions.
//  - Ragged sizes: query lanes at or past nq load NaN (no compare holds;
//    nothing is written for them); nd must be a multiple of 4 with
//    16-byte aligned rows, which the wrapper ensures by padding with NaN
//    lanes (never with the sentinel: a sentinel meets a sentinel at
//    dist2 0).
//
// Kernels 7, 9 and 12 (count3, nearest, min_label_qd) are the first design:
// one thread per query, 256 queries per block, the data streamed through
// shared memory 256 points at a time and split over gridDim.y, merged with
// atomics on integers (atomicAdd, atomicMin, and for the nearest one
// 64-bit atomicMin on (bits(dist2) << 32 | index): dist2 >= 0, so the key
// orders by distance and then by index, which is the first minimum).
// Ragged N is masked on both axes. Their grid (grid_for) and query load
// (load_query_or0) serve only them, until they move onto the engine.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError(). The
// wrapper allocates the outputs and the box scratch; dense_count3,
// dense_min_label_qd and dense_nearest take their outputs initialised
// (zeros, big, all-ones keys).

#include <stdint.h>

#include "span_engine.cuh"

namespace {

// ---- kernels 6 and 8: the engine with exact tile decisions by boxes ----

constexpr int kWarps = kThreads / 32;  // query groups per block
// a box: NDIM minima at [0, 6), maxima at [kMax, kMax + 6), the largest
// radius2 at kR2 (-inf: none), the lane count at kCount
constexpr int kBox = 16, kMax = 6, kR2 = 12, kCount = 13;
// a tile's decision, as dense_kernels.tile_decisions codes it
constexpr unsigned char kSkip = 0, kWhole = 1, kPairs = 2;

template <int NDIM>
struct Box {
  float lo[NDIM], hi[NDIM], r2;
  int count;
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
}

// Lane i of the cloud p (n lanes) joins the box when it is in range, all
// its coordinates are numbers and (with labels) its label is below big.
template <int NDIM>
__device__ __forceinline__ void box_add(Box<NDIM>& b, const float* __restrict__ p,
                                        int n, int i, const float* radius2,
                                        const int* labels, int big) {
  if (i >= n || (labels != nullptr && labels[i] >= big)) return;
  float x[NDIM];
  bool ok = true;
#pragma unroll
  for (int c = 0; c < NDIM; ++c) {
    x[c] = p[(size_t)c * n + i];
    ok &= x[c] == x[c];
  }
  if (!ok) return;
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
}

// Block b: for b < q_blocks the boxes of its 4 warp query groups (the
// lanes of the engine's query layout) -> qbox[4 b + w]; for b < d_chunks
// the box of data chunk b -> dbox[b]. Either radius2 may be null.
template <int NDIM>
__global__ void __launch_bounds__(kThreads)
box_kernel(const float* __restrict__ q, int nq, const float* __restrict__ q_r2,
           int q_blocks, const float* __restrict__ d, int nd,
           const float* __restrict__ d_r2, const int* __restrict__ labels,
           int big, int d_chunks, float* __restrict__ qbox,
           float* __restrict__ dbox) {
  __shared__ float part[kWarps][kBox];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x;
  Box<NDIM> bx;
  if (b < q_blocks) {
    box_empty(bx);
#pragma unroll
    for (int i = 0; i < kQpt; ++i)
      box_add(bx, q, nq, b * kBlock + threadIdx.x + i * kThreads, q_r2,
              nullptr, big);
    box_warp_reduce(bx);
    if (lane == 0) box_store(bx, qbox + (size_t)(b * kWarps + warp) * kBox);
  }
  if (b < d_chunks) {
    box_empty(bx);
#pragma unroll
    for (int i = 0; i < kQpt; ++i)
      box_add(bx, d, nd, b * kChunk + threadIdx.x + i * kThreads, d_r2,
              labels, big);
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

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ q, int nq, const float* __restrict__ d,
             int nd, const float* __restrict__ qbox,
             const float* __restrict__ dbox, float r2, int* __restrict__ out,
             unsigned char* __restrict__ tiles) {
  __shared__ __align__(16) float buf[2][NDIM * kChunk];
  const float* db = dbox + (size_t)blockIdx.y * kBox;
  float low, up;
  tile_bounds<NDIM>(qbox + (size_t)warp_group() * kBox, db, low, up);
  const unsigned char code = low > r2 ? kSkip : up <= r2 ? kWhole : kPairs;
  record(tiles, code);
  // the splits merge into a zeroed output: a block whose warps all skip
  // has nothing to add
  if (gridDim.y > 1 && !__syncthreads_or(code != kSkip)) return;
  // taken whole: the chunk's lane count, to each query lane that is a number
  const int whole = code == kWhole ? (int)db[kCount] : 0;
  const int q0 = blockIdx.x * kBlock + threadIdx.x;
  const float lv[1] = {r2};
  float qv[kQpt][NDIM];
  int cnt[kQpt][1];
#pragma unroll
  for (int i = 0; i < kQpt; ++i)
    cnt[i][0] = load_query_masked<NDIM>(q, nq, q0 + i * kThreads, qv[i])
                    ? whole : 0;
  // the block stages its chunk when one of its warps runs the pair loop
  const int c = blockIdx.y;
  const Span sp{0, nd, 0, c, c + __syncthreads_or(code == kPairs)};
  scan_span<NDIM, NDIM>(
      d, nd, nullptr, nullptr, sp, buf, [&](const float* cur, int ng, int) {
        if (code == kPairs) count_groups<1, NDIM>(cur, ng, qv, lv, cnt);
      });
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = q0 + i * kThreads;
    if (qi >= nq) continue;
    if (gridDim.y == 1)
      out[qi] = cnt[i][0];
    else if (cnt[i][0])
      atomicAdd(out + qi, cnt[i][0]);
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

// ---- kernels 7, 9 and 12: one query per thread ----

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
count3_kernel(const float* __restrict__ q, int nq, const float* __restrict__ d,
              int nd, int chunk, const float* __restrict__ levels2,
              int* __restrict__ out) {
  __shared__ float sd[NDIM * kBlock];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  int j0, j1;
  split_range(nd, chunk, j0, j1);
  const float l0 = levels2[0], l1 = levels2[1], l2 = levels2[2];
  float qv[NDIM];
  load_query_or0<NDIM>(q, nq, qi, qv);
  int c0 = 0, c1 = 0, c2 = 0;
  for (int j = j0; j < j1; j += kBlock) {
    stage<NDIM>(d, nd, j, sd);
    __syncthreads();
    const int tn = min(kBlock, j1 - j);
#pragma unroll 8
    for (int t = 0; t < tn; ++t) {
      const float dd = dist2<NDIM>(qv, sd, t);
      c0 += dd <= l0;
      c1 += dd <= l1;
      c2 += dd <= l2;
    }
    __syncthreads();
  }
  if (qi < nq) {
    if (c0) atomicAdd(out + 3 * (size_t)qi + 0, c0);
    if (c1) atomicAdd(out + 3 * (size_t)qi + 1, c1);
    if (c2) atomicAdd(out + 3 * (size_t)qi + 2, c2);
  }
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

template <int NDIM>
__global__ void __launch_bounds__(kBlock)
nearest_kernel(const float* __restrict__ q, int nq,
               const float* __restrict__ d, int nd, int chunk,
               unsigned long long* __restrict__ keys) {
  __shared__ float sd[NDIM * kBlock];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  int j0, j1;
  split_range(nd, chunk, j0, j1);
  float qv[NDIM];
  load_query_or0<NDIM>(q, nq, qi, qv);
  float best = INFINITY;
  int bi = -1;
  for (int j = j0; j < j1; j += kBlock) {
    stage<NDIM>(d, nd, j, sd);
    __syncthreads();
    const int tn = min(kBlock, j1 - j);
#pragma unroll 8
    for (int t = 0; t < tn; ++t) {
      const float dd = dist2<NDIM>(qv, sd, t);
      // strict < over ascending indices keeps the FIRST minimum (argmin)
      if (dd < best) {
        best = dd;
        bi = j + t;
      }
    }
    __syncthreads();
  }
  if (qi < nq && bi >= 0) {
    // dist2 >= 0: its bits order as an unsigned integer, and the index in
    // the low half breaks ties toward the first minimum
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(best) << 32) | (unsigned)bi;
    atomicMin(keys + qi, key);
  }
}

__global__ void nearest_finalize(const unsigned long long* __restrict__ keys,
                                 int nq, float* __restrict__ dist,
                                 int* __restrict__ idx) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  const unsigned long long key = keys[qi];
  if (key == ~0ull) {  // no candidate below +inf (the Pallas init)
    dist[qi] = INFINITY;
    idx[qi] = 0;
  } else {
    dist[qi] = __uint_as_float((unsigned)(key >> 32));
    idx[qi] = (int)(key & 0xffffffffu);
  }
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

}  // namespace

extern "C" {

// boxes: (4 ceil(nq / 256) + ceil(nd / 256)) * 16 floats of scratch; out
// (nq,) int32; tiles null, or (4 ceil(nq / 256), ceil(nd / 256)) bytes for
// the decisions. nd a multiple of 4 and d's rows 16-byte aligned.
int dense_count(const float* q, int nq, const float* d, int nd, int ndim,
                float r2, float* boxes, int* out, unsigned char* tiles,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq <= 0 || nd <= 0 || nd % 4) return (int)cudaErrorInvalidValue;
  const int q_blocks = (nq + kBlock - 1) / kBlock;
  const int d_chunks = (nd + kChunk - 1) / kChunk;
  float* qbox = boxes;
  float* dbox = boxes + (size_t)q_blocks * kWarps * kBox;
  const int box_blocks = q_blocks > d_chunks ? q_blocks : d_chunks;
  const dim3 grid(q_blocks, d_chunks);
  if (grid.y > 1) fill(out, nq, 0, st);
  return dispatch_ndim(ndim, [&](auto nd_) {
    constexpr int N = decltype(nd_)::value;
    box_kernel<N><<<box_blocks, kThreads, 0, st>>>(
        q, nq, nullptr, q_blocks, d, nd, nullptr, nullptr, 0, d_chunks, qbox,
        dbox);
    count_kernel<N><<<grid, kThreads, 0, st>>>(q, nq, d, nd, qbox, dbox, r2,
                                               out, tiles);
  });
}

// out (nq, 3) int32, zeroed by the caller
int dense_count3(const float* q, int nq, const float* d, int nd, int ndim,
                 const float* levels2, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunk;
  dim3 grid;
  if (!grid_for(nq, nd, grid, chunk)) return (int)cudaErrorInvalidValue;
  return dispatch_ndim(ndim, [&](auto nd_) {
    count3_kernel<decltype(nd_)::value><<<grid, kBlock, 0, st>>>(
        q, nq, d, nd, chunk, levels2, out);
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
  const int blocks = (n + kBlock - 1) / kBlock;
  float* qbox = boxes;
  float* dbox = boxes + (size_t)blocks * kWarps * kBox;
  const dim3 grid(blocks, blocks);
  if (grid.y > 1) fill(out, n, big, st);
  return dispatch_ndim(ndim, [&](auto nd_) {
    constexpr int N = decltype(nd_)::value;
    box_kernel<N><<<blocks, kThreads, 0, st>>>(pts, n, radius2, blocks, pts,
                                               n, radius2, labels, big,
                                               blocks, qbox, dbox);
    min_label_kernel<N><<<grid, kThreads, 0, st>>>(
        pts, n, radius2, labels, qbox, dbox, big, out, tiles);
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

// keys (nq,) 64-bit scratch, all ones (set by the caller); dist (nq,) f32
// and idx (nq,) int32 are written by the finalize pass
int dense_nearest(const float* q, int nq, const float* d, int nd, int ndim,
                  unsigned long long* keys, float* dist, int* idx,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunk;
  dim3 grid;
  if (!grid_for(nq, nd, grid, chunk)) return (int)cudaErrorInvalidValue;
  const int err = dispatch_ndim(ndim, [&](auto nd_) {
    nearest_kernel<decltype(nd_)::value><<<grid, kBlock, 0, st>>>(
        q, nq, d, nd, chunk, keys);
  });
  if (err != (int)cudaSuccess) return err;
  nearest_finalize<<<(nq + kBlock - 1) / kBlock, kBlock, 0, st>>>(keys, nq,
                                                                  dist, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
