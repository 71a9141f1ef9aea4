// The pair engine of the neighbour kernels for Hopper (sm_90a), shared by
// banded.cu (kernels 1-4) and dense.cu (kernels 6-9).
//
// Clouds are (8, N) float32, row-major (row c holds coordinate c of every
// point). The squared distance is (q - d)^2 summed over rows 0..ndim-1 in
// that order, every product and sum rounded on its own (__fsub_rn /
// __fmul_rn / __fadd_rn, and both sources build with -fmad=false), so the
// kernels agree bit for bit with their plain PyTorch versions.
//
// The engine:
//  - A block holds 256 queries, kQpt = 2 per thread at stride 128
//    (coalesced loads and stores); warp w holds queries 32w..32w+31 and
//    128+32w..128+32w+31 of its block.
//  - Data points arrive in chunks of 256 ranks through two shared-memory
//    stages: chunk k + 1 lands by cp.async (16 bytes per thread per row)
//    while chunk k is computed (scan_span). Per block (ndim [+ 2]) x 256
//    x 4 bytes x 2 stages: 6 KB for a 3-D count, 16 KB for a 6-D min-label
//    pass.
//  - Each group of 4 data points comes from shared memory as one 16-byte
//    broadcast load per coordinate row (and per radius and label row) and
//    serves 4 x 2 pairs, so loads are 1 / 4 instructions per pair, not
//    ndim (count_groups, min_label_groups, nearest_groups).
//  - A scan visits the consecutive chunks [c0, c1) of a span: a banded
//    block's run, or a dense block's one chunk when its box test needs
//    it. Ranks outside [lo, hi) in a boundary group of 4 get a NaN first
//    coordinate in shared memory, so every compare with them is false;
//    the pair loop stops at the last group of 4 that meets [lo, hi).
//  - The launcher cuts a block's chunks into runs over gridDim.y; the runs
//    merge into an output set first on the same stream (fill_kernel:
//    integer atomicAdd into 0, atomicMin into big; the nearest: a 64-bit
//    atomicMin on nearest_key into kNoNearest, then nearest_unpack_kernel):
//    order-free, so no result depends on the split.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kBlock = 256;            // queries per block
constexpr int kQpt = 2;                // queries per thread
constexpr int kThreads = kBlock / kQpt;
constexpr int kChunk = 256;            // data ranks per shared-memory stage
constexpr int kGroups = kChunk / 4;    // 16-byte groups per row of a stage

template <int NDIM>
__device__ __forceinline__ void load_query(const float* __restrict__ q,
                                           int nq, int qi, float (&qv)[NDIM]) {
#pragma unroll
  for (int c = 0; c < NDIM; ++c) qv[c] = q[(size_t)c * nq + qi];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the most recent group have landed (in this thread's view)
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int J>
__device__ __forceinline__ float lane(const float4& v) {
  return J == 0 ? v.x : J == 1 ? v.y : J == 2 ? v.z : v.w;
}
template <int J>
__device__ __forceinline__ int lane(const int4& v) {
  return J == 0 ? v.x : J == 1 ? v.y : J == 2 ? v.z : v.w;
}

// A block's data ranks: the span [lo, hi), chunks of kChunk from base (a
// multiple of 4 at or below lo), and the block's run of chunks [c0, c1).
struct Span {
  int lo, hi, base, c0, c1;
};

// Stage chunk c into buf by cp.async: ROWS rows, the NDIM coordinates,
// then (ROWS = NDIM + 2) the radius2 and label rows. Thread f of the
// flattened (row, group) grid copies 16 bytes. Groups at or past hi are not
// read (hi <= nd, and nd and base are multiples of 4, so a group below hi
// lies inside nd).
template <int NDIM, int ROWS>
__device__ __forceinline__ void stage_async(const float* __restrict__ d,
                                            int nd, const float* radius2,
                                            const int* labels, const Span& sp,
                                            int c, float* buf) {
  const int r0 = sp.base + c * kChunk;
#pragma unroll
  for (int it = 0; it < (ROWS * kGroups + kThreads - 1) / kThreads; ++it) {
    const int f = threadIdx.x + it * kThreads;
    if (f >= ROWS * kGroups) break;
    const int row = f / kGroups, g = f % kGroups;
    const int rank = r0 + 4 * g;
    if (rank >= sp.hi) continue;
    const void* src = row < NDIM    ? d + (size_t)row * nd + rank
                      : row == NDIM ? radius2 + rank
                                    : static_cast<const void*>(labels + rank);
    cp_async16(buf + row * kChunk + 4 * g, src);
  }
}

// After the wait: the ranks of chunk c outside [lo, hi) that its boundary
// groups hold get a NaN first coordinate (every compare false). Thread g
// (< kGroups) copied row 0's group g itself, so it sees that copy landed.
__device__ __forceinline__ void mask_chunk(const Span& sp, int c, float* buf) {
  const int g = threadIdx.x;
  const int rank = sp.base + c * kChunk + 4 * g;
  if (g < kGroups && rank < sp.hi && (rank < sp.lo || rank + 4 > sp.hi)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (rank + j < sp.lo || rank + j >= sp.hi)
        buf[4 * g + j] = __int_as_float(0x7fc00000);
  }
}

// The span loop: chunk k + 1 is staged by cp.async while chunk k is
// computed; body(cur, ng, r0) serves the ng groups of 4 of a chunk that
// meet the span, r0 the chunk's first global rank.
template <int NDIM, int ROWS, class Body>
__device__ __forceinline__ void scan_span(const float* __restrict__ d,
                                          int nd, const float* radius2,
                                          const int* labels, const Span& sp,
                                          float (*buf)[ROWS * kChunk],
                                          Body&& body) {
  const int n = sp.c1 - sp.c0;
  if (n > 0) {
    stage_async<NDIM, ROWS>(d, nd, radius2, labels, sp, sp.c0, buf[0]);
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    const int c = sp.c0 + k;
    if (k + 1 < n)
      stage_async<NDIM, ROWS>(d, nd, radius2, labels, sp, c + 1,
                              buf[(k + 1) & 1]);
    cp_async_commit();
    cp_async_wait_prev();
    float* cur = buf[k & 1];
    mask_chunk(sp, c, cur);
    __syncthreads();
    const int r0 = sp.base + c * kChunk;
    body(cur, min(kGroups, (sp.hi - r0 + 3) >> 2), r0);
    __syncthreads();  // before chunk k + 2 lands in this stage
  }
}

// (q - d)^2 over rows 0..NDIM-1 in order, each step rounded on its own,
// for data point J of the group dv
template <int NDIM, int J>
__device__ __forceinline__ float dist2_lane(const float* qv,
                                            const float4 (&dv)[NDIM]) {
  float diff = __fsub_rn(qv[0], lane<J>(dv[0]));
  float acc = __fmul_rn(diff, diff);
#pragma unroll
  for (int c = 1; c < NDIM; ++c) {
    diff = __fsub_rn(qv[c], lane<J>(dv[c]));
    acc = __fadd_rn(acc, __fmul_rn(diff, diff));
  }
  return acc;
}

template <int NDIM>
__device__ __forceinline__ void load_group(const float* buf, int g,
                                           float4 (&dv)[NDIM]) {
  const float4* b4 = reinterpret_cast<const float4*>(buf);
#pragma unroll
  for (int c = 0; c < NDIM; ++c) dv[c] = b4[c * kGroups + g];
}

// counts at NLEV squared radii lv
template <int NLEV, int NDIM, int J>
__device__ __forceinline__ void count_lane(const float* qv,
                                           const float4 (&dv)[NDIM],
                                           const float (&lv)[NLEV],
                                           int (&cnt)[NLEV]) {
  const float dd = dist2_lane<NDIM, J>(qv, dv);
#pragma unroll
  for (int l = 0; l < NLEV; ++l) cnt[l] += dd <= lv[l];
}

// The count pair loop over the ng groups of 4 of a staged chunk.
template <int NLEV, int NDIM>
__device__ __forceinline__ void count_groups(const float* cur, int ng,
                                             const float (&qv)[kQpt][NDIM],
                                             const float (&lv)[NLEV],
                                             int (&cnt)[kQpt][NLEV]) {
#pragma unroll 2
  for (int g = 0; g < ng; ++g) {
    float4 dv[NDIM];
    load_group<NDIM>(cur, g, dv);
#pragma unroll
    for (int i = 0; i < kQpt; ++i) {
      count_lane<NLEV, NDIM, 0>(qv[i], dv, lv, cnt[i]);
      count_lane<NLEV, NDIM, 1>(qv[i], dv, lv, cnt[i]);
      count_lane<NLEV, NDIM, 2>(qv[i], dv, lv, cnt[i]);
      count_lane<NLEV, NDIM, 3>(qv[i], dv, lv, cnt[i]);
    }
  }
}

// The min-label pair loop over the ng groups of 4 of a staged chunk (rows
// NDIM and NDIM + 1 hold radius2 and the labels): a data point within
// max(radius2_q, radius2_d) lowers the query's best label.
template <int NDIM>
__device__ __forceinline__ void min_label_groups(
    const float* cur, int ng, const float (&qv)[kQpt][NDIM],
    const float (&qr2)[kQpt], int (&best)[kQpt]) {
  const float4* r4 = reinterpret_cast<const float4*>(cur + NDIM * kChunk);
  const int4* l4 = reinterpret_cast<const int4*>(cur + (NDIM + 1) * kChunk);
#pragma unroll 2
  for (int g = 0; g < ng; ++g) {
    float4 dv[NDIM];
    load_group<NDIM>(cur, g, dv);
    const float4 dr = r4[g];
    const int4 dl = l4[g];
#pragma unroll
    for (int i = 0; i < kQpt; ++i) {
      // max-radius joint: HDBSCAN mutual-reachability linkage
      if (dist2_lane<NDIM, 0>(qv[i], dv) <= fmaxf(qr2[i], lane<0>(dr)))
        best[i] = min(best[i], lane<0>(dl));
      if (dist2_lane<NDIM, 1>(qv[i], dv) <= fmaxf(qr2[i], lane<1>(dr)))
        best[i] = min(best[i], lane<1>(dl));
      if (dist2_lane<NDIM, 2>(qv[i], dv) <= fmaxf(qr2[i], lane<2>(dr)))
        best[i] = min(best[i], lane<2>(dl));
      if (dist2_lane<NDIM, 3>(qv[i], dv) <= fmaxf(qr2[i], lane<3>(dr)))
        best[i] = min(best[i], lane<3>(dl));
    }
  }
}

// strict < over ascending ranks keeps the FIRST minimum (argmin); a NaN
// distance (a masked rank, a NaN lane) never wins
template <int NDIM, int J>
__device__ __forceinline__ void nearest_lane(const float* qv,
                                             const float4 (&dv)[NDIM],
                                             int rank, float& best, int& bi) {
  const float dd = dist2_lane<NDIM, J>(qv, dv);
  if (dd < best) {
    best = dd;
    bi = rank + J;
  }
}

// The nearest pair loop over the ng groups of 4 of a staged chunk whose
// first rank is r0: per query the least dist2 and its first rank.
template <int NDIM>
__device__ __forceinline__ void nearest_groups(const float* cur, int ng,
                                               int r0,
                                               const float (&qv)[kQpt][NDIM],
                                               float (&best)[kQpt],
                                               int (&bi)[kQpt]) {
#pragma unroll 2
  for (int g = 0; g < ng; ++g) {
    float4 dv[NDIM];
    load_group<NDIM>(cur, g, dv);
    const int rank = r0 + 4 * g;
#pragma unroll
    for (int i = 0; i < kQpt; ++i) {
      nearest_lane<NDIM, 0>(qv[i], dv, rank, best[i], bi[i]);
      nearest_lane<NDIM, 1>(qv[i], dv, rank, best[i], bi[i]);
      nearest_lane<NDIM, 2>(qv[i], dv, rank, best[i], bi[i]);
      nearest_lane<NDIM, 3>(qv[i], dv, rank, best[i], bi[i]);
    }
  }
}

// The nearest's merge key: dist2 >= 0, so its bits order as its value
// does, and the lower rank in the low half wins a tie as the strict < over
// ascending ranks does inside one block: a 64-bit atomicMin over keys is
// order-free. kNoNearest = nearest_key(inf, 0): no candidate yet.
__device__ __forceinline__ unsigned long long nearest_key(float dist2,
                                                          int rank) {
  return ((unsigned long long)__float_as_uint(dist2) << 32) |
         (unsigned)rank;
}
constexpr unsigned long long kNoNearest = 0x7f800000ULL << 32;

__global__ void nearest_unpack_kernel(
    const unsigned long long* __restrict__ keys, int n,
    float* __restrict__ dist, int* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long key = keys[i];
    dist[i] = __uint_as_float((unsigned)(key >> 32));
    idx[i] = (int)(unsigned)key;
  }
}

template <class T>
__global__ void fill_kernel(T* __restrict__ out, int n, T value) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = value;
}

// the splits merge into out, set to value first
template <class T>
void fill(T* out, int n, T value, cudaStream_t st) {
  fill_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(out, n, value);
}

// launch(std::integral_constant<int, NDIM>) for ndim 3 to 6, then the
// launch's error
template <class Launch>
int dispatch_ndim(int ndim, Launch&& launch) {
  switch (ndim) {
    case 3: launch(std::integral_constant<int, 3>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    case 5: launch(std::integral_constant<int, 5>()); break;
    case 6: launch(std::integral_constant<int, 6>()); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
