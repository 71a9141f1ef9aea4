// Banded neighbour kernels for Hopper (sm_90a): the CUDA port of the four
// banded Pallas kernels of vilgod_tpu/ops/pallas_kernels.py
//   banded_count      <- banded_tile_count      (pallas_kernels.py:331)
//   banded_count3     <- banded_tile_count3     (pallas_kernels.py:371)
//   banded_min_label  <- banded_tile_min_label  (pallas_kernels.py:412)
//   banded_nearest    <- banded_tile_nearest    (pallas_kernels.py:463)
//
// What they compute. Clouds are (8, N) float32, row-major (row c holds
// coordinate c of every point), cell-sorted, invalid points at a far
// sentinel. Query block b (tq consecutive queries) scans the data window
// [s, s + w) with s = clamp(starts[b], 0, n_d - w), exactly the window of
// the JAX package's XLA fallback (dynamic_slice clamps the same way). The
// squared distance is (q - d)^2 summed over rows 0..ndim-1 in that order,
// every product and sum rounded on its own (__fmul_rn / __fadd_rn, and the
// file builds with -fmad=false): the radius thresholds sit on a 5 mm
// lattice where an FMA would flip pairs, and the plain PyTorch version of
// each kernel (vilgod_tpu_torch/ops/kernels.py) must agree bit for bit.
//
// What bounds them on the H100. Every query meets every point of its span:
// per (query, data point) pair 3 flops per coordinate less one, plus an
// epilogue (the compare; for the min-label pass also the max of the two
// radii and the label min), no reuse beyond the window, and the (8, N)
// inputs are a few MB. So they are bound by FP32 operations: the needed
// pairs x (3 ndim - 1 + epilogue) over 67 TFLOP/s. That peak counts an FMA
// as two operations; with -fmad=false no FMA pairs a product with a sum,
// so the FP32 pipes issue at most half of it, and every load, integer or
// branch instruction takes an issue slot from them.
//
// count_kernel and min_label_kernel (kernels 1 and 3) are built for that:
//  - The span. Where the wrapper passes ends (the JAX package's Pallas
//    kernels take the same per-block span, pallas_kernels.py:278-296),
//    block b scans exactly [s, min(ends[b], s + w)) and nothing past it;
//    without ends, [s, s + w). Chunks of 256 data ranks start at s rounded
//    down to 4 (16-byte copies); the ranks outside the span in a boundary
//    group of 4 get a NaN first coordinate in shared memory, so every
//    compare with them is false, and the compute loop stops at the last
//    group of 4 that meets the span. An empty span writes 0 / big.
//  - Register tiling. A block holds 256 queries, kQpt = 2 per thread at
//    stride 128 (coalesced loads and stores); each group of 4 data points
//    comes from shared memory as one 16-byte broadcast load per coordinate
//    row (and per radius and label row) and serves 4 x 2 pairs, so loads
//    are 1 / 4 instructions per pair, not ndim. Four queries per thread
//    needed nearly twice the registers and was slower on both kernels.
//  - Overlapped staging. Two shared-memory stages: chunk k + 1 arrives by
//    cp.async (16 bytes per thread per row) while chunk k is computed.
//    Per block (ndim [+ 2]) x 256 x 4 bytes x 2 stages: 6 KB for the 3-D
//    count, 16 KB for the 6-D min-label pass, so a dozen blocks fit an SM.
//  - Enough blocks. Each block's span is cut into gridDim.y runs of whole
//    chunks (the wrapper picks gridDim.y so the grid has ~4 blocks per SM:
//    4 for the 40960-query entropy counts, 1 for the 983040-query paged
//    min-label pass), merged with integer atomicAdd / atomicMin into an
//    output set to 0 / big first (by fill_kernel, on the same stream):
//    order-free, so no result depends on the split.
// count3_kernel and nearest_kernel (kernels 2 and 4) keep the first
// design: one thread per query, the whole window [s, s + w) staged 256
// points at a time by plain loads.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 256;

template <int NDIM>
__device__ __forceinline__ void load_query(const float* __restrict__ q,
                                           int nq, int qi, float (&qv)[NDIM]) {
#pragma unroll
  for (int c = 0; c < NDIM; ++c) qv[c] = q[(size_t)c * nq + qi];
}

// Stage data points [j0, j0 + kBlock) into sd (NDIM rows of kBlock).
template <int NDIM>
__device__ __forceinline__ void stage(const float* __restrict__ d, int nd,
                                      int j0, float* sd) {
#pragma unroll
  for (int c = 0; c < NDIM; ++c)
    sd[c * kBlock + threadIdx.x] = d[(size_t)c * nd + j0 + threadIdx.x];
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

__device__ __forceinline__ int window_start(const int* __restrict__ starts,
                                            int tq, int nd, int w) {
  int s = starts[(blockIdx.x * kBlock) / tq];
  return max(0, min(s, nd - w));
}

// ---- kernels 1 and 3: span, register tiling, cp.async double buffer ----

constexpr int kQpt = 2;                // queries per thread
constexpr int kThreads = kBlock / kQpt;
constexpr int kChunk = 256;            // data ranks per shared-memory stage
constexpr int kGroups = kChunk / 4;    // 16-byte groups per row of a stage

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

// This block's data ranks: the span [lo, hi) of its query block, chunks of
// kChunk from base = lo rounded down to 4, and this split's chunks [c0, c1).
struct Span {
  int lo, hi, base, c0, c1;
};

__device__ __forceinline__ Span block_span(const int* __restrict__ starts,
                                           const int* __restrict__ ends,
                                           int tq, int nd, int w) {
  Span sp;
  const int b = (blockIdx.x * kBlock) / tq;
  sp.lo = max(0, min(starts[b], nd - w));
  sp.hi = sp.lo + w;
  if (ends != nullptr) sp.hi = max(sp.lo, min(ends[b], sp.hi));
  sp.base = sp.lo & ~3;
  const int n_chunks =
      sp.hi > sp.lo ? (sp.hi - sp.base + kChunk - 1) / kChunk : 0;
  const int per = (n_chunks + gridDim.y - 1) / gridDim.y;
  sp.c0 = min(n_chunks, (int)blockIdx.y * per);
  sp.c1 = min(n_chunks, sp.c0 + per);
  return sp;
}

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

// groups of 4 of chunk c that meet the span
__device__ __forceinline__ int chunk_groups(const Span& sp, int c) {
  return min(kGroups, (sp.hi - (sp.base + c * kChunk) + 3) >> 2);
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

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ q, int nq, const float* __restrict__ d,
             int nd, const int* __restrict__ starts,
             const int* __restrict__ ends, int tq, int w, float r2,
             int* __restrict__ out) {
  __shared__ __align__(16) float buf[2][NDIM * kChunk];
  const Span sp = block_span(starts, ends, tq, nd, w);
  const int q0 = blockIdx.x * kBlock + threadIdx.x;
  float qv[kQpt][NDIM];
#pragma unroll
  for (int i = 0; i < kQpt; ++i)
    load_query<NDIM>(q, nq, q0 + i * kThreads, qv[i]);
  int cnt[kQpt] = {};
  const int n = sp.c1 - sp.c0;
  if (n > 0) {
    stage_async<NDIM, NDIM>(d, nd, nullptr, nullptr, sp, sp.c0,
                                      buf[0]);
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    const int c = sp.c0 + k;
    if (k + 1 < n)
      stage_async<NDIM, NDIM>(d, nd, nullptr, nullptr, sp, c + 1,
                                        buf[(k + 1) & 1]);
    cp_async_commit();
    cp_async_wait_prev();
    float* cur = buf[k & 1];
    mask_chunk(sp, c, cur);
    __syncthreads();
    const int ng = chunk_groups(sp, c);
#pragma unroll 2
    for (int g = 0; g < ng; ++g) {
      float4 dv[NDIM];
      load_group<NDIM>(cur, g, dv);
#pragma unroll
      for (int i = 0; i < kQpt; ++i) {
        cnt[i] += dist2_lane<NDIM, 0>(qv[i], dv) <= r2;
        cnt[i] += dist2_lane<NDIM, 1>(qv[i], dv) <= r2;
        cnt[i] += dist2_lane<NDIM, 2>(qv[i], dv) <= r2;
        cnt[i] += dist2_lane<NDIM, 3>(qv[i], dv) <= r2;
      }
    }
    __syncthreads();  // before chunk k + 2 lands in this stage
  }
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    int* o = out + q0 + i * kThreads;
    if (gridDim.y == 1)
      *o = cnt[i];
    else if (cnt[i])
      atomicAdd(o, cnt[i]);
  }
}

template <int NDIM>
__global__ void __launch_bounds__(kBlock)
count3_kernel(const float* __restrict__ q, int nq, const float* __restrict__ d,
              int nd, const int* __restrict__ starts, int tq, int w,
              const float* __restrict__ levels2, int* __restrict__ out) {
  __shared__ float sd[NDIM * kBlock];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  const int s = window_start(starts, tq, nd, w);
  const float l0 = levels2[0], l1 = levels2[1], l2 = levels2[2];
  float qv[NDIM];
  load_query<NDIM>(q, nq, qi, qv);
  int c0 = 0, c1 = 0, c2 = 0;
  for (int k = 0; k < w; k += kBlock) {
    stage<NDIM>(d, nd, s + k, sd);
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kBlock; ++t) {
      const float dd = dist2<NDIM>(qv, sd, t);
      c0 += dd <= l0;
      c1 += dd <= l1;
      c2 += dd <= l2;
    }
    __syncthreads();
  }
  out[3 * (size_t)qi + 0] = c0;
  out[3 * (size_t)qi + 1] = c1;
  out[3 * (size_t)qi + 2] = c2;
}

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
min_label_kernel(const float* __restrict__ pts, int n,
                 const float* __restrict__ radius2,
                 const int* __restrict__ labels,
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 int tq, int w, int big, int* __restrict__ out) {
  constexpr int kRows = NDIM + 2;  // coordinates, radius2, labels
  __shared__ __align__(16) float buf[2][kRows * kChunk];
  const Span sp = block_span(starts, ends, tq, n, w);
  const int q0 = blockIdx.x * kBlock + threadIdx.x;
  float qv[kQpt][NDIM], qr2[kQpt];
  int best[kQpt];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    load_query<NDIM>(pts, n, q0 + i * kThreads, qv[i]);
    qr2[i] = radius2[q0 + i * kThreads];
    best[i] = big;
  }
  const int nc = sp.c1 - sp.c0;
  if (nc > 0) {
    stage_async<NDIM, kRows>(pts, n, radius2, labels, sp, sp.c0,
                                       buf[0]);
    cp_async_commit();
  }
  for (int k = 0; k < nc; ++k) {
    const int c = sp.c0 + k;
    if (k + 1 < nc)
      stage_async<NDIM, kRows>(pts, n, radius2, labels, sp, c + 1,
                                         buf[(k + 1) & 1]);
    cp_async_commit();
    cp_async_wait_prev();
    float* cur = buf[k & 1];
    mask_chunk(sp, c, cur);
    __syncthreads();
    const int ng = chunk_groups(sp, c);
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
    __syncthreads();  // before chunk k + 2 lands in this stage
  }
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    int* o = out + q0 + i * kThreads;
    if (gridDim.y == 1)
      *o = best[i];
    else if (best[i] < big)
      atomicMin(o, best[i]);
  }
}

template <int NDIM>
__global__ void __launch_bounds__(kBlock)
nearest_kernel(const float* __restrict__ q, int nq,
               const float* __restrict__ d, int nd,
               const int* __restrict__ starts, int tq, int w,
               float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float sd[NDIM * kBlock];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  const int s = window_start(starts, tq, nd, w);
  float qv[NDIM];
  load_query<NDIM>(q, nq, qi, qv);
  float best = INFINITY;
  int bi = 0;
  for (int k = 0; k < w; k += kBlock) {
    stage<NDIM>(d, nd, s + k, sd);
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kBlock; ++t) {
      const float dd = dist2<NDIM>(qv, sd, t);
      // strict < over ascending ranks keeps the FIRST minimum (argmin)
      if (dd < best) {
        best = dd;
        bi = s + k + t;
      }
    }
    __syncthreads();
  }
  dist[qi] = best;
  idx[qi] = bi;
}

__global__ void fill_kernel(int* __restrict__ out, int n, int value) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = value;
}

// the splits of kernels 1 and 3 merge into out, set to value first
void fill(int* out, int n, int value, cudaStream_t st) {
  fill_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(out, n, value);
}

inline dim3 grid_for(int nq) { return dim3(nq / kBlock); }

}  // namespace

#define DISPATCH_NDIM(ndim, KERNEL, ...)                                   \
  switch (ndim) {                                                          \
    case 3: KERNEL<3><<<grid_for(nq), kBlock, 0, st>>>(__VA_ARGS__); break; \
    case 4: KERNEL<4><<<grid_for(nq), kBlock, 0, st>>>(__VA_ARGS__); break; \
    case 5: KERNEL<5><<<grid_for(nq), kBlock, 0, st>>>(__VA_ARGS__); break; \
    case 6: KERNEL<6><<<grid_for(nq), kBlock, 0, st>>>(__VA_ARGS__); break; \
    default: return (int)cudaErrorInvalidValue;                            \
  }

extern "C" {

// kernels 1 and 3: kThreads threads a block, gridDim.y = split
#define DISPATCH_SPAN(ndim, KERNEL, ...)                                   \
  switch (ndim) {                                                          \
    case 3: KERNEL<3><<<grid, kThreads, 0, st>>>(__VA_ARGS__); break;      \
    case 4: KERNEL<4><<<grid, kThreads, 0, st>>>(__VA_ARGS__); break;      \
    case 5: KERNEL<5><<<grid, kThreads, 0, st>>>(__VA_ARGS__); break;      \
    case 6: KERNEL<6><<<grid, kThreads, 0, st>>>(__VA_ARGS__); break;      \
    default: return (int)cudaErrorInvalidValue;                            \
  }

int banded_count(const float* q, int nq, const float* d, int nd,
                 const int* starts, const int* ends, int tq, int w, int ndim,
                 float r2, int split, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nq / kBlock, split);
  if (split > 1) fill(out, nq, 0, st);
  DISPATCH_SPAN(ndim, count_kernel, q, nq, d, nd, starts, ends, tq, w,
                r2, out);
  return (int)cudaGetLastError();
}

int banded_count3(const float* q, int nq, const float* d, int nd,
                  const int* starts, int tq, int w, int ndim,
                  const float* levels2, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_NDIM(ndim, count3_kernel, q, nq, d, nd, starts, tq, w, levels2,
                out);
  return (int)cudaGetLastError();
}

int banded_min_label(const float* pts, int n, const float* radius2,
                     const int* labels, const int* starts, const int* ends,
                     int tq, int w, int ndim, int big, int split, int* out,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / kBlock, split);
  if (split > 1) fill(out, n, big, st);
  DISPATCH_SPAN(ndim, min_label_kernel, pts, n, radius2, labels, starts,
                ends, tq, w, big, out);
  return (int)cudaGetLastError();
}

int banded_nearest(const float* q, int nq, const float* d, int nd,
                   const int* starts, int tq, int w, int ndim, float* dist,
                   int* idx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_NDIM(ndim, nearest_kernel, q, nq, d, nd, starts, tq, w, dist, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
