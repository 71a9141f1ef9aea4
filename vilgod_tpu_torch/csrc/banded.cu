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
// epilogue (the compares; for the min-label pass also the max of the two
// radii and the label min; for the nearest the strict less-than and its
// select), no reuse beyond the window, and the (8, N) inputs are a few MB.
// So they are bound by FP32 operations: the needed pairs x (3 ndim - 1 +
// epilogue) over 67 TFLOP/s. That peak counts an FMA as two operations;
// with -fmad=false no FMA pairs a product with a sum, so the FP32 pipes
// issue at most half of it, and every load, integer or branch instruction
// takes an issue slot from them.
//
// All four kernels are built for that:
//  - The span. Where the wrapper passes ends (the JAX package's Pallas
//    kernels take the same per-block span, pallas_kernels.py:278-296),
//    block b scans exactly [s, min(ends[b], s + w)) and nothing past it;
//    without ends, [s, s + w). Chunks of 256 data ranks start at s rounded
//    down to 4 (16-byte copies); the ranks outside the span in a boundary
//    group of 4 get a NaN first coordinate in shared memory, so every
//    compare with them is false (a NaN distance is never below the best
//    nearest one either), and the compute loop stops at the last group of
//    4 that meets the span. An empty span writes 0 / big / (inf, 0).
//  - Register tiling. A block holds 256 queries, kQpt = 2 per thread at
//    stride 128 (coalesced loads and stores); each group of 4 data points
//    comes from shared memory as one 16-byte broadcast load per coordinate
//    row (and per radius and label row) and serves 4 x 2 pairs, so loads
//    are 1 / 4 instructions per pair, not ndim. Four queries per thread
//    needed nearly twice the registers and was slower on kernels 1 and 3.
//  - Overlapped staging (scan_span). Two shared-memory stages: chunk k + 1
//    arrives by cp.async (16 bytes per thread per row) while chunk k is
//    computed. Per block (ndim [+ 2]) x 256 x 4 bytes x 2 stages: 6 KB for
//    the 3-D count, 16 KB for the 6-D min-label pass, so a dozen blocks fit
//    an SM.
//  - Enough blocks, and no long tail. Each block's span is cut into runs
//    of `run` whole chunks (2 from the wrapper), one per gridDim.y index,
//    so that the few long spans of a skewed cloud (a 2x-band nearest
//    call: half its query blocks empty, its longest spans 112 chunks)
//    spread over many SMs instead of setting the kernel's tail, and a
//    grid of few query blocks (the 40960-query entropy counts) still
//    fills the card. The runs merge into an output set first (by a fill
//    kernel, on the same stream): integer atomicAdd into 0 for the
//    counts, atomicMin into big for the labels,
//    and for the nearest a 64-bit atomicMin on (bits(dist2) << 32) | rank
//    into (bits(inf) << 32) | 0, unpacked into (dist2, rank) afterwards.
//    dist2 >= 0, so its bits order as its value does, and the lower rank
//    wins a tie across runs as the strict < over ascending ranks does
//    inside one: every merge is order-free, so no result depends on the
//    split. A block whose run is empty returns at once.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

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

// This block's data ranks: the span [lo, hi) of its query block, chunks of
// kChunk from base = lo rounded down to 4, and this split's chunks [c0, c1):
// run y of the span's runs of max(ceil(chunks / gridDim.y), run) chunks.
struct Span {
  int lo, hi, base, c0, c1;
};

__device__ __forceinline__ Span block_span(const int* __restrict__ starts,
                                           const int* __restrict__ ends,
                                           int tq, int nd, int w, int run) {
  Span sp;
  const int b = (blockIdx.x * kBlock) / tq;
  sp.lo = max(0, min(starts[b], nd - w));
  sp.hi = sp.lo + w;
  if (ends != nullptr) sp.hi = max(sp.lo, min(ends[b], sp.hi));
  sp.base = sp.lo & ~3;
  const int n_chunks =
      sp.hi > sp.lo ? (sp.hi - sp.base + kChunk - 1) / kChunk : 0;
  const int splits = gridDim.y;
  const int per = max((n_chunks + splits - 1) / splits, run);
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

// counts at NLEV squared radii (kernel 1: one, r2; kernel 2: three, from
// levels2 on the card), out (nq, NLEV) row-major
template <int NLEV, int NDIM, int J>
__device__ __forceinline__ void count_lane(const float* qv,
                                           const float4 (&dv)[NDIM],
                                           const float (&lv)[NLEV],
                                           int (&cnt)[NLEV]) {
  const float dd = dist2_lane<NDIM, J>(qv, dv);
#pragma unroll
  for (int l = 0; l < NLEV; ++l) cnt[l] += dd <= lv[l];
}

template <int NDIM, int NLEV>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ q, int nq, const float* __restrict__ d,
             int nd, const int* __restrict__ starts,
             const int* __restrict__ ends, int tq, int w, int run, float r2,
             const float* __restrict__ levels2, int* __restrict__ out) {
  __shared__ __align__(16) float buf[2][NDIM * kChunk];
  const Span sp = block_span(starts, ends, tq, nd, w, run);
  if (gridDim.y > 1 && sp.c0 == sp.c1) return;  // nothing to merge
  const int q0 = blockIdx.x * kBlock + threadIdx.x;
  float lv[NLEV];
#pragma unroll
  for (int l = 0; l < NLEV; ++l) lv[l] = NLEV == 1 ? r2 : levels2[l];
  float qv[kQpt][NDIM];
  int cnt[kQpt][NLEV] = {};
#pragma unroll
  for (int i = 0; i < kQpt; ++i)
    load_query<NDIM>(q, nq, q0 + i * kThreads, qv[i]);
  scan_span<NDIM, NDIM>(d, nd, nullptr, nullptr, sp, buf,
                        [&](const float* cur, int ng, int) {
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
  });
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    int* o = out + (size_t)NLEV * (q0 + i * kThreads);
#pragma unroll
    for (int l = 0; l < NLEV; ++l) {
      if (gridDim.y == 1)
        o[l] = cnt[i][l];
      else if (cnt[i][l])
        atomicAdd(o + l, cnt[i][l]);
    }
  }
}

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
min_label_kernel(const float* __restrict__ pts, int n,
                 const float* __restrict__ radius2,
                 const int* __restrict__ labels,
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 int tq, int w, int run, int big, int* __restrict__ out) {
  constexpr int kRows = NDIM + 2;  // coordinates, radius2, labels
  __shared__ __align__(16) float buf[2][kRows * kChunk];
  const Span sp = block_span(starts, ends, tq, n, w, run);
  if (gridDim.y > 1 && sp.c0 == sp.c1) return;  // nothing to merge
  const int q0 = blockIdx.x * kBlock + threadIdx.x;
  float qv[kQpt][NDIM], qr2[kQpt];
  int best[kQpt];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    load_query<NDIM>(pts, n, q0 + i * kThreads, qv[i]);
    qr2[i] = radius2[q0 + i * kThreads];
    best[i] = big;
  }
  scan_span<NDIM, kRows>(pts, n, radius2, labels, sp, buf,
                         [&](const float* cur, int ng, int) {
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
  });
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    int* o = out + q0 + i * kThreads;
    if (gridDim.y == 1)
      *o = best[i];
    else if (best[i] < big)
      atomicMin(o, best[i]);
  }
}

// strict < over ascending ranks keeps the FIRST minimum (argmin); a NaN
// distance (a masked rank) never wins
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

__device__ __forceinline__ unsigned long long nearest_key(float dist2,
                                                          int rank) {
  return ((unsigned long long)__float_as_uint(dist2) << 32) |
         (unsigned)rank;
}

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ q, int nq,
               const float* __restrict__ d, int nd,
               const int* __restrict__ starts, const int* __restrict__ ends,
               int tq, int w, int run, float* __restrict__ dist,
               int* __restrict__ idx, unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float buf[2][NDIM * kChunk];
  const Span sp = block_span(starts, ends, tq, nd, w, run);
  if (gridDim.y > 1 && sp.c0 == sp.c1) return;  // nothing to merge
  const int q0 = blockIdx.x * kBlock + threadIdx.x;
  float qv[kQpt][NDIM], best[kQpt];
  int bi[kQpt];
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    load_query<NDIM>(q, nq, q0 + i * kThreads, qv[i]);
    best[i] = INFINITY;
    bi[i] = 0;
  }
  scan_span<NDIM, NDIM>(d, nd, nullptr, nullptr, sp, buf,
                        [&](const float* cur, int ng, int r0) {
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
  });
#pragma unroll
  for (int i = 0; i < kQpt; ++i) {
    const int qi = q0 + i * kThreads;
    if (gridDim.y == 1) {
      dist[qi] = best[i];
      idx[qi] = bi[i];
    } else if (best[i] < INFINITY) {
      atomicMin(keys + qi, nearest_key(best[i], bi[i]));
    }
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

// kThreads threads a block; gridDim.y = split (1: each block writes its
// queries' results itself), each split at least run chunks of a span
extern "C" {

int banded_count(const float* q, int nq, const float* d, int nd,
                 const int* starts, const int* ends, int tq, int w, int ndim,
                 float r2, int split, int run, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nq / kBlock, split);
  if (split > 1) fill(out, nq, 0, st);
  return dispatch_ndim(ndim, [&](auto nd_) {
    count_kernel<decltype(nd_)::value, 1><<<grid, kThreads, 0, st>>>(
        q, nq, d, nd, starts, ends, tq, w, run, r2, nullptr, out);
  });
}

int banded_count3(const float* q, int nq, const float* d, int nd,
                  const int* starts, const int* ends, int tq, int w, int ndim,
                  const float* levels2, int split, int run, int* out,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nq / kBlock, split);
  if (split > 1) fill(out, 3 * nq, 0, st);
  return dispatch_ndim(ndim, [&](auto nd_) {
    count_kernel<decltype(nd_)::value, 3><<<grid, kThreads, 0, st>>>(
        q, nq, d, nd, starts, ends, tq, w, run, 0.0f, levels2, out);
  });
}

int banded_min_label(const float* pts, int n, const float* radius2,
                     const int* labels, const int* starts, const int* ends,
                     int tq, int w, int ndim, int big, int split, int run,
                     int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / kBlock, split);
  if (split > 1) fill(out, n, big, st);
  return dispatch_ndim(ndim, [&](auto nd_) {
    min_label_kernel<decltype(nd_)::value><<<grid, kThreads, 0, st>>>(
        pts, n, radius2, labels, starts, ends, tq, w, run, big, out);
  });
}

// keys (nq,) 64-bit scratch, used only when split > 1
int banded_nearest(const float* q, int nq, const float* d, int nd,
                   const int* starts, const int* ends, int tq, int w,
                   int ndim, int split, int run, float* dist, int* idx,
                   unsigned long long* keys, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nq / kBlock, split);
  // nearest_key(inf, 0): no candidate yet
  if (split > 1) fill(keys, nq, 0x7f800000ULL << 32, st);
  const int err = dispatch_ndim(ndim, [&](auto nd_) {
    nearest_kernel<decltype(nd_)::value><<<grid, kThreads, 0, st>>>(
        q, nq, d, nd, starts, ends, tq, w, run, dist, idx, keys);
  });
  if (err != 0 || split == 1) return err;
  nearest_unpack_kernel<<<(nq + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      keys, nq, dist, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
