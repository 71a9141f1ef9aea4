// Banded neighbour kernels for Hopper (sm_90a): the CUDA port of the four
// banded Pallas kernels of vilgod_tpu/ops/pallas_kernels.py
//   banded_count      <- banded_tile_count      (pallas_kernels.py:331)
//   banded_count3     <- banded_tile_count3     (pallas_kernels.py:371)
//   banded_min_label  <- banded_tile_min_label  (pallas_kernels.py:412)
//   banded_nearest    <- banded_tile_nearest    (pallas_kernels.py:463)
//
// What they compute. Clouds are (8, N) float32, cell-sorted, invalid
// points at a far sentinel. Query block b (tq consecutive queries) scans
// the data window [s, s + w) with s = clamp(starts[b], 0, n_d - w), exactly
// the window of the JAX package's XLA fallback (dynamic_slice clamps the
// same way), in the difference form of span_engine.cuh: the radius
// thresholds sit on a 5 mm lattice where an FMA would flip pairs, and the
// plain PyTorch version of each kernel (vilgod_tpu_torch/ops/kernels.py)
// must agree bit for bit.
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
// All four run on the pair engine of span_engine.cuh (2 queries per
// thread, 16-byte broadcast loads of 4 data points, a cp.async double
// buffer), and:
//  - The span. Where the wrapper passes ends (the JAX package's Pallas
//    kernels take the same per-block span, pallas_kernels.py:278-296),
//    block b scans exactly [s, min(ends[b], s + w)) and nothing past it;
//    without ends, [s, s + w). Chunks of 256 data ranks start at s rounded
//    down to 4 (16-byte copies); the ranks outside the span in a boundary
//    group of 4 are NaN-masked (a NaN distance is never below the best
//    nearest one either). An empty span writes 0 / big / (inf, 0).
//  - Enough blocks, and no long tail. Each block's span is cut into runs
//    of `run` whole chunks (2 from the wrapper), one per gridDim.y index,
//    so that the few long spans of a skewed cloud (a 2x-band nearest
//    call: half its query blocks empty, its longest spans 112 chunks)
//    spread over many SMs instead of setting the kernel's tail, and a
//    grid of few query blocks (the 40960-query entropy counts) still
//    fills the card. The runs merge into an output set first: integer
//    atomicAdd into 0 for the counts, atomicMin into big for the labels,
//    and for the nearest a 64-bit atomicMin on (bits(dist2) << 32) | rank
//    into (bits(inf) << 32) | 0, unpacked into (dist2, rank) afterwards
//    (nearest_key, kNoNearest and nearest_unpack_kernel, with the nearest
//    pair loop, are span_engine.cuh's, which dense.cu's kernel 9 shares).
//    dist2 >= 0, so its bits order as its value does, and the lower rank
//    wins a tie across runs as the strict < over ascending ranks does
//    inside one: every merge is order-free, so no result depends on the
//    split. A block whose run is empty returns at once.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include "span_engine.cuh"

namespace {

// This block's data ranks: the span [lo, hi) of its query block, chunks of
// kChunk from base = lo rounded down to 4, and this split's chunks [c0, c1):
// run y of the span's runs of max(ceil(chunks / gridDim.y), run) chunks.
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
    count_groups<NLEV, NDIM>(cur, ng, qv, lv, cnt);
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
    min_label_groups<NDIM>(cur, ng, qv, qr2, best);
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
    nearest_groups<NDIM>(cur, ng, r0, qv, best, bi);
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
  if (split > 1) fill(keys, nq, kNoNearest, st);
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