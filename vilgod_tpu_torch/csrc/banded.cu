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
// What bounds them on the H100. Every query meets every point of its
// window: 3 flops per coordinate plus a compare, no reuse beyond the
// window, and the (8, N) inputs are a few MB. So they are bound by FP32
// operations (67 TFLOP/s peak, half of that without FMA pairing), not by
// the 3.35 TB/s of HBM. The design is the simple one: one thread per
// query, a 256-thread block covers 256 queries of one tq-block and so
// shares that block's window, and the window streams through shared
// memory 256 points at a time (one coalesced load per coordinate row per
// thread), after which each thread runs the 256 distance evaluations from
// shared memory (broadcast reads). ndim is a template parameter so the
// coordinate loop unrolls. Making them fast (register tiling of several
// queries per thread, skipping the window past a block's true span) is
// later work.
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

template <int NDIM>
__global__ void __launch_bounds__(kBlock)
count_kernel(const float* __restrict__ q, int nq, const float* __restrict__ d,
             int nd, const int* __restrict__ starts, int tq, int w, float r2,
             int* __restrict__ out) {
  __shared__ float sd[NDIM * kBlock];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  const int s = window_start(starts, tq, nd, w);
  float qv[NDIM];
  load_query<NDIM>(q, nq, qi, qv);
  int cnt = 0;
  for (int k = 0; k < w; k += kBlock) {
    stage<NDIM>(d, nd, s + k, sd);
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kBlock; ++t) cnt += dist2<NDIM>(qv, sd, t) <= r2;
    __syncthreads();
  }
  out[qi] = cnt;
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
__global__ void __launch_bounds__(kBlock)
min_label_kernel(const float* __restrict__ pts, int n,
                 const float* __restrict__ radius2,
                 const int* __restrict__ labels,
                 const int* __restrict__ starts, int tq, int w, int big,
                 int* __restrict__ out) {
  __shared__ float sd[NDIM * kBlock];
  __shared__ float sr2[kBlock];
  __shared__ int slab[kBlock];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  const int s = window_start(starts, tq, n, w);
  float qv[NDIM];
  load_query<NDIM>(pts, n, qi, qv);
  const float qr2 = radius2[qi];
  int best = big;
  for (int k = 0; k < w; k += kBlock) {
    stage<NDIM>(pts, n, s + k, sd);
    sr2[threadIdx.x] = radius2[s + k + threadIdx.x];
    slab[threadIdx.x] = labels[s + k + threadIdx.x];
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kBlock; ++t) {
      // max-radius joint: HDBSCAN mutual-reachability linkage
      const float joint = fmaxf(qr2, sr2[t]);
      if (dist2<NDIM>(qv, sd, t) <= joint) best = min(best, slab[t]);
    }
    __syncthreads();
  }
  out[qi] = best;
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

int banded_count(const float* q, int nq, const float* d, int nd,
                 const int* starts, int tq, int w, int ndim, float r2,
                 int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_NDIM(ndim, count_kernel, q, nq, d, nd, starts, tq, w, r2, out);
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
                     const int* labels, const int* starts, int tq, int w,
                     int ndim, int big, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = n;
  DISPATCH_NDIM(ndim, min_label_kernel, pts, n, radius2, labels, starts, tq,
                w, big, out);
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
