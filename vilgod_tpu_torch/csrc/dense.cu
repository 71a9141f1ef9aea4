// Dense (all-pairs) neighbour kernels for Hopper (sm_90a): the CUDA port of
// the four dense Pallas kernels of vilgod_tpu/ops/pallas_kernels.py
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
//             linkage); one kernel for both entries: dense_min_label
//             passes the same cloud as query and data, dense_min_label_qd
//             a query block and a different data window;
//   nearest   per query, the least dist2 and the FIRST data index that
//             reaches it (Pallas: argmin within a tile, strict < across).
//
// What bounds them on the H100. 3 flops per coordinate and a compare per
// pair, no reuse beyond the pair, and a few MB of input: FP32 operations
// (67 TFLOP/s), not the 3.35 TB/s of HBM. The design is the simple one of
// banded.cu: one thread per query, 256 queries per block, the data
// streamed through shared memory 256 points at a time. Since every query
// scans all of the data, the data axis is also split over gridDim.y so
// that a 16384-point cloud (64 query blocks) still fills the 132 SMs; the
// splits merge with atomics on integers (atomicAdd for the counts,
// atomicMin for the labels, and for the nearest one 64-bit atomicMin on
// (bits(dist2) << 32 | index): dist2 >= 0, so the key orders by distance
// and then by index, which is the first minimum). So no result depends on
// the split. Ragged N (not a multiple of 256) is masked on both axes.
// Making them fast (several queries per thread in registers) is later work.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError(). The
// wrapper allocates and initialises the outputs (zeros, big, all-ones
// keys).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
// aim for this many blocks in all: four per SM of an H100
constexpr int kTargetBlocks = 4 * 132;

template <int NDIM>
__device__ __forceinline__ void load_query(const float* __restrict__ q,
                                           int nq, int qi, float (&qv)[NDIM]) {
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
count_kernel(const float* __restrict__ q, int nq, const float* __restrict__ d,
             int nd, int chunk, float r2, int* __restrict__ out) {
  __shared__ float sd[NDIM * kBlock];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  int j0, j1;
  split_range(nd, chunk, j0, j1);
  float qv[NDIM];
  load_query<NDIM>(q, nq, qi, qv);
  int cnt = 0;
  for (int j = j0; j < j1; j += kBlock) {
    stage<NDIM>(d, nd, j, sd);
    __syncthreads();
    const int tn = min(kBlock, j1 - j);
#pragma unroll 8
    for (int t = 0; t < tn; ++t) cnt += dist2<NDIM>(qv, sd, t) <= r2;
    __syncthreads();
  }
  if (qi < nq && cnt) atomicAdd(out + qi, cnt);
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
  load_query<NDIM>(q, nq, qi, qv);
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
min_label_kernel(const float* __restrict__ q, int nq, const float* __restrict__ d,
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
  load_query<NDIM>(q, nq, qi, qv);
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
  load_query<NDIM>(q, nq, qi, qv);
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

#define DISPATCH_NDIM(ndim, KERNEL, ...)                                   \
  switch (ndim) {                                                          \
    case 3: KERNEL<3><<<grid, kBlock, 0, st>>>(__VA_ARGS__); break;        \
    case 4: KERNEL<4><<<grid, kBlock, 0, st>>>(__VA_ARGS__); break;        \
    case 5: KERNEL<5><<<grid, kBlock, 0, st>>>(__VA_ARGS__); break;        \
    case 6: KERNEL<6><<<grid, kBlock, 0, st>>>(__VA_ARGS__); break;        \
    default: return (int)cudaErrorInvalidValue;                            \
  }

extern "C" {

// out (nq,) int32, zeroed by the caller
int dense_count(const float* q, int nq, const float* d, int nd, int ndim,
                float r2, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunk;
  dim3 grid;
  if (!grid_for(nq, nd, grid, chunk)) return (int)cudaErrorInvalidValue;
  DISPATCH_NDIM(ndim, count_kernel, q, nq, d, nd, chunk, r2, out);
  return (int)cudaGetLastError();
}

// out (nq, 3) int32, zeroed by the caller
int dense_count3(const float* q, int nq, const float* d, int nd, int ndim,
                 const float* levels2, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunk;
  dim3 grid;
  if (!grid_for(nq, nd, grid, chunk)) return (int)cudaErrorInvalidValue;
  DISPATCH_NDIM(ndim, count3_kernel, q, nq, d, nd, chunk, levels2, out);
  return (int)cudaGetLastError();
}

// out (n,) int32, filled with big by the caller
int dense_min_label(const float* pts, int n, const float* radius2,
                    const int* labels, int ndim, int big, int* out,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunk;
  dim3 grid;
  if (!grid_for(n, n, grid, chunk)) return (int)cudaErrorInvalidValue;
  DISPATCH_NDIM(ndim, min_label_kernel, pts, n, pts, n, chunk, radius2,
                radius2, labels, big, out);
  return (int)cudaGetLastError();
}

// out (nq,) int32, filled with big by the caller; labels (nd,) of the data
int dense_min_label_qd(const float* q, int nq, const float* d, int nd,
                       const float* q_r2, const float* d_r2, const int* labels,
                       int ndim, int big, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunk;
  dim3 grid;
  if (!grid_for(nq, nd, grid, chunk)) return (int)cudaErrorInvalidValue;
  DISPATCH_NDIM(ndim, min_label_kernel, q, nq, d, nd, chunk, q_r2, d_r2,
                labels, big, out);
  return (int)cudaGetLastError();
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
  DISPATCH_NDIM(ndim, nearest_kernel, q, nq, d, nd, chunk, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nearest_finalize<<<(nq + kBlock - 1) / kBlock, kBlock, 0, st>>>(keys, nq,
                                                                  dist, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
