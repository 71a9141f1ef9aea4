// The clustering stage's input selection for Hopper (sm_90a): the keep
// mask of a chunk of frame windows in one pass
//   select_keep  <- no Pallas kernel
//
// What it replaces. vilgod_tpu/pipeline/stages_geometry.py's
// select_cluster_input keeps, per point of each frame of the window that
// page i (frame fnr = f0 + i) clusters,
//   keep = uniform(fold_in(fold_in(PRNGKey(seed), fnr), rel), (n,)) < 1/nfw
//          & mask & has_nbr,  or dense_moving & mask where entropy_mask,
// over the window's frames rel = 0 .. nfw - 1, and leaves it to XLA under
// vmap: the JAX package has no Pallas kernel for it. The port's plain
// version (vilgod_tpu_torch/ops/select_kernels.py, keep_plain) runs it as
// about 200 int64 elementwise PyTorch ops over a (pages x nfw, n) tensor.
// This kernel gives the same mask, bit for bit, per point:
//  - the window: lo = clamp(f0 + i, 0, max(f_real - nfw, 0)), frame
//    f = min(lo + rel, n_frames - 1), valid where f < f_real and
//    lo + rel == f (a window clamped at the sequence's end repeats no
//    frame);
//  - the draw of the page's (fnr, rel) key, which the host derives and
//    passes in the launch's parameters: threefry2x32 of counter (0, row)
//    and the mantissa trick (threefry.cuh, kernel 13's), compared with
//    float32(1 / nfw) as jax compares a float32 draw with a Python float;
//  - the rule: mask & valid & (entropy_mask ? dense_moving : draw &
//    has_nbr); a point whose rule does not read the draw skips it.
//
// What bounds it on the H100. Four mask bytes are read and one keep byte
// is written a point, 5 bytes: 13 MB for a waymo.urban chunk (32 pages x
// 2 frames x 40960 points), 3.9 us at 3.35 TB/s. A drawn number costs ~81
// 32-bit integer ops (20 rounds of add, funnel-shift rotate and xor; 5 key
// injections of 3; the mantissa bits), at most 2.6 M numbers a chunk: 13 us
// at 132 SMs x 64 a clock x 1.98 GHz if every point drew. Both are far
// below a launch's own few microseconds of host time: the kernel exists to
// make the chunk's selection one launch and no host read, not to be fast.
//
// How the design meets it. A grid of (row blocks of 256 points, nfw,
// pages); a thread takes one point, reads its four mask bytes (coalesced
// in a warp), draws only where the rule needs it, and writes one byte.
// Keys travel by value in the launch's parameters (256 at most, 2 KB:
// the wrapper launches once for every kMaxKeys / nfw pages), so nothing
// is uploaded. No operation is floating point but the exact subtraction
// and the compare; the file builds with -fmad=false as the others do.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKeys = 256;      // (page, window frame) keys a launch

struct Keys {
  uint32_t k[kMaxKeys][2];
};

// block (x, rel, p): points [x * kThreads, (x + 1) * kThreads) of window
// frame rel of page page0 + p -> keep[((page0 + p) * nfw + rel) * n + row]
__global__ void __launch_bounds__(kThreads)
select_keep_kernel(const Keys keys, const uint8_t* __restrict__ mask,
                   const uint8_t* __restrict__ has_nbr,
                   const uint8_t* __restrict__ dense_moving,
                   const uint8_t* __restrict__ entropy_mask, int n,
                   int n_frames, int f_real, int f0, int nfw, int page0,
                   float threshold, uint8_t* __restrict__ keep) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const int rel = blockIdx.y;
  const int page = page0 + blockIdx.z;
  const int lo = min(max(f0 + page, 0), max(f_real - nfw, 0));
  const int f = min(lo + rel, n_frames - 1);
  const long long at = (long long)f * n + row;
  bool k = false;
  if (f < f_real && lo + rel == f && mask[at]) {
    if (entropy_mask[at]) {
      k = dense_moving[at] != 0;
    } else if (has_nbr[at]) {
      const uint32_t* key = keys.k[blockIdx.z * nfw + rel];
      k = unit_float(key[0], key[1], (uint32_t)row) < threshold;
    }
  }
  keep[((long long)page * nfw + rel) * n + row] = k;
}

}  // namespace

extern "C" {

// The (page, window frame) keys one launch takes: the wrapper launches
// once for every select_max_keys() / nfw pages.
int select_max_keys() { return kMaxKeys; }

// keys: pages x nfw host (k0, k1) pairs, page-major, of pages
// [page0, page0 + pages); the masks are (n_frames, n) bytes; keep is the
// chunk's (chunk, nfw, n) bytes.
int select_keep(const unsigned int* keys, int pages, int page0,
                const unsigned char* mask, const unsigned char* has_nbr,
                const unsigned char* dense_moving,
                const unsigned char* entropy_mask, int n, int n_frames,
                int f_real, int f0, int nfw, float threshold,
                unsigned char* keep, void* stream) {
  if (pages <= 0 || nfw <= 0 || pages * nfw > kMaxKeys) {
    return (int)cudaErrorInvalidValue;
  }
  Keys k;
  std::memset(&k, 0, sizeof(k));
  std::memcpy(k.k, keys, sizeof(uint32_t) * 2 * pages * nfw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kThreads - 1) / kThreads, nfw, pages);
  select_keep_kernel<<<grid, kThreads, 0, st>>>(
      k, mask, has_nbr, dense_moving, entropy_mask, n, n_frames, f_real, f0,
      nfw, page0, threshold, keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
