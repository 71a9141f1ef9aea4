// The filter's RANSAC draw for Hopper (sm_90a): Gumbel top-3 in one pass
//   ransac_gumbel_top3  <- no Pallas kernel
//
// What it replaces. vilgod_tpu/ops/plane.py's ransac_plane draws a stage's
// `iters` index triples as
//   lax.top_k(where(mask, 0, -inf)[None, :] + jax.random.gumbel(key,
//             (iters, n)), 3)
// and leaves both calls to XLA: the JAX package has no Pallas kernel for
// them. The port's plain version (vilgod_tpu_torch/ops/ransac_kernels.py,
// draw_plain) runs them as about 200 int64 elementwise PyTorch ops, each
// reading and writing an (iters, n) tensor in HBM. This kernel fuses
// jax.random.gumbel with lax.top_k(..., 3) and gives the same triples, bit
// for bit:
//  - threefry2x32 (20 rounds) of key (k0, k1) over the counter pair
//    (0, r * n + i mod 2^32) of row r and point i: jax's partitionable
//    layout, as the plain version's _unit_floats lays it out;
//  - the mantissa trick, f = float(bits((y0 ^ y1) >> 9 | 0x3F800000)) - 1
//    (both from threefry.cuh, shared with kernel 14) and
//    u = max(f + tiny, tiny);
//  - g = -xla_log(-xla_log(u)), XLA's CPU float32 logarithm (Cephes'
//    polynomial, each product fused into the sum that follows it);
//  - the score 0 + g where mask[i], else -inf (0 + g turns a -0 into +0);
//  - top3_first's tie rule: the score's order-preserving int32 (its bits,
//    the low 31 flipped where negative) packed above n - 1 - i into a
//    unique int64 key; the three largest keys, largest first, give the
//    triple, the lower index first among equal scores.
//
// Why no operation may be contracted. The plain version is held to JAX
// bit for bit, and a Gumbel draw that moves by one bit can reorder a row's
// top three. XLA fuses each product of the polynomial into the following
// sum as a float64 product (exact: two float32 mantissas fit in 53 bits),
// a float64 sum and one float32 rounding (utils/common.fma32); a true
// fused multiply-add rounds once and differs about once in 2^29. So every
// such step is __double2float_rn(__dadd_rn(__dmul_rn(a, b), c)), every
// other float op is an __f*_rn intrinsic, and the file builds with
// -fmad=false besides: nvcc contracts neither a float32 product into a sum
// nor a float64 one. The constants are hex literals of the float32 values
// the plain version rounds them to (tests/test_torch_ransac.py reads them
// back from this file).
//
// What bounds it on the H100. Nothing but a mask byte a point is read and
// iters x 3 int64 are written, so the bytes are negligible (n = 155648:
// 0.16 MB). Per drawn number of a valid point: ~90 32-bit integer ops
// (20 rounds of add, funnel-shift rotate and xor; 10 key injections; the
// mantissa bits; the exponent and mantissa of two logarithms; the packed
// key and the running top 3), 42 conversions (per logarithm one int to
// float and 20 between float32 and float64), 36 float64 and ~30 float32
// ops. On 132 SMs at 1.98 GHz the integer ops take iters x n_valid x 90 /
// (132 x 64 per clock) and the conversions, at 16 per clock and SM, 42 /
// 16 = 2.6 clocks a number: the conversions are the tighter bound, about
// 0.16 ms for 100 x 155648 valid points, against ~30 ms for the plain
// version's ops.
//
// How the design meets it. A grid of (point blocks of kSpan points, rows):
// 100 rows of a 155648-point frame make 3800 blocks of 256 threads. Each
// thread draws its own numbers from its counters in registers and keeps a
// running top 3 of the packed keys there; a masked point skips the draw
// (its score is -inf whatever g is) and only competes with -inf's key.
// The block merges its threads' triples by warp shuffles, then its warps'
// through shared memory, and writes one triple to the scratch (iters,
// blocks, 3) the wrapper gives it. A second launch of one warp a row
// merges a row's block triples and writes (n - 1) - (key & 0xFFFFFFFF).
// The keys of a row are unique (their low word is the point), so the top
// three of any split is the row's top three: no result depends on the
// merge order, and the kernel is deterministic. On an H100 80GB HBM3 at
// 700 W a 100 x 155648 stage (153172 valid points) takes 0.20 ms, 77 % of
// the conversion bound (ptxas: 32 registers, no spills).
//
// Plain C interface for ctypes: the entry point launches both kernels on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kSpan = kThreads * kPerThread;   // points of a block's row span
constexpr int kWarps = kThreads / 32;
constexpr long long kNone = INT64_MIN;         // below every packed key

// float32 constants as the plain version rounds them (hex: no decimal
// rounding of the compiler's own)
constexpr float kTiny = 0x1p-126f;              // finfo(float32).tiny
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;     // 0.707106781186547524
constexpr float kP0 = 0x1.204376p-4f;           // 7.0376836292e-2
constexpr float kP1 = -0x1.d7a37p-4f;           // -1.1514610310e-1
constexpr float kP2 = 0x1.de4a34p-4f;           // 1.1676998740e-1
constexpr float kP3 = -0x1.fcba9ep-4f;          // -1.2420140846e-1
constexpr float kP4 = 0x1.23d37ep-3f;           // 1.4249322787e-1
constexpr float kP5 = -0x1.555cap-3f;           // -1.6668057665e-1
constexpr float kP6 = 0x1.999d58p-3f;           // 2.0000714765e-1
constexpr float kP7 = -0x1.fffff8p-3f;          // -2.4999993993e-1
constexpr float kP8 = 0x1.555554p-2f;           // 3.3333331174e-1
constexpr float kQ1 = -0x1.bd0106p-13f;         // -2.12194440e-4
constexpr float kQ2 = 0x1.63p-1f;               // 0.693359375

// a * b + c as XLA's CPU backend fuses it: float64 product (exact), float64
// sum, one float32 rounding (utils/common.fma32)
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// ops/random.xla_log: XLA's CPU float32 natural logarithm, for x > 0
__device__ __forceinline__ float xla_log(float x) {
  x = fmaxf(x, kTiny);
  const int bits = __float_as_int(x);
  float e = __fadd_rn(1.0f, __int2float_rn((bits >> 23) - 127));
  // mantissa in [0.5, 1): the exponent bits of 0.5 under x's mantissa
  const float m = __int_as_float((bits & 0x807FFFFF) | 0x3F000000);
  const bool low = m < kSqrtHalf;
  float t = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(t, t);
  const float x3 = __fmul_rn(x2, t);
  float y = fma32(t, kP0, kP1);
  float y1 = fma32(t, kP3, kP4);
  float y2 = fma32(t, kP6, kP7);
  y = fma32(y, t, kP2);
  y1 = fma32(y1, t, kP5);
  y2 = fma32(y2, t, kP8);
  y = fma32(y, x3, y1);
  y = fma32(y, x3, y2);
  y = fma32(y, x3, __fmul_rn(e, kQ1));
  t = __fsub_rn(t, __fmul_rn(0.5f, x2));
  t = __fadd_rn(t, y);
  return __fadd_rn(t, __fmul_rn(e, kQ2));
}

// jax.random.gumbel's float32 draw of counter c: -log(-log(u)), u uniform
// on [tiny, 1)
__device__ __forceinline__ float gumbel(uint32_t k0, uint32_t k1,
                                        uint32_t c) {
  const float u = fmaxf(__fadd_rn(unit_float(k0, k1, c), kTiny), kTiny);
  return -xla_log(-xla_log(u));
}

// top3_first's key: the score's order-preserving int32 above n - 1 - i
__device__ __forceinline__ long long packed_key(float score, int rev) {
  int k = __float_as_int(score);
  if (k < 0) k ^= 0x7FFFFFFF;
  return (long long)(((unsigned long long)(uint32_t)k << 32) |
                     (uint32_t)rev);
}

struct Top3 {
  long long a = kNone, b = kNone, c = kNone;   // a > b > c

  __device__ __forceinline__ void insert(long long k) {
    if (k <= c) return;
    if (k > b) {
      c = b;
      if (k > a) { b = a; a = k; } else { b = k; }
    } else {
      c = k;
    }
  }

  // every lane of the warp ends with the warp's top 3 (the lanes' keys
  // are disjoint, so no key enters twice)
  __device__ __forceinline__ void warp_merge() {
    for (int off = 16; off > 0; off >>= 1) {
      const long long oa = __shfl_xor_sync(0xFFFFFFFFu, a, off);
      const long long ob = __shfl_xor_sync(0xFFFFFFFFu, b, off);
      const long long oc = __shfl_xor_sync(0xFFFFFFFFu, c, off);
      insert(oa);
      insert(ob);
      insert(oc);
    }
  }
};

// block (x, r): the top 3 packed keys of row r over points
// [x * kSpan, min((x + 1) * kSpan, n)) -> part[(r * gridDim.x + x) * 3 + j]
__global__ void __launch_bounds__(kThreads)
gumbel_top3_kernel(uint32_t k0, uint32_t k1,
                   const uint8_t* __restrict__ mask, int n,
                   long long* __restrict__ part) {
  __shared__ long long warp_top[kWarps][3];
  const int r = blockIdx.y;
  const int base = blockIdx.x * kSpan + threadIdx.x;
  const uint32_t row0 = (uint32_t)r * (uint32_t)n;
  const long long masked = packed_key(-__int_as_float(0x7F800000), 0);
  Top3 top;
#pragma unroll 4
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads;
    if (i >= n) break;
    const int rev = n - 1 - i;
    long long k;
    if (mask[i]) {
      k = packed_key(__fadd_rn(0.0f, gumbel(k0, k1, row0 + (uint32_t)i)),
                     rev);
    } else {
      k = masked | (uint32_t)rev;    // -inf whatever the draw
    }
    top.insert(k);
  }
  top.warp_merge();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_top[warp][0] = top.a;
    warp_top[warp][1] = top.b;
    warp_top[warp][2] = top.c;
  }
  __syncthreads();
  if (warp != 0) return;
  Top3 blk;
  if (lane < kWarps) {
    blk.a = warp_top[lane][0];
    blk.b = warp_top[lane][1];
    blk.c = warp_top[lane][2];
  }
  blk.warp_merge();
  if (lane == 0) {
    long long* out = part + ((long long)r * gridDim.x + blockIdx.x) * 3;
    out[0] = blk.a;
    out[1] = blk.b;
    out[2] = blk.c;
  }
}

// one warp a row: the top 3 of its blocks' triples -> the row's indices,
// largest key first
__global__ void merge_top3_kernel(const long long* __restrict__ part,
                                  int blocks, int n,
                                  long long* __restrict__ triples) {
  const int r = blockIdx.x, lane = threadIdx.x;
  const long long* row = part + (long long)r * blocks * 3;
  Top3 top;
  for (int j = lane; j < blocks * 3; j += 32) top.insert(row[j]);
  top.warp_merge();
  if (lane == 0) {
    long long* out = triples + (long long)r * 3;
    out[0] = (n - 1) - (top.a & 0xFFFFFFFFll);
    out[1] = (n - 1) - (top.b & 0xFFFFFFFFll);
    out[2] = (n - 1) - (top.c & 0xFFFFFFFFll);
  }
}

}  // namespace

extern "C" {

// The point blocks a row is cut into: the wrapper sizes the scratch
// (iters, blocks, 3) int64 with it.
int ransac_blocks(int n) { return (n + kSpan - 1) / kSpan; }

int ransac_gumbel_top3(unsigned int k0, unsigned int k1,
                       const unsigned char* mask, int n, int iters,
                       long long* part, long long* triples, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = ransac_blocks(n);
  gumbel_top3_kernel<<<dim3(blocks, iters), kThreads, 0, st>>>(
      k0, k1, mask, n, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_top3_kernel<<<iters, 32, 0, st>>>(part, blocks, n, triples);
  return (int)cudaGetLastError();
}

}  // extern "C"
