// jax.random's threefry2x32 for Hopper (sm_90a), shared by ransac.cu
// (kernel 13) and select.cu (kernel 14).
//
// threefry2x32 with 20 rounds, as jax's threefry2x32_p computes it, of key
// (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) over the counter pair (0, c): jax's
// partitionable layout (jax_threefry_partitionable=True) gives the i-th
// number of a draw of shape (n,) the pair (0, i), and the numbers of a
// draw of shape (rows, n) the pairs (0, r * n + i mod 2^32), as
// vilgod_tpu_torch/ops/random._unit_floats lays them out. Only the xor of
// the two output words is used (jax.random's 32-bit bits).

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// threefry2x32 (20 rounds) of key (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) over the
// counter pair (0, c): y0 ^ y1
__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1,
                                                 uint32_t c) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0, x1 = c + k1;
#define VILGOD_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
  VILGOD_ROUND(13) VILGOD_ROUND(15) VILGOD_ROUND(26) VILGOD_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  VILGOD_ROUND(17) VILGOD_ROUND(29) VILGOD_ROUND(16) VILGOD_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  VILGOD_ROUND(13) VILGOD_ROUND(15) VILGOD_ROUND(26) VILGOD_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  VILGOD_ROUND(17) VILGOD_ROUND(29) VILGOD_ROUND(16) VILGOD_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  VILGOD_ROUND(13) VILGOD_ROUND(15) VILGOD_ROUND(26) VILGOD_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef VILGOD_ROUND
  return x0 ^ x1;
}

// jax.random.uniform's float32 in [0, 1) from the bits of counter c: 23
// random mantissa bits under the exponent of 1.0, minus 1 (exact)
__device__ __forceinline__ float unit_float(uint32_t k0, uint32_t k1,
                                            uint32_t c) {
  const uint32_t bits = (threefry_xor(k0, k1, c) >> 9) | 0x3F800000u;
  return __fsub_rn(__uint_as_float(bits), 1.0f);
}

}  // namespace
