// Native 64-bit modular helpers shared by the port's kernels.
//
// The JAX package synthesised every 64-bit product from 32-bit lane pairs
// (ppqsflhe_tpu/ops/u32pair.py) because the TPU's vector unit has no 64-bit
// multiply. Hopper has mul.lo.u64 and __umul64hi, so these are direct
// formulas; the contract kept is the u32-pair helpers' results, bit for bit.
// Residues are < 2^62; every modulus is < 2^60.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ppq {

// a*w mod q for a constant w with Shoup companion ws = floor(w*2^64/q);
// lazy: a < 4q gives [0, 2q)
__device__ __forceinline__ uint64_t shoup_lazy(uint64_t a, uint64_t w, uint64_t ws,
                                               uint64_t q) {
  return a * w - __umul64hi(a, ws) * q;
}

// strict Shoup product, a < q: [0, q)
__device__ __forceinline__ uint64_t shoup(uint64_t a, uint64_t w, uint64_t ws, uint64_t q) {
  uint64_t r = shoup_lazy(a, w, ws, q);
  return r >= q ? r - q : r;
}

// Shoup product for UNREDUCED a < 2^62: r < 3q, two conditional subtracts
__device__ __forceinline__ uint64_t shoup_wide(uint64_t a, uint64_t w, uint64_t ws,
                                               uint64_t q) {
  uint64_t r = shoup_lazy(a, w, ws, q);
  r = r >= 2 * q ? r - 2 * q : r;
  return r >= q ? r - q : r;
}

// Montgomery product a*b*2^-64 mod q (qinv = -q^{-1} mod 2^64) without the
// final subtract: a < 4q, b < q give [0, 2q)
__device__ __forceinline__ uint64_t mont_lazy(uint64_t a, uint64_t b, uint64_t q,
                                              uint64_t qinv) {
  const uint64_t lo = a * b;
  return __umul64hi(a, b) + __umul64hi(lo * qinv, q) + (lo != 0);
}

// -q^{-1} mod 2^64 for odd q, mont_lazy's constant: Newton's iteration
// x <- x*(2 - q*x) doubles the correct low bits, from 3 at x = q
__device__ __forceinline__ uint64_t neg_inv64(uint64_t q) {
  uint64_t x = q;
#pragma unroll
  for (int i = 0; i < 5; ++i) x *= 2 - q * x;
  return 0 - x;
}

// Montgomery product a*b*2^-64 mod q, a, b < q
__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b, uint64_t q,
                                             uint64_t qinv) {
  const uint64_t u = mont_lazy(a, b, q, qinv);
  return u >= q ? u - q : u;
}

__device__ __forceinline__ uint64_t modadd(uint64_t a, uint64_t b, uint64_t q) {
  uint64_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint64_t modsub(uint64_t a, uint64_t b, uint64_t q) {
  return a >= b ? a - b : a + q - b;
}

}  // namespace ppq
