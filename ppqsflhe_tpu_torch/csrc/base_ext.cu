// HPS fast base extension src → dst, optionally with the key-switch digit
// constant folded in.
//
// Replaces: ppqsflhe_tpu/ops/pallas_ext.py, _build's kernel (pallas_call at
// :167, entry fused_extend at :184). Plain torch version: core/rns.py
// BaseExtender.extend. Per coefficient:
//   y_i   = x_i * C_i mod d_i            (C_i = [(D/d_i)^-1 * pre_i]_{d_i})
//   alpha = carries + round bit of the wrapping Q0.64 sum of y_i*round(2^64/d_i)
//   z_j   = sum_i y_i*[D/d_i]_{p_j} - alpha*[D]_{p_j}   (mod p_j)
//
// What bounds it here: memory. Per coefficient it reads ls*8 B and writes
// ld*8 B (ls, ld <= 3 on the main path) against ~4*ls*ld 64-bit multiplies,
// far below the card's integer rate. Design: one thread per (batch,
// coefficient), neighbouring threads on neighbouring coefficients so every
// load and store is coalesced; the per-(src, dst, pre) constants sit in a
// small device table (a few hundred bytes, served from L1/constant cache).
// The TPU kernel baked them into the kernel body instead, which meant one
// compile per (src, dst, pre); a table keeps one binary for every basis pair.
#include "common.cuh"

namespace {

constexpr int MAX_SRC = 8;
constexpr int THREADS = 256;

// k (uint64): per src i: [q_i, C_i, Shoup(C_i), round(2^64/q_i)] (4*ls);
// then per dst j: [p_j, [D]_{p_j}, Shoup] (3*ld);
// then per (j, i): [[D/d_i]_{p_j}, Shoup] (2*ld*ls)
__global__ void __launch_bounds__(THREADS)
base_extend_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
                   const uint64_t* __restrict__ k, int Bf, int ls, int ld, int n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= static_cast<int64_t>(Bf) * n) return;
  const int64_t b = idx / n, co = idx - b * n;
  const uint64_t* kd = k + 4 * ls;
  const uint64_t* km = kd + 3 * ld;

  uint64_t y[MAX_SRC];
  uint64_t acc = 0, carry = 0;
#pragma unroll
  for (int i = 0; i < MAX_SRC; ++i) {
    if (i < ls) {
      const uint64_t xi = x[(b * ls + i) * n + co];
      const uint64_t yi = ppq::shoup(xi, k[4 * i + 1], k[4 * i + 2], k[4 * i]);
      y[i] = yi;
      const uint64_t nxt = acc + yi * k[4 * i + 3];   // wrapping Q0.64 sum
      carry += nxt < acc;
      acc = nxt;
    }
  }
  const uint64_t alpha = carry + (acc >> 63);
  for (int j = 0; j < ld; ++j) {
    const uint64_t p = kd[3 * j];
    uint64_t z = 0;
#pragma unroll
    for (int i = 0; i < MAX_SRC; ++i) {
      if (i < ls) {
        const uint64_t* w = km + 2 * (j * ls + i);
        z = ppq::modadd(z, ppq::shoup_wide(y[i], w[0], w[1], p), p);
      }
    }
    const uint64_t corr = ppq::shoup(alpha, kd[3 * j + 1], kd[3 * j + 2], p);
    out[(b * ld + j) * n + co] = ppq::modsub(z, corr, p);
  }
}

}  // namespace

extern "C" int ppq_base_extend(const void* x, void* out, const void* consts, int Bf, int ls,
                               int ld, int n, void* stream) {
  if (ls > MAX_SRC) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(Bf) * n;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  base_extend_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(consts), Bf, ls, ld, n);
  return static_cast<int>(cudaGetLastError());
}
