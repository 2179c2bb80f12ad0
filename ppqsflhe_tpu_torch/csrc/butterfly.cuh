// Register-blocked Shoup butterflies of the four-step NTT's column stages,
// shared by kernels 1 and 1b (csrc/mxu_ntt.cu) and 4 and 5
// (csrc/streamed_ntt.cu).
//
// A stage transforms an m-point column (m = 2^LOGM, 32 <= m <= 256) held by
// m/16 threads, 16 values each. The Pease network of the plain versions
// (ops/fourstep.py _col_gs_cg / _col_ct_cg), read by row label, is the
// in-place DIF (GS) or DIT (CT) network: stage s pairs rows a and
// a + (m >> (s + 1)), with twiddle root^((a mod d) << s) taken from Pease
// row 0 (root^i, i < m/2). The top four bits of the row are the thread's own
// (label t + T*k, T = m/16), so stages 0..3 run in registers; one exchange
// through shared memory gives each thread 16 consecutive rows (label
// 16*t + k), and stages 4..LOGM-1 run in registers too. The inverse network
// runs the other way round. Values stay < 2q between stages (Harvey-lazy).
#pragma once

#include "common.cuh"

namespace ppq {

constexpr int TC = 16;      // columns (or rows) of a tile
constexpr int R = 16;       // values per thread
constexpr int INFO = 4;     // per limb: q, vector, Pease row 0 and twiddle offsets

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// copy n uint64 (n even, both ends 16-byte aligned) into shared memory
__device__ __forceinline__ void copy_block(uint64_t* dst, const uint64_t* src, int n, int tid,
                                           int nthreads) {
  for (int i = 2 * tid; i < n; i += 2 * nthreads) cp_async16(dst + i, src + i);
}

// Gentleman-Sande (forward) and Cooley-Tukey (inverse) butterflies of the
// plain _col_gs_cg / _col_ct_cg: inputs and outputs < 2q
__device__ __forceinline__ void gs(uint64_t& u, uint64_t& v, uint64_t w, uint64_t ws, uint64_t q,
                                   uint64_t q2) {
  uint64_t s = u + v;
  const uint64_t d = shoup_lazy(u + q2 - v, w, ws, q);
  u = s >= q2 ? s - q2 : s;
  v = d;
}

__device__ __forceinline__ void ct(uint64_t& u, uint64_t& v, uint64_t w, uint64_t ws, uint64_t q,
                                   uint64_t q2) {
  const uint64_t b = shoup_lazy(v, w, ws, q);
  const uint64_t s = u + b, d = u + q2 - b;
  u = s >= q2 ? s - q2 : s;
  v = d >= q2 ? d - q2 : d;
}

// Stages s = 0..3 (GS; CT: 3..0) on values of row labels t + T*k, k < 16.
// The pair of stage s is (a, a + d), d = m >> (s + 1), i.e. k and k + 8>>s;
// its twiddle is root^((a mod d) << s).
template <bool FWD>
__device__ __forceinline__ void high_stages(uint64_t (&v)[R], int t, int T, const uint64_t* rw,
                                            const uint64_t* rs, uint64_t q, uint64_t q2) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int s = FWD ? it : 3 - it;
    const int dk = 8 >> s;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k & dk) continue;
      const int e = (t + T * (k & (dk - 1))) << s;
      if (FWD) gs(v[k], v[k + dk], rw[e], rs[e], q, q2);
      else ct(v[k], v[k + dk], rw[e], rs[e], q, q2);
    }
  }
}

// Stages s = 4..LOGM-1 (GS; CT: LOGM-1..4) on values of row labels
// 16*t + k: d = 1 << (LOGM - 1 - s) < 16, the pair is k and k + d.
template <int LOGM, bool FWD>
__device__ __forceinline__ void low_stages(uint64_t (&v)[R], const uint64_t* rw,
                                           const uint64_t* rs, uint64_t q, uint64_t q2) {
#pragma unroll
  for (int it = 0; it < LOGM - 4; ++it) {
    const int s = FWD ? 4 + it : LOGM - 1 - it;
    const int d = 1 << (LOGM - 1 - s);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k & d) continue;
      const int e = (k & (d - 1)) << s;
      if (FWD) gs(v[k], v[k + d], rw[e], rs[e], q, q2);
      else ct(v[k], v[k + d], rw[e], rs[e], q, q2);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace ppq
