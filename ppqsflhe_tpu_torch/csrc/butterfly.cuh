// Register-blocked Shoup butterflies of the four-step NTT's column stages,
// shared by kernels 1 and 1b (csrc/mxu_ntt.cu), 4 and 5
// (csrc/streamed_ntt.cu) and 6 (csrc/fourstep_ntt.cu).
//
// A stage transforms an m-point column (m = 2^LOGM, 8 <= m <= 256) held by
// T = m/R threads of R values each: R = 16, or R = m when m <= 16. The Pease
// network of the plain versions (ops/fourstep.py _col_gs_cg / _col_ct_cg),
// read by row label, is the in-place DIF (GS) or DIT (CT) network: stage s
// pairs rows a and a + (m >> (s + 1)), with twiddle root^((a mod d) << s)
// taken from Pease row 0 (root^i, i < m/2). The top log2(R) bits of the row
// are the thread's own (label t + T*k), so stages 0..log2(R)-1 run in
// registers. For m >= 32 one exchange through shared memory then gives each
// thread 16 consecutive rows (label 16*t + k), and stages 4..LOGM-1 run in
// registers too; for m <= 16 one thread holds the whole column (t = 0, both
// labels are k) and every stage runs in registers, with no exchange. The
// inverse network runs the other way round. Values stay < 2q between stages
// (Harvey-lazy).
//
// A block owns one tile of TC columns (or, in kernel 5, TC rows) of one
// (poly, limb), TC in {1, 2, 4, 8, 16}: T*TC threads, thread tid on column
// tid % TC with t = tid / TC.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ppq {

constexpr int TC_MAX = 16;  // the widest tile: columns (or rows) a block
constexpr int INFO = 4;     // per limb: q, vector, Pease row 0 and twiddle offsets

// values a thread holds of an m-point column, m = 2^logm
__host__ __device__ constexpr int rows_of(int logm) { return logm < 4 ? 1 << logm : 16; }
// threads of a block over tc columns of m-point columns
__host__ __device__ constexpr int threads_of(int logm, int tc) {
  return (1 << logm) / rows_of(logm) * tc;
}
__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

// one copy of a row segment of a TC-wide tile: two int64 (16 bytes, both
// ends 16-byte aligned), or one when TC = 1 (an 8-byte segment at any column)
template <int TC>
__host__ __device__ constexpr int seg_of() { return TC == 1 ? 1 : 2; }

template <int TC>
__device__ __forceinline__ void cp_async_seg(void* smem, const void* gmem) {
  if constexpr (TC == 1) cp_async8(smem, gmem);
  else cp_async16(smem, gmem);
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

// Stages s = 0..log2(R)-1 (GS; CT: the reverse) on values of row labels
// t + T*k, k < R. The pair of stage s is (a, a + d), d = m >> (s + 1), i.e.
// k and k + (R/2 >> s); its twiddle is root^((a mod d) << s).
template <bool FWD, int R>
__device__ __forceinline__ void high_stages(uint64_t (&v)[R], int t, int T, const uint64_t* rw,
                                            const uint64_t* rs, uint64_t q, uint64_t q2) {
  constexpr int S = ilog2(R);
#pragma unroll
  for (int it = 0; it < S; ++it) {
    const int s = FWD ? it : S - 1 - it;
    const int dk = (R / 2) >> s;
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
// 16*t + k: d = 1 << (LOGM - 1 - s) < 16, the pair is k and k + d. None for
// m <= 16.
template <int LOGM, bool FWD, int R>
__device__ __forceinline__ void low_stages(uint64_t (&v)[R], const uint64_t* rw,
                                           const uint64_t* rs, uint64_t q, uint64_t q2) {
  if constexpr (LOGM > 4) {
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
}

// The exchange between the two halves of the network through the thread's
// column in shared memory (row a at col[a * st]): forward, store labels
// t + T*k and load 16*t + k; inverse the other way round. A barrier in
// between; nothing at all for m <= 16, where one thread holds the column.
template <int LOGM, bool FWD, int R>
__device__ __forceinline__ void exchange(uint64_t (&v)[R], uint64_t* col, int st, int t) {
  if constexpr (LOGM > 4) {
    constexpr int T = (1 << LOGM) / R;
#pragma unroll
    for (int k = 0; k < R; ++k) col[(FWD ? t + T * k : R * t + k) * st] = v[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = col[(FWD ? R * t + k : t + T * k) * st];
  }
}

// The tile width TC of a block over w columns (kernel 5: rows): TC_MAX for
// whole tiles, else w itself when it is one of the NARROW widths. Runs
// launch(std::integral_constant<int, TC>{}) and returns its code;
// cudaErrorInvalidValue for any other w. ops/streamed_ntt.py tile_width is
// its twin: kernels 4 and 5 take every power of two below TC_MAX, kernels 1,
// 1b and 6 the widths of fused_tiles.
template <int... NARROW, typename Launch>
int with_tile(int w, Launch&& launch) {
  if (w > 0 && w % TC_MAX == 0) return launch(std::integral_constant<int, TC_MAX>{});
  int code = static_cast<int>(cudaErrorInvalidValue);
  (void)((w == NARROW && (code = launch(std::integral_constant<int, NARROW>{}), true)) || ...);
  return code;
}

// kernels 1, 1b and 6: whole 16-column tiles, or 8 columns at m <= 16 (the
// 8-column stages of N = 2^6 and 2^7; every larger m has at least 16)
template <int LOGM, typename Launch>
int fused_tiles(int c, Launch&& launch) {
  if constexpr (LOGM <= 4) return with_tile<8>(c, launch);
  else return with_tile<>(c, launch);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace ppq
