// Kernel 2: the HPS fast base extension src -> dst, optionally with the
// key-switch digit constant folded in.
//
// Replaces: ppqsflhe_tpu/ops/pallas_ext.py, _build's kernel (pallas_call at
// :167, entry fused_extend at :184). Plain torch version: core/rns.py
// BaseExtender.extend; wrapper: ops/cuda_ext.py. Per coefficient:
//   y_i   = x_i * C_i mod d_i            (C_i = [(D/d_i)^-1 * pre_i]_{d_i})
//   alpha = carries + round bit of the wrapping Q0.64 sum of y_i*round(2^64/d_i)
//   z_j   = sum_i y_i*[D/d_i]_{p_j} - alpha*[D]_{p_j}   (mod p_j)
// The output is canonical and bit-equal to the plain version.
//
// What bounds it: bytes. Per coefficient it reads ls*8 B and writes ld*8 B
// (ls <= 3, ld <= 4 on the port's paths) against (1 + ld)*ls + ld 64-bit
// Shoup products, each three 64-bit multiplies that the card builds from
// 32-bit IMADs. At 2 -> 3 limbs the arithmetic is within a small factor of
// the bytes' time, so the thread has to issue nothing else: no 64-bit
// division for its batch index, no loop of runtime length, no constant
// reloaded from a global table. Design:
// - Grid: coefficient blocks x batch items, no division; each thread takes
//   two neighbouring coefficients with 16-byte loads and stores.
// - Instances: templates on (LS, LD) for the shapes the port's paths launch
//   (PPQ_EXT_INSTANCES), every loop unrolled; one generic instance with
//   runtime counts up to MAX_SRC / MAX_DST takes any other shape.
// - Constants: one ExtParams struct passed by value (1,480 bytes, in the
//   kernel-parameter constant bank), each read an operand of its
//   instruction, instead of a per-thread global table.
// - Deferred reductions: each term y_i*w_ji is a lazy Shoup product, < 2p
//   for any y_i < 2^64 (w_ji < p); the sum of ls of them is < 2*ls*p
//   <= 16p < 2^64 (p < 2^60, ls <= 8). The alpha correction joins the sum
//   unreduced (correct()), and one chain of conditional subtracts of 8p,
//   4p, 2p and p, as many as the bound needs, ends each destination, instead
//   of a modular add after every term and a strict product for alpha.
// - alpha is computed exactly as the plain version does: it decides the
//   output.
// - nvcc -Xptxas -v (sm_90a, probes/kernel_report.py): 24-42 registers in
//   the unrolled instances (32 at 2 -> 3 limbs), 63 in the generic one; no
//   spill, no shared memory. SASS: 592 instructions at 2 -> 3 limbs, straight
//   code for two coefficients (296 a coefficient); 4416 in the generic one.
#include "common.cuh"

constexpr int MAX_SRC = 8;
constexpr int MAX_DST = 8;       // ops/cuda_ext.py launches larger dst bases in chunks

// The (LS, LD) instances; ops/cuda_ext.py INSTANCES lists the same.
#define PPQ_EXT_INSTANCES(X) \
  X(1, 1) X(1, 2) X(1, 3) X(1, 4) X(2, 1) X(2, 2) X(2, 3) X(2, 4) X(3, 1) X(3, 2) X(3, 3) X(3, 4)

// ops/cuda_ext.py ExtParams mirrors this layout field for field.
struct ExtParams {
  uint64_t q[MAX_SRC];               // src moduli d_i
  uint64_t c[MAX_SRC];               // C_i
  uint64_t c_sh[MAX_SRC];            // floor(C_i * 2^64 / d_i)
  uint64_t recip[MAX_SRC];           // round(2^64 / d_i)
  uint64_t p[MAX_DST];               // dst moduli p_j
  uint64_t dc[MAX_DST];              // [D]_{p_j}
  uint64_t dc_sh[MAX_DST];
  uint64_t w[MAX_DST][MAX_SRC];      // [D/d_i]_{p_j}
  uint64_t w_sh[MAX_DST][MAX_SRC];
  int ls, ld;                        // the generic instance's counts
};

namespace {

constexpr int THREADS = 256;

enum Work { FULL, BYTES, ARITH };    // BYTES, ARITH: the time split of probes/kernel_report

// s < BOUND*p (BOUND <= 16) -> s mod p: each conditional subtract of k*p
// takes s < 2k*p below k*p
template <int BOUND>
__device__ __forceinline__ uint64_t reduce(uint64_t s, uint64_t p) {
  if (BOUND > 8) s = s >= 8 * p ? s - 8 * p : s;
  if (BOUND > 4) s = s >= 4 * p ? s - 4 * p : s;
  if (BOUND > 2) s = s >= 2 * p ? s - 2 * p : s;
  if (BOUND > 1) s = s >= p ? s - p : s;
  return s;
}

// z = s - alpha*[D]_p mod p for the sum s < 2*ls*p of ls lazy terms. alpha
// <= ls (at most ls - 1 carries and the round bit), so alpha*[D]_p <=
// ls*(p - 1) and, in an unrolled instance (ls <= 3), s + ls*p -
// alpha*[D]_p lies in [0, 3*ls*p) within [0, 9p): one 32x64-bit product
// and the subtracts. The generic instance (ls <= 8, where 3*ls*p may pass
// 2^64) reduces s, then subtracts the strict Shoup product.
template <int LS>
__device__ __forceinline__ uint64_t correct(uint64_t s, uint64_t alpha, uint64_t dc,
                                            uint64_t dc_sh, uint64_t p) {
  if (LS) return reduce<3 * LS>(s + LS * p - static_cast<uint32_t>(alpha) * dc, p);
  return ppq::modsub(reduce<2 * MAX_SRC>(s, p), ppq::shoup(alpha, dc, dc_sh, p), p);
}

// x: (Bf, ls, n); out: (Bf, out_ld, n), this launch's dst limb j at row j.
// LS = LD = 0: the generic instance (prm.ls, prm.ld).
template <int LS, int LD, Work W>
__global__ void __launch_bounds__(THREADS)
base_extend_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
                   const ExtParams prm, int n, int out_ld, int b0) {
  constexpr int NS = LS ? LS : MAX_SRC, ND = LD ? LD : MAX_DST;
  const int ls = LS ? LS : prm.ls, ld = LD ? LD : prm.ld;
  const int co = 2 * (blockIdx.x * THREADS + threadIdx.x);
  if (co >= n) return;
  const int64_t b = b0 + blockIdx.y;
  const uint64_t* xb = x + b * ls * n + co;
  uint64_t* ob = out + b * out_ld * n + co;

  uint64_t y0[NS], y1[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (i < ls) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(xb + static_cast<int64_t>(i) * n);
      y0[i] = v.x;
      y1[i] = v.y;
    }
  }
  if (W == BYTES) {
    uint64_t h0 = 0, h1 = 0;
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (i < ls) h0 ^= y0[i], h1 ^= y1[i];
#pragma unroll
    for (int j = 0; j < ND; ++j)
      if (j < ld)
        *reinterpret_cast<ulonglong2*>(ob + static_cast<int64_t>(j) * n) =
            make_ulonglong2(h0 ^ j, h1 ^ j);
    return;
  }

  uint64_t acc0 = 0, acc1 = 0, carry0 = 0, carry1 = 0;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (i < ls) {
      const uint64_t q = prm.q[i], c = prm.c[i], cs = prm.c_sh[i], r = prm.recip[i];
      y0[i] = ppq::shoup(y0[i], c, cs, q);
      y1[i] = ppq::shoup(y1[i], c, cs, q);
      const uint64_t n0 = acc0 + y0[i] * r, n1 = acc1 + y1[i] * r;   // wrapping Q0.64 sums
      carry0 += n0 < acc0;
      carry1 += n1 < acc1;
      acc0 = n0;
      acc1 = n1;
    }
  }
  const uint64_t alpha0 = carry0 + (acc0 >> 63), alpha1 = carry1 + (acc1 >> 63);
  uint64_t h = 0;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    if (j < ld) {
      const uint64_t p = prm.p[j];
      uint64_t s0 = 0, s1 = 0;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (i < ls) {
          s0 += ppq::shoup_lazy(y0[i], prm.w[j][i], prm.w_sh[j][i], p);
          s1 += ppq::shoup_lazy(y1[i], prm.w[j][i], prm.w_sh[j][i], p);
        }
      }
      const uint64_t z0 = correct<LS>(s0, alpha0, prm.dc[j], prm.dc_sh[j], p);
      const uint64_t z1 = correct<LS>(s1, alpha1, prm.dc[j], prm.dc_sh[j], p);
      if (W == FULL)
        *reinterpret_cast<ulonglong2*>(ob + static_cast<int64_t>(j) * n) = make_ulonglong2(z0, z1);
      else
        h ^= z0 ^ z1;
    }
  }
  if (W == ARITH && h == ~0ull) ob[0] = h;   // never true (z < 2^60): no store
}

template <int LS, int LD, Work W>
int launch(const void* x, void* out, const ExtParams& prm, int Bf, int n, int out_ld,
           cudaStream_t stream) {
  const unsigned bx = static_cast<unsigned>((n / 2 + THREADS - 1) / THREADS);
  for (int b0 = 0; b0 < Bf; b0 += 65535) {
    const unsigned by = static_cast<unsigned>(Bf - b0 < 65535 ? Bf - b0 : 65535);
    base_extend_kernel<LS, LD, W><<<dim3(bx, by), THREADS, 0, stream>>>(
        static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out), prm, n, out_ld, b0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <Work W>
int dispatch(const void* x, void* out, const ExtParams& prm, int Bf, int n, int out_ld,
             cudaStream_t s) {
#define PPQ_EXT_CASE(A, B) \
  if (prm.ls == A && prm.ld == B) return launch<A, B, W>(x, out, prm, Bf, n, out_ld, s);
  PPQ_EXT_INSTANCES(PPQ_EXT_CASE)
#undef PPQ_EXT_CASE
  return launch<0, 0, W>(x, out, prm, Bf, n, out_ld, s);
}

}  // namespace

// x: (Bf, ls, n) int64, n even, 16-byte aligned; out: the first of ld dst
// rows of (Bf, out_ld, n). work 0: the kernel; 1 and 2: its bytes-only and
// arithmetic-only variants (measurement only).
extern "C" int ppq_base_extend(const void* x, void* out, ExtParams prm, int Bf, int n,
                               int out_ld, int work, void* stream) {
  if (prm.ls < 1 || prm.ls > MAX_SRC || prm.ld < 1 || prm.ld > MAX_DST || n % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (work == 1) return dispatch<BYTES>(x, out, prm, Bf, n, out_ld, s);
  if (work == 2) return dispatch<ARITH>(x, out, prm, Bf, n, out_ld, s);
  return dispatch<FULL>(x, out, prm, Bf, n, out_ld, s);
}
