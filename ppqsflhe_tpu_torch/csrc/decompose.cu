// The key switch's digit assembly: the own-group Shoup product and the
// stacked digit tensor in one pass.
//
// Replaces no TPU kernel: the JAX package's ckks/eval.py keyswitch_core
// leaves the product by [Qhat_j^-1]_{q_i}, the concatenation of each digit
// and their stack to XLA, which fused them into their neighbours. Plain
// torch version: ops/cuda_decompose.py digits_plain (core/modarith.py
// shoup_mul, ~31 int64 launches over the group's rows, a torch.cat a digit
// and a torch.stack); wrapper: ops/cuda_decompose.py. For digit j (group
// rows lo..hi-1), batch b, extended row r < LK = l + K and coefficient k:
//   out[b, j, r, k] = c[b, r, k] * [Qhat_j^-1]_{q_r} mod q_r   lo <= r < hi
//   out[b, j, r, k] = ext_j[b, r', k]                          otherwise,
// r' = r below lo and r - (hi - lo) above: the digit's extension to the
// other limbs, already in the evaluation domain. The product is a strict
// Shoup product (c < q gives [0, q)): the plain version's bits.
//
// What bounds it: bytes. Per coefficient it reads one word (of c or of the
// extension) and writes one, against at most a Shoup product (three 64-bit
// multiplies), so the least time is 2 * B * nd * LK * N * 8 bytes at
// 3.35 TB/s. Design: keep the memory busy and issue nothing else.
// - Grid: (coefficient blocks, extended row, batch), one launch a digit into
//   the preallocated (B, nd, LK, N) output. A block finds its row, its
//   branch (product or copy) and its constants from blockIdx alone: no
//   divergence, no division.
// - Each thread takes PAIRS pairs of neighbouring coefficients with 16-byte
//   loads and stores, every load issued before the arithmetic.
// - c is read in place through the batch and limb strides it is given (the
//   ciphertext's c1, ct.data[..., 1, :, :], batch stride 2 * l * N), not
//   copied contiguous first; the extension and out are contiguous.
// - A masked edge takes any even N (a small ring, a shard's width N/D).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PAIRS = 2;                    // 16-byte pairs a thread
constexpr int SPAN = THREADS * PAIRS;       // pairs a block

// c: row (b, i) at c + b * c_batch + i * c_limb; ext: (Bf, LK - (hi - lo), n);
// out: (Bf, nd, LK, n), digit j written; qs, ws, wss: per group row q_i,
// [Qhat_j^-1]_{q_i} and its Shoup companion
__global__ void __launch_bounds__(THREADS)
decompose_kernel(const uint64_t* __restrict__ c, const uint64_t* __restrict__ ext,
                 uint64_t* __restrict__ out, const uint64_t* __restrict__ qs,
                 const uint64_t* __restrict__ ws, const uint64_t* __restrict__ wss,
                 int64_t c_batch, int64_t c_limb, int nd, int j, int lo, int hi, int LK, int n,
                 int b0) {
  const int r = blockIdx.y;
  const int64_t b = b0 + static_cast<int64_t>(blockIdx.z);
  ulonglong2* orow = reinterpret_cast<ulonglong2*>(out + ((b * nd + j) * LK + r) * n);
  const int half = n / 2;
  const int p0 = blockIdx.x * SPAN + threadIdx.x;
  ulonglong2 v[PAIRS];
  if (r >= lo && r < hi) {
    const int i = r - lo;
    const uint64_t q = qs[i], w = ws[i], wsh = wss[i];
    const ulonglong2* cr = reinterpret_cast<const ulonglong2*>(c + b * c_batch + r * c_limb);
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int p = p0 + k * THREADS;
      if (p < half) v[k] = cr[p];
    }
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int p = p0 + k * THREADS;
      if (p < half)
        orow[p] = make_ulonglong2(ppq::shoup(v[k].x, w, wsh, q), ppq::shoup(v[k].y, w, wsh, q));
    }
  } else {
    const int rows = LK - (hi - lo);
    const int rr = r < lo ? r : r - (hi - lo);
    const ulonglong2* er = reinterpret_cast<const ulonglong2*>(ext + (b * rows + rr) * n);
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int p = p0 + k * THREADS;
      if (p < half) v[k] = er[p];
    }
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const int p = p0 + k * THREADS;
      if (p < half) orow[p] = v[k];
    }
  }
}

}  // namespace

// c: Bf rows of at least hi limbs, n even, its strides even and its pointer
// 16-byte aligned; ext: (Bf, LK - (hi - lo), n) and out: (Bf, nd, LK, n)
// contiguous and 16-byte aligned; q, w, w_sh: hi - lo words each.
extern "C" int ppq_decompose_digit(const void* c, const void* ext, void* out, const void* q,
                                   const void* w, const void* w_sh, long long c_batch,
                                   long long c_limb, int Bf, int nd, int j, int lo, int hi,
                                   int LK, int n, void* stream) {
  if (Bf < 1 || nd < 1 || j < 0 || j >= nd || lo < 0 || hi <= lo || hi > LK || LK > 65535 ||
      n < 2 || n % 2 || c_batch % 2 || c_limb % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned bx = static_cast<unsigned>((n / 2 + SPAN - 1) / SPAN);
  for (int b0 = 0; b0 < Bf; b0 += 65535) {
    const unsigned bz = static_cast<unsigned>(Bf - b0 < 65535 ? Bf - b0 : 65535);
    decompose_kernel<<<dim3(bx, LK, bz), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(c), static_cast<const uint64_t*>(ext),
        static_cast<uint64_t*>(out), static_cast<const uint64_t*>(q),
        static_cast<const uint64_t*>(w), static_cast<const uint64_t*>(w_sh), c_batch, c_limb,
        nd, j, lo, hi, LK, n, b0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
