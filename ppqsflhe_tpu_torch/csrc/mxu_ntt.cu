// Digit-matmul four-step NTT stages on Hopper's int8 tensor cores.
//
// Two entry points share one stage body:
//
// - ppq_mxu_ntt_stage (kernel `mxu_ntt_stage_kernel`) replaces
//   ppqsflhe_tpu/ops/pallas_mxu_ntt.py, PallasMxuNtt._run_group (the fused
//   Shoup-twiddle kernel; its pallas_call is at :390). That kernel ran both
//   column transforms of one (limb, ciphertext) in VMEM: digitize → int8 MXU
//   dot → REDC recompose → twiddle → transpose → digitize → dot → REDC → two
//   csubs. Here it is two launches: stage 1 stores transposed, stage 2 in
//   place.
// - ppq_mxu_ntt_stage_mont (kernel `mxu_ntt_stage_mont_kernel`) replaces the
//   same function's mont=True branch (pallas_mxu_ntt.py:347-350): the
//   twiddle is a lazy Montgomery product against one table w*2^64 mod q
//   (tables :211-229, constant -q^{-1} mod 2^64 at :203-208) instead of the
//   Shoup pair (w, floor(w*2^64/q)). On the TPU it existed to fit VMEM: the
//   2-plane table let the nd=6 group at N=2^16 stay fused. Here the twiddle
//   is read once per coefficient from device memory in stage 1's epilogue
//   either way, so what it changes is 8 of the 16 table bytes per
//   coefficient against one more 64-bit high product (__umul64hi); stage 2
//   is kernel 1's. Both launches of a transform run this symbol, so the
//   profiler and the launch count tell it from kernel 1.
//
// The streamed pair of PallasMxuNttBig (kernels 4 and 5) is not a digit
// product on this card: csrc/streamed_ntt.cu.
//
// Plain torch versions: ops/mxu_ntt.py (mxu_ntt_limb/mxu_intt_limb with
// mont=False/True).
//
// What bounds it here: a stage matrix is (nd*m)^2 int8 — 1.33 MB for a 60-bit
// limb at m=128 (nd=9), 5.3 MB at m=256 — far above the 227 KB of shared
// memory a block can use, so the matrix cannot stay resident the way it did
// in VMEM. The work is an int8 GEMM per limb:
// M = nd*m rows (plane e, output row k), K = nd*m (digit d, input row j),
// N = B*c columns (every ciphertext of the batch side by side). Its arithmetic
// is 2*M*K*N int8 ops, well under the tensor cores' rate; what costs is
// re-reading the matrix tiles from L2 and the digitize prologue.
//
// Design: a block owns 16 output rows k for ALL nd planes (so the REDC
// recompose of a coefficient happens in the block that accumulated its
// planes) and 64 columns; it walks the contraction in chunks of 32 (one
// mma.sync m16n8k32 step): the matrix chunk is copied to shared memory, the
// column chunk is digitized straight from the int64 residues into shared
// memory, and each of the 4 warps issues nd*2 mma.sync.s8 per chunk into
// int32 accumulators. Exactness: nd*m ≤ 9*256 terms of ≤ 127^2 stay below
// 2^31 (the host asserts it). The epilogue recomposes (one Montgomery
// reduction by R = 2^28 without a 128-bit product), then either applies the
// lazy twiddle (Shoup or Montgomery) or two conditional subtracts, and stores
// in the layout the entry point asks for. wgmma/TMA and keeping the
// digitized columns resident are later work.
#include "common.cuh"

namespace {

constexpr int TK = 16;      // output rows per block (one m16 tile per plane)
constexpr int TN = 64;      // output columns per block
constexpr int KC = 32;      // contraction chunk (one m16n8k32 step)
constexpr int MAX_ND = 9;   // 7-bit digits of a value < 2^62
constexpr int THREADS = 128;
constexpr int SPLIT_BITS = 28;   // REDC by R = 2^(7*4): the uniform plan
constexpr int INFO = 6;          // per limb: mat_off, nd, q, qinv_r, tw_off, qinv64

// the elementwise step between the product and the store
enum Twiddle { CSUB, SHOUP, MONT };

struct Smem {
  int8_t As[MAX_ND][TK][KC];
  int8_t Bs[TN][KC];
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One column stage over limb blockIdx.z: contraction rows j < m of x
// (B, L, m, c), columns (b, cc) with cc < c.
//   TW:       SHOUP: lazy Shoup twiddle of row k, column cc by
//             tw[info[4] + k*c + cc] (its companion m*c
//             further on), output < 2q; MONT: lazy Montgomery product by the
//             same entry of a w*2^64 mod q table with info[5] = -q^{-1} mod
//             2^64, output < 1.25q; CSUB: two csubs, output < q.
//   STORE_T:  y is (B, L, c, m); else (B, L, m, c).
template <Twiddle TW, bool STORE_T>
__device__ __forceinline__ void stage_body(Smem& sm, const uint64_t* __restrict__ x,
                                           uint64_t* __restrict__ y,
                                           const int8_t* __restrict__ mats,
                                           const int64_t* __restrict__ info,
                                           const uint64_t* __restrict__ tw, int B, int L,
                                           int m, int c) {
  const int limb = blockIdx.z;
  const int64_t* inf = info + INFO * limb;
  const int8_t* A = mats + inf[0];
  const int nd = static_cast<int>(inf[1]);
  const uint64_t q = static_cast<uint64_t>(inf[2]);
  const uint64_t qinv_r = static_cast<uint64_t>(inf[3]);
  const int k0 = blockIdx.y * TK;
  const int col0 = blockIdx.x * TN;
  const int ncol = B * c;
  const int width = nd * m;                      // matrix row length (bytes)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  int acc[MAX_ND][2][4];
#pragma unroll
  for (int e = 0; e < MAX_ND; ++e)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[e][nt][i] = 0;

  // digitize mapping: this thread fills column bcol, contraction rows
  // [16*jhalf, 16*jhalf + 16) of the chunk
  const int bcol = tid & (TN - 1);
  const int jhalf = tid >> 6;
  const int gcol = col0 + bcol;
  const bool col_ok = gcol < ncol;
  const uint64_t* xcol = x;
  if (col_ok) {
    const int b = gcol / c, cc = gcol - b * c;
    xcol = x + (static_cast<int64_t>(b) * L + limb) * m * c + cc;
  }

  const int nchunks = width / KC;
  for (int kc = 0; kc < nchunks; ++kc) {
    const int d = (kc * KC) / m;                  // input digit of this chunk
    const int j0 = kc * KC - d * m;               // first input row
    // matrix chunk: rows (e, k0 + r), bytes [kc*32, kc*32 + 32), 16 B at a time
    for (int v = tid; v < nd * TK * 2; v += THREADS) {
      const int e = v / (TK * 2), r = (v >> 1) % TK, half = v & 1;
      const int8_t* src = A + static_cast<int64_t>(e * m + k0 + r) * width + kc * KC + half * 16;
      *reinterpret_cast<int4*>(&sm.As[e][r][half * 16]) = *reinterpret_cast<const int4*>(src);
    }
    // column chunk: digit d of x[j0 + jj][col], packed 4 per word
    uint32_t packed[4];
#pragma unroll
    for (int w4 = 0; w4 < 4; ++w4) {
      uint32_t word = 0;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int jj = jhalf * 16 + w4 * 4 + bb;
        const uint64_t v = col_ok ? xcol[static_cast<int64_t>(j0 + jj) * c] : 0;
        word |= (static_cast<uint32_t>(v >> (7 * d)) & 127u) << (8 * bb);
      }
      packed[w4] = word;
    }
    *reinterpret_cast<uint4*>(&sm.Bs[bcol][jhalf * 16]) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
    __syncthreads();

    uint32_t bf[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = warp * 16 + nt * 8 + g;
      bf[nt][0] = *reinterpret_cast<const uint32_t*>(&sm.Bs[n][t * 4]);
      bf[nt][1] = *reinterpret_cast<const uint32_t*>(&sm.Bs[n][16 + t * 4]);
    }
#pragma unroll
    for (int e = 0; e < MAX_ND; ++e) {
      if (e < nd) {
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(&sm.As[e][g][t * 4]);
        af[1] = *reinterpret_cast<const uint32_t*>(&sm.As[e][g + 8][t * 4]);
        af[2] = *reinterpret_cast<const uint32_t*>(&sm.As[e][g][16 + t * 4]);
        af[3] = *reinterpret_cast<const uint32_t*>(&sm.As[e][g + 8][16 + t * 4]);
        mma_s8(acc[e][0], af, bf[0]);
        mma_s8(acc[e][1], af, bf[1]);
      }
    }
    __syncthreads();
  }

  // epilogue: recompose each accumulated coefficient
  const uint64_t mask = (1ull << SPLIT_BITS) - 1;
  const uint64_t q_lo = q & mask, q_hi = q >> SPLIT_BITS;
  const uint64_t* tw_w = tw + inf[4];
  const uint64_t* tw_s = tw_w + static_cast<int64_t>(m) * c;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + g + 8 * (i >> 1);
      const int col = col0 + warp * 16 + nt * 8 + t * 2 + (i & 1);
      if (col >= ncol) continue;
      const int b = col / c, cc = col - b * c;
      uint64_t s_lo = 0, hi_grp = 0;
#pragma unroll
      for (int e = 0; e < MAX_ND; ++e) {
        if (e < nd) {
          const uint64_t p = static_cast<uint32_t>(acc[e][nt][i]);
          if (e < 4) s_lo += p << (7 * e);
          else hi_grp += p << (7 * (e - 4));
        }
      }
      // REDC by R = 2^28: (s_lo + mm*q) / R with q = q_hi*R + q_lo
      const uint64_t mm = ((s_lo & mask) * qinv_r) & mask;
      uint64_t u = ((s_lo + mm * q_lo) >> SPLIT_BITS) + mm * q_hi + hi_grp;  // < 4q
      if (TW == SHOUP) {
        const int64_t ti = static_cast<int64_t>(k) * c + cc;
        u = ppq::shoup_lazy(u, tw_w[ti], tw_s[ti], q);                        // < 2q
      } else if (TW == MONT) {
        const int64_t ti = static_cast<int64_t>(k) * c + cc;
        u = ppq::mont_lazy(u, tw_w[ti], q, static_cast<uint64_t>(inf[5]));    // < 2q
      } else {
        u = u >= 2 * q ? u - 2 * q : u;
        u = u >= q ? u - q : u;
      }
      const int64_t base = static_cast<int64_t>(b) * L + limb;
      if (STORE_T) y[(base * c + cc) * m + k] = u;
      else y[(base * m + k) * c + cc] = u;
    }
  }
}

// kernel 1: stage 1 (twiddle, transposed store) or stage 2 (csubs, in place)
__global__ void __launch_bounds__(THREADS)
mxu_ntt_stage_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                     const int8_t* __restrict__ mats, const int64_t* __restrict__ info,
                     const uint64_t* __restrict__ tw, int B, int L, int m, int c,
                     int twiddle) {
  __shared__ __align__(16) Smem sm;
  if (twiddle) stage_body<SHOUP, true>(sm, x, y, mats, info, tw, B, L, m, c);
  else stage_body<CSUB, false>(sm, x, y, mats, info, tw, B, L, m, c);
}

// kernel 1b: the same two stages with the Montgomery twiddle
__global__ void __launch_bounds__(THREADS)
mxu_ntt_stage_mont_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                          const int8_t* __restrict__ mats, const int64_t* __restrict__ info,
                          const uint64_t* __restrict__ tw, int B, int L, int m, int c,
                          int twiddle) {
  __shared__ __align__(16) Smem sm;
  if (twiddle) stage_body<MONT, true>(sm, x, y, mats, info, tw, B, L, m, c);
  else stage_body<CSUB, false>(sm, x, y, mats, info, tw, B, L, m, c);
}

dim3 grid_of(int B, int L, int m, int c) { return dim3((B * c + TN - 1) / TN, m / TK, L); }

}  // namespace

// x: (B, L, m, c) int64, contracted over the m rows.
// y: (B, L, c, m) when twiddle (stage 1, transposed store), else (B, L, m, c).
extern "C" int ppq_mxu_ntt_stage(const void* x, void* y, const void* mats, const void* info,
                                 const void* tw, int B, int L, int m, int c, int twiddle,
                                 void* stream) {
  mxu_ntt_stage_kernel<<<grid_of(B, L, m, c), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y),
      static_cast<const int8_t*>(mats), static_cast<const int64_t*>(info),
      static_cast<const uint64_t*>(tw), B, L, m, c, twiddle);
  return static_cast<int>(cudaGetLastError());
}

// kernel 1b: as ppq_mxu_ntt_stage, with tw holding w*2^64 mod q tables.
extern "C" int ppq_mxu_ntt_stage_mont(const void* x, void* y, const void* mats,
                                      const void* info, const void* tw, int B, int L, int m,
                                      int c, int twiddle, void* stream) {
  mxu_ntt_stage_mont_kernel<<<grid_of(B, L, m, c), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y),
      static_cast<const int8_t*>(mats), static_cast<const int64_t*>(info),
      static_cast<const uint64_t*>(tw), B, L, m, c, twiddle);
  return static_cast<int>(cudaGetLastError());
}
