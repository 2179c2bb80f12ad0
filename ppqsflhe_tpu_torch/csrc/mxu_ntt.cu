// Kernels 1 and 1b: the fused four-step NTT's two column stages as Shoup
// butterflies.
//
// - ppq_mxu_ntt_stage (kernel `mxu_ntt_stage_kernel`) replaces
//   ppqsflhe_tpu/ops/pallas_mxu_ntt.py, PallasMxuNtt._run_group (the fused
//   Shoup-twiddle kernel; its pallas_call is at :390). That kernel ran both
//   column transforms of one (limb, ciphertext) in VMEM; here a transform is
//   two launches: stage 1 stores transposed, stage 2 in place.
// - ppq_mxu_ntt_stage_mont (kernel `mxu_ntt_stage_mont_kernel`) replaces the
//   same function's mont=True branch (pallas_mxu_ntt.py:347-350): stage 1's
//   twiddle is a lazy Montgomery product against one table w*2^64 mod q
//   (ppq::mont_lazy, with -q^{-1} mod 2^64 computed from q) instead of the
//   Shoup pair (w, floor(w*2^64/q)). On the TPU the two-plane table let the
//   nd=6 group at N=2^16 fit VMEM; here it halves stage 1's twiddle tile,
//   8 B per entry instead of 16 (70 KB of shared memory a block at m=256
//   instead of 102 KB: 3 blocks an SM instead of 2). Its stage 2 is kernel
//   1's; both launches of a transform run this symbol, so the profiler and
//   the launch count tell it from kernel 1.
//
// Plain torch versions: ops/cuda_mxu_ntt.py stage1_plain / stage2_plain.
//
// The function is the TPU kernel's: canonical outputs in the four-step
// kernel order, equal to the digit plain versions (ops/mxu_ntt.py
// mxu_ntt_limb / mxu_intt_limb). The method is not. The TPU had no 64-bit
// multiply and an int8 matrix unit, so it ran each stage as an exact int8
// product against a digit-sliced (nd*m)^2 matrix (2*(nd*m)^2 int8
// operations per column). The matrix is the product of a twist, a Pease
// butterfly network and a twiddle; this card multiplies 64-bit words, so here
// each stage runs those factors, the plain versions' butterfly graph step for
// step (Harvey-lazy, < 2q between stages):
//   stage 1 forward: twist psi1^j1 down the rows, GS network of omega1, lazy
//     twiddle (kernel 4's function);
//   stage 2 forward: twist psi^j2, GS network of omega2, csub (kernel 5's
//     function, down the columns);
//   stage 1 inverse: csub by 2q (inputs < 4q), CT network of omega2^-1,
//     psi^-j2, lazy twiddle;
//   stage 2 inverse: CT network of omega1^-1, strict Shoup by N^-1*psi1^-j1.
// Stage 1's output is < 2q and = the digit stage's mod q; its lazy
// representative may differ (a Shoup or Montgomery product ends it, not a
// REDC). Stage 2 ends canonical.
//
// What bounds it: bytes. A transform must read each residue once and write
// it once (16 B per coefficient) and read its twiddle table (16 B per entry
// for kernel 1, 8 B for 1b, shared by every poly of the batch); the work is
// log2(N)/2 64-bit Shoup products per coefficient plus three for the twists
// and the twiddle, on the CUDA cores. Two launches move the residues twice,
// so unless the 50 MB L2 holds the intermediate the design tops out near
// half of the transform's bytes bound. Fusing both stages into one launch
// would keep a whole N=2^14 limb (128 KB) in shared memory, as the TPU kept
// it in VMEM, at one block an SM: an under-filled wave at the round's
// shapes.
//
// Design (the schedule of csrc/butterfly.cuh, shared with kernels 4, 5 and 6):
// - A block owns one tile, m rows x TC columns of one (poly, limb), m in
//   {8, 16, ..., 256} (N = 2^6 ... 2^16), TC = 16, or 8 where a stage has 8
//   columns (m = 16 at N = 2^7, m = 8 at N = 2^6 and 2^7), and reads it once
//   with 16-byte cp.async copies of 8*TC-byte row segments, with its limb's
//   m-vector of twist or scale factors, Pease row 0 and, in stage 1, its
//   TC-column tile of the twiddle table. No residue is read twice; there is
//   no digit and no matrix.
// - m/16 threads per column hold 16 values each: four stages in registers on
//   the top four row bits, one exchange through shared memory, the rest in
//   registers on 16 consecutive rows. At m = 8 and 16 (N <= 2^9, where the
//   JAX runner's route is always the fused one) one thread holds the whole
//   column and every stage runs in registers, with no exchange.
// - Stage 1 stores transposed. The block's TC columns are TC adjacent rows
//   of y, one run of TC*m int64, so the values go through the shared tile
//   (transposed, rows padded by 16 bytes) and every warp stores 512
//   contiguous bytes. Storing each thread's 16 consecutive rows straight
//   from registers (32 lines a warp instruction) made stage 1 4-37% slower
//   on an H100 (PERF.md section 6). Stage 2 stores like kernel 4: TC
//   threads of one row write TC consecutive int64.
// - nvcc -Xptxas -v (sm_90a), at m=256: stage 1 forward 92 registers
//   (kernel 1) and 80 (1b, 8 bytes of spill), inverse 80 and 80; stage 2
//   72-78; no other spill. Dynamic shared memory: stage 1 102 KB (kernel 1)
//   and 70 KB (1b), stage 2 38 KB; at m=128 51, 35 and 19 KB. So at m=256
//   stage 1 of kernel 1 runs 2 blocks an SM (shared memory), 1b and stage 2
//   3 (registers, held to 85 by __launch_bounds__). The small-ring
//   instances (probes/kernel_report.py lists every one) are a few KB.
#include "butterfly.cuh"

namespace {

using namespace ppq;

// One column stage over tile blockIdx.x of limb blockIdx.y of poly
// blockIdx.z: x (B, L, M, c) transformed down its M rows.
//   FIRST: stage 1, twiddled by the limb's (M, c) table at tabs + info[3]
//     (MONT: w*2^64 mod q; else Shoup values, companions M*c further on),
//     stored transposed to y (B, L, c, M), values < 2q;
//   else stage 2, y (B, L, M, c), canonical.
template <int LOGM, int TC, bool FWD, bool FIRST, bool MONT>
__device__ __forceinline__ void stage_body(uint64_t* smem, const uint64_t* __restrict__ x,
                                           uint64_t* __restrict__ y,
                                           const uint64_t* __restrict__ tabs,
                                           const int64_t* __restrict__ info, int L, int c) {
  constexpr int M = 1 << LOGM, R = rows_of(LOGM), T = M / R, NT = T * TC;
  constexpr int LD = M + 2;                        // a row of the transposed tile, padded
  constexpr int TW = FIRST ? (MONT ? 1 : 2) : 0;   // twiddle planes
  uint64_t* tile = smem;               // [M][TC]; stage 1's store: [TC][LD]
  uint64_t* tw = tile + (FIRST ? TC * LD : M * TC);   // [TW][M][TC]
  uint64_t* vec = tw + TW * M * TC;    // M values, M companions
  uint64_t* root = vec + 2 * M;        // M/2 values, M/2 companions
  const int64_t* inf = info + INFO * blockIdx.y;
  const uint64_t q = static_cast<uint64_t>(inf[0]), q2 = 2 * q;
  const int64_t base = (static_cast<int64_t>(blockIdx.z) * L + blockIdx.y) * M * c;
  const int c0 = blockIdx.x * TC;
  const int tid = threadIdx.x;

  const uint64_t* twg = tabs + inf[3] + c0;
  const int64_t tw_size = static_cast<int64_t>(M) * c;
  for (int i = tid; i < M * TC / 2; i += NT) {
    const int r = i / (TC / 2), ch = 2 * (i % (TC / 2));
    const int64_t g = static_cast<int64_t>(r) * c + ch;
    cp_async16(tile + r * TC + ch, x + base + c0 + g);
#pragma unroll
    for (int p = 0; p < TW; ++p) cp_async16(tw + p * M * TC + r * TC + ch, twg + p * tw_size + g);
  }
  copy_block(vec, tabs + inf[1], 2 * M, tid, NT);
  copy_block(root, tabs + inf[2], M, tid, NT);
  cp_async_wait_all();
  __syncthreads();

  const int cc = tid % TC, t = tid / TC;
  const uint64_t *rw = root, *rs = root + M / 2;
  uint64_t v[R];
  if (FWD) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int a = t + T * k;
      v[k] = shoup_lazy(tile[a * TC + cc], vec[a], vec[M + a], q);
    }
    high_stages<true>(v, t, T, rw, rs, q, q2);
    exchange<LOGM, true>(v, tile + cc, TC, t);
    low_stages<LOGM, true>(v, rw, rs, q, q2);
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const uint64_t u = tile[(R * t + k) * TC + cc];
      v[k] = FIRST && u >= q2 ? u - q2 : u;
    }
    low_stages<LOGM, false>(v, rw, rs, q, q2);
    exchange<LOGM, false>(v, tile + cc, TC, t);
    high_stages<false>(v, t, T, rw, rs, q, q2);
  }
  // v[k] holds row a(k) of column cc: the network ends on labels 16*t + k
  // forward and t + T*k inverse (both k when one thread holds the column)
  const auto a = [&](int k) { return FWD ? R * t + k : t + T * k; };

  if (!FIRST) {
    uint64_t* out = y + base + c0 + cc;
#pragma unroll
    for (int k = 0; k < R; ++k)
      out[static_cast<int64_t>(a(k)) * c] =
          FWD ? (v[k] >= q ? v[k] - q : v[k]) : shoup(v[k], vec[a(k)], vec[M + a(k)], q);
    return;
  }
  const uint64_t qinv = MONT ? neg_inv64(q) : 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = a(k) * TC + cc;
    const uint64_t u = FWD ? v[k] : shoup_lazy(v[k], vec[a(k)], vec[M + a(k)], q);
    v[k] = MONT ? mont_lazy(u, tw[i], q, qinv) : shoup_lazy(u, tw[i], tw[M * TC + i], q);
  }
  // The block's TC columns are TC adjacent rows of y, one run of TC*M int64:
  // transpose through the tile, then every warp stores 512 contiguous bytes.
  __syncthreads();   // every thread has read its values out of the tile
#pragma unroll
  for (int k = 0; k < R; ++k) tile[cc * LD + a(k)] = v[k];
  __syncthreads();
  uint64_t* out = y + base + static_cast<int64_t>(c0) * M;
#pragma unroll
  for (int i = 2 * tid; i < TC * M; i += 2 * NT)
    *reinterpret_cast<ulonglong2*>(out + i) =
        *reinterpret_cast<const ulonglong2*>(tile + (i / M) * LD + i % M);
}

// kernel 1: stage 1 (Shoup twiddle, transposed store) or stage 2. At m=256
// stage 1's shared memory allows 2 blocks an SM; the other kernels are held
// to 3 (at most 85 registers a thread).
template <int LOGM, int TC, bool FWD, bool FIRST>
__global__ void __launch_bounds__(threads_of(LOGM, TC), FIRST ? 2 : 3)
mxu_ntt_stage_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                     const uint64_t* __restrict__ tabs, const int64_t* __restrict__ info, int L,
                     int c) {
  extern __shared__ __align__(16) uint64_t smem[];
  stage_body<LOGM, TC, FWD, FIRST, false>(smem, x, y, tabs, info, L, c);
}

// kernel 1b: the same two stages with the Montgomery twiddle
template <int LOGM, int TC, bool FWD, bool FIRST>
__global__ void __launch_bounds__(threads_of(LOGM, TC), 3)
mxu_ntt_stage_mont_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                          const uint64_t* __restrict__ tabs, const int64_t* __restrict__ info,
                          int L, int c) {
  extern __shared__ __align__(16) uint64_t smem[];
  stage_body<LOGM, TC, FWD, FIRST, true>(smem, x, y, tabs, info, L, c);
}

using Kernel = void (*)(const uint64_t*, uint64_t*, const uint64_t*, const int64_t*, int, int);

template <int LOGM, int TC, bool FWD, bool FIRST, bool MONT>
int launch(const void* x, void* y, const void* tabs, const void* info, int B, int L, int c,
           cudaStream_t stream) {
  constexpr int M = 1 << LOGM;
  constexpr int TW = FIRST ? (MONT ? 1 : 2) : 0;
  const size_t smem = ((1 + TW) * M * TC + 3 * M + (FIRST ? 2 * TC : 0)) * sizeof(uint64_t);
  const Kernel kernel = MONT ? mxu_ntt_stage_mont_kernel<LOGM, TC, FWD, FIRST>
                             : mxu_ntt_stage_kernel<LOGM, TC, FWD, FIRST>;
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<dim3(c / TC, L, B), threads_of(LOGM, TC), smem, stream>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y),
      static_cast<const uint64_t*>(tabs), static_cast<const int64_t*>(info), L, c);
  return static_cast<int>(cudaGetLastError());
}

template <int LOGM, bool MONT>
int launch_m(const void* x, void* y, const void* tabs, const void* info, int B, int L, int c,
             int forward, int first, cudaStream_t s) {
  return fused_tiles<LOGM>(c, [&](auto tc) {
    constexpr int TC = decltype(tc)::value;
    if (forward)
      return first ? launch<LOGM, TC, true, true, MONT>(x, y, tabs, info, B, L, c, s)
                   : launch<LOGM, TC, true, false, MONT>(x, y, tabs, info, B, L, c, s);
    return first ? launch<LOGM, TC, false, true, MONT>(x, y, tabs, info, B, L, c, s)
                 : launch<LOGM, TC, false, false, MONT>(x, y, tabs, info, B, L, c, s);
  });
}

template <bool MONT>
int dispatch(const void* x, void* y, const void* tabs, const void* info, int B, int L, int m,
             int c, int forward, int first, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 8: return launch_m<3, MONT>(x, y, tabs, info, B, L, c, forward, first, s);
    case 16: return launch_m<4, MONT>(x, y, tabs, info, B, L, c, forward, first, s);
    case 32: return launch_m<5, MONT>(x, y, tabs, info, B, L, c, forward, first, s);
    case 64: return launch_m<6, MONT>(x, y, tabs, info, B, L, c, forward, first, s);
    case 128: return launch_m<7, MONT>(x, y, tabs, info, B, L, c, forward, first, s);
    case 256: return launch_m<8, MONT>(x, y, tabs, info, B, L, c, forward, first, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (B, L, m, c) int64 transformed down its m rows (m in {8, 16, ...,
// 256}, c a multiple of 16, or 8 when m <= 16). first: stage 1, y (B, L, c,
// m), values < 2q; else stage 2, y (B, L, m, c), canonical. info (L, 4): q
// and the offsets in tabs of the stage's m-vector pair, Pease row 0 pair and
// (stage 1) the (m, c) twiddle pair.
//
// ops/cuda_lib.py builds this file in two parts that compile in parallel:
// PPQ_PART 0 holds kernel 1's entry point and instances, 1 kernel 1b's;
// without PPQ_PART (probes/kernel_report.py) both.
#if !defined(PPQ_PART) || PPQ_PART == 0
extern "C" int ppq_mxu_ntt_stage(const void* x, void* y, const void* tabs, const void* info,
                                 int B, int L, int m, int c, int forward, int first,
                                 void* stream) {
  return dispatch<false>(x, y, tabs, info, B, L, m, c, forward, first, stream);
}
#endif

#if !defined(PPQ_PART) || PPQ_PART == 1
// kernel 1b: as ppq_mxu_ntt_stage, stage 1's twiddle offset pointing at the
// limb's (m, c) table of w*2^64 mod q.
extern "C" int ppq_mxu_ntt_stage_mont(const void* x, void* y, const void* tabs,
                                      const void* info, int B, int L, int m, int c, int forward,
                                      int first, void* stream) {
  return dispatch<true>(x, y, tabs, info, B, L, m, c, forward, first, stream);
}
#endif
