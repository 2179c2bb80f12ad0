// Kernel 6: the constant-geometry (Pease) four-step NTT with Shoup butterflies.
//
// Replaces ppqsflhe_tpu/ops/pallas_ntt.py, _pallas_transform (pallas_call at
// :207), the ntt_impl="pallas" transform, whose body is ntt_body_cg /
// intt_body_cg (ppqsflhe_tpu/ops/fourstep.py:385-411). Plain torch version:
// ops/fourstep.py (ntt_body_cg / intt_body_cg); wrapper: ops/cuda_ntt.py.
//
// The TPU kernel held one whole limb in VMEM per grid cell (N <= 2^16 ->
// <= 512 KB as u32 pairs) and ran twist, the n1-point column NTTs, the
// twiddle, the transpose and the n2-point NTTs without touching HBM. On
// Hopper a block has 227 KB of shared memory: a limb of int64 residues is
// 128 KB at N=2^14 but 512 KB at N=2^16, and a block-per-limb grid would put
// only B*L blocks on 132 SMs. So a transform is TWO launches, each a column
// pass over tiles of TC columns (16; 8 where a pass has only 8):
//
//   forward, pass 1: an (n1 x TC) tile of the (n1, n2) input, twisted (lazy
//     Shoup, inputs < 4q), the log2(n1) Pease stages, the lazy twiddle,
//     stored transposed into (n2, n1);
//   forward, pass 2: (n2 x TC) tiles of that, log2(n2) stages, one csub,
//     stored in place: evaluation k2*n1 + k1 lands at rev(k2)*n1 + rev(k1),
//     the kernel order of fourstep.py:13-16;
//   inverse, pass 1: (n2 x TC) tiles of the kernel-order input (< 2q), the
//     inverse stages, the lazy inverse twiddle (a host table stored
//     transposed, so both passes index tables by their input coordinates),
//     stored transposed into (n1, n2);
//   inverse, pass 2: (n1 x TC) tiles, inverse stages, the strict itwist
//     (N^{-1} folded in), stored in place.
//
// The function is the plain version's, butterfly for butterfly
// (Harvey-lazy, < 2q between stages, native uint64_t with __umul64hi for the
// Shoup quotient; 4q < 2^62), so the canonical outputs are bit-equal to it
// and to kernels 1, 1b and 4+5.
//
// What bounds it: bytes. Each pass reads and writes the limb once (16 B per
// coefficient) and reads its (m, c) elementwise tables, 16 B per coefficient
// per (value, companion) pair — twist and twiddle in forward pass 1, none in
// forward pass 2, the inverse twiddle and the itwist in the inverse passes —
// shared by every poly of the batch, so read from device memory once and
// from L2 after. Against that stand log2(N)/2 Shoup products per coefficient
// and up to two for the tables, on the CUDA cores.
//
// Design: the register-blocked schedule of csrc/butterfly.cuh, as in kernels
// 1, 1b, 4 and 5 (no barrier or shared-memory round trip per stage):
// - A block owns one m x TC tile of one (poly, limb), m in {8, 16, ..., 256}
//   (N = 2^6 ... 2^16), TC = 16, or 8 for the 8-column passes of N = 2^6
//   and 2^7, and reads it once with 16-byte cp.async copies,
//   with Pease row 0 of the limb's stage table (root^i, what butterfly.cuh
//   indexes) and the pass's post table tile (twiddle, inverse twiddle or
//   itwist; 16 B an entry).
// - m/16 threads per column hold 16 values each: four stages in registers
//   on the top four row bits, one exchange through shared memory, the rest
//   in registers on 16 consecutive rows (the inverse the other way round).
//   At m = 8 and 16 one thread holds the whole column: every stage in
//   registers, no exchange.
// - The twist of forward pass 1, the one pass with two tables, is read
//   straight from global memory: the 16 columns of a row are 128 contiguous
//   bytes per plane, shared by all B polys and held in L2. So a block stages
//   at most one table tile pair and its shared memory stays within kernel
//   1's stage 1 at the same m (98 KB against 102 KB at m=256: 2 blocks an
//   SM).
// - Pass 1 stores transposed through the shared tile (rows padded by 16
//   bytes), one TC*m run per block, as kernel 1's stage 1; pass 2 in place,
//   TC threads of a row writing TC consecutive int64.
// - nvcc -Xptxas -v (sm_90a), registers at m = 32, 64, 128, 256
//   (probes/kernel_report.py): forward pass 1 96, 96, 96, 96; pass 2 72,
//   72, 70, 72; inverse pass 1 76, 76, 72, 78; pass 2 70, 74, 74, 72; no
//   spill. Dynamic shared memory at m=256: 98 KB (the passes with a staged
//   table), 34 KB (forward pass 2); at m=128 49 and 17 KB. So at m=256
//   forward pass 2 runs 3 blocks an SM (registers), the others 2 (shared
//   memory).
#include "butterfly.cuh"

namespace {

using namespace ppq;

enum Post { CSUB, LAZY, STRICT };      // after the stages: csub, lazy or strict Shoup

// One column pass over tile blockIdx.x of limb blockIdx.y of poly
// blockIdx.z: x (B, L, M, c) transformed down its M rows.
//   FWD:     GS stages of the forward (else CT stages of the inverse), on
//            Pease row 0 of the (LOGM, M/2) stage table at tabs + info[3]
//   PRE:     lazy Shoup by the (M, c) table pair at tabs + info[1] first
//   POST:    csub by q, or a lazy / strict Shoup by the pair at info[2]
//   STORE_T: y is (B, L, c, M); else (B, L, M, c)
// An (M, c) table pair is M*c values then M*c companions; a stage table
// LOGM*M/2 values then as many companions.
template <int LOGM, int TC, bool FWD, bool PRE, Post POST, bool STORE_T>
__device__ __forceinline__ void pass_body(uint64_t* smem, const uint64_t* __restrict__ x,
                                          uint64_t* __restrict__ y,
                                          const uint64_t* __restrict__ tabs,
                                          const int64_t* __restrict__ info, int L, int c) {
  constexpr int M = 1 << LOGM, R = rows_of(LOGM), T = M / R, NT = T * TC, H = M / 2;
  constexpr int LD = M + 2;                     // a row of the transposed tile, padded
  constexpr bool TAB = POST != CSUB;            // the post table tile, staged
  uint64_t* tile = smem;                                  // [M][TC]; transposed: [TC][LD]
  uint64_t* tw = tile + (STORE_T ? TC * LD : M * TC);     // [2][M][TC]
  uint64_t* root = tw + (TAB ? 2 * M * TC : 0);           // H values, H companions
  const int64_t* inf = info + INFO * blockIdx.y;
  const uint64_t q = static_cast<uint64_t>(inf[0]), q2 = 2 * q;
  const int64_t size = static_cast<int64_t>(M) * c;
  const int64_t base = (static_cast<int64_t>(blockIdx.z) * L + blockIdx.y) * size;
  const int c0 = blockIdx.x * TC;
  const int tid = threadIdx.x;

  const uint64_t* post = tabs + inf[2] + c0;
  for (int i = tid; i < M * TC / 2; i += NT) {
    const int r = i / (TC / 2), ch = 2 * (i % (TC / 2));
    const int64_t g = static_cast<int64_t>(r) * c + ch;
    cp_async16(tile + r * TC + ch, x + base + c0 + g);
    if (TAB) {
      cp_async16(tw + r * TC + ch, post + g);
      cp_async16(tw + M * TC + r * TC + ch, post + size + g);
    }
  }
  const uint64_t* st = tabs + inf[3];
  copy_block(root, st, H, tid, NT);
  copy_block(root + H, st + LOGM * H, H, tid, NT);
  cp_async_wait_all();
  __syncthreads();

  const int cc = tid % TC, t = tid / TC;
  const uint64_t *rw = root, *rs = root + H;
  uint64_t v[R];
  if (FWD) {
    const uint64_t* pre = tabs + inf[1] + c0 + cc;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int a = t + T * k;
      const uint64_t u = tile[a * TC + cc];
      v[k] = PRE ? shoup_lazy(u, pre[static_cast<int64_t>(a) * c],
                              pre[size + static_cast<int64_t>(a) * c], q)
                 : u;
    }
    high_stages<true>(v, t, T, rw, rs, q, q2);
    exchange<LOGM, true>(v, tile + cc, TC, t);
    low_stages<LOGM, true>(v, rw, rs, q, q2);
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = tile[(R * t + k) * TC + cc];
    low_stages<LOGM, false>(v, rw, rs, q, q2);
    exchange<LOGM, false>(v, tile + cc, TC, t);
    high_stages<false>(v, t, T, rw, rs, q, q2);
  }
  // v[k] holds row a(k) of column cc: the network ends on labels 16*t + k
  // forward and t + T*k inverse (both k when one thread holds the column)
  const auto a = [&](int k) { return FWD ? R * t + k : t + T * k; };
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = a(k) * TC + cc;
    if (POST == CSUB) v[k] = v[k] >= q ? v[k] - q : v[k];
    else if (POST == LAZY) v[k] = shoup_lazy(v[k], tw[i], tw[M * TC + i], q);
    else v[k] = shoup(v[k], tw[i], tw[M * TC + i], q);
  }
  if (!STORE_T) {
    uint64_t* out = y + base + c0 + cc;
#pragma unroll
    for (int k = 0; k < R; ++k) out[static_cast<int64_t>(a(k)) * c] = v[k];
    return;
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

// The kernel symbol the profiler and the launch count know. Passes with a
// staged table tile (98 KB at m=256) run 2 blocks an SM; forward pass 2 is
// held to 3 (at most 85 registers a thread).
template <int LOGM, int TC, bool FWD, bool PRE, Post POST, bool STORE_T>
__global__ void __launch_bounds__(threads_of(LOGM, TC), POST == CSUB ? 3 : 2)
fourstep_ntt_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                    const uint64_t* __restrict__ tabs, const int64_t* __restrict__ info, int L,
                    int c) {
  extern __shared__ __align__(16) uint64_t smem[];
  pass_body<LOGM, TC, FWD, PRE, POST, STORE_T>(smem, x, y, tabs, info, L, c);
}

template <int LOGM, int TC, bool FWD, bool PRE, Post POST, bool STORE_T>
int launch(const void* x, void* y, const void* tabs, const void* info, int B, int L, int c,
           cudaStream_t stream) {
  constexpr int M = 1 << LOGM;
  const size_t smem = ((STORE_T ? TC * (M + 2) : M * TC) + (POST != CSUB ? 2 * M * TC : 0) + M) *
                      sizeof(uint64_t);
  const auto kernel = fourstep_ntt_kernel<LOGM, TC, FWD, PRE, POST, STORE_T>;
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<dim3(c / TC, L, B), threads_of(LOGM, TC), smem, stream>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y),
      static_cast<const uint64_t*>(tabs), static_cast<const int64_t*>(info), L, c);
  return static_cast<int>(cudaGetLastError());
}

template <int LOGM>
int launch_m(const void* x, void* y, const void* tabs, const void* info, int B, int L, int c,
             int forward, int first, cudaStream_t s) {
  return fused_tiles<LOGM>(c, [&](auto tc) {
    constexpr int TC = decltype(tc)::value;
    if (forward)
      return first ? launch<LOGM, TC, true, true, LAZY, true>(x, y, tabs, info, B, L, c, s)
                   : launch<LOGM, TC, true, false, CSUB, false>(x, y, tabs, info, B, L, c, s);
    return first ? launch<LOGM, TC, false, false, LAZY, true>(x, y, tabs, info, B, L, c, s)
                 : launch<LOGM, TC, false, false, STRICT, false>(x, y, tabs, info, B, L, c, s);
  });
}

}  // namespace

// x: (B, L, m, c) int64, transformed down its m rows (m in {8, 16, ...,
// 256}, c a multiple of 16 or, when m <= 16, 8; 16-byte aligned). y: (B, L, c, m) for the first
// pass of a transform, (B, L, m, c) for the second. info: (L, 4) per limb: q
// and the offsets in tabs of the pass's pre-, post- and stage tables.
extern "C" int ppq_fourstep_pass(const void* x, void* y, const void* tabs, const void* info,
                                 int B, int L, int m, int c, int forward, int first,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 8: return launch_m<3>(x, y, tabs, info, B, L, c, forward, first, s);
    case 16: return launch_m<4>(x, y, tabs, info, B, L, c, forward, first, s);
    case 32: return launch_m<5>(x, y, tabs, info, B, L, c, forward, first, s);
    case 64: return launch_m<6>(x, y, tabs, info, B, L, c, forward, first, s);
    case 128: return launch_m<7>(x, y, tabs, info, B, L, c, forward, first, s);
    case 256: return launch_m<8>(x, y, tabs, info, B, L, c, forward, first, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
