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
// only B*L blocks on 132 SMs. So one design serves every size: TWO launches
// per transform, each a column pass over tiles of TC=16 columns:
//
//   forward, pass 1: load an (n1 x 16) tile of the (n1, n2) input, twist it
//     (lazy Shoup, inputs < 4q), run the log2(n1) Pease stages in shared
//     memory, twiddle, and store the tile transposed into (n2, n1);
//   forward, pass 2: (n2 x 16) tiles of that, log2(n2) stages, one csub,
//     stored in place: evaluation k2*n1 + k1 lands at rev(k2)*n1 + rev(k1),
//     the kernel order of fourstep.py:13-16;
//   inverse, pass 1: (n2 x 16) tiles of the kernel-order input, the
//     inverse stages in reverse, the inverse twiddle (a host table stored
//     transposed, so both passes index tables by their input coordinates),
//     stored transposed into (n1, n2);
//   inverse, pass 2: (n1 x 16) tiles, inverse stages, the strict itwist
//     (N^{-1} folded in), stored in place.
//
// Each Pease stage reads rows i and i + m/2 and writes rows 2i and 2i + 1
// (forward; the inverse the other way round), so a tile lives in two
// shared-memory buffers used in turn, one barrier per stage. Rows are padded
// to 17 words so the transposed store's column reads spread over the banks.
// At m = 256 the pair is 68 KB: dynamic shared memory, above the 48 KB
// default after cudaFuncSetAttribute. The arithmetic is the plain version's,
// step for step (Harvey-lazy, < 2q between stages), on native uint64_t with
// __umul64hi for the Shoup quotient; 4q < 2^62, so nothing overflows, and
// the canonical outputs are bit-equal.
//
// What bounds it here: each pass reads and writes the limb once (16 B per
// coefficient) and reads one (value, companion) table of 16 B per
// coefficient (twist, twiddle or itwist; pass 2 of the forward reads
// none), so a limb-NTT moves about 64 B per coefficient — 4 MB at N=2^16,
// 1.3 us at 3.35 TB/s. Against that stand log2(N)/2 butterflies per
// coefficient, each a 64-bit Shoup product (three 64-bit multiplies, which
// the card builds from 32-bit IMADs), on the CUDA cores; a later version can
// keep a limb in a cluster's distributed shared memory and fuse the passes.
#include "common.cuh"

namespace {

constexpr int TC = 16;                 // columns per tile
constexpr int LD = TC + 1;             // padded shared-memory row, in words
constexpr int THREADS = 256;
constexpr int INFO = 4;                // per limb: q, pre, post and stage table offsets

enum Post { CSUB, LAZY, STRICT };      // after the stages: csub, lazy or strict Shoup

// One column pass over limb blockIdx.y of batch item blockIdx.z: x is
// (B, L, m, c), transformed down its m rows in tiles of TC columns.
//   FWD:     Pease GS stages s = 0..S-1 (else the inverse, s = S-1..0) with the
//            (S, m/2) table pair at tabs + info[3]
//   PRE:     lazy Shoup by the (m, c) table pair at tabs + info[1] first
//   POST:    csub by q, or a lazy / strict Shoup by the pair at info[2]
//   STORE_T: y is (B, L, c, m); else (B, L, m, c)
// An (m, c) table pair is m*c values then m*c companions; an (S, m/2) pair
// S*m/2 values then as many companions.
template <bool FWD, bool PRE, Post POST, bool STORE_T>
__global__ void __launch_bounds__(THREADS)
fourstep_ntt_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                    const uint64_t* __restrict__ tabs, const int64_t* __restrict__ info,
                    int L, int m, int c, int log_m) {
  extern __shared__ __align__(16) uint64_t smem[];
  uint64_t* cur = smem;
  uint64_t* nxt = smem + m * LD;
  const int64_t* inf = info + INFO * blockIdx.y;
  const uint64_t q = static_cast<uint64_t>(inf[0]), q2 = 2 * q;
  const int64_t size = static_cast<int64_t>(m) * c;
  const int64_t base = (static_cast<int64_t>(blockIdx.z) * L + blockIdx.y) * size;
  const uint64_t* xin = x + base;
  uint64_t* out = y + base;
  const int c0 = blockIdx.x * TC;
  const int h = m >> 1;
  const int tid = threadIdx.x;

  const uint64_t* pre = tabs + (PRE ? inf[1] : 0);
  for (int k = tid; k < m * TC; k += THREADS) {
    const int r = k / TC, cc = k % TC;
    const int64_t g = static_cast<int64_t>(r) * c + c0 + cc;
    uint64_t v = xin[g];
    if (PRE) v = ppq::shoup_lazy(v, pre[g], pre[size + g], q);
    cur[r * LD + cc] = v;
  }
  __syncthreads();

  const uint64_t* st = tabs + inf[3];
  const int64_t st_size = static_cast<int64_t>(log_m) * h;
  for (int it = 0; it < log_m; ++it) {
    const int s = FWD ? it : log_m - 1 - it;
    const uint64_t* w = st + static_cast<int64_t>(s) * h;
    for (int k = tid; k < h * TC; k += THREADS) {
      const int i = k / TC, cc = k % TC;
      const uint64_t wi = w[i], wsi = w[st_size + i];
      if (FWD) {
        const uint64_t u = cur[i * LD + cc], v = cur[(i + h) * LD + cc];
        uint64_t sum = u + v;
        sum = sum >= q2 ? sum - q2 : sum;
        nxt[2 * i * LD + cc] = sum;
        nxt[(2 * i + 1) * LD + cc] = ppq::shoup_lazy(u + q2 - v, wi, wsi, q);
      } else {
        const uint64_t a = cur[2 * i * LD + cc];
        const uint64_t b = ppq::shoup_lazy(cur[(2 * i + 1) * LD + cc], wi, wsi, q);
        uint64_t u = a + b, v = a + q2 - b;
        nxt[i * LD + cc] = u >= q2 ? u - q2 : u;
        nxt[(i + h) * LD + cc] = v >= q2 ? v - q2 : v;
      }
    }
    __syncthreads();
    uint64_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  const uint64_t* post = tabs + (POST != CSUB ? inf[2] : 0);
  for (int k = tid; k < m * TC; k += THREADS) {
    // a transposed store walks down a column so that its writes are contiguous
    const int r = STORE_T ? k % m : k / TC;
    const int cc = STORE_T ? k / m : k % TC;
    const int64_t g = static_cast<int64_t>(r) * c + c0 + cc;
    uint64_t v = cur[r * LD + cc];
    if (POST == CSUB) v = v >= q ? v - q : v;
    else if (POST == LAZY) v = ppq::shoup_lazy(v, post[g], post[size + g], q);
    else v = ppq::shoup(v, post[g], post[size + g], q);
    if (STORE_T) out[static_cast<int64_t>(c0 + cc) * m + r] = v;
    else out[g] = v;
  }
}

template <bool FWD, bool PRE, Post POST, bool STORE_T>
int launch(const void* x, void* y, const void* tabs, const void* info, int B, int L, int m,
           int c, cudaStream_t stream) {
  int log_m = 0;
  while ((1 << log_m) < m) ++log_m;
  const size_t smem = 2 * static_cast<size_t>(m) * LD * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fourstep_ntt_kernel<FWD, PRE, POST, STORE_T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fourstep_ntt_kernel<FWD, PRE, POST, STORE_T><<<dim3(c / TC, L, B), THREADS, smem, stream>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y),
      static_cast<const uint64_t*>(tabs), static_cast<const int64_t*>(info), L, m, c, log_m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, L, m, c) int64, transformed down its m rows (m a power of two,
// c a multiple of 16). y: (B, L, c, m) for the first pass of a transform,
// (B, L, m, c) for the second. info: (L, 4) per limb: q and the offsets in
// tabs of the pass's pre-, post- and stage tables.
extern "C" int ppq_fourstep_pass(const void* x, void* y, const void* tabs, const void* info,
                                 int B, int L, int m, int c, int forward, int first,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (forward)
    return first ? launch<true, true, LAZY, true>(x, y, tabs, info, B, L, m, c, s)
                 : launch<true, false, CSUB, false>(x, y, tabs, info, B, L, m, c, s);
  return first ? launch<false, false, LAZY, true>(x, y, tabs, info, B, L, m, c, s)
               : launch<false, false, STRICT, false>(x, y, tabs, info, B, L, m, c, s);
}
