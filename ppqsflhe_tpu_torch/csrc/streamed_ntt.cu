// Kernels 4 and 5: the streamed four-step NTT pair as Shoup butterflies.
//
// - ppq_streamed_stage_a (kernel `streamed_stage_a_kernel`) replaces
//   ppqsflhe_tpu/ops/pallas_mxu_ntt.py, PallasMxuNttBig._stage_a
//   (pallas_call at :512): the first column stage with its lazy twiddle and
//   no transpose, for any aligned block of columns of a wider twiddle table
//   (the per-shard first half of the sharded transform).
// - ppq_streamed_stage_b (kernel `streamed_stage_b_kernel`) replaces
//   PallasMxuNttBig._stage_b (pallas_call at :566): the second stage along
//   the LAST axis of t[b, l, r, j], stored at y[b, l, k, r].
//
// Plain torch versions and wrappers: ops/streamed_ntt.py (stage_a_plain,
// stage_b_plain; stage_a, stage_b). The functions are those of the TPU
// kernels; the method is not. The TPU had no 64-bit multiply and an int8
// matrix unit, so it ran each stage as an exact int8 product against a
// digit-sliced (nd*m)^2 matrix: 2*(nd*m)^2 int8 operations per column
// (41k per coefficient at nd=9, m=256) and a 5.3 MB matrix per limb. The
// matrix is the product of a twist, a Pease butterfly network and a
// twiddle; this card multiplies 64-bit words (__umul64hi), so here each stage
// runs those factors, the plain version's butterfly graph step for step
// (Harvey-lazy, < 2q between stages): stage A forward twist psi1^j1, GS
// network, lazy twiddle; stage B forward twist psi^j2, GS network, csub;
// stage A inverse csub by 2q, CT network, psi^-j2, lazy twiddle; stage B
// inverse CT network, strict Shoup by N^-1 * psi1^-j1.
//
// What bounds it: bytes. Each residue must be read once and written once
// (16 B per coefficient), stage A also reads its twiddle pair (16 B per
// coefficient of the table, shared by every poly); the work is log2(m)/2
// 64-bit Shoup products per coefficient plus one or two for the twist and
// twiddle, on the CUDA cores.
//
// Design:
// - A block owns one tile, m rows x TC columns (stage A: row segments of
//   8*TC bytes) or TC rows x m (stage B: contiguous runs of m*8 bytes), TC
//   = 16 or, for a narrower shard, the shard's width (c or rows, a power of
//   two below 16): a template parameter. It reads the tile once, with
//   16-byte cp.async copies (8-byte ones at TC = 1, where a row segment is
//   one int64 at any column), together with its limb's m-vector of twist or
//   scale factors, row 0 of the Pease table (root^i, i < m/2: row s entry i
//   is root^((i >> s) << s), so row 0 holds every twiddle of the network),
//   and, in stage A, its tile of the twiddle pair. No residue is read twice;
//   there is no digitizing and no matrix.
// - m/16 threads per column hold 16 values each. The top four bits of the
//   row index are the thread's own (label t + T*k), so four stages run in
//   registers; one exchange through shared memory gives each thread 16
//   consecutive rows (label 16*t + k), and the last log2(m) - 4 stages run in
//   registers too (csrc/butterfly.cuh, shared with kernels 1, 1b and 6). Two
//   barriers per tile: after the copies, and at the exchange. The inverse
//   network runs the other way round (low stages first). At m = 8 and 16
//   one thread holds a whole column and runs every stage in registers, with
//   no exchange: a block is then TC threads.
// - The stores go straight from registers: in a warp, TC threads of one
//   row write TC consecutive int64 (128 bytes at TC = 16).
// - Several blocks per SM let one tile's copies overlap another's
//   butterflies: at m=256, 2 of stage A (its 102 KB of shared memory, the
//   twiddle tile included) and 3 of stage B (70-80 registers a thread).
// - Stage B's tile rows are padded by one 16-byte chunk, so the reads down
//   a row spread over the banks.
// - A narrow tile (TC < 16, a coef axis wider than n/16 ranks, or a small
//   ring's shard) gives small blocks and, at small sizes, a grid of few of
//   them: such launches run near the launch floor, not the bytes bound.
#include "butterfly.cuh"

namespace {

using namespace ppq;

// Stage A over tile (blockIdx.x) of limb blockIdx.y of poly blockIdx.z:
// x, y (B, L, M, c); the limb's twiddle table is (M, tw_cols) at
// tabs + info[3] (companions M*tw_cols further on), x holding its columns
// [col0, col0 + c).
template <int LOGM, int TC, bool FWD>
__global__ void __launch_bounds__(threads_of(LOGM, TC), 2)
streamed_stage_a_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                        const uint64_t* __restrict__ tabs, const int64_t* __restrict__ info,
                        int L, int c, int tw_cols, int col0) {
  constexpr int M = 1 << LOGM, R = rows_of(LOGM), T = M / R, NT = T * TC, SEG = seg_of<TC>();
  extern __shared__ __align__(16) uint64_t smem[];
  uint64_t* tile = smem;               // [M][TC]
  uint64_t* tww = tile + M * TC;       // [M][TC] twiddle values
  uint64_t* tws = tww + M * TC;        // [M][TC] their companions
  uint64_t* vec = tws + M * TC;        // M values, M companions
  uint64_t* root = vec + 2 * M;        // M/2 values, M/2 companions
  const int64_t* inf = info + INFO * blockIdx.y;
  const uint64_t q = static_cast<uint64_t>(inf[0]), q2 = 2 * q;
  const int64_t base = (static_cast<int64_t>(blockIdx.z) * L + blockIdx.y) * M * c;
  const int c0 = blockIdx.x * TC;
  const int tid = threadIdx.x;

  const uint64_t* tw = tabs + inf[3];
  const int64_t tw_size = static_cast<int64_t>(M) * tw_cols;
  for (int i = tid; i < M * TC / SEG; i += NT) {
    const int r = i / (TC / SEG), ch = SEG * (i % (TC / SEG));
    const int64_t g = static_cast<int64_t>(r) * tw_cols + col0 + c0 + ch;
    cp_async_seg<TC>(tile + r * TC + ch, x + base + static_cast<int64_t>(r) * c + c0 + ch);
    cp_async_seg<TC>(tww + r * TC + ch, tw + g);
    cp_async_seg<TC>(tws + r * TC + ch, tw + tw_size + g);
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
      v[k] = ppq::shoup_lazy(tile[a * TC + cc], vec[a], vec[M + a], q);
    }
    high_stages<true>(v, t, T, rw, rs, q, q2);
    exchange<LOGM, true>(v, tile + cc, TC, t);
    low_stages<LOGM, true>(v, rw, rs, q, q2);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int a = R * t + k;
      y[base + static_cast<int64_t>(a) * c + c0 + cc] =
          ppq::shoup_lazy(v[k], tww[a * TC + cc], tws[a * TC + cc], q);
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const uint64_t u = tile[(R * t + k) * TC + cc];
      v[k] = u >= q2 ? u - q2 : u;
    }
    low_stages<LOGM, false>(v, rw, rs, q, q2);
    exchange<LOGM, false>(v, tile + cc, TC, t);
    high_stages<false>(v, t, T, rw, rs, q, q2);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int a = t + T * k;
      const uint64_t u = ppq::shoup_lazy(v[k], vec[a], vec[M + a], q);
      y[base + static_cast<int64_t>(a) * c + c0 + cc] =
          ppq::shoup_lazy(u, tww[a * TC + cc], tws[a * TC + cc], q);
    }
  }
}

// Stage B over tile (blockIdx.x) of limb blockIdx.y of poly blockIdx.z:
// x (B, L, rows, M) transformed along its last axis, y (B, L, M, rows).
template <int LOGM, int TC, bool FWD>
__global__ void __launch_bounds__(threads_of(LOGM, TC), 2)
streamed_stage_b_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                        const uint64_t* __restrict__ tabs, const int64_t* __restrict__ info,
                        int L, int rows) {
  constexpr int M = 1 << LOGM, R = rows_of(LOGM), T = M / R, NT = T * TC, LD = M + 2;
  extern __shared__ __align__(16) uint64_t smem[];
  uint64_t* tile = smem;               // [TC][LD]: row r of the tile holds x[r0 + r][0..M)
  uint64_t* vec = tile + TC * LD;      // M values, M companions
  uint64_t* root = vec + 2 * M;        // M/2 values, M/2 companions
  const int64_t* inf = info + INFO * blockIdx.y;
  const uint64_t q = static_cast<uint64_t>(inf[0]), q2 = 2 * q;
  const int64_t base = (static_cast<int64_t>(blockIdx.z) * L + blockIdx.y) * M * rows;
  const int r0 = blockIdx.x * TC;
  const int tid = threadIdx.x;

  for (int i = tid; i < TC * M / 2; i += NT) {
    const int r = i / (M / 2), ch = 2 * (i % (M / 2));
    cp_async16(tile + r * LD + ch, x + base + static_cast<int64_t>(r0 + r) * M + ch);
  }
  copy_block(vec, tabs + inf[1], 2 * M, tid, NT);
  copy_block(root, tabs + inf[2], M, tid, NT);
  cp_async_wait_all();
  __syncthreads();

  const int cc = tid % TC, t = tid / TC;
  uint64_t* row = tile + cc * LD;
  const uint64_t *rw = root, *rs = root + M / 2;
  uint64_t* out = y + base + r0 + cc;
  uint64_t v[R];
  if (FWD) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int a = t + T * k;
      v[k] = ppq::shoup_lazy(row[a], vec[a], vec[M + a], q);
    }
    high_stages<true>(v, t, T, rw, rs, q, q2);
    exchange<LOGM, true>(v, row, 1, t);
    low_stages<LOGM, true>(v, rw, rs, q, q2);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const uint64_t u = v[k];
      out[static_cast<int64_t>(R * t + k) * rows] = u >= q ? u - q : u;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = row[R * t + k];
    low_stages<LOGM, false>(v, rw, rs, q, q2);
    exchange<LOGM, false>(v, row, 1, t);
    high_stages<false>(v, t, T, rw, rs, q, q2);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int a = t + T * k;
      out[static_cast<int64_t>(a) * rows] = ppq::shoup(v[k], vec[a], vec[M + a], q);
    }
  }
}

template <int LOGM, int TC, bool FWD>
int launch_a(const void* x, void* y, const void* tabs, const void* info, int B, int L, int c,
             int tw_cols, int col0, cudaStream_t stream) {
  constexpr int M = 1 << LOGM;
  const size_t smem = (3 * M * TC + 3 * M) * sizeof(uint64_t);
  static const cudaError_t set = allow_smem(streamed_stage_a_kernel<LOGM, TC, FWD>, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  streamed_stage_a_kernel<LOGM, TC, FWD><<<dim3(c / TC, L, B), threads_of(LOGM, TC), smem,
                                           stream>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y),
      static_cast<const uint64_t*>(tabs), static_cast<const int64_t*>(info), L, c, tw_cols,
      col0);
  return static_cast<int>(cudaGetLastError());
}

template <int LOGM, int TC, bool FWD>
int launch_b(const void* x, void* y, const void* tabs, const void* info, int B, int L, int rows,
             cudaStream_t stream) {
  constexpr int M = 1 << LOGM;
  const size_t smem = (TC * (M + 2) + 3 * M) * sizeof(uint64_t);
  static const cudaError_t set = allow_smem(streamed_stage_b_kernel<LOGM, TC, FWD>, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  streamed_stage_b_kernel<LOGM, TC, FWD><<<dim3(rows / TC, L, B), threads_of(LOGM, TC), smem,
                                           stream>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y),
      static_cast<const uint64_t*>(tabs), static_cast<const int64_t*>(info), L, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int LOGM>
int dispatch_a(const void* x, void* y, const void* tabs, const void* info, int B, int L, int c,
               int tw_cols, int col0, int forward, cudaStream_t s) {
  return with_tile<1, 2, 4, 8>(c, [&](auto tc) {
    constexpr int TC = decltype(tc)::value;
    if (col0 % TC) return static_cast<int>(cudaErrorInvalidValue);
    return forward ? launch_a<LOGM, TC, true>(x, y, tabs, info, B, L, c, tw_cols, col0, s)
                   : launch_a<LOGM, TC, false>(x, y, tabs, info, B, L, c, tw_cols, col0, s);
  });
}

template <int LOGM>
int dispatch_b(const void* t, void* y, const void* tabs, const void* info, int B, int L,
               int rows, int forward, cudaStream_t s) {
  return with_tile<1, 2, 4, 8>(rows, [&](auto tc) {
    constexpr int TC = decltype(tc)::value;
    return forward ? launch_b<LOGM, TC, true>(t, y, tabs, info, B, L, rows, s)
                   : launch_b<LOGM, TC, false>(t, y, tabs, info, B, L, rows, s);
  });
}

}  // namespace

// ops/cuda_lib.py builds this file in two parts that compile in parallel:
// PPQ_PART 0 holds kernel 4's entry point and instances, 1 kernel 5's;
// without PPQ_PART (probes/kernel_report.py) both.
#if !defined(PPQ_PART) || PPQ_PART == 0
// x, y: (B, L, m, c) int64, m in {8, 16, ..., 256}, c a multiple of 16 or a
// power of two below 16; info (L, 4): q and the offsets in tabs of the limb's
// m-vector pair, Pease row 0 pair and (m, tw_cols) twiddle pair, x holding
// the table's columns [col0, col0 + c) (col0 a multiple of the tile width,
// min(c, 16)).
extern "C" int ppq_streamed_stage_a(const void* x, void* y, const void* tabs, const void* info,
                                    int B, int L, int m, int c, int tw_cols, int col0,
                                    int forward, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 8: return dispatch_a<3>(x, y, tabs, info, B, L, c, tw_cols, col0, forward, s);
    case 16: return dispatch_a<4>(x, y, tabs, info, B, L, c, tw_cols, col0, forward, s);
    case 32: return dispatch_a<5>(x, y, tabs, info, B, L, c, tw_cols, col0, forward, s);
    case 64: return dispatch_a<6>(x, y, tabs, info, B, L, c, tw_cols, col0, forward, s);
    case 128: return dispatch_a<7>(x, y, tabs, info, B, L, c, tw_cols, col0, forward, s);
    case 256: return dispatch_a<8>(x, y, tabs, info, B, L, c, tw_cols, col0, forward, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#endif

#if !defined(PPQ_PART) || PPQ_PART == 1
// t: (B, L, rows, m) int64, transformed along its last axis (m in {8, ...,
// 256}, rows a multiple of 16 or a power of two below 16); y: (B, L, m,
// rows); info (L, 4) as above (the twiddle offset unused).
extern "C" int ppq_streamed_stage_b(const void* t, void* y, const void* tabs, const void* info,
                                    int B, int L, int m, int rows, int forward, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 8: return dispatch_b<3>(t, y, tabs, info, B, L, rows, forward, s);
    case 16: return dispatch_b<4>(t, y, tabs, info, B, L, rows, forward, s);
    case 32: return dispatch_b<5>(t, y, tabs, info, B, L, rows, forward, s);
    case 64: return dispatch_b<6>(t, y, tabs, info, B, L, rows, forward, s);
    case 128: return dispatch_b<7>(t, y, tabs, info, B, L, rows, forward, s);
    case 256: return dispatch_b<8>(t, y, tabs, info, B, L, rows, forward, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif
