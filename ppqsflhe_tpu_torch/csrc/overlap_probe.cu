// Kernel 7: does an int8 tensor-core product run alongside an independent
// 32-bit integer chain on one SM?
//
// Replaces: probes/mxu_vpu_overlap.py, make (pallas_call at :59), the TPU
// probe of MXU/VPU co-issue. Plain torch version:
// ppqsflhe_tpu_torch/probes/mxu_vpu_overlap.py probe_plain. Per cell k (one
// CTA each), with x = X8[k] ^ carry (carry: the low byte of the previous
// call's out[0, 0, 0], read on the device) and x0, x1 its two column halves:
//   mxu    : out = [A[:m] @ x0, A[:m] @ x1]                 (int32 as uint32)
//   vpu    : out = chain(x[:m] sign-extended), per half
//   serial : dot0; chain(dot0); dot1; chain(dot1)
//   inter  : dot0; dot1; chain(dot0); chain(dot1)
// where chain is 20 rounds of x = (x * 2654435761 + i) ^ (x >> 7) in uint32.
// serial and inter give the same output; the order is what is timed. The
// TPU kernel contracted all nd*m rows of A and sliced the m rows it stores
// (:38-40, :47-53); here only the m rows that reach the output are
// computed: 2*m*(nd*m)*c int8 operations per cell.
//
// What bounds it: at the probe's shapes (m=256, nd=6, c=256, K=64) the call
// must read X8 (25.2 MB) and write the output (16.8 MB): about 12.5 us at
// 3.35 TB/s, against about 6.5 us for the int8 products at 1,979 T/s. The
// question is not the bound but the order: one CTA per cell, so with K=64
// the call fills 64 of the 132 SMs, and us/cell reads what one SM does with
// a tensor-core stream and an integer chain in each order -- the question
// of the digit-matmul NTT's REDC epilogue behind the next tile's products.
// All four kinds are instances of one templated body, so only the order of
// the dots and chains differs between serial and inter.
//
// Design: 8 warps; the m output rows in tiles of 64 (4 warps x 16 rows), a
// half's 128 columns as 2 warps x 64 (eight m16n8k32 tiles per warp). Each
// dot walks the contraction in chunks of 64: the A chunk is copied to
// shared memory, the x chunk is read in 4x4-byte blocks, XORed with the
// carry and transposed in registers (__byte_perm) into the column-major
// layout mma.sync's B operand takes. Both halves' accumulators stay in
// registers (64 per thread) until the chains and the store.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // 8 warps
constexpr int TM = 64;              // output rows per row tile (4 warps x 16)
constexpr int H = 128;              // columns per half: c = 256
constexpr int WN = 64;              // columns per warp
constexpr int NT = WN / 8;          // m16n8k32 tiles per warp
constexpr int KC = 64;              // contraction bytes per chunk
constexpr int S = KC + 16;          // shared row stride: conflict-free fragment loads
constexpr int ROUNDS = 20;

enum Kind { MXU = 0, VPU = 1, SERIAL = 2, INTER = 3 };

struct Smem {
  int8_t As[TM][S];                 // A rows of the tile, one contraction chunk
  int8_t Bs[H][S];                  // x chunk, transposed: Bs[column][k]
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc = A[row0:row0+64] @ x[:, col0:col0+128] for this warp's 16 x 64 share
__device__ __forceinline__ void dot(int (&acc)[NT][4], Smem& sm, const int8_t* __restrict__ x,
                                    const int8_t* __restrict__ A, int row0, int col0, int W,
                                    int c, uint32_t carry4) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = (warp & 3) * 16, n0 = (warp >> 2) * WN;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;

  for (int kc = 0; kc < W; kc += KC) {
    {  // A chunk: 64 rows x 64 bytes, 16 bytes a thread
      const int ar = tid >> 2, seg = tid & 3;
      *reinterpret_cast<int4*>(&sm.As[ar][seg * 16]) = *reinterpret_cast<const int4*>(
          A + static_cast<int64_t>(row0 + ar) * W + kc + seg * 16);
    }
    // x chunk: 4x4-byte blocks (4 rows k x 4 columns), carry XORed in,
    // transposed so each word holds 4 consecutive k of one column
    for (int v = tid; v < (KC / 4) * (H / 4); v += THREADS) {
      const int kq = v & (KC / 4 - 1), cq = v / (KC / 4);
      const int8_t* src = x + static_cast<int64_t>(kc + kq * 4) * c + col0 + cq * 4;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(src) ^ carry4;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(src + c) ^ carry4;
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(src + 2 * c) ^ carry4;
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(src + 3 * c) ^ carry4;
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w2, w3, 0x5140);
      const uint32_t t2 = __byte_perm(w0, w1, 0x7362), t3 = __byte_perm(w2, w3, 0x7362);
      *reinterpret_cast<uint32_t*>(&sm.Bs[cq * 4 + 0][kq * 4]) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(&sm.Bs[cq * 4 + 1][kq * 4]) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(&sm.Bs[cq * 4 + 2][kq * 4]) = __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(&sm.Bs[cq * 4 + 3][kq * 4]) = __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KC; ks += 32) {
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(&sm.As[r + g][ks + t * 4]);
      af[1] = *reinterpret_cast<const uint32_t*>(&sm.As[r + g + 8][ks + t * 4]);
      af[2] = *reinterpret_cast<const uint32_t*>(&sm.As[r + g][ks + 16 + t * 4]);
      af[3] = *reinterpret_cast<const uint32_t*>(&sm.As[r + g + 8][ks + 16 + t * 4]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + nt * 8 + g;
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(&sm.Bs[n][ks + t * 4]),
                                *reinterpret_cast<const uint32_t*>(&sm.Bs[n][ks + 16 + t * 4])};
        mma_s8(acc[nt], af, bf);
      }
    }
    __syncthreads();
  }
}

// the vpu kind's operand: x[row][col] ^ carry sign-extended, in the
// accumulator layout
__device__ __forceinline__ void load_x(int (&acc)[NT][4], const int8_t* __restrict__ x,
                                       int row0, int col0, int c, int8_t carry8) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = row0 + (warp & 3) * 16, n0 = col0 + (warp >> 2) * WN;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + g + 8 * (i >> 1), col = n0 + nt * 8 + t * 2 + (i & 1);
      acc[nt][i] = static_cast<int8_t>(x[static_cast<int64_t>(row) * c + col] ^ carry8);
    }
}

__device__ __forceinline__ void chain(int (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v = static_cast<uint32_t>(acc[nt][i]);
#pragma unroll
      for (int k = 0; k < ROUNDS; ++k) v = (v * 2654435761u + static_cast<uint32_t>(k)) ^ (v >> 7);
      acc[nt][i] = static_cast<int>(v);
    }
}

__device__ __forceinline__ void store(const int (&acc)[NT][4], int* __restrict__ o, int row0,
                                      int col0, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = row0 + (warp & 3) * 16, n0 = col0 + (warp >> 2) * WN;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r + g + 8 * hh, col = n0 + nt * 8 + t * 2;
      *reinterpret_cast<int2*>(o + static_cast<int64_t>(row) * c + col) =
          make_int2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
    }
}

// x8: (K, W, c) int8 with W = nd*m; A: (W, W) int8, rows [0, m) used;
// carry_src: an int32 whose low byte is the carry; out: (K, m, c) uint32 bits
template <int KIND>
__global__ void __launch_bounds__(THREADS)
overlap_probe_kernel(const int8_t* __restrict__ x8, const int8_t* __restrict__ A,
                     const int* __restrict__ carry_src, int* __restrict__ out, int W, int m,
                     int c) {
  __shared__ __align__(16) Smem sm;
  const int8_t* x = x8 + static_cast<int64_t>(blockIdx.x) * W * c;
  int* o = out + static_cast<int64_t>(blockIdx.x) * m * c;
  const uint32_t cb = static_cast<uint32_t>(*carry_src) & 0xFFu;
  const uint32_t carry4 = cb * 0x01010101u;
  const int8_t carry8 = static_cast<int8_t>(cb);
  for (int row0 = 0; row0 < m; row0 += TM) {
    int acc0[NT][4], acc1[NT][4];
    if (KIND == VPU) {
      load_x(acc0, x, row0, 0, c, carry8);
      chain(acc0);
      store(acc0, o, row0, 0, c);
      load_x(acc1, x, row0, H, c, carry8);
      chain(acc1);
      store(acc1, o, row0, H, c);
      continue;
    }
    dot(acc0, sm, x, A, row0, 0, W, c, carry4);
    if (KIND == SERIAL) {
      chain(acc0);
      store(acc0, o, row0, 0, c);
    }
    dot(acc1, sm, x, A, row0, H, W, c, carry4);
    if (KIND == SERIAL) {
      chain(acc1);
      store(acc1, o, row0, H, c);
      continue;
    }
    if (KIND == INTER) {
      chain(acc0);
      chain(acc1);
    }
    store(acc0, o, row0, 0, c);
    store(acc1, o, row0, H, c);
  }
}

}  // namespace

// kind: 0 mxu, 1 vpu, 2 serial, 3 inter; one CTA per cell. Needs c == 256,
// m % 64 == 0, W % 64 == 0, W >= m (the wrapper checks).
extern "C" int ppq_overlap_probe(const void* x8, const void* a, const void* carry, void* out,
                                 int kind, int K, int W, int m, int c, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x8);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* cs = static_cast<const int*>(carry);
  auto* o = static_cast<int*>(out);
  switch (kind) {
    case MXU: overlap_probe_kernel<MXU><<<K, THREADS, 0, s>>>(x, A, cs, o, W, m, c); break;
    case VPU: overlap_probe_kernel<VPU><<<K, THREADS, 0, s>>>(x, A, cs, o, W, m, c); break;
    case SERIAL: overlap_probe_kernel<SERIAL><<<K, THREADS, 0, s>>>(x, A, cs, o, W, m, c); break;
    case INTER: overlap_probe_kernel<INTER><<<K, THREADS, 0, s>>>(x, A, cs, o, W, m, c); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
