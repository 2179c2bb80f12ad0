// Kernel 7: does an int8 tensor-core product run alongside an independent
// 32-bit integer chain on one SM?
//
// Replaces: probes/mxu_vpu_overlap.py, make (pallas_call at :59), the TPU
// probe of MXU/VPU co-issue. Plain torch version:
// ppqsflhe_tpu_torch/probes/mxu_vpu_overlap.py probe_plain. Per cell k, with
// x = X8[k] ^ carry (carry: the low byte of the previous call's
// out[0, 0, 0], read on the device) and x0, x1 its two column halves:
//   mxu    : out = [A[:m] @ x0, A[:m] @ x1]                 (int32 as uint32)
//   vpu    : out = chain(x[:m] sign-extended), per half
//   serial : dot0; chain(dot0); dot1; chain(dot1)
//   inter  : dot0; dot1 with chain(dot0) between its issues; chain(dot1)
// where chain is 20 rounds of x = (x * 2654435761 + i) ^ (x >> 7) in uint32.
// serial and inter give the same output; the order is what is timed. Only
// the m rows of A that reach the output are computed: 2*m*(nd*m)*c int8
// operations per cell.
//
// What bounds it: at the probe's shapes (m=256, nd=6, c=256, K=64) the call
// must read X8 (25.2 MB) and write the output (16.8 MB): 12.6 us at 3.35
// TB/s, against 6.5 us for the int8 products at 1,979 T/s.
//
// Design (sm_90a). Each cell's m rows are split over m/128 CTAs (TWO CTAs a
// cell at m=256: 128 CTAs for K=64, on 128 of the 132 SMs), adjacent in
// blockIdx so the pair reads its x from L2 once. A CTA holds THREE
// warpgroups: two consumers (64 output rows each, both halves: two
// m64n128 int32 accumulators, 64 registers each, raised to 224 registers
// with setmaxnreg) and one producer (lowered to 56). The products are
// wgmma.mma_async m64n128k32 .s32.s8.s8 with both operands in shared memory
// in the 128-byte swizzle (int8 wgmma takes K-major operands only). The
// contraction runs in chunks of KC=128 bytes, one pass per column half (the
// order decides when each half's chain runs), so a CTA walks 2*W/KC steps.
// Per step: one thread of the producer sends TMA copies of the A[:m] chunk
// (128 rows x 128 bytes, swizzled by the copy) into an OS-stage operand ring
// and of the x half-chunk (128 rows x 128 bytes, as stored) into an RS-stage
// staging ring, both on mbarriers; the producer warpgroup then XORs the
// carry into the staged chunk and transposes it (4 x 4 byte blocks,
// __byte_perm) into the K-major swizzled B tile, fences the generic-proxy
// stores for the async proxy (fence.proxy.async) and arrives on the step's
// full barrier. The staging ring is refilled RS steps ahead, so x is read
// once per CTA and the copies stay off the consumers' path; the consumers'
// only CUDA-core work is the chains. Each consumer warp releases a stage
// (an mbarrier arrival) once wgmma.wait_group shows its products done.
//
// The four orders are wgmma group disciplines over the same steps (one
// commit group per step; the output is the same as the plain version's):
//   mxu    : every step's group issued with one group in flight (wait_group
//            1 releases the previous stage), wait_group 0, store.
//   vpu    : chains only, on x read straight from global; no products.
//   serial : dot0's groups, wait_group 0, chain(dot0), store; only then
//            dot1's groups, wait_group 0, chain(dot1), store.
//   inter  : dot0's groups, wait_group 0; then each of dot1's groups is
//            committed and a slice of chain(dot0)'s rounds runs before the
//            wait_group 1 that retires the previous group; then chain(dot1).
// inter is the pattern an NTT built on tensor-core products would use: the
// REDC or butterfly epilogue of one tile run on the CUDA cores while the
// next tile's products are in flight. If the tensor cores and the integer
// pipes overlap within the SM, inter approaches max(mxu, serial - mxu);
// if they do not, it stays at serial. ptxas must not serialize the wgmmas
// for that reading to mean anything: `python3 -m
// ppqsflhe_tpu_torch.probes.kernel_report` prints what it says.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

namespace {

constexpr int BM = 128;             // output rows per CTA (two consumer warpgroups)
constexpr int H = 128;              // columns per half: c = 256
constexpr int KC = 128;             // contraction bytes per step (one 128-byte swizzle row)
constexpr int OS = 4;               // operand ring stages (A chunk + B tile)
constexpr int RS = 3;               // staging ring stages (x half-chunk as stored)
constexpr int TILE = BM * KC;       // bytes of an A chunk, a B tile, a staged chunk: 16 KB
constexpr int THREADS = 384;        // warpgroups 0, 1: consumers; 2: producer
constexpr int PRODUCER = 256;       // first producer thread: it sends the copies
constexpr int ROUNDS = 20;
constexpr int SMEM = (2 * OS + RS) * TILE + (2 * OS + RS) * 8 + 1024;   // + alignment slack

enum Kind { MXU = 0, VPU = 1, SERIAL = 2, INTER = 3 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
      "selp.u32 %0, 1, 0, p; }"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// returns once the phase of the given parity has completed; a wait of more
// than 2^34 clocks (about 10 s) traps, so a broken pipeline fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// a 2-D TMA copy of the box at (col, row) into shared memory, on an mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO = 64 x 16 B), LBO unused (1)
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the wgmma
// fences and waits
__device__ __forceinline__ void fence_acc(uint32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) : : "memory");
}

// d += A (64 x 32, K-major) @ B (32 x 128, K-major as B^T), int8 -> int32
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p; }"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// rounds [lo, hi) of the chain on every accumulator value
__device__ __forceinline__ void chain(uint32_t (&d)[64], int lo, int hi) {
  for (int k = lo; k < hi; ++k)
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = (d[i] * 2654435761u + static_cast<uint32_t>(k)) ^ (d[i] >> 7);
}

// Accumulator layout of m64nNk32 (as the f32 one): thread t of the
// warpgroup holds, for n8 block j, rows 16*(t/32) + (t%32)/4 (+8) and
// columns 8j + 2*(t%4) (+1) in d[4j .. 4j+3].
__device__ __forceinline__ void store_half(const uint32_t (&d)[64], int* __restrict__ o, int row0,
                                           int col0, int c) {
  const int t = threadIdx.x & 127;
  const int r = row0 + 16 * (t >> 5) + ((t & 31) >> 2), n = col0 + 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<int2*>(o + static_cast<int64_t>(r + 8 * hh) * c + n + 8 * j) =
          make_int2(static_cast<int>(d[4 * j + 2 * hh]), static_cast<int>(d[4 * j + 2 * hh + 1]));
}

// the vpu order's operand: x[row][col] ^ carry sign-extended, in the
// accumulator layout
__device__ __forceinline__ void load_x(uint32_t (&d)[64], const int8_t* __restrict__ x, int row0,
                                       int col0, int c, uint32_t carry2) {
  const int t = threadIdx.x & 127;
  const int r = row0 + 16 * (t >> 5) + ((t & 31) >> 2), n = col0 + 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t v = *reinterpret_cast<const uint16_t*>(
                             x + static_cast<int64_t>(r + 8 * hh) * c + n + 8 * j) ^ carry2;
      d[4 * j + 2 * hh] = static_cast<uint32_t>(static_cast<int>(static_cast<int8_t>(v & 0xFF)));
      d[4 * j + 2 * hh + 1] = static_cast<uint32_t>(static_cast<int>(static_cast<int8_t>(v >> 8)));
    }
}

struct Ring {
  uint32_t a, b, raw;                       // stage 0 of each ring (shared addresses)
  uint32_t full, empty, staged;             // mbarrier arrays (OS, OS, RS)
};

// The producer warpgroup's transpose of one staged step: raw[k][n] (128 x
// 128 bytes, as stored) ^ carry -> B[n][k] in the 128-byte swizzle, byte
// (n, k) at n*128 + (((k >> 4) ^ (n & 7)) << 4) + (k & 15). Thread p takes
// the 4 x 16 blocks (columns 4q .. 4q+3, q = p % 32; k-groups g = p/32 and
// p/32 + 4): 16 conflict-free 4-byte loads each (a warp reads one 128-byte
// row). The selectors rotate the four output rows by r = (q/2) % 4 so that
// each 8-lane phase of the 16-byte stores meets 8 distinct (n & 7), i.e. 8
// distinct 16-byte slots of a 128-byte line: conflict-free too.
__device__ __forceinline__ void transpose_step(uint32_t raw, uint32_t b, uint32_t carry4) {
  const int p = threadIdx.x - PRODUCER, q = p & 31;
  const uint32_t r = (q >> 1) & 3;
  const uint32_t r1 = (r + 1) & 3, r2 = (r + 2) & 3, r3 = (r + 3) & 3;
  const uint32_t sa = r | ((4 + r) << 4) | (r1 << 8) | ((4 + r1) << 12);
  const uint32_t sb = r2 | ((4 + r2) << 4) | (r3 << 8) | ((4 + r3) << 12);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int g = (p >> 5) + 4 * u;
    uint32_t o[4][4];
#pragma unroll
    for (int mq = 0; mq < 4; ++mq) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        asm volatile("ld.shared.u32 %0, [%1];"
                     : "=r"(w[i])
                     : "r"(raw + (16 * g + 4 * mq + i) * KC + 4 * q));
        w[i] ^= carry4;
      }
      const uint32_t t0 = __byte_perm(w[0], w[1], sa), t1 = __byte_perm(w[2], w[3], sa);
      const uint32_t t2 = __byte_perm(w[0], w[1], sb), t3 = __byte_perm(w[2], w[3], sb);
      o[0][mq] = __byte_perm(t0, t1, 0x5410);     // row 4q + r
      o[1][mq] = __byte_perm(t0, t1, 0x7632);     // row 4q + r + 1
      o[2][mq] = __byte_perm(t2, t3, 0x5410);     // row 4q + r + 2
      o[3][mq] = __byte_perm(t2, t3, 0x7632);     // row 4q + r + 3
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = 4 * q + ((s + r) & 3);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                       b + n * KC + (((g ^ (n & 7))) << 4)),
                   "r"(o[s][0]), "r"(o[s][1]), "r"(o[s][2]), "r"(o[s][3])
                   : "memory");
    }
  }
}

// step t: column half t / nc, contraction chunk t % nc
__device__ __forceinline__ void send_x(const Ring& rg, const CUtensorMap* xmap, int t, int nc,
                                       int xrow0) {
  const int s = t % RS;
  mbar_arrive_tx(rg.staged + 8 * s, TILE);
  tma_load(rg.raw + s * TILE, xmap, (t / nc) * H, xrow0 + (t % nc) * KC, rg.staged + 8 * s);
}

__device__ void producer(const Ring& rg, const CUtensorMap* xmap, const CUtensorMap* amap,
                         int steps, int nc, int xrow0, int arow0, uint32_t carry4) {
  const bool leader = threadIdx.x == PRODUCER;
  if (leader)
    for (int t = 0; t < steps && t < RS; ++t) send_x(rg, xmap, t, nc, xrow0);
  for (int t = 0; t < steps; ++t) {
    const int os = t % OS, rs = t % RS;
    mbar_wait(rg.empty + 8 * os, ((t / OS) & 1) ^ 1);
    if (leader) {
      mbar_expect_tx(rg.full + 8 * os, TILE);
      tma_load(rg.a + os * TILE, amap, (t % nc) * KC, arow0, rg.full + 8 * os);
    }
    mbar_wait(rg.staged + 8 * rs, (t / RS) & 1);
    transpose_step(rg.raw + rs * TILE, rg.b + os * TILE, carry4);
    fence_async_smem();
    mbar_arrive(rg.full + 8 * os);
    asm volatile("bar.sync 1, 128;" ::: "memory");    // the staged chunk is read
    if (leader && t + RS < steps) {
      fence_async_smem();
      send_x(rg, xmap, t + RS, nc, xrow0);
    }
  }
}

// one step's products into d: the consumer warpgroup's 64 rows of the A
// chunk against the B tile, four k32 slices
__device__ __forceinline__ void issue_step(uint32_t (&d)[64], const Ring& rg, int t, int wg) {
  const int os = t % OS;
  mbar_wait(rg.full + 8 * os, (t / OS) & 1);
  __syncwarp();                       // the .aligned wgmma instructions need the warp whole
  const uint32_t a = rg.a + os * TILE + wg * 64 * KC, b = rg.b + os * TILE;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KC / 32; ++kk) wgmma_s8(d, desc_b128(a + 32 * kk), desc_b128(b + 32 * kk));
  wgmma_commit();
}

__device__ __forceinline__ void release(const Ring& rg, int t) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(rg.empty + 8 * (t % OS));
}

// x8: (K, W, c) int8 with W = nd*m; A: (W, W) int8, rows [0, m) used (both
// through the tensor maps); carry_src: an int32 whose low byte is the carry;
// out: (K, m, c) uint32 bits. CTA (cell, row block) = blockIdx.x / nb, % nb.
template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
overlap_probe_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap amap, const int8_t* __restrict__ x8,
                     const int* __restrict__ carry_src, int* __restrict__ out, int W, int m,
                     int c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  Ring rg;
  rg.a = base;
  rg.b = base + OS * TILE;
  rg.raw = base + 2 * OS * TILE;
  rg.full = base + (2 * OS + RS) * TILE;
  rg.empty = rg.full + 8 * OS;
  rg.staged = rg.empty + 8 * OS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < OS; ++s) {
      mbar_init(rg.full + 8 * s, 128);        // the producer warpgroup's arrivals (+ A's bytes)
      mbar_init(rg.empty + 8 * s, 8);         // one arrival per consumer warp
    }
    for (int s = 0; s < RS; ++s) mbar_init(rg.staged + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nb = m / BM, cell = blockIdx.x / nb, row0 = (blockIdx.x % nb) * BM;
  const uint32_t cb = static_cast<uint32_t>(*carry_src) & 0xFFu;
  const int nc = W / KC, steps = KIND == VPU ? 0 : 2 * nc;
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    producer(rg, &xmap, &amap, steps, nc, cell * W, row0, cb * 0x01010101u);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    int* o = out + static_cast<int64_t>(cell) * m * c;
    const int r0 = row0 + 64 * wg;
    uint32_t acc0[64], acc1[64];
    if (KIND == VPU) {
      const int8_t* x = x8 + static_cast<int64_t>(cell) * W * c;
      load_x(acc0, x, r0, 0, c, cb * 0x0101u);
      chain(acc0, 0, ROUNDS);
      store_half(acc0, o, r0, 0, c);
      load_x(acc1, x, r0, H, c, cb * 0x0101u);
      chain(acc1, 0, ROUNDS);
      store_half(acc1, o, r0, H, c);
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
      fence_acc(acc0);
      fence_acc(acc1);
      // dot0: steps [0, nc)
      for (int t = 0; t < nc; ++t) {
        issue_step(acc0, rg, t, wg);
        wgmma_wait<1>();
        if (t > 0) release(rg, t - 1);
      }
      if (KIND != MXU) {
        wgmma_wait<0>();
        fence_acc(acc0);
        release(rg, nc - 1);
        if (KIND == SERIAL) {
          chain(acc0, 0, ROUNDS);
          store_half(acc0, o, r0, 0, c);
        }
      }
      // dot1: steps [nc, 2 nc); inter runs chain(dot0) a slice per step
      for (int j = 0; j < nc; ++j) {
        const int t = nc + j;
        issue_step(acc1, rg, t, wg);
        if (KIND == INTER) chain(acc0, ROUNDS * j / nc, ROUNDS * (j + 1) / nc);
        wgmma_wait<1>();
        if (KIND == MXU || j > 0) release(rg, t - 1);
      }
      wgmma_wait<0>();
      fence_acc(acc0);
      fence_acc(acc1);
      release(rg, 2 * nc - 1);
      if (KIND != SERIAL) store_half(acc0, o, r0, 0, c);
      if (KIND != MXU) chain(acc1, 0, ROUNDS);
      store_half(acc1, o, r0, H, c);
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a 2-D int8 tensor map over rows x cols (row stride cols bytes), box of
// 128 x 128 bytes; the last map encoded for each use is kept
struct MapCache {
  const void* ptr = nullptr;
  uint64_t rows = 0, cols = 0;
  CUtensorMap map;
};

bool encode(MapCache& mc, const void* ptr, uint64_t rows, uint64_t cols,
            CUtensorMapSwizzle swizzle) {
  if (mc.ptr == ptr && mc.rows == rows && mc.cols == cols) return true;
  const auto fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {cols};
  const cuuint32_t box[2] = {KC, BM}, one[2] = {1, 1};
  if (fn(&mc.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
         one, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    mc.ptr = nullptr;
    return false;
  }
  mc.ptr = ptr;
  mc.rows = rows;
  mc.cols = cols;
  return true;
}

template <int KIND>
int launch(const CUtensorMap& xm, const CUtensorMap& am, const int8_t* x, const int* cs, int* o,
           int K, int W, int m, int c, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        overlap_probe_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  overlap_probe_kernel<KIND><<<K * (m / BM), THREADS, SMEM, s>>>(xm, am, x, cs, o, W, m, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 mxu, 1 vpu, 2 serial, 3 inter. m / 128 CTAs per cell. Needs
// c == 256, m % 128 == 0, W % 128 == 0, m <= W (the wrapper checks; the
// kernel returns cudaErrorInvalidValue otherwise).
extern "C" int ppq_overlap_probe(const void* x8, const void* a, const void* carry, void* out,
                                 int kind, int K, int W, int m, int c, void* stream) {
  static MapCache xcache, acache;
  if (c != 2 * H || m % BM || W % KC || m > W || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!encode(xcache, x8, static_cast<uint64_t>(K) * W, c, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(acache, a, m, W, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(x8);
  const auto* cs = static_cast<const int*>(carry);
  auto* o = static_cast<int*>(out);
  switch (kind) {
    case MXU: return launch<MXU>(xcache.map, acache.map, x, cs, o, K, W, m, c, s);
    case VPU: return launch<VPU>(xcache.map, acache.map, x, cs, o, K, W, m, c, s);
    case SERIAL: return launch<SERIAL>(xcache.map, acache.map, x, cs, o, K, W, m, c, s);
    case INTER: return launch<INTER>(xcache.map, acache.map, x, cs, o, K, W, m, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
