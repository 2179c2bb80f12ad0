// Hybrid key-switch KSK inner product.
//
// Replaces: ppqsflhe_tpu/ops/pallas_ks.py, ks_inner_product (pallas_call at
// :127). Plain torch version: ops/cuda_ks.py ks_inner_product_plain. For each
// batch entry b, extended-basis limb l and coefficient:
//   acc_c = sum_j mont_mul(digit[b, j, l], ksk[j, c, l])  mod q_l,  c in {0, 1}
// with the key in Montgomery form (k*2^64 mod q), so one Montgomery product
// per term gives digit*k mod q.
//
// What bounds it here: memory. Per coefficient it reads nd digit words and,
// per batch entry, 2*nd key words, and writes 2 words, against 2*nd
// Montgomery products. The key slice (nd*2*N*8 B per limb) is the same for
// every batch entry. Design: one thread per (batch, limb, coefficient),
// looping over the nd digits; the grid puts the batch on its fastest axis,
// so the blocks that share a key slice run together and the slice is read
// from device memory about once and then served from L2 — what the TPU
// kernel's (limb, batch) grid order did for VMEM. A limb map lets the kernel
// read the needed limbs straight out of the full key, without a gathered copy.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// dig: (Bf, nd, LK, n); ksk: (ndk, 2, LKT, n); out: (Bf, 2, LK, n);
// limb_map[l]: limb of the key's LKT axis for output limb l;
// qs[l], qinvs[l]: q_l and -q_l^{-1} mod 2^64
__global__ void __launch_bounds__(THREADS)
ks_ip_kernel(const uint64_t* __restrict__ dig, const uint64_t* __restrict__ ksk,
             uint64_t* __restrict__ out, const int64_t* __restrict__ limb_map,
             const uint64_t* __restrict__ qs, const uint64_t* __restrict__ qinvs, int nd,
             int LK, int LKT, int n) {
  const int b = blockIdx.x;
  const int co = blockIdx.y * THREADS + threadIdx.x;
  const int l = blockIdx.z;
  if (co >= n) return;
  const uint64_t q = qs[l], qinv = qinvs[l];
  const int64_t kl = limb_map[l];
  uint64_t acc0 = 0, acc1 = 0;
  for (int j = 0; j < nd; ++j) {
    const uint64_t d = dig[((static_cast<int64_t>(b) * nd + j) * LK + l) * n + co];
    const uint64_t k0 = ksk[((2 * static_cast<int64_t>(j) + 0) * LKT + kl) * n + co];
    const uint64_t k1 = ksk[((2 * static_cast<int64_t>(j) + 1) * LKT + kl) * n + co];
    acc0 = ppq::modadd(acc0, ppq::mont_mul(d, k0, q, qinv), q);
    acc1 = ppq::modadd(acc1, ppq::mont_mul(d, k1, q, qinv), q);
  }
  out[((static_cast<int64_t>(b) * 2 + 0) * LK + l) * n + co] = acc0;
  out[((static_cast<int64_t>(b) * 2 + 1) * LK + l) * n + co] = acc1;
}

}  // namespace

extern "C" int ppq_ks_inner_product(const void* dig, const void* ksk, void* out,
                                    const void* limb_map, const void* qs, const void* qinvs,
                                    int Bf, int nd, int LK, int LKT, int n, void* stream) {
  dim3 grid(Bf, (n + THREADS - 1) / THREADS, LK);
  ks_ip_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(dig), static_cast<const uint64_t*>(ksk),
      static_cast<uint64_t*>(out), static_cast<const int64_t*>(limb_map),
      static_cast<const uint64_t*>(qs), static_cast<const uint64_t*>(qinvs), nd, LK, LKT, n);
  return static_cast<int>(cudaGetLastError());
}
