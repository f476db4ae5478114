// Kernel B1: paged relevance scoring (Salca phase 1) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/score_est/kernel.py::paged_score_estimate_pallas.
// For slot s and logical block j it reads physical block pages[s, j] of the
// packed 2-bit key-feature pool and writes
//     scores[s, kv, j*BS + t] = sum_g chain(q_scale, a, z, <q_codes, codes>, q_sum)
// where chain is quantization.dequant_score_chain with bf16 rounding pinned
// after every op (__float2bfloat16_rn round trips, no FMA contraction), so
// the output is bit-identical to the plain PyTorch version.
//
// Bound on this card: bytes. Per (token, kv head) it reads 16 B of words
// plus 8 B of scale/zero and does 64 small integer MACs, far below the
// ~300 ops/byte where compute would bind. Design: one CTA per (slot,
// logical block) loads its own page id (Hopper has no scalar prefetch);
// threads walk the block token-major so consecutive threads read
// consecutive 24 B records; the (KV, G, r) query codes sit in shared
// memory. The integer dot is plain int32 FMAs (exact). No tensor cores:
// at r = 64 the kernel is a memory stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float rp(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void paged_score_estimate_kernel(
    const int8_t* __restrict__ q_codes,     // (S, KV, G, R)
    const float* __restrict__ q_scale,      // (S, KV, G)
    const int32_t* __restrict__ q_sums,     // (S, KV, G)
    const uint32_t* __restrict__ words,     // (P, BS, KV, R/16)
    const float* __restrict__ feat_scale,   // (P, BS, KV)
    const float* __restrict__ feat_zero,    // (P, BS, KV)
    const int32_t* __restrict__ pages,      // (S, MB), clamped >= 0
    float* __restrict__ out,                // (S, KV, MB*BS)
    int KV, int G, int R, int BS, int MB, int bf16) {
  extern __shared__ int8_t q_sh[];          // (KV, G, R) of this slot
  const int j = blockIdx.x;
  const int s = blockIdx.y;
  const int W = R / 16;
  const int nq = KV * G * R;
  for (int i = threadIdx.x; i < nq; i += blockDim.x) q_sh[i] = q_codes[(size_t)s * nq + i];
  __syncthreads();
  const size_t page = (size_t)pages[(size_t)s * MB + j];
  for (int idx = threadIdx.x; idx < BS * KV; idx += blockDim.x) {
    const int t = idx / KV;
    const int kv = idx % KV;
    const size_t row = (page * BS + t) * KV + kv;
    const uint32_t* w = words + row * W;
    const float a = feat_scale[row];
    const float z = feat_zero[row];
    float acc = 0.f;
    for (int g = 0; g < G; ++g) {
      const int8_t* q = q_sh + (kv * G + g) * R;
      int dot = 0;
      for (int wi = 0; wi < W; ++wi) {
        const uint32_t word = w[wi];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          dot += (int)((word >> (2 * c)) & 3u) * (int)q[wi * 16 + c];
        }
      }
      const int qi = (s * KV + kv) * G + g;
      const float d = (float)dot;
      const float qm = (float)q_sums[qi];
      const float sq = q_scale[qi];
      float sc;
      if (bf16) {
        sc = rp(__fmul_rn(rp(sq), rp(__fadd_rn(rp(__fmul_rn(rp(a), rp(d))),
                                               rp(__fmul_rn(rp(z), rp(qm)))))));
      } else {
        sc = __fmul_rn(sq, __fadd_rn(__fmul_rn(a, d), __fmul_rn(z, qm)));
      }
      acc = (g == 0) ? sc : __fadd_rn(acc, sc);
    }
    out[((size_t)s * KV + kv) * ((size_t)MB * BS) + (size_t)j * BS + t] = acc;
  }
}

}  // namespace

extern "C" int paged_score_estimate(const void* q_codes, const void* q_scale,
                                    const void* q_sums, const void* words,
                                    const void* feat_scale, const void* feat_zero,
                                    const void* pages, void* out, int S, int KV, int G,
                                    int R, int BS, int MB, int bf16, void* stream) {
  int threads = BS * KV;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : ((threads + 31) / 32) * 32);
  const dim3 grid(MB, S);
  const size_t smem = (size_t)KV * G * R;
  paged_score_estimate_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q_codes, (const float*)q_scale, (const int32_t*)q_sums,
      (const uint32_t*)words, (const float*)feat_scale, (const float*)feat_zero,
      (const int32_t*)pages, (float*)out, KV, G, R, BS, MB, bf16);
  return (int)cudaGetLastError();
}
