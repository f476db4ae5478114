// Kernels B1 and B4: paged relevance scoring (Salca phase 1) for Hopper
// (sm_90a).
//
// B1 replaces src/repro/kernels/score_est/kernel.py::paged_score_estimate_pallas.
// For slot s and logical block j it reads physical block pages[s, j] of the
// packed 2-bit key-feature pool and writes
//     scores[s, kv, j*BS + t] = sum_g chain(q_scale, a, z, <q_codes, codes>, q_sum)
// where chain is quantization.dequant_score_chain with bf16 rounding pinned
// after every op (__float2bfloat16_rn round trips, no FMA contraction), so
// the output is bit-identical to the plain PyTorch version.
//
// B4 replaces paged_score_bounds_pallas (the block-sharded tick's phase 1):
// the same scores, set to SCORE_NEG_INF where blk_valid[s, j, t] is 0, plus
// the raw per-(slot, kv) binning bounds lo = min over valid scores (+inf
// when none) and hi = max over the masked scores. Both kernels are one
// template over the same body. The TPU kernel carries (lo, hi) in scratch
// along its sequential block axis; here the blocks of a row run in parallel
// CTAs, so each CTA reduces its block in shared memory and folds the result
// into the (S, KV) outputs with order-preserving integer atomics on the
// float bits (min/max are exact, so the order does not matter and the
// bounds equal the plain reduction bit for bit). The wrapper fills lo with
// +inf and hi with -inf before the launch.
//
// Bound on this card: bytes. Per (token, kv head) it reads 16 B of words
// plus 8 B of scale/zero (plus 1 B of validity per token for B4) and does
// 64 small integer MACs, far below the ~300 ops/byte where compute would
// bind. Design: one CTA per (slot, logical block) loads its own page id
// (Hopper has no scalar prefetch); threads walk the block token-major so
// consecutive threads read consecutive 24 B records; the (KV, G, r) query
// codes sit in shared memory. The integer dot is plain int32 FMAs (exact).
// No tensor cores: at r = 64 the kernel is a memory stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float SCORE_NEG_INF = -3.0e38f;

__device__ __forceinline__ float rp(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Float min/max through integer atomics on the bits: for a clear sign bit
// the int order is the float order; for a set sign bit the unsigned order
// is the reverse of the float order (-0.0 included).
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0) atomicMin((int*)addr, __float_as_int(v));
  else atomicMax((unsigned int*)addr, __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0) atomicMax((int*)addr, __float_as_int(v));
  else atomicMin((unsigned int*)addr, __float_as_uint(v));
}

template <bool BOUNDS>
__global__ void paged_score_kernel(
    const int8_t* __restrict__ q_codes,     // (S, KV, G, R)
    const float* __restrict__ q_scale,      // (S, KV, G)
    const int32_t* __restrict__ q_sums,     // (S, KV, G)
    const uint32_t* __restrict__ words,     // (P, BS, KV, R/16)
    const float* __restrict__ feat_scale,   // (P, BS, KV)
    const float* __restrict__ feat_zero,    // (P, BS, KV)
    const int32_t* __restrict__ pages,      // (S, MB), clamped >= 0
    const uint8_t* __restrict__ blk_valid,  // (S, MB, BS)   [BOUNDS]
    float* __restrict__ out,                // (S, KV, MB*BS)
    float* __restrict__ lo,                 // (S, KV)       [BOUNDS]
    float* __restrict__ hi,                 // (S, KV)       [BOUNDS]
    int KV, int G, int R, int BS, int MB, int bf16) {
  extern __shared__ float sh[];
  float* lo_sh = sh;                        // (KV)          [BOUNDS]
  float* hi_sh = sh + KV;                   // (KV)          [BOUNDS]
  int8_t* q_sh = (int8_t*)(sh + (BOUNDS ? 2 * KV : 0));   // (KV, G, R) of this slot
  const int j = blockIdx.x;
  const int s = blockIdx.y;
  const int W = R / 16;
  const int nq = KV * G * R;
  for (int i = threadIdx.x; i < nq; i += blockDim.x) q_sh[i] = q_codes[(size_t)s * nq + i];
  if (BOUNDS) {
    for (int i = threadIdx.x; i < KV; i += blockDim.x) {
      lo_sh[i] = INFINITY;
      hi_sh[i] = -INFINITY;
    }
  }
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
    if (BOUNDS) {
      const bool valid = blk_valid[((size_t)s * MB + j) * BS + t] != 0;
      if (valid) atomic_min_f32(&lo_sh[kv], acc);
      else acc = SCORE_NEG_INF;
      atomic_max_f32(&hi_sh[kv], acc);
    }
    out[((size_t)s * KV + kv) * ((size_t)MB * BS) + (size_t)j * BS + t] = acc;
  }
  if (BOUNDS) {
    __syncthreads();
    for (int kv = threadIdx.x; kv < KV; kv += blockDim.x) {
      if (lo_sh[kv] != INFINITY) atomic_min_f32(&lo[s * KV + kv], lo_sh[kv]);
      atomic_max_f32(&hi[s * KV + kv], hi_sh[kv]);
    }
  }
}

template <bool BOUNDS>
int launch(const void* q_codes, const void* q_scale, const void* q_sums, const void* words,
           const void* feat_scale, const void* feat_zero, const void* pages,
           const void* blk_valid, void* out, void* lo, void* hi, int S, int KV, int G,
           int R, int BS, int MB, int bf16, void* stream) {
  int threads = BS * KV;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : ((threads + 31) / 32) * 32);
  const dim3 grid(MB, S);
  const size_t smem = (BOUNDS ? 2 * KV * sizeof(float) : 0) + (size_t)KV * G * R;
  paged_score_kernel<BOUNDS><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q_codes, (const float*)q_scale, (const int32_t*)q_sums,
      (const uint32_t*)words, (const float*)feat_scale, (const float*)feat_zero,
      (const int32_t*)pages, (const uint8_t*)blk_valid, (float*)out, (float*)lo,
      (float*)hi, KV, G, R, BS, MB, bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_score_estimate(const void* q_codes, const void* q_scale,
                                    const void* q_sums, const void* words,
                                    const void* feat_scale, const void* feat_zero,
                                    const void* pages, void* out, int S, int KV, int G,
                                    int R, int BS, int MB, int bf16, void* stream) {
  return launch<false>(q_codes, q_scale, q_sums, words, feat_scale, feat_zero, pages,
                       nullptr, out, nullptr, nullptr, S, KV, G, R, BS, MB, bf16, stream);
}

extern "C" int paged_score_bounds(const void* q_codes, const void* q_scale,
                                  const void* q_sums, const void* words,
                                  const void* feat_scale, const void* feat_zero,
                                  const void* pages, const void* blk_valid, void* out,
                                  void* lo, void* hi, int S, int KV, int G, int R, int BS,
                                  int MB, int bf16, void* stream) {
  return launch<true>(q_codes, q_scale, q_sums, words, feat_scale, feat_zero, pages,
                      blk_valid, out, lo, hi, S, KV, G, R, BS, MB, bf16, stream);
}
