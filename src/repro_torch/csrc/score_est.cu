// Kernels B1, B4 and B7: relevance scoring (Salca phase 1) for Hopper
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
// B7 replaces score_estimate_pallas: flat (B, KV, N) scores of a contiguous
// feature stream, read through separate batch / token / kv-head strides for
// words, scale and zero, so the contiguous tick passes views of the cache's
// (B, N, KV, .) fields and the reference's (BH, N, .) layout is the case
// KV = 1. Template flag BF16: off, it is score_estimate_pallas's unpinned f32
// chain s_q * (a * dot + z * sum(q)) (with __fmul_rn/__fadd_rn, so nvcc does
// not contract it into an FMA); on, it is the pinned chain of B1, i.e. the
// flat selection.estimate_relevance under bf16_collectives=True. The chain
// itself exists once (score_chain), for B1, B4 and B7.
//
// Bound on this card: bytes. Per (token, kv head) it reads 16 B of words
// plus 8 B of scale/zero (plus 1 B of validity per token for B4) and does
// 64 small integer MACs, far below the ~300 ops/byte where compute would
// bind. Design: one CTA per (slot, logical block) for B1/B4, per (batch
// row, run of tokens) for B7; threads walk token-major with the kv head
// fastest, so consecutive threads read consecutive 24 B records of the
// (., N, KV, .) layout; the (KV, G, r) query codes sit in shared memory.
// The integer dot is plain int32 FMAs (exact). No tensor cores: at r = 64
// the kernels are a memory stream.

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

// quantization.dequant_score_chain for one score: s_q * (a * d + z * qm),
// every intermediate rounded to bf16 when ``bf16`` (the reference pins the
// same points), plain IEEE f32 ops otherwise.
__device__ __forceinline__ float score_chain(float sq, float a, float d, float z, float qm,
                                             bool bf16) {
  if (bf16) {
    return rp(__fmul_rn(rp(sq), rp(__fadd_rn(rp(__fmul_rn(rp(a), rp(d))),
                                             rp(__fmul_rn(rp(z), rp(qm)))))));
  }
  return __fmul_rn(sq, __fadd_rn(__fmul_rn(a, d), __fmul_rn(z, qm)));
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
      const float sc = score_chain(q_scale[qi], a, (float)dot, z, (float)q_sums[qi], bf16);
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

// B7: row r = b * KV + kv of the (B * KV, N) output. CTA (x, b) scores
// tokens [x * TN, x * TN + TN) of batch row b for every kv head.
template <bool BF16>
__global__ void flat_score_kernel(
    const int8_t* __restrict__ q_codes,     // (B * KV, G, R)
    const float* __restrict__ q_scale,      // (B * KV, G)
    const uint32_t* __restrict__ words,     // [b * w_sb + n * w_sn + kv * w_skv + i]
    const float* __restrict__ feat_scale,   // [b * a_sb + n * a_sn + kv * a_skv]
    const float* __restrict__ feat_zero,    // [b * z_sb + n * z_sn + kv * z_skv]
    float* __restrict__ out,                // (B * KV, N)
    int KV, int G, int R, int N, int TN,
    long long w_sb, long long w_sn, long long w_skv,
    long long a_sb, long long a_sn, long long a_skv,
    long long z_sb, long long z_sn, long long z_skv) {
  extern __shared__ int32_t qsum_sh[];      // (KV, G) code sums, then the codes
  int8_t* q_sh = (int8_t*)(qsum_sh + KV * G);   // (KV, G, R) of batch row b
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int W = R / 16;
  const int nq = KV * G * R;
  for (int i = threadIdx.x; i < nq; i += blockDim.x) q_sh[i] = q_codes[(size_t)b * nq + i];
  __syncthreads();
  for (int i = threadIdx.x; i < KV * G; i += blockDim.x) {
    int sum = 0;
    for (int c = 0; c < R; ++c) sum += q_sh[i * R + c];
    qsum_sh[i] = sum;
  }
  __syncthreads();
  const int nn = min(TN, N - n0);
  for (int idx = threadIdx.x; idx < nn * KV; idx += blockDim.x) {
    const int n = n0 + idx / KV;
    const int kv = idx % KV;
    const uint32_t* w = words + b * w_sb + n * w_sn + kv * w_skv;
    const float a = feat_scale[b * a_sb + n * a_sn + kv * a_skv];
    const float z = feat_zero[b * z_sb + n * z_sn + kv * z_skv];
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
      const size_t qi = ((size_t)b * KV + kv) * G + g;
      const float sc = score_chain(q_scale[qi], a, (float)dot, z, (float)qsum_sh[kv * G + g],
                                   BF16);
      acc = (g == 0) ? sc : __fadd_rn(acc, sc);
    }
    out[((size_t)b * KV + kv) * N + n] = acc;
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

// B7. Strides are in elements of each tensor; the output is (B * KV, N).
extern "C" int flat_score_estimate(const void* q_codes, const void* q_scale, const void* words,
                                   const void* feat_scale, const void* feat_zero, void* out,
                                   int B, int KV, int G, int R, int N, long long w_sb,
                                   long long w_sn, long long w_skv, long long a_sb,
                                   long long a_sn, long long a_skv, long long z_sb,
                                   long long z_sn, long long z_skv, int bf16, void* stream) {
  if (R % 16 != 0 || KV < 1 || KV > 1024) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int tn = (1024 + KV - 1) / KV;      // tokens per CTA: ~1024 (token, kv) records
  const dim3 grid((N + tn - 1) / tn, B);
  const size_t smem = (size_t)KV * G * sizeof(int32_t) + (size_t)KV * G * R;
  cudaStream_t st = (cudaStream_t)stream;
#define B7_LAUNCH(FLAG)                                                                  \
  flat_score_kernel<FLAG><<<grid, threads, smem, st>>>(                                  \
      (const int8_t*)q_codes, (const float*)q_scale, (const uint32_t*)words,             \
      (const float*)feat_scale, (const float*)feat_zero, (float*)out, KV, G, R, N, tn,   \
      w_sb, w_sn, w_skv, a_sb, a_sn, a_skv, z_sb, z_sn, z_skv)
  if (bf16) {
    B7_LAUNCH(true);
  } else {
    B7_LAUNCH(false);
  }
#undef B7_LAUNCH
  return (int)cudaGetLastError();
}
