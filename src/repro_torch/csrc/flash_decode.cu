// Kernels B2, B6 and B8: exact sparse attention over int8 K/V with
// per-token scales, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_decode/kernel.py::
// sparse_flash_decode_paged_pallas (int8 branch: per-token scales). Row
// b = slot*KV + kv (kv = b % KV) holds G query heads; it walks its list of
// counts[b] physical blocks pblk[b, :]. Per block: s = (q . k_int8) *
// k_scale * 1/sqrt(HD), masked to -1e30 outside blk_mask, online softmax
// (running max m, sum l) and acc += p * (v_int8 * v_scale), all f32; the
// output is acc / max(l, 1e-20). Padded list entries (n >= counts[b]) are
// never read.
//
// B6 replaces sparse_flash_decode_paged_partials_pallas: the same kernel
// (template flag PARTIALS) stopped before the normalization, writing the
// online-softmax state (acc, m, l) that the block-sharded tick merges
// across ranks. A row with counts[b] == 0 (this rank owns none of its
// selected blocks) writes acc = 0, m = -1e30, l = 0, which vanish in the
// merge.
//
// B8 replaces sparse_flash_decode_pallas (the contiguous tick): the same
// kernel (template flag FLAT) over rows already gathered into (BH, C, HD)
// codes with (BH, C) scales and mask. The row's C tokens are walked as
// ceil(C / 32) runs of 32 consecutive tokens in place of a block list (the
// last run may be short); every row runs all its runs. The scale is a
// multiply by 1/sqrt(HD), as in the TPU kernel.
//
// Bound on this card: bytes — the int8 K and V rows of the selected blocks
// plus their scales, read once; the math is 4 flops per byte. Design: one
// CTA per row (the loop over the row's blocks replaces the TPU's sequential
// grid axis; nothing carries between CTAs), blockDim = HD threads. Warps
// score tokens (a lane per channel group, shuffle reduction), scores and
// probabilities go through shared memory, and thread d accumulates output
// channel d in registers, so V rows are read coalesced. Simple first
// version: a row's blocks are processed one after another, so few CTAs
// (slots*KV) are in flight; splitting rows across CTAs is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Paged (FLAT false): row b walks physical blocks pblk[b, :counts[b]] of
// the (P, BS, KV, HD) pool at kv head b % KV; bmask is (BH, NSB, BS).
// FLAT: row b walks its own C gathered tokens of the (BH, C, HD) arrays in
// runs of BS (KV = 1, NSB = ceil(C / BS)); bmask is the (BH, C) mask.
template <int G, bool PARTIALS, bool FLAT>
__global__ void sparse_flash_decode_paged_kernel(
    const float* __restrict__ q,          // (BH, G, HD)
    const int8_t* __restrict__ k_codes,   // (P, BS, KV, HD) | FLAT: (BH, C, HD)
    const float* __restrict__ k_scale,    // (P, BS, KV)     | FLAT: (BH, C)
    const int8_t* __restrict__ v_codes,   // (P, BS, KV, HD) | FLAT: (BH, C, HD)
    const float* __restrict__ v_scale,    // (P, BS, KV)     | FLAT: (BH, C)
    const int32_t* __restrict__ pblk,     // (BH, NSB)       [paged]
    const int32_t* __restrict__ counts,   // (BH,)           [paged]
    const uint8_t* __restrict__ bmask,    // (BH, NSB, BS)   | FLAT: (BH, C)
    float* __restrict__ out,              // (BH, G, HD): output, or acc if PARTIALS
    float* __restrict__ m_out,            // (BH, G)  [PARTIALS]
    float* __restrict__ l_out,            // (BH, G)  [PARTIALS]
    int HD, int BS, int KV, int NSB, int C, float scale) {
  extern __shared__ float sh[];
  float* q_sh = sh;               // (G, HD)
  float* p_sh = sh + G * HD;      // (G, BS): scores, then probabilities
  const int b = blockIdx.x;
  const int kv = FLAT ? 0 : b % KV;
  const size_t tstride = FLAT ? 1 : KV;    // rows between consecutive tokens of a run
  const int tid = threadIdx.x;    // output channel
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float NEG = -1e30f;

  for (int i = tid; i < G * HD; i += blockDim.x) q_sh[i] = q[(size_t)b * G * HD + i];
  float m[G], l[G], acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  __syncthreads();

  const int cnt = FLAT ? NSB : counts[b];
  for (int n = 0; n < cnt; ++n) {
    // the run's first row and its token count
    const size_t base = FLAT ? (size_t)b * C + (size_t)n * BS
                             : (size_t)pblk[(size_t)b * NSB + n] * BS * KV + kv;
    const int nt = FLAT ? min(BS, C - n * BS) : BS;
    const uint8_t* mk = bmask + (FLAT ? (size_t)b * C : (size_t)b * NSB * BS) + (size_t)n * BS;
    // scores of the run's tokens: one warp per token
    for (int t = warp; t < nt; t += nwarps) {
      const size_t row = base + t * tstride;
      const int8_t* kr = k_codes + row * HD;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      for (int d = lane; d < HD; d += 32) {
        const float kd = (float)kr[d];
        for (int g = 0; g < G; ++g) part[g] += q_sh[g * HD + d] * kd;
      }
      for (int g = 0; g < G; ++g) {
        float x = part[g];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        part[g] = x;
      }
      if (lane == 0) {
        const float ks = k_scale[row];
        for (int g = 0; g < G; ++g) p_sh[g * BS + t] = mk[t] ? part[g] * ks * scale : NEG;
      }
    }
    __syncthreads();
    float mnew[G], corr[G];
    for (int g = 0; g < G; ++g) {
      float mx = NEG;
      for (int t = 0; t < nt; ++t) mx = fmaxf(mx, p_sh[g * BS + t]);
      mnew[g] = fmaxf(m[g], mx);
      corr[g] = expf(m[g] - mnew[g]);
    }
    __syncthreads();
    for (int i = tid; i < G * BS; i += blockDim.x) {
      const int g = i / BS;
      const int t = i % BS;
      if (t < nt) p_sh[i] = mk[t] ? expf(p_sh[i] - mnew[g]) : 0.f;
    }
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      float ps = 0.f;
      for (int t = 0; t < nt; ++t) ps += p_sh[g * BS + t];
      l[g] = l[g] * corr[g] + ps;
      m[g] = mnew[g];
      acc[g] *= corr[g];
    }
    for (int t = 0; t < nt; ++t) {
      const size_t row = base + t * tstride;
      const float vv = (float)v_codes[row * HD + tid] * v_scale[row];
      for (int g = 0; g < G; ++g) acc[g] += p_sh[g * BS + t] * vv;
    }
    __syncthreads();   // p_sh is rewritten by the next block
  }
  for (int g = 0; g < G; ++g) {
    out[((size_t)b * G + g) * HD + tid] = PARTIALS ? acc[g] : acc[g] / fmaxf(l[g], 1e-20f);
  }
  if (PARTIALS && tid == 0) {   // every thread holds the same (m, l)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_out[(size_t)b * G + g] = m[g];
      l_out[(size_t)b * G + g] = l[g];
    }
  }
}

template <bool PARTIALS, bool FLAT>
int launch(const void* q, const void* k_codes, const void* k_scale, const void* v_codes,
           const void* v_scale, const void* pblk, const void* counts, const void* bmask,
           void* out, void* m_out, void* l_out, int BH, int G, int HD, int BS, int KV,
           int NSB, int C, float scale, void* stream) {
  if (HD % 32 != 0 || HD > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(G * HD + G * BS) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define B2_LAUNCH(GG)                                                              \
  sparse_flash_decode_paged_kernel<GG, PARTIALS, FLAT><<<BH, HD, smem, st>>>(      \
      (const float*)q, (const int8_t*)k_codes, (const float*)k_scale,              \
      (const int8_t*)v_codes, (const float*)v_scale, (const int32_t*)pblk,         \
      (const int32_t*)counts, (const uint8_t*)bmask, (float*)out, (float*)m_out,   \
      (float*)l_out, HD, BS, KV, NSB, C, scale)
  switch (G) {
    case 1: B2_LAUNCH(1); break;
    case 2: B2_LAUNCH(2); break;
    case 4: B2_LAUNCH(4); break;
    case 8: B2_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef B2_LAUNCH
  return (int)cudaGetLastError();
}

constexpr int FLAT_RUN = 32;                // tokens per run of a B8 row

}  // namespace

extern "C" int sparse_flash_decode_paged(const void* q, const void* k_codes,
                                         const void* k_scale, const void* v_codes,
                                         const void* v_scale, const void* pblk,
                                         const void* counts, const void* bmask, void* out,
                                         int BH, int G, int HD, int BS, int KV, int NSB,
                                         float scale, void* stream) {
  return launch<false, false>(q, k_codes, k_scale, v_codes, v_scale, pblk, counts, bmask,
                              out, nullptr, nullptr, BH, G, HD, BS, KV, NSB, NSB * BS,
                              scale, stream);
}

extern "C" int sparse_flash_decode_paged_partials(
    const void* q, const void* k_codes, const void* k_scale, const void* v_codes,
    const void* v_scale, const void* pblk, const void* counts, const void* bmask, void* acc,
    void* m, void* l, int BH, int G, int HD, int BS, int KV, int NSB, float scale,
    void* stream) {
  return launch<true, false>(q, k_codes, k_scale, v_codes, v_scale, pblk, counts, bmask, acc,
                             m, l, BH, G, HD, BS, KV, NSB, NSB * BS, scale, stream);
}

extern "C" int sparse_flash_decode(const void* q, const void* k_codes, const void* k_scale,
                                   const void* v_codes, const void* v_scale, const void* mask,
                                   void* out, int BH, int G, int HD, int C, float scale,
                                   void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const int bs = C < FLAT_RUN ? C : FLAT_RUN;
  return launch<false, true>(q, k_codes, k_scale, v_codes, v_scale, nullptr, nullptr, mask,
                             out, nullptr, nullptr, BH, G, HD, bs, 1, (C + bs - 1) / bs, C,
                             scale, stream);
}
