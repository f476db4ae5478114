// Kernels B2, B6 and B8: exact sparse attention over quantized K/V, for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_decode/kernel.py::
// sparse_flash_decode_paged_pallas, all three branches of its pool
// (`_paged_step`): int8 codes with per-token scales; f16 values and packed
// int4 codes (two signed nibbles per byte along HD, the even channel in the
// low nibble), each with ONE scale per (block, kv head). Row
// b = slot*KV + kv (kv = b % KV) holds G query heads; it walks its list of
// counts[b] physical blocks pblk[b, :]. Per block: s = (q . k_int8) *
// k_scale * 1/sqrt(HD), masked to -1e30 outside blk_mask, online softmax
// (running max m, sum l) and acc += p * (v_int8 * v_scale), all f32; the
// output is acc / max(l, 1e-20). Padded list entries (n >= counts[b]) are
// never read. The per-block branches (template CODE = half or nibble,
// PER_BLOCK) read the block's one scale word and multiply in the
// reference's order, s * (k_scale * 1/sqrt(HD)); int4 nibbles are unpacked
// in registers as they are loaded (sign-extended), so only the packed
// bytes cross HBM.
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
// Bound on this card: bytes — the K and V rows of the selected blocks (1 B,
// 2 B or 1/2 B per element) plus their scales, read once; the math is 4-16
// flops per byte. Design: one
// CTA per row (the loop over the row's blocks replaces the TPU's sequential
// grid axis; nothing carries between CTAs), blockDim = HD threads. Warps
// score tokens (a lane per channel group, shuffle reduction), scores and
// probabilities go through shared memory, and thread d accumulates output
// channel d in registers, so V rows are read coalesced. Simple first
// version: a row's blocks are processed one after another, so few CTAs
// (slots*KV) are in flight; splitting rows across CTAs is later work.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// K/V storage of the pool (template CODE)
constexpr int CODE_INT8 = 0;     // int8 codes, (·, HD)
constexpr int CODE_HALF = 1;     // f16 values, (·, HD)
constexpr int CODE_NIBBLE = 2;   // packed int4 codes, (·, HD/2) bytes

// Element d of the code row starting at element `row` * HD, as f32.
template <int CODE>
__device__ __forceinline__ float load_code(const void* __restrict__ codes, size_t row,
                                           int HD, int d) {
  if (CODE == CODE_HALF) return __half2float(((const __half*)codes)[row * HD + d]);
  if (CODE == CODE_NIBBLE) {
    const int b = ((const int8_t*)codes)[row * (HD >> 1) + (d >> 1)];
    const int hi = b >> 4;                        // arithmetic: sign-extended
    const int lo = b - hi * 16;                   // [0, 15]
    return (float)((d & 1) ? hi : lo - ((lo & 8) << 1));
  }
  return (float)((const int8_t*)codes)[row * HD + d];
}

// Paged (FLAT false): row b walks physical blocks pblk[b, :counts[b]] of
// the (P, BS, KV, HD) pool at kv head b % KV; bmask is (BH, NSB, BS).
// FLAT: row b walks its own C gathered tokens of the (BH, C, HD) arrays in
// runs of BS (KV = 1, NSB = ceil(C / BS)); bmask is the (BH, C) mask.
// PER_BLOCK (paged only): scales are (P, 1, KV), one word per (block, kv).
template <int G, bool PARTIALS, bool FLAT, int CODE, bool PER_BLOCK>
__global__ void sparse_flash_decode_paged_kernel(
    const float* __restrict__ q,          // (BH, G, HD)
    const void* __restrict__ k_codes,     // (P, BS, KV, HD | HD/2) | FLAT: (BH, C, HD)
    const float* __restrict__ k_scale,    // (P, BS | 1, KV)        | FLAT: (BH, C)
    const void* __restrict__ v_codes,     // (P, BS, KV, HD | HD/2) | FLAT: (BH, C, HD)
    const float* __restrict__ v_scale,    // (P, BS | 1, KV)        | FLAT: (BH, C)
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
    const size_t pb = FLAT ? 0 : (size_t)pblk[(size_t)b * NSB + n];
    const size_t base = FLAT ? (size_t)b * C + (size_t)n * BS : pb * BS * KV + kv;
    const int nt = FLAT ? min(BS, C - n * BS) : BS;
    const uint8_t* mk = bmask + (FLAT ? (size_t)b * C : (size_t)b * NSB * BS) + (size_t)n * BS;
    // per-block branches: the block's one scale word per kv head
    const float ks_blk = PER_BLOCK ? k_scale[pb * KV + kv] : 0.f;
    const float vs_blk = PER_BLOCK ? v_scale[pb * KV + kv] : 0.f;
    // scores of the run's tokens: one warp per token
    for (int t = warp; t < nt; t += nwarps) {
      const size_t row = base + t * tstride;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      for (int d = lane; d < HD; d += 32) {
        const float kd = load_code<CODE>(k_codes, row, HD, d);
        for (int g = 0; g < G; ++g) part[g] += q_sh[g * HD + d] * kd;
      }
      for (int g = 0; g < G; ++g) {
        float x = part[g];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        part[g] = x;
      }
      if (lane == 0) {
        for (int g = 0; g < G; ++g) {
          const float sc = PER_BLOCK ? part[g] * (ks_blk * scale)    // the reference's order
                                     : part[g] * k_scale[row] * scale;
          p_sh[g * BS + t] = mk[t] ? sc : NEG;
        }
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
      const float vv = load_code<CODE>(v_codes, row, HD, tid) * (PER_BLOCK ? vs_blk
                                                                           : v_scale[row]);
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

template <bool PARTIALS, bool FLAT, int CODE, bool PER_BLOCK>
int launch(const void* q, const void* k_codes, const void* k_scale, const void* v_codes,
           const void* v_scale, const void* pblk, const void* counts, const void* bmask,
           void* out, void* m_out, void* l_out, int BH, int G, int HD, int BS, int KV,
           int NSB, int C, float scale, void* stream) {
  if (HD % 32 != 0 || HD > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(G * HD + G * BS) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define B2_LAUNCH(GG)                                                              \
  sparse_flash_decode_paged_kernel<GG, PARTIALS, FLAT, CODE, PER_BLOCK>           \
      <<<BH, HD, smem, st>>>(                                                      \
      (const float*)q, k_codes, (const float*)k_scale,                             \
      v_codes, (const float*)v_scale, (const int32_t*)pblk,                        \
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

// The paged kernels' branch by the pool's storage code: int8 (per-token
// scales), half or nibble (per-block scales).
template <bool PARTIALS>
int launch_paged(int code, const void* q, const void* k_codes, const void* k_scale,
                 const void* v_codes, const void* v_scale, const void* pblk, const void* counts,
                 const void* bmask, void* out, void* m_out, void* l_out, int BH, int G, int HD,
                 int BS, int KV, int NSB, float scale, void* stream) {
#define B2_BRANCH(CC, PB)                                                          \
  launch<PARTIALS, false, CC, PB>(q, k_codes, k_scale, v_codes, v_scale, pblk, counts, \
                                  bmask, out, m_out, l_out, BH, G, HD, BS, KV, NSB,    \
                                  NSB * BS, scale, stream)
  switch (code) {
    case CODE_INT8: return B2_BRANCH(CODE_INT8, false);
    case CODE_HALF: return B2_BRANCH(CODE_HALF, true);
    case CODE_NIBBLE: return B2_BRANCH(CODE_NIBBLE, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B2_BRANCH
}

}  // namespace

// code: 0 int8 (per-token scales), 1 f16, 2 packed int4 (per-block scales)
extern "C" int sparse_flash_decode_paged(const void* q, const void* k_codes,
                                         const void* k_scale, const void* v_codes,
                                         const void* v_scale, const void* pblk,
                                         const void* counts, const void* bmask, void* out,
                                         int BH, int G, int HD, int BS, int KV, int NSB,
                                         float scale, int code, void* stream) {
  return launch_paged<false>(code, q, k_codes, k_scale, v_codes, v_scale, pblk, counts,
                             bmask, out, nullptr, nullptr, BH, G, HD, BS, KV, NSB, scale,
                             stream);
}

extern "C" int sparse_flash_decode_paged_partials(
    const void* q, const void* k_codes, const void* k_scale, const void* v_codes,
    const void* v_scale, const void* pblk, const void* counts, const void* bmask, void* acc,
    void* m, void* l, int BH, int G, int HD, int BS, int KV, int NSB, float scale, int code,
    void* stream) {
  return launch_paged<true>(code, q, k_codes, k_scale, v_codes, v_scale, pblk, counts, bmask,
                            acc, m, l, BH, G, HD, BS, KV, NSB, scale, stream);
}

extern "C" int sparse_flash_decode(const void* q, const void* k_codes, const void* k_scale,
                                   const void* v_codes, const void* v_scale, const void* mask,
                                   void* out, int BH, int G, int HD, int C, float scale,
                                   void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const int bs = C < FLAT_RUN ? C : FLAT_RUN;
  return launch<false, true, CODE_INT8, false>(q, k_codes, k_scale, v_codes, v_scale, nullptr, nullptr, mask,
                             out, nullptr, nullptr, BH, G, HD, bs, 1, (C + bs - 1) / bs, C,
                             scale, stream);
}
