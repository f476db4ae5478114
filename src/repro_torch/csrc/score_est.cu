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
// when none) and hi = max over the masked scores. The TPU kernel carries
// (lo, hi) in scratch along its sequential block axis; here the blocks of a
// row run in parallel CTAs, so each CTA reduces its part (warp shuffles,
// then shared atomics, on order-preserving integer keys of the floats) and
// folds it into the (S, KV) outputs with integer atomics on the float bits
// (min/max are exact, so the order does not matter and the bounds equal the
// plain reduction bit for bit, -0.0 below +0.0). The wrapper fills lo with
// +inf and hi with -inf before the launch. B4 reads the features of valid
// tokens only: a block with nothing valid costs its BS validity bytes.
//
// B7 replaces score_estimate_pallas: flat (B, KV, N) scores of a contiguous
// feature stream, read through separate batch / token / kv-head strides for
// words, scale and zero, so the contiguous tick passes views of the cache's
// (B, N, KV, .) fields and the reference's (BH, N, .) layout is the case
// KV = 1. Template flag BF16: off, it is score_estimate_pallas's unpinned f32
// chain s_q * (a * dot + z * sum(q)) (with __fmul_rn/__fadd_rn, so nvcc does
// not contract it into an FMA); on, it is the pinned chain of B1, i.e. the
// flat selection.estimate_relevance under bf16_collectives=True. The chain
// itself exists once (score_chain), for B1, B4 and B7; the bf16 flag is a
// template parameter of all three.
//
// Bound on this card: bytes. Per (token, kv head) it reads 16 B of words
// plus 8 B of scale/zero (plus 1 B of validity per token for B4) and does
// 64 small integer MACs, far below the ~300 ops/byte where compute would
// bind; at the main path's shapes (262,144 records, 3.3 MB) the bound is
// ~1 us, so the kernels are latency- and instruction-bound.
//
// B1/B4 design (one template, two kernels so that a trace names each): the
// integer dot runs on __dp4a. (word >> 2j) & 0x03030303 holds codes j, j+4,
// j+8 and j+12 of a word as bytes; the query's matching four codes are packed
// into one int32 once (pack_query), so one word costs 4 dp4a per query row
// and is unpacked once for all G rows of its group. CTA (x, s) takes NB
// logical blocks of slot s (NB·BS ≈ 4 tokens per thread per kv head); a task
// is (kv head, group of 4 consecutive tokens): its 4 records' loads are
// issued together (one 16 B load of words at r = 64, and the scale and zero),
// the 4 scores go out as one float4. Threads are a multiple of KV and keep
// one kv head, with kv fastest across lanes, so a warp reads whole 128 B
// rows of the (P, BS, KV, .) layout. At the main path's shape (G 1, r 64:
// qwen3-0.6b with the group-summed query; aligned operands) the packed query
// sits in registers, where it takes about 0.8 of the wide layout's time
// (PERF.md, PR 17); every other shape keeps it in shared memory as int4 rows
// padded to an odd count, so the rows that a quarter-warp reads fall in
// distinct banks. B7's stream is flat: one CTA per (batch row, run of
// tokens), threads token-major with the kv head fastest, the (KV, G, r)
// query codes in shared memory, the dot as plain int32 MACs. No tensor
// cores: a 16-row MMA over G = 2 query rows would be 1/8 used.

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

// Order-preserving int key of a float: the key order is the float order,
// with -0.0 below +0.0, as atomic_min_f32 / atomic_max_f32 order them.
__device__ __forceinline__ int f2key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key2f(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }

constexpr int KEY_POS_INF = 0x7f800000;           // f2key(+inf)
constexpr int KEY_NEG_INF = (int)0x807fffff;      // f2key(-inf)
constexpr uint32_t CODE_MASK = 0x03030303u;

// Four int32 of 16 query codes (bytes c0..c15) → the dp4a operands: int j
// holds codes j, j+4, j+8, j+12, the codes that (word >> 2j) & CODE_MASK
// brings to bytes 0..3 of a packed key word.
__device__ __forceinline__ int4 pack_query(int4 x) {
  const uint32_t t0 = __byte_perm(x.x, x.y, 0x5140), t1 = __byte_perm(x.z, x.w, 0x5140);
  const uint32_t t2 = __byte_perm(x.x, x.y, 0x7362), t3 = __byte_perm(x.z, x.w, 0x7362);
  return make_int4((int)__byte_perm(t0, t1, 0x5410), (int)__byte_perm(t0, t1, 0x7632),
                   (int)__byte_perm(t2, t3, 0x5410), (int)__byte_perm(t2, t3, 0x7632));
}

// <q, codes> over one key word of 16 two-bit codes: four dp4a on the word's
// byte planes, exact in int32 (any order of the sums gives the same value).
__device__ __forceinline__ int dot_word(uint32_t w, int4 q, int acc) {
  acc = __dp4a((int)(w & CODE_MASK), q.x, acc);
  acc = __dp4a((int)((w >> 2) & CODE_MASK), q.y, acc);
  acc = __dp4a((int)((w >> 4) & CODE_MASK), q.z, acc);
  return __dp4a((int)((w >> 6) & CODE_MASK), q.w, acc);
}

template <int W>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p, uint32_t (&w)[W]) {
  static_assert(W % 4 == 0, "16 B loads");
#pragma unroll
  for (int i = 0; i < W; i += 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + i));
    w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
  }
}

// B1 (BOUNDS false) and B4 (BOUNDS true). CTA (x, s) scores logical blocks
// [x*NB, x*NB + NB) of slot s: groups of 4 consecutive tokens, each group
// × kv head one task of 4 records. GT > 0: the register layout (kv fixed per
// thread, G = GT and W = WT words per record, the packed query in GT*WT int4
// registers, 16 B word loads; instantiated at GT 1, WT 4). GT = 0: the wide
// layout (runtime G and W; the packed query of every kv head in shared
// memory, rows of (G*W)|1 int4 so that the rows of a quarter-warp fall in
// distinct banks).
template <bool BOUNDS, bool BF16, int GT, int WT>
__device__ __forceinline__ void paged_score_body(
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
    int KV, int G_, int R, int BS, int MB, int NB, int vec_out) {
  constexpr bool REGS = GT > 0;
  extern __shared__ int4 smem[];
  const int G = REGS ? GT : G_;
  const int W = REGS ? WT : R / 16;
  const int QS = (G * W) | 1;
  int4* q_sh = smem;                                       // (KV, QS)    [wide]
  int* lo_sh = reinterpret_cast<int*>(smem + (REGS ? 0 : KV * QS));   // (KV) keys [BOUNDS]
  int* hi_sh = lo_sh + KV;                                 // (KV) keys   [BOUNDS]
  const int s = blockIdx.y;
  const int j0 = blockIdx.x * NB;
  const int ntok = min(NB, MB - j0) * BS;
  const int ngrp = (ntok + 3) >> 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t N = (size_t)MB * BS;
  const int32_t* pg = pages + (size_t)s * MB + j0;
  const uint8_t* vrow = BOUNDS ? blk_valid + (size_t)s * N + (size_t)j0 * BS : nullptr;

  if (BOUNDS) {
    for (int i = tid; i < KV; i += nt) {
      lo_sh[i] = KEY_POS_INF;
      hi_sh[i] = KEY_NEG_INF;
    }
  }
  if (!REGS) {                  // stage every kv head's packed query codes
    const int8_t* qs = q_codes + (size_t)s * KV * G * R;
    for (int i = tid; i < KV * G * W; i += nt) {
      const int8_t* src = qs + (size_t)i * 16;             // (kv, g, word i % W)
      int c[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[k] = (int)(uint8_t)src[4 * k] | ((int)(uint8_t)src[4 * k + 1] << 8)
               | ((int)(uint8_t)src[4 * k + 2] << 16) | ((int)(uint8_t)src[4 * k + 3] << 24);
      }
      q_sh[(i / (G * W)) * QS + i % (G * W)] = pack_query(make_int4(c[0], c[1], c[2], c[3]));
    }
  }
  if (BOUNDS || !REGS) __syncthreads();

  const bool fixed_kv = nt % KV == 0;       // always for the register layout
  int lo_k = KEY_POS_INF, hi_k = KEY_NEG_INF;
  const int kv0 = tid % KV;

  // register layout: this thread's kv head's query, packed once
  int4 qp[REGS ? GT * WT : 1];
  float sq[REGS ? GT : 1], qm[REGS ? GT : 1];
  if constexpr (REGS) {
    const int8_t* qrow = q_codes + ((size_t)s * KV + kv0) * GT * WT * 16;
#pragma unroll
    for (int e = 0; e < GT * WT; ++e)
      qp[e] = pack_query(__ldg(reinterpret_cast<const int4*>(qrow) + e));
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      sq[g] = __ldg(q_scale + ((size_t)s * KV + kv0) * GT + g);
      qm[g] = (float)__ldg(q_sums + ((size_t)s * KV + kv0) * GT + g);
    }
  }

  const int ntask = REGS ? ngrp : KV * ngrp;
  const int step = REGS ? nt / KV : nt;
  for (int task = REGS ? tid / KV : tid; task < ntask; task += step) {
    const int kv = REGS ? kv0 : task % KV;
    const int grp = REGS ? task : task / KV;
    const int T0 = grp * 4;
    const int b0 = T0 / BS;
    const int t0 = T0 - b0 * BS;
    bool use[4];
    size_t row[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int t = t0 + k, b = b0;
      while (t >= BS) { t -= BS; ++b; }
      const bool in = T0 + k < ntok;     // the page and validity loads go out together
      row[k] = in ? ((size_t)__ldg(pg + b) * BS + t) * KV + kv : 0;
      use[k] = in && (!BOUNDS || __ldg(vrow + T0 + k) != 0);
    }
    float sc[4];
    if constexpr (REGS) {
      uint32_t w[4][WT];
      float a[4], z[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (use[k]) {
          load_words<WT>(words + row[k] * WT, w[k]);
          a[k] = __ldg(feat_scale + row[k]);
          z[k] = __ldg(feat_zero + row[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sc[k] = BOUNDS ? SCORE_NEG_INF : 0.f;
        if (use[k]) {
          int dot[GT];
#pragma unroll
          for (int g = 0; g < GT; ++g) dot[g] = 0;
#pragma unroll
          for (int wi = 0; wi < WT; ++wi) {
#pragma unroll
            for (int g = 0; g < GT; ++g) dot[g] = dot_word(w[k][wi], qp[g * WT + wi], dot[g]);
          }
          float acc = 0.f;
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float v = score_chain(sq[g], a[k], (float)dot[g], z[k], qm[g], BF16);
            acc = (g == 0) ? v : __fadd_rn(acc, v);
          }
          sc[k] = acc;
        }
      }
    } else {
      const int4* qrow = q_sh + kv * QS;
      const size_t qi = ((size_t)s * KV + kv) * G;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sc[k] = BOUNDS ? SCORE_NEG_INF : 0.f;
        if (use[k]) {
          const uint32_t* wp = words + row[k] * W;
          const float a = __ldg(feat_scale + row[k]);
          const float z = __ldg(feat_zero + row[k]);
          float acc = 0.f;
          for (int g = 0; g < G; ++g) {
            int dot = 0;
            for (int wi = 0; wi < W; ++wi) dot = dot_word(__ldg(wp + wi), qrow[g * W + wi], dot);
            const float v = score_chain(__ldg(q_scale + qi + g), a, (float)dot, z,
                                        (float)__ldg(q_sums + qi + g), BF16);
            acc = (g == 0) ? v : __fadd_rn(acc, v);
          }
          sc[k] = acc;
        }
      }
    }
    float* orow = out + ((size_t)s * KV + kv) * N + (size_t)j0 * BS + T0;
    if (vec_out && T0 + 4 <= ntok) {
      *reinterpret_cast<float4*>(orow) = make_float4(sc[0], sc[1], sc[2], sc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (T0 + k < ntok) orow[k] = sc[k];
    }
    if (BOUNDS) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (T0 + k < ntok) {
          const int key = f2key(sc[k]);
          if (use[k]) lo_k = min(lo_k, key);
          hi_k = max(hi_k, key);
        }
      }
      if (!fixed_kv) {          // kv changes from task to task: fold now
        atomicMin(&lo_sh[kv], lo_k);
        atomicMax(&hi_sh[kv], hi_k);
        lo_k = KEY_POS_INF;
        hi_k = KEY_NEG_INF;
      }
    }
  }

  if (BOUNDS) {
    if (fixed_kv) {
      if (32 % KV == 0) {       // full warps; lane % KV is the kv head
        for (int off = 16; off >= KV; off >>= 1) {
          lo_k = min(lo_k, __shfl_xor_sync(0xffffffffu, lo_k, off));
          hi_k = max(hi_k, __shfl_xor_sync(0xffffffffu, hi_k, off));
        }
        if ((tid & 31) < KV) {
          atomicMin(&lo_sh[kv0], lo_k);
          atomicMax(&hi_sh[kv0], hi_k);
        }
      } else {
        atomicMin(&lo_sh[kv0], lo_k);
        atomicMax(&hi_sh[kv0], hi_k);
      }
    }
    __syncthreads();
    for (int kv = tid; kv < KV; kv += nt) {
      if (lo_sh[kv] != KEY_POS_INF) atomic_min_f32(&lo[s * KV + kv], key2f(lo_sh[kv]));
      atomic_max_f32(&hi[s * KV + kv], key2f(hi_sh[kv]));
    }
  }
}

// Two kernels, one per replaced TPU kernel, so that a trace names each.
#define SCORE_ARGS                                                                       \
  const int8_t *__restrict__ q_codes, const float *__restrict__ q_scale,                 \
      const int32_t *__restrict__ q_sums, const uint32_t *__restrict__ words,            \
      const float *__restrict__ feat_scale, const float *__restrict__ feat_zero,         \
      const int32_t *__restrict__ pages, const uint8_t *__restrict__ blk_valid,          \
      float *__restrict__ out, float *__restrict__ lo, float *__restrict__ hi, int KV,   \
      int G, int R, int BS, int MB, int NB, int vec_out
#define SCORE_PASS                                                                       \
  q_codes, q_scale, q_sums, words, feat_scale, feat_zero, pages, blk_valid, out, lo, hi, \
      KV, G, R, BS, MB, NB, vec_out

template <bool BF16, int GT, int WT>
__global__ void __launch_bounds__(GT > 0 ? 256 : 1024) paged_score_estimate_kernel(SCORE_ARGS) {
  paged_score_body<false, BF16, GT, WT>(SCORE_PASS);
}

template <bool BF16, int GT, int WT>
__global__ void __launch_bounds__(GT > 0 ? 256 : 1024) paged_score_bounds_kernel(SCORE_ARGS) {
  paged_score_body<true, BF16, GT, WT>(SCORE_PASS);
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

constexpr int SCORE_CTA = 256;      // threads per CTA of B1/B4 (at most 256 below KV 256)

template <bool BOUNDS, bool BF16>
int launch_paged(const void* q_codes, const void* q_scale, const void* q_sums, const void* words,
                 const void* feat_scale, const void* feat_zero, const void* pages,
                 const void* blk_valid, void* out, void* lo, void* hi, int S, int KV, int G,
                 int R, int BS, int MB, cudaStream_t st) {
  const int W = R / 16;
  // threads: a multiple of KV (each thread keeps one kv head), ~SCORE_CTA
  const int nt = KV <= 1024 ? KV * (KV < SCORE_CTA ? SCORE_CTA / KV : 1) : SCORE_CTA;
  // blocks per CTA: about one group of 4 tokens per thread
  const int tokens = 4 * (nt / KV > 1 ? nt / KV : 1);
  const int nb = tokens / BS > 1 ? tokens / BS : 1;
  const dim3 grid((MB + nb - 1) / nb, S);
  const auto aligned = [](const void* p, int bytes) { return (uintptr_t)p % bytes == 0; };
  const bool regs = G == 1 && W == 4 && KV <= 256 && aligned(q_codes, 16) && aligned(words, 16);
  const int vec_out = BS % 4 == 0 && aligned(out, 16);
#define SCORE_LAUNCH(GG, WW, SMEM)                                                         \
  do {                                                                                     \
    if constexpr (BOUNDS)                                                                \
      paged_score_bounds_kernel<BF16, GG, WW><<<grid, nt, SMEM, st>>>(                    \
          (const int8_t*)q_codes, (const float*)q_scale, (const int32_t*)q_sums,           \
          (const uint32_t*)words, (const float*)feat_scale, (const float*)feat_zero,       \
          (const int32_t*)pages, (const uint8_t*)blk_valid, (float*)out, (float*)lo,       \
          (float*)hi, KV, G, R, BS, MB, nb, vec_out);                                      \
    else                                                                                   \
      paged_score_estimate_kernel<BF16, GG, WW><<<grid, nt, SMEM, st>>>(                  \
          (const int8_t*)q_codes, (const float*)q_scale, (const int32_t*)q_sums,           \
          (const uint32_t*)words, (const float*)feat_scale, (const float*)feat_zero,       \
          (const int32_t*)pages, nullptr, (float*)out, nullptr, nullptr, KV, G, R, BS, MB, \
          nb, vec_out);                                                                    \
    return (int)cudaGetLastError();                                                        \
  } while (0)
  const size_t bounds_smem = BOUNDS ? 2 * KV * sizeof(int) : 0;
  // the main path's shape: the register layout
  if (regs) SCORE_LAUNCH(1, 4, bounds_smem);
  // every other shape: the wide layout, the packed query in shared memory
  SCORE_LAUNCH(0, 0, (size_t)KV * ((G * W) | 1) * sizeof(int4) + bounds_smem);
#undef SCORE_LAUNCH
}

template <bool BOUNDS>
int launch(const void* q_codes, const void* q_scale, const void* q_sums, const void* words,
           const void* feat_scale, const void* feat_zero, const void* pages,
           const void* blk_valid, void* out, void* lo, void* hi, int S, int KV, int G,
           int R, int BS, int MB, int bf16, void* stream) {
  return bf16 ? launch_paged<BOUNDS, true>(q_codes, q_scale, q_sums, words, feat_scale,
                                           feat_zero, pages, blk_valid, out, lo, hi, S, KV, G,
                                           R, BS, MB, (cudaStream_t)stream)
              : launch_paged<BOUNDS, false>(q_codes, q_scale, q_sums, words, feat_scale,
                                            feat_zero, pages, blk_valid, out, lo, hi, S, KV, G,
                                            R, BS, MB, (cudaStream_t)stream);
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
