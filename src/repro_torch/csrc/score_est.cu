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
// template parameter of all three. B7 scores every position of the stream:
// it has no lengths operand, as the reference kernel has none.
//
// Bound on this card: bytes. Per (token, kv head) it reads 16 B of words
// plus 8 B of scale/zero (plus 1 B of validity per token for B4) and does
// 64 small integer MACs, far below the ~300 ops/byte where compute would
// bind; at the main paths' shapes (B1/B4: 262,144 records, 3.3 MB; B7:
// 7.3 MB) the bound is 1-2 us, so the kernels are latency- and
// instruction-bound.
//
// Design (one template, three kernels so that a trace names each): the
// integer dot runs on __dp4a. (word >> 2j) & 0x03030303 holds codes j, j+4,
// j+8 and j+12 of a word as bytes; the query's matching four codes are packed
// into one int32 once (pack_query), so one word costs 4 dp4a per query row
// and is unpacked once for all G rows of its group. A task is (kv head,
// group of 4 consecutive tokens): its 4 records' loads are issued together
// (one 16 B load of words at r = 64, and the scale and zero), the 4 scores
// go out as one float4. Threads are a multiple of KV and keep one kv head,
// with kv fastest across lanes, so a warp reads whole 128 B rows of the
// (., KV, .) layouts. B1/B4: CTA (x, s) takes NB logical blocks of slot s
// (NB·BS ≈ 4 tokens per thread per kv head), the token's record found
// through the page table. B7: CTA (x, b) takes the same count of tokens of
// batch row b, the record found through the batch / token / kv-head
// strides, and the query's code sums computed in the kernel (a dot with a
// word of all-one codes). At the main paths' shape (G 1, r 64: qwen3-0.6b
// with the group-summed query; aligned operands) the packed query sits in
// registers, where it takes about 0.8 of the wide layout's time (PERF.md);
// every other shape keeps it in shared memory as int4 rows padded to an odd
// count, so the rows that a quarter-warp reads fall in distinct banks. No
// tensor cores: a 16-row MMA over G = 2 query rows would be 1/8 used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// The code sum of a packed query row of W words: its dot with a key word
// whose 16 codes are all 1 (exact, like every dp4a sum).
__device__ __forceinline__ int code_sum(const int4* q, int W) {
  int acc = 0;
  for (int wi = 0; wi < W; ++wi) acc = dot_word(0x55555555u, q[wi], acc);
  return acc;
}

enum Kind { PAGED, BOUNDS, FLAT };

// B7's record addresses, in elements of each tensor
struct FlatStrides {
  long long w_sb, w_sn, w_skv, a_sb, a_sn, a_skv, z_sb, z_sn, z_skv;
};

// B1 (PAGED), B4 (BOUNDS) and B7 (FLAT). CTA (x, s) scores the tokens
// [x*NB*BS, x*NB*BS + NB*BS) of row s: logical blocks of slot s for B1/B4,
// batch row s of the stream for B7 (which runs at BS 1, MB = N). Groups of 4
// consecutive tokens, each group × kv head one task of 4 records. GT > 0:
// the register layout (kv fixed per thread, G = GT and W = WT words per
// record, the packed query in GT*WT int4 registers, 16 B word loads;
// instantiated at GT 1, WT 4). GT = 0: the wide layout (runtime G and W; the
// packed query of every kv head in shared memory, rows of (G*W)|1 int4 so
// that the rows of a quarter-warp fall in distinct banks).
template <Kind K, bool BF16, int GT, int WT>
__device__ __forceinline__ void score_body(
    const int8_t* __restrict__ q_codes,     // (S, KV, G, R)
    const float* __restrict__ q_scale,      // (S, KV, G)
    const int32_t* __restrict__ q_sums,     // (S, KV, G)          [PAGED, BOUNDS]
    const uint32_t* __restrict__ words,     // (P, BS, KV, R/16)   [FLAT: strides fs]
    const float* __restrict__ feat_scale,   // (P, BS, KV)
    const float* __restrict__ feat_zero,    // (P, BS, KV)
    const int32_t* __restrict__ pages,      // (S, MB), clamped >= 0  [PAGED, BOUNDS]
    const uint8_t* __restrict__ blk_valid,  // (S, MB, BS)         [BOUNDS]
    float* __restrict__ out,                // (S, KV, MB*BS)
    float* __restrict__ lo,                 // (S, KV)             [BOUNDS]
    float* __restrict__ hi,                 // (S, KV)             [BOUNDS]
    int KV, int G_, int R, int BS, int MB, int NB, int vec_out, FlatStrides fs) {
  constexpr bool REGS = GT > 0;
  constexpr bool FLAT_ = K == FLAT;
  constexpr bool BOUNDS_ = K == BOUNDS;
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
  const int32_t* pg = FLAT_ ? nullptr : pages + (size_t)s * MB + j0;
  const uint8_t* vrow = BOUNDS_ ? blk_valid + (size_t)s * N + (size_t)j0 * BS : nullptr;

  if (BOUNDS_) {
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
  if (BOUNDS_ || !REGS) __syncthreads();

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
      qm[g] = FLAT_ ? (float)code_sum(qp + g * WT, WT)
                    : (float)__ldg(q_sums + ((size_t)s * KV + kv0) * GT + g);
    }
  }

  const int ntask = REGS ? ngrp : KV * ngrp;
  const int step = REGS ? nt / KV : nt;
  for (int task = REGS ? tid / KV : tid; task < ntask; task += step) {
    const int kv = REGS ? kv0 : task % KV;
    const int grp = REGS ? task : task / KV;
    const int T0 = grp * 4;
    bool use[4];
    size_t wo[4], ao[4], zo[4];   // the records' words, scale and zero offsets
    if constexpr (FLAT_) {
      const long long n = (long long)j0 + T0;
      const long long wb = s * fs.w_sb + n * fs.w_sn + kv * fs.w_skv;
      const long long ab = s * fs.a_sb + n * fs.a_sn + kv * fs.a_skv;
      const long long zb = s * fs.z_sb + n * fs.z_sn + kv * fs.z_skv;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        use[k] = T0 + k < ntok;
        wo[k] = use[k] ? (size_t)(wb + k * fs.w_sn) : 0;
        ao[k] = use[k] ? (size_t)(ab + k * fs.a_sn) : 0;
        zo[k] = use[k] ? (size_t)(zb + k * fs.z_sn) : 0;
      }
    } else {
      const int b0 = T0 / BS;
      const int t0 = T0 - b0 * BS;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int t = t0 + k, b = b0;
        while (t >= BS) { t -= BS; ++b; }
        const bool in = T0 + k < ntok;   // the page and validity loads go out together
        const size_t row = in ? ((size_t)__ldg(pg + b) * BS + t) * KV + kv : 0;
        use[k] = in && (!BOUNDS_ || __ldg(vrow + T0 + k) != 0);
        wo[k] = row * W;
        ao[k] = zo[k] = row;
      }
    }
    float sc[4];
    if constexpr (REGS) {
      uint32_t w[4][WT];
      float a[4], z[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (use[k]) {
          load_words<WT>(words + wo[k], w[k]);
          a[k] = __ldg(feat_scale + ao[k]);
          z[k] = __ldg(feat_zero + zo[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sc[k] = BOUNDS_ ? SCORE_NEG_INF : 0.f;
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
        sc[k] = BOUNDS_ ? SCORE_NEG_INF : 0.f;
        if (use[k]) {
          const uint32_t* wp = words + wo[k];
          const float a = __ldg(feat_scale + ao[k]);
          const float z = __ldg(feat_zero + zo[k]);
          float acc = 0.f;
          for (int g = 0; g < G; ++g) {
            int dot = 0;
            for (int wi = 0; wi < W; ++wi) dot = dot_word(__ldg(wp + wi), qrow[g * W + wi], dot);
            const int qm_g = FLAT_ ? code_sum(qrow + g * W, W) : __ldg(q_sums + qi + g);
            const float v = score_chain(__ldg(q_scale + qi + g), a, (float)dot, z, (float)qm_g,
                                        BF16);
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
    if (BOUNDS_) {
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

  if (BOUNDS_) {
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

// Three kernels, one per replaced TPU kernel, so that a trace names each.
#define SCORE_ARGS                                                                       \
  const int8_t *__restrict__ q_codes, const float *__restrict__ q_scale,                 \
      const int32_t *__restrict__ q_sums, const uint32_t *__restrict__ words,            \
      const float *__restrict__ feat_scale, const float *__restrict__ feat_zero,         \
      const int32_t *__restrict__ pages, const uint8_t *__restrict__ blk_valid,          \
      float *__restrict__ out, float *__restrict__ lo, float *__restrict__ hi, int KV,   \
      int G, int R, int BS, int MB, int NB, int vec_out, FlatStrides fs
#define SCORE_PASS                                                                       \
  q_codes, q_scale, q_sums, words, feat_scale, feat_zero, pages, blk_valid, out, lo, hi, \
      KV, G, R, BS, MB, NB, vec_out, fs

template <bool BF16, int GT, int WT>
__global__ void __launch_bounds__(GT > 0 ? 256 : 1024) paged_score_estimate_kernel(SCORE_ARGS) {
  score_body<PAGED, BF16, GT, WT>(SCORE_PASS);
}

template <bool BF16, int GT, int WT>
__global__ void __launch_bounds__(GT > 0 ? 256 : 1024) paged_score_bounds_kernel(SCORE_ARGS) {
  score_body<BOUNDS, BF16, GT, WT>(SCORE_PASS);
}

template <bool BF16, int GT, int WT>
__global__ void __launch_bounds__(GT > 0 ? 256 : 1024) flat_score_kernel(SCORE_ARGS) {
  score_body<FLAT, BF16, GT, WT>(SCORE_PASS);
}

constexpr int SCORE_CTA = 256;      // threads per CTA (at most 256 below KV 256)

// Launch kernel K over S rows of MB blocks of BS tokens (B7: S batch rows
// of MB = N tokens, BS 1). ``regs``: the caller's operands allow the
// register layout at G 1, W 4 (aligned query codes and words).
template <Kind K, bool BF16>
int launch_score(const void* q_codes, const void* q_scale, const void* q_sums, const void* words,
                 const void* feat_scale, const void* feat_zero, const void* pages,
                 const void* blk_valid, void* out, void* lo, void* hi, int S, int KV, int G,
                 int R, int BS, int MB, bool regs, FlatStrides fs, cudaStream_t st) {
  const int W = R / 16;
  // threads: a multiple of KV (each thread keeps one kv head), ~SCORE_CTA
  const int nt = KV <= 1024 ? KV * (KV < SCORE_CTA ? SCORE_CTA / KV : 1) : SCORE_CTA;
  // blocks per CTA: about one group of 4 tokens per thread
  const int tokens = 4 * (nt / KV > 1 ? nt / KV : 1);
  const int nb = tokens / BS > 1 ? tokens / BS : 1;
  const dim3 grid((MB + nb - 1) / nb, S);
  const auto aligned = [](const void* p, int bytes) { return (uintptr_t)p % bytes == 0; };
  regs = regs && G == 1 && W == 4 && KV <= 256 && aligned(q_codes, 16) && aligned(words, 16);
  const int vec_out = (K == FLAT ? MB : BS) % 4 == 0 && aligned(out, 16);
  const auto run = [&](auto fn, size_t smem) {
    fn<<<grid, nt, smem, st>>>(
        (const int8_t*)q_codes, (const float*)q_scale, (const int32_t*)q_sums,
        (const uint32_t*)words, (const float*)feat_scale, (const float*)feat_zero,
        (const int32_t*)pages, (const uint8_t*)blk_valid, (float*)out, (float*)lo, (float*)hi,
        KV, G, R, BS, MB, nb, vec_out, fs);
    return (int)cudaGetLastError();
  };
  const auto kernel = [](auto gt, auto wt) {
    constexpr int GG = decltype(gt)::value, WW = decltype(wt)::value;
    if constexpr (K == PAGED) return &paged_score_estimate_kernel<BF16, GG, WW>;
    else if constexpr (K == BOUNDS) return &paged_score_bounds_kernel<BF16, GG, WW>;
    else return &flat_score_kernel<BF16, GG, WW>;
  };
  const size_t bounds_smem = K == BOUNDS ? 2 * KV * sizeof(int) : 0;
  // the main paths' shape: the register layout
  if (regs)
    return run(kernel(std::integral_constant<int, 1>{}, std::integral_constant<int, 4>{}),
               bounds_smem);
  // every other shape: the wide layout, the packed query in shared memory
  return run(kernel(std::integral_constant<int, 0>{}, std::integral_constant<int, 0>{}),
             (size_t)KV * ((G * W) | 1) * sizeof(int4) + bounds_smem);
}

template <Kind K>
int launch(const void* q_codes, const void* q_scale, const void* q_sums, const void* words,
           const void* feat_scale, const void* feat_zero, const void* pages,
           const void* blk_valid, void* out, void* lo, void* hi, int S, int KV, int G, int R,
           int BS, int MB, bool regs, FlatStrides fs, int bf16, void* stream) {
  const auto go = [&](auto flag) {
    return launch_score<K, decltype(flag)::value>(q_codes, q_scale, q_sums, words, feat_scale,
                                                  feat_zero, pages, blk_valid, out, lo, hi, S,
                                                  KV, G, R, BS, MB, regs, fs,
                                                  (cudaStream_t)stream);
  };
  return bf16 ? go(std::true_type{}) : go(std::false_type{});
}

}  // namespace

extern "C" int paged_score_estimate(const void* q_codes, const void* q_scale,
                                    const void* q_sums, const void* words,
                                    const void* feat_scale, const void* feat_zero,
                                    const void* pages, void* out, int S, int KV, int G,
                                    int R, int BS, int MB, int bf16, void* stream) {
  return launch<PAGED>(q_codes, q_scale, q_sums, words, feat_scale, feat_zero, pages, nullptr,
                       out, nullptr, nullptr, S, KV, G, R, BS, MB, true, FlatStrides{}, bf16,
                       stream);
}

extern "C" int paged_score_bounds(const void* q_codes, const void* q_scale,
                                  const void* q_sums, const void* words,
                                  const void* feat_scale, const void* feat_zero,
                                  const void* pages, const void* blk_valid, void* out,
                                  void* lo, void* hi, int S, int KV, int G, int R, int BS,
                                  int MB, int bf16, void* stream) {
  return launch<BOUNDS>(q_codes, q_scale, q_sums, words, feat_scale, feat_zero, pages,
                        blk_valid, out, lo, hi, S, KV, G, R, BS, MB, true, FlatStrides{}, bf16,
                        stream);
}

// B7. Strides are in elements of each tensor; the output is (B * KV, N).
extern "C" int flat_score_estimate(const void* q_codes, const void* q_scale, const void* words,
                                   const void* feat_scale, const void* feat_zero, void* out,
                                   int B, int KV, int G, int R, int N, long long w_sb,
                                   long long w_sn, long long w_skv, long long a_sb,
                                   long long a_sn, long long a_skv, long long z_sb,
                                   long long z_sn, long long z_skv, int bf16, void* stream) {
  if (R % 16 != 0 || KV < 1 || N < 1) return (int)cudaErrorInvalidValue;
  // 16 B word loads need every record 16 B apart from the first
  const auto by4 = [](long long stride, int size) { return size == 1 || stride % 4 == 0; };
  const bool regs = by4(w_sb, B) && by4(w_sn, N) && by4(w_skv, KV);
  return launch<FLAT>(q_codes, q_scale, nullptr, words, feat_scale, feat_zero, nullptr, nullptr,
                      out, nullptr, nullptr, B, KV, G, R, 1, N, regs,
                      FlatStrides{w_sb, w_sn, w_skv, a_sb, a_sn, a_skv, z_sb, z_sn, z_skv}, bf16,
                      stream);
}
