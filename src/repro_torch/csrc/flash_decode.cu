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
// Bound on this card: bytes — the K and V rows of the selected blocks (1 B,
// 2 B or 1/2 B per element) plus their scales, read once; the math is 4-16
// flops per byte. Design of B2/B6: one
// CTA per row (the loop over the row's blocks replaces the TPU's sequential
// grid axis; nothing carries between CTAs), blockDim = HD threads. Warps
// score tokens (a lane per channel group, shuffle reduction), scores and
// probabilities go through shared memory, and thread d accumulates output
// channel d in registers, so V rows are read coalesced. Simple first
// version: a row's blocks are processed one after another, so few CTAs
// (slots*KV) are in flight; B8's channel split below is their next step.
//
// B8 replaces sparse_flash_decode_pallas (the contiguous tick): the same math
// over rows already gathered into (BH, C, HD) int8 codes with (BH, C) scales
// and mask; the score is (q . k) * k_scale * (1/sqrt(HD)), a multiply as in
// the TPU kernel. Bound: bytes, as B2 (the live rows' codes and scales).
// Design, its own kernel: the row's walk is B2's block loop over runs of 32
// tokens (running max, rescale, sums in token order: what one CTA walking the
// whole row computes), and the parallelism comes from the output channels: the
// grid is (BH, HD / 32), each CTA accumulating 32 channels of every query row,
// so 32 rows x 4 slices = 128 CTAs on the contiguous tick. Each CTA reads the
// row's mask and stops at its last live token (compact_indices puts the live
// tokens first, so the padded tail is never loaded; a run with nothing live
// changes nothing in the walk). Its 16 warps form a pipeline over 64-token
// chunks: 16-byte cp.async copies bring chunk c + 2 (K rows, the CTA's V
// slice, scales) into a two-slot ring while 16 - G scoring warps score chunk c
// + 1 in B2's order (lane d sums channels d, d + 32, ..., then a shuffle tree;
// four tokens per warp at once) and dequantize its V slice, and warp g walks
// query row g through chunk c: the run's max by a warp reduction (exact), p,
// the run's sum in token order, the rescale of l and acc, and lane d's channel
// of p * v. So B8's output is that of one CTA walking the row, bit for bit,
// and equals B2's wherever a row's runs are B2's blocks: the contiguous and
// the paged ticks part only where the block masks move a rescale point. A
// split over C with a merge of per-chunk (acc, m, l) partials rounds
// independently of B2 and measurably widened their gap (PERF.md). Every CTA of
// a row scores the whole row, which bounds the kernel now; sharing the scores
// across the row's CTAs (a thread-block cluster) is the next step. f32
// throughout: with G <= 8 query rows and an f32 q, tensor cores would need q
// rounded. HD is a multiple of 32 up to 1024 and G is 1, 2, 4 or 8, as before.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

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

// Row b walks physical blocks pblk[b, :counts[b]] of the (P, BS, KV, HD)
// pool at kv head b % KV; bmask is (BH, NSB, BS). PER_BLOCK: scales are
// (P, 1, KV), one word per (block, kv).
template <int G, bool PARTIALS, int CODE, bool PER_BLOCK>
__global__ void sparse_flash_decode_paged_kernel(
    const float* __restrict__ q,          // (BH, G, HD)
    const void* __restrict__ k_codes,     // (P, BS, KV, HD | HD/2)
    const float* __restrict__ k_scale,    // (P, BS | 1, KV)
    const void* __restrict__ v_codes,     // (P, BS, KV, HD | HD/2)
    const float* __restrict__ v_scale,    // (P, BS | 1, KV)
    const int32_t* __restrict__ pblk,     // (BH, NSB)
    const int32_t* __restrict__ counts,   // (BH,)
    const uint8_t* __restrict__ bmask,    // (BH, NSB, BS)
    float* __restrict__ out,              // (BH, G, HD): output, or acc if PARTIALS
    float* __restrict__ m_out,            // (BH, G)  [PARTIALS]
    float* __restrict__ l_out,            // (BH, G)  [PARTIALS]
    int HD, int BS, int KV, int NSB, float scale) {
  extern __shared__ float sh[];
  float* q_sh = sh;               // (G, HD)
  float* p_sh = sh + G * HD;      // (G, BS): scores, then probabilities
  const int b = blockIdx.x;
  const int kv = b % KV;
  const size_t tstride = KV;      // rows between consecutive tokens of a block
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

  const int cnt = counts[b];
  for (int n = 0; n < cnt; ++n) {
    // the block's first row
    const size_t pb = (size_t)pblk[(size_t)b * NSB + n];
    const size_t base = pb * BS * KV + kv;
    const int nt = BS;
    const uint8_t* mk = bmask + (size_t)b * NSB * BS + (size_t)n * BS;
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

template <bool PARTIALS, int CODE, bool PER_BLOCK>
int launch(const void* q, const void* k_codes, const void* k_scale, const void* v_codes,
           const void* v_scale, const void* pblk, const void* counts, const void* bmask,
           void* out, void* m_out, void* l_out, int BH, int G, int HD, int BS, int KV,
           int NSB, float scale, void* stream) {
  if (HD % 32 != 0 || HD > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(G * HD + G * BS) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define B2_LAUNCH(GG)                                                              \
  sparse_flash_decode_paged_kernel<GG, PARTIALS, CODE, PER_BLOCK>                 \
      <<<BH, HD, smem, st>>>(                                                      \
      (const float*)q, k_codes, (const float*)k_scale,                             \
      v_codes, (const float*)v_scale, (const int32_t*)pblk,                        \
      (const int32_t*)counts, (const uint8_t*)bmask, (float*)out, (float*)m_out,   \
      (float*)l_out, HD, BS, KV, NSB, scale)
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

// The paged kernels' branch by the pool's storage code: int8 (per-token
// scales), half or nibble (per-block scales).
template <bool PARTIALS>
int launch_paged(int code, const void* q, const void* k_codes, const void* k_scale,
                 const void* v_codes, const void* v_scale, const void* pblk, const void* counts,
                 const void* bmask, void* out, void* m_out, void* l_out, int BH, int G, int HD,
                 int BS, int KV, int NSB, float scale, void* stream) {
#define B2_BRANCH(CC, PB)                                                          \
  launch<PARTIALS, CC, PB>(q, k_codes, k_scale, v_codes, v_scale, pblk, counts, bmask, \
                           out, m_out, l_out, BH, G, HD, BS, KV, NSB, scale, stream)
  switch (code) {
    case CODE_INT8: return B2_BRANCH(CODE_INT8, false);
    case CODE_HALF: return B2_BRANCH(CODE_HALF, true);
    case CODE_NIBBLE: return B2_BRANCH(CODE_NIBBLE, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B2_BRANCH
}


// ---- B8: the walk over gathered rows, split by output channels ---------

constexpr int B8_RUN = 32;        // tokens per run of the walk (B2's block size)
constexpr int B8_CH = 64;         // tokens staged per step (two runs)
constexpr int B8_SLICE = 32;      // output channels per CTA (one per lane)
constexpr int B8_THREADS = 512;   // 16 warps: G walk, the others score
constexpr int B8_TOK = 4;         // tokens a scoring warp dots at once

// Shared memory of a B8 CTA: two-deep rings of the staged chunk (K rows,
// the V slice, scales) and of its scores and dequantized V slice.
struct B8Layout {
  int k, v, ks, vs, q, p, vv, mk, bytes;
  __host__ __device__ B8Layout(int G, int HD, int C) {
    k = 0;                                  // int8 (2, CH, HD)
    v = k + 2 * B8_CH * HD;                 // int8 (2, CH, SLICE)
    ks = v + 2 * B8_CH * B8_SLICE;          // f32 (2, CH)
    vs = ks + 2 * B8_CH * 4;                // f32 (2, CH)
    q = vs + 2 * B8_CH * 4;                 // f32 (G, HD)
    p = q + G * HD * 4;                     // f32 (2, G, CH): scores, then p
    vv = p + 2 * G * B8_CH * 4;             // f32 (2, CH, SLICE): v * v_scale
    mk = vv + 2 * B8_CH * B8_SLICE * 4;     // u8 (C)
    bytes = mk + C;
  }
};

template <int G>
__global__ void __launch_bounds__(B8_THREADS) sparse_flash_decode_flat_kernel(
    const float* __restrict__ q,          // (BH, G, HD)
    const int8_t* __restrict__ k_codes,   // (BH, C, HD)
    const float* __restrict__ k_scale,    // (BH, C)
    const int8_t* __restrict__ v_codes,   // (BH, C, HD)
    const float* __restrict__ v_scale,    // (BH, C)
    const uint8_t* __restrict__ mask,     // (BH, C)
    float* __restrict__ out,              // (BH, G, HD)
    int HD, int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const B8Layout L(G, HD, C);
  float* q_sh = (float*)(smem + L.q);
  uint8_t* mk_sh = smem + L.mk;
  __shared__ int last_live;
  const float NEG = -1e30f;
  const int b = blockIdx.x, d0 = blockIdx.y * B8_SLICE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NWARPS = B8_THREADS / 32, NSCORE = NWARPS - G;
  const size_t row0 = (size_t)b * C;         // the row's first token

  // the row's mask; tokens past its last live one change nothing in the
  // walk (a run with nothing live leaves m, l and acc exactly as they are)
  if (tid == 0) last_live = -1;
  __syncthreads();
  int last = -1;
  for (int t = tid; t < C; t += B8_THREADS) {
    const uint8_t x = mask[row0 + t];
    mk_sh[t] = x;
    if (x) last = t;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0 && last >= 0) atomicMax(&last_live, last);
  for (int i = tid; i < G * HD; i += B8_THREADS) q_sh[i] = q[(size_t)b * G * HD + i];
  __syncthreads();
  const int end = last_live + 1;
  const int nchunks = (end + B8_CH - 1) / B8_CH;
  auto ntok = [&](int c) { return min(B8_CH, end - c * B8_CH); };

  // stage chunk c (its K rows, this CTA's V slice, both scales) into ring slot c & 1
  auto stage = [&](int c) {
    const int buf = c & 1, c0 = c * B8_CH, n = ntok(c);
    const uint32_t ka = smem_addr(smem + L.k + buf * B8_CH * HD);
    const uint32_t va = smem_addr(smem + L.v + buf * B8_CH * B8_SLICE);
    const int8_t* kg = k_codes + (row0 + c0) * HD;
    for (int i = tid; i < n * HD / 16; i += B8_THREADS) cp_async16(ka + 16 * i, kg + 16 * i, true);
    for (int i = tid; i < 2 * n; i += B8_THREADS)
      cp_async16(va + 16 * i, v_codes + (row0 + c0 + (i >> 1)) * HD + d0 + 16 * (i & 1), true);
    const uint32_t ksa = smem_addr(smem + L.ks + buf * B8_CH * 4);
    const uint32_t vsa = smem_addr(smem + L.vs + buf * B8_CH * 4);
    for (int t = tid; t < n; t += B8_THREADS) {
      cp_async4(ksa + 4 * t, k_scale + row0 + c0 + t);
      cp_async4(vsa + 4 * t, v_scale + row0 + c0 + t);
    }
    cp_async_commit();
  };

  // scoring warps, on staged chunk c: its dequantized V slice, as B2
  // dequantizes, and its scores, one token per warp in B2's order (lane d
  // sums channels d, d + 32, ... then a shuffle tree); each warp carries
  // B8_TOK tokens at once, their trees level by level
  auto score = [&](int c) {
    const int buf = c & 1, c0 = c * B8_CH, nt = ntok(c), sw = warp - G;
    const int8_t* k_sh = (const int8_t*)(smem + L.k + buf * B8_CH * HD);
    const int8_t* v_sh = (const int8_t*)(smem + L.v + buf * B8_CH * B8_SLICE);
    const float* ks_sh = (const float*)(smem + L.ks + buf * B8_CH * 4);
    const float* vs_sh = (const float*)(smem + L.vs + buf * B8_CH * 4);
    float* p_sh = (float*)(smem + L.p) + buf * G * B8_CH;
    float* vv_sh = (float*)(smem + L.vv) + buf * B8_CH * B8_SLICE;
    for (int i = sw * 32 + lane; i < nt * B8_SLICE; i += NSCORE * 32)
      vv_sh[i] = (float)v_sh[i] * vs_sh[i / B8_SLICE];
    for (int t0 = sw; t0 < nt; t0 += B8_TOK * NSCORE) {
      float part[B8_TOK][G];
#pragma unroll
      for (int k = 0; k < B8_TOK; ++k)
#pragma unroll
        for (int g = 0; g < G; ++g) part[k][g] = 0.f;
#pragma unroll 4
      for (int d = lane; d < HD; d += 32) {
        float qd[G];
#pragma unroll
        for (int g = 0; g < G; ++g) qd[g] = q_sh[g * HD + d];
#pragma unroll
        for (int k = 0; k < B8_TOK; ++k) {
          const int t = t0 + k * NSCORE;
          const float kd = t < nt ? (float)k_sh[t * HD + d] : 0.f;
#pragma unroll
          for (int g = 0; g < G; ++g) part[k][g] += qd[g] * kd;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < B8_TOK; ++k)
#pragma unroll
          for (int g = 0; g < G; ++g) part[k][g] += __shfl_xor_sync(0xffffffffu, part[k][g], o);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < B8_TOK; ++k) {
          const int t = t0 + k * NSCORE;
          if (t < nt) {
#pragma unroll
            for (int g = 0; g < G; ++g)
              p_sh[g * B8_CH + t] = mk_sh[c0 + t] ? part[k][g] * ks_sh[t] * scale : NEG;
          }
        }
      }
    }
  };

  // walking warp g, on scored chunk c: query row g run by run as B2's
  // block loop — the run's max (an exact warp reduction), the running max,
  // p, the run's sum in token order (lane r sums run r, as B2 sums), the
  // rescale of l and acc, then lane d's channel of p * v in token order
  float m = NEG, l = 0.f, acc = 0.f;         // row `warp`'s walk (acc: channel d0 + lane)
  auto walk = [&](int c) {
    const int buf = c & 1, c0 = c * B8_CH, nt = ntok(c);
    float* pg = (float*)(smem + L.p) + (buf * G + warp) * B8_CH;
    const float* vv_sh = (const float*)(smem + L.vv) + buf * B8_CH * B8_SLICE;
    const int n0 = min(B8_RUN, nt), n1 = nt - n0;
    float mx0 = lane < n0 ? pg[lane] : NEG, mx1 = lane < n1 ? pg[B8_RUN + lane] : NEG;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mnew0 = fmaxf(m, mx0), mnew1 = fmaxf(mnew0, mx1);
    if (lane < n0) pg[lane] = mk_sh[c0 + lane] ? expf(pg[lane] - mnew0) : 0.f;
    const int t1 = B8_RUN + lane;
    if (lane < n1) pg[t1] = mk_sh[c0 + t1] ? expf(pg[t1] - mnew1) : 0.f;
    __syncwarp();
    float ps = 0.f;                          // positions past the run add +0: exact
    if (lane < 2) {
      const int nr = lane ? n1 : n0;
#pragma unroll
      for (int i = 0; i < B8_RUN; ++i) ps += i < nr ? pg[lane * B8_RUN + i] : 0.f;
    }
    const float ps0 = __shfl_sync(0xffffffffu, ps, 0), ps1 = __shfl_sync(0xffffffffu, ps, 1);
    for (int r = 0; r < (n1 > 0 ? 2 : 1); ++r) {
      const float mnew = r ? mnew1 : mnew0;
      const float corr = expf(m - mnew);
      l = l * corr + (r ? ps1 : ps0);
      m = mnew;
      acc *= corr;
      const int ta = r * B8_RUN, tb = ta + (r ? n1 : n0);
#pragma unroll 8
      for (int t = ta; t < tb; ++t) acc += pg[t] * vv_sh[t * B8_SLICE + lane];
    }
  };

  // the pipeline: while the walking warps walk chunk c, the scoring warps
  // score chunk c + 1 and chunk c + 2 is being copied in
  if (nchunks > 0) {
    stage(0);
    if (nchunks > 1) stage(1);
    if (nchunks > 1) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    if (warp >= G) score(0);
    __syncthreads();
  }
  for (int c = 0; c < nchunks; ++c) {
    if (c + 2 < nchunks) stage(c + 2);       // into chunk c's slot, read by score(c) only
    if (c + 2 < nchunks) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();                          // chunk c + 1 has landed
    if (warp >= G) {
      if (c + 1 < nchunks) score(c + 1);
    } else {
      walk(c);
    }
    __syncthreads();                          // the slots are rewritten next
  }
  if (warp < G) out[((size_t)b * G + warp) * HD + d0 + lane] = acc / fmaxf(l, 1e-20f);
}

int launch_flat(const void* q, const void* k_codes, const void* k_scale, const void* v_codes,
                const void* v_scale, const void* mask, void* out, int BH, int G, int HD, int C,
                float scale, void* stream) {
  if (C < 1 || HD % B8_SLICE != 0 || HD > 1024) return (int)cudaErrorInvalidValue;
  const int smem = B8Layout(G, HD, C).bytes;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(BH, HD / B8_SLICE);
  // the attribute is set on every launch (cheap; it is per device)
#define B8_LAUNCH(GG)                                                                   \
  do {                                                                                  \
    const cudaError_t e = cudaFuncSetAttribute(sparse_flash_decode_flat_kernel<GG>,     \
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                               smem);                                   \
    if (e != cudaSuccess) return (int)e;                                                \
    sparse_flash_decode_flat_kernel<GG><<<grid, B8_THREADS, smem, st>>>(                \
        (const float*)q, (const int8_t*)k_codes, (const float*)k_scale,                 \
        (const int8_t*)v_codes, (const float*)v_scale, (const uint8_t*)mask, (float*)out, \
        HD, C, scale);                                                                  \
  } while (0)
  switch (G) {
    case 1: B8_LAUNCH(1); break;
    case 2: B8_LAUNCH(2); break;
    case 4: B8_LAUNCH(4); break;
    case 8: B8_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef B8_LAUNCH
  return (int)cudaGetLastError();
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
  return launch_flat(q, k_codes, k_scale, v_codes, v_scale, mask, out, BH, G, HD, C, scale,
                     stream);
}
