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
// in registers from shared memory (sign-extended), so only the packed bytes
// cross HBM.
//
// B6 replaces sparse_flash_decode_paged_partials_pallas: the same kernel
// (given m_out and l_out) stopped before the normalization, writing the
// online-softmax state (acc, m, l) that the block-sharded tick merges
// across ranks. A row with counts[b] == 0 (this rank owns none of its
// selected blocks) writes acc = 0, m = -1e30, l = 0, which vanish in the
// merge.
//
// Bound on this card: bytes — the K and V rows of the selected blocks (1 B,
// 2 B or 1/2 B per element) plus their scales, read once; the math is 4-16
// flops per byte. Design of B2/B6 (B8's, carried over to the block lists):
// the walk is one CTA's block loop — block by block in list order, the
// block's scores (lane d sums channels d, d + 32, ..., then the xor tree),
// its max, mnew = max(m, mx), corr = exp(m - mnew), p, the block's sum in
// token order, l = l * corr + sum, acc *= corr, acc += p * v in token order —
// and the parallelism comes from the output channels: the grid is
// (slices, BH), each CTA accumulating W = 32 * cpl output channels of every
// query row of its row (cpl = 1 up to HD 256, so HD / 32 CTAs per row, 128 at
// the main path; above, at most 8 slices with cpl channels per lane). The CTA
// reads its row's block list itself. Its 16 warps form a pipeline over steps
// of whole blocks (about two scoring passes, 224 tokens at G = 2): 16-byte
// cp.async copies bring step s + 2 (K rows, the CTA's V slice, scales, mask
// rows) into rings while the 16 - G scoring warps score step s + 1 (the xor
// trees of 16 dot products at once, halving: tree_sums) and compute each
// block's max, running max, corr, p and sum — none of which depends on acc —
// and warp g walks query row g through step s: l, the rescale and lane d's
// channels of p * v, dequantizing v as it reads it. So the output is that of
// one CTA walking the row, bit for bit. A row's longest list sets the
// kernel's time, and every CTA of a row scores the whole row, which bounds it
// now. A first version that shared the scores across a row's CTAs
// through a thread-block cluster (each scoring 1/slices of the tokens,
// written into every CTA's ring through distributed shared memory) paid a
// cluster barrier per block and was slower (PERF.md). f32 throughout (G <= 8
// query rows of an f32 q).
//
// G = 3 (granite-moe's 24 heads over 8 KV heads): a scoring pass dots 16 / G
// tokens at once and the xor trees halve over 16 values, so the layout needs
// G to divide 16. G 3 runs on the G 4 layout with a fourth query row of
// zeros: it is scored with the other three (its scores are 0 and never
// read) but no warp walks it and nothing of it is stored (template GQ, the
// real rows, beside G, the layout's). Each query row's walk and softmax are
// independent of the other rows, so rows 0-2 are what a G 3 layout would
// compute, bit for bit; the cost is a quarter more scoring than G 3 needs.
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
// a row scores the whole row, as B2's do. HD is a multiple of 32 up to 1024
// and G is 1, 2, 3, 4 or 8.
//
// B8 takes G = 3 as it is: its scoring warps carry B8_TOK tokens x G rows
// with one full xor tree each, which needs no power of two, so it is
// instantiated at G 3 (13 scoring warps).
//
// B8's partials branch (the sequence-sharded contiguous tick): the same kernel
// given m_out and l_out writes the walk's unnormalised state (acc, m, l) in
// place of the normalised output, as B6 is to B2; a row with nothing live
// writes (0, -1e30, 0). Each rank merges it across ranks by pmax / psum.

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

constexpr int B2_THREADS = 512;    // 16 warps: G walk, the others score
constexpr int B2_STEP = 128;       // tokens per step at least (whole scoring passes, blocks)
constexpr int B2_MAX_SLICES = 8;   // CTAs per row at most
constexpr int B2_SMEM_MAX = 232448;   // shared memory one CTA may use (227 KB)
constexpr unsigned FULL = 0xffffffffu;

// Element d of a staged code row (`row` points at its first byte), as f32.
template <int CODE>
__device__ __forceinline__ float code_at(const unsigned char* row, int d) {
  if (CODE == CODE_HALF) return __half2float(((const __half*)row)[d]);
  if (CODE == CODE_NIBBLE) {
    const int b = ((const int8_t*)row)[d >> 1];
    const int hi = b >> 4;                        // arithmetic: sign-extended
    const int lo = b - hi * 16;                   // [0, 15]
    return (float)((d & 1) ? hi : lo - ((lo & 8) << 1));
  }
  return (float)((const int8_t*)row)[d];
}

// The warp sums of a lane's C values x[0..C) (C a power of two), each in
// the xor tree's order — pairs of lanes 16 apart first, then 8, ... — as
// `x += shfl_xor(x, o)` level by level gives, but halving: at each level a
// lane keeps half its values, adds its partner's copy of them and sends the
// other half, so C - 1 + (5 - log2 C) shuffles replace 5 C. The total of
// value lane >> (5 - log2 C) ends in x[0]. Every addition pairs the same two
// partial sums as the full tree does, so each total is the tree's, bit for
// bit (float addition commutes).
template <int C>
__device__ __forceinline__ void tree_sums(float* x, int lane, int o) {
  if constexpr (C > 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int j = 0; j < C / 2; ++j) {
      const float send = upper ? x[j] : x[j + C / 2];
      const float keep = upper ? x[j + C / 2] : x[j];
      x[j] = keep + __shfl_xor_sync(FULL, send, o);
    }
    tree_sums<C / 2>(x, lane, o >> 1);
  } else {
    for (; o > 0; o >>= 1) x[0] += __shfl_xor_sync(FULL, x[0], o);
  }
}

// How a row's output channels split over its CTAs: `cpl` channels per lane,
// W = 32 * cpl per CTA, `slices` CTAs (the last one may hold fewer than W
// channels when HD / 32 is not a multiple of cpl).
struct B2Split {
  int cpl, w, slices;
  __host__ __device__ explicit B2Split(int HD) {
    const int n = HD / 32;
    cpl = (n + B2_MAX_SLICES - 1) / B2_MAX_SLICES;
    w = 32 * cpl;
    slices = (n + cpl - 1) / cpl;
  }
};

// Shared memory of a B2/B6 CTA staging `nb` blocks (T = nb * BS tokens) per
// step: rings of the staged step (K rows, K scales and mask rows two deep,
// read by the scoring warps; the V slice and its scales three deep, read by
// the walking warps a step later), of its scores / probabilities and of the
// per-block softmax terms (corr, the running max, the block sum); the
// scoring warps' block maxima and running max; q; the row's block list.
struct B2Layout {
  int k, v, ks, vs, mk, q, p, terms, mx, mrun, list, bytes;
  __host__ __device__ B2Layout(int G, int HD, int BS, int NSB, int code, int w, int nb) {
    const int T = nb * BS;
    const int krow = code == CODE_HALF ? 2 * HD : code == CODE_NIBBLE ? HD / 2 : HD;
    const int vrow = code == CODE_HALF ? 2 * w : code == CODE_NIBBLE ? w / 2 : w;
    const int nscale = code == CODE_INT8 ? T : nb;
    k = 0;                                           // (2, T, krow) bytes
    v = k + 2 * T * krow;                            // (3, T, vrow) bytes
    ks = v + 3 * T * vrow;                           // f32 (2, T | nb)
    vs = ks + 2 * 4 * nscale;                        // f32 (3, T | nb)
    mk = vs + 3 * 4 * nscale;                        // u8 (2, T)
    q = (mk + 2 * T + 15) & ~15;                     // f32 (G, HD)
    p = q + 4 * G * HD;                              // f32 (2, G, T): scores, then p
    terms = p + 4 * 2 * G * T;                       // f32 (2, 3, nb, G): corr, mnew, sum
    mx = terms + 4 * 2 * 3 * nb * G;                 // f32 (nb, G)
    mrun = mx + 4 * nb * G;                          // f32 (G)
    list = mrun + 4 * G;                             // i32 (NSB)
    bytes = list + 4 * NSB;
  }
};

// Blocks per step: as many whole blocks as fit in the first multiple of a
// scoring pass (the tokens the scoring warps dot at once) at or above
// B2_STEP tokens, at least one; fewer while the layout exceeds the CTA's
// shared memory; 0 if even one block does not fit.
inline int b2_blocks_per_step(int G, int HD, int BS, int NSB, int code) {
  const B2Split sp(HD);
  const int pass = (16 / G) * (B2_THREADS / 32 - G);
  const int want = pass * ((B2_STEP + pass - 1) / pass);
  for (int nb = want / BS > 1 ? want / BS : 1; nb > 0; --nb)
    if (B2Layout(G, HD, BS, NSB, code, sp.w, nb).bytes <= B2_SMEM_MAX) return nb;
  return 0;
}

// Row b = blockIdx.y walks physical blocks pblk[b, :counts[b]] of the
// (P, BS, KV, ·) pool at kv head b % KV; bmask is (BH, NSB, BS). PER_BLOCK:
// scales are (P, 1, KV), one word per (block, kv). CTA blockIdx.x
// accumulates channels [x * W, x * W + W); CPL (1 or 4) bounds cpl. With
// m_out set (B6) it writes the unnormalised state, else the output. G is the
// layout's query rows (a divisor of 16), GQ <= G the real ones: q, out, m_out
// and l_out hold GQ rows per row b; rows GQ..G-1 are zeros, scored, never
// walked or stored.
template <int G, int GQ, int CODE, bool PER_BLOCK, int CPL>
__global__ void __launch_bounds__(B2_THREADS) sparse_flash_decode_paged_kernel(
    const float* __restrict__ q,          // (BH, GQ, HD)
    const void* __restrict__ k_codes,     // (P, BS, KV, HD | HD/2)
    const float* __restrict__ k_scale,    // (P, BS | 1, KV)
    const void* __restrict__ v_codes,     // (P, BS, KV, HD | HD/2)
    const float* __restrict__ v_scale,    // (P, BS | 1, KV)
    const int32_t* __restrict__ pblk,     // (BH, NSB)
    const int32_t* __restrict__ counts,   // (BH,)
    const uint8_t* __restrict__ bmask,    // (BH, NSB, BS)
    float* __restrict__ out,              // (BH, GQ, HD): output, or acc (B6)
    float* __restrict__ m_out,            // (BH, GQ), B6 only (else null)
    float* __restrict__ l_out,            // (BH, GQ), B6 only
    int HD, int BS, int KV, int NSB, float scale, int NB) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NWARPS = B2_THREADS / 32, NSCORE = NWARPS - G;
  constexpr int TOK = 16 / G;                 // tokens a scoring warp dots at once (a pass)
  const bool partials = m_out != nullptr;
  const B2Split sp(HD);
  const int W = CPL == 1 ? 32 : sp.w, cpl = CPL == 1 ? 1 : sp.cpl;
  const int T = NB * BS;
  const B2Layout L(G, HD, BS, NSB, CODE, W, NB);
  const int krow = CODE == CODE_HALF ? 2 * HD : CODE == CODE_NIBBLE ? HD / 2 : HD;
  const int vrow = CODE == CODE_HALF ? 2 * W : CODE == CODE_NIBBLE ? W / 2 : W;
  const int nscale = PER_BLOCK ? NB : T;
  float* q_sh = (float*)(smem + L.q);
  float* mx_sh = (float*)(smem + L.mx);
  float* mrun = (float*)(smem + L.mrun);
  int32_t* list = (int32_t*)(smem + L.list);
  const float NEG = -1e30f;
  const int b = blockIdx.y, kv = b % KV, d0 = blockIdx.x * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cnt = counts[b];
  const int nsteps = (cnt + NB - 1) / NB;
  auto nblk = [&](int s) { return min(NB, cnt - s * NB); };
  for (int i = tid; i < cnt; i += B2_THREADS) list[i] = pblk[(size_t)b * NSB + i];
  for (int i = tid; i < G * HD; i += B2_THREADS)
    q_sh[i] = i < GQ * HD ? q[(size_t)b * GQ * HD + i] : 0.f;
  if (tid < G) mrun[tid] = NEG;
  __syncthreads();

  // stage step s's blocks (their K rows, this CTA's V slice, the scales,
  // the mask rows) into ring slots s & 1 (V and its scales: s % 3); token u
  // of the step is token u % BS of its block u / BS
  auto stage = [&](int s) {
    const int buf = s & 1, vbuf = s % 3, n0 = s * NB, tn = nblk(s) * BS;
    const unsigned char* kg = (const unsigned char*)k_codes;
    const unsigned char* vg = (const unsigned char*)v_codes;
    auto row = [&](int u) {                   // pool row of token u: (pb, t, kv)
      const int blk = u / BS;
      return ((size_t)list[n0 + blk] * BS + (u - blk * BS)) * KV + kv;
    };
    const uint32_t ka = smem_addr(smem + L.k + buf * T * krow);
    const int kchunks = krow / 16;
    for (int i = tid; i < tn * kchunks; i += B2_THREADS) {
      const int u = i / kchunks;
      cp_async16(ka + 16 * i, kg + row(u) * krow + 16 * (i - u * kchunks), true);
    }
    const uint32_t va = smem_addr(smem + L.v + vbuf * T * vrow);
    const int vchunks = vrow / 16, dbyte = CODE == CODE_HALF ? 2 * d0
                                         : CODE == CODE_NIBBLE ? d0 / 2 : d0;
    for (int i = tid; i < tn * vchunks; i += B2_THREADS) {
      const int u = i / vchunks, off = dbyte + 16 * (i - u * vchunks);
      const bool ok = off < krow;             // the last slice may end early
      cp_async16(va + 16 * i, vg + row(u) * krow + (ok ? off : 0), ok);
    }
    const uint32_t ksa = smem_addr(smem + L.ks + buf * 4 * nscale);
    const uint32_t vsa = smem_addr(smem + L.vs + vbuf * 4 * nscale);
    if (PER_BLOCK) {
      for (int i = tid; i < 2 * nblk(s); i += B2_THREADS) {
        const size_t w = (size_t)list[n0 + (i >> 1)] * KV + kv;
        if (i & 1) cp_async4(vsa + 4 * (i >> 1), v_scale + w);
        else cp_async4(ksa + 4 * (i >> 1), k_scale + w);
      }
    } else {
      for (int i = tid; i < 2 * tn; i += B2_THREADS) {
        const int u = i >> 1;
        if (i & 1) cp_async4(vsa + 4 * u, v_scale + row(u));
        else cp_async4(ksa + 4 * u, k_scale + row(u));
      }
    }
    unsigned char* mk = smem + L.mk + buf * T;
    const uint8_t* mg = bmask + ((size_t)b * NSB + n0) * BS;   // the step's rows are adjacent
    if ((BS & 3) == 0) {
      for (int i = tid; i < tn / 4; i += B2_THREADS) cp_async4(smem_addr(mk + 4 * i), mg + 4 * i);
    } else {
      for (int u = tid; u < tn; u += B2_THREADS) mk[u] = mg[u];
    }
    cp_async_commit();
  };

  // the scoring warps' barrier (named barrier 1; the walking warps go on)
  auto score_sync = [&]() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(NSCORE * 32));
  };

  // scoring warps, on staged step s: the scores, one token per warp in B2's
  // order (lane d sums channels d, d + 32, ..., then the xor tree, TOK
  // tokens at once); then, per (block, query row), the block's max, the
  // running max and corr = exp(m - mnew) in block order, p and the block's
  // sum in token order — the walk's terms, which depend on no acc
  auto score = [&](int s) {
    const int buf = s & 1, sw = warp - G, nb = nblk(s), tn = nb * BS;
    const unsigned char* k_sh = smem + L.k + buf * T * krow;
    const float* ks_sh = (const float*)(smem + L.ks + buf * 4 * nscale);
    const unsigned char* mk = smem + L.mk + buf * T;
    float* p_sh = (float*)(smem + L.p) + buf * G * T;
    float* terms = (float*)(smem + L.terms) + buf * 3 * NB * G;   // corr, mnew, sum
    constexpr int SHIFT = 5 - 4;              // log2(32 / (TOK * G)), TOK * G = 16
    const int mine = lane >> SHIFT;           // the value whose total this lane ends with
    for (int u0 = sw; u0 < tn; u0 += TOK * NSCORE) {
      float part[TOK * G];
#pragma unroll
      for (int i = 0; i < TOK * G; ++i) part[i] = 0.f;
#pragma unroll 4
      for (int d = lane; d < HD; d += 32) {
        float qd[G];
#pragma unroll
        for (int g = 0; g < G; ++g) qd[g] = q_sh[g * HD + d];
#pragma unroll
        for (int k = 0; k < TOK; ++k) {
          const int u = u0 + k * NSCORE;
          const float kd = u < tn ? code_at<CODE>(k_sh + u * krow, d) : 0.f;
#pragma unroll
          for (int g = 0; g < G; ++g) part[k * G + g] += qd[g] * kd;
        }
      }
      tree_sums<TOK * G>(part, lane, 16);
      const int k = mine / G, g = mine - k * G, u = u0 + k * NSCORE;
      if ((lane & ((1 << SHIFT) - 1)) == 0 && u < tn) {
        const float sc = PER_BLOCK ? part[0] * (ks_sh[u / BS] * scale)   // the reference's order
                                   : part[0] * ks_sh[u] * scale;
        p_sh[g * T + u] = mk[u] ? sc : NEG;
      }
    }
    score_sync();
    for (int task = sw; task < nb * G; task += NSCORE) {     // the block maxima
      const int k = task / G, g = task - k * G;
      float mx = NEG;
      for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, p_sh[g * T + k * BS + t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      if (lane == 0) mx_sh[k * G + g] = mx;
    }
    score_sync();
    if (sw == 0 && lane < G) {                // the running max, block by block
      float m = mrun[lane];
      for (int k = 0; k < nb; ++k) {
        const float mnew = fmaxf(m, mx_sh[k * G + lane]);
        terms[k * G + lane] = expf(m - mnew);
        terms[(NB + k) * G + lane] = mnew;
        m = mnew;
      }
      mrun[lane] = m;
    }
    score_sync();
    for (int task = sw; task < nb * G; task += NSCORE) {     // p and the block sums
      const int k = task / G, g = task - k * G;
      float* pg = p_sh + g * T + k * BS;
      const float mnew = terms[(NB + k) * G + g];
      for (int t = lane; t < BS; t += 32) pg[t] = mk[k * BS + t] ? expf(pg[t] - mnew) : 0.f;
      __syncwarp();
      if (lane == 0) {
        float ps = 0.f;
#pragma unroll 8
        for (int t = 0; t < BS; ++t) ps += pg[t];
        terms[(2 * NB + k) * G + g] = ps;
      }
    }
  };

  // walking warp g, on scored step s: query row g block by block as B2's
  // loop — l = l * corr + sum, acc *= corr, then lane d's channels of
  // p * v in token order, v dequantized as B2 dequantizes (code * scale)
  float m = NEG, l = 0.f, acc[CPL];           // row `warp`'s walk
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  auto walk = [&](int s) {
    const int buf = s & 1, nb = nblk(s);
    const float* pg = (const float*)(smem + L.p) + (buf * G + warp) * T;
    const unsigned char* v_sh = smem + L.v + (s % 3) * T * vrow;
    const float* vs_sh = (const float*)(smem + L.vs + (s % 3) * 4 * nscale);
    const float* terms = (const float*)(smem + L.terms) + buf * 3 * NB * G;
    for (int k = 0; k < nb; ++k) {
      const float corr = terms[k * G + warp];
      l = l * corr + terms[(2 * NB + k) * G + warp];
      m = terms[(NB + k) * G + warp];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] *= corr;
      const int u0 = k * BS;
      const float vsk = PER_BLOCK ? vs_sh[k] : 0.f;
      if (CPL == 1) {
#pragma unroll 8
        for (int u = u0; u < u0 + BS; ++u) {
          const float vv = code_at<CODE>(v_sh + u * vrow, lane) * (PER_BLOCK ? vsk : vs_sh[u]);
          acc[0] += pg[u] * vv;
        }
      } else {
        for (int u = u0; u < u0 + BS; ++u) {
          const float pu = pg[u], vsu = PER_BLOCK ? vsk : vs_sh[u];
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            if (j < cpl) acc[j] += pu * (code_at<CODE>(v_sh + u * vrow, 32 * j + lane) * vsu);
        }
      }
    }
  };

  // the pipeline: while the walking warps walk step s, the scoring warps
  // score step s + 1 and step s + 2 is being copied in
  if (nsteps > 0) {
    stage(0);
    if (nsteps > 1) stage(1);
    if (nsteps > 1) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    if (warp >= G) score(0);
    __syncthreads();
  }
  for (int s = 0; s < nsteps; ++s) {
    if (s + 2 < nsteps) stage(s + 2);          // into slots that score(s) and walk(s - 1) read
    if (s + 2 < nsteps) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();                           // step s + 1 has landed
    if (warp >= G) {
      if (s + 1 < nsteps) score(s + 1);
    } else if (warp < GQ) {
      walk(s);
    }
    __syncthreads();                           // the slots are rewritten next
  }
  if (warp < GQ) {
    for (int j = 0; j < cpl; ++j) {
      const int c = d0 + 32 * j + lane;
      if (c < HD) out[((size_t)b * GQ + warp) * HD + c] = partials ? acc[j]
                                                                   : acc[j] / fmaxf(l, 1e-20f);
    }
    if (partials && blockIdx.x == 0 && lane == 0) {   // every CTA holds the same (m, l)
      m_out[(size_t)b * GQ + warp] = m;
      l_out[(size_t)b * GQ + warp] = l;
    }
  }
}

// The launch of one branch: grid (slices, BH), 512 threads.
template <int CODE, bool PER_BLOCK>
int launch(const void* q, const void* k_codes, const void* k_scale, const void* v_codes,
           const void* v_scale, const void* pblk, const void* counts, const void* bmask,
           void* out, void* m_out, void* l_out, int BH, int G, int HD, int BS, int KV,
           int NSB, float scale, void* stream) {
  if (HD % 32 != 0 || HD > 1024 || BS < 1 || BH < 1) return (int)cudaErrorInvalidValue;
  const B2Split sp(HD);
  const int GL = G == 3 ? 4 : G;                     // the layout's rows (G 3 on G 4's)
  const int nb = b2_blocks_per_step(GL, HD, BS, NSB, CODE);
  if (nb < 1) return (int)cudaErrorInvalidValue;    // one block's rows exceed shared memory
  const int smem = B2Layout(GL, HD, BS, NSB, CODE, sp.w, nb).bytes;
  const dim3 grid(sp.slices, BH);
  cudaStream_t st = (cudaStream_t)stream;
  // the attribute is set on every launch (cheap; it is per device)
#define B2_LAUNCH(GG, GQ, CC)                                                           \
  do {                                                                                  \
    auto* fn = sparse_flash_decode_paged_kernel<GG, GQ, CODE, PER_BLOCK, CC>;           \
    const cudaError_t e =                                                               \
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);    \
    if (e != cudaSuccess) return (int)e;                                                \
    fn<<<grid, B2_THREADS, smem, st>>>(                                                 \
        (const float*)q, k_codes, (const float*)k_scale, v_codes, (const float*)v_scale, \
        (const int32_t*)pblk, (const int32_t*)counts, (const uint8_t*)bmask, (float*)out, \
        (float*)m_out, (float*)l_out, HD, BS, KV, NSB, scale, nb);                      \
  } while (0)
#define B2_GROUPS(CC)                              \
  switch (G) {                                     \
    case 1: B2_LAUNCH(1, 1, CC); break;            \
    case 2: B2_LAUNCH(2, 2, CC); break;            \
    case 3: B2_LAUNCH(4, 3, CC); break;            \
    case 4: B2_LAUNCH(4, 4, CC); break;            \
    case 8: B2_LAUNCH(8, 8, CC); break;            \
    default: return (int)cudaErrorInvalidValue;    \
  }
  if (sp.cpl == 1) {
    B2_GROUPS(1)
  } else {
    B2_GROUPS(4)
  }
#undef B2_GROUPS
#undef B2_LAUNCH
  return (int)cudaGetLastError();
}

// The paged kernels' branch by the pool's storage code: int8 (per-token
// scales), half or nibble (per-block scales).
int launch_paged(int code, const void* q, const void* k_codes, const void* k_scale,
                 const void* v_codes, const void* v_scale, const void* pblk, const void* counts,
                 const void* bmask, void* out, void* m_out, void* l_out, int BH, int G, int HD,
                 int BS, int KV, int NSB, float scale, void* stream) {
#define B2_BRANCH(CC, PB)                                                          \
  launch<CC, PB>(q, k_codes, k_scale, v_codes, v_scale, pblk, counts, bmask,        \
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
    float* __restrict__ out,              // (BH, G, HD): normalised, or acc
    float* __restrict__ m_out,            // (BH, G) or null: the partials branch
    float* __restrict__ l_out,            // (BH, G) or null
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
  if (warp < G) {
    const size_t row = (size_t)b * G + warp;
    if (m_out == nullptr) {
      out[row * HD + d0 + lane] = acc / fmaxf(l, 1e-20f);
    } else {                                 // the walk's state; an empty row: (0, -1e30, 0)
      out[row * HD + d0 + lane] = acc;
      if (blockIdx.y == 0 && lane == 0) {
        m_out[row] = m;
        l_out[row] = l;
      }
    }
  }
}

int launch_flat(const void* q, const void* k_codes, const void* k_scale, const void* v_codes,
                const void* v_scale, const void* mask, void* out, void* m_out, void* l_out,
                int BH, int G, int HD, int C, float scale, void* stream) {
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
        (float*)m_out, (float*)l_out, HD, C, scale);                                    \
  } while (0)
  switch (G) {
    case 1: B8_LAUNCH(1); break;
    case 2: B8_LAUNCH(2); break;
    case 3: B8_LAUNCH(3); break;
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
  return launch_paged(code, q, k_codes, k_scale, v_codes, v_scale, pblk, counts, bmask, out,
                      nullptr, nullptr, BH, G, HD, BS, KV, NSB, scale, stream);
}

extern "C" int sparse_flash_decode_paged_partials(
    const void* q, const void* k_codes, const void* k_scale, const void* v_codes,
    const void* v_scale, const void* pblk, const void* counts, const void* bmask, void* acc,
    void* m, void* l, int BH, int G, int HD, int BS, int KV, int NSB, float scale, int code,
    void* stream) {
  return launch_paged(code, q, k_codes, k_scale, v_codes, v_scale, pblk, counts, bmask, acc,
                      m, l, BH, G, HD, BS, KV, NSB, scale, stream);
}

extern "C" int sparse_flash_decode(const void* q, const void* k_codes, const void* k_scale,
                                   const void* v_codes, const void* v_scale, const void* mask,
                                   void* out, int BH, int G, int HD, int C, float scale,
                                   void* stream) {
  return launch_flat(q, k_codes, k_scale, v_codes, v_scale, mask, out, nullptr, nullptr, BH, G,
                     HD, C, scale, stream);
}

// B8's partials branch: the walk's unnormalised state (acc, m, l)
extern "C" int sparse_flash_decode_partials(const void* q, const void* k_codes,
                                            const void* k_scale, const void* v_codes,
                                            const void* v_scale, const void* mask, void* acc,
                                            void* m, void* l, int BH, int G, int HD, int C,
                                            float scale, void* stream) {
  return launch_flat(q, k_codes, k_scale, v_codes, v_scale, mask, acc, m, l, BH, G, HD, C,
                     scale, stream);
}
