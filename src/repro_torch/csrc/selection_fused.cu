// Kernels B5 and B9: fused INT8 binning, stride-1 max-pool and 256-bin
// histogram (Salca phases 2-3), for Hopper (sm_90a).
//
// B5 replaces src/repro/kernels/selection_fused/kernel.py::
// paged_fused_select_pallas (the block-sharded tick). Row (s, kv) of the
// (S, KV, MB, BS) scores:
//   offset = isfinite(lo) ? lo : 0, scale = max((hi - offset) / 254, 1e-6)
//   bins   = valid ? clip(rint((score - offset) / scale) + 1, 1, 255) : 0
// with IEEE division and round-half-to-even, so the bins are bit-identical
// to quantization.bins_from_bounds; then a stride-1 max-pool of width
// `window` inside each block, whose out-of-block neighbours come from the
// given halo columns (from_left / from_right: the psum'd edge bins of the
// neighbouring blocks); pooling never revives a masked slot (bins == 0);
// sink/recent positions (force & valid) go to 255; and the raw histogram
// of the pooled bins. The threshold is located outside, after the
// histogram's all-reduce.
//
// B9 replaces fused_bin_pool_threshold_pallas (the contiguous tick). Row r
// of the flat (BH, N) scores: scale = max((hi - lo) / 254, 1e-6) with the
// `lo` operand used raw (the caller passes binning_affine's cleaned
// offset), bins = clip(rint((score - lo) / scale) + 1, 1, 255) below
// lengths[r] and 0 past it; a stride-1 max-pool along the row, whose
// window reads 0 past the row's ends; a pooled bin is 0 where its centre
// bin is 0; then the 256-bin histogram
// and the threshold: the largest bin whose reverse cumulative count is at
// least k[r], never below 1 (histogram_topk.locate_threshold).
//
// Bound on this card: bytes — 4 B of score in per valid position (plus 2 B
// of valid/force per position for B5) and 1 B of pooled bin out per
// position; a few dozen integer ops each.
//
// B5 design: the positions of a row go to warps in items (32 consecutive
// positions where the block size divides 32, else one block), three per
// warp, dealt round the row's CTAs (16 CTAs of 8 warps per row at the main
// path's 8,192 positions), each warp's items' loads issued together. A warp
// reads an item's validity first (a byte per lane, a ballot): at the main
// path about 64 % of the (slot, block) pairs hold nothing valid, and such an
// item stores zero bins and adds its positions to bin 0, reading no score,
// halo column or force byte. Elsewhere a lane bins its own position and
// takes the window max from its neighbours with shuffles, the block's edge
// lanes from the halo columns that lanes t < HALO of the block hold (any
// other block size: the block's bins and halo columns staged per warp in
// shared memory). No CTA barrier: each warp adds its pooled bins to the
// zeroed global histogram one run of equal neighbouring lanes at a time,
// and its bin-0 count once. Measured against other shapes (PERF.md):
// a cluster of a row's CTAs summing their shared histograms through
// distributed shared memory, which writes the histogram whole and needs no
// zeroing, cost ~1.5 us more at the same CTA shape.
//
// B9 design: one CTA of 640 threads per row, each taking words of 4
// consecutive positions. Only the row's valid prefix, min(lengths[r], N)
// positions, is read: up to four words' scores per thread, their loads
// issued together, 16 B each where the row is 16 B aligned (N % 4 == 0 and
// an aligned base; scalar loads otherwise). Each position is binned once
// into a uint8 stage in shared memory, with zero bytes before position 0
// and past the prefix. The window max is taken from the staged words four
// positions at a time: for the main path's window 7 from three words whose
// middle word lies in all four windows (pool7), for any other window as a
// byte-wise __vmaxu4 over funnel-shifted words. Each pooled bin goes to a
// shared histogram by an atomic; positions past the prefix get none: every
// valid bin is >= 1 and pools to >= 1, so bin 0 counts N - min(len, N).
// After a barrier warp 0 scans the histogram to the threshold
// (warp_threshold) while the other warps write the histogram whole and zero
// the bins past the prefix (16 B stores): no global atomics, no ticket,
// nothing zeroed beforehand, one launch per call. A prefix whose stage does
// not fit the opt-in shared memory is walked in chunks, each carrying the
// previous chunk's edge bins. Measured against other shapes (PERF.md):
// several CTAs per row merging through global atomics and a self-resetting
// ticket, runs of equal bins added as one (across a warp or within a word),
// per-warp sub-histograms, and 256-1,024 threads were all slower.
//
// B10 replaces src/repro/kernels/maxpool/kernel.py::maxpool_pallas: the
// stride-1 max-pool of (BH, N) uint8 bins on its own, zero past the row's
// ends (the reuse tree's shift fill). Bound: bytes (1 B in, 1 B out per
// position). A row is cut into 16 B vectors from its first 16 B boundary
// (the few bytes before it and after the last whole vector form a partial
// vector each, read and written a byte at a time, 0 outside the row); the
// output rows share the input rows' alignment (the wrapper allocates them
// so), so every whole vector is one 16 B load and one 16 B store. A thread
// owns one vector. Windows up to 33 (HALO <= 16) pool in registers: the
// halo words come from the neighbouring lanes by shuffles and, at a warp's
// edges, from one extra vector load; the max runs byte-wise on words
// (__vmaxu4 over funnel-shifted words, the offsets known at compile time),
// window 7 by B9's pool7. Wider windows stage a CTA's run of vectors and
// its halo as uint8 in shared memory and pool by doubling (m_2s[b] =
// max(m_s[b], m_s[b + s]), log2(window) steps over the whole stage), the
// window then the max of two overlapping power-of-two windows, so the cost
// per position grows with log2(window), not with the window.
//
// B11 replaces src/repro/kernels/hist_topk/kernel.py::hist_threshold_pallas:
// the 256-bin histogram of (BH, N) uint8 bins and its reverse scan to the
// threshold. One CTA of 512 threads per row: two 16 B loads per thread
// issued together from the row's first 16 B boundary (the few bytes before
// it and after the last whole 16 B one at a time); each warp adds its bins
// to its own 1 KB sub-histogram in shared memory, an atomic per bin, so
// that a skewed row does not serialise the CTA on a few words; the
// sub-histograms are summed once and finish_row writes the histogram and
// the threshold as in B9. Bound: bytes (1 B in per position). Runs of equal
// bins merged across a warp's lanes, or 16 equal bins of a load added as
// one, cost more than they saved on uniform bins (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NUM_BINS = 256;

constexpr unsigned FULL = 0xffffffffu;
constexpr int B5_WARPS = 8;                 // warps per CTA
constexpr int B5_WARP_ITEMS = 3;            // a warp's items, their loads issued together

// binning_affine's bin of one valid score (IEEE division, ties to even)
__device__ __forceinline__ int bin_of(float x, float offset, float scale) {
  const float y = __fdiv_rn(__fsub_rn(x, offset), scale);
  return (int)fminf(fmaxf(__fadd_rn(rintf(y), 1.f), 1.f), 255.f);
}

// Add the warp's 32 values p (a bin, or NUM_BINS for no position) to a row's
// histogram: equal neighbouring lanes form a run, whose first lane adds the
// run's length (pooling makes runs; exact integer counts). Bin 0, the most
// common, is left to the caller: the count of its lanes is returned.
__device__ __forceinline__ int count_runs(int p, int32_t* hist_row) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(FULL, p, 1);
  const bool head = lane == 0 || p != prev;
  const unsigned heads = __ballot_sync(FULL, head);
  if (head && p > 0 && p < NUM_BINS) {
    const unsigned later = heads & ~((2u << lane) - 1u);
    atomicAdd(&hist_row[p], (later ? __ffs(later) - 1 : 32) - lane);
  }
  return __popc(__ballot_sync(FULL, p == 0));
}

// B5. Grid (CPR, S*KV): a row's warp items are dealt round its CPR CTAs and
// their warps, warp w of CTA x taking items x + CPR*(w + B5_WARPS*k) for k <
// B5_WARP_ITEMS, so that a slot's valid prefix spreads evenly over them.
// SHFL (block size SEG, a power of two <= 32): an item is a warp unit, 32
// consecutive positions (32/SEG whole blocks); a lane holds one position,
// takes its block's halo columns from the lanes t < HALO of its segment and
// pools with shuffles. Otherwise an item is one block, binned into the
// warp's stage in shared memory and pooled from there in chunks of 32.
// Either way a warp reads the validity first: an item with nothing valid
// gets zero bins and adds its positions to bin 0, reading no score, halo
// column or force byte; elsewhere scores and force bytes are read at valid
// positions only. The histogram is the zeroed global one: runs go to it
// with atomics, bin 0 once per warp.
template <bool SHFL>
__global__ void __launch_bounds__(B5_WARPS * 32) paged_fused_select_kernel(
    const float* __restrict__ scores,       // (S, KV, MB, BS)
    const float* __restrict__ lo,           // (S, KV)
    const float* __restrict__ hi,           // (S, KV)
    const uint8_t* __restrict__ from_left,  // (S, KV, MB, HALO)
    const uint8_t* __restrict__ from_right, // (S, KV, MB, HALO)
    const uint8_t* __restrict__ blk_valid,  // (S, MB, BS)
    const uint8_t* __restrict__ force,      // (S, MB, BS)
    uint8_t* __restrict__ pooled,           // (S, KV, MB, BS)
    int32_t* __restrict__ hist,             // (S, KV, 256), zeroed
    int KV, int MB, int BS, int HALO) {
  extern __shared__ uint8_t stage[];        // !SHFL: per warp, HALO + BS + HALO bins
  const int row = blockIdx.y;               // s * KV + kv
  const int s = row / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t N = (size_t)MB * BS;
  const float* srow = scores + (size_t)row * N;
  const uint8_t* vrow = blk_valid + (size_t)s * N;
  const uint8_t* frow = force + (size_t)s * N;
  const uint8_t* lrow = from_left + (size_t)row * MB * HALO;
  const uint8_t* rrow = from_right + (size_t)row * MB * HALO;
  uint8_t* prow = pooled + (size_t)row * N;
  int32_t* hrow = hist + (size_t)row * NUM_BINS;
  const float l = lo[row];
  const float offset = isfinite(l) ? l : 0.f;
  const float scale = fmaxf(__fdiv_rn(__fsub_rn(hi[row], offset), 254.f), 1e-6f);
  const int first = blockIdx.x + gridDim.x * warp, stride = gridDim.x * B5_WARPS;
  int zeros = 0;                            // this warp's positions in bin 0
  if constexpr (SHFL) {
    const int SEG = BS;
    const int units = (int)((N + 31) / 32);
    const int base = lane & ~(SEG - 1), t = lane & (SEG - 1);
    const unsigned seg_bits = SEG == 32 ? FULL : ((1u << SEG) - 1u) << base;
    int v[B5_WARP_ITEMS];
    unsigned any[B5_WARP_ITEMS];
#pragma unroll
    for (int k = 0; k < B5_WARP_ITEMS; ++k) {
      const size_t pos = (size_t)(first + k * stride) * 32 + lane;
      v[k] = first + k * stride < units && pos < N ? vrow[pos] : 0;
    }
#pragma unroll
    for (int k = 0; k < B5_WARP_ITEMS; ++k) any[k] = __ballot_sync(FULL, v[k]);
    float x[B5_WARP_ITEMS];
    int f[B5_WARP_ITEMS], halo[B5_WARP_ITEMS];
#pragma unroll
    for (int k = 0; k < B5_WARP_ITEMS; ++k) {
      const size_t pos = (size_t)(first + k * stride) * 32 + lane;
      x[k] = v[k] ? srow[pos] : 0.f;
      f[k] = v[k] ? frow[pos] : 0;
      halo[k] = 0;
      if (t < HALO && (any[k] & seg_bits)) {
        const size_t h = pos / SEG * HALO + t;
        halo[k] = lrow[h] | (rrow[h] << 8);
      }
    }
#pragma unroll
    for (int k = 0; k < B5_WARP_ITEMS; ++k) {
      const int u = first + k * stride;
      if (u >= units) break;
      const size_t pos = (size_t)u * 32 + lane;
      const bool in = pos < N;
      if (!any[k]) {
        if (in) prow[pos] = 0;
        zeros += N - (size_t)u * 32 < 32 ? (int)(N - (size_t)u * 32) : 32;
        continue;
      }
      const int bin = v[k] ? bin_of(x[k], offset, scale) : 0;
      // lane t's bin in byte 0, from_left[t] and from_right[t] in bytes 1 and 2
      const int pk = bin | (halo[k] << 8);
      int p = bin;
      for (int d = 1; d <= HALO; ++d) {
        const int il = t - d, ir = t + d;
        const int vl = __shfl_sync(FULL, pk, base + (il >= 0 ? il : HALO + il));
        const int vr = __shfl_sync(FULL, pk, base + (ir < SEG ? ir : ir - SEG));
        p = max(p, il >= 0 ? vl & 255 : (vl >> 8) & 255);
        p = max(p, ir < SEG ? vr & 255 : (vr >> 16) & 255);
      }
      if (bin == 0) p = 0;                  // pooling never revives a masked slot
      if (v[k] && f[k]) p = 255;
      if (in) prow[pos] = (uint8_t)p;
      zeros += count_runs(in ? p : NUM_BINS, hrow);
    }
  } else {
    uint8_t* st = stage + (size_t)warp * ((BS + 2 * HALO + 15) & ~15);
    for (int j = first; j < MB; j += stride) {
      const size_t b0 = (size_t)j * BS;
      bool any = false;
      for (int t = lane; t < BS; t += 32) any |= vrow[b0 + t] != 0;
      if (!__any_sync(FULL, any)) {
        for (int t = lane; t < BS; t += 32) prow[b0 + t] = 0;
        zeros += BS;
        continue;
      }
      for (int t = lane; t < BS; t += 32)
        st[HALO + t] = vrow[b0 + t] ? (uint8_t)bin_of(srow[b0 + t], offset, scale) : 0;
      for (int c = lane; c < HALO; c += 32) {
        st[c] = lrow[(size_t)j * HALO + c];
        st[HALO + BS + c] = rrow[(size_t)j * HALO + c];
      }
      __syncwarp();
      for (int t0 = 0; t0 < BS; t0 += 32) {
        const int t = t0 + lane;
        int p = NUM_BINS;
        if (t < BS) {
          p = st[HALO + t];
          if (p > 0) {                      // window [t - HALO, t + HALO] of the block
            for (int o = 0; o <= 2 * HALO; ++o) p = max(p, (int)st[t + o]);
          }
          if (vrow[b0 + t] && frow[b0 + t]) p = 255;
          prow[b0 + t] = (uint8_t)p;
        }
        zeros += count_runs(p, hrow);
      }
      __syncwarp();                         // the stage is rewritten for the next block
    }
  }
  if (lane == 0 && zeros) atomicAdd(&hrow[0], zeros);
}

// One warp's threshold of a row's 256-bin histogram in shared memory (16 B
// aligned): the largest bin whose reverse cumulative count reaches k, never
// below 1. Lane l takes bins 8l .. 8l + 7: suffix sums in the lane, then the
// later lanes' totals by shuffles. The suffix sums fall as the bin grows, so
// the bins that reach k are 0 .. t and t + 1 is their count.
__device__ __forceinline__ int warp_threshold(const int32_t* hist_sh, int k) {
  const int lane = threadIdx.x & 31;
  const int4 a = reinterpret_cast<const int4*>(hist_sh)[2 * lane];
  const int4 b = reinterpret_cast<const int4*>(hist_sh)[2 * lane + 1];
  int s[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 6; i >= 0; --i) s[i] += s[i + 1];
  int later = s[0];                         // this lane's and the later lanes' total
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_down_sync(FULL, later, d);
    if (lane + d < 32) later += v;
  }
  later -= s[0];
  int reached = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) reached += s[i] + later >= k;
  return max(__reduce_add_sync(FULL, reached) - 1, 1);
}

// zero n bytes from p: single bytes up to the first 16 B boundary, 16 B
// stores, single bytes after the last whole 16 B; thread u of `threads`
__device__ __forceinline__ void zero_bytes(uint8_t* p, int n, int u, int threads) {
  const int head = min((int)((16 - ((uintptr_t)p & 15)) & 15), n);
  const int nvec = (n - head) >> 4;
  for (int i = u; i < head; i += threads) p[i] = 0;
  uint4* pv = reinterpret_cast<uint4*>(p + head);
  for (int i = u; i < nvec; i += threads) pv[i] = make_uint4(0, 0, 0, 0);
  for (int i = head + 16 * nvec + u; i < n; i += threads) p[i] = 0;
}

// Warp 0 writes the row's threshold; the other warps write its histogram
// (16 B stores) and zero the n pooled bins from z. After a barrier.
__device__ __forceinline__ void finish_row(const int32_t* hist_sh, int k, int32_t* hist_row,
                                           int32_t* thr_row, uint8_t* z, int n) {
  const int t = threadIdx.x;
  if (t < 32) {
    const int tr = warp_threshold(hist_sh, k);
    if (t == 0) *thr_row = tr;
  } else {
    for (int i = t - 32; i < NUM_BINS / 4; i += blockDim.x - 32)
      reinterpret_cast<int4*>(hist_row)[i] = reinterpret_cast<const int4*>(hist_sh)[i];
    zero_bytes(z, n, t - 32, blockDim.x - 32);
  }
}

constexpr int B9_THREADS = 640;
constexpr int B9_BATCH = 4;                 // stage words per thread whose loads go out together
constexpr int B9_SLACK = 16;                // stage bytes read past its end, never used

// the scores of positions x .. x + 3 of a row below m (x % 4 == 0; 0 at or
// past m, where nothing is read): one 16 B load where VEC and x + 4 <= m
template <bool VEC>
__device__ __forceinline__ void load_word(const float* __restrict__ srow, int x, int m,
                                          float (&f)[4]) {
  if (VEC && x + 4 <= m) {
    const float4 q = *reinterpret_cast<const float4*>(srow + x);
    f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = x + i < m ? srow[x + i] : 0.f;
  }
}

// the bins of those positions packed in a word (position x in the low
// byte, 0 at or past m)
__device__ __forceinline__ uint32_t bin_word(const float (&f)[4], int x, int m, float offset,
                                             float scale) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (x + i < m) w |= (uint32_t)bin_of(f[i], offset, scale) << (8 * i);
  }
  return w;
}

// Window 7 over the bytes c0 .. c11 of the words a0, a1, a2 (c0 the low
// byte of a0): byte i of the result is max(c[1 + i] .. c[7 + i]). Every
// window holds all of a1, whose max is taken once.
__device__ __forceinline__ uint32_t pool7(uint32_t a0, uint32_t a1, uint32_t a2) {
  const auto c = [](uint32_t w, int i) { return (w >> (8 * i)) & 255u; };
  const uint32_t mid = max(__vimax3_u32(c(a1, 0), c(a1, 1), c(a1, 2)), c(a1, 3));
  const uint32_t l = max(c(a0, 2), c(a0, 3)), r = max(c(a2, 0), c(a2, 1));
  return __vimax3_u32(mid, c(a0, 1), l) | __vimax3_u32(mid, l, c(a2, 0)) << 8 |
         __vimax3_u32(mid, c(a0, 3), r) << 16 | __vimax3_u32(mid, r, c(a2, 2)) << 24;
}

// B9. Grid (BH,). The stage holds the bins of positions c0 - PAD ..
// c0 + C + PAD of the current chunk (PAD = HALO rounded up to 4), position
// x at byte PAD + x - c0. VEC: N % 4 == 0 and the scores 16 B aligned.
// HC: HALO known at compile time (3, the main path's window 7, pooled by
// pool7), or -1.
template <bool VEC, int HC>
__global__ void __launch_bounds__(B9_THREADS) fused_bin_pool_threshold_kernel(
    const float* __restrict__ scores,       // (BH, N)
    const float* __restrict__ lo,           // (BH,)
    const float* __restrict__ hi,           // (BH,)
    const int32_t* __restrict__ k,          // (BH,)
    const int32_t* __restrict__ lengths,    // (BH,)
    uint8_t* __restrict__ pooled,           // (BH, N)
    int32_t* __restrict__ hist,             // (BH, 256)
    int32_t* __restrict__ thr,              // (BH,)
    int N, int halo, int C) {               // C: positions per chunk, a multiple of 4
  extern __shared__ uint32_t words_sh[];    // the stage: (PAD + C + PAD + B9_SLACK) bytes
  __shared__ __align__(16) int32_t hist_sh[NUM_BINS];
  const int row = blockIdx.x, t = threadIdx.x;
  const int HALO = HC >= 0 ? HC : halo;
  const int PAD = (HALO + 3) & ~3;
  const float* srow = scores + (size_t)row * N;
  uint8_t* prow = pooled + (size_t)row * N;
  const float offset = lo[row];
  const float scale = fmaxf(__fdiv_rn(__fsub_rn(hi[row], offset), 254.f), 1e-6f);
  const int m = min(max(lengths[row], 0), N);
  const int kr = k[row];
  const int m4 = (m + 3) & ~3;
  for (int i = t; i < NUM_BINS; i += B9_THREADS) hist_sh[i] = i == 0 ? N - m : 0;
  uint32_t carry = 0;
  for (int c0 = 0; c0 < m; c0 += C) {
    // stage: zeros before position 0, or the previous chunk's edge words;
    // then the bins of the positions up to the chunk's end + PAD
    const int fresh = c0 == 0 ? PAD / 4 : PAD / 2;
    if (c0 == 0) {
      for (int j = t; j < fresh; j += B9_THREADS) words_sh[j] = 0;
    } else if (t < fresh) {
      words_sh[t] = carry;
    }
    const int words = (2 * PAD + min(C, m4 - c0)) / 4;
    for (int j0 = fresh + t; j0 < words; j0 += B9_BATCH * B9_THREADS) {
      float f[B9_BATCH][4];
#pragma unroll
      for (int u = 0; u < B9_BATCH; ++u) {
        const int j = j0 + u * B9_THREADS;
        load_word<VEC>(srow, c0 - PAD + 4 * j, j < words ? m : 0, f[u]);
      }
#pragma unroll
      for (int u = 0; u < B9_BATCH; ++u) {
        const int j = j0 + u * B9_THREADS;
        if (j < words) words_sh[j] = bin_word(f[u], c0 - PAD + 4 * j, m, offset, scale);
      }
    }
    __syncthreads();
    // pool and count the words of positions 4w .. 4w + 3
    const int w1 = (min(c0 + C, m) + 3) / 4;
    for (int w = c0 / 4 + t; w < w1; w += B9_THREADS) {
      uint32_t p = 0;
      if constexpr (HC == 3) {
        const int lw = w - c0 / 4;          // positions 4w - 4 .. 4w + 7 in 3 words
        p = pool7(words_sh[lw], words_sh[lw + 1], words_sh[lw + 2]);
      } else {
        // the 4 bytes from stage byte b + o are the o-th shift of the window
        const int b = PAD - HALO + 4 * (w - c0 / 4);
        int wi = b >> 2, sh = (b & 3) * 8;
        uint32_t a0 = words_sh[wi], a1 = words_sh[wi + 1];
        for (int o = 0; o <= 2 * HALO; ++o) {
          p = __vmaxu4(p, __funnelshift_r(a0, a1, sh));
          sh += 8;
          if (sh == 32) {
            sh = 0;
            a0 = a1;
            a1 = words_sh[++wi + 1];
          }
        }
      }
      const int x = 4 * w;
      if (x + 4 > m) p &= (1u << (8 * (m - x))) - 1u;     // zero where the centre is 0
      if (VEC) {
        *reinterpret_cast<uint32_t*>(prow + x) = p;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (x + i < N) prow[x + i] = (uint8_t)(p >> (8 * i));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (x + i < m) atomicAdd(&hist_sh[(p >> (8 * i)) & 255u], 1);
      }
    }
    if (c0 + C < m && t < PAD / 2) carry = words_sh[C / 4 + t];
    __syncthreads();
  }
  if (m == 0) __syncthreads();
  finish_row(hist_sh, kr, hist + (size_t)row * NUM_BINS, thr + row, prow + min(m4, N),
             N - min(m4, N));
}

constexpr int B10_THREADS = 256;           // register path: a vector (16 positions) per thread
constexpr int B10_WIDE_THREADS = 256;      // staged path: likewise, plus the stage's halo

// A row of n bins at x as 16 B vectors: h bytes before its first 16 B
// boundary, nvec whole vectors from there; vector v holds positions
// h + 16v .. h + 16v + 15 (v = -1: the head, v = nvec: the tail).
struct RowVecs {
  int h, nvec, lo, hi;                     // lo .. hi: the vectors holding a position
  __device__ __forceinline__ RowVecs(const uint8_t* x, int n) {
    h = min((int)((16 - ((uintptr_t)x & 15)) & 15), n);
    nvec = (n - h) >> 4;
    lo = h ? -1 : 0;
    hi = ((n - h) & 15) ? nvec : nvec - 1;
  }
};

// vector v of the row (any v): one 16 B load where it is whole, else byte
// loads, 0 outside the row
__device__ __forceinline__ uint4 load_vec(const uint8_t* __restrict__ x, int n,
                                          const RowVecs& r, int v) {
  if (v >= 0 && v < r.nvec) return reinterpret_cast<const uint4*>(x + r.h)[v];
  uint32_t w[4] = {0, 0, 0, 0};
  const int p0 = r.h + 16 * v;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int p = p0 + i;
    if (p >= 0 && p < n) w[i >> 2] |= (uint32_t)x[p] << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// write vector v's positions inside the row (y aligned as x)
__device__ __forceinline__ void store_vec(uint8_t* __restrict__ y, int n, const RowVecs& r,
                                          int v, const uint32_t (&w)[4]) {
  if (v >= 0 && v < r.nvec) {
    reinterpret_cast<uint4*>(y + r.h)[v] = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  const int p0 = r.h + 16 * v;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int p = p0 + i;
    if (p >= 0 && p < n) y[p] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
}

// the 4 bytes from byte b of the word array a (a[i] holds bytes 4i .. 4i + 3)
__device__ __forceinline__ uint32_t bytes_at(const uint32_t* a, int b) {
  const int i = b >> 2, sh = (b & 3) * 8;
  return sh ? __funnelshift_r(a[i], a[i + 1], sh) : a[i];
}

// B10, HALO <= 16. Grid (ceil(vectors / B10_THREADS), BH): thread g of a row
// pools vector lo + g. Its words w[NW .. NW + 3], the last NW words of the
// vector before in w[0 .. NW - 1] and the first NW of the vector after in
// w[NW + 4 ..], from the neighbouring lanes (lanes 0 and 31 load them).
template <int HALO>
__global__ void __launch_bounds__(B10_THREADS) maxpool_u8_kernel(
    const uint8_t* __restrict__ bins,      // (BH, N)
    uint8_t* __restrict__ pooled,          // (BH, N), aligned as bins
    int N) {
  constexpr int NW = (HALO + 3) / 4;
  const int lane = threadIdx.x & 31;
  const uint8_t* x = bins + (size_t)blockIdx.y * N;
  const RowVecs r(x, N);
  const int v = r.lo + blockIdx.x * B10_THREADS + threadIdx.x;
  if (v - lane > r.hi) return;             // the whole warp past the row
  const uint4 q = load_vec(x, N, r, v);
  uint4 e = make_uint4(0, 0, 0, 0);
  if (lane == 0) e = load_vec(x, N, r, v - 1);
  if (lane == 31) e = load_vec(x, N, r, v + 1);
  const uint32_t own[4] = {q.x, q.y, q.z, q.w}, edge[4] = {e.x, e.y, e.z, e.w};
  uint32_t w[2 * NW + 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[NW + i] = own[i];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t l = __shfl_up_sync(FULL, own[4 - NW + i], 1);
    const uint32_t rt = __shfl_down_sync(FULL, own[i], 1);
    w[i] = lane == 0 ? edge[4 - NW + i] : l;
    w[NW + 4 + i] = lane == 31 ? edge[i] : rt;
  }
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (HALO == 3) {
      out[j] = pool7(w[NW + j - 1], w[NW + j], w[NW + j + 1]);
    } else {
      uint32_t p = 0;
#pragma unroll
      for (int o = -HALO; o <= HALO; ++o) p = __vmaxu4(p, bytes_at(w, 4 * (NW + j) + o));
      out[j] = p;
    }
  }
  if (v <= r.hi) store_vec(pooled + (size_t)blockIdx.y * N, N, r, v, out);
}

// B10, HALO > 16. Grid (ceil(vectors / B10_WIDE_THREADS), BH): a CTA pools
// the row's vectors v0 .. v0 + B10_WIDE_THREADS - 1, staged with HV vectors
// of halo on each side. The doubling leaves m_P (P: the largest power of two
// <= 2 HALO + 1) in the stage; position q pools max(m_P[q - HALO],
// m_P[q + HALO - P + 1]), two windows that together cover q's.
__global__ void __launch_bounds__(B10_WIDE_THREADS) maxpool_u8_wide_kernel(
    const uint8_t* __restrict__ bins,      // (BH, N)
    uint8_t* __restrict__ pooled,          // (BH, N), aligned as bins
    int N, int HALO, int HV, int P) {
  extern __shared__ uint4 stage_v[];       // two stages of SV vectors
  const int t = threadIdx.x;
  const uint8_t* x = bins + (size_t)blockIdx.y * N;
  const RowVecs r(x, N);
  const int v0 = r.lo + blockIdx.x * B10_WIDE_THREADS;
  if (v0 > r.hi) return;
  const int SV = B10_WIDE_THREADS + 2 * HV;
  uint32_t* a = reinterpret_cast<uint32_t*>(stage_v);
  uint32_t* b = a + 4 * SV;
  for (int i = t; i < SV; i += B10_WIDE_THREADS) stage_v[i] = load_vec(x, N, r, v0 - HV + i);
  __syncthreads();
  const int words = 4 * SV;
  for (int s = 1; s < P; s <<= 1) {        // a: m_s -> b: m_2s; words past the stage read 0
    for (int i = t; i < words; i += B10_WIDE_THREADS) {
      const int k = i + (s >> 2), sh = (s & 3) * 8;
      const uint32_t lo = k < words ? a[k] : 0u, hi = k + 1 < words ? a[k + 1] : 0u;
      b[i] = __vmaxu4(a[i], sh ? __funnelshift_r(lo, hi, sh) : lo);
    }
    __syncthreads();
    uint32_t* tmp = a;
    a = b;
    b = tmp;
  }
  uint32_t out[4];
  const int q = 16 * (HV + t);             // this thread's vector in the stage
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __vmaxu4(bytes_at(a, q + 4 * j - HALO), bytes_at(a, q + 4 * j + HALO - P + 1));
  if (v0 + t <= r.hi) store_vec(pooled + (size_t)blockIdx.y * N, N, r, v0 + t, out);
}

constexpr int B11_THREADS = 512;
constexpr int B11_WARPS = B11_THREADS / 32;
constexpr int B11_VEC = 2;                  // 16 B loads per thread issued together

// B11. Grid (BH,): hist[r] = the 256-bin histogram of bins[r], thr[r] its
// threshold for k[r] (k_all for every row where k is null)
__global__ void __launch_bounds__(B11_THREADS) hist_threshold_kernel(
    const uint8_t* __restrict__ bins,       // (BH, N)
    const int32_t* __restrict__ k,          // (BH,) or null
    int k_all,
    int32_t* __restrict__ hist,             // (BH, 256)
    int32_t* __restrict__ thr,              // (BH,)
    int N) {
  __shared__ __align__(16) int32_t sub[B11_WARPS][NUM_BINS];
  const int row = blockIdx.x, t = threadIdx.x;
  const uint8_t* x = bins + (size_t)row * N;
  const int kr = k ? k[row] : k_all;
  const int head = min((int)((16 - ((uintptr_t)x & 15)) & 15), N);
  const int nvec = (N - head) >> 4;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4 q[B11_VEC];
#pragma unroll
  for (int u = 0; u < B11_VEC; ++u) {
    const int i = t + u * B11_THREADS;
    q[u] = i < nvec ? xv[i] : make_uint4(0, 0, 0, 0);
  }
  for (int i = t; i < B11_WARPS * NUM_BINS / 4; i += B11_THREADS)
    reinterpret_cast<int4*>(&sub[0][0])[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  int32_t* mine = sub[t >> 5];
  for (int i0 = 0; i0 < nvec; i0 += B11_VEC * B11_THREADS) {
#pragma unroll
    for (int u = 0; u < B11_VEC; ++u) {
      const int i = i0 + t + u * B11_THREADS;
      if (i0 > 0) q[u] = i < nvec ? xv[i] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < B11_VEC; ++u) {
      if (i0 + t + u * B11_THREADS >= nvec) break;
      const uint32_t wd[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
      for (int b = 0; b < 16; ++b) atomicAdd(&mine[(wd[b >> 2] >> (8 * (b & 3))) & 255u], 1);
    }
  }
  for (int i = t; i < head; i += B11_THREADS) atomicAdd(&mine[x[i]], 1);
  for (int i = head + 16 * nvec + t; i < N; i += B11_THREADS) atomicAdd(&mine[x[i]], 1);
  __syncthreads();
  if (t < NUM_BINS) {
    int h = 0;
#pragma unroll
    for (int w = 0; w < B11_WARPS; ++w) h += sub[w][t];
    sub[0][t] = h;
  }
  __syncthreads();
  finish_row(sub[0], kr, hist + (size_t)row * NUM_BINS, thr + row, nullptr, 0);
}

}  // namespace

extern "C" int paged_fused_select(const void* scores, const void* lo, const void* hi,
                                  const void* from_left, const void* from_right,
                                  const void* blk_valid, const void* force, void* pooled,
                                  void* hist, int S, int KV, int MB, int BS, int HALO,
                                  void* stream) {
  if (BS < 1 || MB < 1 || HALO < 0 || HALO > BS) return (int)cudaErrorInvalidValue;
  const bool shfl = BS <= 32 && (BS & (BS - 1)) == 0;
  // warp items: units of 32 positions, or blocks; B5_WARP_ITEMS per warp
  const long long items = shfl ? ((long long)MB * BS + 31) / 32 : MB;
  const long long per_cta = (long long)B5_WARPS * B5_WARP_ITEMS;
  const dim3 grid((unsigned)((items + per_cta - 1) / per_cta), S * KV);
  const size_t smem = shfl ? 0 : (size_t)B5_WARPS * ((BS + 2 * HALO + 15) & ~15);
  const auto kernel = shfl ? &paged_fused_select_kernel<true> : &paged_fused_select_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, B5_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)lo, (const float*)hi, (const uint8_t*)from_left,
      (const uint8_t*)from_right, (const uint8_t*)blk_valid, (const uint8_t*)force,
      (uint8_t*)pooled, (int32_t*)hist, KV, MB, BS, HALO);
  return (int)cudaGetLastError();
}

extern "C" int fused_bin_pool_threshold(const void* scores, const void* lo, const void* hi,
                                        const void* k, const void* lengths, void* pooled,
                                        void* hist, void* thr, int BH, int N, int HALO,
                                        void* stream) {
  if (HALO < 0 || HALO > 1024 || N < 1) return (int)cudaErrorInvalidValue;
  const int pad = (HALO + 3) & ~3;
  // one chunk holds the whole row where its stage fits the opt-in shared memory
  int chunk = (N + 3) & ~3;
  size_t smem = (size_t)2 * pad + chunk + B9_SLACK;
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    const int budget = optin - NUM_BINS * 4 - 1024;   // static + margin
    if ((long long)smem > budget) {
      chunk = (budget - 2 * pad - B9_SLACK) / 128 * 128;   // >= 2 * pad: carries stay apart
      smem = (size_t)2 * pad + chunk + B9_SLACK;
    }
  }
  const bool vec = N % 4 == 0 && ((uintptr_t)scores & 15) == 0;
  const auto kernel =
      HALO == 3 ? (vec ? &fused_bin_pool_threshold_kernel<true, 3>
                       : &fused_bin_pool_threshold_kernel<false, 3>)
                : (vec ? &fused_bin_pool_threshold_kernel<true, -1>
                       : &fused_bin_pool_threshold_kernel<false, -1>);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<BH, B9_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)lo, (const float*)hi, (const int32_t*)k,
      (const int32_t*)lengths, (uint8_t*)pooled, (int32_t*)hist, (int32_t*)thr, N, HALO, chunk);
  return (int)cudaGetLastError();
}

extern "C" int maxpool_u8(const void* bins, void* pooled, int BH, int N, int HALO,
                          void* stream) {
  if (HALO < 1 || HALO > 1024 || N < 1 || BH < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)bins ^ (uintptr_t)pooled) & 15) return (int)cudaErrorMisalignedAddress;
  // vectors per row: N / 16 where every row starts on a 16 B boundary, else
  // at most a partial head, the whole vectors and a partial tail
  const int vecs = ((uintptr_t)bins & 15) == 0 && N % 16 == 0 ? N / 16 : (N + 15) / 16 + 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (HALO > 16) {
    const int hv = (HALO + 15) / 16;
    int p = 1;
    while (2 * p <= 2 * HALO + 1) p *= 2;
    const size_t smem = (size_t)2 * (B10_WIDE_THREADS + 2 * hv) * 16;
    const dim3 grid((vecs + B10_WIDE_THREADS - 1) / B10_WIDE_THREADS, BH);
    maxpool_u8_wide_kernel<<<grid, B10_WIDE_THREADS, smem, st>>>(
        (const uint8_t*)bins, (uint8_t*)pooled, N, HALO, hv, p);
    return (int)cudaGetLastError();
  }
  const dim3 grid((vecs + B10_THREADS - 1) / B10_THREADS, BH);
  const uint8_t* x = (const uint8_t*)bins;
  uint8_t* y = (uint8_t*)pooled;
  switch (HALO) {
#define B10_CASE(H) \
    case H: maxpool_u8_kernel<H><<<grid, B10_THREADS, 0, st>>>(x, y, N); break;
    B10_CASE(1) B10_CASE(2) B10_CASE(3) B10_CASE(4) B10_CASE(5) B10_CASE(6) B10_CASE(7)
    B10_CASE(8) B10_CASE(9) B10_CASE(10) B10_CASE(11) B10_CASE(12) B10_CASE(13)
    B10_CASE(14) B10_CASE(15) B10_CASE(16)
#undef B10_CASE
  }
  return (int)cudaGetLastError();
}

extern "C" int hist_threshold(const void* bins, const void* k, int k_all, void* hist,
                              void* thr, int BH, int N, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  hist_threshold_kernel<<<BH, B11_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const int32_t*)k, k_all, (int32_t*)hist, (int32_t*)thr, N);
  return (int)cudaGetLastError();
}
