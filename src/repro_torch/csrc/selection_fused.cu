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
// lengths[r] and 0 past it; the max-pool's halo columns are bins recomputed
// from the neighbouring positions' scores in memory, 0 past the row's ends;
// a pooled bin is 0 where its centre bin is 0; then the 256-bin histogram
// and the threshold: the largest bin whose reverse cumulative count is at
// least k[r], never below 1 (histogram_topk.locate_threshold).
//
// Bound on this card: bytes — 4 B of score in (plus 2 B of valid/force for
// B5) and 1 B of pooled bin out per position; a few dozen integer ops each.
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
// B9 design: one CTA per (run of positions, row), one thread per position.
// The run's bins and their halo columns sit in shared memory for the pool;
// the histogram accumulates in shared memory and is added into the zeroed
// global histogram with one atomic per non-empty bin (exact integer counts,
// so the order of the adds does not matter). The TPU kernels carry the
// histogram in scratch across their sequential block axis; here the runs of
// a row are parallel CTAs, so B9 hands the threshold to the row's last CTA:
// each CTA fences its histogram adds and takes a ticket from a per-row
// counter, and the CTA that draws the last ticket reads the complete
// histogram back (through L2) and runs the reverse scan.
//
// B10 replaces src/repro/kernels/maxpool/kernel.py::maxpool_pallas: the
// stride-1 max-pool of (BH, N) uint8 bins on its own, zero past the row's
// ends (the reuse tree's shift fill). B11 replaces
// src/repro/kernels/hist_topk/kernel.py::hist_threshold_pallas: the 256-bin
// histogram of (BH, N) uint8 bins and its reverse scan to the threshold.
// Both are B9's stages without the binning, built from the same device
// functions (window_max, flush_histogram, last_cta_threshold) and the same
// CTA shape: a run of B9_RUN positions per CTA, the row's last CTA scans.
// Bound: bytes (1 B in and 1 B out per position for B10, 1 B in for B11).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NUM_BINS = 256;

// max over the 2*HALO + 1 bins starting at b
__device__ __forceinline__ int window_max(const int32_t* b, int HALO) {
  int p = b[0];
  for (int o = 1; o <= 2 * HALO; ++o) p = max(p, b[o]);
  return p;
}

// add a CTA's shared histogram into the row's zeroed global one
__device__ __forceinline__ void flush_histogram(const int32_t* hist_sh, int32_t* hist_row) {
  for (int i = threadIdx.x; i < NUM_BINS; i += blockDim.x) {
    if (hist_sh[i]) atomicAdd(&hist_row[i], hist_sh[i]);
  }
}

// After flush_histogram: the row's CTA that draws the last ticket reads the
// complete histogram back and writes the threshold, the largest bin whose
// reverse cumulative count is at least k, never below 1. hist_sh is reused
// as scratch. Every thread of the CTA must call it.
__device__ void last_cta_threshold(int32_t* hist_sh, const int32_t* hist_row, int k,
                                   unsigned int* ticket_row, int32_t* thr_row) {
  __shared__ bool last;
  __threadfence();                          // this CTA's adds before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket_row, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < NUM_BINS; i += blockDim.x) hist_sh[i] = __ldcg(&hist_row[i]);
  __syncthreads();
  if (threadIdx.x == 0) {
    int cum = 0, t = 0;
    for (int b = NUM_BINS - 1; b >= 0; --b) {
      cum += hist_sh[b];
      if (cum >= k) {
        t = b;
        break;
      }
    }
    *thr_row = max(t, 1);
  }
}

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

constexpr int B9_THREADS = 256;
constexpr int B9_RUN = 1024;                // positions per CTA

__device__ __forceinline__ int32_t flat_bin(const float* __restrict__ row, int p, int N,
                                            int len, float lo, float scale) {
  if (p < 0 || p >= N || p >= len) return 0;
  const float x = __fdiv_rn(__fsub_rn(row[p], lo), scale);
  return (int32_t)fminf(fmaxf(__fadd_rn(rintf(x), 1.f), 1.f), 255.f);
}

__global__ void fused_bin_pool_threshold_kernel(
    const float* __restrict__ scores,       // (BH, N)
    const float* __restrict__ lo,           // (BH,)
    const float* __restrict__ hi,           // (BH,)
    const int32_t* __restrict__ k,          // (BH,)
    const int32_t* __restrict__ lengths,    // (BH,)
    uint8_t* __restrict__ pooled,           // (BH, N)
    int32_t* __restrict__ hist,             // (BH, 256), zeroed
    int32_t* __restrict__ thr,              // (BH,)
    unsigned int* __restrict__ ticket,      // (BH,), zeroed
    int N, int HALO) {
  extern __shared__ int32_t fsh[];
  int32_t* hist_sh = fsh;                   // (256)
  int32_t* buf = fsh + NUM_BINS;            // (HALO + run + HALO) bins
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * B9_RUN;
  const int nb = min(B9_RUN, N - c0);
  const float* s = scores + (size_t)row * N;
  const float l = lo[row];
  const float scale = fmaxf(__fdiv_rn(__fsub_rn(hi[row], l), 254.f), 1e-6f);
  const int len = lengths[row];
  for (int i = threadIdx.x; i < NUM_BINS; i += blockDim.x) hist_sh[i] = 0;
  for (int e = threadIdx.x; e < nb + 2 * HALO; e += blockDim.x) {
    buf[e] = flat_bin(s, c0 - HALO + e, N, len, l, scale);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nb; e += blockDim.x) {
    int p = buf[HALO + e];
    if (p > 0) p = window_max(buf + e, HALO);
    pooled[(size_t)row * N + c0 + e] = (uint8_t)p;
    atomicAdd(&hist_sh[p], 1);
  }
  __syncthreads();
  flush_histogram(hist_sh, hist + (size_t)row * NUM_BINS);
  last_cta_threshold(hist_sh, hist + (size_t)row * NUM_BINS, k[row], ticket + row, thr + row);
}

// B10: pooled[r, n] = max(bins[r, n - HALO .. n + HALO]), 0 past the ends
__global__ void maxpool_u8_kernel(const uint8_t* __restrict__ bins,  // (BH, N)
                                  uint8_t* __restrict__ pooled,      // (BH, N)
                                  int N, int HALO) {
  extern __shared__ int32_t msh[];          // (HALO + run + HALO) bins
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * B9_RUN;
  const int nb = min(B9_RUN, N - c0);
  const uint8_t* x = bins + (size_t)row * N;
  for (int e = threadIdx.x; e < nb + 2 * HALO; e += blockDim.x) {
    const int p = c0 - HALO + e;
    msh[e] = (p >= 0 && p < N) ? x[p] : 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nb; e += blockDim.x) {
    pooled[(size_t)row * N + c0 + e] = (uint8_t)window_max(msh + e, HALO);
  }
}

// B11: hist[r] = the 256-bin histogram of bins[r], thr[r] its threshold for k[r]
__global__ void hist_threshold_kernel(const uint8_t* __restrict__ bins,  // (BH, N)
                                      const int32_t* __restrict__ k,     // (BH,)
                                      int32_t* __restrict__ hist,        // (BH, 256), zeroed
                                      int32_t* __restrict__ thr,         // (BH,)
                                      unsigned int* __restrict__ ticket, // (BH,), zeroed
                                      int N) {
  __shared__ int32_t hist_sh[NUM_BINS];
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * B9_RUN;
  const int nb = min(B9_RUN, N - c0);
  const uint8_t* x = bins + (size_t)row * N + c0;
  for (int i = threadIdx.x; i < NUM_BINS; i += blockDim.x) hist_sh[i] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < nb; e += blockDim.x) atomicAdd(&hist_sh[x[e]], 1);
  __syncthreads();
  flush_histogram(hist_sh, hist + (size_t)row * NUM_BINS);
  last_cta_threshold(hist_sh, hist + (size_t)row * NUM_BINS, k[row], ticket + row, thr + row);
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
                                        void* hist, void* thr, void* ticket, int BH, int N,
                                        int HALO, void* stream) {
  if (HALO < 0 || HALO > B9_RUN) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + B9_RUN - 1) / B9_RUN, BH);
  const size_t smem = (NUM_BINS + (size_t)B9_RUN + 2 * HALO) * sizeof(int32_t);
  fused_bin_pool_threshold_kernel<<<grid, B9_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)lo, (const float*)hi, (const int32_t*)k,
      (const int32_t*)lengths, (uint8_t*)pooled, (int32_t*)hist, (int32_t*)thr,
      (unsigned int*)ticket, N, HALO);
  return (int)cudaGetLastError();
}

extern "C" int maxpool_u8(const void* bins, void* pooled, int BH, int N, int HALO,
                          void* stream) {
  if (HALO < 1 || HALO > B9_RUN || N < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + B9_RUN - 1) / B9_RUN, BH);
  const size_t smem = ((size_t)B9_RUN + 2 * HALO) * sizeof(int32_t);
  maxpool_u8_kernel<<<grid, B9_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (uint8_t*)pooled, N, HALO);
  return (int)cudaGetLastError();
}

extern "C" int hist_threshold(const void* bins, const void* k, void* hist, void* thr,
                              void* ticket, int BH, int N, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + B9_RUN - 1) / B9_RUN, BH);
  hist_threshold_kernel<<<grid, B9_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const int32_t*)k, (int32_t*)hist, (int32_t*)thr,
      (unsigned int*)ticket, N);
  return (int)cudaGetLastError();
}
