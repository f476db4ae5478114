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
// Design: one CTA per (run of positions, row), one thread per position. The
// run's bins and their halo columns sit in shared memory for the pool; the
// histogram accumulates in shared memory and is added into the zeroed
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

__global__ void paged_fused_select_kernel(
    const float* __restrict__ scores,       // (S, KV, MB, BS)
    const float* __restrict__ lo,           // (S, KV)
    const float* __restrict__ hi,           // (S, KV)
    const uint8_t* __restrict__ from_left,  // (S, KV, MB, HALO)
    const uint8_t* __restrict__ from_right, // (S, KV, MB, HALO)
    const uint8_t* __restrict__ blk_valid,  // (S, MB, BS)
    const uint8_t* __restrict__ force,      // (S, MB, BS)
    uint8_t* __restrict__ pooled,           // (S, KV, MB, BS)
    int32_t* __restrict__ hist,             // (S, KV, 256), zeroed
    int KV, int MB, int BS, int HALO, int BPC) {
  extern __shared__ int32_t sh[];
  int32_t* hist_sh = sh;                    // (256)
  int32_t* buf = sh + NUM_BINS;             // (BPC, HALO + BS + HALO)
  const int row = blockIdx.y;               // s * KV + kv
  const int s = row / KV;
  const int j0 = blockIdx.x * BPC;
  const int nb = min(BPC, MB - j0);
  const int W = BS + 2 * HALO;
  for (int i = threadIdx.x; i < NUM_BINS; i += blockDim.x) hist_sh[i] = 0;

  const float l = lo[row];
  const float offset = isfinite(l) ? l : 0.f;
  const float scale = fmaxf(__fdiv_rn(__fsub_rn(hi[row], offset), 254.f), 1e-6f);
  for (int e = threadIdx.x; e < nb * BS; e += blockDim.x) {
    const int jb = e / BS;
    const int t = e % BS;
    const size_t pos = (size_t)(j0 + jb) * BS + t;
    int bin = 0;
    if (blk_valid[(size_t)s * MB * BS + pos]) {
      const float x = __fdiv_rn(__fsub_rn(scores[(size_t)row * MB * BS + pos], offset), scale);
      bin = (int)fminf(fmaxf(__fadd_rn(rintf(x), 1.f), 1.f), 255.f);
    }
    buf[jb * W + HALO + t] = bin;
  }
  for (int e = threadIdx.x; e < nb * HALO; e += blockDim.x) {
    const int jb = e / HALO;
    const int c = e % HALO;
    const size_t src = ((size_t)row * MB + j0 + jb) * HALO + c;
    buf[jb * W + c] = from_left[src];
    buf[jb * W + HALO + BS + c] = from_right[src];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nb * BS; e += blockDim.x) {
    const int jb = e / BS;
    const int t = e % BS;
    const size_t pos = (size_t)(j0 + jb) * BS + t;
    const int32_t* b = buf + jb * W + t;    // window [t - HALO, t + HALO] of the block
    int p = b[HALO];
    if (p > 0) p = window_max(b, HALO);
    if (force[(size_t)s * MB * BS + pos] && blk_valid[(size_t)s * MB * BS + pos]) p = 255;
    pooled[(size_t)row * MB * BS + pos] = (uint8_t)p;
    atomicAdd(&hist_sh[p], 1);
  }
  __syncthreads();
  flush_histogram(hist_sh, hist + (size_t)row * NUM_BINS);
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
  const int bpc = BS >= 256 ? 1 : 256 / BS;   // blocks per CTA
  int threads = bpc * BS;
  threads = threads > 256 ? 256 : ((threads + 31) / 32) * 32;
  const dim3 grid((MB + bpc - 1) / bpc, S * KV);
  const size_t smem = (NUM_BINS + (size_t)bpc * (BS + 2 * HALO)) * sizeof(int32_t);
  paged_fused_select_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)lo, (const float*)hi, (const uint8_t*)from_left,
      (const uint8_t*)from_right, (const uint8_t*)blk_valid, (const uint8_t*)force,
      (uint8_t*)pooled, (int32_t*)hist, KV, MB, BS, HALO, bpc);
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
