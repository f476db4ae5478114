// Kernel B5: fused INT8 binning, stride-1 max-pool and 256-bin histogram
// over paged scores (Salca phases 2-3 of the block-sharded tick), for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/selection_fused/kernel.py::
// paged_fused_select_pallas. Row (s, kv) of the (S, KV, MB, BS) scores:
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
// Bound on this card: bytes — 4 B of score plus 2 B of valid/force in and
// 1 B of pooled bin out per position; a few dozen integer ops each. Design:
// one CTA per (run of blocks, slot·kv row), one thread per position. The
// run's bins and their halo columns sit in shared memory for the pool; the
// histogram accumulates in shared memory and is added into the zeroed
// (S, KV, 256) output with one atomic per non-empty bin (exact integer
// counts, so the order of the adds does not matter). The TPU kernel's
// scratch histogram carried across its sequential block axis; here the
// runs of a row are separate CTAs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NUM_BINS = 256;

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
    if (p > 0) {
      for (int o = 0; o <= 2 * HALO; ++o) p = max(p, b[o]);
    }
    if (force[(size_t)s * MB * BS + pos] && blk_valid[(size_t)s * MB * BS + pos]) p = 255;
    pooled[(size_t)row * MB * BS + pos] = (uint8_t)p;
    atomicAdd(&hist_sh[p], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NUM_BINS; i += blockDim.x) {
    if (hist_sh[i]) atomicAdd(&hist[(size_t)row * NUM_BINS + i], hist_sh[i]);
  }
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
