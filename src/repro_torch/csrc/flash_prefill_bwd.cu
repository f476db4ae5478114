// Kernel B3-bwd: the gradient of kernel B3 (flash_prefill.cu) for training,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains through the XLA twin of B3
// (src/repro/models/attention.py::flash_attention_xla, under jax.checkpoint)
// and takes this gradient by XLA's autodiff; its Pallas kernel
// (src/repro/kernels/flash_prefill/kernel.py::flash_attention_pallas) has no
// custom_vjp. The port trains through B3, so its backward is this kernel.
//
// Inputs: q, dout, out (BH, T, HD); k, v (BKV, S, HD), BH = BKV * groups;
// lse (BH, T) f32, the forward's per-row log-sum-exp of the scaled, masked
// scores (B3's optional output). Query row i sits at position qpos =
// q_offset + i over keys [0, S) (a context-parallel shard's rows; 0 for a
// whole sequence), and the masks are B3's: causal keeps kpos <= qpos, window
// > 0 keeps kpos > qpos - window. Every tile bound below is taken on
// positions, so at q_offset 0 the kernel does what it did without one. With
// P = exp(scale * Q K^T - lse) (masked entries 0) and D = rowsum(dO * O):
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the `groups` query heads of a KV head.
//
// Three launches, no atomics (every gradient is the same bits from run to
// run): (1) D, one warp per row; (2) dK/dV, one CTA per (KV head, key tile),
// looping over the group's query heads and every query tile that sees its
// keys (tiles entirely above the diagonal or past the window are skipped;
// only diagonal and edge tiles are masked); (3) dQ, one CTA per (query head,
// query tile), looping over the key tiles its rows see (longest tiles
// launched first, as B3). S and dP are computed in both (2) and (3): the
// second pass is the price of a dQ without atomics.
//
// Bound on this card: operations — 10*HD flops per kept (query, key) pair
// (S, dP, dV, dK, dQ) at the bf16 tensor-core rate, 989 TFLOP/s.
//
// bf16 (what training runs): tensor cores, `wgmma` (wgmma.cuh) with f32
// accumulators, warp-specialised in one if/else. A CTA is three
// warpgroups: two consumers, then the producer, one warp of which issues
// TMA copies into a ring of shared-memory stages, each with a full and an
// empty mbarrier; `setmaxnreg` leaves the producer 40 registers a thread
// and gives each consumer 232. The tensor maps are 3-D, over (heads, rows,
// HD), built on the host for each call (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint so the library links nothing beyond the
// CUDA runtime, as the other kernel libraries) and passed as
// __grid_constant__ parameters: a tile that runs past T reads TMA's zero
// fill, never the next head's rows. Tiles land 128-byte swizzled (64-byte at
// HD 32), the layout wgmma's descriptors read.
//  (2) loads its K and V tiles once (BN = 128 keys, 64 a consumer; at HD 256
//      BN = 64 and the two consumers split dK's and dV's channels), then
//      streams (Q, dO) tiles of BM = 64 query rows with their rows' LSE and
//      D, twice: a dV pass, then a dK pass, so that a consumer holds one
//      64-register accumulator (holding dK, dV, S, dP and the bf16 pairs at
//      once spilled, and ptxas then serialises every wgmma). A
//      consumer computes S^T = K Q^T (both operands from shared memory) and
//      P^T = exp2(S^T * scale * log2 e - LSE * log2 e) in registers; pass 1
//      adds dV += P^T dO, pass 2 computes dP^T = V dO^T and dS^T = P^T *
//      (dP^T - D) and adds dK += dS^T Q. P^T and dS^T are wgmma's register
//      A operand: in this order an accumulator's fragment is already A's
//      layout, converted to bf16 pairs in place; dO and Q are read
//      transposed through their descriptors.
//  (3) loads its Q and dO tiles once (128 rows, 64 a consumer; at HD 256 64
//      rows and the consumers split dQ's channels) and streams (K, V) tiles
//      of BN = 64 keys: S = Q K^T, dP = dO V^T, dS = P * (dP - D), dQ += dS K
//      (dS in registers, K read transposed).
// P and dS reach the tensor cores as bf16 hi + lo pairs, two wgmma each:
// rounded once to bf16 (as FlashAttention does) they miss the tolerance,
// 1e-3 + 2^-7 |plain|, by up to 10.7x (dV, recurrentgemma's G 10); split,
// the kernel's worst case is 0.93 of it (scripts/torch_b3_bwd_roundings.py).
// Work executed per kept pair: 22*HD (dV pass S 2 + P^T dO 4, dK pass S 2 +
// dP 2 + dS^T Q 4, dQ S 2 + dP 2 + dS K 4); at HD 256 32*HD (both consumers
// compute S and dP). At qwen3-0.6b's training shape (chip_smoke run (ae);
// an H100 SXM at 700 W) it takes 3.44 ms, 0.20 of the bound, 439 TFLOP/s of
// executed work. What holds it there: a consumer waits for each group of
// products before it computes on the CUDA cores (only the other consumer
// fills the tensor cores meanwhile), and the hi + lo splits and the second
// pass are 12*HD of work beyond the bound's 10*HD. Registers (ptxas,
// sm_90a): 168 at entry, up to 232 in the consumers, no spills at any head
// dim.
//
// f32: PR 30's first kernels, unchanged, on the CUDA cores (f32 on the
// tensor cores is TF32, which would break the f32 contract): each product is
// a register-tiled loop over f32 tiles in shared memory (rows padded to
// HD + 1 floats, so a warp reading one channel of 32 rows hits 32 banks),
// staged synchronously; tiles: (2) 64 keys x 32 query rows, (3) 64 rows x
// 32 keys (32 / 32 at HD 256). 14*HD flops per pair.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

// rows [r0, r0 + ROWS) of a (rows, HD) matrix into a shared tile of row
// stride HD + 1, widened to f32; rows at or past `rmax` are zero
template <typename T, int ROWS, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int rmax) {
  for (int e = threadIdx.x; e < ROWS * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    dst[r * (HD + 1) + c] = r0 + r < rmax ? ld(src + (size_t)(r0 + r) * HD + c) : 0.f;
  }
}

// acc[i][j] += sum_{kk < K} A(m_i, kk) * B(n_j, kk) over shared tiles, with
// A(m, kk) = a[m * SAM + kk * SAK] and B(n, kk) = b[n * SBN + kk * SBK]. The
// threads form an (THREADS / NTX) x NTX grid; thread (ty, tx) owns rows
// m_i = ty + (THREADS / NTX) * i and columns n_j = tx + NTX * j.
template <int TM, int TN, int NTX, int K, int SAM, int SAK, int SBN, int SBK>
__device__ __forceinline__ void mm(const float* a, const float* b, float (&acc)[TM][TN]) {
  constexpr int NTY = THREADS / NTX;
  const int tx = threadIdx.x % NTX, ty = threadIdx.x / NTX;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a[(ty + NTY * i) * SAM + kk * SAK];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[(tx + NTX * j) * SBN + kk * SBK];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// query row `row` (at position qoff + row) and key kpos
__device__ __forceinline__ bool kept(int row, int kpos, int Tq, int S, int qoff, int causal,
                                     int window) {
  const int qpos = qoff + row;
  return row < Tq && kpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// (1) D = rowsum(dO * O), one warp per row
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int HD) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int c = lane; c < HD; c += 32)
    s = fmaf(ld(dout + (size_t)row * HD + c), ld(out + (size_t)row * HD + c), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[row] = s;
}

// tiles: (2) BN keys x BM query rows, (3) BM query rows x BN keys
template <int HD>
struct Cfg {
  static constexpr int KV_BN = HD > 128 ? 32 : 64;   // (2): keys per CTA
  static constexpr int KV_BM = 32;                   // (2): query rows per tile
  static constexpr int Q_BM = HD > 128 ? 32 : 64;    // (3): query rows per CTA
  static constexpr int Q_BN = 32;                    // (3): keys per tile
  static constexpr int LD = HD + 1;
  // shared floats: two (BN, HD) and two (BM, HD) tiles, one (BM, BN + 1),
  // lse and D of the BM rows
  static constexpr int KV_SMEM = 4 * ((2 * KV_BN + 2 * KV_BM) * LD + KV_BM * (KV_BN + 1) +
                                      2 * KV_BM);
  static constexpr int Q_SMEM = 4 * ((2 * Q_BN + 2 * Q_BM) * LD + Q_BM * (Q_BN + 1) +
                                     2 * Q_BM);
};

// (2) dK, dV for keys [n0, n0 + BN) of KV head bkv
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int Tq, int S, int qoff,
                      int groups, int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int BN = C::KV_BN, BM = C::KV_BM, LD = C::LD, LP = BN + 1;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + BN * LD;
  float* qs = vs + BN * LD;
  float* dos = qs + BM * LD;
  float* ps = dos + BM * LD;          // P, then dS, (BM, BN + 1)
  float* ls = ps + BM * LP;           // lse of the tile's rows
  float* ds = ls + BM;                // D of the tile's rows

  const int bkv = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int n_last = min(n0 + BN, S) - 1;
  load_tile<T, BN, HD>(ks, k + (size_t)bkv * S * HD, n0, S);
  load_tile<T, BN, HD>(vs, v + (size_t)bkv * S * HD, n0, S);

  // S / P / dP micro-tile: BM x BN over a 8 x 32 grid
  constexpr int S_NTX = 32, S_TM = BM / (THREADS / S_NTX), S_TN = BN / S_NTX;
  // dK / dV: BN x HD over a 8 x 32 grid
  constexpr int G_NTX = 32, G_TM = BN / (THREADS / G_NTX), G_TN = HD / G_NTX;
  static_assert(S_TN >= 1 && G_TN >= 1 && S_TM >= 1 && G_TM >= 1, "tile shapes");
  float dk_acc[G_TM][G_TN], dv_acc[G_TM][G_TN];
  zero(dk_acc);
  zero(dv_acc);

  // query rows that see a key of this tile: [m_begin, m_end)
  const int m_begin = causal ? max(0, n0 - qoff) / BM * BM : 0;
  const int m_end = window > 0 ? min(Tq, max(0, n_last + window - qoff)) : Tq;
  const int s_tx = threadIdx.x % S_NTX, s_ty = threadIdx.x / S_NTX;

  for (int g = 0; g < groups; ++g) {
    const int bh = bkv * groups + g;
    const T* qg = q + (size_t)bh * Tq * HD;
    const T* dog = dout + (size_t)bh * Tq * HD;
    for (int m0 = m_begin; m0 < m_end; m0 += BM) {
      __syncthreads();                // the previous tile fully consumed
      load_tile<T, BM, HD>(qs, qg, m0, Tq);
      load_tile<T, BM, HD>(dos, dog, m0, Tq);
      for (int r = threadIdx.x; r < BM; r += THREADS) {
        const bool ok = m0 + r < Tq;
        ls[r] = ok ? lse[(size_t)bh * Tq + m0 + r] : 0.f;
        ds[r] = ok ? delta[(size_t)bh * Tq + m0 + r] : 0.f;
      }
      __syncthreads();

      // P = exp(scale * Q K^T - lse), kept in registers and staged for dV
      float p[S_TM][S_TN];
      zero(p);
      mm<S_TM, S_TN, S_NTX, HD, LD, 1, LD, 1>(qs, ks, p);
#pragma unroll
      for (int i = 0; i < S_TM; ++i) {
        const int m = s_ty + (THREADS / S_NTX) * i;
#pragma unroll
        for (int j = 0; j < S_TN; ++j) {
          const int n = s_tx + S_NTX * j;
          p[i][j] = kept(m0 + m, n0 + n, Tq, S, qoff, causal, window)
                        ? expf(p[i][j] * scale - ls[m]) : 0.f;
          ps[m * LP + n] = p[i][j];
        }
      }
      __syncthreads();
      // dV += P^T dO
      mm<G_TM, G_TN, G_NTX, BM, 1, LP, 1, LD>(ps, dos, dv_acc);
      // dP = dO V^T; dS = P * (dP - D)
      float dp[S_TM][S_TN];
      zero(dp);
      mm<S_TM, S_TN, S_NTX, HD, LD, 1, LD, 1>(dos, vs, dp);
      __syncthreads();                 // every thread is done reading P
#pragma unroll
      for (int i = 0; i < S_TM; ++i) {
        const int m = s_ty + (THREADS / S_NTX) * i;
#pragma unroll
        for (int j = 0; j < S_TN; ++j)
          ps[m * LP + s_tx + S_NTX * j] = p[i][j] * (dp[i][j] - ds[m]);
      }
      __syncthreads();
      // dK += dS^T Q (scaled at the end)
      mm<G_TM, G_TN, G_NTX, BM, 1, LP, 1, LD>(ps, qs, dk_acc);
    }
  }

  const int g_tx = threadIdx.x % G_NTX, g_ty = threadIdx.x / G_NTX;
#pragma unroll
  for (int i = 0; i < G_TM; ++i) {
    const int n = n0 + g_ty + (THREADS / G_NTX) * i;
    if (n >= S) continue;
    const size_t off = ((size_t)bkv * S + n) * HD;
#pragma unroll
    for (int j = 0; j < G_TN; ++j) {
      const int c = g_tx + G_NTX * j;
      st(dk + off + c, dk_acc[i][j] * scale);
      st(dv + off + c, dv_acc[i][j]);
    }
  }
}

// (3) dQ for query rows [m0, m0 + BM) of query head bh
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Tq, int S,
                    int qoff, int groups, int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int BM = C::Q_BM, BN = C::Q_BN, LD = C::LD, LP = BN + 1;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + BM * LD;
  float* ks = dos + BM * LD;
  float* vs = ks + BN * LD;
  float* ps = vs + BN * LD;           // dS, (BM, BN + 1)
  float* ls = ps + BM * LP;
  float* ds = ls + BM;

  const int bh = blockIdx.x;
  const int m0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * BM;   // longest tiles first
  const int bkv = bh / groups;
  const int m_last = min(m0 + BM, Tq) - 1;
  load_tile<T, BM, HD>(qs, q + (size_t)bh * Tq * HD, m0, Tq);
  load_tile<T, BM, HD>(dos, dout + (size_t)bh * Tq * HD, m0, Tq);
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const bool ok = m0 + r < Tq;
    ls[r] = ok ? lse[(size_t)bh * Tq + m0 + r] : 0.f;
    ds[r] = ok ? delta[(size_t)bh * Tq + m0 + r] : 0.f;
  }

  constexpr int S_NTX = 16, S_TM = BM / (THREADS / S_NTX), S_TN = BN / S_NTX;
  constexpr int G_NTX = 32, G_TM = BM / (THREADS / G_NTX), G_TN = HD / G_NTX;
  static_assert(S_TN >= 1 && G_TN >= 1 && S_TM >= 1 && G_TM >= 1, "tile shapes");
  float dq_acc[G_TM][G_TN];
  zero(dq_acc);

  // keys this tile's rows see: [n_begin, n_end)
  const int n_end = causal ? min(S, qoff + m_last + 1) : S;
  const int n_begin = (window > 0 ? max(0, qoff + m0 - window + 1) : 0) / BN * BN;
  const int s_tx = threadIdx.x % S_NTX, s_ty = threadIdx.x / S_NTX;
  const T* kg = k + (size_t)bkv * S * HD;
  const T* vg = v + (size_t)bkv * S * HD;

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    __syncthreads();                   // the previous tile fully consumed
    load_tile<T, BN, HD>(ks, kg, n0, S);
    load_tile<T, BN, HD>(vs, vg, n0, S);
    __syncthreads();
    float p[S_TM][S_TN], dp[S_TM][S_TN];
    zero(p);
    zero(dp);
    mm<S_TM, S_TN, S_NTX, HD, LD, 1, LD, 1>(qs, ks, p);
    mm<S_TM, S_TN, S_NTX, HD, LD, 1, LD, 1>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < S_TM; ++i) {
      const int m = s_ty + (THREADS / S_NTX) * i;
#pragma unroll
      for (int j = 0; j < S_TN; ++j) {
        const int n = s_tx + S_NTX * j;
        const float pr = kept(m0 + m, n0 + n, Tq, S, qoff, causal, window)
                             ? expf(p[i][j] * scale - ls[m]) : 0.f;
        ps[m * LP + n] = pr * (dp[i][j] - ds[m]);
      }
    }
    __syncthreads();
    // dQ += dS K (scaled at the end)
    mm<G_TM, G_TN, G_NTX, BN, LP, 1, 1, LD>(ps, ks, dq_acc);
  }

  const int g_tx = threadIdx.x % G_NTX, g_ty = threadIdx.x / G_NTX;
#pragma unroll
  for (int i = 0; i < G_TM; ++i) {
    const int m = m0 + g_ty + (THREADS / G_NTX) * i;
    if (m >= Tq) continue;
    const size_t off = ((size_t)bh * Tq + m) * HD;
#pragma unroll
    for (int j = 0; j < G_TN; ++j) st(dq + off + g_tx + G_NTX * j, dq_acc[i][j] * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int BH, int Tq,
           int S, int qoff, int groups, int causal, int window, float scale, cudaStream_t st) {
  using C = Cfg<HD>;
  const int rows = BH * Tq;
  flash_bwd_delta_kernel<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(
      (const T*)out, (const T*)dout, delta, rows, HD);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // set on every launch (cheap): the attribute is per device
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::KV_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::Q_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int bkv = BH / groups;
  flash_bwd_dkdv_kernel<T, HD><<<dim3((S + C::KV_BN - 1) / C::KV_BN, bkv), THREADS,
                                 C::KV_SMEM, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, Tq,
      S, qoff, groups, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, HD><<<dim3(BH, (Tq + C::Q_BM - 1) / C::Q_BM), THREADS, C::Q_SMEM,
                               st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, Tq, S,
      qoff, groups, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma, a TMA ring, warp specialisation
// ---------------------------------------------------------------------------
namespace hop {

constexpr int WG = 128;                    // threads of a warpgroup
constexpr int THREADS = 3 * WG;            // two consumer warpgroups, then the producer's
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive, and expect `bytes` of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// wait for the phase of parity `parity` to complete; a phase that never
// completes (a lost arrival or a short copy) traps after ~10 s instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(a, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// one box of a 3-D tensor map (channel c0, row c1, head c2) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi): hi + lo
// carries x to ~2^-16 of itself
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// A tile of R rows x HD bf16 channels in shared memory, as TMA writes it:
// NCOL column blocks of SW channels (rows of SW * 2 bytes, 8-row swizzle
// atoms), block c at byte c * R * SW * 2.
template <int HD>
struct Tile {
  static constexpr int SW = HD < 64 ? HD : 64;
  static constexpr int NCOL = HD / SW;
  static constexpr uint32_t LAYOUT = SW == 64 ? 1 : 2;   // 128 B / 64 B swizzle
  static constexpr uint32_t ATOM = 8 * SW * 2;           // bytes of 8 rows of a block
  // Descriptors are made where their wgmma is issued: the empty asm on the
  // tile's address keeps the compiler from hoisting the K / V / Q / dO
  // tiles' loop-invariant descriptors out of the loops, which would hold
  // 32-64 registers a thread.
  static __device__ __forceinline__ uint32_t here(uint32_t tile) {
    asm volatile("" : "+r"(tile));
    return tile;
  }
  // K-major operand: rows [r0, r0 + 64) (or N), channels [16 kk, 16 kk + 16)
  template <int R>
  static __device__ __forceinline__ uint64_t k_major(uint32_t tile, int r0, int kk) {
    const uint32_t c = kk * 16 / SW, w = kk * 16 % SW;
    return wgmma::desc(here(tile) + c * R * SW * 2 + r0 * SW * 2 + w * 2, 16, ATOM, LAYOUT);
  }
  // MN-major operand (transposed B): rows [16 kk, 16 kk + 16) are K,
  // channels [ch0, ch0 + N) are N
  template <int R>
  static __device__ __forceinline__ uint64_t mn_major(uint32_t tile, int ch0, int kk) {
    return wgmma::desc(here(tile) + (ch0 / SW) * R * SW * 2 + kk * 16 * SW * 2, R * SW * 2,
                       ATOM, LAYOUT);
  }
  // the R-row tile at rows [row, row + R) of head `head`, every column block
  template <int R>
  static __device__ __forceinline__ void load(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row, int head) {
#pragma unroll
    for (int c = 0; c < NCOL; ++c) tma_load(dst + c * R * SW * 2, map, bar, c * SW, row, head);
  }
};

// query rows [q0, q0 + nq) (at positions qoff + row) and keys [k0, k0 + nk):
// 0: no pair of the tile is kept; 1: every pair is; 2: some are
__device__ __forceinline__ int tile_kind(int q0, int nq, int k0, int nk, int Tq, int S, int qoff,
                                         int causal, int window) {
  const int q1 = q0 + nq - 1, k1 = k0 + nk - 1;
  const int p0 = qoff + q0, p1 = qoff + q1;   // the rows' positions
  if (q0 >= Tq || k0 >= S || (causal && k0 > p1) || (window > 0 && k1 <= p0 - window)) return 0;
  const bool all = q1 < Tq && k1 < S && (!causal || k1 <= p0) && (window <= 0 || k0 > p1 - window);
  return all ? 1 : 2;
}

// (2): dK, dV
template <int HD>
struct KV {
  static constexpr int SPLIT = HD > 128 ? 2 : 1;   // HD 256: the consumers split the channels
  static constexpr int BN = SPLIT == 2 ? 64 : 128;  // keys per CTA
  static constexpr int BM = 64;                     // query rows per stage
  static constexpr int NCH = HD / SPLIT;            // channels of dK, dV a consumer holds
  static constexpr int STAGES = HD > 128 ? 2 : 3;
  static constexpr uint32_t K_OFF = 0, V_OFF = BN * HD * 2, RING = 2 * BN * HD * 2;
  static constexpr uint32_t Q_OFF = 0, DO_OFF = BM * HD * 2, LSE_OFF = 2 * BM * HD * 2,
                            D_OFF = LSE_OFF + BM * 4;
  static constexpr uint32_t STAGE = (D_OFF + BM * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t BAR = RING + STAGES * STAGE;
  static constexpr uint32_t SMEM = BAR + (2 * STAGES + 1) * 8 + 1024;   // + alignment slack
};

// A consumer's rows of an m64 accumulator in (2): element 4 j + 2 h + e is
// key key + 8 h and column 8 j + cc + e (a query row, or a channel)
struct Rows {
  int key, cc;
  float sl2;   // scale * log2 e
  int Tq, S, qoff, causal, window;
};

// the LSE rows (log2 e units) of a ring stage of (2); its D rows follow
template <int HD>
__device__ __forceinline__ const float* stage_lse(const uint8_t* sm, int stage) {
  return reinterpret_cast<const float*>(sm + KV<HD>::RING + stage * KV<HD>::STAGE +
                                        KV<HD>::LSE_OFF);
}

// acc = A B^T with A = 64 rows from row a0 of an R-row tile and B = an
// N-row tile, over HD channels (issued; the caller commits and waits)
template <int HD, int R, int N>
__device__ __forceinline__ void products(float (&acc)[N / 2], uint32_t a_tile, int a0,
                                         uint32_t b_tile) {
  using L = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma::wgmma_ss<N>(acc, L::template k_major<R>(a_tile, a0, kk),
                       L::template k_major<N>(b_tile, 0, kk), kk > 0);
}

// S^T in s (keys x BM query rows) becomes P^T = exp2(S^T * scale * log2 e -
// LSE * log2 e), masked
template <int BM>
__device__ __forceinline__ void probabilities(float (&s)[BM / 2], const float* ls, int m0,
                                              int kind, const Rows& r) {
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + r.cc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h, kpos = r.key + 8 * h, qpos = m0 + 8 * j + r.cc;   // qpos: a row
      float p0 = exp2f(fmaf(s[i], r.sl2, -l2.x));
      float p1 = exp2f(fmaf(s[i + 1], r.sl2, -l2.y));
      if (kind == 2) {
        if (!kept(qpos, kpos, r.Tq, r.S, r.qoff, r.causal, r.window)) p0 = 0.f;
        if (!kept(qpos + 1, kpos, r.Tq, r.S, r.qoff, r.causal, r.window)) p1 = 0.f;
      }
      s[i] = p0;
      s[i + 1] = p1;
    }
  }
}

// acc += X^T B over BM query rows: X^T (64 keys x BM, an m64 accumulator's
// layout) as bf16 hi + lo pairs, two wgmma a k-step; B = the query rows'
// channels [ch0, ch0 + NCH) of a tile, read transposed
template <int HD, int BM, int NCH>
__device__ __forceinline__ void accumulate(float (&acc)[NCH / 2], const float (&x)[BM / 2],
                                           uint32_t b_tile, int ch0) {
  using L = Tile<HD>;
  uint32_t hi[BM / 4], lo[BM / 4];
#pragma unroll
  for (int i = 0; i < BM / 4; ++i) split_bf16(x[2 * i], x[2 * i + 1], hi[i], lo[i]);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk) {
    const uint32_t a[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3]};
    const uint32_t b[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3]};
    wgmma::wgmma_rs<NCH>(acc, a, L::template mn_major<BM>(b_tile, ch0, kk), 1);
    wgmma::wgmma_rs<NCH>(acc, b, L::template mn_major<BM>(b_tile, ch0, kk), 1);
  }
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_regs(acc);
}

// mul * acc into rows [key, key + 8] of a (rows, HD) bf16 matrix whose
// first row is `row0`, channels [ch0, ch0 + NCH); rows at or past S skipped
template <int HD, int NCH>
__device__ __forceinline__ void store(__nv_bfloat16* out, const float (&acc)[NCH / 2], float mul,
                                      size_t row0, const Rows& r, int ch0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = r.key + 8 * h;
    if (n >= r.S) continue;
    const size_t off = (row0 + n) * HD + ch0 + r.cc;
#pragma unroll
    for (int j = 0; j < NCH / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + off + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// a consumer warp is done with a stage: its lanes' reads are complete
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int Tq, int S, int qoff, int groups, int causal, int window,
                            float scale) {
  using C = KV<HD>;
  using L = Tile<HD>;
  constexpr int BM = C::BM, BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);   // 1024-byte aligned
  const uint32_t base = smem_u32(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* kv_full = empty + C::STAGES;

  const int bkv = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int n_last = min(n0 + BN, S) - 1;
  // query rows that see a key of this tile: [m_begin, m_end)
  const int m_begin = causal ? max(0, n0 - qoff) / BM * BM : 0;
  const int m_end = window > 0 ? min(Tq, max(0, n_last + window - qoff)) : Tq;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 32);       // the producer warp's lanes (LSE, D rows)
      mbar_init(&empty[s], 8);       // the consumers' warps
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one warp streams the query tiles twice, once a pass
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x / 32 != 8) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * BN * HD * 2);
      L::template load<BN>(sm + C::K_OFF, &tk, kv_full, n0, bkv);
      L::template load<BN>(sm + C::V_OFF, &tv, kv_full, n0, bkv);
    }
    int stage = 0;
    uint32_t ph = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int g = 0; g < groups; ++g) {
        const int bh = bkv * groups + g;
        for (int m0 = m_begin; m0 < m_end; m0 += BM) {
          mbar_wait(&empty[stage], ph ^ 1);
          uint8_t* st = sm + C::RING + stage * C::STAGE;
          float* ls = reinterpret_cast<float*>(st + C::LSE_OFF);
          float* ds = reinterpret_cast<float*>(st + C::D_OFF);
          for (int r = lane; r < BM; r += 32) {
            const bool ok = m0 + r < Tq;
            ls[r] = ok ? lse[(size_t)bh * Tq + m0 + r] * LOG2E : 0.f;
            ds[r] = ok ? delta[(size_t)bh * Tq + m0 + r] : 0.f;
          }
          if (lane == 0) {
            mbar_expect_tx(&full[stage], 2 * BM * HD * 2);
            L::template load<BM>(st + C::Q_OFF, &tq, &full[stage], m0, bh);
            L::template load<BM>(st + C::DO_OFF, &tdo, &full[stage], m0, bh);
          } else {
            mbar_arrive(&full[stage]);
          }
          if (++stage == C::STAGES) stage = 0, ph ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns keys [key0, key0 + 64) of the tile and
    // channels [ch0, ch0 + NCH) of dK and dV. Two passes over the query
    // tiles: dV, then dK, so that one NCH-wide accumulator is held at a time.
    setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int NS = BM / 2, NG = C::NCH / 2;   // accumulator registers a thread
    const int key0 = C::SPLIT == 1 ? wg * 64 : 0;
    const int ch0 = C::SPLIT == 1 ? 0 : wg * C::NCH;
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int rr = warp * 16 + lane / 4;   // accumulator rows rr, rr + 8 (keys)
    const int cc = 2 * (lane % 4);         // columns 8 j + cc + {0, 1} (query rows)
    const Rows rows{n0 + key0 + rr, cc, scale * LOG2E, Tq, S, qoff, causal, window};
    const uint32_t kt = base + C::K_OFF, vt = base + C::V_OFF;
    mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t ph = 0;

    {  // pass 1: dV = P^T dO
      float dva[NG];
#pragma unroll
      for (int i = 0; i < NG; ++i) dva[i] = 0.f;
      for (int g = 0; g < groups; ++g) {
        for (int m0 = m_begin; m0 < m_end; m0 += BM) {
          mbar_wait(&full[stage], ph);
          const int kind = tile_kind(m0, BM, n0 + key0, 64, Tq, S, qoff, causal, window);
          if (kind != 0) {
            const uint32_t st = base + C::RING + stage * C::STAGE;
            float p[NS];
            wgmma::fence();
            products<HD, BN, BM>(p, kt, key0, st + C::Q_OFF);   // S^T = K Q^T
            wgmma::commit();
            wgmma::wait<0>();
            wgmma::fence_regs(p);
            probabilities<BM>(p, stage_lse<HD>(sm, stage), m0, kind, rows);
            accumulate<HD, BM, C::NCH>(dva, p, st + C::DO_OFF, ch0);
          }
          release(&empty[stage], lane);
          if (++stage == C::STAGES) stage = 0, ph ^= 1;
        }
      }
      store<HD, C::NCH>(dv, dva, 1.f, (size_t)bkv * S, rows, ch0);
    }
    {  // pass 2: dK = scale * dS^T Q, dS^T = P^T (dP^T - D), dP^T = V dO^T
      float dka[NG];
#pragma unroll
      for (int i = 0; i < NG; ++i) dka[i] = 0.f;
      for (int g = 0; g < groups; ++g) {
        for (int m0 = m_begin; m0 < m_end; m0 += BM) {
          mbar_wait(&full[stage], ph);
          const int kind = tile_kind(m0, BM, n0 + key0, 64, Tq, S, qoff, causal, window);
          if (kind != 0) {
            const uint32_t st = base + C::RING + stage * C::STAGE;
            const float* ls = stage_lse<HD>(sm, stage);
            const float* ds = ls + BM;
            // S^T, then P^T, then dP^T: with S^T and dP^T in flight together
            // the consumer spills
            float p[NS], dp[NS];
            wgmma::fence();
            products<HD, BN, BM>(p, kt, key0, st + C::Q_OFF);    // S^T = K Q^T
            wgmma::commit();
            wgmma::wait<0>();
            wgmma::fence_regs(p);
            probabilities<BM>(p, ls, m0, kind, rows);
            wgmma::fence();
            products<HD, BN, BM>(dp, vt, key0, st + C::DO_OFF);  // dP^T = V dO^T
            wgmma::commit();
            wgmma::wait<0>();
            wgmma::fence_regs(dp);
#pragma unroll
            for (int j = 0; j < BM / 8; ++j) {
              const float2 dd = *reinterpret_cast<const float2*>(ds + 8 * j + cc);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int i = 4 * j + 2 * h;
                dp[i] = p[i] * (dp[i] - dd.x);
                dp[i + 1] = p[i + 1] * (dp[i + 1] - dd.y);
              }
            }
            accumulate<HD, BM, C::NCH>(dka, dp, st + C::Q_OFF, ch0);
          }
          release(&empty[stage], lane);
          if (++stage == C::STAGES) stage = 0, ph ^= 1;
        }
      }
      store<HD, C::NCH>(dk, dka, scale, (size_t)bkv * S, rows, ch0);
    }
  }
}

// (3): dQ
template <int HD>
struct QD {
  static constexpr int SPLIT = HD > 128 ? 2 : 1;   // HD 256: the consumers split the channels
  static constexpr int BM = SPLIT == 2 ? 64 : 128;  // query rows per CTA, 64 a consumer
  static constexpr int BN = 64;                     // keys per stage
  static constexpr int NCH = HD / SPLIT;            // channels of dQ a consumer holds
  static constexpr int STAGES = HD > 128 ? 2 : 3;
  static constexpr uint32_t Q_OFF = 0, DO_OFF = BM * HD * 2, RING = 2 * BM * HD * 2;
  static constexpr uint32_t K_OFF = 0, V_OFF = BN * HD * 2, STAGE = 2 * BN * HD * 2;
  static constexpr uint32_t BAR = RING + STAGES * STAGE;
  static constexpr uint32_t SMEM = BAR + (2 * STAGES + 1) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Tq, int S, int qoff, int groups,
                          int causal, int window, float scale) {
  using C = QD<HD>;
  using L = Tile<HD>;
  constexpr int BM = C::BM, BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* q_full = empty + C::STAGES;

  const int bh = blockIdx.x;
  const int m0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * BM;   // longest tiles first
  const int bkv = bh / groups;
  const int m_last = min(m0 + BM, Tq) - 1;
  // keys this tile's rows see: [n_begin, n_end)
  const int n_end = causal ? min(S, qoff + m_last + 1) : S;
  const int n_begin = (window > 0 ? max(0, qoff + m0 - window + 1) : 0) / BN * BN;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 2 * WG) return;   // one thread issues every copy
    mbar_expect_tx(q_full, 2 * BM * HD * 2);
    L::template load<BM>(sm + C::Q_OFF, &tq, q_full, m0, bh);
    L::template load<BM>(sm + C::DO_OFF, &tdo, q_full, m0, bh);
    int stage = 0;
    uint32_t ph = 0;
    for (int n0 = n_begin; n0 < n_end; n0 += BN) {
      mbar_wait(&empty[stage], ph ^ 1);
      uint8_t* st = sm + C::RING + stage * C::STAGE;
      mbar_expect_tx(&full[stage], 2 * BN * HD * 2);
      L::template load<BN>(st + C::K_OFF, &tk, &full[stage], n0, bkv);
      L::template load<BN>(st + C::V_OFF, &tv, &full[stage], n0, bkv);
      if (++stage == C::STAGES) stage = 0, ph ^= 1;
    }
  } else {
    // consumers: warpgroup wg owns query rows [q0, q0 + 64) and channels
    // [ch0, ch0 + NCH) of dQ
    setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int NS = BN / 2, NG = C::NCH / 2;
    const int q0 = C::SPLIT == 1 ? m0 + 64 * wg : m0;
    const int ch0 = C::SPLIT == 1 ? 0 : wg * C::NCH;
    const int qrow = q0 - m0;   // the warpgroup's rows within the Q and dO tiles
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int rr = warp * 16 + lane / 4;   // accumulator rows rr, rr + 8 (query rows)
    const int cc = 2 * (lane % 4);         // columns 8 j + cc + {0, 1} (keys)
    const float sl2 = scale * LOG2E;
    float l2[2], dd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = q0 + rr + 8 * h;
      l2[h] = m < Tq ? lse[(size_t)bh * Tq + m] * LOG2E : 0.f;
      dd[h] = m < Tq ? delta[(size_t)bh * Tq + m] : 0.f;
    }
    float dqa[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) dqa[i] = 0.f;
    const uint32_t qt = base + C::Q_OFF, dot = base + C::DO_OFF;
    mbar_wait(q_full, 0);

    int stage = 0;
    uint32_t ph = 0;
    for (int n0 = n_begin; n0 < n_end; n0 += BN) {
      mbar_wait(&full[stage], ph);
      const int kind = tile_kind(q0, 64, n0, BN, Tq, S, qoff, causal, window);
      if (kind != 0) {
        const uint32_t st = base + C::RING + stage * C::STAGE;
        float s[NS], dp[NS];
        wgmma::fence();
        products<HD, BM, BN>(s, qt, qrow, st + C::K_OFF);    // S = Q K^T
        products<HD, BM, BN>(dp, dot, qrow, st + C::V_OFF);  // dP = dO V^T
        wgmma::commit();
        wgmma::wait<0>();
        wgmma::fence_regs(s);
        wgmma::fence_regs(dp);
        // dS: element 4 j + 2 h + e is (query row rr + 8 h, key 8 j + cc + e)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              float p = exp2f(fmaf(s[i], sl2, -l2[h]));
              if (kind == 2 &&
                  !kept(q0 + rr + 8 * h, n0 + 8 * j + cc + e, Tq, S, qoff, causal, window))
                p = 0.f;
              dp[i] = p * (dp[i] - dd[h]);
            }
          }
        }
        uint32_t dh_[NS / 2], dl_[NS / 2];
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) split_bf16(dp[2 * i], dp[2 * i + 1], dh_[i], dl_[i]);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const uint32_t a[4] = {dh_[4 * kk], dh_[4 * kk + 1], dh_[4 * kk + 2], dh_[4 * kk + 3]};
          const uint32_t b[4] = {dl_[4 * kk], dl_[4 * kk + 1], dl_[4 * kk + 2], dl_[4 * kk + 3]};
          wgmma::wgmma_rs<C::NCH>(dqa, a, L::template mn_major<BN>(st + C::K_OFF, ch0, kk), 1);
          wgmma::wgmma_rs<C::NCH>(dqa, b, L::template mn_major<BN>(st + C::K_OFF, ch0, kk), 1);
        }
        wgmma::commit();
        wgmma::wait<0>();
        wgmma::fence_regs(dqa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == C::STAGES) stage = 0, ph ^= 1;
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = q0 + rr + 8 * h;
      if (m >= Tq) continue;
      const size_t off = ((size_t)bh * Tq + m) * HD + ch0 + cc;
#pragma unroll
      for (int j = 0; j < C::NCH / 8; ++j)
        *reinterpret_cast<uint32_t*>(dq + off + 8 * j) =
            pack_bf16(dqa[4 * j + 2 * h] * scale, dqa[4 * j + 2 * h + 1] * scale);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a 3-D map over (heads, rows, HD) bf16, boxes of (1, box_rows, SW)
template <int HD>
CUresult tensor_map(EncodeTiled enc, CUtensorMap* map, const void* base, int heads, int rows,
                    int box_rows) {
  using L = Tile<HD>;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)rows * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::SW, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A tensor map that cannot be made returns TENSOR_MAP_ERROR + its CUresult
// (the wrapper says so); anything else is a cudaError_t.
constexpr int TENSOR_MAP_ERROR = 10000;

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int BH, int Tq, int S,
           int qoff, int groups, int causal, int window, float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // (1) first: the runtime's launch makes the device's primary context
  // current on this thread (autograd runs the backward on a thread of its
  // own), which the driver's encoder below needs
  const int rows = BH * Tq;
  flash_bwd_delta_kernel<bf><<<(rows + ::THREADS / 32 - 1) / (::THREADS / 32), ::THREADS, 0, st>>>(
      (const bf*)out, (const bf*)dout, delta, rows, HD);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int bkv = BH / groups;
  CUtensorMap kq, kk, kvv, kdo, qq, qk, qv, qdo;   // (2)'s and (3)'s maps
  const struct {
    CUtensorMap* map;
    const void* base;
    int heads, rows, box;
  } maps[8] = {{&kq, q, BH, Tq, KV<HD>::BM},   {&kdo, dout, BH, Tq, KV<HD>::BM},
               {&kk, k, bkv, S, KV<HD>::BN},   {&kvv, v, bkv, S, KV<HD>::BN},
               {&qq, q, BH, Tq, QD<HD>::BM},   {&qdo, dout, BH, Tq, QD<HD>::BM},
               {&qk, k, bkv, S, QD<HD>::BN},   {&qv, v, bkv, S, QD<HD>::BN}};
  for (const auto& m : maps) {
    const CUresult r = tensor_map<HD>(enc, m.map, m.base, m.heads, m.rows, m.box);
    if (r != CUDA_SUCCESS) return TENSOR_MAP_ERROR + (int)r;
  }
  e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, KV<HD>::SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, QD<HD>::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_wgmma_kernel<HD>
      <<<dim3((S + KV<HD>::BN - 1) / KV<HD>::BN, bkv), THREADS, KV<HD>::SMEM, st>>>(
          kq, kk, kvv, kdo, lse, delta, (bf*)dk, (bf*)dv, Tq, S, qoff, groups, causal, window,
          scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_wgmma_kernel<HD>
      <<<dim3(BH, (Tq + QD<HD>::BM - 1) / QD<HD>::BM), THREADS, QD<HD>::SMEM, st>>>(
          qq, qk, qv, qdo, lse, delta, (bf*)dq, Tq, S, qoff, groups, causal, window, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int BH, int Tq, int S,
             int HD, int qoff, int groups, int causal, int window, float scale, cudaStream_t st) {
#define B3_BWD_CASE(D)                                                                        \
  case D:                                                                                   \
    return launch<D>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Tq, S, qoff, groups,    \
                     causal, window, scale, st);
  switch (HD) {
    B3_BWD_CASE(32)
    B3_BWD_CASE(64)
    B3_BWD_CASE(128)
    B3_BWD_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef B3_BWD_CASE
}

}  // namespace hop

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int BH, int Tq,
             int S, int HD, int qoff, int groups, int causal, int window, float scale,
             cudaStream_t st) {
#define B3_BWD_CASE(D)                                                                        \
  case D:                                                                                   \
    return launch<T, D>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Tq, S, qoff, groups, \
                        causal, window, scale, st);
  switch (HD) {
    B3_BWD_CASE(32)
    B3_BWD_CASE(64)
    B3_BWD_CASE(128)
    B3_BWD_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef B3_BWD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout and the gradients);
// lse (BH, Tq) f32 from B3; delta (BH, Tq) f32 scratch; query row i at
// position q_offset + i over keys [0, S). Returns a cudaError_t, or 10000 +
// the CUresult of a bf16 tensor map that could not be made.
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v, const void* out,
                                 const void* dout, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int dtype, int BH, int Tq, int S, int HD,
                                 int groups, int causal, int window, int q_offset, float scale,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Tq <= 0 || BH <= 0 || S <= 0) return (int)cudaGetLastError();
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, dout, (const float*)lse, (float*)delta, dq, dk, dv,
                           BH, Tq, S, HD, q_offset, groups, causal, window, scale, st);
  if (dtype == 1)
    return hop::dispatch(q, k, v, out, dout, (const float*)lse, (float*)delta, dq, dk, dv, BH,
                         Tq, S, HD, q_offset, groups, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
