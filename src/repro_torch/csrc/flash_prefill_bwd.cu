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
// scores (B3's optional output). Masks as B3 at q_offset 0: causal keeps
// kpos <= qpos, window > 0 keeps kpos > qpos - window. With
// P = exp(scale * Q K^T - lse) (masked entries 0) and D = rowsum(dO * O):
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the `groups` query heads of a KV head.
//
// Three launches, no atomics (every gradient is the same bits from run to
// run): (1) D, one warp per row; (2) dK/dV, one CTA per (KV head, BN-key
// tile), looping over the group's query heads and every BM-row query tile
// that sees its keys (tiles entirely above the diagonal or past the window
// are skipped); (3) dQ, one CTA per (query head, BM-row query tile), looping
// over the key tiles its rows see (longest tiles launched first, as B3).
//
// Arithmetic is f32 on the CUDA cores: bf16 inputs are widened as they are
// staged into shared memory, and the gradients are written in the inputs'
// dtype. Bound on this card: operations — 10*HD flops per (query, key)
// pair kept (S and dP recomputed, dV, dK, dQ); this first version does 14*HD
// (S and dP are recomputed in both (2) and (3)) at the f32 rate, and each
// product is a register-tiled loop over tiles in shared memory (rows padded
// to HD + 1 floats, so a warp reading one channel of 32 rows hits 32 banks).
// The Hopper redesign (wgmma on bf16 tiles, TMA, one pass) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

__device__ __forceinline__ bool kept(int qpos, int kpos, int Tq, int S, int causal,
                                     int window) {
  return qpos < Tq && kpos < S && (!causal || kpos <= qpos) &&
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
                      T* __restrict__ dk, T* __restrict__ dv, int Tq, int S, int groups,
                      int causal, int window, float scale) {
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
  const int m_begin = causal ? n0 / BM * BM : 0;
  const int m_end = window > 0 ? min(Tq, n_last + window) : Tq;
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
          p[i][j] = kept(m0 + m, n0 + n, Tq, S, causal, window)
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
                    int groups, int causal, int window, float scale) {
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
  const int n_end = causal ? min(S, m_last + 1) : S;
  const int n_begin = (window > 0 ? max(0, m0 - window + 1) : 0) / BN * BN;
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
        const float pr = kept(m0 + m, n0 + n, Tq, S, causal, window)
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
           int S, int groups, int causal, int window, float scale, cudaStream_t st) {
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
      S, groups, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, HD><<<dim3(BH, (Tq + C::Q_BM - 1) / C::Q_BM), THREADS, C::Q_SMEM,
                               st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, Tq, S,
      groups, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int BH, int Tq,
             int S, int HD, int groups, int causal, int window, float scale,
             cudaStream_t st) {
  switch (HD) {
    case 32: return launch<T, 32>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Tq, S,
                                  groups, causal, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Tq, S,
                                  groups, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Tq, S,
                                    groups, causal, window, scale, st);
    case 256: return launch<T, 256>(q, k, v, out, dout, lse, delta, dq, dk, dv, BH, Tq, S,
                                    groups, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout and the gradients);
// lse (BH, Tq) f32 from B3; delta (BH, Tq) f32 scratch.
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v, const void* out,
                                 const void* dout, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int dtype, int BH, int Tq, int S, int HD,
                                 int groups, int causal, int window, float scale,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Tq <= 0 || BH <= 0 || S <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, dout, (const float*)lse, (float*)delta, dq, dk, dv,
                           BH, Tq, S, HD, groups, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, dout, (const float*)lse, (float*)delta, dq,
                                   dk, dv, BH, Tq, S, HD, groups, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
