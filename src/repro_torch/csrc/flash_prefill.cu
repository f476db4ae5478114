// Kernel B3: dense causal / windowed flash attention for prefill, for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_prefill/kernel.py::flash_attention_pallas
// (the JAX model runs its XLA twin models/attention.py::flash_attention_xla).
// q (BH, T, HD), k/v (BKV, S, HD), BH = BKV * groups; query row i of
// row-group bh sits at absolute position q_offset + i and attends keys
// kpos <= qpos (causal) with kpos > qpos - window (window > 0). GQA is
// index arithmetic: row-group bh reads K/V row-group bh / groups. Output in
// q's dtype (f32 or bf16); scores, softmax and accumulation in f32.
//
// Bound on this card: operations — 4*HD flops per (query, key) pair against
// 2*HD*2 bytes per key row reused by a whole query tile. Design of this
// first version: CUDA-core f32 FMAs, no tensor cores (wgmma/TMA are later
// work). A CTA owns BQ = 64 query rows (two threads per row, each holding
// half the channels of q and of the accumulator in registers) and streams
// BK = 32-key tiles of K and V through shared memory as f32; float4 reads
// of shared memory give 4 FMAs per load. Tiles entirely above the diagonal
// (or before the window) are skipped; a ragged T or S is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 2 * BQ;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Thread (row, h) owns channels {8*i + 4*h + c : i < HD/8, c < 4}.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Tq, int S,
                     int groups, int causal, int window, int q_offset, float scale) {
  constexpr int NH = HD / 2;            // channels per thread
  __shared__ __align__(16) float ks[BK][HD];
  __shared__ __align__(16) float vs[BK][HD];
  const int bh = blockIdx.y;
  const int bkv = bh / groups;
  const int row = threadIdx.x >> 1;
  const int h = threadIdx.x & 1;
  const int qb = (int)blockIdx.x * BQ;   // first query row of the tile
  const int qi = qb + row;
  const bool row_ok = qi < Tq;
  const int qpos = q_offset + qi;

  float qr[NH], acc[NH];
#pragma unroll
  for (int i = 0; i < NH / 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 8 * i + 4 * h + c;
      qr[4 * i + c] = row_ok ? to_f(q[((size_t)bh * Tq + qi) * HD + d]) * scale : 0.f;
      acc[4 * i + c] = 0.f;
    }
  }

  const int q_first = q_offset + qb;
  const int q_last = q_offset + min(qb + BQ, Tq) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float m = -1e30f, l = 0.f;
  for (int kb = k_begin; kb < k_end; kb += BK) {
    __syncthreads();                      // previous tile fully consumed
    for (int e = threadIdx.x; e < BK * HD; e += THREADS) {
      const int r = e / HD, c = e % HD;
      const int kr = kb + r;
      float kx = 0.f, vx = 0.f;
      if (kr < S) {
        const size_t off = ((size_t)bkv * S + kr) * HD + c;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    __syncthreads();

    float sc[BK];
    float mt = -1e30f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NH / 4; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][8 * i + 4 * h]);
        part += qr[4 * i] * kk.x + qr[4 * i + 1] * kk.y + qr[4 * i + 2] * kk.z +
                qr[4 * i + 3] * kk.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const int kpos = kb + j;
      const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      sc[j] = ok ? part : -1e30f;
      mt = fmaxf(mt, sc[j]);
    }
    const float mnew = fmaxf(m, mt);
    const float corr = expf(m - mnew);
#pragma unroll
    for (int i = 0; i < NH; ++i) acc[i] *= corr;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kpos = kb + j;
      const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      const float p = ok ? expf(sc[j] - mnew) : 0.f;
      ps += p;
#pragma unroll
      for (int i = 0; i < NH / 4; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][8 * i + 4 * h]);
        acc[4 * i] += p * vv.x;
        acc[4 * i + 1] += p * vv.y;
        acc[4 * i + 2] += p * vv.z;
        acc[4 * i + 3] += p * vv.w;
      }
    }
    l = l * corr + ps;
    m = mnew;
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < NH / 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 8 * i + 4 * h + c;
        out[((size_t)bh * Tq + qi) * HD + d] = from_f<T>(acc[4 * i + c] * inv);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int Tq, int S,
           int HD, int groups, int causal, int window, int q_offset, float scale,
           cudaStream_t st) {
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
#define B3_LAUNCH(D)                                                                   \
  flash_prefill_kernel<T, D><<<grid, THREADS, 0, st>>>(                                \
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Tq, S, groups, causal, window, \
      q_offset, scale)
  switch (HD) {
    case 32: B3_LAUNCH(32); break;
    case 64: B3_LAUNCH(64); break;
    case 128: B3_LAUNCH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef B3_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* out,
                             int dtype, int BH, int Tq, int S, int HD, int groups,
                             int causal, int window, int q_offset, float scale,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Tq <= 0 || BH <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return launch<float>(q, k, v, out, BH, Tq, S, HD, groups, causal, window, q_offset,
                         scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, BH, Tq, S, HD, groups, causal, window,
                                 q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
