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
// 2*HD*2 bytes per key row reused by a whole query tile.
//
// bf16 (what full-width serving runs): tensor cores. mma.sync m16n8k16
// (bf16 in, f32 accumulate) with ldmatrix operands; wgmma + TMA is the next
// redesign. A CTA owns BQ = 64 query rows, one warp per 16; its Q tile goes
// to registers once. K and V stream in BK = 64-key tiles through a
// two-stage cp.async ring in shared memory (rows padded by 16 B, so
// ldmatrix is free of bank conflicts), the next tile's load in flight
// while this one is computed. S = Q·K^T and the online softmax stay in
// registers (exp2f on scores pre-scaled by log2(e)/sqrt(HD)); P is split in
// registers into a bf16 pair hi + lo and fed back as the A operand of two
// MMAs, O += P_hi·V + P_lo·V (ldmatrix.trans on V): P rounded to one bf16
// alone misses the one-ulp check on the early rows (few keys, large
// weights, cancelling V terms), and the pair costs half again the MMAs. Tiles entirely above the diagonal or before the
// window are never loaded; only diagonal and edge tiles are masked. The
// grid is (BH, T/BQ) with the query tiles launched last-first, so the
// longest rows of the causal triangle start first on the 132 SMs.
//
// f32: the first CUDA-core kernel, unchanged. f32 on the tensor cores is
// TF32 (10-bit mantissa), which would break the f32 contract (1e-5 against
// the plain version; the small serving path's logits within 3e-4 of the
// CPU). A CTA owns BQ = 64 query rows (two threads per row, each holding
// half the channels of q and of the accumulator in registers) and streams
// BK = 32-key tiles of K and V through shared memory as f32; float4 reads
// of shared memory give 4 FMAs per load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 2 * BQ;

// Thread (row, h) owns channels {8*i + 4*h + c : i < HD/8, c < 4}.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int Tq, int S,
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
      qr[4 * i + c] = row_ok ? q[((size_t)bh * Tq + qi) * HD + d] * scale : 0.f;
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
        kx = k[off];
        vx = v[off];
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
        out[((size_t)bh * Tq + qi) * HD + d] = acc[4 * i + c] * inv;
      }
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int BH, int Tq,
               int S, int HD, int groups, int causal, int window, int q_offset, float scale,
               cudaStream_t st) {
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
#define B3_LAUNCH(D)                                                                   \
  flash_prefill_kernel<D><<<grid, THREADS, 0, st>>>(                                   \
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Tq, S, groups,   \
      causal, window, q_offset, scale)
  switch (HD) {
    case 32: B3_LAUNCH(32); break;
    case 64: B3_LAUNCH(64); break;
    case 128: B3_LAUNCH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef B3_LAUNCH
  return (int)cudaGetLastError();
}


// ---- bf16 branch: tensor cores -------------------------------------------
namespace tc {

constexpr int BQ = 64;               // query rows per CTA
constexpr int BK = 64;               // keys per tile
constexpr int WARPS = BQ / 16;       // one warp per 16 query rows
constexpr int THREADS = 32 * WARPS;

template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;                   // padded row, elements
  static constexpr int Q_BYTES = BQ * LD * 2;
  static constexpr int TILE_BYTES = BK * LD * 2;      // one K or V tile
  static constexpr int BYTES = Q_BYTES + 4 * TILE_BYTES;   // Q, K x2, V x2
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row-major fragment) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 (x0 the lower column, in the low half) → bf16x2 hi = rn(x) and
// lo = rn(x - hi): hi + lo carries x to ~2^-17 relative, where hi alone
// carries 2^-9 (one bf16 P fails the 1e-4 + 2^-7·|o| check on early rows,
// whose few large weights meet cancelling V terms).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// rows [r0, r0 + ROWS) of a (rows, HD) bf16 matrix into a padded shared
// tile; rows at or past `rmax` are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, int r0,
                                          int rmax) {
  constexpr int CPR = HD / 8;                          // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, ch = c % CPR;
    const bool ok = r0 + r < rmax;
    const __nv_bfloat16* g = ok ? src + (size_t)(r0 + r) * HD + ch * 8 : src;
    cp_async16(dst + (uint32_t)((r * Layout<HD>::LD + ch * 8) * 2), g, ok);
  }
}

// Thread (warp w, lane = 4*gq + t4) holds, of each 16x8 accumulator tile,
// rows 16w + gq and 16w + gq + 8 at columns 2*t4 and 2*t4 + 1.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_prefill_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          int Tq, int S, int groups, int causal, int window, int q_offset,
                          float scale_log2) {
  using L = Layout<HD>;
  constexpr int LD = L::LD;
  constexpr int KSTEPS = HD / 16;    // k-steps of S = Q K^T
  constexpr int NT = BK / 8;         // 8-key column tiles of S
  constexpr int DT = HD / 8;         // 8-channel column tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t q_sm = smem_addr(smem);
  const uint32_t k_sm = q_sm + L::Q_BYTES;               // stage s at + s * TILE_BYTES
  const uint32_t v_sm = k_sm + 2 * L::TILE_BYTES;

  const int bh = blockIdx.x;
  const int qb = ((int)gridDim.y - 1 - (int)blockIdx.y) * BQ;   // longest tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* qg = q + (size_t)bh * Tq * HD;
  const __nv_bfloat16* kg = k + (size_t)(bh / groups) * S * HD;
  const __nv_bfloat16* vg = v + (size_t)(bh / groups) * S * HD;

  const int q_first = q_offset + qb;
  const int q_last = q_offset + min(qb + BQ, Tq) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int k_begin = (window > 0 ? max(0, q_first - window + 1) : 0) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_rows<HD, BQ>(q_sm, qg, qb, Tq);
  if (n_tiles > 0) {
    load_rows<HD, BK>(k_sm, kg, k_begin, S);
    load_rows<HD, BK>(v_sm, vg, k_begin, S);
  }
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};   // rows gq, gq + 8
  const int qpos0 = q_first + 16 * warp + gq;
  // ldmatrix.x4 lane offsets: A operand (Q, P) and K's B operand
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = ((lane >> 4) & 1) * 8;
  const int kb_row = (lane & 7) + ((lane >> 4) & 1) * 8, kb_col = ((lane >> 3) & 1) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = k_begin + it * BK;
    const uint32_t stage = (uint32_t)(it & 1) * L::TILE_BYTES;
    if (it + 1 < n_tiles) {         // the next tile into the other stage
      const uint32_t next = (uint32_t)((it + 1) & 1) * L::TILE_BYTES;
      load_rows<HD, BK>(k_sm + next, kg, kb + BK, S);
      load_rows<HD, BK>(v_sm + next, vg, kb + BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm_x4(qf[kk], q_sm + (uint32_t)(((16 * warp + a_row) * LD + 16 * kk + a_col) * 2));
    }

    // S = Q K^T (16 x BK per warp)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, k_sm + stage +
                       (uint32_t)(((16 * jp + kb_row) * LD + 16 * kk + kb_col) * 2));
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale to log2 units; mask only the diagonal and edge tiles
    const bool edge = kb + BK > S || (causal && kb + BK - 1 > q_first) ||
                      (window > 0 && kb <= q_last - window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = kb + 8 * j + 2 * t4 + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
      }
    }

    // online softmax; a row's four threads share its max (quad shuffles),
    // each keeps its own partial sum until the end
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // nothing live yet
      const float corr = exp2f(m_run[r] - m_use);
      m_run[r] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_use);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_use);
        ps += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_run[r] = l_run[r] * corr + ps;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * r] *= corr;
        o[d][2 * r + 1] *= corr;
      }
    }

    // O += P V: P, split into bf16 hi + lo in registers, is the A operand
    // of two MMAs per V fragment (V via ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, v_sm + stage +
                             (uint32_t)(((16 * kk + a_row) * LD + 16 * dp + a_col) * 2));
        mma_bf16(o[2 * dp], hi, b[0], b[1]);
        mma_bf16(o[2 * dp], lo, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();                // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-20f);
    const int row = qb + 16 * warp + gq + 8 * r;
    if (row < Tq) {
      __nv_bfloat16* dst = out + ((size_t)bh * Tq + row) * HD + 2 * t4;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
            __floats2bfloat162_rn(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int Tq, int S,
           int groups, int causal, int window, int q_offset, float scale, cudaStream_t st) {
  constexpr int bytes = Layout<HD>::BYTES;
  // set on every launch (cheap): the attribute is per device
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  flash_prefill_bf16_kernel<HD><<<grid, THREADS, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, Tq, S, groups, causal, window, q_offset,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* out,
                             int dtype, int BH, int Tq, int S, int HD, int groups,
                             int causal, int window, int q_offset, float scale,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Tq <= 0 || BH <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return launch_f32(q, k, v, out, BH, Tq, S, HD, groups, causal, window, q_offset, scale,
                      st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (HD) {
    case 32: return tc::launch<32>(q, k, v, out, BH, Tq, S, groups, causal, window, q_offset,
                                   scale, st);
    case 64: return tc::launch<64>(q, k, v, out, BH, Tq, S, groups, causal, window, q_offset,
                                   scale, st);
    case 128: return tc::launch<128>(q, k, v, out, BH, Tq, S, groups, causal, window,
                                     q_offset, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
