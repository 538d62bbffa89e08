// Flash (streamed-softmax) cross-attention, forward and backward, Hopper (sm_90a).
//
// Replaces the TPU flash attention that mamba_tts_tpu/models/attention.py:25
// (_flash_attend, dispatched at :110-117 for Tq >= 128) takes from jax's
// pallas.ops.tpu.flash_attention, forward and backward.  It computes, per
// (batch, head),
//
//     S = q K^T * scale + bias,  bias[k] = 0 where memory_mask[b, k] else -1e9
//     O = softmax(S) V,          lse = logsumexp(S) per query row
//
// for q (B, H, Tq, 64), K and V (B, H, Tk, 64) and O in bf16, lse f32, with f32
// products and an f32 online softmax.  The -1e9 bias is the plain path's
// (attention.py:104); keys beyond Tk get -inf and count for nothing.  Ragged
// Tq and Tk are masked inside the kernel, not padded.  The backward takes
// Delta = rowsum(dO * O) from a small first kernel, then one kernel for dK and
// dV (a block per key tile, looping over query tiles) and one for dQ (a block
// per query tile, looping over key tiles), each recomputing P from lse.
// Every sum runs in a fixed order and there are no atomics, so reruns are
// bit-identical.
//
// What bounds it on an H100: operations.  At the flagship training shapes
// (B = 8, H = 8, Tq = 5,120, Tk = 5,376, head_dim 64) the forward is 2 x 2 x
// B·H·Tq·Tk·64 = 0.45 TFLOP against 0.1 GB of q, K, V and O.  This first
// version multiplies with f32 FMAs (67 TFLOP/s peak) rather than the bf16
// tensor cores (989 TFLOP/s): each block keeps its tiles in shared memory
// as f32, with a row stride of 68 floats so that the 16-byte loads of
// neighbouring rows fall in different banks, and each of 256 threads owns a
// 4 x 4 register tile with rows ty + 16 i and columns tx + 16 j.  The 16
// threads that share a query row are 16 adjacent lanes, so row maxima and
// sums are xor-shuffle trees.  wgmma / mma.sync tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;       // head dim
constexpr int kBq = 64;       // query rows per tile
constexpr int kBk = 64;       // keys per tile
constexpr int kS = 68;        // shared-memory row stride (floats)
constexpr int kThreads = 256;  // 16 x 16
constexpr float kMasked = -1e9f;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Load a (64, 64) bf16 tile (rows [r0, r0 + 64) of a (rows, 64) matrix) into
// shared memory as f32, rows >= rows zero; row-major with stride kS.
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src, int r0, int rows) {
  for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
    const int r = i % 64, ch = i / 64;  // lanes walk rows: conflict-free stores
    float v[8];
    if (r0 + r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * kHd + ch * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * kS + ch * 8 + j] = v[j];
  }
}

// As load_tile, but transposed: dst[d * kS + r].
__device__ __forceinline__ void load_tile_t(float* dst, const __nv_bfloat16* src, int r0, int rows) {
  for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
    const int r = i % 64, ch = i / 64;
    float v[8];
    if (r0 + r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * kHd + ch * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(ch * 8 + j) * kS + r] = v[j];
  }
}

// Key bias of a key tile: 0 (valid), -1e9 (masked out), -inf (beyond Tk).
__device__ __forceinline__ void load_bias(float* bias, const uint8_t* mask, int b, int k0, int Tk) {
  for (int i = threadIdx.x; i < kBk; i += kThreads) {
    const int k = k0 + i;
    bias[i] = k >= Tk ? -INFINITY : (mask == nullptr || mask[(size_t)b * Tk + k]) ? 0.f : kMasked;
  }
}

// acc[i][j] = sum_d X[(ty + 16 i)][d] * Y[(tx + 16 j)][d] for row-major tiles.
__device__ __forceinline__ void dot_rows(float acc[4][4], const float* X, const float* Y, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kHd; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(X + (ty + 16 * i) * kS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld4(Y + (tx + 16 * j) * kS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
flash_fwd(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
          __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Tq, int Tk,
          float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;              // [q][d]
  float* Ks = Qs + 64 * kS;    // [k][d]
  float* Vt = Ks + 64 * kS;    // [d][k]
  float* Ps = Vt + 64 * kS;    // [q][k]
  float* bias = Ps + 64 * kS;  // [k]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kBq;
  const __nv_bfloat16* qb = q + (size_t)bh * Tq * kHd;
  const __nv_bfloat16* kb = k + (size_t)bh * Tk * kHd;
  const __nv_bfloat16* vb = v + (size_t)bh * Tk * kHd;
  load_tile(Qs, qb, q0, Tq);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < Tk; k0 += kBk) {
    load_tile(Ks, kb, k0, Tk);
    load_tile_t(Vt, vb, k0, Tk);
    load_bias(bias, mask, b, k0, Tk);
    __syncthreads();
    float s[4][4];
    dot_rows(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] * scale + bias[tx + 16 * j];
        mx = fmaxf(mx, s[i][j]);
      }
      const float mnew = fmaxf(m[i], row_max16(mx));  // finite: every tile has a key < Tk
      const float corr = expf(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mnew);
        Ps[(ty + 16 * i) * kS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    // acc[i][j] += sum_k P[ty + 16 i][k] * V[k][tx + 16 j]
#pragma unroll 4
    for (int kk = 0; kk < kBk; kk += 4) {
      float4 p[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ld4(Ps + (ty + 16 * i) * kS + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = ld4(Vt + (tx + 16 * j) * kS + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(p[i].x, vv[j].x, acc[i][j]);
          acc[i][j] = fmaf(p[i].y, vv[j].y, acc[i][j]);
          acc[i][j] = fmaf(p[i].z, vv[j].z, acc[i][j]);
          acc[i][j] = fmaf(p[i].w, vv[j].w, acc[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[((size_t)bh * Tq + r) * kHd + tx + 16 * j] = __float2bfloat16(acc[i][j] * inv);
    if (tx == 0) lse[(size_t)bh * Tq + r] = m[i] + logf(l[i]);
  }
}

// Delta[row] = sum_d dO[row, d] * O[row, d]; one warp per row.
__global__ void flash_bwd_delta(const __nv_bfloat16* __restrict__ o,
                                const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                                long long rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * kHd;
  float s = __bfloat162float(o[base + lane]) * __bfloat162float(dout[base + lane]) +
            __bfloat162float(o[base + lane + 32]) * __bfloat162float(dout[base + lane + 32]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// P and dS of one (query tile, key tile) pair for the thread's 4 x 4 entries:
// P = exp(S * scale + bias - lse), dS = P * (dO V^T - Delta).  Rows beyond Tq
// carry lse = +inf (P = 0) and zero dO.
__device__ __forceinline__ void p_and_ds(float P[4][4], float dS[4][4], const float* Qs,
                                         const float* Ks, const float* dOs, const float* Vs,
                                         const float* bias, const float* lse_s,
                                         const float* delta_s, float scale, int ty, int tx) {
  dot_rows(P, Qs, Ks, ty, tx);
  float dP[4][4];
  dot_rows(dP, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ls = lse_s[ty + 16 * i], dl = delta_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      P[i][j] = expf(P[i][j] * scale + bias[tx + 16 * j] - ls);
      dS[i][j] = P[i][j] * (dP[i][j] - dl);
    }
  }
}

__device__ __forceinline__ void load_rowstats(float* lse_s, float* delta_s, const float* lse,
                                              const float* delta, size_t base, int q0, int Tq) {
  for (int i = threadIdx.x; i < kBq; i += kThreads) {
    const bool ok = q0 + i < Tq;
    lse_s[i] = ok ? lse[base + q0 + i] : INFINITY;
    delta_s[i] = ok ? delta[base + q0 + i] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
               const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;               // [k][d]
  float* Vs = Ks + 64 * kS;     // [k][d]
  float* Qs = Vs + 64 * kS;     // [q][d]
  float* dOs = Qs + 64 * kS;    // [q][d]
  float* Ps = dOs + 64 * kS;    // [q][k]
  float* dSs = Ps + 64 * kS;    // [q][k]
  float* bias = dSs + 64 * kS;  // [k]
  float* lse_s = bias + kBk;    // [q]
  float* delta_s = lse_s + kBq; // [q]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, k0 = blockIdx.x * kBk;
  const size_t qbase = (size_t)bh * Tq;
  load_tile(Ks, k + (size_t)bh * Tk * kHd, k0, Tk);
  load_tile(Vs, v + (size_t)bh * Tk * kHd, k0, Tk);
  load_bias(bias, mask, b, k0, Tk);
  // dK[c][d], dV[c][d] for c = ty + 16 i, d = tx + 16 j
  float dK[4][4], dV[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dK[i][j] = dV[i][j] = 0.f;
  for (int q0 = 0; q0 < Tq; q0 += kBq) {
    load_tile(Qs, q + qbase * kHd, q0, Tq);
    load_tile(dOs, dout + qbase * kHd, q0, Tq);
    load_rowstats(lse_s, delta_s, lse, delta, qbase, q0, Tq);
    __syncthreads();
    float P[4][4], dS[4][4];
    p_and_ds(P, dS, Qs, Ks, dOs, Vs, bias, lse_s, delta_s, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * kS + tx + 16 * j] = P[i][j];
        dSs[(ty + 16 * i) * kS + tx + 16 * j] = dS[i][j];
      }
    __syncthreads();
    // dV[c][d] += sum_r P[r][c] dO[r][d];  dK[c][d] += sum_r dS[r][c] Q[r][d]
#pragma unroll 4
    for (int r = 0; r < kBq; ++r) {
      float p[4], ds[4], go[4], qq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[r * kS + ty + 16 * i];
        ds[i] = dSs[r * kS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        go[j] = dOs[r * kS + tx + 16 * j];
        qq[j] = Qs[r * kS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dV[i][j] = fmaf(p[i], go[j], dV[i][j]);
          dK[i][j] = fmaf(ds[i], qq[j], dK[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Tk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t off = ((size_t)bh * Tk + c) * kHd + tx + 16 * j;
      dk[off] = __float2bfloat16(dK[i][j] * scale);
      dv[off] = __float2bfloat16(dV[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
             const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int Tq,
             int Tk, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;               // [q][d]
  float* dOs = Qs + 64 * kS;    // [q][d]
  float* Ks = dOs + 64 * kS;    // [k][d]
  float* Vs = Ks + 64 * kS;     // [k][d]
  float* dSs = Vs + 64 * kS;    // [q][k]
  float* bias = dSs + 64 * kS;  // [k]
  float* lse_s = bias + kBk;    // [q]
  float* delta_s = lse_s + kBq; // [q]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kBq;
  const size_t qbase = (size_t)bh * Tq;
  load_tile(Qs, q + qbase * kHd, q0, Tq);
  load_tile(dOs, dout + qbase * kHd, q0, Tq);
  load_rowstats(lse_s, delta_s, lse, delta, qbase, q0, Tq);
  float dQ[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dQ[i][j] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += kBk) {
    load_tile(Ks, k + (size_t)bh * Tk * kHd, k0, Tk);
    load_tile(Vs, v + (size_t)bh * Tk * kHd, k0, Tk);
    load_bias(bias, mask, b, k0, Tk);
    __syncthreads();
    float P[4][4], dS[4][4];
    p_and_ds(P, dS, Qs, Ks, dOs, Vs, bias, lse_s, delta_s, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * kS + tx + 16 * j] = dS[i][j];
    __syncthreads();
    // dQ[r][d] += sum_c dS[r][c] K[c][d] for r = ty + 16 i, d = tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kBk; c += 4) {
      float4 ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = ld4(dSs + (ty + 16 * i) * kS + c);
      float kk[4][4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < 4; ++j) kk[cc][j] = Ks[(c + cc) * kS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dQ[i][j] = fmaf(ds[i].x, kk[0][j], dQ[i][j]);
          dQ[i][j] = fmaf(ds[i].y, kk[1][j], dQ[i][j]);
          dQ[i][j] = fmaf(ds[i].z, kk[2][j], dQ[i][j]);
          dQ[i][j] = fmaf(ds[i].w, kk[3][j], dQ[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[((size_t)bh * Tq + r) * kHd + tx + 16 * j] = __float2bfloat16(dQ[i][j] * scale);
  }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Forward.  q (B, H, Tq, 64), k and v (B, H, Tk, 64), o (B, H, Tq, 64) bf16,
// contiguous; mask (B, Tk) bytes (true = valid) or null; lse (B, H, Tq) f32.
// The wrapper guarantees Tq, Tk >= 1 and 16-byte-aligned rows.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, const void* mask,
                               void* o, void* lse, int B, int H, int Tq, int Tk, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (4 * 64 * kS + kBk) * sizeof(float);
  cudaError_t e = opt_in(flash_fwd, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + kBq - 1) / kBq, B * H);
  flash_fwd<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Tq, Tk, scale);
  return (int)cudaGetLastError();
}

// Backward.  o, lse from the forward; dout (B, H, Tq, 64) bf16; delta a
// (B, H, Tq) f32 workspace; dq, dk, dv bf16 in the layouts of q, k, v.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* mask,
                               const void* o, const void* lse, const void* dout, void* delta,
                               void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * H * Tq;
  flash_bwd_delta<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (6 * 64 * kS + kBk + 2 * kBq) * sizeof(float);
  e = opt_in(flash_bwd_dkdv, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<<<dim3((Tk + kBk - 1) / kBk, B * H), kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(lse), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_q = (5 * 64 * kS + kBk + 2 * kBq) * sizeof(float);
  e = opt_in(flash_bwd_dq, smem_q);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<<<dim3((Tq + kBq - 1) / kBq, B * H), kThreads, smem_q, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(lse), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H, Tq, Tk, scale);
  return (int)cudaGetLastError();
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
