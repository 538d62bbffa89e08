// W8A16 weight-streaming matvec for the int8 step decode, Hopper (sm_90a).
//
// Replaces the TPU kernel mamba_tts_tpu/ops/int8_matvec.py:38 (_matvec_kernel,
// reached through int8_matvec :46 / pallas_call :67).  It computes
//
//     y[b, n] = bf16( f32acc( sum_k bf16(x[b, k]) * float(w_q[k, n]) ) * scale[n] )
//
// for x (B <= 16, K) bf16, w_q (K, N) int8 row-major, scale (N,) f32 and
// y (B, N) bf16.  int8 -> float is exact and every product of a bf16 and an
// int8 value is exact in f32, so this is the TPU kernel's bf16 MXU product
// with f32 accumulation, with the per-column scale applied once at the end.
//
// What bounds it on an H100: weight bytes.  Each call reads K*N int8 once
// (1 MiB for in_proj 512x2048) against B*K*N*2 multiply-adds, far below the
// card's ops-per-byte balance, so the least time is K*N / 3.35 TB/s.  The 8
// decoder layers' int8 weights together are 32 MiB, which fits the 50 MB L2.
//
// The TPU kernel keeps the whole K in one block and tiles N by 512; on a
// 132-SM card that gives 1 to 4 blocks per call, so the design splits K too:
//   - grid (N/128 strips, S K-splits), S chosen by the wrapper so that about
//     2 x 132 blocks stream the weights; block s owns rows [s*Kc, (s+1)*Kc);
//   - its 32 lanes read 4 consecutive int8 columns each (one 32-bit load),
//     so a warp reads 128 contiguous bytes of a weight row: coalesced along N;
//     the block's 8 warps take rows k0+w, k0+w+8, ...; each thread keeps
//     BT x 4 f32 accumulators in registers;
//   - the block's x rows are staged in shared memory, transposed to [Kc][BT]
//     so every lane of a warp reads the same address (a broadcast);
//   - the 8 warps' sums are reduced through shared memory into one f32
//     partial per (split, b, n) in a workspace the wrapper allocates;
//   - a second kernel sums the S partials in a fixed order (deterministic),
//     applies scale and rounds to bf16.
// Shared memory is max(Kc*BT*2, 8*BT*128*4) bytes: 64 KB at BT = 16, which
// needs the dynamic-shared-memory opt-in above 48 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;               // int8 columns per thread (one 32-bit load)
constexpr int kLanes = 32;             // threads across the strip
constexpr int kWarps = 8;              // warps splitting a block's rows
constexpr int kStrip = kLanes * kCols; // 128 output columns per block

int batch_tile(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : B <= 8 ? 8 : 16; }

size_t smem_bytes(int bt, int rows) {
  size_t xs = (size_t)rows * bt * sizeof(__nv_bfloat16);
  size_t red = (size_t)kWarps * bt * kStrip * sizeof(float);
  return xs > red ? xs : red;
}

template <int BT>
__global__ void __launch_bounds__(kLanes * kWarps)
int8_matvec_partial(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                    float* __restrict__ part, int B, int K, int N, int Kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [Kc][BT]
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  constexpr int kThreads = kLanes * kWarps;
  const int k0 = blockIdx.y * Kc;
  const int rows = min(Kc, K - k0);

  // Stage this block's x rows transposed; rows b >= B (batch padded to BT) are zero.
  for (int i = tid; i < rows * BT; i += kThreads) {
    const int k = i / BT, b = i % BT;
    xs[i] = b < B ? x[(size_t)b * K + k0 + k] : __float2bfloat16(0.0f);
  }
  __syncthreads();

  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[b][j] = 0.0f;

  const int n0 = blockIdx.x * kStrip + threadIdx.x * kCols;
  if (n0 < N) {  // N % 4 == 0, so the whole 4-column group is in range
    const int8_t* wp = w + (size_t)k0 * N + n0;
#pragma unroll 4
    for (int k = threadIdx.y; k < rows; k += kWarps) {
      const char4 q = *reinterpret_cast<const char4*>(wp + (size_t)k * N);
      const float wf[kCols] = {(float)q.x, (float)q.y, (float)q.z, (float)q.w};
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float xv = __bfloat162float(xs[k * BT + b]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[b][j] = fmaf(xv, wf[j], acc[b][j]);
      }
    }
  }
  __syncthreads();  // x is no longer read: reuse its buffer for the reduction

  float* red = reinterpret_cast<float*>(smem);  // [kWarps][BT][kStrip]
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    float4 v = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    *reinterpret_cast<float4*>(&red[(threadIdx.y * BT + b) * kStrip + threadIdx.x * kCols]) = v;
  }
  __syncthreads();

  for (int i = tid; i < BT * kStrip; i += kThreads) {
    const int b = i / kStrip, c = i % kStrip;
    const int n = blockIdx.x * kStrip + c;
    if (b < B && n < N) {
      float s = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi * BT * kStrip + i];
      part[((size_t)blockIdx.y * B + b) * N + n] = s;
    }
  }
}

__global__ void int8_matvec_finish(const float* __restrict__ part, const float* __restrict__ scale,
                                   __nv_bfloat16* __restrict__ y, int B, int N, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // over B*N
  if (i >= B * N) return;
  float s = 0.0f;
  for (int si = 0; si < S; ++si) s += part[(size_t)si * B * N + i];
  y[i] = __float2bfloat16(s * scale[i % N]);
}

template <int BT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* y, void* work, int B,
                   int K, int N, int S, cudaStream_t stream) {
  const int Kc = (K + S - 1) / S;
  const size_t smem = smem_bytes(BT, Kc);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(int8_matvec_partial<BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + kStrip - 1) / kStrip, S), block(kLanes, kWarps);
  int8_matvec_partial<BT><<<grid, block, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(work), B, K, N, Kc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int threads = 256;
  int8_matvec_finish<<<(B * N + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(work), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(y), B, N, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 on success).  Pointers are
// device pointers; work is an f32 (S, B, N) workspace.  The wrapper
// guarantees 1 <= B <= 16, 1 <= S <= K, N % 4 == 0, contiguity and a
// 4-byte-aligned w.
int int8_matvec_launch(const void* x, const void* w, const void* scale, void* y, void* work,
                       int B, int K, int N, int S, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (batch_tile(B)) {
    case 1: return (int)launch<1>(x, w, scale, y, work, B, K, N, S, s);
    case 2: return (int)launch<2>(x, w, scale, y, work, B, K, N, S, s);
    case 4: return (int)launch<4>(x, w, scale, y, work, B, K, N, S, s);
    case 8: return (int)launch<8>(x, w, scale, y, work, B, K, N, S, s);
    default: return (int)launch<16>(x, w, scale, y, work, B, K, N, S, s);
  }
}

const char* int8_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
