// The Mamba-2 (SSD) mixer's decode step between its conv and its gated norm,
// Hopper (sm_90a): one kernel a layer a step that reads and writes the decode
// carry's f32 state once, in place.
//
// Replaces no TPU kernel: the JAX package has no Mamba-2 mixer.  It sits in
// the granite decoder's step (mamba_tts_torch/models/mamba2.py
// Mamba2Mixer.step) after in_proj and the conv kernel of csrc/mamba_step.cu
// (mamba_conv_step_kernel, over x, B and C), and before the gated RMSNorm and
// out_proj, which stay outside: the norm sums over all heads.  It is a source
// of its own so that the decoders that never call it never build it.
//
// mamba2_ssm_step_kernel<N, P>, one block of 128 threads a (row, head); each
// warp takes P / 4 of the head's P channels, each lane N / 32 = 4 state values
// of a channel (one 16-byte load and store: a warp's channel is 512
// contiguous bytes of h).  With one group (B and C shared by every head):
//
//     delta = softplus(f32(dt[b, h]) + dt_bias[h])                  (threshold 20)
//     dA    = exp(delta * -exp(A_log[h]))
//     h'[p, n] = h[p, n] * dA + (delta * x[p]) * B[n]
//     y[p]     = (sum_n h'[p, n] * C[n] + x[p] * D[h]) * silu(z[p])   (f32 out)
//
// x, B and C are the conv kernel's output (x the first H * P channels, B and C
// the next N each; one row stride), z and dt slices of in_proj's output (their
// row strides), all in the compute dtype T (bf16, or f32); dt_bias, A_log and D
// (H) f32; h (B, H, P, N) f32, h_out may be h_in.  Every f32 product and sum of
// the state update is its own IEEE operation (__fmul_rn, __fadd_rn: no fused
// multiply-add) in the plain step's order (ops/mamba_step.py mamba2_step_ref),
// with expf and log1pf and no fast-math, so the state is the plain version's
// bit for bit; only the order of the sum over n differs (a butterfly over the
// lanes).  y stays f32 for the norm, which squares it over every channel.
//
// What bounds it on an H100: bytes.  At granite's B = 16, 128 heads of 64
// channels, N = 128, the state is 67.1 MB a layer, read and written: 134 MB,
// 40 us at 3.35 TB/s; the other operands are under 1 MB.  Each thread starts
// its P / 4 state loads before it computes, so a block keeps 64 KB in flight.
//
// No atomics, no shared memory, one launch a call: capturable in a CUDA graph,
// and a rerun is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kSoftplusThreshold = 20.0f;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

template <int N, int P, typename T>
__global__ void __launch_bounds__(kThreads) mamba2_ssm_step_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
    long long xbc_stride, const T* __restrict__ z, long long z_stride,
    const T* __restrict__ dt, long long dt_stride, const float* __restrict__ dt_bias,
    const float* __restrict__ A_log, const float* __restrict__ Dskip, const float* h_in,
    float* h_out, float* __restrict__ y, int H) {
  static_assert(N == 128, "four state values a lane");
  static_assert(P % kWarps == 0, "whole channels a warp");
  constexpr int kRows = P / kWarps;  // channels a warp
  const int head = blockIdx.x;
  const size_t b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = ((size_t)b * H + head) * P * N + lane * 4;  // h[b, head, 0, 4 lane]

  float4 hv[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    hv[i] = *reinterpret_cast<const float4*>(h_in + base + (size_t)(warp + i * kWarps) * N);

  const float draw = to_f32(dt[b * dt_stride + head]) + dt_bias[head];
  const float delta = draw > kSoftplusThreshold ? draw : log1pf(expf(draw));
  const float dA = expf(__fmul_rn(delta, -expf(A_log[head])));
  const float Dh = Dskip[head];
  float Bv[4], Cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    Bv[j] = to_f32(Bm[b * xbc_stride + lane * 4 + j]);
    Cv[j] = to_f32(Cm[b * xbc_stride + lane * 4 + j]);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int p = warp + i * kWarps;
    const int c = head * P + p;
    const float xp = to_f32(x[b * xbc_stride + c]);
    const float dx = __fmul_rn(delta, xp);
    float hn[4] = {hv[i].x, hv[i].y, hv[i].z, hv[i].w};
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hn[j] = __fadd_rn(__fmul_rn(hn[j], dA), __fmul_rn(dx, Bv[j]));
      acc = fmaf(hn[j], Cv[j], acc);
    }
    *reinterpret_cast<float4*>(h_out + base + (size_t)p * N) =
        make_float4(hn[0], hn[1], hn[2], hn[3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float yv = __fadd_rn(acc, __fmul_rn(xp, Dh));
      y[b * (size_t)H * P + c] = __fmul_rn(yv, silu(to_f32(z[b * z_stride + c])));
    }
  }
}

template <typename T>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* x, const void* Bm, const void* Cm,
                   long long xbc_stride, const void* z, long long z_stride, const void* dt,
                   long long dt_stride, const void* dt_bias, const void* A_log,
                   const void* Dskip, const void* h_in, void* h_out, void* y, int H) {
  mamba2_ssm_step_kernel<128, 64, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      xbc_stride, static_cast<const T*>(z), z_stride, static_cast<const T*>(dt), dt_stride,
      static_cast<const float*>(dt_bias), static_cast<const float*>(A_log),
      static_cast<const float*>(Dskip), static_cast<const float*>(h_in),
      static_cast<float*>(h_out), static_cast<float*>(y), H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  Pointers are device
// pointers; strides count elements; f32: x, B, C, z and dt are f32, else bf16.
// The wrapper (ops/mamba_step.py mamba2_step) guarantees dtypes, layouts and
// 16-byte alignment of h; this refuses shapes it has no instance for (N 128,
// P 64) with cudaErrorInvalidValue.
int mamba2_ssm_step_launch(const void* x, const void* Bm, const void* Cm, long long xbc_stride,
                           const void* z, long long z_stride, const void* dt,
                           long long dt_stride, const void* dt_bias, const void* A_log,
                           const void* Dskip, const void* h_in, void* h_out, void* y, int B,
                           int H, int P, int N, int f32, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || N != 128 || P != 64) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(f32 ? launch<float>(grid, s, x, Bm, Cm, xbc_stride, z, z_stride, dt, dt_stride,
                                   dt_bias, A_log, Dskip, h_in, h_out, y, H)
                   : launch<__nv_bfloat16>(grid, s, x, Bm, Cm, xbc_stride, z, z_stride, dt,
                                           dt_stride, dt_bias, A_log, Dskip, h_in, h_out, y,
                                           H));
}

const char* mamba_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
