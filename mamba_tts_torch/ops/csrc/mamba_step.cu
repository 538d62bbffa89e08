// The Mamba block's decode step between its projections, Hopper (sm_90a):
// two kernels a layer a step that read and write the decode carry's conv
// window and SSM state in place.
//
// Replaces no TPU kernel: XLA fuses the JAX step (mamba_tts_tpu/models/
// mamba.py MambaBlock.step and ops/selective_scan.py selective_scan_step)
// into its own loops.  It was added because the port's plain step
// (ops/mamba_step.py conv_step_ref and ssm_step_ref) runs as a chain of
// about 30 small PyTorch kernels a layer a step (casts, the conv window's
// cat, A = -exp(A_log), five f32 products over (B, d_state, d_inner), the
// gates), and the decode then copies every new window and state back into
// its carry.  The four projections (in_proj, x_proj, dt_proj with its bias,
// out_proj) stay matrix products outside, as does the jamba block's
// dt_norm.
//
// mamba_conv_step_kernel, one thread a (row, 8 channels), 16-byte loads
// along d_inner:
//
//     x_conv[b, c] = r(silu(r(r(sum_k window[b, k, c] * r(w[k, c])) + r(bias[c]))))
//     window'[b]   = [window[b, 1:], xin[b]]            (written over window[b] in place)
//
// r rounds to the compute dtype T: bf16 (the served decoders) or f32 (no
// rounding).  window (B, K-1, D) in T, xin the x half of in_proj's output
// where chunk leaves it (row stride xin_stride), the taps w (K, D) in their
// held dtype (f32 or bf16; rounded to T first, as the plain step casts
// them), the bias (D) f32, bf16 or none.  The products of two bf16 values
// are exact in f32, so in bf16 the f32 sum differs from the plain einsum's
// only by its order.
//
// mamba_ssm_step_kernel<N>, one thread a (row, channel) with its N state
// values in registers; for each n the warp's 32 channels are 128 contiguous
// bytes of h:
//
//     delta  = softplus(f32(dt[b, c]))                               (f32, threshold 20)
//     B', C' = r(rmsnorm(B)), r(rmsnorm(C)) over the N values        (with the block's norms)
//     h'[n]  = exp(delta * -exp(A_log[c, n])) * h[n] + (delta * u) * B'[n]
//     y      = r(r(sum_n C'[n] * h'[n] + u * D[c]) * r(silu(z)))
//
// u = x_conv[b, c], z the gate half of in_proj's output where chunk leaves
// it, B and C slices of x_proj's output (their own row strides).  The state
// h (B, N, D) f32 is read once and written once, in place where h_out is
// h_in.  Every f32 product and sum of the state update is its own IEEE
// operation (__fmul_rn, __fadd_rn: no fused multiply-add), in the plain
// step's order; expf, log1pf and IEEE division, no fast-math.  Only the
// order of the sum over n (and of the norms' sums of squares) differs.
//
// What bounds them on an H100: bytes.  At the jamba block's B = 16, N = 16,
// d_inner 5,120 the state is 5.24 MB a layer, read and written: 10.5 MB, and
// about 0.6 MB of the other operands, 3.3 us at 3.35 TB/s; the conv kernel's
// 0.7 MB 0.2 us.  Both are too small to fill the card for long, so their
// design only keeps every byte read once and enough loads in flight: each
// thread starts its N state loads before it computes.
//
// No atomics, no shared memory, one launch a call each: capturable in a CUDA
// graph, and a rerun is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads a block, both kernels
constexpr int kChan = 8;       // channels a thread of the conv kernel: 16 bytes of bf16
constexpr float kSoftplusThreshold = 20.0f;

// the compute dtype's rounding: bf16 (round to nearest even) or none (f32)
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// 8 consecutive values of T, moved as whole 16-byte words (one for bf16, two for f32)
template <typename T>
struct Vec8 {
  static constexpr int kWords = sizeof(T) * kChan / 16;
  uint4 w[kWords];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < kWords; ++i) reinterpret_cast<uint4*>(p)[i] = w[i];
  }
  __device__ __forceinline__ void to_float(float* out) const {
    const T* v = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int i = 0; i < kChan; ++i) out[i] = to_f32(v[i]);
  }
  __device__ __forceinline__ void from_float(const float* in) {
    T* v = reinterpret_cast<T*>(w);
#pragma unroll
    for (int i = 0; i < kChan; ++i) v[i] = from_f32<T>(in[i]);
  }
};

// 8 values from f32 or bf16 memory, as f32 (p is 16-byte aligned)
__device__ __forceinline__ void load8(const void* p, bool bf16, float* out) {
  if (bf16) {
    Vec8<__nv_bfloat16> v;
    v.load(static_cast<const __nv_bfloat16*>(p));
    v.to_float(out);
  } else {
    Vec8<float> v;
    v.load(static_cast<const float*>(p));
    v.to_float(out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mamba_conv_step_kernel(
    const T* __restrict__ xin, long long xin_stride, const T* win_in, T* win_out,
    const void* __restrict__ taps, int taps_bf16, const void* __restrict__ bias, int bias_kind,
    T* __restrict__ x_conv, int D, int K) {
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kChan;
  if (c0 >= D) return;
  const size_t b = blockIdx.y;
  const size_t row = b * (size_t)(K - 1) * D + c0;  // window[b, 0, c0]
  Vec8<T> x_new, cur;
  x_new.load(xin + b * xin_stride + c0);
  const size_t tap_bytes = taps_bf16 ? 2 : 4;
  float acc[kChan];
#pragma unroll
  for (int i = 0; i < kChan; ++i) acc[i] = 0.0f;
  // window element k is state row k for k < K-1 and the new input at K-1;
  // row k of the new window is element k+1, written once element k+1 is read
  if (K > 1) cur.load(win_in + row); else cur = x_new;
  for (int k = 0; k < K; ++k) {
    float x[kChan], w[kChan];
    cur.to_float(x);
    load8(static_cast<const char*>(taps) + ((size_t)k * D + c0) * tap_bytes, taps_bf16, w);
#pragma unroll
    for (int i = 0; i < kChan; ++i) acc[i] = fmaf(x[i], round_to<T>(w[i]), acc[i]);
    if (k + 1 < K) {
      Vec8<T> next;
      if (k + 1 < K - 1) next.load(win_in + row + (size_t)(k + 1) * D); else next = x_new;
      next.store(win_out + row + (size_t)k * D);
      cur = next;
    }
  }
  float bv[kChan];
  if (bias_kind) load8(static_cast<const char*>(bias) + (size_t)c0 * (bias_kind == 2 ? 2 : 4),
                       bias_kind == 2, bv);
#pragma unroll
  for (int i = 0; i < kChan; ++i) {
    float c = round_to<T>(acc[i]);
    if (bias_kind) c = round_to<T>(c + round_to<T>(bv[i]));
    acc[i] = silu(c);
  }
  Vec8<T> out;
  out.from_float(acc);
  out.store(x_conv + b * D + c0);
}

// RMSNorm over N values as models/layers.py RMSNorm rounds it to T:
// (x * rsqrt(mean(x^2) + eps)) * w
template <int N, typename T>
__device__ __forceinline__ void rms_norm(float* v, const float* __restrict__ w, float eps) {
  float ss = 0.0f;
#pragma unroll
  for (int n = 0; n < N; ++n) ss = fmaf(v[n], v[n], ss);
  const float r = rsqrtf(ss / N + eps);
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = round_to<T>(__fmul_rn(__fmul_rn(v[n], r), w[n]));
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads) mamba_ssm_step_kernel(
    const T* __restrict__ dt, const float* __restrict__ A_log, const T* __restrict__ u,
    const T* __restrict__ z, long long z_stride, const T* __restrict__ Bm, long long b_stride,
    const T* __restrict__ Cm, long long c_stride, const float* __restrict__ wB,
    const float* __restrict__ wC, float eps, const float* __restrict__ Dskip, const float* h_in,
    float* h_out, T* __restrict__ y, int D) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  const size_t b = blockIdx.y;
  const size_t base = b * N * (size_t)D + c;  // h[b, 0, c]
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = h_in[base + (size_t)n * D];
  float Bv[N], Cv[N], al[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    Bv[n] = to_f32(Bm[b * b_stride + n]);
    Cv[n] = to_f32(Cm[b * c_stride + n]);
  }
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    const float4 a = *reinterpret_cast<const float4*>(A_log + (size_t)c * N + n);
    al[n] = a.x; al[n + 1] = a.y; al[n + 2] = a.z; al[n + 3] = a.w;
  }
  if (wB != nullptr) {
    rms_norm<N, T>(Bv, wB, eps);
    rms_norm<N, T>(Cv, wC, eps);
  }
  const float x = to_f32(dt[b * D + c]);
  const float delta = x > kSoftplusThreshold ? x : log1pf(expf(x));
  const float uu = to_f32(u[b * D + c]);
  const float du = __fmul_rn(delta, uu);
  float acc = 0.0f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float a = expf(__fmul_rn(delta, -expf(al[n])));
    const float hn = __fadd_rn(__fmul_rn(a, h[n]), __fmul_rn(du, Bv[n]));
    h_out[base + (size_t)n * D] = hn;
    acc = fmaf(hn, Cv[n], acc);
  }
  const float yv = round_to<T>(__fadd_rn(acc, __fmul_rn(uu, Dskip[c])));
  const float gate = round_to<T>(silu(to_f32(z[b * z_stride + c])));
  y[b * D + c] = from_f32<T>(yv * gate);
}

template <typename T>
cudaError_t launch_conv(dim3 grid, cudaStream_t stream, const void* xin, long long xin_stride,
                        const void* win_in, void* win_out, const void* taps, int taps_bf16,
                        const void* bias, int bias_kind, void* x_conv, int D, int K) {
  mamba_conv_step_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xin), xin_stride, static_cast<const T*>(win_in),
      static_cast<T*>(win_out), taps, taps_bf16, bias, bias_kind, static_cast<T*>(x_conv), D, K);
  return cudaGetLastError();
}

template <int N, typename T>
cudaError_t launch_ssm(dim3 grid, cudaStream_t stream, const void* dt, const void* A_log,
                       const void* u, const void* z, long long z_stride, const void* Bm,
                       long long b_stride, const void* Cm, long long c_stride, const void* wB,
                       const void* wC, float eps, const void* Dskip, const void* h_in,
                       void* h_out, void* y, int D) {
  mamba_ssm_step_kernel<N, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const float*>(A_log), static_cast<const T*>(u),
      static_cast<const T*>(z), z_stride, static_cast<const T*>(Bm), b_stride,
      static_cast<const T*>(Cm), c_stride, static_cast<const float*>(wB),
      static_cast<const float*>(wC), eps, static_cast<const float*>(Dskip),
      static_cast<const float*>(h_in), static_cast<float*>(h_out), static_cast<T*>(y), D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return the cudaError_t of the launch (0 on success).  Pointers are
// device pointers; strides count elements; f32: the activations (xin, the
// window, x_conv, dt, z, B, C, y) are f32, else bf16.  The wrapper
// (ops/mamba_step.py) guarantees dtypes, contiguity and 16-byte alignment;
// these refuse sizes they do not lay out with cudaErrorInvalidValue.

// taps_bf16: the taps (K, D) are bf16, else f32; bias_kind: 0 none, 1 f32,
// 2 bf16.  win_out may be win_in (the carry's window, shifted in place).
int mamba_conv_step_launch(const void* xin, long long xin_stride, const void* win_in,
                           void* win_out, const void* taps, int taps_bf16, const void* bias,
                           int bias_kind, void* x_conv, int B, int D, int K, int f32,
                           void* stream) {
  if (B < 1 || B > 65535 || D < kChan || D % kChan || K < 1 || K > 64 || xin_stride % kChan ||
      bias_kind < 0 || bias_kind > 2 || (bias_kind != 0) != (bias != nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((D / kChan + kThreads - 1) / kThreads, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(f32 ? launch_conv<float>(grid, s, xin, xin_stride, win_in, win_out, taps,
                                        taps_bf16, bias, bias_kind, x_conv, D, K)
                   : launch_conv<__nv_bfloat16>(grid, s, xin, xin_stride, win_in, win_out, taps,
                                                taps_bf16, bias, bias_kind, x_conv, D, K));
}

// wB, wC: the B and C norms' weights (N) f32, both or neither.  h_out may be
// h_in (the carry's state, updated in place).  N is 4, 8 or 16.
int mamba_ssm_step_launch(const void* dt, const void* A_log, const void* u, const void* z,
                          long long z_stride, const void* Bm, long long b_stride,
                          const void* Cm, long long c_stride, const void* wB, const void* wC,
                          float eps, const void* Dskip, const void* h_in, void* h_out, void* y,
                          int B, int D, int N, int f32, void* stream) {
  if (B < 1 || B > 65535 || D < 1 || (wB == nullptr) != (wC == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MAMBA_SSM_CASE(n)                                                                     \
  case n:                                                                                     \
    return (int)(f32 ? launch_ssm<n, float>(grid, s, dt, A_log, u, z, z_stride, Bm, b_stride, \
                                            Cm, c_stride, wB, wC, eps, Dskip, h_in, h_out, y, \
                                            D)                                                \
                     : launch_ssm<n, __nv_bfloat16>(grid, s, dt, A_log, u, z, z_stride, Bm,   \
                                                    b_stride, Cm, c_stride, wB, wC, eps,      \
                                                    Dskip, h_in, h_out, y, D));
  switch (N) {
    MAMBA_SSM_CASE(4)
    MAMBA_SSM_CASE(8)
    MAMBA_SSM_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MAMBA_SSM_CASE
}

const char* mamba_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
