// Selective scan (Mamba SSM) forward and backward for training, Hopper (sm_90a).
//
// Replaces the three TPU scan kernels of mamba_tts_tpu/ops/pallas_scan.py:
//   - _scan_kernel (:36, pallas_call :86): the forward, no checkpoints;
//   - _scan_kernel_ckpt (:121, pallas_call :427): the forward that also
//     writes the chunk-start states (the backward's rematerialization points);
//   - _scan_bwd_kernel (:160, pallas_call :261): the reverse adjoint scan.
// It computes, per batch row b, channel d and state index n,
//
//     h_t = exp(dt_t * A[d, n]) * h_{t-1} + dt_t * u_t * B_t[n]
//     y_t = sum_n C_t[n] * h_t + D[d] * u_t
//
// with u, B, C, y in the caller's dtype (bf16 on the main path, f32 in tests),
// dt, A, D and every state in f32.  ckpt[b, c] is the state at the START of
// chunk c (so ckpt[:, 0] is h0).  The backward emits du and ddt (B, T, D) f32
// without the D-skip term, per-channel-slice partials of dB and dC
// (B, D/16, T, N) f32 that the wrapper sums in a fixed order, dA per batch
// row (B, N, D) f32 and dh0 (B, N, D) f32, as the TPU kernel does.
//
// What bounds it on an H100: the forward reads u, dt and writes y once (8
// bytes per (b, t, d) in bf16) and does about seven f32 operations, one an
// exp, per (b, t, d, n): 14 operations per byte, near the card's f32 balance
// of 20, so bytes and operations bound it about evenly (exps run on the
// special-function units at an eighth of the FMA rate, which tips it to
// operations).  The backward recomputes the states and does about 26
// operations per (b, t, d, n): operations.  The time of this first version
// is set by neither but by the recurrence: each block walks T dependent
// steps (PERF.md has the numbers).
//
// The TPU kernel walks time chunks as a sequential grid dimension with the
// state in VMEM scratch and scans each chunk with Hillis-Steele.  Blocks on
// this card run in parallel and in no order, so the design gives each block
// a (batch row, slice of 16 channels) and lets it loop over ALL of T itself:
//   - one thread per (channel, state index n): h lives in a register and the
//     recurrence is one fma per step; nothing carries across blocks;
//   - y sums the N state lanes of a channel with a fixed-order xor-shuffle
//     tree (the N lanes are adjacent in a warp), so reruns are bit-identical;
//   - u, dt, B and C of a tile of 64 time steps are staged in shared memory
//     with coalesced loads; y is staged the same way and written as a tile.
// The backward walks the chunks in reverse inside the block: it recomputes
// the chunk's states from ckpt into shared memory (64 states per thread
// would spill registers), then runs the suffix adjoint
// hhat_t = dy_t * C_t + a_{t+1} * hhat_{t+1}, carrying a_t * hhat_t to the
// previous chunk.  Sums over n use the shuffle tree; sums over the block's
// channels (dB, dC) go warp by warp through shared memory in a fixed order.
// No float atomics anywhere.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCpb = 16;   // channels per block
constexpr int kTile = 64;  // time steps staged per pass of the forward

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t fwd_smem(int N) { return (size_t)(3 * kTile * kCpb + 2 * kTile * N) * sizeof(float); }

size_t bwd_smem(int N, int chunk) {
  const int threads = kCpb * N, warps = threads / 32;
  return (size_t)(chunk * threads          // recomputed states
                  + 5 * chunk * kCpb       // u, dt, dy in; du, ddt out
                  + 2 * chunk * N          // B, C
                  + 2 * chunk * warps * N  // per-warp dB, dC partials
                  ) * sizeof(float);
}

template <typename TU, bool CKPT>
__global__ void __launch_bounds__(512)
scan_fwd(const TU* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ A,
         const TU* __restrict__ Bm, const TU* __restrict__ Cm, const float* __restrict__ Dsk,
         const float* __restrict__ h0, TU* __restrict__ y, float* __restrict__ hT,
         float* __restrict__ ckpt, int L, int D, int N, int chunk, int nc) {
  extern __shared__ __align__(16) float sm[];
  float* su = sm;                    // [kTile][kCpb]
  float* sdt = su + kTile * kCpb;    // [kTile][kCpb]
  float* sy = sdt + kTile * kCpb;    // [kTile][kCpb]
  float* sB = sy + kTile * kCpb;     // [kTile][N]
  float* sC = sB + kTile * N;        // [kTile][N]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n = tid & (N - 1), cl = tid / N;
  const int b = blockIdx.y, d0 = blockIdx.x * kCpb, d = d0 + cl;
  const bool valid = d < D;
  const float a_dn = valid ? A[(size_t)d * N + n] : 0.f;
  const float dsk = valid ? Dsk[d] : 0.f;
  float h = (valid && h0 != nullptr) ? h0[((size_t)b * N + n) * D + d] : 0.f;
  const size_t row0 = (size_t)b * L;
  int to_ckpt = 0, chunk_idx = 0;  // steps until the next chunk start, its index

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int tl = min(kTile, L - t0);
    for (int i = tid; i < kTile * kCpb; i += nthr) {
      const int tt = i / kCpb, c = i % kCpb;
      float uv = 0.f, dv = 0.f;
      if (tt < tl && d0 + c < D) {
        const size_t off = (row0 + t0 + tt) * D + d0 + c;
        uv = to_f(u[off]);
        dv = dt[off];
      }
      su[i] = uv;
      sdt[i] = dv;
    }
    for (int i = tid; i < kTile * N; i += nthr) {
      const int tt = i / N, k = i % N;
      float bv = 0.f, cv = 0.f;
      if (tt < tl) {
        const size_t off = (row0 + t0 + tt) * N + k;
        bv = to_f(Bm[off]);
        cv = to_f(Cm[off]);
      }
      sB[i] = bv;
      sC[i] = cv;
    }
    __syncthreads();
    for (int tt = 0; tt < tl; ++tt) {  // tl is the same for the whole block
      if (CKPT) {
        if (to_ckpt == 0) {
          if (valid) ckpt[(((size_t)b * nc + chunk_idx) * N + n) * D + d] = h;
          to_ckpt = chunk;
          ++chunk_idx;
        }
        --to_ckpt;
      }
      const float dv = sdt[tt * kCpb + cl], uv = su[tt * kCpb + cl];
      h = fmaf(expf(dv * a_dn), h, dv * uv * sB[tt * N + n]);
      float p = h * sC[tt * N + n];
      for (int off = N >> 1; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) sy[tt * kCpb + cl] = p + dsk * uv;
    }
    __syncthreads();
    for (int i = tid; i < tl * kCpb; i += nthr) {
      const int tt = i / kCpb, c = i % kCpb;
      if (d0 + c < D) y[(row0 + t0 + tt) * D + d0 + c] = from_f<TU>(sy[i]);
    }
    __syncthreads();
  }
  if (valid) hT[((size_t)b * N + n) * D + d] = h;
}

template <typename TU>
__global__ void __launch_bounds__(512)
scan_bwd(const TU* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ A,
         const TU* __restrict__ Bm, const TU* __restrict__ Cm, const float* __restrict__ ckpt,
         const float* __restrict__ dy, const float* __restrict__ dhT, float* __restrict__ du,
         float* __restrict__ ddt, float* __restrict__ dBp, float* __restrict__ dCp,
         float* __restrict__ dAb, float* __restrict__ dh0, int L, int D, int N, int chunk,
         int nc) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, nthr = blockDim.x, warps = nthr / 32;
  float* sh = sm;                          // [chunk][nthr] states h_t
  float* su = sh + chunk * nthr;           // [chunk][kCpb]
  float* sdt = su + chunk * kCpb;
  float* sdy = sdt + chunk * kCpb;
  float* sdu = sdy + chunk * kCpb;
  float* sddt = sdu + chunk * kCpb;
  float* sB = sddt + chunk * kCpb;         // [chunk][N]
  float* sC = sB + chunk * N;
  float* rB = sC + chunk * N;              // [chunk][warps][N]
  float* rC = rB + chunk * warps * N;
  const int n = tid & (N - 1), cl = tid / N, warp = tid / 32, lane = tid & 31;
  const int b = blockIdx.y, d0 = blockIdx.x * kCpb, d = d0 + cl;
  const int slices = gridDim.x;
  const bool valid = d < D;
  const float a_dn = valid ? A[(size_t)d * N + n] : 0.f;
  const size_t row0 = (size_t)b * L;
  const size_t sidx = ((size_t)b * N + n) * D + d;
  float g = valid ? dhT[sidx] : 0.f;  // a_{t+1} * hhat_{t+1}; dh_T at the end
  float dA = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk, tl = min(chunk, L - t0);
    for (int i = tid; i < chunk * kCpb; i += nthr) {
      const int tt = i / kCpb, cc = i % kCpb;
      float uv = 0.f, dv = 0.f, gv = 0.f;
      if (tt < tl && d0 + cc < D) {
        const size_t off = (row0 + t0 + tt) * D + d0 + cc;
        uv = to_f(u[off]);
        dv = dt[off];
        gv = dy[off];
      }
      su[i] = uv;
      sdt[i] = dv;
      sdy[i] = gv;
    }
    for (int i = tid; i < chunk * N; i += nthr) {
      const int tt = i / N, k = i % N;
      float bv = 0.f, cv = 0.f;
      if (tt < tl) {
        const size_t off = (row0 + t0 + tt) * N + k;
        bv = to_f(Bm[off]);
        cv = to_f(Cm[off]);
      }
      sB[i] = bv;
      sC[i] = cv;
    }
    __syncthreads();
    // recompute the chunk's states from its checkpoint
    const float hs = valid ? ckpt[(((size_t)b * nc + c) * N + n) * D + d] : 0.f;
    float h = hs;
    for (int tt = 0; tt < tl; ++tt) {
      const float dv = sdt[tt * kCpb + cl];
      h = fmaf(expf(dv * a_dn), h, dv * su[tt * kCpb + cl] * sB[tt * N + n]);
      sh[tt * nthr + tid] = h;
    }
    // suffix adjoint, last step first
    for (int tt = tl - 1; tt >= 0; --tt) {
      const float dv = sdt[tt * kCpb + cl], uv = su[tt * kCpb + cl], gy = sdy[tt * kCpb + cl];
      const float Bn = sB[tt * N + n], Cn = sC[tt * N + n];
      const float a = expf(dv * a_dn);
      const float hhat = fmaf(gy, Cn, g);
      const float hprev = tt > 0 ? sh[(tt - 1) * nthr + tid] : hs;
      const float ht = sh[tt * nthr + tid];
      float x_ddt = hhat * (a * hprev * a_dn + uv * Bn);
      float x_du = hhat * Bn;
      float x_dB = hhat * (dv * uv);
      float x_dC = ht * gy;
      dA += hhat * hprev * a * dv;
      g = a * hhat;
      for (int off = N >> 1; off > 0; off >>= 1) {
        x_ddt += __shfl_xor_sync(0xffffffffu, x_ddt, off);
        x_du += __shfl_xor_sync(0xffffffffu, x_du, off);
      }
      if (n == 0) {
        sddt[tt * kCpb + cl] = x_ddt;
        sdu[tt * kCpb + cl] = dv * x_du;
      }
      for (int off = N; off < 32; off <<= 1) {  // the warp's channels, same n
        x_dB += __shfl_xor_sync(0xffffffffu, x_dB, off);
        x_dC += __shfl_xor_sync(0xffffffffu, x_dC, off);
      }
      if (lane < N) {
        rB[(tt * warps + warp) * N + lane] = x_dB;
        rC[(tt * warps + warp) * N + lane] = x_dC;
      }
    }
    __syncthreads();
    for (int i = tid; i < tl * kCpb; i += nthr) {
      const int tt = i / kCpb, cc = i % kCpb;
      if (d0 + cc < D) {
        const size_t off = (row0 + t0 + tt) * D + d0 + cc;
        du[off] = sdu[i];
        ddt[off] = sddt[i];
      }
    }
    for (int i = tid; i < tl * N; i += nthr) {
      const int tt = i / N, k = i % N;
      float sb = 0.f, sc = 0.f;
      for (int w = 0; w < warps; ++w) {  // fixed order
        sb += rB[(tt * warps + w) * N + k];
        sc += rC[(tt * warps + w) * N + k];
      }
      const size_t off = (((size_t)b * slices + blockIdx.x) * L + t0 + tt) * N + k;
      dBp[off] = sb;
      dCp[off] = sc;
    }
    __syncthreads();
  }
  if (valid) {
    dAb[sidx] = dA;
    dh0[sidx] = g;
  }
}

template <typename TU>
cudaError_t launch_fwd(const void* u, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* Dsk, const void* h0, void* y, void* hT,
                       void* ckpt, int Bz, int L, int D, int N, int chunk, cudaStream_t s) {
  const int nc = (L + chunk - 1) / chunk;
  const size_t smem = fwd_smem(N);
  const dim3 grid((D + kCpb - 1) / kCpb, Bz), block(kCpb * N);
  if (ckpt != nullptr) {
    auto k = scan_fwd<TU, true>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    k<<<grid, block, smem, s>>>(static_cast<const TU*>(u), static_cast<const float*>(dt),
                                static_cast<const float*>(A), static_cast<const TU*>(Bm),
                                static_cast<const TU*>(Cm), static_cast<const float*>(Dsk),
                                static_cast<const float*>(h0), static_cast<TU*>(y),
                                static_cast<float*>(hT), static_cast<float*>(ckpt), L, D, N,
                                chunk, nc);
  } else {
    auto k = scan_fwd<TU, false>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    k<<<grid, block, smem, s>>>(static_cast<const TU*>(u), static_cast<const float*>(dt),
                                static_cast<const float*>(A), static_cast<const TU*>(Bm),
                                static_cast<const TU*>(Cm), static_cast<const float*>(Dsk),
                                static_cast<const float*>(h0), static_cast<TU*>(y),
                                static_cast<float*>(hT), nullptr, L, D, N, chunk, nc);
  }
  return cudaGetLastError();
}

template <typename TU>
cudaError_t launch_bwd(const void* u, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* ckpt, const void* dy, const void* dhT,
                       void* du, void* ddt, void* dBp, void* dCp, void* dAb, void* dh0, int Bz,
                       int L, int D, int N, int chunk, cudaStream_t s) {
  const int nc = (L + chunk - 1) / chunk;
  const size_t smem = bwd_smem(N, chunk);
  const dim3 grid((D + kCpb - 1) / kCpb, Bz), block(kCpb * N);
  auto k = scan_bwd<TU>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  k<<<grid, block, smem, s>>>(
      static_cast<const TU*>(u), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const TU*>(Bm), static_cast<const TU*>(Cm), static_cast<const float*>(ckpt),
      static_cast<const float*>(dy), static_cast<const float*>(dhT), static_cast<float*>(du),
      static_cast<float*>(ddt), static_cast<float*>(dBp), static_cast<float*>(dCp),
      static_cast<float*>(dAb), static_cast<float*>(dh0), L, D, N, chunk, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward.  Device pointers; u, B, C, y are bf16 when is_bf16 != 0, else f32;
// dt, A (D, N), Dsk (D,), h0 (B, N, D) (may be null: zeros), hT (B, N, D) and
// ckpt (B, ceil(L/chunk), N, D) are f32.  ckpt null selects the forward
// without checkpoints.  The wrapper guarantees contiguity, N in
// {2, 4, 8, 16}, L >= 1 and 1 <= chunk.
int selective_scan_fwd_launch(const void* u, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* Dsk, const void* h0, void* y, void* hT,
                              void* ckpt, int Bz, int L, int D, int N, int chunk, int is_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_fwd<__nv_bfloat16>(u, dt, A, Bm, Cm, Dsk, h0, y, hT, ckpt, Bz, L, D, N,
                                          chunk, s);
  return (int)launch_fwd<float>(u, dt, A, Bm, Cm, Dsk, h0, y, hT, ckpt, Bz, L, D, N, chunk, s);
}

// Backward.  dy (B, L, D), dhT (B, N, D) f32; outputs du, ddt (B, L, D),
// dBp, dCp (B, ceil(D/16), L, N), dAb, dh0 (B, N, D), all f32.
int selective_scan_bwd_launch(const void* u, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* ckpt, const void* dy, const void* dhT,
                              void* du, void* ddt, void* dBp, void* dCp, void* dAb, void* dh0,
                              int Bz, int L, int D, int N, int chunk, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_bwd<__nv_bfloat16>(u, dt, A, Bm, Cm, ckpt, dy, dhT, du, ddt, dBp, dCp, dAb,
                                          dh0, Bz, L, D, N, chunk, s);
  return (int)launch_bwd<float>(u, dt, A, Bm, Cm, ckpt, dy, dhT, du, ddt, dBp, dCp, dAb, dh0, Bz,
                                L, D, N, chunk, s);
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
