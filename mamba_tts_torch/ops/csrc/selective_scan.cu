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
// dt, A, D and every state and adjoint in f32.  ckpt[b, c] is the state at the
// START of chunk c (so ckpt[:, 0] is h0).  The backward emits du and ddt
// (B, T, D) f32 without the D-skip term, dB and dC partials per cluster of
// channel slices (B, G, T, N) f32, dA partials per chunk (B, nc, N, D) f32
// (the wrapper sums both in a fixed order) and dh0 (B, N, D) f32.
//
// What bounds it on an H100: the exps.  Every (b, t, d, n) needs one
// exp(dt * A) on the special-function unit (16 a clock per SM: 4.2 T/s), a
// handful of FMA-pipe operations (7 in the forward, 26 in the backward, at
// 67 TFLOP/s) and few bytes (about 8 per (b, t, d) in the forward).  The
// first version gave each block a (row, 16 channels) and let it walk all T
// steps in series: one dependent chain of 5,120 steps per block.
//
// This design is chunk-parallel over the checkpoints.  A chunk of C steps
// maps its start state to its end state as h_end = P_c h_start + S_c with
// P_c = exp(A sum_{t in c} dt_t), and the adjoint into it from the adjoint
// out of it as g_in = P_c g_out + Q_c.  Each direction is three launches:
//   1. summary, every chunk in parallel: S_c from a zero start (forward) or
//      Q_c from a zero adjoint (backward), and sum dt per (b, c, d);
//   2. carry, one thread per (b, n, d) over the chunks in order (forward) or
//      in reverse (backward): the true start state of every chunk (that IS
//      ckpt, and h_T) or the true adjoint at every chunk's end (and dh0);
//   3. every chunk in parallel from its true start: y (forward); states
//      recomputed from ckpt, then the adjoint with its true carry, giving
//      du, ddt and the dB/dC/dA partials (backward).
// The forward without checkpoints runs the same launches with the starts
// in a workspace, so its y and h_T equal the checkpointing forward's bit for
// bit.  C is a template parameter (16 or 64), so the time loops unroll and
// the exps of later steps issue ahead of the fma chain.
//
// The summaries and the forward's output pass keep no state across steps
// beyond the recurrence, so a thread owns one channel and all N of its
// states in registers (kRowThreads channels a block): u, dt and dy come
// straight from their (B, T, D) rows, 256 channels a load; B and C of the
// chunk wait in shared memory and every lane reads the same address; y and
// the sums over n stay inside the thread.  Each step is one exp, two fmas
// and a multiply per state: the exps bound it.
//
// The gradient pass needs each step's state in the reverse sweep, so its
// block is 16 channels x N states, one thread per (channel, n), and it
// holds the recomputed states of 8 steps at a time in registers: a first
// sweep over the chunk writes each 8-step segment's start state to shared
// memory, and each segment is recomputed just before its reverse pass; the
// segment loop is not unrolled, so one segment's code stays in the
// instruction cache.  Sums over n (du, ddt) and over a warp's
// channels (dB, dC) go through one reduce-scatter of shuffles per step: the
// first level splits the two values between the partner lanes, so four sums
// cost five shuffles, not ten.  A chunk's inputs are staged in shared memory
// through registers, every load issued before the first store.
//
// dB and dC sum over every channel.  The gradient blocks of one (row, chunk
// group) that own consecutive 16-channel slices run as a thread-block
// cluster of S <= 8 (the portable size).  After each 8-step segment a block
// sums its warps' partials in a fixed order and pushes each value to the
// rank that owns its 16-byte piece with st.async stores counted on that
// rank's mbarrier (no cluster barrier in the loop); an owner sums the S
// pieces in rank order 0..S-1 and writes one partial per cluster:
// G = ceil(D/16/S) partials (8 at d_inner 1,024; the first design wrote 64).
// No float atomics anywhere: reruns are bit-identical.  Every pass fits in
// at most 56 KB of shared memory and 64 registers a thread, so 4 blocks of
// 256 threads are resident on an SM.  Every block takes one chunk: on the
// card many short blocks balance better than fewer that walk several
// chunks.  The launch plan (grids, cluster size,
// shared memory) is made in Python
// (ops/pallas_scan.py:scan_launch_plan); the launchers here refuse a plan
// whose layout they compute differently.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCpb = 16;          // gradient pass: channels per block, one dB/dC slice
constexpr int kRowThreads = 256;  // summaries and output pass: channels (threads) per block
constexpr int kSeg = 8;           // gradient pass: steps whose states a thread holds at once
constexpr int kMaxCluster = 8;    // portable cluster size
constexpr int kCarryThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Stride of a staged [channel][t] tile: the padding puts neighbouring rows on other banks.
__host__ __device__ constexpr int row_len(int C) { return C + 4; }

// ---- shared-memory layouts, in floats; mirrored by _pass_smem in ../pallas_scan.py
size_t fwd_summary_floats(int N, int C) { return (size_t)C * N; }      // B
size_t fwd_output_floats(int N, int C) { return (size_t)2 * C * N; }   // B, C
size_t bwd_summary_floats(int N, int C) { return (size_t)C * N; }      // C
int bwd_units(int N) { return kSeg * 2 * N / 4; }  // 16-byte pieces of a segment's dB/dC partial
int bwd_slot_floats(int N, int S) { return 4 * ((bwd_units(N) + S - 1) / S); }
size_t bwd_grad_fixed_floats(int N, int C) {
  const int T = kCpb * N;
  return (size_t)3 * kCpb * row_len(C)  // u, dt, dy
         + 2 * C * N                    // B, C
         + (C / kSeg) * T               // each segment's start state
         + kSeg * N * N                 // the warps' dB/dC partials [kSeg][N/2][2N]
         + 2 * kSeg * kCpb              // ddt, du of a segment
         + 2 * N * kCpb;                // start-state and carry tiles
}
size_t bwd_grad_floats(int N, int C, int S) {
  return bwd_grad_fixed_floats(N, C) + 2 * (size_t)S * bwd_slot_floats(N, S);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x on the special-function unit: one MUFU.EX2 (exp2f adds a denormal
// range fix-up around it); a result below 2^-126 flushes to 0, far inside
// every tolerance of the states and gradients.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sums v[0..K) over the lanes of a warp that differ only in the lane bits
// OFF, OFF/2, ..., LO (powers of two).  The first levels split the values:
// the lane with the bit set keeps the upper half and adds its partner's
// copy of it; once one value is left, the remaining levels all-reduce.  A
// lane ends with v[0 .. rs_held) = the sums of values [rs_base, rs_base +
// rs_held).  Every sum is taken in the same order on every run.
template <int K, int OFF, int LO>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (OFF >= LO) {
    if constexpr (K > 1) {
      constexpr int H = K / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float keep = up ? v[i + H] : v[i];
        const float give = up ? v[i] : v[i + H];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, give, OFF);
      }
      reduce_scatter<H, OFF / 2, LO>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<1, OFF / 2, LO>(v, lane);
    }
  }
}

template <int K, int OFF, int LO>
__device__ __forceinline__ int rs_base(int lane) {
  if constexpr (OFF >= LO && K > 1) {
    return ((lane & OFF) ? K / 2 : 0) + rs_base<K / 2, OFF / 2, LO>(lane);
  } else {
    return 0;
  }
}

template <int K, int OFF, int LO>
__host__ __device__ constexpr int rs_held() {
  if constexpr (OFF >= LO && K > 1) return rs_held<K / 2, OFF / 2, LO>();
  else return K;
}

// The lane bits that were all-reduced: the lanes where they are 0 write.
template <int K, int OFF, int LO>
__host__ __device__ constexpr int rs_shared_bits() {
  if constexpr (OFF < LO) return 0;
  else if constexpr (K > 1) return rs_shared_bits<K / 2, OFF / 2, LO>();
  else return OFF | rs_shared_bits<1, OFF / 2, LO>();
}

// A chunk is staged into shared memory through registers: a kernel first
// issues every load of the chunk (load_*), then stores them (store_*), so
// staging waits about one memory latency, not one per element.  NT threads.
//
// kCpb channels x C steps of a (B, L, D) array, for tile[c][t]; zero beyond
// tl steps or D channels.
template <int C, int NT, typename TS>
__device__ __forceinline__ void load_channels(float (&v)[C * kCpb / NT], const TS* src,
                                              size_t row0, int tl, int D, int d0, int tid) {
#pragma unroll
  for (int k = 0; k < C * kCpb / NT; ++k) {
    const int i = tid + k * NT, t = i / kCpb, c = i % kCpb;
    v[k] = t < tl && d0 + c < D ? to_f(src[(row0 + t) * D + d0 + c]) : 0.f;
  }
}

template <int C, int NT>
__device__ __forceinline__ void store_channels(float* tile, const float (&v)[C * kCpb / NT],
                                               int tid) {
#pragma unroll
  for (int k = 0; k < C * kCpb / NT; ++k) {
    const int i = tid + k * NT;
    tile[(i % kCpb) * row_len(C) + i / kCpb] = v[k];
  }
}

// C steps x N of a (B, L, N) array, in its own [t][n] order; zero beyond tl
// steps.  K = ceil(C * N / NT) values a thread.
template <int C, int N, int NT, typename TS>
__device__ __forceinline__ void load_states(float (&v)[(C * N + NT - 1) / NT], const TS* src,
                                            size_t row0, int tl, int tid) {
#pragma unroll
  for (int k = 0; k < (C * N + NT - 1) / NT; ++k) {
    const int i = tid + k * NT, t = i / N;
    v[k] = i < C * N && t < tl ? to_f(src[(row0 + t) * N + i % N]) : 0.f;
  }
}

template <int K, int NT>
__device__ __forceinline__ void store_rows(float* tile, const float (&v)[K], int tid, int size = K * NT) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (tid + k * NT < size) tile[tid + k * NT] = v[k];
  }
}

// A state tile [N][kCpb] from rows src[k * D + d0 + c] of a (., N, D) array:
// the block's threads read 16 channels of a row together.  Thread tid
// holds element tid of the tile (NT = N * kCpb).
__device__ __forceinline__ float load_tile(const float* src, int D, int d0, int tid) {
  const int k = tid / kCpb, c = tid % kCpb;
  return d0 + c < D ? src[(size_t)k * D + d0 + c] : 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------ summaries and output pass
//
// Thread d of a block owns channel blockIdx.x * kRowThreads + d and its N
// states; the block takes chunk blockIdx.y.  The chunk's B (and C) rows
// [t][n] sit in shared memory.

template <int C, int N, int NB>
struct RowStage {  // NB (B, T, N) arrays of one chunk, staged through registers
  static constexpr int K = (C * N + kRowThreads - 1) / kRowThreads;
  float v[NB][K];
  template <typename TU>
  __device__ __forceinline__ void load(const TU* const (&src)[NB], int b, int L, int c, int tid) {
    const int tl = min(C, L - c * C);
    const size_t row0 = (size_t)b * L + (size_t)c * C;
#pragma unroll
    for (int a = 0; a < NB; ++a) load_states<C, N, kRowThreads>(v[a], src[a], row0, tl, tid);
  }
  __device__ __forceinline__ void store(float* tile, int tid) const {
#pragma unroll
    for (int a = 0; a < NB; ++a) store_rows<K, kRowThreads>(tile + a * C * N, v[a], tid, C * N);
  }
};

// Pass 1 of the forward: per chunk, the end state from a zero start (into
// ws[b, c]) and sum dt (into sdt[b, c, d]).
template <typename TU, int C, int N>
__global__ void __launch_bounds__(kRowThreads, 4)
scan_fwd_summary(const TU* __restrict__ u, const float* __restrict__ dt,
                 const float* __restrict__ A, const TU* __restrict__ Bm,
                 float* __restrict__ ws, float* __restrict__ sdt, int L, int D, int nc) {
  extern __shared__ __align__(16) float sB[];  // [C][N]
  const int tid = threadIdx.x, b = blockIdx.z, c = blockIdx.y, d = blockIdx.x * kRowThreads + tid;
  const bool valid = d < D;
  float A2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) A2[n] = valid ? A[(size_t)d * N + n] * kLog2e : 0.f;
  const TU* const srcs[1] = {Bm};
  RowStage<C, N, 1> stage;
  stage.load(srcs, b, L, c, tid);
  stage.store(sB, tid);
  __syncthreads();
  const int tl = min(C, L - c * C);
  const size_t row0 = (size_t)b * L + (size_t)c * C;
  float h[N], dts = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;
#pragma unroll 8
  for (int t = 0; t < C; ++t) {
    const bool in = valid && t < tl;
    const float dv = in ? dt[(row0 + t) * D + d] : 0.f;
    const float du = in ? dv * to_f(u[(row0 + t) * D + d]) : 0.f;
    dts += dv;
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = fmaf(ex2(dv * A2[n]), h[n], du * sB[t * N + n]);
  }
  if (valid) {
#pragma unroll
    for (int n = 0; n < N; ++n) ws[(((size_t)b * nc + c) * N + n) * D + d] = h[n];
    sdt[((size_t)b * nc + c) * D + d] = dts;
  }
}

// Pass 2 (either direction): one thread per (b, n, d) walks the chunks, in
// order (reverse = 0) or in reverse; x starts at init (zero when null).
// ws[c] holds chunk c's summary on entry and the carry INTO it (the state at
// its start, or the adjoint at its end) on return; out gets the last carry
// (h_T, or dh0).
__global__ void __launch_bounds__(kCarryThreads)
scan_carry(const float* __restrict__ A, const float* __restrict__ init,
           const float* __restrict__ sdt, float* __restrict__ ws, float* __restrict__ out, int N,
           int D, int nc, int reverse) {
  constexpr int kAhead = 8;  // chunks whose loads are issued before their fmas
  const int i = blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= N * D) return;
  const int b = blockIdx.y, n = i / D, d = i % D;
  const float A2 = A[(size_t)d * N + n] * kLog2e;
  float x = init != nullptr ? init[((size_t)b * N + n) * D + d] : 0.f;
  for (int k0 = 0; k0 < nc; k0 += kAhead) {
    float s[kAhead], e[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int c = reverse ? nc - 1 - (k0 + j) : k0 + j;
      const bool in = k0 + j < nc;
      s[j] = in ? ws[(((size_t)b * nc + c) * N + n) * D + d] : 0.f;
      e[j] = in ? sdt[((size_t)b * nc + c) * D + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (k0 + j < nc) {
        const int c = reverse ? nc - 1 - (k0 + j) : k0 + j;
        ws[(((size_t)b * nc + c) * N + n) * D + d] = x;
        x = fmaf(ex2(A2 * e[j]), x, s[j]);
      }
    }
  }
  out[((size_t)b * N + n) * D + d] = x;
}

// Pass 3 of the forward: every chunk from its true start state ckpt[b, c]: y.
template <typename TU, int C, int N>
__global__ void __launch_bounds__(kRowThreads, 4)
scan_fwd_output(const TU* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const TU* __restrict__ Bm,
                const TU* __restrict__ Cm, const float* __restrict__ Dsk,
                const float* __restrict__ ckpt, TU* __restrict__ y, int L, int D, int nc) {
  extern __shared__ __align__(16) float sB[];  // [B, C][C][N]
  const float* sC = sB + C * N;
  const int tid = threadIdx.x, b = blockIdx.z, c = blockIdx.y, d = blockIdx.x * kRowThreads + tid;
  const bool valid = d < D;
  float A2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) A2[n] = valid ? A[(size_t)d * N + n] * kLog2e : 0.f;
  const float dsk = valid ? Dsk[d] : 0.f;
  const TU* const srcs[2] = {Bm, Cm};
  RowStage<C, N, 2> stage;
  stage.load(srcs, b, L, c, tid);
  stage.store(sB, tid);
  __syncthreads();
  const int tl = min(C, L - c * C);
  const size_t row0 = (size_t)b * L + (size_t)c * C;
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = valid ? ckpt[(((size_t)b * nc + c) * N + n) * D + d] : 0.f;
#pragma unroll 8
  for (int t = 0; t < C; ++t) {
    const bool in = valid && t < tl;
    const float dv = in ? dt[(row0 + t) * D + d] : 0.f;
    const float uv = in ? to_f(u[(row0 + t) * D + d]) : 0.f;
    const float du = dv * uv;
    float yv = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = fmaf(ex2(dv * A2[n]), h[n], du * sB[t * N + n]);
      yv = fmaf(sC[t * N + n], h[n], yv);
    }
    if (in) y[(row0 + t) * D + d] = from_f<TU>(fmaf(dsk, uv, yv));
  }
}

// Pass 1 of the backward: per chunk, the adjoint out of its start from a
// zero adjoint at its end, Q_c (into ws[b, c]), and sum dt (into
// sdt[b, c, d]).
template <typename TU, int C, int N>
__global__ void __launch_bounds__(kRowThreads, 4)
scan_bwd_summary(const float* __restrict__ dt, const float* __restrict__ A,
                 const TU* __restrict__ Cm, const float* __restrict__ dy,
                 float* __restrict__ ws, float* __restrict__ sdt, int L, int D, int nc) {
  extern __shared__ __align__(16) float sC[];  // [C][N]
  const int tid = threadIdx.x, b = blockIdx.z, c = blockIdx.y, d = blockIdx.x * kRowThreads + tid;
  const bool valid = d < D;
  float A2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) A2[n] = valid ? A[(size_t)d * N + n] * kLog2e : 0.f;
  const TU* const srcs[1] = {Cm};
  RowStage<C, N, 1> stage;
  stage.load(srcs, b, L, c, tid);
  stage.store(sC, tid);
  __syncthreads();
  const int tl = min(C, L - c * C);
  const size_t row0 = (size_t)b * L + (size_t)c * C;
  float g[N], dts = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) g[n] = 0.f;
#pragma unroll 8
  for (int t = C - 1; t >= 0; --t) {
    const bool in = valid && t < tl;
    const float dv = in ? dt[(row0 + t) * D + d] : 0.f;
    const float gy = in ? dy[(row0 + t) * D + d] : 0.f;
    dts += dv;
#pragma unroll
    for (int n = 0; n < N; ++n) g[n] = ex2(dv * A2[n]) * fmaf(gy, sC[t * N + n], g[n]);
  }
  if (valid) {
#pragma unroll
    for (int n = 0; n < N; ++n) ws[(((size_t)b * nc + c) * N + n) * D + d] = g[n];
    sdt[((size_t)b * nc + c) * D + d] = dts;
  }
}

// ------------------------------------------------------------ gradient pass

// One step of the forward from h.
__device__ __forceinline__ float forward_step(float h, float A2, float uv, float dv, float bv) {
  return fmaf(ex2(dv * A2), h, dv * uv * bv);
}

// Pass 3: every chunk from its checkpoint and the true adjoint at its end
// (gin[b, c]): du, ddt, the dB/dC partials (summed over the cluster's
// channel slices) and dA per chunk.  The cluster spans grid x: rank
// blockIdx.x % S of group blockIdx.x / S.  The segment loop is not unrolled
// (one segment's code, about 2 K instructions, stays in the instruction
// cache); the segments' start states wait in shared memory.
template <typename TU, int C, int N>
__global__ void __launch_bounds__(256, 4)
scan_bwd_grad(const TU* __restrict__ u, const float* __restrict__ dt,
              const float* __restrict__ A, const TU* __restrict__ Bm, const TU* __restrict__ Cm,
              const float* __restrict__ ckpt, const float* __restrict__ dy,
              const float* __restrict__ gin, float* __restrict__ du, float* __restrict__ ddt,
              float* __restrict__ dBp, float* __restrict__ dCp, float* __restrict__ dAp, int L,
              int D, int nc) {
  constexpr int R = row_len(C), T = kCpb * N, W = T / 32;
  constexpr int NSEG = C / kSeg;       // segments a chunk
  constexpr int U = kSeg * 2 * N / 4;  // 16-byte pieces of a segment's partial
  constexpr int kShared1 = rs_shared_bits<2, N / 2, 1>(), kShared2 = rs_shared_bits<2, 16, N>();
  static_assert(rs_held<2, N / 2, 1>() == 1 && rs_held<2, 16, N>() == 1, "one sum a lane");
  static_assert(C % kSeg == 0 && T % 32 == 0 && 4 * U == T, "layout");
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) uint64_t landed[2];  // one mbarrier per receive buffer
  float* su = sm;
  float* sd = su + kCpb * R;
  float* sg = sd + kCpb * R;
  float* sB = sg + kCpb * R;         // [C][N]
  float* sC = sB + C * N;            // [C][N]
  float* shs = sC + C * N;           // [NSEG][T] each segment's start state
  float* rw = shs + NSEG * T;        // [kSeg][W][2N] the warps' dB/dC partials
  float* so = rw + kSeg * N * N;     // [2][kSeg][kCpb] ddt, du
  float* s0 = so + 2 * kSeg * kCpb;  // [N][kCpb] chunk-start states
  float* sgi = s0 + N * kCpb;        // [N][kCpb] adjoints at the chunk's end
  float* recv = sgi + N * kCpb;      // [2][S][slot]
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / S, groups = gridDim.x / S;
  const int slot = 4 * ((U + S - 1) / S);
  const int u_lo = rank * U / S, u_hi = (rank + 1) * U / S;  // the pieces this block owns
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = tid % N, cl = tid / N;
  const int b = blockIdx.z, d0 = blockIdx.x * kCpb, d = d0 + cl;
  const bool valid = d < D;
  const float Adn = valid ? A[(size_t)d * N + n] : 0.f, A2 = Adn * kLog2e;
  const int q1 = rs_base<2, N / 2, 1>(lane), q2 = rs_base<2, 16, N>(lane);  // which sum a lane keeps
  const uint32_t bar0 = smem_u32(&landed[0]);
  const int expect = 16 * (u_hi - u_lo) * (S - 1);  // bytes from the other ranks a segment
  const int mine = 4 * (u_hi - u_lo);

  if (S > 1) {
    if (tid == 0) {
      for (int i = 0; i < 2; ++i) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * i));
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int i = 0; i < 2; ++i) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar0 + 8 * i),
                     "r"(expect) : "memory");
      }
    }
    cluster.sync();  // every mbarrier of the cluster is initialised before any push
  }

  float dA = 0.f;
  const int c = blockIdx.y;
  const int t0 = c * C, tl = min(C, L - t0);
  const size_t row0 = (size_t)b * L + t0;
  {
    float ru[C * kCpb / T], rd[C * kCpb / T], rg[C * kCpb / T], rb[C * N / T], rc[C * N / T];
    load_channels<C, T>(ru, u, row0, tl, D, d0, tid);
    load_channels<C, T>(rd, dt, row0, tl, D, d0, tid);
    load_channels<C, T>(rg, dy, row0, tl, D, d0, tid);
    load_states<C, N, T>(rb, Bm, row0, tl, tid);
    load_states<C, N, T>(rc, Cm, row0, tl, tid);
    const float r0 = load_tile(ckpt + ((size_t)b * nc + c) * N * D, D, d0, tid);
    const float r1 = load_tile(gin + ((size_t)b * nc + c) * N * D, D, d0, tid);
    store_channels<C, T>(su, ru, tid);
    store_channels<C, T>(sd, rd, tid);
    store_channels<C, T>(sg, rg, tid);
    store_rows<C * N / T, T>(sB, rb, tid);
    store_rows<C * N / T, T>(sC, rc, tid);
    s0[tid] = r0;
    sgi[tid] = r1;
  }
  __syncthreads();
  float g = sgi[n * kCpb + cl];
  float hseg[kSeg];  // the states of the segment in hand
  {  // the first sweep: each segment's start state; the last segment's states
    float h = s0[n * kCpb + cl];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      if (t % kSeg == 0) shs[(t / kSeg) * T + tid] = h;
      h = forward_step(h, A2, su[cl * R + t], sd[cl * R + t], sB[t * N + n]);
      if (t >= C - kSeg) hseg[t - (C - kSeg)] = h;
    }
  }
#pragma unroll 1
  for (int s = NSEG - 1; s >= 0; --s) {
    const int ts0 = s * kSeg;      // the segment's first step in the chunk
    const int seg = NSEG - 1 - s;  // segments done: buffer seg & 1, its phase (seg >> 1) & 1
    const float hstart = shs[s * T + tid];
    if (s < NSEG - 1) {  // recompute the segment's states
      float h = hstart;
#pragma unroll
      for (int ts = 0; ts < kSeg; ++ts) {
        const int t = ts0 + ts;
        h = forward_step(h, A2, su[cl * R + t], sd[cl * R + t], sB[t * N + n]);
        hseg[ts] = h;
      }
    }
    // the adjoint over the segment, last step first
#pragma unroll
    for (int ts = kSeg - 1; ts >= 0; --ts) {
      const int t = ts0 + ts;
      const float hc = hseg[ts], hp = ts > 0 ? hseg[ts - 1] : hstart;
      const float uv = su[cl * R + t], dv = sd[cl * R + t], gy = sg[cl * R + t];
      const float bv = sB[t * N + n], cv = sC[t * N + n];
      const float a = ex2(dv * A2);
      const float hhat = fmaf(gy, cv, g);
      const float z = hhat * hp * a;  // the adjoint times d h_t / d(A dt)
      float r1[2], r2[2];             // [ddt, du] summed over n; [dB, dC] over channels
      r1[1] = hhat * bv;
      r1[0] = fmaf(uv, r1[1], z * Adn);
      r2[0] = hhat * (dv * uv);
      r2[1] = hc * gy;
      dA = fmaf(z, dv, dA);
      g = a * hhat;
      reduce_scatter<2, N / 2, 1>(r1, lane);  // lane bit N/2 set: keeps du, else ddt
      reduce_scatter<2, 16, N>(r2, lane);     // lane bit 16 set: keeps dC, else dB
      if ((lane & kShared1) == 0) so[(q1 * kSeg + ts) * kCpb + cl] = q1 ? dv * r1[0] : r1[0];
      if ((lane & kShared2) == 0) rw[(ts * W + warp) * 2 * N + q2 * N + n] = r2[0];
    }
    __syncthreads();
    // ddt and du of the segment, 16 channels a row
    for (int i = tid; i < 2 * kSeg * kCpb; i += T) {
      const int q = i / (kSeg * kCpb), tt = t0 + ts0 + (i / kCpb) % kSeg, cc = i % kCpb;
      if (tt < L && d0 + cc < D) (q ? du : ddt)[((size_t)b * L + tt) * D + d0 + cc] = so[i];
    }
    // the block's dB/dC partial (kSeg * 2N = T values, one a thread),
    // summed over its warps in order, pushed into slot `rank` of the owner
    // of its 16-byte piece
    float* rbuf = recv + (seg & 1) * S * slot;
    {
      const int ts = tid / (2 * N), k = tid % (2 * N), p = tid / 4;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) v += rw[(ts * W + w) * 2 * N + k];
      const int owner = ((p + 1) * S - 1) / U;
      float* dst = rbuf + rank * slot + tid - 4 * (owner * U / S);
      if (owner == rank) {
        *dst = v;
      } else {
        uint32_t to, bar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(to) : "r"(smem_u32(dst)), "r"(owner));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(bar) : "r"(bar0 + 8 * (seg & 1)), "r"(owner));
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                     ::"r"(to), "r"(__float_as_uint(v)), "r"(bar) : "memory");
      }
    }
    __syncthreads();  // this block's own slot, and so / rw free for the next segment
    // Sum the S partials of the owned pieces in rank order.  Its mbarrier is
    // armed again for the segment after next only once every thread has
    // passed this wait (thread 0 is always a waiter and re-arms after it):
    // a rank pushes that segment only after this block's pushes of the next.
    if (tid < mine || tid == 0) {
      if (S > 1) {
        const uint32_t bar = bar0 + 8 * (seg & 1), parity = (seg >> 1) & 1;
        for (long long spins = 0;; ++spins) {
          uint32_t done;
          asm volatile(
              "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
              " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
          if (done) break;
          if (spins > (1ll << 26)) __trap();
        }
        if (tid == 0)
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                       "r"(expect) : "memory");
      }
      for (int v = tid; v < mine; v += T) {
        float sum = 0.f;
        for (int r = 0; r < S; ++r) sum += rbuf[r * slot + v];
        const int i = 4 * u_lo + v, ts = i / (2 * N), q = (i / N) & 1, k = i % N;
        const int tt = t0 + ts0 + ts;
        if (tt < L) (q ? dCp : dBp)[(((size_t)b * groups + group) * L + tt) * N + k] = sum;
      }
    }
  }
  if (valid) dAp[(((size_t)b * nc + c) * N + n) * D + d] = dA;
}

// ---------------------------------------------------------------- launchers

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct FwdArgs {
  const void *u, *dt, *A, *Bm, *Cm, *Dsk, *h0;
  void *y, *hT, *ws, *sdt;
  int Bz, L, D, N;
};

template <typename TU, int C, int N>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t s) {
  const int nc = (a.L + C - 1) / C, cols = (a.D + kRowThreads - 1) / kRowThreads;
  const size_t m1 = fwd_summary_floats(N, C) * 4, m3 = fwd_output_floats(N, C) * 4;
  const float* A = static_cast<const float*>(a.A);
  const float* dt = static_cast<const float*>(a.dt);
  float* ws = static_cast<float*>(a.ws);
  float* sdt = static_cast<float*>(a.sdt);
  cudaError_t e;
  if ((e = opt_in(scan_fwd_summary<TU, C, N>, m1)) != cudaSuccess) return e;
  if ((e = opt_in(scan_fwd_output<TU, C, N>, m3)) != cudaSuccess) return e;
  scan_fwd_summary<TU, C, N><<<dim3(cols, nc, a.Bz), kRowThreads, m1, s>>>(
      static_cast<const TU*>(a.u), dt, A, static_cast<const TU*>(a.Bm), ws, sdt, a.L, a.D, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_carry<<<dim3((N * a.D + kCarryThreads - 1) / kCarryThreads, a.Bz), kCarryThreads, 0, s>>>(
      A, static_cast<const float*>(a.h0), sdt, ws, static_cast<float*>(a.hT), N, a.D, nc, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.y == nullptr) return cudaSuccess;  // the final state (and ckpt) only
  scan_fwd_output<TU, C, N><<<dim3(cols, nc, a.Bz), kRowThreads, m3, s>>>(
      static_cast<const TU*>(a.u), dt, A, static_cast<const TU*>(a.Bm),
      static_cast<const TU*>(a.Cm), static_cast<const float*>(a.Dsk), ws, static_cast<TU*>(a.y),
      a.L, a.D, nc);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *u, *dt, *A, *Bm, *Cm, *ckpt, *dy, *dhT;
  void *du, *ddt, *dBp, *dCp, *dAp, *dh0, *ws, *sdt;
  int Bz, L, D, N, S;
};

template <typename TU, int C, int N>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t s) {
  const int nc = (a.L + C - 1) / C, slices = (a.D + kCpb - 1) / kCpb;
  const int cols = (a.D + kRowThreads - 1) / kRowThreads, groups = (slices + a.S - 1) / a.S;
  const size_t m1 = bwd_summary_floats(N, C) * 4, m3 = bwd_grad_floats(N, C, a.S) * 4;
  const float* A = static_cast<const float*>(a.A);
  const float* dt = static_cast<const float*>(a.dt);
  const float* dy = static_cast<const float*>(a.dy);
  float* ws = static_cast<float*>(a.ws);
  float* sdt = static_cast<float*>(a.sdt);
  cudaError_t e;
  if ((e = opt_in(scan_bwd_summary<TU, C, N>, m1)) != cudaSuccess) return e;
  if ((e = opt_in(scan_bwd_grad<TU, C, N>, m3)) != cudaSuccess) return e;
  scan_bwd_summary<TU, C, N><<<dim3(cols, nc, a.Bz), kRowThreads, m1, s>>>(
      dt, A, static_cast<const TU*>(a.Cm), dy, ws, sdt, a.L, a.D, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_carry<<<dim3((N * a.D + kCarryThreads - 1) / kCarryThreads, a.Bz), kCarryThreads, 0, s>>>(
      A, static_cast<const float*>(a.dhT), sdt, ws, static_cast<float*>(a.dh0), N, a.D, nc, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * a.S, nc, a.Bz);
  cfg.blockDim = dim3(kCpb * N, 1, 1);
  cfg.dynamicSmemBytes = m3;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, scan_bwd_grad<TU, C, N>, static_cast<const TU*>(a.u), dt, A,
      static_cast<const TU*>(a.Bm), static_cast<const TU*>(a.Cm),
      static_cast<const float*>(a.ckpt), dy, static_cast<const float*>(ws),
      static_cast<float*>(a.du), static_cast<float*>(a.ddt), static_cast<float*>(a.dBp),
      static_cast<float*>(a.dCp), static_cast<float*>(a.dAp), a.L, a.D, nc);
}

template <typename TU, int C, int N>
struct Fwd {
  static cudaError_t run(const FwdArgs& a, cudaStream_t s) { return launch_fwd<TU, C, N>(a, s); }
};
template <typename TU, int C, int N>
struct Bwd {
  static cudaError_t run(const BwdArgs& a, cudaStream_t s) { return launch_bwd<TU, C, N>(a, s); }
};

template <template <typename, int, int> class F, typename TU, typename Args>
cudaError_t dispatch(int chunk, int N, const Args& a, cudaStream_t s) {
  switch (chunk * 100 + N) {
    case 1602: return F<TU, 16, 2>::run(a, s);
    case 1604: return F<TU, 16, 4>::run(a, s);
    case 1608: return F<TU, 16, 8>::run(a, s);
    case 1616: return F<TU, 16, 16>::run(a, s);
    case 6402: return F<TU, 64, 2>::run(a, s);
    case 6404: return F<TU, 64, 4>::run(a, s);
    case 6408: return F<TU, 64, 8>::run(a, s);
    case 6416: return F<TU, 64, 16>::run(a, s);
    default: return cudaErrorInvalidValue;
  }
}

bool shape_ok(int Bz, int L, int D, int N, int chunk) {
  return Bz >= 1 && L >= 1 && D >= 1 && (N == 2 || N == 4 || N == 8 || N == 16) &&
         (chunk == 16 || chunk == 64);
}

}  // namespace

extern "C" {

// Forward.  Device pointers; u, B, C, y are bf16 when is_bf16 != 0, else f32;
// dt, A (D, N), Dsk (D,), h0 (B, N, D) (may be null: zeros), hT (B, N, D)
// and ws (B, ceil(L/chunk), N, D) are f32: ws returns the chunk-start states
// (it is ckpt for the checkpointing forward, a workspace otherwise); sdt
// (B, ceil(L/chunk), D) f32 is a workspace.  y may be null: then only the
// summary and the carry run (hT and ws), for a pass that needs only the
// final state.  The launch plan: the summary
// and output passes' shared memory in bytes; a plan this source lays out
// differently is refused (cudaErrorInvalidValue).
// The wrapper guarantees contiguity.
int selective_scan_fwd_launch(const void* u, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* Dsk, const void* h0, void* y, void* hT,
                              void* ws, void* sdt, int Bz, int L, int D, int N, int chunk,
                              int is_bf16, long long smem_sum, long long smem_out,
                              void* stream) {
  if (!shape_ok(Bz, L, D, N, chunk) || smem_sum != (long long)fwd_summary_floats(N, chunk) * 4 ||
      smem_out != (long long)fwd_output_floats(N, chunk) * 4)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{u, dt, A, Bm, Cm, Dsk, h0, y, hT, ws, sdt, Bz, L, D, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<Fwd, __nv_bfloat16>(chunk, N, a, s)
                       : dispatch<Fwd, float>(chunk, N, a, s));
}

// Backward.  ckpt (B, nc, N, D), dy (B, L, D), dhT (B, N, D) f32; outputs
// du, ddt (B, L, D), dBp, dCp (B, ceil(ceil(D/16)/S), L, N), dAp
// (B, nc, N, D), dh0 (B, N, D), all f32; ws (B, nc, N, D) and sdt
// (B, nc, D) f32 are workspaces.  The launch plan: the cluster size S (1..8)
// and the summary and gradient passes' shared memory in bytes; refused as
// above when it differs.
int selective_scan_bwd_launch(const void* u, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* ckpt, const void* dy, const void* dhT,
                              void* du, void* ddt, void* dBp, void* dCp, void* dAp, void* dh0,
                              void* ws, void* sdt, int Bz, int L, int D, int N, int chunk,
                              int is_bf16, int S, long long smem_sum, long long smem_grad,
                              void* stream) {
  const int slices = (D + kCpb - 1) / kCpb;
  if (!shape_ok(Bz, L, D, N, chunk) || S < 1 || S > kMaxCluster || S > slices ||
      smem_sum != (long long)bwd_summary_floats(N, chunk) * 4 ||
      smem_grad != (long long)bwd_grad_floats(N, chunk, S) * 4)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{u, dt, A, Bm, Cm, ckpt, dy, dhT, du, ddt, dBp, dCp, dAp, dh0, ws, sdt,
                  Bz, L, D, N, S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<Bwd, __nv_bfloat16>(chunk, N, a, s)
                       : dispatch<Bwd, float>(chunk, N, a, s));
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
