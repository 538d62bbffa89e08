// One-launch autoregressive decode for Hopper (sm_90a).
//
// Replaces the TPU kernel mamba_tts_tpu/ops/decode_megakernel.py:532
// (_make_kernel, reached through _megakernel_call :726 / pallas_call :771):
// the whole greedy or Gumbel-max decode of Q*F steps in ONE launch.  Per step:
// embed the previous token, run L layers (LayerNorm, in_proj, 4-tap conv ring +
// SiLU, x/dt projections, softplus, SSM update, gate, out_proj, LayerNorm, q,
// 1-query all-heads attention over K/V, o_proj, LayerNorm, FiLM, ff1, GELU,
// ff2), final LayerNorm, vocab head, argmax, and feed the token back, all on
// the device.  Every product is computed by this file's own code.
//
// What does not carry over from the TPU: there the grid is a sequential loop
// on one core with every weight resident in on-chip memory.  Here 132
// SMs run in parallel with 227 KB of shared memory each, so
//   - the kernel is ONE persistent cooperative grid (one block of 16 warps per
//     SM, all co-resident), and the sequential grid dimension is a loop over
//     steps and layers inside it;
//   - each dependent stage of a step splits its output columns (or (row, head,
//     memory slice) triples) over all warps of the grid, writes its small
//     activation row to a global buffer, and a grid barrier separates it from
//     the next stage: embed | in_proj | conv+SiLU+x-projections | dt+SSM+gate |
//     out_proj | q_proj | attention scores | softmax + P@V | o_proj | ff1+GELU |
//     ff2 per layer, then head | argmax (10 barriers per layer, 2 per step);
//   - cheap per-row work (LayerNorm, the conv, the argmax) is recomputed by
//     every block, which saves a barrier each time;
//   - weights are laid out (N, K), one output column's K inputs contiguous, so
//     a warp computes a column as a dot with 16-byte loads per lane and a
//     shuffle-tree sum: a fixed order, so a run repeats bit for bit (no float
//     atomics anywhere);
//   - every buffer that one block writes and another reads in this launch is
//     read with ld.global.cg (L2), never through the read-only path; each
//     such element has one owner per stage (x: the warp of its column; conv
//     ring and SSM state: the thread of its (row, channel)).
//
// Teacher forcing and the embedding take token ids where the TPU kernel takes
// one-hot rows: a gathered row equals the one-hot product exactly.
//
// Rounding points are the TPU kernel's (see decode_megakernel_ref in
// ../decode_megakernel.py, which this kernel is held against): bf16 after the
// embedding sum, after every projection (scale applied in f32 first), after
// every conv tap product and sum, after each residual add, for q * k_scale,
// the softmax probabilities, the attention output row, FiLM and GELU; f32 for
// LayerNorm statistics, softplus, exp(dt A), the SSM state, sum_n C h and the
// logits.  No fast-math: expf, log1pf and IEEE division.
//
// What bounds it on an H100: each step reads the whole plan (weights, K/V)
// once; at the default width that is 52-98 MB, more than the 50 MB L2, so the
// least time per step is plan bytes / 3.35 TB/s (15-29 us at B=1).  This
// version is far from that: a step is a chain of 82 stages, each a few
// dependent cold loads (about a microsecond apiece) and a barrier (about 1.7
// us), so it is bound by latency, not bytes.  What the design does about it:
// every stage issues all of its loads before it uses any (batched 16-byte
// loads in the dots, the conv and the SSM update; LayerNorm over the whole
// block), a product's first weight loads go out before the barrier in front
// of it, and attention spreads each (row, head) over up to 8 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr long long kSpinLimit = 6000000000LL;  // clock cycles (a few seconds) a barrier may wait

// Mirrors _MKParams in ../decode_megakernel.py: pointers, then ints, then a float.
struct MKParams {
  const bf16* emb_pq;       // (total, d)
  const bf16* token_embed;  // (Vpad, d)
  const float* norms;       // (L, 6, d)
  const void* in_w;         // (L, 2di, d) int8 | bf16
  const float* in_s;        // (L, 2di)
  const bf16* conv_w;       // (L, dc, di)
  const float* conv_b;      // (L, di)
  const bf16* xp_w;         // (L, r+2N, di): dt | B | C rows
  const bf16* dt_w;         // (L, r, di)
  const float* dt_b;        // (L, di)
  const float* A;           // (L, N, di)
  const float* D;           // (L, di)
  const void* out_w;        // (L, d, di)
  const float* out_s;       // (L, d)
  const void* q_w;          // (L, d, d)
  const float* q_s;
  const float* q_b;
  const void* K;            // (L, B, d, Tmp) int8 | bf16
  const void* V;            // (L, B, Tmp, d)
  const float* k_scale;     // (L, B, d)
  const float* v_scale;     // (L, B, d)
  const float* mask_row;    // (B, Tmp)
  const void* o_w;          // (L, d, d)
  const float* o_s;
  const float* o_b;
  const float* gamma;       // (L, B, d)
  const float* beta;        // (L, B, d)
  const void* ff1_w;        // (L, dff, d)
  const float* ff1_s;
  const float* ff1_b;
  const void* ff2_w;        // (L, d, dff)
  const float* ff2_s;
  const float* ff2_b;
  const float* norm_out;    // (2, d)
  const bf16* head_w;       // (Vpad, d)
  const float* head_b;      // (Vpad)
  const int* forced;        // (total, B) or null
  const float* gumbel;      // (total, B, Vpad) or null
  float* logits;            // (total, B, Vpad)
  bf16* conv_state;         // (L, dc-1, B, di)
  float* ssm_state;         // (L, B, N, di)
  bf16* x;                  // (B, d) residual stream
  bf16* xz;                 // (B, 2di)
  bf16* xc;                 // (B, di)
  bf16* dbc;                // (B, r+2N)
  bf16* y;                  // (B, di)
  bf16* q;                  // (B, d)
  float* scores;            // (B, H, Tmp) attention scores of the current layer
  float* attn_part;         // (TS, B, d) P @ V partial rows, one per slice of the memory
  bf16* h1;                 // (B, dff)
  unsigned long long* sync; // [0] barrier arrivals, [1] error word
  long long* stage_clock;   // optional (null): block 0 stamps clock64() around each barrier
  int total, B, L, d, di, N, r, dc, H, dff, Vpad, Tmp, bos, w_int8, kv_int8, smem_bytes, TS;
  float att_scale;
  int clock_step;           // the step whose barriers are stamped
};

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float bits_to_float(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// A bf16 activation that another block may have written in this launch: L2 load.
__device__ __forceinline__ float ld_act(const bf16* p) {
  return bits_to_float(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ void st_act(bf16* p, float v) { *p = __float2bfloat16(v); }

// A bf16 operand that nothing writes during the launch: read-only path.
__device__ __forceinline__ float ld_ro(const bf16* p) {
  return bits_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float silu_bf16(float v) { return bf16r(v / (1.0f + expf(-v))); }

__device__ __forceinline__ float softplus_f32(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// 0.5 x (1 + erf(x / sqrt 2)), erf by Abramowitz & Stegun 7.1.26, as the TPU kernel.
__device__ __forceinline__ float gelu_bf16(float v) {
  const float u = fabsf(v) * 0.70710678118654752f;
  const float t = 1.0f / (1.0f + 0.3275911f * u);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  const float erf_abs = 1.0f - poly * expf(-u * u);
  const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  return bf16r(0.5f * v * (1.0f + sgn * erf_abs));
}

// ---- one output column: lane-strided 16-byte loads of the column's K inputs

// Loads are issued in batches of kBatch before any is used: a column is a
// handful of 16-byte loads per lane, and their (cold) latencies must overlap.
// The first batch of a warp's first column is asked for even earlier, by
// prefetch_col before the grid barrier that precedes the stage: weights depend
// on nothing, so their latency hides behind the barrier and the staging of the
// activations.
constexpr int kBatch = 4;

template <typename WT>
__device__ __forceinline__ void prefetch_col(const WT* __restrict__ w, int K, int ncols,
                                             uint4 (&pre)[kBatch]) {
  constexpr int E = 16 / static_cast<int>(sizeof(WT));  // weights per 16-byte load
  const int lane = threadIdx.x & 31, col = blockIdx.x + gridDim.x * (threadIdx.x >> 5);
  if (col < ncols) {
    const WT* row = w + static_cast<size_t>(col) * K;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if ((lane + u * 32) * E < K) pre[u] = __ldg(reinterpret_cast<const uint4*>(row + (lane + u * 32) * E));
  }
}

template <int BT>
__device__ __forceinline__ void dot_row(const int8_t* __restrict__ w, int K, const float* xs,
                                        int B, float (&acc)[BT], int lane, uint4 (&v)[kBatch],
                                        bool have) {
  for (int k0 = lane * 16; k0 < K; k0 += kBatch * 512) {
    if (!have) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (k0 + u * 512 < K) v[u] = __ldg(reinterpret_cast<const uint4*>(w + k0 + u * 512));
    }
    have = false;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * 512;
      if (k < K) {
        const unsigned q[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        float wf[16];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wf[4 * i + j] =
                static_cast<float>(static_cast<int>(static_cast<signed char>(q[i] >> (8 * j))));
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          if (b < B) {
            const float4* xp = reinterpret_cast<const float4*>(xs + b * K + k);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 xv = xp[i];
              acc[b] = fmaf(xv.x, wf[4 * i + 0], acc[b]);
              acc[b] = fmaf(xv.y, wf[4 * i + 1], acc[b]);
              acc[b] = fmaf(xv.z, wf[4 * i + 2], acc[b]);
              acc[b] = fmaf(xv.w, wf[4 * i + 3], acc[b]);
            }
          }
        }
      }
    }
  }
}

template <int BT>
__device__ __forceinline__ void dot_row(const bf16* __restrict__ w, int K, const float* xs, int B,
                                        float (&acc)[BT], int lane, uint4 (&v)[kBatch],
                                        bool have) {
  for (int k0 = lane * 8; k0 < K; k0 += kBatch * 256) {
    if (!have) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (k0 + u * 256 < K) v[u] = __ldg(reinterpret_cast<const uint4*>(w + k0 + u * 256));
    }
    have = false;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * 256;
      if (k < K) {
        const unsigned q[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        float wf[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wf[2 * i] = __uint_as_float(q[i] << 16);
          wf[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
        }
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          if (b < B) {
            const float4* xp = reinterpret_cast<const float4*>(xs + b * K + k);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float4 xv = xp[i];
              acc[b] = fmaf(xv.x, wf[4 * i + 0], acc[b]);
              acc[b] = fmaf(xv.y, wf[4 * i + 1], acc[b]);
              acc[b] = fmaf(xv.z, wf[4 * i + 2], acc[b]);
              acc[b] = fmaf(xv.w, wf[4 * i + 3], acc[b]);
            }
          }
        }
      }
    }
  }
}

// (acc * scale) -> bf16 for int8 weights; acc -> bf16 for bf16 weights (scale folded).
__device__ __forceinline__ float dequant(const int8_t*, float acc, const float* scale, int col) {
  return bf16r(acc * __ldg(scale + col));
}
__device__ __forceinline__ float dequant(const bf16*, float acc, const float*, int) {
  return bf16r(acc);
}

// Columns [0, ncols) of xs (B, K) @ w (ncols, K), split over every warp of the
// grid (block-major, so few columns still spread over many SMs).  pre holds the
// first loads of the warp's first column (prefetch_col of the same w, K and
// ncols).  epi(b, col, acc) runs on lane b with the f32 sum.
template <typename WT, int BT, typename Epi>
__device__ __forceinline__ void matvec_cols(const WT* __restrict__ w, int K, int ncols,
                                            const float* xs, int B, uint4 (&pre)[kBatch],
                                            Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool have = true;
  for (int col = blockIdx.x + gridDim.x * warp; col < ncols; col += gridDim.x * kWarps) {
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.0f;
    dot_row<BT>(w + static_cast<size_t>(col) * K, K, xs, B, acc, lane, pre, have);
    have = false;
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = warp_sum(acc[b]);
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < B && lane == b) epi(b, col, acc[b]);
  }
}

// Stage B activation rows (B, K) of a global buffer into shared memory as f32.
__device__ __forceinline__ void load_rows(const bf16* g, int n, float* xs) {
  for (int i = threadIdx.x; i < n; i += kThreads) xs[i] = ld_act(g + i);
  __syncthreads();
}

// Sums of BT per-thread values over the block, in a fixed order: shuffle tree
// within each warp, then the 16 warp sums in turn.  red holds BT * kWarps floats.
template <int BT>
__device__ __forceinline__ void block_sum_rows(float (&v)[BT], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    v[b] = warp_sum(v[b]);
    if (lane == 0) red[b * kWarps + warp] = v[b];
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    float r = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) r += red[b * kWarps + i];
    v[b] = r;
  }
  __syncthreads();
}

// LayerNorm (eps 1e-6, f32 statistics, bf16 result) of the B rows of x into xs;
// with gamma/beta also FiLM, each op rounded to bf16.  A thread takes column
// tid (+512, ...) of every row, so that all of the block's loads (the rows and
// the cold scale/bias/FiLM vectors) are in flight together.
template <int BT>
__device__ __forceinline__ void ln_rows(const bf16* x, const float* __restrict__ scale,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta, float* xs, float* red,
                                        int B, int d) {
  const int tid = threadIdx.x;
  // the first column's parameters, asked for before anything waits
  const bool has0 = tid < d;
  const float sc0 = has0 ? __ldg(scale + tid) : 0.0f, bi0 = has0 ? __ldg(bias + tid) : 0.0f;
  float g0[BT], be0[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    const bool on = gamma != nullptr && has0 && b < B;
    g0[b] = on ? __ldg(gamma + b * d + tid) : 1.0f;
    be0[b] = on ? __ldg(beta + b * d + tid) : 0.0f;
  }
  float s[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) s[b] = 0.0f;
  for (int j = tid; j < d; j += kThreads)
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < B) {
        const float v = ld_act(x + b * d + j);
        xs[b * d + j] = v;
        s[b] += v;
      }
  block_sum_rows<BT>(s, red);
  float sq[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) sq[b] = 0.0f;
  for (int j = tid; j < d; j += kThreads)
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < B) {
        const float dv = xs[b * d + j] - s[b] / static_cast<float>(d);
        sq[b] += dv * dv;
      }
  block_sum_rows<BT>(sq, red);
  for (int j = tid; j < d; j += kThreads) {
    const float sc = j == tid ? sc0 : __ldg(scale + j), bi = j == tid ? bi0 : __ldg(bias + j);
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < B) {
        const float mu = s[b] / static_cast<float>(d);
        const float rs = rsqrtf(sq[b] / static_cast<float>(d) + 1e-6f);
        float v = bf16r((xs[b * d + j] - mu) * rs * sc + bi);
        if (gamma != nullptr) {
          const float g = j == tid ? g0[b] : __ldg(gamma + b * d + j);
          const float be = j == tid ? be0[b] : __ldg(beta + b * d + j);
          v = bf16r(bf16r(g) * v);
          v = bf16r(v + bf16r(be));
        }
        xs[b * d + j] = v;
      }
  }
  __syncthreads();
}

// Every block arrives, then waits until all have.  The launch is cooperative,
// so all blocks are resident and the wait ends; a wait beyond kSpinLimit sets
// the error word, and every block that sees it leaves the kernel.
__device__ __forceinline__ bool grid_barrier(unsigned long long* sync,
                                             unsigned long long& target) {
  __shared__ int s_ok;
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(&sync[0], 1ULL);
    volatile unsigned long long* vs = sync;
    const long long t0 = clock64();
    int ok = 1;
    unsigned spins = 0;
    while (vs[0] < target) {
      if ((++spins & 63u) == 0u) {
        if (vs[1] != 0ULL) { ok = 0; break; }
        if (clock64() - t0 > kSpinLimit) { atomicExch(&sync[1], 1ULL); ok = 0; break; }
      }
    }
    __threadfence();
    s_ok = ok;
  }
  __syncthreads();
  return s_ok != 0;
}

// The barrier between two stages of a step.  A diagnostic rides on it: when
// p.stage_clock is given, block 0 stamps clock64() on entering and on leaving
// every barrier of step p.clock_step, which splits that step into each stage's
// work and each barrier's wait.
__device__ __forceinline__ bool stage_barrier(const MKParams& p, unsigned long long& target,
                                              int t, int& stamp) {
  const bool rec = p.stage_clock != nullptr && t == p.clock_step && blockIdx.x == 0 &&
                   threadIdx.x == 0;
  if (rec) p.stage_clock[stamp++] = clock64();
  const bool ok = grid_barrier(p.sync, target);
  if (rec) p.stage_clock[stamp++] = clock64();
  return ok;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.0f;
  for (int i = 0; i < kWarps; ++i) r += red[i];
  __syncthreads();
  return r;
}

// K/V element loads: 8 consecutive memory positions of one K channel, or 8
// consecutive channels of one V position (16 bytes of bf16, 8 of int8).
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&v)[8]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const unsigned w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[4 * i + j] = static_cast<float>(static_cast<int>(static_cast<signed char>(w[i] >> (8 * j))));
}

// 1-query attention in two stages with a grid barrier between them.  One (row,
// head) pair reads 2 x hd x Tmp K/V elements, too much for one SM's load
// rate, so the memory is cut into TS slices and a block takes one (row, head,
// slice) at a time.  Both products keep 16-byte loads in flight: scores by
// (8 positions, a few of the head's channels) per thread, P @ V by (one
// position, 8 channels) per lane.

// Stage 1: this slice's scores, (q . K) * att_scale + mask, f32, to p.scores.
template <typename KT>
__device__ __forceinline__ void attention_scores(const MKParams& p, int l, float* smem) {
  const int tid = threadIdx.x;
  const int d = p.d, Tmp = p.Tmp, hd = p.d / p.H, Tc = Tmp / p.TS;
  int JS = 16;  // lanes per group of 8 positions: a power of two
  while (JS > 1 && (JS > hd / 2 || (Tc / 8) * JS > kThreads)) JS >>= 1;
  const int CH = hd / JS, js = tid % JS;  // channels per lane, and which ones
  float* qs = smem;  // [hd]
  for (int u = blockIdx.x; u < p.B * p.H * p.TS; u += gridDim.x) {
    const int ts = u % p.TS, bh = u / p.TS, b = bh / p.H, c0 = (bh % p.H) * hd;
    const size_t lb = static_cast<size_t>(l) * p.B + b;
    // K's per-channel scale folds into q (ones for bf16 K/V), then bf16
    if (tid < hd)
      qs[tid] = bf16r(ld_act(p.q + b * d + c0 + tid) * __ldg(p.k_scale + lb * d + c0 + tid));
    __syncthreads();
    const KT* Kb = static_cast<const KT*>(p.K) + (lb * d + c0) * Tmp;
    const float* mask = p.mask_row + static_cast<size_t>(b) * Tmp;
    float* S = p.scores + static_cast<size_t>(bh) * Tmp;
    // JS neighbouring lanes share 8 positions and split the head's channels, as
    // many as keep the block's threads busy: each thread then has few loads, all
    // in flight together, and a shuffle tree joins the partial sums.
    // (The loop bound is the same for every lane: the shuffles need whole warps.)
    for (int base = ts * Tc; base < (ts + 1) * Tc; base += (kThreads / JS) * 8) {
      const int t8 = base + (tid / JS) * 8;
      const bool on = t8 < (ts + 1) * Tc;
      float a[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (on) {
        const KT* Kr = Kb + static_cast<size_t>(js * CH) * Tmp + t8;
#pragma unroll 4
        for (int j = 0; j < CH; ++j) {
          float kv[8];
          load8(Kr + static_cast<size_t>(j) * Tmp, kv);
          const float qv = qs[js * CH + j];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = fmaf(qv, kv[i], a[i]);
        }
      }
      for (int off = 1; off < JS; off <<= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
      if (on && js == 0)
#pragma unroll
        for (int i = 0; i < 8; ++i) S[t8 + i] = a[i] * p.att_scale + __ldg(mask + t8 + i);
    }
    __syncthreads();
  }
}

// Stage 2: the pair's whole score row (f32 softmax statistics, the same sums in
// every slice's block), this slice's probabilities in bf16, and its part of
// P @ V as an f32 row to p.attn_part.
template <typename KT>
__device__ __forceinline__ void attention_values(const MKParams& p, int l, float* smem,
                                                 float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = p.d, Tmp = p.Tmp, hd = p.d / p.H, Tc = Tmp / p.TS;
  float* S = smem;          // [Tmp]
  float* part = smem + Tmp; // [kWarps][hd]
  for (int u = blockIdx.x; u < p.B * p.H * p.TS; u += gridDim.x) {
    const int ts = u % p.TS, bh = u / p.TS, b = bh / p.H, c0 = (bh % p.H) * hd;
    const size_t lb = static_cast<size_t>(l) * p.B + b;
    const float* Sg = p.scores + static_cast<size_t>(bh) * Tmp;
    float mx = -3.0e38f;
    for (int t = tid; t < Tmp; t += kThreads) {
      const float sv = __ldcg(Sg + t);
      S[t] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = block_max(mx, red);
    float sum = 0.0f;
    for (int t = tid; t < Tmp; t += kThreads) {
      const float e = expf(S[t] - mx);
      S[t] = e;
      sum += e;
    }
    sum = block_sum(sum, red);
    for (int t = ts * Tc + tid; t < (ts + 1) * Tc; t += kThreads) S[t] = bf16r(S[t] / sum);
    __syncthreads();
    // lane = (position within the warp's group, 8 channels of the head)
    const int CL = hd / 8, PS = 32 / CL;
    const int cg = lane % CL, ps = lane / CL;
    const KT* Vb = static_cast<const KT*>(p.V) + lb * Tmp * d + c0 + cg * 8;
    float o[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int t = ts * Tc + warp * PS + ps; t < (ts + 1) * Tc; t += kWarps * PS) {
      float v[8];
      load8(Vb + static_cast<size_t>(t) * d, v);
      const float pt = S[t];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = fmaf(pt, v[i], o[i]);
    }
    for (int off = CL; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] += __shfl_xor_sync(0xffffffffu, o[i], off);
    if (ps == 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) part[warp * hd + cg * 8 + i] = o[i];
    __syncthreads();
    if (tid < hd) {
      float o_sum = 0.0f;
      for (int w = 0; w < kWarps; ++w) o_sum += part[w * hd + tid];
      p.attn_part[(static_cast<size_t>(ts) * p.B + b) * d + c0 + tid] = o_sum;
    }
    __syncthreads();
  }
}

// First index of each row's maximum of logits (+ noise), computed by every
// block for itself so that the next step's embedding needs no barrier.
__device__ __forceinline__ void argmax_rows(const float* logits, const float* gumbel, int B,
                                            int Vpad, int* s_tok, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* red_i = reinterpret_cast<int*>(red + kWarps);
  for (int b = 0; b < B; ++b) {
    float best = -3.4e38f;
    int bi = 0x3fffffff;
    for (int col = tid; col < Vpad; col += kThreads) {
      float v = __ldcg(logits + b * Vpad + col);
      if (gumbel != nullptr) v += __ldg(gumbel + b * Vpad + col);
      if (v > best) { best = v; bi = col; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
    }
    if (lane == 0) { red[warp] = best; red_i[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (red[w] > best || (red[w] == best && red_i[w] < bi)) { best = red[w]; bi = red_i[w]; }
      s_tok[b] = bi;
    }
    __syncthreads();
  }
}

template <typename WT, int BT>
__global__ void __launch_bounds__(kThreads, 1) decode_megakernel(const MKParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_tok[BT];
  float* xs = smem;                                   // staged activation rows
  float* red = smem + (p.smem_bytes / 4 - 8 * kWarps);  // block-reduction scratch
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;
  const int gthread = blockIdx.x * kThreads + tid, gthreads = G * kThreads;
  const int B = p.B, L = p.L, d = p.d, di = p.di, N = p.N, r = p.r, dc = p.dc, dff = p.dff;
  const int nx = r + 2 * N;
  unsigned long long target = 0;
  int stamp = 0;
  uint4 pre[kBatch] = {};  // the next product's first weight loads, asked for a stage early

  // step 0: zero state, BOS
  for (int i = gthread; i < L * (dc - 1) * B * di; i += gthreads) p.conv_state[i] = __float2bfloat16(0.0f);
  for (int i = gthread; i < L * B * N * di; i += gthreads) p.ssm_state[i] = 0.0f;
  if (tid < B) s_tok[tid] = p.bos;
  if (!grid_barrier(p.sync, target)) return;

  for (int t = 0; t < p.total; ++t) {
    if (p.forced != nullptr && tid < B) s_tok[tid] = __ldg(p.forced + t * B + tid);
    __syncthreads();
    // ---- embed: token row + this step's pos/quant row, in bf16
    for (int i = gthread; i < B * d; i += gthreads) {
      const int b = i / d, j = i % d;
      st_act(p.x + i, bf16r(ld_ro(p.token_embed + static_cast<size_t>(s_tok[b]) * d + j) +
                             ld_ro(p.emb_pq + static_cast<size_t>(t) * d + j)));
    }
    prefetch_col(static_cast<const WT*>(p.in_w), d, 2 * di, pre);  // layer 0's in_proj
    if (!stage_barrier(p, target, t, stamp)) return;

    for (int l = 0; l < L; ++l) {
      const float* nb = p.norms + static_cast<size_t>(l) * 6 * d;
      // ---- in_proj: xz = dq(LN(x) @ in_w)
      ln_rows<BT>(p.x, nb, nb + d, nullptr, nullptr, xs, red, B, d);
      {
        const WT* w = static_cast<const WT*>(p.in_w) + static_cast<size_t>(l) * 2 * di * d;
        const float* sc = p.in_s + static_cast<size_t>(l) * 2 * di;
        matvec_cols<WT, BT>(w, d, 2 * di, xs, B, pre, [&](int b, int col, float acc) {
          st_act(p.xz + b * 2 * di + col, dequant(w, acc, sc, col));
        });
      }
      prefetch_col(p.xp_w + static_cast<size_t>(l) * nx * di, di, nx, pre);
      if (!stage_barrier(p, target, t, stamp)) return;

      // ---- conv + SiLU (every block, all channels), then the x-projections
      {
        const bf16* cw = p.conv_w + static_cast<size_t>(l) * dc * di;
        const bf16* cs = p.conv_state + static_cast<size_t>(l) * (dc - 1) * B * di;
        // 4 elements at a time, every load before any arithmetic (d_conv <= 4)
        for (int i0 = tid; i0 < B * di; i0 += 4 * kThreads) {
          float xin[4], sv[4][3], wv[4][4], cb[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + e * kThreads;
            if (i < B * di) {
              const int b = i / di, c = i % di;
              xin[e] = ld_act(p.xz + b * 2 * di + c);
              cb[e] = __ldg(p.conv_b + l * di + c);
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (k < dc) wv[e][k] = ld_ro(cw + k * di + c);
#pragma unroll
              for (int k = 0; k < 3; ++k)
                if (k < dc - 1) sv[e][k] = ld_act(cs + (k * B + b) * di + c);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + e * kThreads;
            if (i < B * di) {
              float last = 0.0f;  // the tap of this step's input
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (k == dc - 1) last = wv[e][k];
              float acc = bf16r(xin[e] * last);
#pragma unroll
              for (int k = 0; k < 3; ++k)
                if (k < dc - 1) acc = bf16r(acc + bf16r(sv[e][k] * wv[e][k]));
              acc = bf16r(acc + bf16r(cb[e]));
              const float xcv = silu_bf16(acc);
              xs[i] = xcv;
              if (i % G == blockIdx.x) st_act(p.xc + i, xcv);
            }
          }
        }
        __syncthreads();
        const bf16* w = p.xp_w + static_cast<size_t>(l) * nx * di;
        matvec_cols<bf16, BT>(w, di, nx, xs, B, pre, [&](int b, int col, float acc) {
          st_act(p.dbc + b * nx + col, bf16r(acc));
        });
      }
      if (!stage_barrier(p, target, t, stamp)) return;

      // ---- dt projection, softplus, SSM update, gate.  A warp takes 8 channels of a
      // row: lane = (quarter, channel); the four quarters split the dt-rank and
      // the state index between them (k, n = quarter, quarter + 4, ...), so that a
      // channel's 60-odd cold loads go out together, and shuffles join the sums.
      // The quarter-0 lane owns the channel's y, and its conv-ring element, which
      // it shifts.
      for (int w8 = blockIdx.x + G * warp; w8 < B * di / 8; w8 += G * kWarps) {
        const int i = w8 * 8 + (lane & 7), qt = lane >> 3;
        const int b = i / di, c = i % di;
        const bf16* dbc = p.dbc + b * nx;
        const float xcv = ld_act(p.xc + i), z = ld_act(p.xz + b * 2 * di + di + c);
        const float dtb = __ldg(p.dt_b + l * di + c), Dv = __ldg(p.D + l * di + c);
        bf16* cs = p.conv_state + (static_cast<size_t>(l) * (dc - 1) * B + b) * di + c;
        float ring[3];  // the conv ring after this step (d_conv <= 4)
        if (qt == 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (k < dc - 1)
              ring[k] = k < dc - 2 ? ld_act(cs + (k + 1) * B * di) : ld_act(p.xz + b * 2 * di + c);
        }
        float acc = 0.0f;
        for (int k0 = qt; k0 < r; k0 += 32) {
          float dv[8], wv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k0 + 4 * j < r) {
              dv[j] = ld_act(dbc + k0 + 4 * j);
              wv[j] = ld_ro(p.dt_w + (static_cast<size_t>(l) * r + k0 + 4 * j) * di + c);
            }
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k0 + 4 * j < r) acc = fmaf(dv[j], wv[j], acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 8);
        acc += __shfl_xor_sync(0xffffffffu, acc, 16);
        const float dt = softplus_f32(bf16r(acc) + dtb);
        const float dtx = dt * xcv;
        float* hs = p.ssm_state + ((static_cast<size_t>(l) * B + b) * N) * di + c;
        const float* Al = p.A + static_cast<size_t>(l) * N * di + c;
        float yv = 0.0f;
        for (int n0 = qt; n0 < N; n0 += 16) {
          float av[4], hv[4], bv[4], cv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + 4 * j < N) {
              av[j] = __ldg(Al + (n0 + 4 * j) * di);
              hv[j] = __ldcg(hs + (n0 + 4 * j) * di);
              bv[j] = ld_act(dbc + r + n0 + 4 * j);
              cv[j] = ld_act(dbc + r + N + n0 + 4 * j);
            }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + 4 * j < N) {
              const float h = expf(dt * av[j]) * hv[j] + bv[j] * dtx;
              hs[(n0 + 4 * j) * di] = h;
              yv += cv[j] * h;
            }
        }
        yv += __shfl_xor_sync(0xffffffffu, yv, 8);
        yv += __shfl_xor_sync(0xffffffffu, yv, 16);
        if (qt == 0) {
          yv = bf16r(yv + xcv * Dv);
          st_act(p.y + i, bf16r(yv * silu_bf16(z)));
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (k < dc - 1) st_act(cs + k * B * di, ring[k]);
        }
      }
      prefetch_col(static_cast<const WT*>(p.out_w) + static_cast<size_t>(l) * d * di, di, d, pre);
      if (!stage_barrier(p, target, t, stamp)) return;

      // ---- out_proj: x += dq(y @ out_w)
      load_rows(p.y, B * di, xs);
      {
        const WT* w = static_cast<const WT*>(p.out_w) + static_cast<size_t>(l) * d * di;
        const float* sc = p.out_s + static_cast<size_t>(l) * d;
        matvec_cols<WT, BT>(w, di, d, xs, B, pre, [&](int b, int col, float acc) {
          bf16* xp = p.x + b * d + col;
          st_act(xp, bf16r(ld_act(xp) + dequant(w, acc, sc, col)));
        });
      }
      prefetch_col(static_cast<const WT*>(p.q_w) + static_cast<size_t>(l) * d * d, d, d, pre);
      if (!stage_barrier(p, target, t, stamp)) return;

      // ---- q_proj: q = dq(LN(x) @ q_w) + q_b
      ln_rows<BT>(p.x, nb + 2 * d, nb + 3 * d, nullptr, nullptr, xs, red, B, d);
      {
        const WT* w = static_cast<const WT*>(p.q_w) + static_cast<size_t>(l) * d * d;
        const float* sc = p.q_s + static_cast<size_t>(l) * d;
        const float* bias = p.q_b + static_cast<size_t>(l) * d;
        matvec_cols<WT, BT>(w, d, d, xs, B, pre, [&](int b, int col, float acc) {
          st_act(p.q + b * d + col, bf16r(dequant(w, acc, sc, col) + bf16r(__ldg(bias + col))));
        });
      }
      if (!stage_barrier(p, target, t, stamp)) return;

      // ---- attention over the memory
      if (p.kv_int8) attention_scores<int8_t>(p, l, smem);
      else attention_scores<bf16>(p, l, smem);
      if (!stage_barrier(p, target, t, stamp)) return;
      if (p.kv_int8) attention_values<int8_t>(p, l, smem, red);
      else attention_values<bf16>(p, l, smem, red);
      prefetch_col(static_cast<const WT*>(p.o_w) + static_cast<size_t>(l) * d * d, d, d, pre);
      if (!stage_barrier(p, target, t, stamp)) return;

      // ---- o_proj: x += dq(attn @ o_w) + o_b
      // the attention row: the slices' parts summed in order, times V's per-channel
      // scale (ones for bf16 K/V), then bf16
      for (int i = tid; i < B * d; i += kThreads) {
        float o = 0.0f;
        for (int ts = 0; ts < p.TS; ++ts) o += __ldcg(p.attn_part + static_cast<size_t>(ts) * B * d + i);
        xs[i] = bf16r(o * __ldg(p.v_scale + static_cast<size_t>(l) * B * d + i));
      }
      __syncthreads();
      {
        const WT* w = static_cast<const WT*>(p.o_w) + static_cast<size_t>(l) * d * d;
        const float* sc = p.o_s + static_cast<size_t>(l) * d;
        const float* bias = p.o_b + static_cast<size_t>(l) * d;
        matvec_cols<WT, BT>(w, d, d, xs, B, pre, [&](int b, int col, float acc) {
          bf16* xp = p.x + b * d + col;
          const float v = bf16r(dequant(w, acc, sc, col) + bf16r(__ldg(bias + col)));
          st_act(xp, bf16r(ld_act(xp) + v));
        });
      }
      prefetch_col(static_cast<const WT*>(p.ff1_w) + static_cast<size_t>(l) * dff * d, d, dff, pre);
      if (!stage_barrier(p, target, t, stamp)) return;

      // ---- ff1: h1 = GELU(dq(FiLM(LN(x)) @ ff1_w) + ff1_b)
      ln_rows<BT>(p.x, nb + 4 * d, nb + 5 * d, p.gamma + static_cast<size_t>(l) * B * d,
                  p.beta + static_cast<size_t>(l) * B * d, xs, red, B, d);
      {
        const WT* w = static_cast<const WT*>(p.ff1_w) + static_cast<size_t>(l) * dff * d;
        const float* sc = p.ff1_s + static_cast<size_t>(l) * dff;
        const float* bias = p.ff1_b + static_cast<size_t>(l) * dff;
        matvec_cols<WT, BT>(w, d, dff, xs, B, pre, [&](int b, int col, float acc) {
          st_act(p.h1 + b * dff + col,
                 gelu_bf16(bf16r(dequant(w, acc, sc, col) + bf16r(__ldg(bias + col)))));
        });
      }
      prefetch_col(static_cast<const WT*>(p.ff2_w) + static_cast<size_t>(l) * d * dff, dff, d, pre);
      if (!stage_barrier(p, target, t, stamp)) return;

      // ---- ff2: x += dq(h1 @ ff2_w) + ff2_b
      load_rows(p.h1, B * dff, xs);
      {
        const WT* w = static_cast<const WT*>(p.ff2_w) + static_cast<size_t>(l) * d * dff;
        const float* sc = p.ff2_s + static_cast<size_t>(l) * d;
        const float* bias = p.ff2_b + static_cast<size_t>(l) * d;
        matvec_cols<WT, BT>(w, dff, d, xs, B, pre, [&](int b, int col, float acc) {
          bf16* xp = p.x + b * d + col;
          const float v = bf16r(dequant(w, acc, sc, col) + bf16r(__ldg(bias + col)));
          st_act(xp, bf16r(ld_act(xp) + v));
        });
      }
      if (l + 1 < L)
        prefetch_col(static_cast<const WT*>(p.in_w) + static_cast<size_t>(l + 1) * 2 * di * d, d,
                     2 * di, pre);
      else prefetch_col(p.head_w, d, p.Vpad, pre);
      if (!stage_barrier(p, target, t, stamp)) return;
    }

    // ---- vocab head on the bf16 LayerNorm row, f32 out, plus the masking bias
    ln_rows<BT>(p.x, p.norm_out, p.norm_out + d, nullptr, nullptr, xs, red, B, d);
    float* logits = p.logits + static_cast<size_t>(t) * B * p.Vpad;
    matvec_cols<bf16, BT>(p.head_w, d, p.Vpad, xs, B, pre, [&](int b, int col, float acc) {
      logits[b * p.Vpad + col] = acc + __ldg(p.head_b + col);
    });
    if (!stage_barrier(p, target, t, stamp)) return;

    // ---- the next token, unless it is forced
    if (p.forced == nullptr && t + 1 < p.total)
      argmax_rows(logits, p.gumbel == nullptr ? nullptr
                  : p.gumbel + static_cast<size_t>(t) * B * p.Vpad, B, p.Vpad, s_tok, red);
  }
}

template <typename WT, int BT>
cudaError_t launch(const MKParams& p, cudaStream_t stream) {
  auto kern = decode_megakernel<WT, BT>;
  int dev = 0, coop = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (e != cudaSuccess) return e;
  // one block per SM; the cooperative launch itself refuses a grid that cannot be co-resident
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, p.smem_bytes);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorLaunchOutOfResources;
  MKParams local = p;
  void* args[] = {&local};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(sms), dim3(kThreads),
                                     args, static_cast<size_t>(p.smem_bytes), stream);
}

template <typename WT>
cudaError_t launch_bt(const MKParams& p, cudaStream_t s) {
  if (p.B <= 1) return launch<WT, 1>(p, s);
  if (p.B <= 2) return launch<WT, 2>(p, s);
  if (p.B <= 4) return launch<WT, 4>(p, s);
  return launch<WT, 8>(p, s);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  The wrapper guarantees
// 1 <= B <= 8, contiguity, the alignments and divisibilities the loads need,
// zeroed sync words, TS dividing Tmp / 8, and smem_bytes as _smem_bytes() of
// the Python side lays the shared memory out.
int decode_megakernel_launch(const void* mk_params, void* stream) {
  // (a parameter of the file-local struct type would give this function internal linkage)
  const MKParams* params = static_cast<const MKParams*>(mk_params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (params->B < 1 || params->B > 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = params->w_int8 ? launch_bt<int8_t>(*params, s) : launch_bt<bf16>(*params, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* decode_megakernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
