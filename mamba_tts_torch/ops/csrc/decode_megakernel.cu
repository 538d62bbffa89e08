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
// What bounds it on an H100.  Without residency a step must read the plan
// (weights, K/V, scales) once: 52-98 MB at B = 1, more than the 50 MB L2, so
// plan bytes / 3.35 TB/s (15-29 us a step) bounds it.  On the TPU the whole
// plan sits in VMEM for all Q*F grid steps; the counterpart here is 132 x 227
// KB of shared memory plus the L2, so the launch keeps what fits of each
// block's own weight slices in its shared memory for the whole launch (with
// the owned channels' Mamba operands and state), and the rest streams from a
// fixed owner.  With residency a step's streamed set is the plan less the
// resident slices: where it fits the L2 it is read from L2 every step and
// from device memory once a launch, and only what exceeds the L2 must come
// from device memory every step.  So the bound of a launch is the larger of
// its streamed bytes over the L2's read rate and the bytes beyond the L2 over
// 3.35 TB/s (chip_smoke.py computes it from each launch's plan).  The first
// version of this kernel ran at 7% of the no-residency bound: latency bound,
// with 82 grid barriers a step (a third of the step) and two or three
// dependent L2 round trips inside every stage.  This design attacks latency:
//
//   - ONE persistent grid of whole thread-block clusters, one block of 8
//     warps per SM (the shared-memory request admits only one), launched
//     cooperatively with a grid of at most cudaOccupancyMaxActiveClusters x
//     cluster size, so every block is resident and the grid barrier ends; the
//     launch fails (and the wrapper raises) where the runtime refuses that.  A
//     barrier that waits beyond kSpinLimit sets an error word and every block
//     leaves.
//   - A grid barrier is one release reduction per block after its
//     __syncthreads and an acquire poll (no full __threadfence on either side):
//     a quarter cheaper than the fenced one of the first version.  A two-level
//     barrier (one arrival per cluster between cluster barriers) measured
//     slower: a cluster barrier costs more than the atomics it saves, so no
//     step waits on one (mamba_tts_torch/diag/card_probes.py measures all
//     three).
//   - Channel ownership for the Mamba half: block g owns d_inner channels
//     [di*g/G, di*(g+1)/G).  It computes the in_proj columns of its channels
//     (x and z halves), their conv and SiLU, and its partial sums of the
//     x-projection, and pushes each partial to the rank of its cluster that
//     adds that output (st.async into the receiver's shared memory, which
//     completes the bytes on the receiver's mbarrier: only the receiver
//     waits); the cluster's sums go to global memory and every block adds them
//     in cluster order after the barrier and rounds to bf16: identical dbc
//     everywhere, no extra barrier.  The conv ring and the f32 SSM state of its
//     channels stay in its shared memory for the whole launch, with A, D,
//     dt_b, dt_w, conv_w and its slice of the x-projection; only the final
//     state is written out.
//   - Every product runs on all of a block's warps: a block owns a fixed range
//     of output columns, its warps split each column's K into 32-lane
//     segments, and the segment sums join in shared memory in a fixed order
//     (no float atomics; a run repeats bit for bit).  Each epilogue's first
//     scale and bias are asked for before the product.
//   - q_proj and attention are one stage on a cluster per (row, head): the TS
//     blocks each compute hd/TS of the head's q columns and push them to every
//     rank, score their slice of the memory, push the slice's max and then its
//     sum to every rank, round probabilities with the global max and sum as the
//     reference does, and push their P @ V part of each channel to the rank
//     that owns the channel, which adds the parts in rank order.
//   - Every block takes the argmax itself and embeds the next token itself.
//   A layer is then 7 stages (Mamba in | SSM + gate | out_proj | attention |
//   o_proj | ff1 | ff2) and a step 7 L + 1 grid barriers (57 at 8 layers,
//   against 82).  A streamed weight slice is prefetched into L2 before the
//   barrier in front of its stage; so are the attention unit's K/V slices.
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
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr long long kSpinLimit = 6000000000LL;  // clock cycles (a few seconds) a barrier may wait
constexpr int kMaxSmem = 232448;                // shared memory one H100 block may use
constexpr int kStaticSmem = 1024;               // the kernel's static shared variables fit in this
constexpr int kOneBlockSmem = 120 * 1024;       // at least this much: one block per SM
constexpr int kU = 4;                           // segments a warp has in flight in a product

// The block-owned products, in the order of their resident copies in shared
// memory and of the bits of MKParams::resident.
enum { P_IN, P_OUT, P_Q, P_O, P_FF1, P_FF2, P_HEAD, P_COUNT };

// Mirrors _MKParams in ../decode_megakernel.py: pointers, then ints, then a float.
struct MKParams {
  const bf16* emb_pq;       // (total, d)
  const bf16* token_embed;  // (Vpad, d)
  const float* norms;       // (L, 6, d)
  const void* in_w;         // (L, 2di, d) int8 | bf16, rows block-major: [x cols, z cols] of block 0, 1, ...
  const float* in_s;        // (L, 2di) in the same row order
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
  bf16* conv_state;         // (L, dc-1, B, di) out
  float* ssm_state;         // (L, B, N, di) out
  bf16* x;                  // (B, d) residual stream
  bf16* y;                  // (B, di) gated SSM output
  bf16* attn;               // (B, d) attention row
  bf16* h1;                 // (B, dff)
  float* xpart;             // (clusters, B, r+2N) x-projection sums, one per cluster
  unsigned long long* sync; // [0] barrier arrivals, [1] error word
  long long* stage_clock;   // optional (null): block 0 stamps clock64() around each barrier
  int total, B, L, d, di, N, r, dc, H, dff, Vpad, Tmp, bos, w_int8, kv_int8;
  int grid, TS, resident, smem_bytes;
  float att_scale;
  int clock_step;           // the step whose barriers are stamped
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int tile_of(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8; }
// first index of part g of n split over G parts
__host__ __device__ inline int split_lo(int n, int G, int g) { return n * g / G; }

// Byte offsets of every region of a block's dynamic shared memory.  Sizes use
// the largest share any block gets.  Mirrors _smem_layout in
// ../decode_megakernel.py; the launcher refuses a plan whose size differs.
struct Layout {
  int xrow, xs, part, red, mamba, xrecv, dbc, scores, qk, smax, ssum, orecv, wpart;
  int ring, ssm, conv_w, conv_b, xp_w, dt_w, dt_b, A, D;
  int prod[P_COUNT];
  int rows[P_COUNT], K[P_COUNT], esize[P_COUNT], layers[P_COUNT];
  int nc, ncd, nff, nv, qc, Tc, BT, total;
};

__host__ __device__ inline Layout make_layout(const MKParams& p) {
  Layout s;
  const int G = p.grid, BT = tile_of(p.B), L = p.L, d = p.d, di = p.di, nx = p.r + 2 * p.N;
  const int hd = p.d / p.H, wb = p.w_int8 ? 1 : 2;
  s.BT = BT;
  s.nc = cdiv(di, G);
  s.ncd = cdiv(d, G);
  s.nff = cdiv(p.dff, G);
  s.nv = cdiv(p.Vpad, G);
  s.qc = hd / p.TS;
  s.Tc = p.Tmp / p.TS;
  const int rows[P_COUNT] = {2 * s.nc, s.ncd, s.qc, s.ncd, s.nff, s.ncd, s.nv};
  const int Ks[P_COUNT] = {d, di, d, d, d, p.dff, d};
  int segs = 0;
  for (int i = 0; i < P_COUNT; ++i) {
    s.rows[i] = rows[i];
    s.K[i] = Ks[i];
    s.esize[i] = i == P_HEAD ? 2 : wb;
    s.layers[i] = i == P_HEAD ? 1 : L;
    segs = imax(segs, rows[i] * cdiv(Ks[i], 32 * (16 / s.esize[i])));
  }
  int off = 0;
  auto take = [&](int bytes) { const int o = off; off += align16(bytes); return o; };
  s.xrow = take(4 * BT * d);
  s.xs = take(4 * BT * imax(d, imax(di, p.dff)));
  s.part = take(4 * BT * segs);
  s.red = take(4 * kWarps * imax(BT, 2));
  s.mamba = take(4 * 3 * BT * s.nc);
  s.xrecv = take(4 * (BT * nx + 8));
  s.dbc = take(4 * BT * nx);
  s.scores = take(4 * s.Tc);
  s.qk = take(4 * hd);
  s.smax = take(4 * 8);
  s.ssum = take(4 * 8);
  s.orecv = take(4 * hd);
  s.wpart = take(4 * kWarps * hd);
  s.ring = take(4 * L * (p.dc - 1) * BT * s.nc);
  s.ssm = take(4 * L * BT * p.N * s.nc);
  s.conv_w = take(4 * L * p.dc * s.nc);
  s.conv_b = take(4 * L * s.nc);
  s.xp_w = take(2 * L * nx * s.nc);
  s.dt_w = take(2 * L * p.r * s.nc);
  s.dt_b = take(4 * L * s.nc);
  s.A = take(4 * L * p.N * s.nc);
  s.D = take(4 * L * s.nc);
  for (int i = 0; i < P_COUNT; ++i)
    s.prod[i] = (p.resident >> i) & 1 ? take(s.rows[i] * s.K[i] * s.esize[i] * s.layers[i]) : -1;
  s.total = imax(off, kOneBlockSmem);
  return s;
}

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

// Ask the L2 for [base, base + bytes) ahead of its use (one 128-byte line per
// thread and round); the loads after the next barrier then find it there.
__device__ __forceinline__ void prefetch_l2(const void* base, size_t bytes) {
  const char* c = static_cast<const char*>(base);
  for (size_t off = static_cast<size_t>(threadIdx.x) * 128; off < bytes;
       off += static_cast<size_t>(kThreads) * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
}

// ---- products: one block, its own output columns, all of its warps

// One 16-byte chunk of weights against BT activation rows (f32 in shared memory).
template <int BT>
__device__ __forceinline__ void dot16(const uint4& v, const int8_t*, const float* x, int stride,
                                      int B, float (&acc)[BT]) {
  const unsigned q[4] = {v.x, v.y, v.z, v.w};
  float wf[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wf[4 * i + j] = static_cast<float>(static_cast<int>(static_cast<signed char>(q[i] >> (8 * j))));
#pragma unroll
  for (int b = 0; b < BT; ++b)
    if (b < B) {
      const float4* xp = reinterpret_cast<const float4*>(x + b * stride);
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

template <int BT>
__device__ __forceinline__ void dot16(const uint4& v, const bf16*, const float* x, int stride,
                                      int B, float (&acc)[BT]) {
  const unsigned q[4] = {v.x, v.y, v.z, v.w};
  float wf[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wf[2 * i] = __uint_as_float(q[i] << 16);
    wf[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
  }
#pragma unroll
  for (int b = 0; b < BT; ++b)
    if (b < B) {
      const float4* xp = reinterpret_cast<const float4*>(x + b * stride);
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


// xs (B rows of K, f32, shared) @ the block's ncol weight rows w (ncol x K,
// contiguous, resident in shared memory or streamed from global memory).
// A segment is 32 lanes x one 16-byte chunk of one row; warp w takes segments
// w, w + kWarps, ..., kU at a time with every load in flight before any use; each
// segment's sum (a shuffle tree) goes to part, then the segments of a column
// are added in order into the column's first: (col, b) ends in
// part[col * spc * BT + b]; returns spc.
template <typename WT, int BT>
__device__ __forceinline__ int block_matvec(const WT* w, bool smem_w, int K, int ncol,
                                         const float* xs, int B, float* part) {
  constexpr int E = 16 / static_cast<int>(sizeof(WT));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = K / E, spc = (chunks + 31) / 32, nseg = ncol * spc;
  for (int s0 = warp; s0 < nseg; s0 += kWarps * kU) {
    uint4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int s = s0 + u * kWarps, ch = (s % spc) * 32 + lane;
      if (s < nseg && ch < chunks) {
        const uint4* src = reinterpret_cast<const uint4*>(w + static_cast<size_t>(s / spc) * K + ch * E);
        v[u] = smem_w ? *src : __ldg(src);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int s = s0 + u * kWarps, ch = (s % spc) * 32 + lane;
      if (s < nseg) {  // warp-uniform
        float acc[BT];
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = 0.0f;
        if (ch < chunks) dot16<BT>(v[u], w, xs + ch * E, K, B, acc);
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = warp_sum(acc[b]);
        if (lane == 0)
#pragma unroll
          for (int b = 0; b < BT; ++b) part[s * BT + b] = acc[b];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ncol * B; i += kThreads) {
    const int col = i / B, b = i % B;
    float a = 0.0f;
    for (int j = 0; j < spc; ++j) a += part[(col * spc + j) * BT + b];
    part[col * spc * BT + b] = a;  // (only this thread reads the slots of (col, b))
  }
  return spc;
}

// A product and its epilogue: epi(b, col, sum, first) runs for every (column,
// row) of the block, first when it is the thread's first, whose scale and
// bias the caller asked for before the product (Pre).  Ends synchronised.
template <typename WT, int BT, typename Epi>
__device__ __forceinline__ void matvec(const WT* w, bool smem_w, int K, int ncol, const float* xs,
                                       int B, float* part, Epi epi) {
  const int spc = block_matvec<WT, BT>(w, smem_w, K, ncol, xs, B, part);
  for (int i = threadIdx.x; i < ncol * B; i += kThreads) {
    const int col = i / B, b = i % B;
    epi(b, col, part[col * spc * BT + b], i == static_cast<int>(threadIdx.x));
  }
  __syncthreads();
}

// The scale and bias of the thread's first (column, row) of a product's
// epilogue (scale and bias relative to the block's first column; either may
// be null), asked for before the product so that their latency hides in it.
struct Pre {
  float s, b;
};
__device__ __forceinline__ Pre pre_load(const float* scale, const float* bias, int ncol, int B) {
  Pre r{1.0f, 0.0f};
  const int i = threadIdx.x;
  if (i < ncol * B) {
    if (scale != nullptr) r.s = __ldg(scale + i / B);
    if (bias != nullptr) r.b = __ldg(bias + i / B);
  }
  return r;
}

// (acc * scale) -> bf16 for int8 weights; acc -> bf16 for bf16 weights (scale folded).
__device__ __forceinline__ float dq(const int8_t*, float acc, float scale) { return bf16r(acc * scale); }
__device__ __forceinline__ float dq(const bf16*, float acc, float) { return bf16r(acc); }

// n bf16 values of a global buffer written in this launch -> f32 in shared memory.
__device__ __forceinline__ void load_rows(const bf16* g, int n, float* xs) {
  for (int i = threadIdx.x; i < n; i += kThreads) xs[i] = ld_act(g + i);
  __syncthreads();
}

// Sums of BT per-thread values over the block, in a fixed order: shuffle tree
// within each warp, then the warp sums in turn.  red holds BT * kWarps floats.
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

// LayerNorm (eps 1e-6, f32 statistics, bf16 result) of the B rows of xr
// (shared, f32) into xs; with gamma/beta also FiLM, each op rounded to bf16.
// The whole block takes part (a thread per column), so that all of its loads
// are in flight together; a thread's first column's parameters are asked for
// before the sums.  (One warp per row was measured slower: one warp cannot
// keep a row's loads in flight.)
template <int BT>
__device__ __forceinline__ void ln_rows(const float* xr, const float* __restrict__ scale,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta, float* xs, float* red,
                                        int B, int d) {
  const int tid = threadIdx.x;
  const bool has0 = tid < d;
  const float sc0 = has0 ? __ldg(scale + tid) : 0.0f, bi0 = has0 ? __ldg(bias + tid) : 0.0f;
  float g0[BT], be0[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    const bool on = gamma != nullptr && has0 && b < B;
    g0[b] = on ? __ldg(gamma + b * d + tid) : 1.0f;
    be0[b] = on ? __ldg(beta + b * d + tid) : 0.0f;
  }
  float s[BT], sq[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) s[b] = sq[b] = 0.0f;
  for (int j = tid; j < d; j += kThreads)
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < B) s[b] += xr[b * d + j];
  block_sum_rows<BT>(s, red);
  for (int j = tid; j < d; j += kThreads)
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < B) {
        const float dv = xr[b * d + j] - s[b] / static_cast<float>(d);
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
        float v = bf16r((xr[b * d + j] - mu) * rs * sc + bi);
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

// ---- the grid barrier

__device__ __forceinline__ void red_release_add(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// ---- exchanges inside a cluster: each block pushes values into the others'
// shared memory with st.async, which completes their bytes on the receiver's
// mbarrier; the receiver waits for its mbarrier's phase, no block waits for
// a cluster barrier.  One mbarrier per exchange point; consecutive uses of
// one are ordered by the exchanges and grid barriers between them, so a
// push never lands in the phase before the one it belongs to.
enum { X_XPROJ, X_QK, X_MAX, X_SUM, X_OUT, X_COUNT };

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// v into *dst of cluster rank `to` (dst: the address in this block's shared
// memory of the same slot), completing 4 bytes on that rank's mbarrier; a
// plain store when `to` is this block.
__device__ __forceinline__ void push(float* dst, int to, int me, uint64_t* bar, float v) {
  if (to == me) {
    *dst = v;
    return;
  }
  uint32_t ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(smem_u32(dst)), "r"(to));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(smem_u32(bar)), "r"(to));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}

// Thread 0: this phase of bar completes when `bytes` have come from the
// other blocks (they may have come already).
__device__ __forceinline__ void expect_bytes(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Every thread: wait for the phase of bar whose parity bit `which` of par
// holds, then flip the bit.  A wait that never ends traps instead of hanging.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t& par, int which) {
  const uint32_t parity = (par >> which) & 1u;
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) break;
    if (clock64() - t0 > kSpinLimit) __trap();
  }
  par ^= 1u << which;
}

// Every block arrives, then waits until all have: the block's __syncthreads
// orders its threads' writes before thread 0's release reduction, and the
// acquire poll plus the closing __syncthreads orders the other blocks'
// writes before this block's reads (which go to L2: ld.global.cg).  A wait
// beyond kSpinLimit sets the error word, and every block that sees it leaves.
__device__ __forceinline__ bool grid_barrier(unsigned long long* sync, unsigned long long& target,
                                             int* s_ok) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    red_release_add(sync, 1ULL);
    const long long t0 = clock64();
    int ok = 1;
    unsigned spins = 0;
    while (ld_acquire(sync) < target) {
      if ((++spins & 63u) == 0u) {
        if (ld_relaxed(sync + 1) != 0ULL) { ok = 0; break; }
        if (clock64() - t0 > kSpinLimit) { atomicExch(&sync[1], 1ULL); ok = 0; break; }
      }
    }
    *s_ok = ok;
  }
  __syncthreads();
  return *s_ok != 0;
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

// Everything one block needs in one launch: where its shared regions are, and
// which channels, columns and attention unit it owns.
struct Block {
  Layout lay;
  char* sm;
  int G, g, cid, rank, nclusters;
  int c0, nch;      // d_inner channels [c0, c0 + nch)
  int dlo, ndc;     // d-wide product columns (out_proj, o_proj, ff2)
  int flo, nfc;     // ff1 columns
  int vlo, nvc;     // head columns
  __device__ float* f(int off) const { return reinterpret_cast<float*>(sm + off); }
};

// Slice of product p for layer l: its block's rows, in shared memory when
// resident, else in global memory.  Rows of in_w are block-major; q_w's
// rows are those of the cluster's head (h) and this rank.
template <typename WT>
__device__ __forceinline__ const WT* slice(const Block& bk, int pr, const void* gw, int l, int N,
                                           int row0) {
  const Layout& s = bk.lay;
  if (s.prod[pr] >= 0)
    return reinterpret_cast<const WT*>(bk.sm + s.prod[pr]) +
           static_cast<size_t>(l) * s.rows[pr] * s.K[pr];
  return static_cast<const WT*>(gw) + (static_cast<size_t>(l) * N + row0) * s.K[pr];
}

// Copy rows [row0, row0 + nrows) x K of each layer of a (L, N, K) weight into
// the block's resident region (layer stride: the region's row count).
template <typename WT>
__device__ __forceinline__ void copy_resident(const Block& bk, int pr, const void* gw, int N,
                                              int row0, int nrows) {
  const Layout& s = bk.lay;
  const int per_layer = nrows * s.K[pr] * static_cast<int>(sizeof(WT)) / 16;
  for (int l = 0; l < s.layers[pr]; ++l) {
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const WT*>(gw) + (static_cast<size_t>(l) * N + row0) * s.K[pr]);
    uint4* dst = reinterpret_cast<uint4*>(bk.sm + s.prod[pr] +
                                          static_cast<size_t>(l) * s.rows[pr] * s.K[pr] * sizeof(WT));
    for (int i = threadIdx.x; i < per_layer; i += kThreads) dst[i] = __ldg(src + i);
  }
}

// Stage 4, one (row b, head h) unit on the cluster: q columns of this rank,
// pushed to every rank of the cluster; this rank's memory slice scored; the
// slice maxima and then sums exchanged, probabilities rounded with the global
// max and sum; P @ V of the slice, pushed channel by channel to the rank that
// owns the channel, which adds the cluster's parts in rank order into its
// channels of the attention row.
template <typename WT, typename KT>
__device__ __forceinline__ void attention_unit(const MKParams& p, const Block& bk, int l, int b,
                                               int h, uint64_t* mbar, uint32_t& par) {
  const Layout& s = bk.lay;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = p.d, Tmp = p.Tmp, hd = d / p.H, TS = p.TS, qc = s.qc, Tc = s.Tc, ts = bk.rank;
  const size_t lb = static_cast<size_t>(l) * p.B + b;
  float* xs = bk.f(s.xs);
  float* qk = bk.f(s.qk);
  float* smax = bk.f(s.smax);
  float* ssum = bk.f(s.ssum);
  float* S = bk.f(s.scores);
  float* orecv = bk.f(s.orecv);
  float* wpart = bk.f(s.wpart);
  float* red = bk.f(s.red);
  if (tid == 0) {  // the bytes each exchange of this unit gets from the other ranks
    expect_bytes(mbar + X_QK, 4 * qc * (TS - 1));
    expect_bytes(mbar + X_MAX, 4 * (TS - 1));
    expect_bytes(mbar + X_SUM, 4 * (TS - 1));
    expect_bytes(mbar + X_OUT, 4 * qc * (TS - 1));
  }

  // q columns [h*hd + rank*qc, + qc) of row b (LN row b in xs), times K's per-channel scale
  const int q0 = h * hd + ts * qc;
  const WT* w = slice<WT>(bk, P_Q, p.q_w, l, d, q0);
  const float* qs_ = p.q_s + static_cast<size_t>(l) * d + q0;
  const float* qb_ = p.q_b + static_cast<size_t>(l) * d + q0;
  const Pre pr = pre_load(qs_, qb_, qc, 1);
  const float ks0 = tid < qc ? __ldg(p.k_scale + lb * d + q0 + tid) : 0.0f;
  matvec<WT, 1>(w, s.prod[P_Q] >= 0, d, qc, xs + b * d, 1, bk.f(s.part), [&](int, int col, float acc, bool f) {
    const int j = q0 + col;
    const float q = bf16r(dq(w, acc, f ? pr.s : __ldg(qs_ + col)) + bf16r(f ? pr.b : __ldg(qb_ + col)));
    qk[ts * qc + col] = bf16r(q * (f ? ks0 : __ldg(p.k_scale + lb * d + j)));
  });
  for (int i = tid; i < qc * TS; i += kThreads) {
    const int to = i / qc, c = ts * qc + i % qc;
    if (to != ts) push(qk + c, to, ts, mbar + X_QK, qk[c]);
  }
  wait_phase(mbar + X_QK, par, X_QK);

  // scores of this slice, (qk . K) * att_scale + mask, f32, into S.  JS
  // neighbouring lanes share 8 positions and split the head's channels.
  int JS = 16;  // a power of two
  while (JS > 1 && (JS > hd / 2 || (Tc / 8) * JS > kThreads)) JS >>= 1;
  const int CH = hd / JS, js = tid % JS;
  const KT* Kb = static_cast<const KT*>(p.K) + (lb * d + h * hd) * Tmp;
  const float* mask = p.mask_row + static_cast<size_t>(b) * Tmp;
  float mx = -3.0e38f;
  for (int base = ts * Tc; base < (ts + 1) * Tc; base += (kThreads / JS) * 8) {  // uniform
    const int t8 = base + (tid / JS) * 8;
    const bool on = t8 < (ts + 1) * Tc;
    float a[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (on) {
      const KT* Kr = Kb + static_cast<size_t>(js * CH) * Tmp + t8;
#pragma unroll 4
      for (int j = 0; j < CH; ++j) {
        float kv[8];
        load8(Kr + static_cast<size_t>(j) * Tmp, kv);
        const float qv = qk[js * CH + j];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = fmaf(qv, kv[i], a[i]);
      }
    }
    for (int off = 1; off < JS; off <<= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
    if (on && js == 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float sv = a[i] * p.att_scale + __ldg(mask + t8 + i);
        S[t8 - ts * Tc + i] = sv;
        mx = fmaxf(mx, sv);
      }
  }
  mx = block_max(mx, red);  // (its first __syncthreads publishes S)
  if (tid < TS) push(smax + ts, tid, ts, mbar + X_MAX, mx);
  __syncthreads();
  wait_phase(mbar + X_MAX, par, X_MAX);
  float gmax = smax[0];
  for (int q = 1; q < TS; ++q) gmax = fmaxf(gmax, smax[q]);
  float sum = 0.0f;
  for (int t = tid; t < Tc; t += kThreads) {
    const float e = expf(S[t] - gmax);
    S[t] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  if (tid < TS) push(ssum + ts, tid, ts, mbar + X_SUM, sum);
  __syncthreads();
  wait_phase(mbar + X_SUM, par, X_SUM);
  float gsum = 0.0f;
  for (int q = 0; q < TS; ++q) gsum += ssum[q];  // rank order
  for (int t = tid; t < Tc; t += kThreads) S[t] = bf16r(S[t] / gsum);
  __syncthreads();

  // P @ V of the slice: lane = (position within the warp's group, 8 channels)
  const int CL = hd / 8, PS = 32 / CL;
  const int cgp = lane % CL, ps = lane / CL;
  const KT* Vb = static_cast<const KT*>(p.V) + lb * Tmp * d + h * hd + cgp * 8;
  float o[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int t = warp * PS + ps; t < Tc; t += kWarps * PS) {
    float v[8];
    load8(Vb + static_cast<size_t>(ts * Tc + t) * d, v);
    const float pt = S[t];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = fmaf(pt, v[i], o[i]);
  }
  for (int off = CL; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] += __shfl_xor_sync(0xffffffffu, o[i], off);
  if (ps == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i) wpart[warp * hd + cgp * 8 + i] = o[i];
  __syncthreads();
  // channel j of this slice's part, to slot [rank][j % qc] of the rank that owns j
  for (int j = tid; j < hd; j += kThreads) {
    float o_sum = 0.0f;
    for (int w2 = 0; w2 < kWarps; ++w2) o_sum += wpart[w2 * hd + j];
    push(orecv + ts * qc + j % qc, j / qc, ts, mbar + X_OUT, o_sum);
  }
  __syncthreads();
  wait_phase(mbar + X_OUT, par, X_OUT);
  // this rank's channels: the cluster's parts in rank order, times V's scale, bf16
  for (int j = tid; j < qc; j += kThreads) {
    float a = 0.0f;
    for (int q = 0; q < TS; ++q) a += orecv[q * qc + j];
    const size_t col = static_cast<size_t>(h) * hd + ts * qc + j;
    st_act(p.attn + b * d + col, bf16r(a * __ldg(p.v_scale + lb * d + col)));
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
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ int s_tok[BT];
  __shared__ int s_ok;
  __shared__ __align__(8) uint64_t s_mbar[X_COUNT];  // one per exchange point
  __shared__ Block s_bk;  // (in shared memory: a per-thread copy would spill)
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = p.B, L = p.L, d = p.d, di = p.di, N = p.N, r = p.r, dc = p.dc, dff = p.dff;
  const int nx = r + 2 * N;
  const int units = B * p.H, hd = d / p.H;

  if (tid == 0) {
    Block& w = s_bk;
    w.lay = make_layout(p);
    w.sm = smem_raw;
    w.G = gridDim.x;
    w.g = blockIdx.x;
    w.rank = static_cast<int>(cluster.block_rank());
    w.cid = w.g / p.TS;
    w.nclusters = w.G / p.TS;
    w.c0 = split_lo(di, w.G, w.g);
    w.nch = split_lo(di, w.G, w.g + 1) - w.c0;
    w.dlo = split_lo(d, w.G, w.g);
    w.ndc = split_lo(d, w.G, w.g + 1) - w.dlo;
    w.flo = split_lo(dff, w.G, w.g);
    w.nfc = split_lo(dff, w.G, w.g + 1) - w.flo;
    w.vlo = split_lo(p.Vpad, w.G, w.g);
    w.nvc = split_lo(p.Vpad, w.G, w.g + 1) - w.vlo;
    // the q slice is fixed for the launch only with one unit per cluster (the
    // plan makes it resident only then)
    if (units > w.nclusters) w.lay.prod[P_Q] = -1;
    for (int i = 0; i < X_COUNT; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(s_mbar + i)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // every mbarrier of the cluster is initialised before any push
  const Block& bk = s_bk;
  const Layout& s = bk.lay;
  const int nc = s.nc, c0 = bk.c0, nch = bk.nch;
  const bool one_unit = units <= bk.nclusters;
  uint64_t* mbar = s_mbar;
  uint32_t par = 0;  // parity of each exchange's current mbarrier phase

  float* xrow = bk.f(s.xrow);
  float* xs = bk.f(s.xs);
  float* part = bk.f(s.part);
  float* red = bk.f(s.red);
  float* xin = bk.f(s.mamba);
  float* zr = xin + BT * nc;
  float* xcv = zr + BT * nc;
  float* xrecv = bk.f(s.xrecv);
  float* dbc = bk.f(s.dbc);
  float* ring = bk.f(s.ring);
  float* ssm = bk.f(s.ssm);
  float* cw = bk.f(s.conv_w);
  float* cb = bk.f(s.conv_b);
  unsigned short* xpw = reinterpret_cast<unsigned short*>(bk.sm + s.xp_w);
  unsigned short* dtw = reinterpret_cast<unsigned short*>(bk.sm + s.dt_w);
  float* dtb = bk.f(s.dt_b);
  float* Am = bk.f(s.A);
  float* Dm = bk.f(s.D);

  // ---- launch start: the owned channels' parameters and zero state, and the
  // resident weight slices, into shared memory (once)
  for (int i = tid; i < L * dc * nch; i += kThreads) {
    const int l = i / (dc * nch), k = (i / nch) % dc, c = i % nch;
    cw[(l * dc + k) * nc + c] = ld_ro(p.conv_w + (static_cast<size_t>(l) * dc + k) * di + c0 + c);
  }
  for (int i = tid; i < L * nch; i += kThreads) {
    const int l = i / nch, c = i % nch;
    cb[l * nc + c] = __ldg(p.conv_b + l * di + c0 + c);
    dtb[l * nc + c] = __ldg(p.dt_b + l * di + c0 + c);
    Dm[l * nc + c] = __ldg(p.D + l * di + c0 + c);
  }
  for (int i = tid; i < L * nx * nch; i += kThreads) {
    const int l = i / (nx * nch), j = (i / nch) % nx, c = i % nch;
    xpw[(l * nx + j) * nc + c] = __ldg(reinterpret_cast<const unsigned short*>(
        p.xp_w + (static_cast<size_t>(l) * nx + j) * di + c0 + c));
  }
  for (int i = tid; i < L * r * nch; i += kThreads) {
    const int l = i / (r * nch), k = (i / nch) % r, c = i % nch;
    dtw[(l * r + k) * nc + c] = __ldg(reinterpret_cast<const unsigned short*>(
        p.dt_w + (static_cast<size_t>(l) * r + k) * di + c0 + c));
  }
  for (int i = tid; i < L * N * nch; i += kThreads) {
    const int l = i / (N * nch), n = (i / nch) % N, c = i % nch;
    Am[(l * N + n) * nc + c] = __ldg(p.A + (static_cast<size_t>(l) * N + n) * di + c0 + c);
  }
  for (int i = tid; i < L * (dc - 1) * BT * nc; i += kThreads) ring[i] = 0.0f;
  for (int i = tid; i < L * BT * N * nc; i += kThreads) ssm[i] = 0.0f;
  if (s.prod[P_IN] >= 0) copy_resident<WT>(bk, P_IN, p.in_w, 2 * di, 2 * c0, 2 * nch);
  if (s.prod[P_OUT] >= 0) copy_resident<WT>(bk, P_OUT, p.out_w, d, bk.dlo, bk.ndc);
  if (s.prod[P_Q] >= 0 && bk.cid < units)
    copy_resident<WT>(bk, P_Q, p.q_w, d, (bk.cid % p.H) * hd + bk.rank * s.qc, s.qc);
  if (s.prod[P_O] >= 0) copy_resident<WT>(bk, P_O, p.o_w, d, bk.dlo, bk.ndc);
  if (s.prod[P_FF1] >= 0) copy_resident<WT>(bk, P_FF1, p.ff1_w, dff, bk.flo, bk.nfc);
  if (s.prod[P_FF2] >= 0) copy_resident<WT>(bk, P_FF2, p.ff2_w, d, bk.dlo, bk.ndc);
  if (s.prod[P_HEAD] >= 0) copy_resident<bf16>(bk, P_HEAD, p.head_w, p.Vpad, bk.vlo, bk.nvc);
  if (tid < B) s_tok[tid] = p.bos;
  __syncthreads();

  unsigned long long target = 0;
  int stamp = 0;
  const int kv_bytes = p.kv_int8 ? 1 : 2;
  // Stamps of the diagnostic: block 0 stamps the step's start and both sides of
  // every grid barrier of step p.clock_step.
  auto barrier = [&](int t) -> bool {
    const bool rec = p.stage_clock != nullptr && t == p.clock_step && bk.g == 0 && tid == 0;
    if (rec) p.stage_clock[stamp++] = clock64();
    const bool ok = grid_barrier(p.sync, target, &s_ok);
    if (rec) p.stage_clock[stamp++] = clock64();
    return ok;
  };
  // a streamed slice of the next stage's product, asked of the L2 before the barrier
  auto prefetch_w = [&](int pr, const void* gw, int l, int N_, int row0, int nrows) {
    if (s.prod[pr] < 0)
      prefetch_l2(static_cast<const char*>(gw) +
                      (static_cast<size_t>(l) * N_ + row0) * s.K[pr] * s.esize[pr],
                  static_cast<size_t>(nrows) * s.K[pr] * s.esize[pr]);
  };

  for (int t = 0; t < p.total; ++t) {
    if (p.stage_clock != nullptr && t == p.clock_step && bk.g == 0 && tid == 0)
      p.stage_clock[stamp++] = clock64();
    if (p.forced != nullptr && tid < B) s_tok[tid] = __ldg(p.forced + t * B + tid);
    __syncthreads();
    // ---- embed: token row + this step's pos/quant row, in bf16, by every block
    for (int i = tid; i < B * d; i += kThreads) {
      const int b = i / d, j = i % d;
      xrow[i] = bf16r(ld_ro(p.token_embed + static_cast<size_t>(s_tok[b]) * d + j) +
                      ld_ro(p.emb_pq + static_cast<size_t>(t) * d + j));
    }
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      const float* nb = p.norms + static_cast<size_t>(l) * 6 * d;
      // ---- 1. LN, in_proj of the owned channels (x and z halves), conv + SiLU,
      // x-projection partials; the cluster's sum to xpart
      if (l > 0) load_rows(p.x, B * d, xrow);  // (layer 0: xrow holds this step's embedding)
      ln_rows<BT>(xrow, nb, nb + d, nullptr, nullptr, xs, red, B, d);
      {
        const WT* w = slice<WT>(bk, P_IN, p.in_w, l, 2 * di, 2 * c0);
        const float* sc = p.in_s + static_cast<size_t>(l) * 2 * di + 2 * c0;
        const Pre pr = pre_load(sc, nullptr, 2 * nch, B);
        matvec<WT, BT>(w, s.prod[P_IN] >= 0, d, 2 * nch, xs, B, part,
                       [&](int b, int col, float acc, bool f) {
          const float v = dq(w, acc, f ? pr.s : __ldg(sc + col));
          if (col < nch) xin[b * nc + col] = v;
          else zr[b * nc + col - nch] = v;
        });
      }
      for (int i = tid; i < B * nch; i += kThreads) {
        const int b = i / nch, c = i % nch;
        const float xv = xin[b * nc + c];
        float* rg = ring + (static_cast<size_t>(l) * (dc - 1) * BT + b) * nc + c;  // tap k at k*BT*nc
        const float* w = cw + static_cast<size_t>(l) * dc * nc + c;
        float acc = bf16r(xv * w[(dc - 1) * nc]);
        for (int k = 0; k < dc - 1; ++k) acc = bf16r(acc + bf16r(rg[k * BT * nc] * w[k * nc]));
        acc = bf16r(acc + bf16r(cb[l * nc + c]));
        xcv[b * nc + c] = silu_bf16(acc);
        for (int k = 0; k < dc - 2; ++k) rg[k * BT * nc] = rg[(k + 1) * BT * nc];
        rg[(dc - 2) * BT * nc] = xv;
      }
      __syncthreads();
      {  // x-projection partials over the owned channels, each pushed to the rank of the
         // cluster that sums it; this rank's share summed in rank order, to xpart
        const int n = B * nx, TS = p.TS, me = bk.rank;
        const int lo = split_lo(n, TS, me), cnt = split_lo(n, TS, me + 1) - lo;
        if (tid == 0) expect_bytes(mbar + X_XPROJ, 4 * cnt * (TS - 1));
        for (int i = tid; i < n; i += kThreads) {
          const int b = i / nx, j = i % nx;
          const unsigned short* w = xpw + (static_cast<size_t>(l) * nx + j) * nc;
          float a = 0.0f;
          for (int c = 0; c < nch; ++c) a = fmaf(xcv[b * nc + c], bits_to_float(w[c]), a);
          int to = TS - 1;
          while (split_lo(n, TS, to) > i) --to;
          const int tlo = split_lo(n, TS, to), tcnt = split_lo(n, TS, to + 1) - tlo;
          push(xrecv + me * tcnt + i - tlo, to, me, mbar + X_XPROJ, a);
        }
        __syncthreads();
        wait_phase(mbar + X_XPROJ, par, X_XPROJ);
        for (int e = tid; e < cnt; e += kThreads) {
          float a = 0.0f;
          for (int q = 0; q < TS; ++q) a += xrecv[q * cnt + e];
          p.xpart[static_cast<size_t>(bk.cid) * n + lo + e] = a;
        }
      }
      if (!barrier(t)) return;

      // ---- 2. dbc (the clusters' sums in order), dt, softplus, SSM update and
      // gate of the owned channels.  A group of N lanes takes one (row,
      // channel): lane n holds state n and a share of the dt-rank.
      {
        const int n = B * nx;
        for (int i = tid; i < n; i += kThreads) {
          float a = 0.0f;
          for (int k0 = 0; k0 < bk.nclusters; k0 += 8) {
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              v[u] = k0 + u < bk.nclusters ? __ldcg(p.xpart + static_cast<size_t>(k0 + u) * n + i) : 0.0f;
#pragma unroll
            for (int u = 0; u < 8; ++u) a += v[u];  // cluster order (the padding adds zeros)
          }
          dbc[i] = bf16r(a);
        }
      }
      __syncthreads();
      {
        const int groups = B * nch, lanes = ((groups * N + 31) / 32) * 32;
        for (int base = warp * 32; base < lanes; base += kThreads) {  // warp-uniform
          const int i = base + lane, gi = i / N, n = i % N;
          const bool on = gi < groups;
          const int b = on ? gi / nch : 0, c = on ? gi % nch : 0;
          float acc = 0.0f;
          if (on)
            for (int k = n; k < r; k += N)
              acc = fmaf(dbc[b * nx + k], bits_to_float(dtw[(static_cast<size_t>(l) * r + k) * nc + c]), acc);
          for (int off = N / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
          float yv = 0.0f, xv = 0.0f;
          if (on) {
            const float dt = softplus_f32(bf16r(acc) + dtb[l * nc + c]);
            xv = xcv[b * nc + c];
            const float dtx = dt * xv;
            float* hp = ssm + ((static_cast<size_t>(l) * BT + b) * N + n) * nc + c;
            const float hn = expf(dt * Am[(l * N + n) * nc + c]) * *hp + dbc[b * nx + r + n] * dtx;
            *hp = hn;
            yv = dbc[b * nx + r + N + n] * hn;
          }
          for (int off = N / 2; off > 0; off >>= 1) yv += __shfl_xor_sync(0xffffffffu, yv, off);
          if (on && n == 0) {
            const float yb = bf16r(yv + xv * Dm[l * nc + c]);
            st_act(p.y + b * di + c0 + c, bf16r(yb * silu_bf16(zr[b * nc + c])));
          }
        }
      }
      prefetch_w(P_OUT, p.out_w, l, d, bk.dlo, bk.ndc);
      if (!barrier(t)) return;

      // ---- 3. out_proj: x += dq(y @ out_w) on the owned columns
      load_rows(p.y, B * di, xs);
      {
        const WT* w = slice<WT>(bk, P_OUT, p.out_w, l, d, bk.dlo);
        const float* sc = p.out_s + static_cast<size_t>(l) * d + bk.dlo;
        const Pre pr = pre_load(sc, nullptr, bk.ndc, B);
        matvec<WT, BT>(w, s.prod[P_OUT] >= 0, di, bk.ndc, xs, B, part,
                       [&](int b, int col, float acc, bool f) {
          const int j = bk.dlo + col;
          st_act(p.x + b * d + j, bf16r(xrow[b * d + j] + dq(w, acc, f ? pr.s : __ldg(sc + col))));
        });
      }
      for (int u = bk.cid; u < units; u += bk.nclusters) {
        const int b = u / p.H, h = u % p.H;
        if (one_unit) prefetch_w(P_Q, p.q_w, l, d, h * hd + bk.rank * s.qc, s.qc);
        const size_t lb = static_cast<size_t>(l) * B + b;
        // the slice's K rows (one per channel of the head, `lines` 128-byte lines
        // each) and V rows (one line per position)
        const int lines = (s.Tc * kv_bytes + 127) / 128;
        const char* Kc = static_cast<const char*>(p.K) +
                         ((lb * d + static_cast<size_t>(h) * hd) * p.Tmp + bk.rank * s.Tc) * kv_bytes;
        const char* Vc = static_cast<const char*>(p.V) +
                         ((lb * p.Tmp + bk.rank * s.Tc) * d + static_cast<size_t>(h) * hd) * kv_bytes;
        for (int i = tid; i < hd * lines + s.Tc; i += kThreads) {
          const char* a = i < hd * lines
              ? Kc + (static_cast<size_t>(i / lines) * p.Tmp) * kv_bytes + (i % lines) * 128
              : Vc + static_cast<size_t>(i - hd * lines) * d * kv_bytes;
          asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
        }
      }
      if (!barrier(t)) return;

      // ---- 4. LN + q + attention, on a cluster per (row, head)
      load_rows(p.x, B * d, xrow);
      ln_rows<BT>(xrow, nb + 2 * d, nb + 3 * d, nullptr, nullptr, xs, red, B, d);
      for (int u = bk.cid; u < units; u += bk.nclusters) {  // the same trip count in a cluster
        if (p.kv_int8) attention_unit<WT, int8_t>(p, bk, l, u / p.H, u % p.H, mbar, par);
        else attention_unit<WT, bf16>(p, bk, l, u / p.H, u % p.H, mbar, par);
      }
      prefetch_w(P_O, p.o_w, l, d, bk.dlo, bk.ndc);
      if (!barrier(t)) return;

      // ---- 5. o_proj: x += dq(attn @ o_w) + o_b on the owned columns
      load_rows(p.attn, B * d, xs);
      {
        const WT* w = slice<WT>(bk, P_O, p.o_w, l, d, bk.dlo);
        const float* sc = p.o_s + static_cast<size_t>(l) * d + bk.dlo;
        const float* bias = p.o_b + static_cast<size_t>(l) * d + bk.dlo;
        const Pre pr = pre_load(sc, bias, bk.ndc, B);
        matvec<WT, BT>(w, s.prod[P_O] >= 0, d, bk.ndc, xs, B, part,
                       [&](int b, int col, float acc, bool f) {
          const int j = bk.dlo + col;
          const float v = bf16r(dq(w, acc, f ? pr.s : __ldg(sc + col)) +
                                bf16r(f ? pr.b : __ldg(bias + col)));
          st_act(p.x + b * d + j, bf16r(xrow[b * d + j] + v));
        });
      }
      prefetch_w(P_FF1, p.ff1_w, l, dff, bk.flo, bk.nfc);
      if (!barrier(t)) return;

      // ---- 6. ff1: h1 = GELU(dq(FiLM(LN(x)) @ ff1_w) + ff1_b) on the owned columns
      load_rows(p.x, B * d, xrow);
      ln_rows<BT>(xrow, nb + 4 * d, nb + 5 * d, p.gamma + static_cast<size_t>(l) * B * d,
                  p.beta + static_cast<size_t>(l) * B * d, xs, red, B, d);
      {
        const WT* w = slice<WT>(bk, P_FF1, p.ff1_w, l, dff, bk.flo);
        const float* sc = p.ff1_s + static_cast<size_t>(l) * dff + bk.flo;
        const float* bias = p.ff1_b + static_cast<size_t>(l) * dff + bk.flo;
        const Pre pr = pre_load(sc, bias, bk.nfc, B);
        matvec<WT, BT>(w, s.prod[P_FF1] >= 0, d, bk.nfc, xs, B, part,
                       [&](int b, int col, float acc, bool f) {
          const int j = bk.flo + col;
          st_act(p.h1 + b * dff + j, gelu_bf16(bf16r(dq(w, acc, f ? pr.s : __ldg(sc + col)) +
                                                     bf16r(f ? pr.b : __ldg(bias + col)))));
        });
      }
      prefetch_w(P_FF2, p.ff2_w, l, d, bk.dlo, bk.ndc);
      if (!barrier(t)) return;

      // ---- 7. ff2: x += dq(h1 @ ff2_w) + ff2_b on the owned columns
      load_rows(p.h1, B * dff, xs);
      {
        const WT* w = slice<WT>(bk, P_FF2, p.ff2_w, l, d, bk.dlo);
        const float* sc = p.ff2_s + static_cast<size_t>(l) * d + bk.dlo;
        const float* bias = p.ff2_b + static_cast<size_t>(l) * d + bk.dlo;
        const Pre pr = pre_load(sc, bias, bk.ndc, B);
        matvec<WT, BT>(w, s.prod[P_FF2] >= 0, dff, bk.ndc, xs, B, part,
                       [&](int b, int col, float acc, bool f) {
          const int j = bk.dlo + col;
          const float v = bf16r(dq(w, acc, f ? pr.s : __ldg(sc + col)) +
                                bf16r(f ? pr.b : __ldg(bias + col)));
          st_act(p.x + b * d + j, bf16r(xrow[b * d + j] + v));
        });
      }
      if (l + 1 < L) prefetch_w(P_IN, p.in_w, l + 1, 2 * di, 2 * c0, 2 * nch);
      else prefetch_w(P_HEAD, p.head_w, 0, p.Vpad, bk.vlo, bk.nvc);
      if (!barrier(t)) return;
    }

    // ---- vocab head on the bf16 LayerNorm row, f32 out, plus the masking bias
    load_rows(p.x, B * d, xrow);
    ln_rows<BT>(xrow, p.norm_out, p.norm_out + d, nullptr, nullptr, xs, red, B, d);
    float* logits = p.logits + static_cast<size_t>(t) * B * p.Vpad;
    {
      const bf16* w = slice<bf16>(bk, P_HEAD, p.head_w, 0, p.Vpad, bk.vlo);
      const Pre pr = pre_load(nullptr, p.head_b + bk.vlo, bk.nvc, B);
      matvec<bf16, BT>(w, s.prod[P_HEAD] >= 0, d, bk.nvc, xs, B, part,
                       [&](int b, int col, float acc, bool f) {
        const int j = bk.vlo + col;
        logits[b * p.Vpad + j] = acc + (f ? pr.b : __ldg(p.head_b + j));
      });
    }
    prefetch_w(P_IN, p.in_w, 0, 2 * di, 2 * c0, 2 * nch);
    if (!barrier(t)) return;

    // ---- the next token, unless it is forced: every block for itself
    if (p.forced == nullptr && t + 1 < p.total)
      argmax_rows(logits, p.gumbel == nullptr ? nullptr
                  : p.gumbel + static_cast<size_t>(t) * B * p.Vpad, B, p.Vpad, s_tok, red);
  }

  // ---- the owned channels' final state
  for (int i = tid; i < L * (dc - 1) * B * nch; i += kThreads) {
    const int c = i % nch, b = (i / nch) % B, k = (i / (nch * B)) % (dc - 1), l = i / (nch * B * (dc - 1));
    st_act(p.conv_state + ((static_cast<size_t>(l) * (dc - 1) + k) * B + b) * di + c0 + c,
           ring[((static_cast<size_t>(l) * (dc - 1) + k) * BT + b) * nc + c]);
  }
  for (int i = tid; i < L * B * N * nch; i += kThreads) {
    const int c = i % nch, n = (i / nch) % N, b = (i / (nch * N)) % B, l = i / (nch * N * B);
    p.ssm_state[((static_cast<size_t>(l) * B + b) * N + n) * di + c0 + c] =
        ssm[((static_cast<size_t>(l) * BT + b) * N + n) * nc + c];
  }
}

template <typename WT, int BT>
cudaError_t launch(const MKParams& p, cudaStream_t stream, int* max_grid) {
  auto kern = decode_megakernel<WT, BT>;
  const Layout lay = make_layout(p);
  if (lay.total != p.smem_bytes || p.smem_bytes > kMaxSmem - kStaticSmem || p.TS < 1 || p.TS > 8 ||
      p.grid % p.TS != 0)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       p.smem_bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.TS;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (max_grid != nullptr) {
    *max_grid = clusters * p.TS;
    return cudaSuccess;
  }
  // Co-residency: one block per SM (the shared-memory request admits one) and
  // no more clusters than fit at once, so every block of the grid is running
  // when the first grid barrier is reached; the cooperative attribute makes
  // the runtime refuse a grid it would not keep resident.
  if (clusters * p.TS < p.grid) return cudaErrorCooperativeLaunchTooLarge;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kern, p);
}

template <typename WT>
cudaError_t launch_bt(const MKParams& p, cudaStream_t s, int* max_grid) {
  if (p.B <= 1) return launch<WT, 1>(p, s, max_grid);
  if (p.B <= 2) return launch<WT, 2>(p, s, max_grid);
  if (p.B <= 4) return launch<WT, 4>(p, s, max_grid);
  return launch<WT, 8>(p, s, max_grid);
}

cudaError_t dispatch(const MKParams& p, cudaStream_t s, int* max_grid) {
  if (p.B < 1 || p.B > 8) return cudaErrorInvalidValue;
  return p.w_int8 ? launch_bt<int8_t>(p, s, max_grid) : launch_bt<bf16>(p, s, max_grid);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  The wrapper guarantees
// 1 <= B <= 8, contiguity, the alignments and divisibilities the loads need,
// zeroed sync words, a cluster size TS dividing the grid and hd, and
// smem_bytes as _smem_layout() of the Python side lays the shared memory out
// (refused otherwise).
int decode_megakernel_launch(const void* mk_params, void* stream) {
  // (a parameter of the file-local struct type would give this function internal linkage)
  const MKParams* params = static_cast<const MKParams*>(mk_params);
  cudaError_t e = dispatch(*params, static_cast<cudaStream_t>(stream), nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The largest grid of whole clusters of params->TS blocks that fits on the
// card at once with params' shared memory (written to *max_grid).
int decode_megakernel_max_grid(const void* mk_params, int* max_grid) {
  return static_cast<int>(dispatch(*static_cast<const MKParams*>(mk_params), nullptr, max_grid));
}

const char* decode_megakernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
