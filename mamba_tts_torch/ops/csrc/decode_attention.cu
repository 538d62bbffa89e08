// One-query cross-attention of the decode step, Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this attention with
// einsums in XLA (mamba_tts_tpu/models/attention.py `_naive`, bf16 K/V with
// preferred_element_type=float32).  It was added because the port's plain
// version (ops/flash_attention.py flash_attention_ref) casts K to f32, lays
// the transposed copy out again for a batched product and copies V to a
// contiguous layout on every decode step of every layer, which took about
// half of the captured default decode's device time at B = 8.  It computes
//
//     out[b, h*64 + c] = bf16( sum_t bf16(p[b, h, t]) * V[b, h, t, c] )     (f32 sum)
//     p[b, h, t]       = exp(s_t - max_t s) / sum_t exp(s_t - max_t s)      (f32)
//     s_t              = f32(q[b, h*64 + :] . K[b, h, t, :]) * scale  (+ -1e9 where key t is masked)
//
// for q (B, H*64) bf16, K and V the (B, H, Tm, 64) bf16 views that
// CrossAttention._split makes of (B, Tm, H*64) tensors (element (b, h, t, c)
// at (b*Tm + t)*H*64 + h*64 + c: every row is 128 contiguous bytes), a bool
// mask (B, Tm) (true = valid) or none, and out (B, H*64) bf16, the layout
// o_proj reads.  The rounding points are the plain version's, in its order:
// the dot in f32, times the scale, then the mask's -1e9 added (two IEEE
// operations, no fused multiply-add); expf and IEEE division, no fast-math;
// each probability rounded to bf16 before P V; P V summed in f32 and rounded
// to bf16 once.  Only the summation orders differ.
//
// What bounds it on an H100: bytes.  Every K and V byte is read once, in
// bf16, straight from the projected memory (2 * B*H*Tm*128 bytes: 25.2 MB at
// B = 8, H = 8, Tm = 1,536, 7.5 us at 3.35 TB/s) against 4 flops a byte.
// The design:
//   - one thread-block cluster of S <= 8 blocks (the portable size) per
//     (row, head) unit; block `rank` owns keys [rank*Tc, (rank+1)*Tc) of the
//     memory.  At B = 8 there are only 64 units, so the slices are what puts
//     enough bytes in flight to fill the card.  A slice is read in tiles of
//     Tt keys; the host's plan (ops/decode_attention.py launch_plan) picks
//     S, Tc and Tt, and the launcher refuses a plan it would lay out
//     otherwise.  Any memory length has a plan;
//   - a block starts the copies of its first K tile and its first V tile
//     into shared memory first thing (16-byte cp.async, 8 lanes across each
//     128-byte row, two commit groups), so that all of their bytes are in
//     flight at once; it scores keys as soon as K has landed, and V lands
//     under the softmax.  Where the slice is one tile (every memory up to
//     8 * 864 keys, the narration's included) that is all of its bytes;
//     a longer slice loads its next K tiles after scoring the last, and its
//     next V tiles after their P V;
//   - the scores of a one-tile slice stay in shared memory; those of a
//     longer slice go to a workspace in device memory (4 bytes a key, from
//     the wrapper), so that every rounding point stays the plain version's:
//     the max and the sum are taken over the final scores, never rescaled;
//   - scores: 8 lanes a key, 8 channels a lane, summed by shuffles;
//   - the slice maxima, then the slice sums, are pushed to every rank of the
//     cluster with st.async stores that complete their bytes on the
//     receiver's mbarrier (no block waits on a cluster barrier after the
//     first one, which only makes the mbarriers initialised); every rank
//     takes the global max, then the sum in rank order, and rounds its
//     probabilities with them;
//   - P V of the slice: 8 lanes across a row, 4 rows a warp, the warps'
//     partials summed in warp order; channel c's partial goes to slot [rank]
//     of rank c % S, which adds the S partials in rank order, rounds and
//     writes its channels of the output row.
// No float atomics, one launch a call: the call is capturable in a CUDA
// graph and a rerun is bit-identical.
//
// decode_attention_grouped_kernel<HD> is the jamba block's causal
// self-attention at one query (models/attention.py SelfAttention.step):
// head_dim HD (128), G query heads on each K/V head (multi-query at
// G = H), over a static K/V cache whose valid keys the mask gives.  The
// rounding points are the ones above.  One cluster of S blocks serves one
// (row, K/V head, group of Gb query heads) unit: the G heads of a K/V head
// split into HG = G / Gb groups so that the grid fills the card (at B = 16
// and G = 20, groups of 4), and a K/V tile is read for Gb heads at once,
// not once a head (the HG groups' reads of one tile mostly hit the L2);
// a block's shared memory stays under half an SM's, so two blocks share
// an SM:
//   - q's Gb heads go to shared memory as f32; scores: 16-byte chunks of a
//     K row on HD/8 lanes, each chunk unpacked once and dotted with 4
//     heads' q at a time, summed by independent shuffles; the scores
//     [Gb][slice] stay in shared memory (a slice too long for them has no
//     plan), K and V come in tiles;
//   - the softmax runs a warp a head: the slice maxima, then the sums, of
//     every head go to every rank by st.async into the mbarriers;
//   - P V: a thread owns (key group, head, 8 channels) accumulators in
//     shared memory (4 key groups, summed in order at the end), so a V tile
//     is read once for every head; channel c of each head is owned by rank
//     c % S, which sums the S partials in rank order.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHeadDim = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;       // portable cluster size
constexpr int kKeyAlign = 16;        // a slice's and a tile's length are multiples of this
constexpr int kChunks = kHeadDim * 2 / 16;  // 16-byte chunks of a 128-byte row
constexpr int kMaxSmem = 232448;     // shared memory one H100 block may use
constexpr float kMasked = -1e9f;     // the plain version's bias on masked keys
constexpr long long kSpinLimit = 6000000000LL;  // clock cycles (a few seconds) a wait may take
enum { X_MAX, X_SUM, X_OUT, X_COUNT };

// Shared memory: K tile [Tt][64] bf16, V tile [Tt][64] bf16, scores [Tt]
// f32 (a one-tile slice's), then the warps' reductions [kWarps], the
// received maxima and sums [kMaxCluster] each, the warps' P V partials
// [kWarps][64], the received partials [kMaxCluster][64] (f32), and X_COUNT
// mbarriers in 32 bytes.
size_t smem_bytes(int Tt) {
  return (size_t)Tt * (4 * kHeadDim + 4) + 4 * (kWarps + 2 * kMaxCluster) +
         4 * kHeadDim * (kWarps + kMaxCluster) + 32;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 8 bf16 values of one 16-byte chunk, as f32
__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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

// Every thread: wait for the first phase of bar (all its bytes landed).  A
// wait that never ends traps instead of hanging the card.
__device__ __forceinline__ void wait_landed(uint64_t* bar) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_u32(bar)) : "memory");
    if (done) break;
    if (clock64() - t0 > kSpinLimit) __trap();
  }
}

// Block-wide max and sum (warps by shuffles, then the warps in order); every
// thread gets the result.  `red` is reused: the trailing __syncthreads keeps
// the next call from overwriting it while it is read.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.0f;
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Keys [j*Tt, j*Tt + m) of the slice starting at element `row0` of `src`
// into `dst`, 16-byte chunks, as one commit group.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t row0, int ld, int j,
                                          int Tt, int m) {
  const size_t first = row0 + (size_t)j * Tt * ld;
  for (int i = threadIdx.x; i < m * kChunks; i += kThreads)
    cp_async16(dst + i * 8, src + first + (size_t)(i / kChunks) * ld + (i % kChunks) * 8);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Grid (S, H, B), cluster (S, 1, 1): blockIdx.x is the block's rank.  `ws`
// holds the scores of every slice longer than one tile, Tc floats a slice;
// null where a slice is one tile (Tc == Tt).
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ K,
                        const bf16* __restrict__ V, const uint8_t* __restrict__ mask,
                        bf16* __restrict__ out, float* __restrict__ ws, int H, int Tm, int Tc,
                        int Tt, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = H * kHeadDim;  // elements between consecutive keys of one head
  const int t0 = rank * Tc;
  const int n = max(0, min(Tc, Tm - t0));  // keys of this slice
  const int tiles = (n + Tt - 1) / Tt;

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)Tt * kHeadDim;
  float* sc_tile = reinterpret_cast<float*>(vs + (size_t)Tt * kHeadDim);
  float* red = sc_tile + Tt;
  float* smax = red + kWarps;
  float* ssum = smax + kMaxCluster;
  float* wpart = ssum + kMaxCluster;
  float* orecv = wpart + kWarps * kHeadDim;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(orecv + kMaxCluster * kHeadDim);
  // the slice's scores, in shared memory or in the workspace
  float* sc = ws != nullptr ? ws + ((size_t)(b * H + h) * S + rank) * Tc : sc_tile;

  // The first K tile, then the first V tile: every byte of a one-tile slice
  // in flight now.
  const size_t row0 = ((size_t)b * Tm + t0) * ld + (size_t)h * kHeadDim;
  load_tile(ks, K, row0, ld, 0, Tt, min(Tt, n));
  load_tile(vs, V, row0, ld, 0, Tt, min(Tt, n));

  // The mbarrier of each exchange completes when the other S - 1 ranks'
  // values have landed: a max and a sum each, and a partial of each channel
  // this rank owns (c % S == rank).  Every block must see them initialised
  // before pushing: the arrival here, the wait before the first push.
  if (tid == 0) {
    const int owned = (kHeadDim - rank + S - 1) / S;
    const int bytes[X_COUNT] = {4 * (S - 1), 4 * (S - 1), 4 * (S - 1) * owned};
    for (int x = 0; x < X_COUNT; ++x)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(mbar + x)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int x = 0; x < X_COUNT; ++x)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_u32(mbar + x)), "r"(bytes[x]) : "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // The additive bias of each key (0, or -1e9 where masked) waits in the
  // score slots; q's 8 channels of this lane, as f32.
  for (int i = tid; i < n; i += kThreads)
    sc[i] = mask != nullptr && !mask[(size_t)b * Tm + t0 + i] ? kMasked : 0.0f;
  const int js = lane % kChunks;  // this lane's channels: js*8 .. js*8 + 7
  float qv[8];
  unpack8(__ldg(reinterpret_cast<const uint4*>(q + (size_t)b * ld + h * kHeadDim + js * 8)), qv);

  // Scores, tile by tile: 8 lanes a key (a 128-byte row), 32 keys a pass.
  // The pass count is the same for every thread, so the shuffles see whole
  // warps.
  float mx = -3.0e38f;
  for (int j = 0; j < tiles; ++j) {
    const int base = j * Tt, m = min(Tt, n - base);
    if (j == 0) {
      asm volatile("cp.async.wait_group 1;" ::: "memory");  // this thread's K chunks
    } else {
      __syncthreads();  // every thread is done with the last K tile
      load_tile(ks, K, row0, ld, j, Tt, m);
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // everyone's chunks, and the biases
    for (int p = 0; p < m; p += kThreads / kChunks) {
      const int t = p + tid / kChunks;
      float a = 0.0f;
      if (t < m) {
        float kv[8];
        unpack8(*reinterpret_cast<const uint4*>(ks + t * kHeadDim + js * 8), kv);
#pragma unroll
        for (int i = 0; i < 8; ++i) a = fmaf(qv[i], kv[i], a);
      }
      for (int off = 1; off < kChunks; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (t < m && js == 0) {
        const float s = __fadd_rn(__fmul_rn(a, scale), sc[base + t]);
        sc[base + t] = s;
        mx = fmaxf(mx, s);
      }
    }
  }
  mx = block_max(mx, red);  // (its first __syncthreads publishes the scores)

  // Every block's mbarriers are initialised (the arrivals at the start).
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (tid < S) push(smax + rank, tid, rank, mbar + X_MAX, mx);
  __syncthreads();
  wait_landed(mbar + X_MAX);
  float gmax = smax[0];
  for (int r = 1; r < S; ++r) gmax = fmaxf(gmax, smax[r]);

  float sum = 0.0f;
  for (int t = tid; t < n; t += kThreads) {
    const float e = expf(sc[t] - gmax);
    sc[t] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  if (tid < S) push(ssum + rank, tid, rank, mbar + X_SUM, sum);
  __syncthreads();
  wait_landed(mbar + X_SUM);
  float gsum = 0.0f;
  for (int r = 0; r < S; ++r) gsum += ssum[r];  // rank order
  for (int t = tid; t < n; t += kThreads) sc[t] = __bfloat162float(__float2bfloat16(__fdiv_rn(sc[t], gsum)));

  // P V of the slice, tile by tile: lane = (row of the warp's 4, 8
  // channels); the 4 rows by shuffles, the warps in order.
  const int cgp = lane % kChunks, kg = lane / kChunks;
  float o[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < tiles; ++j) {
    const int base = j * Tt, m = min(Tt, n - base);
    if (j > 0) {
      __syncthreads();  // every thread is done with the last V tile
      load_tile(vs, V, row0, ld, j, Tt, m);
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");  // this thread's V chunks
    __syncthreads();  // everyone's, and the probabilities
    for (int t = warp * (32 / kChunks) + kg; t < m; t += kThreads / kChunks) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(vs + t * kHeadDim + cgp * 8), v);
      const float p = sc[base + t];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = fmaf(p, v[i], o[i]);
    }
  }
  for (int off = kChunks; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] += __shfl_xor_sync(0xffffffffu, o[i], off);
  if (kg == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i) wpart[warp * kHeadDim + cgp * 8 + i] = o[i];
  __syncthreads();
  if (tid < kHeadDim) {
    float part = 0.0f;
    for (int w = 0; w < kWarps; ++w) part += wpart[w * kHeadDim + tid];
    push(orecv + rank * kHeadDim + tid, tid % S, rank, mbar + X_OUT, part);
  }
  __syncthreads();  // this block's own slots, written by other threads of the block
  wait_landed(mbar + X_OUT);
  // this rank's channels: the cluster's partials in rank order, bf16.  No
  // block needs another after its pushes, so there is no barrier at the exit.
  if (tid < kHeadDim && tid % S == rank) {
    float acc = 0.0f;
    for (int r = 0; r < S; ++r) acc += orecv[r * kHeadDim + tid];
    out[(size_t)b * ld + h * kHeadDim + tid] = __float2bfloat16(acc);
  }
}

// ---------------------------------------------------------------- grouped

constexpr int kKeyGroups = 4;  // P V accumulators a (head, channel): keys t % 4
constexpr int kHeadStep = 4;   // heads scored together, for independent shuffles

// Shared memory of the grouped kernel, for Gb heads a block: K and V tiles
// [Tt][HD] bf16, the slice's scores [Gb][Tc] f32, q [Gb][HD] f32, the
// received maxima and sums [Gb][kMaxCluster] each, the P V accumulators
// [kKeyGroups][Gb][HD], the received partials [Gb][kMaxCluster][own] (own
// = ceil(HD / S) channels a head a rank), then X_COUNT mbarriers at an
// 8-byte boundary in 32 bytes.
size_t grouped_smem_bytes(int HD, int Gb, int S, int Tc, int Tt) {
  const size_t own = (HD + S - 1) / S;
  const size_t floats = (size_t)Gb * Tc + (size_t)Gb * HD + 2 * (size_t)Gb * kMaxCluster +
                        (size_t)kKeyGroups * Gb * HD + (size_t)Gb * kMaxCluster * own;
  return (size_t)Tt * HD * 4 + ((floats * 4 + 7) / 8) * 8 + 32;
}

template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t row0, int ld, int j,
                                          int Tt, int m) {
  constexpr int CH = HD * 2 / 16;
  const size_t first = row0 + (size_t)j * Tt * ld;
  for (int i = threadIdx.x; i < m * CH; i += kThreads)
    cp_async16(dst + i * 8, src + first + (size_t)(i / CH) * ld + (i % CH) * 8);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Grid (S, Hkv * HG, B), cluster (S, 1, 1).  blockIdx.y = kvh * HG + hg:
// the block serves query heads kvh*G + hg*Gb .. + Gb - 1 (G = HG * Gb
// heads share K/V head kvh).  q (B, Hkv*G*HD); K, V: element (b, kvh, t,
// c) at (b*Tm + t)*Hkv*HD + kvh*HD + c.  The slice's scores stay in shared
// memory; K and V come in tiles of Tt keys.
template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_grouped_kernel(const bf16* __restrict__ q, const bf16* __restrict__ K,
                                const bf16* __restrict__ V, const uint8_t* __restrict__ mask,
                                bf16* __restrict__ out, int Hkv, int HG, int Gb, int Tm, int Tc,
                                int Tt, float scale) {
  constexpr int CH = HD * 2 / 16;      // 16-byte chunks of a row
  constexpr int KPP = kThreads / CH;   // keys a pass of the scores
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kvh = blockIdx.y / HG, hg = blockIdx.y % HG, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = Hkv * HD;
  const size_t head0 = ((size_t)b * Hkv * HG + blockIdx.y) * Gb * HD;  // this block's q, out
  const int t0 = rank * Tc;
  const int n = max(0, min(Tc, Tm - t0));
  const int tiles = (n + Tt - 1) / Tt;
  const int own = (HD + S - 1) / S;

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)Tt * HD;
  float* sc = reinterpret_cast<float*>(vs + (size_t)Tt * HD);
  float* qs = sc + (size_t)Gb * Tc;
  float* smax = qs + (size_t)Gb * HD;
  float* ssum = smax + (size_t)Gb * kMaxCluster;
  float* acc = ssum + (size_t)Gb * kMaxCluster;
  float* orecv = acc + (size_t)kKeyGroups * Gb * HD;
  const size_t used = (size_t)(orecv + (size_t)Gb * kMaxCluster * own - sc) * 4;
  uint64_t* mbar =
      reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(sc) + (used + 7) / 8 * 8);

  const size_t row0 = ((size_t)b * Tm + t0) * ld + (size_t)kvh * HD;
  load_rows<HD>(ks, K, row0, ld, 0, Tt, min(Tt, n));
  load_rows<HD>(vs, V, row0, ld, 0, Tt, min(Tt, n));

  if (tid == 0) {
    const int owned = (HD - rank + S - 1) / S;
    const int bytes[X_COUNT] = {4 * (S - 1) * Gb, 4 * (S - 1) * Gb, 4 * (S - 1) * Gb * owned};
    for (int x = 0; x < X_COUNT; ++x)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(mbar + x)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int x = 0; x < X_COUNT; ++x)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_u32(mbar + x)), "r"(bytes[x]) : "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  for (int i = tid; i < Gb * HD; i += kThreads) qs[i] = __bfloat162float(q[head0 + i]);
  for (int i = tid; i < kKeyGroups * Gb * HD; i += kThreads) acc[i] = 0.0f;

  // Scores, tile by tile: CH lanes a key, KPP keys a pass; each K chunk is
  // unpacked once and dotted with kHeadStep heads' q at a time, whose sums
  // by shuffles are independent.  Trip counts are the same for every
  // thread, so the shuffles see whole warps.
  const int js = lane % CH, kl = tid / CH;
  for (int j = 0; j < tiles; ++j) {
    const int base = j * Tt, m = min(Tt, n - base);
    if (j == 0) {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      __syncthreads();
      load_rows<HD>(ks, K, row0, ld, j, Tt, m);
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // everyone's K chunks, and q
    for (int p = 0; p < m; p += KPP) {
      const int t = p + kl;
      float kv[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float bias = 0.0f;
      if (t < m) {
        unpack8(*reinterpret_cast<const uint4*>(ks + t * HD + js * 8), kv);
        if (mask != nullptr && !mask[(size_t)b * Tm + t0 + base + t]) bias = kMasked;
      }
      for (int g0 = 0; g0 < Gb; g0 += kHeadStep) {
        float a[kHeadStep];
#pragma unroll
        for (int u = 0; u < kHeadStep; ++u) {
          a[u] = 0.0f;
          if (g0 + u < Gb) {
            const float* qg = qs + (g0 + u) * HD + js * 8;
            const float4 q0 = *reinterpret_cast<const float4*>(qg);
            const float4 q1 = *reinterpret_cast<const float4*>(qg + 4);
            a[u] = fmaf(q0.x, kv[0], a[u]);
            a[u] = fmaf(q0.y, kv[1], a[u]);
            a[u] = fmaf(q0.z, kv[2], a[u]);
            a[u] = fmaf(q0.w, kv[3], a[u]);
            a[u] = fmaf(q1.x, kv[4], a[u]);
            a[u] = fmaf(q1.y, kv[5], a[u]);
            a[u] = fmaf(q1.z, kv[6], a[u]);
            a[u] = fmaf(q1.w, kv[7], a[u]);
          }
        }
#pragma unroll
        for (int off = 1; off < CH; off <<= 1)
#pragma unroll
          for (int u = 0; u < kHeadStep; ++u) a[u] += __shfl_xor_sync(0xffffffffu, a[u], off);
        if (t < m && js == 0)
#pragma unroll
          for (int u = 0; u < kHeadStep; ++u)
            if (g0 + u < Gb)
              sc[(size_t)(g0 + u) * Tc + base + t] = __fadd_rn(__fmul_rn(a[u], scale), bias);
      }
    }
  }
  __syncthreads();  // the scores

  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  // the softmax, a warp a head: slice max, then (after every rank's) the
  // exps and the slice sum, then the probabilities
  for (int g = warp; g < Gb; g += kWarps) {
    float mx = -3.0e38f;
#pragma unroll 4
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sc[(size_t)g * Tc + t]);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane < S) push(smax + g * kMaxCluster + rank, lane, rank, mbar + X_MAX, mx);
  }
  __syncthreads();
  wait_landed(mbar + X_MAX);
  for (int g = warp; g < Gb; g += kWarps) {
    float gmax = smax[g * kMaxCluster];
    for (int r = 1; r < S; ++r) gmax = fmaxf(gmax, smax[g * kMaxCluster + r]);
    float sum = 0.0f;
#pragma unroll 4
    for (int t = lane; t < n; t += 32) {
      const float e = expf(sc[(size_t)g * Tc + t] - gmax);
      sc[(size_t)g * Tc + t] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane < S) push(ssum + g * kMaxCluster + rank, lane, rank, mbar + X_SUM, sum);
  }
  __syncthreads();
  wait_landed(mbar + X_SUM);
  for (int g = warp; g < Gb; g += kWarps) {
    float gsum = 0.0f;
    for (int r = 0; r < S; ++r) gsum += ssum[g * kMaxCluster + r];  // rank order
#pragma unroll 4
    for (int t = lane; t < n; t += 32)
      sc[(size_t)g * Tc + t] =
          __bfloat162float(__float2bfloat16(__fdiv_rn(sc[(size_t)g * Tc + t], gsum)));
  }

  // P V, tile by tile: item i = (key group, head, 8 channels), its
  // accumulators in shared memory, keys t = group, group + 4, ...
  const int items = kKeyGroups * Gb * CH;
  for (int j = 0; j < tiles; ++j) {
    const int base = j * Tt, m = min(Tt, n - base);
    if (j > 0) {
      __syncthreads();  // every thread is done with the last V tile
      load_rows<HD>(vs, V, row0, ld, j, Tt, m);
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // everyone's V chunks, and the probabilities
    for (int i = tid; i < items; i += kThreads) {
      const int kg = i / (Gb * CH), g = (i / CH) % Gb, c8 = i % CH;
      float* o = acc + ((size_t)kg * Gb + g) * HD + c8 * 8;
      float r[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) r[x] = o[x];
      const float* pr = sc + (size_t)g * Tc + base;
#pragma unroll 4
      for (int t = kg; t < m; t += kKeyGroups) {
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(vs + t * HD + c8 * 8), v);
        const float pt = pr[t];
#pragma unroll
        for (int x = 0; x < 8; ++x) r[x] = fmaf(pt, v[x], r[x]);
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) o[x] = r[x];
    }
  }
  __syncthreads();  // the accumulators
  for (int i = tid; i < Gb * HD; i += kThreads) {
    const int g = i / HD, c = i % HD;
    float part = 0.0f;
    for (int kg = 0; kg < kKeyGroups; ++kg) part += acc[((size_t)kg * Gb + g) * HD + c];
    push(orecv + ((size_t)g * kMaxCluster + rank) * own + c / S, c % S, rank, mbar + X_OUT, part);
  }
  __syncthreads();  // this block's own slots
  wait_landed(mbar + X_OUT);
  for (int i = tid; i < Gb * HD; i += kThreads) {
    const int g = i / HD, c = i % HD;
    if (c % S != rank) continue;
    float a = 0.0f;
    for (int r = 0; r < S; ++r) a += orecv[((size_t)g * kMaxCluster + r) * own + c / S];
    out[head0 + (size_t)g * HD + c] = __float2bfloat16(a);
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  Pointers are device
// pointers; mask may be null (every key valid).  S (cluster size), Tc (keys a
// block), Tt (keys a tile) and smem_bytes are the host's launch plan; ws is
// the scores' workspace, B*H*S*Tc floats, given exactly where Tt < Tc.  A
// plan this source does not lay out the same way (slices that miss a key,
// an empty last slice, a tile longer than its slice, a workspace where none
// is used or none where one is) is refused with cudaErrorInvalidValue.  The
// wrapper guarantees the layouts, bf16, and 16-byte-aligned q, K, V.
int decode_attention_launch(const void* q, const void* K, const void* V, const void* mask,
                            void* out, void* ws, int B, int H, int Tm, int S, int Tc, int Tt,
                            long long smem_bytes_plan, float scale, void* stream) {
  const size_t smem = Tt > 0 ? smem_bytes(Tt) : 0;
  if (B < 1 || H < 1 || H > 65535 || B > 65535 || Tm < 1 || S < 1 || S > kMaxCluster ||
      Tt < kKeyAlign || Tt % kKeyAlign || Tc % kKeyAlign || Tt > Tc ||
      (long long)S * Tc < Tm || (long long)(S - 1) * Tc >= Tm || (ws != nullptr) != (Tt < Tc) ||
      smem > (size_t)kMaxSmem || (long long)smem != smem_bytes_plan)
    return (int)cudaErrorInvalidValue;
  // dynamic shared memory beyond 48 KB, asked for on every call: the
  // attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, H, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_attention_kernel, static_cast<const bf16*>(q),
                                 static_cast<const bf16*>(K), static_cast<const bf16*>(V),
                                 static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
                                 static_cast<float*>(ws), H, Tm, Tc, Tt, scale);
}

// The grouped kernel: q (B, Hkv*HG*Gb*HD), K and V the (B, Hkv, Tm, HD)
// views of (B, Tm, Hkv, HD) caches, HD 128, HG blocks of Gb query
// heads on each K/V head; the plan's rules as above.
int decode_attention_grouped_launch(const void* q, const void* K, const void* V,
                                    const void* mask, void* out, int B, int Hkv, int HG, int Gb,
                                    int HD, int Tm, int S, int Tc, int Tt,
                                    long long smem_bytes_plan, float scale, void* stream) {
  const size_t smem = Tt > 0 && Gb > 0 && S > 0 ? grouped_smem_bytes(HD, Gb, S, Tc, Tt) : 0;
  if (B < 1 || Hkv < 1 || HG < 1 || (long long)Hkv * HG > 65535 || B > 65535 || Gb < 1 ||
      HD != 128 || Tm < 1 || S < 1 || S > kMaxCluster || Tt < kKeyAlign ||
      Tt % kKeyAlign || Tc % kKeyAlign || Tt > Tc || (long long)S * Tc < Tm ||
      (long long)(S - 1) * Tc >= Tm || smem > (size_t)kMaxSmem ||
      (long long)smem != smem_bytes_plan)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const bf16*, const bf16*, const bf16*, const uint8_t*, bf16*, int, int, int,
                 int, int, int, float) = decode_attention_grouped_kernel<128>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, Hkv * HG, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q),
                                 static_cast<const bf16*>(K), static_cast<const bf16*>(V),
                                 static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), Hkv,
                                 HG, Gb, Tm, Tc, Tt, scale);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
