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
// for q (B, H, Tq, 64), K and V (B, H, Tk, 64) and O in bf16, lse f32.  The
// -1e9 bias is the plain path's (attention.py:104); keys beyond Tk get -inf
// and count for nothing.  Ragged Tq and Tk are masked inside the kernels, not
// padded.  The backward takes lse and Delta = rowsum(dO * O) from a small
// first kernel, then one kernel for dK and dV (a block per 128-key tile,
// looping over 64-row query tiles) and one for dQ (a block per 128-row query
// tile, looping over 128-key tiles), each recomputing P from lse.  Every sum
// runs in a fixed order and there are no atomics, so reruns are
// bit-identical.  Rounding points are the TPU kernel's: products take bf16
// inputs and sum in f32; P is rounded to bf16 before P V, P^T and
// dS^T * scale before dV += P^T dO and dK += dS^T Q, dS * scale before
// dQ += dS K.
//
// What bounds it on an H100: operations.  The forward is 2 products of
// 2 B·H·Tq·Tk·64 operations each (4 B·H·Tq·Tk·64, 0.45 PFLOP at the flagship
// training shapes B = 8, H = 8, Tq = 5,120, Tk = 5,376) against 0.1 GB of q,
// K, V and O; the backward's bound counts 5 products (10 B·H·Tq·Tk·64), but
// the split into a dK/dV and a dQ kernel, which buys determinism without
// atomics as on the TPU, forms S and dP twice: it executes 7 (14 B·H·Tq·Tk·64).  So
// every product runs on the bf16 tensor cores (989 TFLOP/s) through wgmma,
// with f32 accumulators in registers:
//
// - A block is two consumer warpgroups, each owning 64 rows of the block's
//   128-row tile, and one producer warpgroup whose first warp feeds them;
//   setmaxnreg moves registers from the producer (40) to the consumers (232).
// - The producer loads 128- or 64-row bf16 tiles with TMA (cp.async.bulk.tensor)
//   from 3-D tensor maps (64, T, B·H), so that rows beyond T arrive as zeros
//   rather than as the next head's rows, into a ring of 3 stages with the
//   128-byte swizzle that wgmma reads; full / empty mbarriers hand stages
//   over.  It writes each key tile's bias vector beside the tile.  (TMA rather
//   than cp.async: the swizzle, the zero fill and the addresses cost the
//   consumers nothing.)
// - A consumer multiplies both operands from shared memory (K-major) for
//   S = Q K^T and dP = dO V^T, applies bias, scale and exp2 with log2 e
//   folded in to the accumulator fragment in registers (a row's maxima and
//   sums across the 4 lanes that share it), rounds P or dS to bf16 in
//   registers, where the accumulator's layout is the A operand's, and
//   multiplies them with V, dO, Q or K read as MN-major B operands.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern __shared__ __align__(16) uint8_t smem_raw[];

namespace {

constexpr int kHd = 64;                // head dim: one 128-byte row per token
constexpr int kRowBytes = kHd * 2;
constexpr int kTile = 128;             // rows of a block's tile and of a key tile
constexpr int kBwdQ = 64;              // query rows per step of the dK/dV block
constexpr int kStages = 3;             // ring depth
constexpr int kThreads = 384;          // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumers = 256;
constexpr int kTileBytes = kTile * kRowBytes;
constexpr int kBwdQBytes = kBwdQ * kRowBytes;
constexpr float kMasked = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, moved up to a 1024-byte boundary: the 128-byte
// swizzle is a function of the address bits, so TMA and wgmma agree on it
// only for tiles that start on such a boundary.
template <class T>
__device__ __forceinline__ T& smem_as() {
  const uint32_t pad = (1024u - (smem_addr(smem_raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(smem_raw + pad);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also announces `bytes` of asynchronous copies.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  A wait of
// 2^34 cycles (about 10 s) can only be a lost arrival: trap instead of
// hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

// A consumer's wait: its warps reconverge before the .aligned wgmma
// instructions that follow.
__device__ __forceinline__ void consumer_wait(uint64_t* bar, uint32_t parity) {
  bar_wait(bar, parity);
  __syncwarp();
}

// The stage of index j in a ring of kStages, and the parity of its round.
__device__ __forceinline__ int stage_of(int j) { return j % kStages; }
__device__ __forceinline__ uint32_t round_parity(int j) { return (j / kStages) & 1; }

// Rows [row, row + box) of plane `plane` of a tensor map into shared memory.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                         int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(row), "r"(plane)
      : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned) of global memory into shared.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_acquire() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// wgmma operand descriptor of a tile of 128-byte rows written by TMA with the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO).  The leading offset
// (LBO) steps between swizzle atoms along K for a K-major operand and along
// M or N for an MN-major one; neither happens here (a K-major k-step of 16
// columns, 32 bytes, and an MN-major width of 64 columns both lie within one
// 128-byte row), so it is set to the 8-row group stride as well.  A K-major
// k-step adds 32 bytes (2 in the address field), an MN-major one 16 rows
// (128).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  constexpr uint64_t group = 1024 >> 4;
  return static_cast<uint64_t>((smem_addr(tile) >> 4) & 0x3FFF) | (group << 16) | (group << 32) |
         (1ull << 62);
}
constexpr uint64_t kKStep = 32 >> 4;
constexpr uint64_t kMnStep = (16 * kRowBytes) >> 4;

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keep the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ... and from reusing an A operand's registers before the products that
// read them have completed.
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// ------------------------------------------------------------- wgmma

// d (64 x 128) = [d +] A (64 x 16) B (16 x 128): A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64) = [d +] A (64 x 16) B (16 x 64): A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64) = [d +] A (64 x 16) B (16 x 64): A in registers (four bf16 pairs a
// thread), B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d = A B^T over head_dim 64 (4 k-steps): A (64 x 64) and B (N x 64) are
// row-major tiles in shared memory, K-major for wgmma.  Issued, not waited.
__device__ __forceinline__ void issue_qk_n128(float (&d)[64], const void* a, const void* b) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_ss_n128(d, da + k * kKStep, db + k * kKStep, k);
}

__device__ __forceinline__ void issue_qk_n64(float (&d)[32], const void* a, const void* b) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_ss_n64(d, da + k * kKStep, db + k * kKStep, k);
}

// d += A B over KC k-steps of 16: A from registers (4 words per k-step),
// B (16 KC x 64) a row-major tile in shared memory, MN-major for wgmma.
template <int KC>
__device__ __forceinline__ void issue_pv(float (&d)[32], const uint32_t (&a)[4 * KC], const void* b) {
  const uint64_t db = sw128_desc(b);
#pragma unroll
  for (int k = 0; k < KC; ++k) wgmma_rs_n64(d, &a[4 * k], db + k * kMnStep, 1);
}

// Accumulator register i of a 64 x N wgmma product holds, for thread lane
// `lane` of warp w of the warpgroup, row 16 w + lane / 4 + 8 * ((i / 2) % 2)
// and column 8 (i / 4) + 2 (lane % 4) + i % 2.
__device__ __forceinline__ int frag_col(int i, int lane) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); }
__device__ __forceinline__ int frag_half(int i) { return (i >> 1) & 1; }

// The same registers rounded to bf16 pairs are the A operand of a product
// over the N columns: k-step kk takes words 4 kk .. 4 kk + 3.
template <int N>
__device__ __forceinline__ void to_bf16_operand(const float (&x)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    a[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Key bias: 0 (valid), -1e9 (masked out), -inf (beyond Tk).
__device__ __forceinline__ float key_bias(const uint8_t* mask, int b, int k, int Tk) {
  return k >= Tk ? -INFINITY : (mask == nullptr || mask[(size_t)b * Tk + k]) ? 0.f : kMasked;
}

// Rows r0 and r0 + 8 of a 64 x 64 f32 fragment, times f[0] and f[1], into a
// row-major (rows, 64) bf16 matrix; rows >= rows are skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&x)[32], int r0, int rows,
                                           const float (&f)[2], int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int i = 4 * jj + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * kHd + frag_col(i, lane)) =
          __floats2bfloat162_rn(x[i] * f[h], x[i + 1] * f[h]);
    }
  }
}

// ------------------------------------------------------------- key tiles

// Shared memory of a block that streams key tiles (forward and dQ): the
// block's own 128 rows (q, and dO for dQ) stay resident.
template <int kOwn>
struct KeyStreamSmem {
  alignas(1024) __nv_bfloat16 own[kOwn][kTile * kHd];
  alignas(1024) __nv_bfloat16 k[kStages][kTile * kHd];
  alignas(1024) __nv_bfloat16 v[kStages][kTile * kHd];
  float bias[kStages][kTile];
  uint64_t own_full, full[kStages], empty[kStages];
};
using FwdSmem = KeyStreamSmem<1>;
using DqSmem = KeyStreamSmem<2>;

__device__ __forceinline__ void init_ring(uint64_t* own_full, uint64_t* full, uint64_t* empty,
                                          uint32_t full_count) {
  if (threadIdx.x == 0) {
    bar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], full_count);
      bar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer warp of a forward or dQ block: its own rows once, then every
// key tile's K, V and bias through the ring.  All 32 lanes write the bias and
// arrive; lane 0 issues the copies.  It returns once the consumers have
// released every stage, so no copy outlives it.
template <int kOwn>
__device__ __forceinline__ void produce_key_tiles(KeyStreamSmem<kOwn>& sm, const CUtensorMap* own0,
                                                  const CUtensorMap* own1, const CUtensorMap* tm_k,
                                                  const CUtensorMap* tm_v, const uint8_t* mask,
                                                  int b, int bh, int q0, int Tk) {
  const int lane = threadIdx.x & 31;
  const int nk = (Tk + kTile - 1) / kTile;
  if (lane == 0) {
    bar_arrive_tx(&sm.own_full, kOwn * kTileBytes);
    tma_rows(sm.own[0], own0, &sm.own_full, q0, bh);
    if (kOwn == 2) tma_rows(sm.own[kOwn - 1], own1, &sm.own_full, q0, bh);
  }
  for (int j = 0; j < nk; ++j) {
    const int s = stage_of(j);
    bar_wait(&sm.empty[s], round_parity(j) ^ 1);
    for (int i = lane; i < kTile; i += 32) sm.bias[s][i] = key_bias(mask, b, j * kTile + i, Tk);
    if (lane == 0) {
      bar_arrive_tx(&sm.full[s], 2 * kTileBytes);
      tma_rows(sm.k[s], tm_k, &sm.full[s], j * kTile, bh);
      tma_rows(sm.v[s], tm_v, &sm.full[s], j * kTile, bh);
    } else {
      bar_arrive(&sm.full[s]);
    }
  }
  for (int j = nk; j < nk + kStages; ++j) bar_wait(&sm.empty[stage_of(j)], round_parity(j) ^ 1);
}

// ------------------------------------------------------------- forward

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ mask,
          __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Tq, int Tk, float scale) {
  FwdSmem& sm = smem_as<FwdSmem>();
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kTile;
  init_ring(&sm.own_full, sm.full, sm.empty, 32);
  if (threadIdx.x >= kConsumers) {
    regs_release<40>();
    if (threadIdx.x / 32 == kConsumers / 32)
      produce_key_tiles(sm, &tm_q, &tm_q, &tm_k, &tm_v, mask, b, bh, q0, Tk);
  } else {
    regs_acquire<232>();
    const int c = threadIdx.x / 128, w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int nk = (Tk + kTile - 1) / kTile;
    const __nv_bfloat16* qa = sm.own[0] + c * 64 * kHd;
    float acc[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    consumer_wait(&sm.own_full, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = stage_of(j);
      consumer_wait(&sm.full[s], round_parity(j));
      float S[64];
      reg_fence(S);
      wg_fence();
      issue_qk_n128(S, qa, sm.k[s]);
      wg_commit();
      wg_wait();
      reg_fence(S);
      // online softmax in log2 units: x = (s * scale + bias) * log2 e
      const float* bias = sm.bias[s];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        S[i] = fmaf(S[i], scale, bias[frag_col(i, lane)]) * kLog2e;
        mx[frag_half(i)] = fmaxf(mx[frag_half(i)], S[i]);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mnew = fmaxf(m[h], quad_max(mx[h]));  // finite: every tile has a key < Tk
        corr[h] = exp2f(m[h] - mnew);
        m[h] = mnew;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        S[i] = exp2f(S[i] - m[frag_half(i)]);
        sum[frag_half(i)] += S[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];  // this thread's columns only
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= corr[frag_half(i)];
      uint32_t P[32];
      to_bf16_operand(S, P);
      reg_fence(acc);
      wg_fence();
      issue_pv<8>(acc, P, sm.v[s]);
      wg_commit();
      wg_wait();
      reg_fence(acc);
      reg_fence(P);
      bar_arrive(&sm.empty[s]);
    }
    const int r0 = q0 + c * 64 + w * 16 + lane / 4;
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = quad_sum(l[h]);
      inv[h] = 1.f / l[h];
      if ((lane & 3) == 0 && r0 + 8 * h < Tq)
        lse[(size_t)bh * Tq + r0 + 8 * h] = m[h] * kLn2 + logf(l[h]);
    }
    store_rows(o + (size_t)bh * Tq * kHd, acc, r0, Tq, inv, lane);
  }
}

// ------------------------------------------------------------- backward

// lse2 = lse * log2 e and Delta = rowsum(dO * O) for every row of the
// padded (B·H, tq_pad) layout the backward kernels read; rows beyond Tq get
// 0 (their q and dO tiles arrive as zeros, so they add nothing).  One warp
// per row.
__global__ void flash_bwd_delta(const __nv_bfloat16* __restrict__ o,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse, float* __restrict__ lse2,
                                float* __restrict__ delta, int Tq, int tq_pad, long long rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long bh = row / tq_pad;
  const int i = (int)(row % tq_pad);
  if (i >= Tq) {
    if (lane == 0) lse2[row] = delta[row] = 0.f;
    return;
  }
  const size_t src = (size_t)(bh * Tq + i);
  const size_t base = src * kHd;
  float s = __bfloat162float(o[base + lane]) * __bfloat162float(dout[base + lane]) +
            __bfloat162float(o[base + lane + 32]) * __bfloat162float(dout[base + lane + 32]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    delta[row] = s;
    lse2[row] = lse[src] * kLog2e;
  }
}

struct DkdvSmem {
  alignas(1024) __nv_bfloat16 k[kTile * kHd];
  alignas(1024) __nv_bfloat16 v[kTile * kHd];
  alignas(1024) __nv_bfloat16 q[kStages][kBwdQ * kHd];
  alignas(1024) __nv_bfloat16 dout[kStages][kBwdQ * kHd];
  float lse2[kStages][kBwdQ];
  float delta[kStages][kBwdQ];
  uint64_t own_full, full[kStages], empty[kStages];
};

// dK and dV of a 128-key tile: K and V resident, 64-row query tiles of q,
// dO, lse2 and Delta through the ring.  Consumer warpgroup c owns keys
// 64 c .. 64 c + 63 and works on transposed products (keys are the rows):
// S^T = K q^T and dP^T = V dO^T, then dV += bf16(P^T) dO and
// dK += bf16(dS^T * scale) q.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
               const uint8_t* __restrict__ mask, const float* __restrict__ lse2,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk, int tq_pad, float scale) {
  DkdvSmem& sm = smem_as<DkdvSmem>();
  const int bh = blockIdx.y, b = bh / H, k0 = blockIdx.x * kTile;
  const int nq = (Tq + kBwdQ - 1) / kBwdQ;
  init_ring(&sm.own_full, sm.full, sm.empty, 1);
  if (threadIdx.x >= kConsumers) {
    regs_release<40>();
    if (threadIdx.x == kConsumers) {
      bar_arrive_tx(&sm.own_full, 2 * kTileBytes);
      tma_rows(sm.k, &tm_k, &sm.own_full, k0, bh);
      tma_rows(sm.v, &tm_v, &sm.own_full, k0, bh);
      const float* lse_bh = lse2 + (size_t)bh * tq_pad;
      const float* delta_bh = delta + (size_t)bh * tq_pad;
      for (int j = 0; j < nq; ++j) {
        const int s = stage_of(j);
        bar_wait(&sm.empty[s], round_parity(j) ^ 1);
        bar_arrive_tx(&sm.full[s], 2 * kBwdQBytes + 2 * kBwdQ * 4);
        tma_rows(sm.q[s], &tm_q, &sm.full[s], j * kBwdQ, bh);
        tma_rows(sm.dout[s], &tm_do, &sm.full[s], j * kBwdQ, bh);
        bulk_copy(sm.lse2[s], lse_bh + j * kBwdQ, kBwdQ * 4, &sm.full[s]);
        bulk_copy(sm.delta[s], delta_bh + j * kBwdQ, kBwdQ * 4, &sm.full[s]);
      }
      for (int j = nq; j < nq + kStages; ++j) bar_wait(&sm.empty[stage_of(j)], round_parity(j) ^ 1);
    }
  } else {
    regs_acquire<232>();
    const int c = threadIdx.x / 128, w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int r0 = k0 + c * 64 + w * 16 + lane / 4;  // this thread's keys: r0, r0 + 8
    const float kb[2] = {key_bias(mask, b, r0, Tk), key_bias(mask, b, r0 + 8, Tk)};
    const __nv_bfloat16* ka = sm.k + c * 64 * kHd;
    const __nv_bfloat16* va = sm.v + c * 64 * kHd;
    float dK[32], dV[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dK[i] = dV[i] = 0.f;
    consumer_wait(&sm.own_full, 0);
    for (int j = 0; j < nq; ++j) {
      const int s = stage_of(j);
      consumer_wait(&sm.full[s], round_parity(j));
      float St[32], dPt[32];
      reg_fence(St);
      reg_fence(dPt);
      wg_fence();
      issue_qk_n64(St, ka, sm.q[s]);
      issue_qk_n64(dPt, va, sm.dout[s]);
      wg_commit();
      wg_wait();
      reg_fence(St);
      reg_fence(dPt);
      const float* ls = sm.lse2[s];
      const float* dl = sm.delta[s];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = frag_col(i, lane);
        St[i] = exp2f(fmaf(St[i], scale, kb[frag_half(i)]) * kLog2e - ls[col]);  // P^T
        dPt[i] = St[i] * (dPt[i] - dl[col]) * scale;                             // dS^T * scale
      }
      uint32_t Pa[16], dSa[16];
      to_bf16_operand(St, Pa);
      to_bf16_operand(dPt, dSa);
      reg_fence(dV);
      reg_fence(dK);
      wg_fence();
      issue_pv<4>(dV, Pa, sm.dout[s]);
      issue_pv<4>(dK, dSa, sm.q[s]);
      wg_commit();
      wg_wait();
      reg_fence(dV);
      reg_fence(dK);
      reg_fence(Pa);
      reg_fence(dSa);
      bar_arrive(&sm.empty[s]);
    }
    const float one[2] = {1.f, 1.f};
    store_rows(dk + (size_t)bh * Tk * kHd, dK, r0, Tk, one, lane);
    store_rows(dv + (size_t)bh * Tk * kHd, dV, r0, Tk, one, lane);
  }
}

// dQ of a 128-row query tile: q and dO resident, key tiles through the
// ring.  S = q K^T and dP = dO V^T, then dQ += bf16(dS * scale) K.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
             const uint8_t* __restrict__ mask, const float* __restrict__ lse2,
             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int Tq, int Tk,
             int tq_pad, float scale) {
  DqSmem& sm = smem_as<DqSmem>();
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kTile;
  init_ring(&sm.own_full, sm.full, sm.empty, 32);
  if (threadIdx.x >= kConsumers) {
    regs_release<40>();
    if (threadIdx.x / 32 == kConsumers / 32)
      produce_key_tiles(sm, &tm_q, &tm_do, &tm_k, &tm_v, mask, b, bh, q0, Tk);
  } else {
    regs_acquire<232>();
    const int c = threadIdx.x / 128, w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int nk = (Tk + kTile - 1) / kTile;
    const int r0 = q0 + c * 64 + w * 16 + lane / 4;  // this thread's rows: r0, r0 + 8 (< tq_pad)
    const size_t rb = (size_t)bh * tq_pad + r0;
    const float ls[2] = {lse2[rb], lse2[rb + 8]}, dl[2] = {delta[rb], delta[rb + 8]};
    const __nv_bfloat16* qa = sm.own[0] + c * 64 * kHd;
    const __nv_bfloat16* da = sm.own[1] + c * 64 * kHd;
    float dQ[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dQ[i] = 0.f;
    consumer_wait(&sm.own_full, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = stage_of(j);
      consumer_wait(&sm.full[s], round_parity(j));
      float S[64], dP[64];
      reg_fence(S);
      reg_fence(dP);
      wg_fence();
      issue_qk_n128(S, qa, sm.k[s]);
      issue_qk_n128(dP, da, sm.v[s]);
      wg_commit();
      wg_wait();
      reg_fence(S);
      reg_fence(dP);
      const float* bias = sm.bias[s];
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int h = frag_half(i);
        const float p = exp2f(fmaf(S[i], scale, bias[frag_col(i, lane)]) * kLog2e - ls[h]);
        dP[i] = p * (dP[i] - dl[h]) * scale;  // dS * scale
      }
      uint32_t dSa[32];
      to_bf16_operand(dP, dSa);
      reg_fence(dQ);
      wg_fence();
      issue_pv<8>(dQ, dSa, sm.k[s]);
      wg_commit();
      wg_wait();
      reg_fence(dQ);
      reg_fence(dSa);
      bar_arrive(&sm.empty[s]);
    }
    const float one[2] = {1.f, 1.f};
    store_rows(dq + (size_t)bh * Tq * kHd, dQ, r0, Tq, one, lane);
  }
}

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; take it from the runtime so
// that the library links against nothing but cudart.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (planes, rows, 64) bf16 tensor as a TMA map of (box_rows, 64) boxes with
// the 128-byte swizzle; rows beyond `rows` of a plane read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int planes, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {kHd, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {kRowBytes, (cuuint64_t)rows * kRowBytes};
  const cuuint32_t box[3] = {kHd, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                        box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The wrapper's launch numbers (ops/flash_attention.py flash_launch_plan)
// must cover the rows exactly once and give the kernel its shared memory.
bool covers(int grid, int tile, int rows) { return grid >= 1 && grid * tile >= rows && (grid - 1) * tile < rows; }

template <class K>
cudaError_t opt_in(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

constexpr int smem_need(size_t bytes) { return (int)bytes + 1024; }  // + the move to a 1024-byte boundary

}  // namespace

extern "C" {

// Forward.  q (B, H, Tq, 64), k and v (B, H, Tk, 64), o (B, H, Tq, 64) bf16,
// contiguous; mask (B, Tk) bytes (true = valid) or null; lse (B, H, Tq) f32.
// grid_q query tiles of 128 rows and smem bytes a block, from the wrapper.
// The wrapper guarantees Tq, Tk >= 1 and 16-byte-aligned tensors.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                               void* lse, int B, int H, int Tq, int Tk, float scale, int grid_q,
                               int smem, void* stream) {
  if (!covers(grid_q, kTile, Tq) || smem < smem_need(sizeof(FwdSmem))) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = make_map(&mq, q, Tq, B * H, kTile)) != cudaSuccess ||
      (e = make_map(&mk, k, Tk, B * H, kTile)) != cudaSuccess ||
      (e = make_map(&mv, v, Tk, B * H, kTile)) != cudaSuccess || (e = opt_in(flash_fwd, smem)) != cudaSuccess)
    return (int)e;
  flash_fwd<<<dim3(grid_q, B * H), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Tq, Tk, scale);
  return (int)cudaGetLastError();
}

// Backward.  o, lse from the forward; dout (B, H, Tq, 64) bf16; work a
// (2, B·H, tq_pad) f32 workspace (lse * log2 e, Delta); dq, dk, dv bf16 in
// the layouts of q, k, v.  grid_q query tiles (dQ) and grid_k key tiles
// (dK/dV) of 128 rows, tq_pad and the blocks' shared memory from the
// wrapper.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* mask,
                               const void* o, const void* lse, const void* dout, void* work, void* dq,
                               void* dk, void* dv, int B, int H, int Tq, int Tk, float scale,
                               int tq_pad, int grid_q, int grid_k, int smem_dkdv, int smem_dq,
                               void* stream) {
  if (!covers(grid_q, kTile, Tq) || !covers(grid_k, kTile, Tk) || tq_pad < grid_q * kTile ||
      tq_pad % kBwdQ != 0 || smem_dkdv < smem_need(sizeof(DkdvSmem)) ||
      smem_dq < smem_need(sizeof(DqSmem)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * H * tq_pad;
  float* lse2 = static_cast<float*>(work);
  float* delta = lse2 + rows;
  flash_bwd_delta<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), lse2, delta, Tq, tq_pad, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mk, mv, mq, mdo, mq64, mdo64;
  if ((e = make_map(&mk, k, Tk, B * H, kTile)) != cudaSuccess ||
      (e = make_map(&mv, v, Tk, B * H, kTile)) != cudaSuccess ||
      (e = make_map(&mq, q, Tq, B * H, kTile)) != cudaSuccess ||
      (e = make_map(&mdo, dout, Tq, B * H, kTile)) != cudaSuccess ||
      (e = make_map(&mq64, q, Tq, B * H, kBwdQ)) != cudaSuccess ||
      (e = make_map(&mdo64, dout, Tq, B * H, kBwdQ)) != cudaSuccess ||
      (e = opt_in(flash_bwd_dkdv, smem_dkdv)) != cudaSuccess || (e = opt_in(flash_bwd_dq, smem_dq)) != cudaSuccess)
    return (int)e;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  flash_bwd_dkdv<<<dim3(grid_k, B * H), kThreads, smem_dkdv, s>>>(
      mk, mv, mq64, mdo64, m, lse2, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      H, Tq, Tk, tq_pad, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<<<dim3(grid_q, B * H), kThreads, smem_dq, s>>>(
      mq, mdo, mk, mv, m, lse2, delta, static_cast<__nv_bfloat16*>(dq), H, Tq, Tk, tq_pad, scale);
  return (int)cudaGetLastError();
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
