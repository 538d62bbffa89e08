// W8A16 weight-streaming matvec for the int8 step decode, Hopper (sm_90a).
//
// Replaces the TPU kernel mamba_tts_tpu/ops/int8_matvec.py:38 (_matvec_kernel,
// reached through int8_matvec :46 / pallas_call :67).  It computes
//
//     y[b, n] = bf16( f32acc( sum_k bf16(x[b, k]) * float(w_q[k, n]) ) * scale[n] )
//     y[b, n] = bf16( float(y[b, n]) + float(bf16(bias[n])) )      (when a bias is given)
//
// for x (B <= 16, K) bf16, w_q (K, N) int8 row-major, scale (N,) f32, bias
// (N,) f32 or bf16 and y (B, N) bf16.  int8 -> float is exact and every
// product of a bf16 and an int8 value is exact in f32, so this is the TPU
// kernel's bf16 MXU product with f32 accumulation, the per-column scale
// applied once at the end; the bias epilogue rounds as the JAX package's
// `y + bias.astype(y.dtype)` after the kernel (int8_matvec.py:84-85) does.
//
// What bounds it on an H100: weight bytes.  Each call reads K*N int8 once
// (1 MiB for in_proj 512x2048) against B*K*N*2 multiply-adds, far below the
// card's ops-per-byte balance, so the least time is K*N / 3.35 TB/s: 0.08 to
// 0.32 us.  A decode step's int8 weights (32 MiB over 8 layers) fit the 50 MB
// L2, so at decode the call waits on launch latency and one round of
// dependent loads, not on bytes.
//
// The TPU kernel keeps the whole K in one block and tiles N by 512: 1 to 4
// blocks on a 132-SM card.  The design splits K as well, inside one launch:
//   - a cluster of S thread blocks (S <= 8, the portable cluster size, so no
//     non-portable opt-in is needed) shares one strip of STRIP output columns;
//     block `rank` streams weight rows [rank*Kc, (rank+1)*Kc) of the strip.
//     The host's launch plan (ops/int8_matvec.py:launch_plan) picks STRIP in
//     {128, 64, 32} and S so that every decode shape puts about 128 blocks
//     on the card: N = 2048 -> 16 strips of 128 x 8, N = 512 -> 16 strips
//     of 32 x 8;
//   - each thread reads 4 consecutive int8 columns (one 32-bit load); the
//     STRIP/4 lanes across a strip read contiguous bytes of a weight row, and
//     the block's 256 / (STRIP/4) row groups take rows rg, rg + RG, ...; each
//     thread keeps BT x 4 f32 accumulators in registers;
//   - a thread requests its first 8 weight rows (all of them at the decode
//     shapes), and the scales and bias of the outputs it will finish, before
//     the block stages x, so these loads and x's make one round trip to L2
//     or memory, not several in a row;
//   - the block's x rows are staged in shared memory transposed to [Kc][BT],
//     so the lanes of a warp read one address (a broadcast);
//   - the row groups of a warp are summed by shuffles, the 8 warps through
//     shared memory, in a fixed order, into the block's f32 partial of each
//     output of the strip;
//   - each output has an owner block in the cluster.  A block pushes its
//     partials into slot `rank` of their owners' shared memory with 16-byte
//     `st.async` stores that complete bytes on the owner's mbarrier, so an
//     owner waits only for the data it needs, not on a barrier of the whole
//     cluster; it then sums the S partials in rank order 0 .. S-1 (reruns
//     are bit-identical, no atomics), applies the scale, rounds to bf16,
//     adds the bias and rounds again.  No block reads another's shared
//     memory, so none has to wait for the others before it exits.  The
//     only cluster barrier is the one that makes every mbarrier initialised
//     before the pushes; blocks arrive at it first thing and wait on it
//     after their loads and sums.
// So a call is one launch: no workspace in device memory, no second kernel
// for the split-K sum, no third for the bias (the design before this one
// took three launches and an (S, B, N) f32 workspace per call).  A first
// cluster version pulled the partials through distributed shared memory
// between two full cluster barriers; stamping clock64() in each block at
// L2-hot B = 1 showed those barriers at about 2,200 of a block's 5,400
// cycles; the push design took 0.4 to 0.8 us off every decode shape at
// B = 1 and 4 (at B = 16 with 128-column strips it is 2 us slower: eight
// receive slots a thread, 128 KB of shared memory a block).
// The "last block of a strip finishes" design with a ticket counter in
// device memory was the alternative; the cluster needs no counter to reset
// between replays of a captured graph, and its partials never leave the SMs.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 4;         // int8 columns per thread (one 32-bit load)
constexpr int kThreads = 256;    // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // portable cluster size
constexpr int kPre = 8;          // weight rows a thread has in flight at once

int batch_tile(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : B <= 8 ? 8 : 16; }

// Shared memory: the x stage [Kc][BT] bf16, reused for the warps' sums
// [kWarps][BT][STRIP] f32; then the slots that receive the cluster's
// partials of this block's outputs, [mine][S][kThreads] f32, where block
// `rank` owns outputs i = rank*kThreads + t + m*S*kThreads (i = b*STRIP + c).
size_t stage_bytes(int bt, int rows, int strip) {
  size_t xs = (size_t)rows * bt * sizeof(__nv_bfloat16);
  size_t red = (size_t)kWarps * bt * strip * sizeof(float);
  size_t s = xs > red ? xs : red;
  return (s + 15) / 16 * 16;
}

size_t smem_bytes(int bt, int rows, int strip, int S) {
  const size_t mine = (bt * strip + kThreads - 1) / kThreads;
  return stage_bytes(bt, rows, strip) + mine * S * kThreads * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int BT, int STRIP>
__global__ void __launch_bounds__(kThreads)
int8_matvec_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const void* __restrict__ bias, int bias_kind,
                   __nv_bfloat16* __restrict__ y, int B, int K, int N, int Kc, int stage) {
  constexpr int CG = STRIP / kCols;  // lanes across the strip
  constexpr int RG = kThreads / CG;  // row groups of the block
  constexpr int kMine = (BT * STRIP + kThreads - 1) / kThreads;  // outputs a thread finishes
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t landed;                       // this block's mbarrier
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [Kc][BT]
  float* red = reinterpret_cast<float*>(smem);                 // [kWarps][BT][STRIP]
  float* recv = reinterpret_cast<float*>(smem + stage);        // [kMine][S][kThreads]
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();  // == blockIdx.x: the cluster spans grid x
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int outs = B * STRIP;  // outputs of the strip, padding columns n >= N included
  const uint32_t landed_at = smem_u32(&landed);

  // The mbarrier completes when the other S - 1 blocks' partials of this
  // block's outputs have landed (4 bytes each).  Every block must see it
  // initialised before pushing: the arrival here, the wait before the pushes.
  if (tid == 0) {
    int owned = 0;
    for (int i = rank * kThreads; i < outs; i += S * kThreads) owned += min(kThreads, outs - i);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(landed_at));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(landed_at), "r"(4 * (S - 1) * owned) : "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  const int k0 = rank * Kc;
  const int rows = max(0, min(Kc, K - k0));
  const int cgi = tid % CG, rg = tid / CG;
  const int n0 = blockIdx.y * STRIP + cgi * kCols;
  const bool cols_in = n0 < N;  // N % 4 == 0, so the whole 4-column group is in range
  const int8_t* wp = w + (size_t)k0 * N + n0;

  // The first kPre weight rows of this thread, and the scale and bias of
  // the outputs it finishes, are requested before x is staged, so that
  // these loads and x's make one round trip, not several in a row.
  char4 q[kPre];
  auto load_rows = [&](int kb) {
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int k = kb + u * RG;
      q[u] = cols_in && k < rows ? *reinterpret_cast<const char4*>(wp + (size_t)k * N)
                                 : make_char4(0, 0, 0, 0);
    }
  };
  load_rows(rg);
  float sc[kMine], bv[kMine];
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    const int i = rank * kThreads + tid + m * S * kThreads;
    const int n = blockIdx.y * STRIP + i % STRIP;
    const bool out = i < outs && n < N;
    sc[m] = out ? scale[n] : 0.0f;
    bv[m] = !out || !bias_kind ? 0.0f
          : bias_kind == 1 ? __bfloat162float(__float2bfloat16(static_cast<const float*>(bias)[n]))
                           : __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]);
  }

  // Stage this block's x rows transposed; rows b >= B (batch padded to BT) are zero.
  for (int i = tid; i < rows * BT; i += kThreads) {
    const int b = i / rows, k = i % rows;
    xs[k * BT + b] = b < B ? x[(size_t)b * K + k0 + k] : __float2bfloat16(0.0f);
  }
  __syncthreads();

  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[b][j] = 0.0f;

  for (int kb = rg; kb < rows; kb += kPre * RG) {
    if (kb != rg) load_rows(kb);
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int k = kb + u * RG;
      if (k < rows) {
        const float wf[kCols] = {(float)q[u].x, (float)q[u].y, (float)q[u].z, (float)q[u].w};
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float xv = __bfloat162float(xs[k * BT + b]);
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[b][j] = fmaf(xv, wf[j], acc[b][j]);
        }
      }
    }
  }

  // The row groups inside a warp (32 / CG of them) are summed by shuffles,
  // the block's warps through shared memory: a fixed order either way.
#pragma unroll
  for (int off = CG; off < 32; off <<= 1)
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[b][j] += __shfl_xor_sync(0xffffffffu, acc[b][j], off);
  __syncthreads();  // x is no longer read: reuse its buffer for the warps' sums
  if (lane < CG) {
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float4 v = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      *reinterpret_cast<float4*>(&red[(warp * BT + b) * STRIP + cgi * kCols]) = v;
    }
  }
  __syncthreads();

  // Every block's mbarrier is initialised (the arrivals at the start).
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  // Push this block's partial of outputs i .. i+3 into slot `rank` of their
  // owner: a 16-byte st.async that completes 16 bytes on the owner's
  // mbarrier; the owner's own slot is a plain store.
  for (int i = 4 * tid; i < outs; i += 4 * kThreads) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < kWarps; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(&red[r * BT * STRIP + i]);
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    const int owner = (i / kThreads) % S, m = i / (kThreads * S);
    float* slot = recv + (m * S + rank) * kThreads + i % kThreads;
    if (owner == rank) {
      *reinterpret_cast<float4*>(slot) = v;
    } else {
      uint32_t to, bar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(to) : "r"(smem_u32(slot)), "r"(owner));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(bar) : "r"(landed_at), "r"(owner));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
          :: "r"(to), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
             "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar) : "memory");
    }
  }
  __syncthreads();  // this block's own slot, written by other threads of the block
  // Wait for the other blocks' pushes; a wait that never ends traps instead
  // of hanging the card.
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(landed_at) : "memory");
    if (done) break;
    if (spins > (1ll << 26)) __trap();
  }
  // Sum the S partials of each owned output in rank order, scale, round,
  // add the bias and round again.  No block needs another after its pushes,
  // so there is no barrier at the exit.
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    const int i = rank * kThreads + tid + m * S * kThreads;
    const int n = blockIdx.y * STRIP + i % STRIP;
    if (i < outs && n < N) {
      float sum = 0.0f;
      for (int s = 0; s < S; ++s) sum += recv[(m * S + s) * kThreads + tid];
      __nv_bfloat16 out = __float2bfloat16(sum * sc[m]);
      if (bias_kind) out = __float2bfloat16(__bfloat162float(out) + bv[m]);
      y[(size_t)(i / STRIP) * N + n] = out;
    }
  }
}

template <int BT, int STRIP>
cudaError_t launch(const void* x, const void* w, const void* scale, const void* bias,
                   int bias_kind, void* y, int B, int K, int N, int S, size_t smem,
                   cudaStream_t stream) {
  auto kern = int8_matvec_kernel<BT, STRIP>;
  static size_t opted_in = 48 * 1024;  // dynamic shared memory this instance may use
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const int Kc = (K + S - 1) / S;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (N + STRIP - 1) / STRIP, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const __nv_bfloat16*>(x),
                            static_cast<const int8_t*>(w), static_cast<const float*>(scale),
                            bias, bias_kind, static_cast<__nv_bfloat16*>(y), B, K, N, Kc,
                            (int)stage_bytes(BT, Kc, STRIP));
}

template <int STRIP>
cudaError_t dispatch(const void* x, const void* w, const void* scale, const void* bias,
                     int bias_kind, void* y, int B, int K, int N, int S, size_t smem,
                     cudaStream_t s) {
  switch (batch_tile(B)) {
    case 1: return launch<1, STRIP>(x, w, scale, bias, bias_kind, y, B, K, N, S, smem, s);
    case 2: return launch<2, STRIP>(x, w, scale, bias, bias_kind, y, B, K, N, S, smem, s);
    case 4: return launch<4, STRIP>(x, w, scale, bias, bias_kind, y, B, K, N, S, smem, s);
    case 8: return launch<8, STRIP>(x, w, scale, bias, bias_kind, y, B, K, N, S, smem, s);
    default: return launch<16, STRIP>(x, w, scale, bias, bias_kind, y, B, K, N, S, smem, s);
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  Pointers are device
// pointers; bias_kind is 0 (no bias: bias may be null), 1 (f32) or 2 (bf16).
// S (cluster size), strip and smem_bytes are the host's launch plan; a plan
// this source does not lay out the same way is refused with
// cudaErrorInvalidValue.  The wrapper guarantees 1 <= B <= 16, N % 4 == 0,
// contiguity and a 4-byte-aligned w.
int int8_matvec_launch(const void* x, const void* w, const void* scale, const void* bias,
                       int bias_kind, void* y, int B, int K, int N, int S, int strip,
                       long long smem_bytes_plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Kc = S > 0 ? (K + S - 1) / S : 0;
  const size_t smem = S > 0 ? smem_bytes(batch_tile(B), Kc, strip, S) : 0;
  if (S < 1 || S > kMaxCluster || B < 1 || B > 16 || bias_kind < 0 || bias_kind > 2 ||
      (long long)smem != smem_bytes_plan)
    return (int)cudaErrorInvalidValue;
  switch (strip) {
    case 32: return (int)dispatch<32>(x, w, scale, bias, bias_kind, y, B, K, N, S, smem, s);
    case 64: return (int)dispatch<64>(x, w, scale, bias, bias_kind, y, B, K, N, S, smem, s);
    case 128: return (int)dispatch<128>(x, w, scale, bias, bias_kind, y, B, K, N, S, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* int8_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
