// Two probes of the card for the decode megakernel
// (../ops/csrc/decode_megakernel.cu), run by card_probes.py beside this file.
//
// barrier_bench: what one grid barrier costs on its own.  Every block of a
// cooperative grid of clusters of 8, one block of 8 warps per SM, runs `iters`
// grid barriers back to back, all arriving together, and block 0 writes the
// cycles they took.
//   mode 0: the first version's barrier: a full fence, a relaxed atomic, a
//           volatile spin and a second fence;
//   mode 1: the served kernel's: one release reduction per block after its
//           __syncthreads, an acquire poll;
//   mode 2: two-level: a cluster barrier, one release reduction per cluster
//           from its rank 0, an acquire poll, a second cluster barrier.
// Modes 0 and 2 are not in the served kernel; this file keeps them so that
// the choice can be measured again.  A barrier's wait in the served kernel
// (its stage_clocks operand) less this cost is the imbalance between blocks.
//
// l2_read: the rate at which the SMs read a buffer that sits in the L2, the
// rate at which the megakernel's streamed weight slices and K/V can come back
// each step.  Every thread reads 16-byte words with ld.global.cg (cached in
// L2 only) over the whole buffer, `reps` times.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                   // 8 warps, as the served kernel
constexpr int kOneBlockSmem = 120 * 1024;       // one block per SM, as the served kernel
constexpr long long kSpinLimit = 6000000000LL;  // clock cycles a barrier may wait

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

// Thread 0 arrives with `arrivals` and polls until the counter reaches
// `target`; a wait beyond kSpinLimit sets the error word sync[1].
__device__ __forceinline__ int arrive_and_wait(unsigned long long* sync, unsigned long long target) {
  red_release_add(sync, 1ULL);
  const long long t0 = clock64();
  unsigned spins = 0;
  while (ld_acquire(sync) < target) {
    if ((++spins & 63u) == 0u) {
      if (ld_relaxed(sync + 1) != 0ULL) return 0;
      if (clock64() - t0 > kSpinLimit) {
        atomicExch(&sync[1], 1ULL);
        return 0;
      }
    }
  }
  return 1;
}

// mode 1, as in the served kernel
__device__ __forceinline__ void grid_barrier(unsigned long long* sync, unsigned long long& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) arrive_and_wait(sync, target);
  __syncthreads();
}

// mode 0
__device__ __forceinline__ void grid_barrier_fenced(unsigned long long* sync,
                                                    unsigned long long& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(&sync[0], 1ULL);
    volatile unsigned long long* vs = sync;
    const long long t0 = clock64();
    while (vs[0] < target)
      if (clock64() - t0 > kSpinLimit) { atomicExch(&sync[1], 1ULL); break; }
    __threadfence();
  }
  __syncthreads();
}

// mode 2
__device__ __forceinline__ void grid_barrier_cluster(unsigned long long* sync,
                                                     unsigned long long& target) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  target += gridDim.x / cluster.num_blocks();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) arrive_and_wait(sync, target);
  cluster.sync();
}

__global__ void __launch_bounds__(kThreads, 1) barrier_bench(int mode, int iters,
                                                             unsigned long long* sync,
                                                             long long* cycles) {
  unsigned long long target = 0, target_clusters = 0;
  grid_barrier(sync, target);  // all blocks started
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (mode == 0) grid_barrier_fenced(sync, target);
    else if (mode == 1) grid_barrier(sync, target);
    else grid_barrier_cluster(sync + 2, target_clusters);  // its own counter and error word
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    cycles[0] = clock64() - t0;
    cycles[1] = gridDim.x;
  }
}

__global__ void __launch_bounds__(256) l2_read(const uint4* __restrict__ buf, long long n16,
                                               int reps, unsigned* out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned acc = 0;
  for (int r = 0; r < reps; ++r) {
    long long i = first;
    for (; i + 3 * stride < n16; i += 4 * stride) {
      const uint4 a = __ldcg(buf + i), b = __ldcg(buf + i + stride);
      const uint4 c = __ldcg(buf + i + 2 * stride), d = __ldcg(buf + i + 3 * stride);
      acc ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w ^ c.x ^ c.y ^ c.z ^ c.w ^ d.x ^ d.y ^
             d.z ^ d.w;
    }
    for (; i < n16; i += stride) {
      const uint4 a = __ldcg(buf + i);
      acc ^= a.x ^ a.y ^ a.z ^ a.w;
    }
  }
  if (acc == 0x9e3779b9u) out[0] = acc;  // keeps the loads; the buffer never gives this value
}

}  // namespace

extern "C" {

// buf: `bytes` (a multiple of 16) of device memory; out: one word.  Launches
// 8 blocks of 256 threads per SM.  Returns a cudaError_t.
int l2_read_launch(const void* buf, long long bytes, int reps, void* out, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  l2_read<<<8 * sms, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), bytes / 16, reps, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

// sync: 4 zeroed words; cycles: 2 words (the cycles, then the grid: as many
// clusters of 8 as the card keeps resident at once).  Returns a cudaError_t.
int barrier_bench_launch(int mode, int iters, void* sync, void* cycles, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(barrier_bench, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kOneBlockSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kOneBlockSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 8;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(8);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, barrier_bench, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(clusters * 8);
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, barrier_bench, mode, iters,
                         static_cast<unsigned long long*>(sync), static_cast<long long*>(cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* barrier_bench_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
