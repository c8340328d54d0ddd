// Timing probe, not a kernel of any path: the dependency floor of the
// point-source trace's cluster plan (trace.cu, octant_trace_cluster_kernel).
//
// barrier_floor_kernel runs `phases` rounds of the cluster barrier
// (barrier.cluster.arrive.release / wait.acquire, as the trace brackets
// each face) and nothing else, on the clusters and threads of the trace's
// launch plan; RELAXED: the arrive without its release, which shows what the
// release costs.  kernel_times.py times it beside the trace, through
// _build.get_probe_lib("trace_floor"); load_all never builds it and no
// wrapper launches it.
#include <cuda_runtime.h>

constexpr int FLOOR_THREADS = 1024;
constexpr int MAX_CLUSTER = 16;

template <bool RELAXED>
__global__ void __launch_bounds__(FLOOR_THREADS) barrier_floor_kernel(int phases) {
  for (int p = 0; p < phases; ++p) {
    if (RELAXED) {
      asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
    } else {
      asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  }
}

// Launch barrier_floor_kernel<relaxed> on 8 clusters of `cluster` blocks of
// `threads`.  Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int pion_trace_barrier_floor(int cluster, int threads, int phases, int relaxed,
                                        void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || threads < 32 || threads > FLOOR_THREADS ||
      phases < 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = relaxed ? barrier_floor_kernel<true> : barrier_floor_kernel<false>;
  if (cluster > 8) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8 * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, phases);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
