// chase_kernel<MODE>: a measuring kernel, not a port of a TPU kernel and
// never called by the port.  It gives the latency of one dependent load on
// the card, the unit of the rare kernels' latency bound
// (ops/traffic.py:latency_bound): one thread follows a chain of `steps`
// loads, each address taken from the value the load before returned.
//
// MODE 0, the neighbour walk: through the neighbour codes of a row table
// (mesh.tet_row, columns nbr .. nbr+3), the face picked by a hash of the
// step, a wall code (< 0) sending the walk back to its own tet.  Rows are
// read through the read-only path, as the rare kernels read table rows, so
// this is the locality a walk really has (neighbours share lines and L2).
// MODE 1, the memory figure: through `next`, a single-cycle permutation
// over a buffer the size of the table, each step a random line.
//
// state[0] holds the chain's position and state[1] the hash; a launch
// starts where the last one stopped, so repeated launches walk on instead
// of replaying the same addresses.  The plain version is ops/probe.py.
//
// The units of amg_tail_kernel's latency bound, measuring too, each in one
// cluster of 16 blocks (the tail's shape):
// cluster_sync_kernel<MODE> passes `syncs` cluster barriers in one cluster
// of 2, 4, 8 or 16 blocks: MODE 0 barrier.cluster arrive and wait, release
// and acquire at cluster scope in every thread (the earlier tail's); 1 a relaxed
// arrive, no memory ordering, only to price the fence; 2 the tail's
// barrier (csrc/amg.cu cluster_arrive/wait): __syncthreads, warp 0's
// arrive with release, the other warps' relaxed, every thread's wait with
// acquire; each block's thread 0 then adds the count it passed to
// state[rank].
// smem_chase_kernel: every block fills its shared memory with the cycle
// j -> (389 j + 1) mod CHASE_SLOTS; block 0's thread 0 follows `steps`
// loads of it from state[0] mod CHASE_SLOTS, each index the value the load before
// returned, in its own shared memory (kRemote false: a coarsest sweep's
// read of x) or each in another block's through map_shared_rank (true: a
// tail phase's read of a neighbour's r or xc), and leaves where it stopped
// in state[0].
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cpf {

// the hash of the neighbour walk (ops/probe.py:_next_hash): a 32-bit LCG,
// the face its top two bits
__device__ __forceinline__ unsigned next_hash(unsigned h) { return h * 1664525u + 1013904223u; }

template <int MODE>
__global__ void chase_kernel(const float* __restrict__ tab, const int* __restrict__ next,
                             int row_w, int nbr, int steps, int* state) {
  int at = state[0];
  unsigned h = static_cast<unsigned>(state[1]);
  for (int s = 0; s < steps; ++s) {
    if constexpr (MODE == 0) {
      h = next_hash(h);
      const int code =
          static_cast<int>(__ldg(tab + static_cast<long long>(at) * row_w + nbr + (h >> 30)));
      at = code >= 0 ? code : at;
    } else {
      at = __ldcg(next + at);
    }
  }
  state[0] = at;
  state[1] = static_cast<int>(h);
}

constexpr int CLUSTER_BLOCKS = 16;
constexpr int CHASE_SLOTS = 1024;

template <int MODE>
__global__ void cluster_sync_kernel(int syncs, int* state) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  for (int s = 0; s < syncs; ++s) {
    if (MODE == 1) {
      asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
    } else if (MODE == 2) {
      __syncthreads();
      if (threadIdx.x < 32)
        asm volatile("barrier.cluster.arrive.release;" ::: "memory");
      else
        asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
    } else {
      asm volatile("barrier.cluster.arrive.release;" ::: "memory");
    }
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  }
  if (threadIdx.x == 0) state[cl.block_rank()] += syncs;
}

template <bool kRemote>
__global__ void smem_chase_kernel(int steps, int* state) {
  __shared__ int slot[CHASE_SLOTS];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  for (int i = threadIdx.x; i < CHASE_SLOTS; i += blockDim.x)
    slot[i] = (389 * i + 1) % CHASE_SLOTS;
  cl.sync();
  if (cl.block_rank() == 0 && threadIdx.x == 0) {
    int j = state[0] & (CHASE_SLOTS - 1);
    for (int s = 0; s < steps; ++s) {
      if (kRemote)
        j = *cl.map_shared_rank(slot + j, 1u + static_cast<unsigned>(s) % (CLUSTER_BLOCKS - 1));
      else
        j = slot[j];
    }
    state[0] = j;
  }
  cl.sync();    // no block leaves while block 0 still reads its shared memory
}

// one cluster of `blocks` (at most 16) blocks of `threads`
int launch_cluster(const void* fn, int blocks, int threads, void** args, void* stream) {
  if (blocks < 1 || blocks > CLUSTER_BLOCKS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

extern "C" int cpf_cluster_sync(int syncs, int threads, int mode, int blocks, void* state,
                                void* stream) {
  const void* fn = mode == 1   ? reinterpret_cast<const void*>(cpf::cluster_sync_kernel<1>)
                   : mode == 2 ? reinterpret_cast<const void*>(cpf::cluster_sync_kernel<2>)
                               : reinterpret_cast<const void*>(cpf::cluster_sync_kernel<0>);
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  int* st = static_cast<int*>(state);
  void* args[] = {&syncs, &st};
  return cpf::launch_cluster(fn, blocks, threads, args, stream);
}

extern "C" int cpf_smem_chase(int steps, int remote, void* state, void* stream) {
  const void* fn = remote ? reinterpret_cast<const void*>(cpf::smem_chase_kernel<true>)
                          : reinterpret_cast<const void*>(cpf::smem_chase_kernel<false>);
  int* st = static_cast<int*>(state);
  void* args[] = {&steps, &st};
  return cpf::launch_cluster(fn, cpf::CLUSTER_BLOCKS, 32, args, stream);
}

extern "C" int cpf_chase_nbr(const void* tab, int row_w, int nbr, int steps, void* state,
                             void* stream) {
  cpf::chase_kernel<0><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), nullptr, row_w, nbr, steps, static_cast<int*>(state));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cpf_chase_perm(const void* next, int steps, void* state, void* stream) {
  cpf::chase_kernel<1><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      nullptr, static_cast<const int*>(next), 0, 0, steps, static_cast<int*>(state));
  return static_cast<int>(cudaGetLastError());
}
