// hop_admit_kernel: the admission rule of the block-compacted hop gather (K3,
// hop_compact=4).
//
// Replaces the admission part of cudaparticlesfoam_tpu/ops/fused_pallas.py:
// _compact_hop_rows (the stable sort of the pending 4-lane groups, the
// first capb of them scattered, the per-slot rank selectors) and
// _kernel_src_c (the per-slot valid flag, rank <= 1).  The plain version is
// ops/fused.py:hop_admit_plain.  Group g is the lanes 4g..4g+3 and is
// pending when one of them is a crosser; it is admitted when fewer than capb
// pending groups precede it; a crosser is admitted (valid) when its group is
// and fewer than 2 crossers precede it in the group.  The TPU fetched two
// neighbour rows per admitted group; on the H100 each lane loads its own row
// (stream_kernel's apply pass), so what is ported is which lanes hop.
//
// Two kernels, one launch of the wrapper: hop_admit_count writes each
// block's number of pending groups; hop_admit_kernel sums the totals of the
// blocks before its own (a scan of block totals, read from L2), ranks its
// groups with a block-wide exclusive scan (warp ballots), and writes the
// per-lane flags.  What bounds it: reading the n crossing flags twice and
// writing n admission flags (3 bytes a lane), plus the block-total sums,
// which grow with the square of the block count (1024 blocks at 1M lanes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace cpf {

constexpr int ADMIT_THREADS = 256;  // groups per block
constexpr int ADMIT_WARPS = ADMIT_THREADS / 32;

__device__ __forceinline__ unsigned group_crossers(const uint8_t* __restrict__ c,
                                                   long long n, long long g) {
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long l = 4 * g + q;
    if (l < n && c[l]) bits |= 1u << q;
  }
  return bits;
}

__global__ void __launch_bounds__(ADMIT_THREADS)
hop_admit_count(const uint8_t* __restrict__ c, long long n, long long ng,
                int* __restrict__ counts) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool pend = g < ng && group_crossers(c, n, g) != 0;
  const int count = __syncthreads_count(pend);
  if (threadIdx.x == 0) counts[blockIdx.x] = count;
}

__global__ void __launch_bounds__(ADMIT_THREADS)
hop_admit_kernel(const uint8_t* __restrict__ c, uint8_t* __restrict__ valid, long long n,
                 long long ng, const int* __restrict__ counts, long long capb) {
  __shared__ long long warp_sum[ADMIT_WARPS];
  __shared__ int warp_pend[ADMIT_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // pending groups in the blocks before this one
  long long before = 0;
  for (unsigned b = threadIdx.x; b < blockIdx.x; b += blockDim.x) before += counts[b];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_down_sync(0xffffffffu, before, o);
  if (lane == 0) warp_sum[warp] = before;

  // this group's rank among the block's pending groups
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned bits = g < ng ? group_crossers(c, n, g) : 0u;
  const unsigned ballot = __ballot_sync(0xffffffffu, bits != 0);
  if (lane == 0) warp_pend[warp] = __popc(ballot);
  __syncthreads();
  long long rank = __popc(ballot & ((1u << lane) - 1u));
  for (int v = 0; v < ADMIT_WARPS; ++v) {
    rank += warp_sum[v];
    if (v < warp) rank += warp_pend[v];
  }
  if (g >= ng) return;

  const bool admitted = bits != 0 && rank < capb;
  int seen = 0;  // crossers before this slot in the group
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long l = 4 * g + q;
    if (l >= n) break;
    const bool crosser = (bits >> q) & 1u;
    valid[l] = (admitted && crosser && seen < 2) ? 1 : 0;
    seen += crosser ? 1 : 0;
  }
}

int launch_hop_admit(const void* crossers, void* valid, void* counts, long long n,
                     long long capb, void* stream) {
  if (n <= 0) return 0;
  const long long ng = (n + 3) / 4;
  const unsigned blocks = static_cast<unsigned>((ng + ADMIT_THREADS - 1) / ADMIT_THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(crossers);
  hop_admit_count<<<blocks, ADMIT_THREADS, 0, s>>>(c, n, ng, static_cast<int*>(counts));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hop_admit_kernel<<<blocks, ADMIT_THREADS, 0, s>>>(c, static_cast<uint8_t*>(valid), n, ng,
                                                   static_cast<const int*>(counts), capb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

// crossers [n] uint8 (1 = crosser) -> valid [n] uint8 (1 = admitted crosser);
// counts is int32 scratch of (ceil(n / 4) + 255) / 256 entries.
extern "C" int cpf_hop_admit(const void* crossers, void* valid, void* counts, long long n,
                             long long capb, void* stream) {
  return cpf::launch_hop_admit(crossers, valid, counts, n, capb, stream);
}
