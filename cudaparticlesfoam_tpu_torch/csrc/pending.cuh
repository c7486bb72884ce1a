// The frame of the rare kernels (rare.cu, convex_rare.cu): a persistent,
// self-compacting grid over the pending flags of n lanes.
//
// At the slice about 0.6% of the lanes are pending (about 6,000 of 1M), and
// each walks a dependent chain of a few row loads.  One thread per lane over
// all n lanes made about 3,900 blocks, four in five of them holding at least
// one pending lane and so staying resident until its deepest walker ended:
// the grid ran in about six waves of one chain each.  Here the grid is
// min(ceil(n / THREADS), resident blocks) blocks (per-SM occupancy x SMs,
// queried once per kernel and device by pending_grid and cached there), so
// every block is on the card at once and the kernel lasts about one chain.
//
// The lanes are cut into groups of 16 on 16 B boundaries of the flag array,
// and block b of G takes the groups b, b + G, b + 2G, ...: lanes whose flags
// cluster (a run of pending lanes in lane order) still spread over all
// blocks, one group each.  (Contiguous strips, one per block, left a run of
// 6,000 pending lanes to a handful of blocks, each thread resolving several
// lanes in turn: 5x slower on an H100.)  A thread reads its group's flags
// as one uint4, byte by byte only in a group that is not whole (the ragged
// head before the first 16 B boundary, the tail past n), counts the set
// bytes, and a block-wide exclusive scan gives each thread its place in a
// shared list of pending lanes.  The block then resolves the list, one lane
// per thread, spread over its warps (entry e to warp e % 8), so that two
// deep walkers rarely share a warp.  A block with more than THREADS groups
// takes them THREADS at a time, so the list (16 lanes a thread) never
// overflows, even when every lane is pending.
#pragma once

#include "tile.cuh"

namespace cpf {

constexpr int PEND_VEC = 16;                    // flag bytes per thread per sub-strip
constexpr int PEND_CHUNK = THREADS * PEND_VEC;  // lanes per sub-strip = list capacity
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DEVICES = 64;

// bit j set where byte j of the 16 flags is not 0 (byte 0 = lowest address)
__device__ __forceinline__ unsigned nonzero_bytes(const uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if ((w[k] >> (8 * b)) & 0xffu) mask |= 1u << (4 * k + b);
    }
  }
  return mask;
}

// Exclusive prefix sum over the block of one int a thread; *total gets the
// block's sum.  Two barriers; the caller places one between two calls.
__device__ __forceinline__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sum[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) warp_sum[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  *total = warp_sum[WARPS - 1];
  return (warp ? warp_sum[warp - 1] : 0) + incl - x;
}

// Calls resolve(i) once for every lane i < n whose flag pend[i] is not 0,
// each from exactly one thread of the grid.  Every thread of every block
// must call it (it holds block barriers).
template <typename F>
__device__ __forceinline__ void for_each_pending(const uint8_t* __restrict__ pend, long long n,
                                                 F&& resolve) {
  __shared__ int list[PEND_CHUNK];
  // 16-lane groups start at lane org + 16 g, on 16 B boundaries of pend;
  // group 0 is the ragged head when pend is not 16 B aligned
  const unsigned mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(pend) & 15u);
  const long long org = mis ? -static_cast<long long>(mis) : 0;
  const long long groups = (n - org + PEND_VEC - 1) / PEND_VEC;
  const long long stride = gridDim.x;
  const int slot = (threadIdx.x & 31) * WARPS + (threadIdx.x >> 5);
  // sub-strip k0 / THREADS of block b: thread t takes group (k0 + t) * G + b
  for (long long k0 = 0; k0 * stride + blockIdx.x < groups; k0 += THREADS) {
    const long long g = (k0 + threadIdx.x) * stride + blockIdx.x;
    unsigned mask = 0;
    if (g < groups) {
      const long long base = org + PEND_VEC * g;
      if (base >= 0 && base + PEND_VEC <= n) {
        mask = nonzero_bytes(*reinterpret_cast<const uint4*>(pend + base));
      } else {
#pragma unroll
        for (int j = 0; j < PEND_VEC; ++j) {
          const long long q = base + j;
          if (q >= 0 && q < n && pend[q]) mask |= 1u << j;
        }
      }
    }
    int total;
    int at = block_exclusive_scan(__popc(mask), &total);
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      list[at++] = PEND_VEC * threadIdx.x + j;
    }
    __syncthreads();
    for (int e = slot; e < total; e += THREADS) {
      const int t = list[e] / PEND_VEC;
      resolve(org + PEND_VEC * ((k0 + t) * stride + blockIdx.x) + list[e] % PEND_VEC);
    }
    __syncthreads();
  }
}

// Blocks of a pending grid for `kernel` over n lanes:
// min(ceil(n / THREADS), resident blocks).  The resident count (blocks per
// SM at THREADS threads x SMs) is queried once per device and kept in
// `cache` [MAX_DEVICES], one array per kernel instantiation.
template <typename K>
inline cudaError_t pending_grid(K kernel, long long n, int* cache, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int resident = dev < MAX_DEVICES ? cache[dev] : 0;
  if (resident == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    resident = per_sm * sms > 0 ? per_sm * sms : 1;
    if (dev < MAX_DEVICES) cache[dev] = resident;
  }
  const long long need = (n + THREADS - 1) / THREADS;
  *blocks = static_cast<int>(need < resident ? need : resident);
  return cudaSuccess;
}

}  // namespace cpf
