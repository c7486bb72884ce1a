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
// What bounds it on the H100: not its bytes (n crossing flags in, n admission
// flags out, 2 MB at 1M lanes, 0.0006 ms at 3.35 TB/s) but the latency of one
// launch and of the scan's chain across blocks.  Measured at 1M lanes on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 0.0056 ms on the card (200 calls
// replayed from a graph), 2.6 times the 0.0022 ms of a one-tile launch; the
// host needs 0.008-0.019 ms to enqueue the call.
//
// Design: one launch, a single-pass scan.  A block takes the next tile of
// 8192 lanes (2048 groups) by an atomic ticket, so a tile's predecessors are
// always held by blocks that already run and waiting on them cannot
// deadlock, whatever the order blocks are scheduled in.  A thread owns 16
// lanes, four whole groups: one 16 B load of flags, one 16 B store of
// admissions (single bytes only in the ragged last chunk of n, in loops kept
// rolled: unrolled they were most of the kernel's code, fetched cold by every
// launch).  The block scans its threads' pending-group counts (warp
// shuffles), publishes its total in its tile's status word, and its first
// warp looks back over the earlier tiles' words, 32 at a time, adding totals
// until it meets a tile whose inclusive prefix is known (decoupled
// look-back); then it publishes its own inclusive prefix.  A status word is
// 32 bits, flag in the top two (0 empty, 1 total, 2 inclusive prefix) and
// count below, so one volatile access moves both and no fence is needed.
// 123 tiles at 1M lanes, at most four look-back windows.  Blocks of 128 to
// 1024 threads with 16 or 32 lanes a thread were tried on the card: 512 x 16
// was the fastest at 1M and 4M lanes (fewer tiles shorten the chain, larger
// blocks start more slowly).  A launch of one tile touches no scratch at all.
//
// Scratch (uint32 words, zero before the first call): [0] the ticket, [1] the
// blocks that finished their look-back, [2 + t] tile t's status.  The last
// block to finish its look-back zeroes all of it again, so the next call on
// the stream finds it clean and the wrapper never has to reset it.
//
// The earlier design took two launches (a count kernel, then a kernel in
// which every block re-summed the totals of all blocks before it) over 977
// blocks of 256 groups, with eight single-byte accesses per thread.  On the
// card the two are level (0.0053 ms for the pair); the host enqueues one
// launch fewer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace cpf {

constexpr int ADMIT_THREADS = 512;
constexpr int ADMIT_WARPS = ADMIT_THREADS / 32;
constexpr int ADMIT_CHUNKS = 1;                                  // 16 B chunks per thread
constexpr int ADMIT_LANES = 16 * ADMIT_CHUNKS * ADMIT_THREADS;  // lanes per tile
constexpr unsigned ST_TOTAL = 1u << 30, ST_PREFIX = 2u << 30, ST_VALUE = (1u << 30) - 1u;
constexpr unsigned FULL_WARP = 0xffffffffu;

__global__ void __launch_bounds__(ADMIT_THREADS)
hop_admit_kernel(const uint8_t* __restrict__ c, uint8_t* __restrict__ valid, long long n,
                 unsigned* scratch, long long capb) {
  __shared__ unsigned s_tile, s_before;
  __shared__ unsigned s_warp[ADMIT_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool single = gridDim.x == 1;  // one tile: no ticket, no status, no scratch
  volatile unsigned* status = scratch + 2;

  if (!single && threadIdx.x == 0) s_tile = atomicAdd(scratch, 1u);
  if (threadIdx.x == 0) s_before = 0u;
  __syncthreads();
  const unsigned t = single ? 0u : s_tile;
  const long long l0 = static_cast<long long>(t) * ADMIT_LANES +
                       16 * ADMIT_CHUNKS * threadIdx.x;

  // the thread's crossing flags: word g is group g's four lanes, a byte each
  // (the ragged last chunk of n byte by byte, in a loop kept rolled: unrolled
  // it was most of the kernel's code, fetched cold by every launch)
  constexpr int GROUPS = 4 * ADMIT_CHUNKS;
  uint32_t f[GROUPS];
  unsigned mine = 0u;
#pragma unroll
  for (int h = 0; h < ADMIT_CHUNKS; ++h) {
    const long long lh = l0 + 16 * h;
    unsigned long long lo = 0ull, hi = 0ull;
    if (lh + 16 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(c + lh);
      lo = v.x | (static_cast<unsigned long long>(v.y) << 32);
      hi = v.z | (static_cast<unsigned long long>(v.w) << 32);
    } else if (lh < n) {
      const int left = static_cast<int>(n - lh);
#pragma unroll 1
      for (int q = 0; q < left; ++q) {
        const unsigned long long bit = c[lh + q] ? 1ull << (8 * (q & 7)) : 0ull;
        if (q < 8) lo |= bit; else hi |= bit;
      }
    }
    f[4 * h] = static_cast<uint32_t>(lo);
    f[4 * h + 1] = static_cast<uint32_t>(lo >> 32);
    f[4 * h + 2] = static_cast<uint32_t>(hi);
    f[4 * h + 3] = static_cast<uint32_t>(hi >> 32);
  }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) mine += f[g] != 0u ? 1u : 0u;

  // pending groups before this thread's in the block, and the block's total
  unsigned incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(FULL_WARP, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned in_block = incl - mine, total = 0u;
#pragma unroll
  for (int v = 0; v < ADMIT_WARPS; ++v) {
    const unsigned x = s_warp[v];
    in_block += v < warp ? x : 0u;
    total += x;
  }

  // pending groups in the tiles before this one
  if (!single && warp == 0) {
    unsigned before = 0u;
    if (t > 0u) {
      if (lane == 0) status[t] = ST_TOTAL | total;
      int j = static_cast<int>(t) - 1;
      while (true) {
        const int idx = j - lane;
        unsigned s = ST_PREFIX;  // before tile 0: an inclusive prefix of 0
        if (idx >= 0) {
          do {
            s = status[idx];
          } while ((s >> 30) == 0u);
        }
        const unsigned known = __ballot_sync(FULL_WARP, (s >> 30) == 2u);
        const int last = known ? __ffs(known) - 1 : 31;  // nearest tile with a prefix
        unsigned v = lane <= last ? (s & ST_VALUE) : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_WARP, v, o);
        before += v;
        if (known) break;
        j -= 32;
      }
    }
    if (lane == 0) {
      status[t] = ST_PREFIX | (before + total);
      s_before = before;
    }
  }
  __syncthreads();

  // admission of the thread's groups and lanes
  long long rank = static_cast<long long>(s_before) + in_block;
#pragma unroll
  for (int h = 0; h < ADMIT_CHUNKS; ++h) {
    uint32_t out[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint32_t fg = f[4 * h + g];
      const bool pending = fg != 0u;
      const bool admitted = pending && rank < capb;
      rank += pending ? 1 : 0;
      int seen = 0;  // crossers before this slot in the group
      uint32_t w = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const bool crosser = ((fg >> (8 * b)) & 0xffu) != 0u;
        if (admitted && crosser && seen < 2) w |= 1u << (8 * b);
        seen += crosser ? 1 : 0;
      }
      out[g] = w;
    }
    const long long lh = l0 + 16 * h;
    if (lh + 16 <= n) {
      *reinterpret_cast<uint4*>(valid + lh) = make_uint4(out[0], out[1], out[2], out[3]);
    } else if (lh < n) {
      const unsigned long long lo = out[0] | (static_cast<unsigned long long>(out[1]) << 32);
      const unsigned long long hi = out[2] | (static_cast<unsigned long long>(out[3]) << 32);
      const int left = static_cast<int>(n - lh);
#pragma unroll 1
      for (int q = 0; q < left; ++q) {
        valid[lh + q] = static_cast<uint8_t>(((q < 8 ? lo : hi) >> (8 * (q & 7))) & 0xffull);
      }
    }
  }

  // the last block past its look-back leaves the scratch zeroed
  if (!single && warp == 0) {
    unsigned last_block = 0u;
    if (lane == 0) {
      __threadfence();
      last_block = atomicAdd(scratch + 1, 1u) == gridDim.x - 1u ? 1u : 0u;
    }
    last_block = __shfl_sync(FULL_WARP, last_block, 0);
    if (last_block) {
      __threadfence();
      for (unsigned idx = lane; idx < gridDim.x; idx += 32u) status[idx] = 0u;
      if (lane == 0) {
        scratch[0] = 0u;
        scratch[1] = 0u;
      }
    }
  }
}

int launch_hop_admit(const void* crossers, void* valid, void* scratch, long long n,
                     long long capb, void* stream) {
  if (n <= 0) return 0;
  if (n > (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);  // 30-bit counts
  const unsigned tiles = static_cast<unsigned>((n + ADMIT_LANES - 1) / ADMIT_LANES);
  hop_admit_kernel<<<tiles, ADMIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(crossers), static_cast<uint8_t*>(valid), n,
      static_cast<unsigned*>(scratch), capb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

// crossers [n] uint8 (nonzero = crosser) -> valid [n] uint8 (1 = admitted
// crosser), both 16 B aligned; scratch is 2 + ceil(n / 8192) zeroed 32-bit
// words, left zeroed.
extern "C" int cpf_hop_admit(const void* crossers, void* valid, void* scratch, long long n,
                             long long capb, void* stream) {
  return cpf::launch_hop_admit(crossers, valid, scratch, n, capb, stream);
}
