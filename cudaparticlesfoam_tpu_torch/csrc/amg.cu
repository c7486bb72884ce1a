// The AMG-CG pressure solve's kernels: the matvec, the two level kernels
// of one V(1,1) cycle's large levels, and the tail kernel that runs the
// small levels and the coarsest in one launch.  They replace no Pallas
// kernel: the JAX package leaves the solve to XLA, which fuses the matvec
// (cudaparticlesfoam_tpu/models/fv.py:420-431) and each level of
// amg_vcycle (:537-570) inside the CG's lax.while_loop.  Op by op in torch a
// V-cycle was ~309 launches; here it is 2t + 1 (t large levels down, the
// tail, t large levels up; ops/amg.py:tail_start), and a CG iteration's
// matvec one more.
//
// Every sum into a row walks a row plan (ops/amg.py:RowPlan, CSR, int32):
// row i's terms offsets[i]..offsets[i+1] in the order fv.index_sum gives
// them (face order of the owner part, then of the neighbour part), summed
// from 0 left to right, then added to diag*x.  The expressions keep the
// plain versions' association, (omega*r)/d, d*x + acc, x + (omega*(r - Ax))/d,
// and the library is built --fmad=false, so each kernel equals its plain
// version (ops/amg.py) bit for bit.
//
// Bound: bytes at the large levels, latency below.  One thread a row reads
// its plan entries, the coefficients and the neighbours' values
// (L2-resident at these sizes); a level kernel recomputes each neighbour's
// smoothed value in place, so no level writes a temporary: down writes the
// coarse residual, up the corrected x.  A small level is one chain of
// dependent loads plus a launch, whatever its bytes, so the levels of at
// most TAIL_ROWS rows (ops/amg_cuda.py) run in amg_tail_kernel: one cluster
// of 16 blocks.  Its plan (ops/amg_tail.py, made once per hierarchy) puts
// each row in the block that owns its aggregate and the levels of at most
// TAIL_BLOCK0_ROWS rows in block 0 alone; a prologue stages every phase's
// index data and coefficients in the blocks' shared memory, so a phase
// waits only on its barrier and on the one value the phase before wrote
// (a neighbour's s or x', read from the owner's shared memory).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cpf {

namespace cg = cooperative_groups;

constexpr int AMG_THREADS = 256;
// the tail's one cluster: 16 blocks (a non-portable size) of up to 512
// threads
constexpr int TAIL_BLOCKS = 16;
constexpr int TAIL_THREADS = 512;
constexpr int TAIL_MAX_LEVELS = 16;      // build_amg's max_levels (models/fv.py)
// dynamic shared memory of a block: the opt-in 227 KB (232,448 B) less
// 1.5 KB kept for the static part (the mbarriers and the level headers)
constexpr int TAIL_SMEM_MAX = 230912;
// a packed address of a cluster level's row: owner rank << 16 | slot
constexpr int TAIL_SLOT_BITS = 16;

// the coefficient of plan position p: face p of part 0 (upper) or face
// p - nf of part 1 (lower)
template <typename T>
__device__ __forceinline__ T coef_at(const T* __restrict__ upper, const T* __restrict__ lower,
                                     int p, int nf) {
  return p < nf ? upper[p] : lower[p - nf];
}

// y = diag*x + sum_row coef*x[col], x [n, K] row-major
template <typename T, int K>
__global__ void __launch_bounds__(AMG_THREADS)
fv_matvec_kernel(int n, const int* __restrict__ off, const int* __restrict__ pos,
                 const int* __restrict__ col, int nf, const T* __restrict__ diag,
                 const T* __restrict__ upper, const T* __restrict__ lower,
                 const T* __restrict__ x, T* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = T(0);
  const int t1 = off[i + 1];
  for (int t = off[i]; t < t1; ++t) {
    const T a = coef_at(upper, lower, pos[t], nf);
    const long long j = static_cast<long long>(col[t]) * K;
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = acc[c] + a * x[j + c];
  }
  const T d = diag[i];
  const long long o = static_cast<long long>(i) * K;
#pragma unroll
  for (int c = 0; c < K; ++c) y[o + c] = d * x[o + c] + acc[c];
}

// the pre-smoothed x of row j: omega r / d
template <typename T>
__device__ __forceinline__ T smoothed(const T* __restrict__ r, const T* __restrict__ diag, T omega,
                                      int j) {
  return (omega * r[j]) / diag[j];
}

// one coarse row c: rc[c] = sum over fine rows i of aggregate c of
// r1[i] = r[i] - (d[i] x[i] + sum_row off*x[j]), x = omega r / d
template <typename T>
__global__ void __launch_bounds__(AMG_THREADS)
amg_down_kernel(int nc, const int* __restrict__ aoff, const int* __restrict__ acell,
                const int* __restrict__ off, const int* __restrict__ pos,
                const int* __restrict__ col, int nf, const T* __restrict__ diag,
                const T* __restrict__ offc, const T* __restrict__ r, T omega,
                T* __restrict__ rc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  T acc = T(0);
  const int a1 = aoff[c + 1];
  for (int a = aoff[c]; a < a1; ++a) {
    const int i = acell[a];
    const T di = diag[i];
    const T xi = (omega * r[i]) / di;
    T s = T(0);
    const int t1 = off[i + 1];
    for (int t = off[i]; t < t1; ++t)
      s = s + coef_at(offc, offc, pos[t], nf) * smoothed(r, diag, omega, col[t]);
    acc = acc + (r[i] - (di * xi + s));
  }
  rc[c] = acc;
}

// the prolonged x' of row j: omega r / d + xc[agg] (times valid on a shard)
template <typename T>
__device__ __forceinline__ T prolonged(const T* __restrict__ r, const T* __restrict__ diag,
                                       T omega, const int* __restrict__ agg,
                                       const T* __restrict__ valid, const T* __restrict__ xc,
                                       int j) {
  const T xcj = xc[agg[j]];
  return smoothed(r, diag, omega, j) + (valid ? xcj * valid[j] : xcj);
}

// one fine row i: x'' = x' + (omega (r - (d x' + sum_row off*x'[j]))) / d
template <typename T>
__global__ void __launch_bounds__(AMG_THREADS)
amg_up_kernel(int n, const int* __restrict__ off, const int* __restrict__ pos,
              const int* __restrict__ col, int nf, const T* __restrict__ diag,
              const T* __restrict__ offc, const T* __restrict__ r, T omega,
              const int* __restrict__ agg, const T* __restrict__ valid,
              const T* __restrict__ xc, T* __restrict__ x) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T xi = prolonged(r, diag, omega, agg, valid, xc, i);
  T s = T(0);
  const int t1 = off[i + 1];
  for (int t = off[i]; t < t1; ++t)
    s = s + coef_at(offc, offc, pos[t], nf) * prolonged(r, diag, omega, agg, valid, xc, col[t]);
  const T di = diag[i];
  x[i] = xi + (omega * (r[i] - (di * xi + s))) / di;
}

// One level of the tail as ops/amg_cuda.py:tail_params fills it from the
// tail plan (ops/amg_tail.py): the level's operator, where this block's
// segment of the plan lies in `blob` (int32 words: block b's at base + b *
// seg, b = 0 on a block-0 level), the offsets of its fields in a segment,
// and where the level's values live in a block's shared memory (bytes; -1:
// not there).  With `stage` the segment's first `copy` words and the
// gathered values (coef, diag, valid; on a cluster top the diag, r (sr)
// and s (sv = ss) of its distinct neighbours, own rows first, which its
// terms reach through tslot; on level C lvalid) are staged in shared
// memory by the prologue.
struct TailLevel {
  const void* diag;    // [n]
  const void* off;     // [nf]
  const void* valid;   // [n] the prolongation's valid onto this level (null: none)
  int n;
  int stage;
  int cap_rows;
  int cap_terms;
  int base;
  int seg;
  int copy;
  int toff, addr, moff, mem, poff, pmem, grow, ldst, tslot, cpos;
  int st, coef, sdiag, svalid, sv, sr, ss, lvalid;
  int r, v;
  int pad;
};

// the tail, passed by value (__grid_constant__: a CUDA graph captures it
// whole); ops/amg_cuda.py:TailParams
struct TailParams {
  const void* r_top;   // the top level's r (global, read only)
  void* x_out;         // the top level's x (global)
  void* xs;            // the top cluster level's x' (global scratch; null when C = 0)
  const int* blob;     // the tail plan's words
  const int* prog;     // the prologue's gather programs (ops/amg_tail.py:programs)
  long long* stamps;   // null, or each phase's clocks in block 0 added here
  double omega;
  int levels;          // K
  int cluster;         // C: levels 0 .. C - 1 over the cluster, C .. K - 1 in block 0
  int sweeps;
  int xb;              // the coarsest's second sweep buffer (bytes)
  int r1, sp;          // level P's r1 and s in block 0 (bytes)
  int lower;           // n_P
  int prog_local;      // items of a block's program (16 of them), then
  int prog_stretch;    // of block 0's levels' program
  TailLevel lv[TAIL_MAX_LEVELS];
};

// terms of a row whose loads are in flight together: as many as the 128
// registers a thread of a 512-thread block holds
template <typename T>
__host__ __device__ constexpr int tail_batch() {
  return sizeof(T) == 8 ? 4 : 8;
}

// s[q] = sum_row term(load(t)) from 0, left to right, over terms t0[q] ..
// t1[q] of R rows in lockstep: the loads of B terms of each row (load: the
// coefficient and the value the term reads) are issued before any of
// their arithmetic, then each row adds its terms in order, so the bits are
// the serial loop's
template <typename T, int R, int B, typename Load, typename Term>
__device__ __forceinline__ void row_sums(const int (&t0)[R], const int (&t1)[R], T (&s)[R],
                                         Load load, Term term) {
  using V = decltype(load(0));
  int len = 0;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    s[q] = T(0);
    len = max(len, t1[q] - t0[q]);
  }
  for (int b = 0; b < len; b += B) {
    V v[R][B];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (b + u < t1[q] - t0[q]) v[q][u] = load(t0[q] + b + u);
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (b + u < t1[q] - t0[q]) s[q] = s[q] + term(v[q][u]);
  }
}

// a term: its coefficient and the value it reads
template <typename T>
struct Term2 {
  T c, a;
};

template <typename T>
__device__ __forceinline__ T product(const Term2<T>& x) {
  return x.c * x.a;
}

// One level as this block sees it: the plan's fields (in shared memory when
// staged, else in global memory), the staged values, the level's arrays
// and its vectors in shared memory.
template <typename T>
struct View {
  const int* toff;
  const int* addr;
  const int* moff;
  const int* mem;
  const int* poff;
  const int* pmem;
  const int* grow;
  const int* ldst;
  const int* tslot;
  const int* cpos;     // global
  const T* coef;
  const T* sdiag;
  const T* svalid;
  const T* sv;
  const T* sr;
  const T* ss;
  const T* lvalid;
  const T* off;
  const T* diag;
  const T* valid;
  T* r;
  T* v;
  int stage;

  // row q's diag and valid (q a row of this block), either staging
  __device__ __forceinline__ T d(int q) const { return stage ? sdiag[q] : diag[grow[q]]; }
  __device__ __forceinline__ T val(int q) const { return stage ? svalid[q] : valid[grow[q]]; }
};

template <typename T>
__device__ __forceinline__ T* at_smem(unsigned char* smem, int bytes) {
  return bytes >= 0 ? reinterpret_cast<T*>(smem + bytes) : nullptr;
}

template <typename T>
__device__ View<T> view(const TailParams& p, int k, unsigned rank, unsigned char* smem) {
  const TailLevel& L = p.lv[k];
  const long long b = k < p.cluster ? rank : 0;
  const int* g = p.blob + L.base + b * L.seg;
  const int* ix = L.stage ? reinterpret_cast<const int*>(smem + L.st) : g;
  View<T> w;
  w.toff = ix + L.toff;
  w.addr = ix + L.addr;
  w.moff = ix + L.moff;
  w.mem = ix + L.mem;
  w.poff = ix + L.poff;
  w.pmem = ix + L.pmem;
  w.grow = ix + L.grow;
  w.ldst = ix + L.ldst;
  w.tslot = ix + L.tslot;
  w.cpos = g + L.cpos;
  w.coef = at_smem<T>(smem, L.coef);
  w.sdiag = at_smem<T>(smem, L.sdiag);
  w.svalid = at_smem<T>(smem, L.svalid);
  w.sv = at_smem<T>(smem, L.sv);
  w.sr = at_smem<T>(smem, L.sr);
  w.ss = at_smem<T>(smem, L.ss);
  w.lvalid = at_smem<T>(smem, L.lvalid);
  w.off = static_cast<const T*>(L.off);
  w.diag = static_cast<const T*>(L.diag);
  w.valid = static_cast<const T*>(L.valid);
  w.r = at_smem<T>(smem, L.r);
  w.v = at_smem<T>(smem, L.v);
  w.stage = L.stage;
  return w;
}

// A level's coefficients and diag with its staging fixed at compile time,
// so that a row's term loads carry no branch and issue together.
template <typename T, bool S>
struct Coefs {
  static constexpr bool staged = S;
  const View<T>& w;
  __device__ __forceinline__ T c(int t) const {
    if constexpr (S)
      return w.coef[t];
    else
      return w.off[w.cpos[t]];
  }
  __device__ __forceinline__ T d(int q) const {
    if constexpr (S)
      return w.sdiag[q];
    else
      return w.diag[w.grow[q]];
  }
};

// fn(Coefs<T, staged>) with the level's staging as a compile-time flag
template <typename T, typename Fn>
__device__ __forceinline__ void with_coefs(const View<T>& w, Fn fn) {
  if (w.stage)
    fn(Coefs<T, true>{w});
  else
    fn(Coefs<T, false>{w});
}

// a cluster level's value at packed address a = rank << TAIL_SLOT_BITS |
// slot, read from (or written to) its owner's copy of the vector at `v`;
// one path for every owner, this block included, so loads issue together
template <typename T>
__device__ __forceinline__ T fetch(const cg::cluster_group& cl, T* v, int a) {
  return *cl.map_shared_rank(v + (a & ((1 << TAIL_SLOT_BITS) - 1)),
                             static_cast<unsigned>(a) >> TAIL_SLOT_BITS);
}

template <typename T>
__device__ __forceinline__ void store_at(const cg::cluster_group& cl, T* v, int a, T x) {
  *cl.map_shared_rank(v + (a & ((1 << TAIL_SLOT_BITS) - 1)),
                      static_cast<unsigned>(a) >> TAIL_SLOT_BITS) = x;
}

// r1 = r - (d s + sum_row coef * nbr) of rows i[0 .. m) of a level (m 1
// or 2, the sums of both rows in lockstep); own(i, r, s) gives a row's own
// r and s = omega r / d
template <typename T, int B, typename Cf, typename Own, typename Nbr>
__device__ __forceinline__ void residual2(const Cf& cf, const int* toff, const int (&i)[2], int m,
                                          Own own, Nbr nbr, T (&r1)[2]) {
  int t0[2], t1[2];
  T ri[2], si[2], di[2], s[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    t0[q] = toff[i[q]];
    t1[q] = q < m ? toff[i[q] + 1] : t0[q];
    own(i[q], ri[q], si[q]);
    di[q] = cf.d(i[q]);
  }
  row_sums<T, 2, B>(t0, t1, s, [&](int t) { return Term2<T>{cf.c(t), nbr(t)}; }, product<T>);
#pragma unroll
  for (int q = 0; q < 2; ++q) r1[q] = ri[q] - (di[q] * si[q] + s[q]);
}

// the restriction of one coarse row: the sum from 0, in the plan's order,
// of r1 over its members mem[a0 .. a1), two at a time
template <typename T, int B, typename Cf, typename Own, typename Nbr>
__device__ __forceinline__ T restrict_row(const Cf& cf, const int* toff, const int* mem, int a0,
                                          int a1, Own own, Nbr nbr) {
  T acc = T(0);
  for (int a = a0; a < a1; a += 2) {
    const int m = a1 - a < 2 ? a1 - a : 2;
    const int i[2] = {mem[a], m > 1 ? mem[a + 1] : mem[a]};
    T r1[2];
    residual2<T, B>(cf, toff, i, m, own, nbr, r1);
    acc = acc + r1[0];
    if (m > 1) acc = acc + r1[1];
  }
  return acc;
}

// x'' = x' + (omega (r - (d x' + sum_row coef * x'[nbr]))) / d of row q
template <typename T, int B, typename Cf, typename Nbr>
__device__ __forceinline__ T smooth_row(const Cf& cf, const int* toff, int q, T x, T r, T omega,
                                        Nbr nbr) {
  const int t0[1] = {toff[q]}, t1[1] = {toff[q + 1]};
  T s[1];
  row_sums<T, 1, B>(t0, t1, s, [&](int t) { return Term2<T>{cf.c(t), nbr(t)}; }, product<T>);
  const T d = cf.d(q);
  return x + (omega * (r - (d * x + s[0]))) / d;
}

// dst(i, src(idx(i))) for i = lo, lo + step, ... below hi: eight index
// loads, then their eight value loads, in flight a thread
template <typename Idx, typename Src, typename Dst>
__device__ __forceinline__ void gather(int lo, int hi, int step, Idx idx, Src src, Dst dst) {
  constexpr int G = 8;
  using V = decltype(src(0));
  for (int i = lo; i < hi; i += G * step) {
    int j[G];
#pragma unroll
    for (int u = 0; u < G; ++u) j[u] = i + u * step < hi ? idx(i + u * step) : -1;
    V v[G];
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (j[u] >= 0) v[u] = src(j[u]);
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (j[u] >= 0) dst(i + u * step, v[u]);
  }
}

// terms of a coarsest row its thread keeps in registers over the sweeps
constexpr int TAIL_COARSE_TERMS = 8;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// mbarrier-tracked bulk copies of the staged segments (PTX ISA: mbarrier,
// cp.async.bulk): one barrier a level, one arrival (the issuing thread's,
// with the copy's byte count), completed by the copy's transaction bytes
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}
// the address of this block's `ptr` in the cluster's shared window
__device__ __forceinline__ unsigned cluster_u32(const void* ptr, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_u32(ptr)), "r"(rank));
  return a;
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar, unsigned rank) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(cluster_u32(dst, rank)),
      "l"(src), "r"(bytes), "r"(cluster_u32(bar, rank))
      : "memory");
}
// a gather program's pad item (ops/amg_tail.py:NO_SOURCE)
constexpr int TAIL_NO_SOURCE = 63;
// clocks a wait on a staged segment may take before the kernel traps
// (about 2 s): a copy that never lands is a fault to report, not a hang
constexpr long long TAIL_WAIT_CLOCKS = 1LL << 32;

__device__ __forceinline__ bool mbar_done(unsigned long long* bar) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(0u)
      : "memory");
  return ok != 0;
}

// The cluster barrier between two phases: every thread's writes (to its
// own block's shared memory, to another block's, to global memory) before
// it must be visible to every thread of the cluster after it.
//
// Why one releasing warp a block is enough (PTX ISA, "Memory Consistency
// Model": "Ordering of memory operations" (program order,
// synchronizes-with, base causality order, causality order), "Release
// and acquire patterns"; "Parallel Synchronization and Communication
// Instructions": bar / barrier.cta, barrier.cluster):
//  1. bar.sync (__syncthreads) makes each thread's earlier accesses precede,
//     at CTA scope, the accesses of every thread after it: the barrier's
//     completion synchronizes-with every participant.
//  2. warp 0's barrier.cluster.arrive.release is a release at cluster
//     scope, and each thread's barrier.cluster.wait.acquire an acquire at
//     cluster scope; the arrive synchronizes-with the waits of the same
//     barrier phase in every thread of the cluster.
//  3. base causality order is transitive over program order and
//     synchronizes-with (the release is cumulative): a write W of any
//     thread of block X before step 1 precedes, in causality order, every
//     read R in any block after its wait, so R sees W (or a later write).
// A barrier.cluster.arrive.relaxed alone orders nothing (the ISA says so of
// .relaxed), which is why warp 0 keeps the release; the other warps arrive
// relaxed, their writes ordered by step 1.  This is the pattern of
// cooperative_groups' grid sync (bar.sync, then one thread's fence and
// arrival).  The release is warp-uniform: thread 0 alone releasing while
// its warp's other lanes arrived relaxed deadlocked on the card (the arrive
// is counted a warp at a time).  probe.cu's cluster_sync_kernel<2> prices
// this barrier beside <0>, every thread arriving with release.
__device__ __forceinline__ void cluster_arrive() {
  __syncthreads();
  if (threadIdx.x < 32)
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
// an arrive that orders nothing: the kernel's first, so that no block
// touches another's shared memory before every block of the cluster runs
// (CUDA C++ Programming Guide, "Distributed Shared Memory")
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The small levels of one V-cycle and the coarsest in one launch of one
// cluster (the tail plan's design, ops/amg_tail.py):
//  prologue   every block copies its staged segments into shared memory
//             (cp.async.bulk, one mbarrier a level) and gathers the values
//             they index: coefficients, diag, valid, and on the top level
//             r, s = omega r / d of its rows and each term's neighbour s;
//             the cluster gathers block 0's levels for it, into its shared
//             memory;
//  down k     (cluster levels, k + 1 < C) each block sums the r1 of its own
//             fine rows into its own coarse rows and keeps their r and s;
//  boundary   each block's rows of level P = C - 1: r1 and s into block 0;
//  block 0    level C from level P's r1, the block-0 levels down, the
//             coarsest's sweeps (one row a thread, its terms in registers),
//             the levels back up, behind __syncthreads; x' of level P into
//             each row's owner;
//  up k       (cluster levels) x'' of each own row, then x' of its
//             prolongation's rows (this block's own) below; the top writes
//             x_out.
// Each cluster phase ends in a cluster barrier (cluster_arrive/wait): 2C in
// all; the top reads its neighbours' x' from global memory, so no block
// reads another's shared memory in the last phase and none waits to leave.
// Every sum keeps tail_plain's terms, order and association, so the result
// equals it bit for bit.  A choice that holds for a whole phase (a level
// staged or not, where a neighbour's value lives) is made once, outside its
// row loop, so the loads of a row's terms carry no branch.
template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
amg_tail_kernel(const __grid_constant__ TailParams p) {
  constexpr int B = tail_batch<T>();
  constexpr int CT = TAIL_COARSE_TERMS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long mbar[TAIL_MAX_LEVELS];
  __shared__ int hdr[TAIL_MAX_LEVELS][4];
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int tid = static_cast<int>(threadIdx.x);
  const int nt = static_cast<int>(blockDim.x);
  const int K = p.levels, C = p.cluster, P = C - 1;
  if (C == 0 && rank != 0) return;              // the whole tail in block 0
  if (C >= 1) cluster_arrive_relaxed();         // waited at the prologue's end
  const T omega = static_cast<T>(p.omega);
  const T* __restrict__ rtop = static_cast<const T*>(p.r_top);
  T* __restrict__ xs = static_cast<T*>(p.xs);
  const bool timed = p.stamps != nullptr && rank == 0 && tid == 0;
  long long clk = timed ? clock64() : 0, clk0 = clk;
  const unsigned long long ns0 = timed ? global_ns() : 0;
  int e = 0;
  const auto stamp = [&] {
    if (timed) {
      const long long t = clock64();
      p.stamps[e++] += t - clk;
      clk = t;
    }
  };
  const auto mine = [&](int k) { return k < C || rank == 0; };
  const auto seg = [&](int k) {
    return p.blob + p.lv[k].base + static_cast<long long>(k < C ? rank : 0) * p.lv[k].seg;
  };

  // ---- prologue
  if (tid == 0) {
    for (int k = 0; k < K; ++k)
      if (p.lv[k].stage && mine(k)) mbar_init(&mbar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < K; ++k)
      if (p.lv[k].stage && mine(k))
        bulk_copy(smem + p.lv[k].st, seg(k), 4u * static_cast<unsigned>(p.lv[k].copy),
                  &mbar[k], rank);
  }
  for (int w = tid; w < 4 * K; w += nt)
    if (mine(w >> 2)) hdr[w >> 2][w & 3] = seg(w >> 2)[w & 3];
  // the staged values: each block runs its gather program (its cluster
  // levels), the cluster runs block 0's levels' program into block 0's
  // shared memory, sixteen loads a thread in flight (item: source << 26 |
  // index, then the element it fills; ops/amg_tail.py:programs)
  const auto source = [&](int id) -> const T* {
    if (id == 3 * TAIL_MAX_LEVELS) return rtop;
    const TailLevel& L = p.lv[id / 3];
    return static_cast<const T*>(id % 3 == 0 ? L.off : id % 3 == 1 ? L.diag : L.valid);
  };
  T* const vals = reinterpret_cast<T*>(smem);
  const auto run = [&](const int* prog, int n, int lo, int step, auto put) {
    constexpr int G = 16;
    const int2* items = reinterpret_cast<const int2*>(prog);
    for (int i = lo; i < n; i += G * step) {
      int2 w[G];
#pragma unroll
      for (int u = 0; u < G; ++u)
        w[u] = i + u * step < n ? items[i + u * step] : make_int2(0, -1);
      T v[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int id = static_cast<int>(static_cast<unsigned>(w[u].x) >> 26);
        const T* src = w[u].y >= 0 && id != TAIL_NO_SOURCE ? source(id) : nullptr;
        if (src)
          v[u] = src[w[u].x & ((1 << 26) - 1)];
        else
          w[u].y = -1;
      }
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (w[u].y >= 0) put(w[u].y, v[u]);
    }
  };
  const auto here = [&](int at, T v) { vals[at] = v; };
  const int* stretch = p.prog + 2 * TAIL_BLOCKS * p.prog_local;
  if (C >= 1) {
    // block 0's levels: this thread's first few values loaded before the
    // block's own gathers, stored into block 0 once every block runs
    constexpr int GR = 4;
    const int lo = static_cast<int>(rank) * nt + tid, step = TAIL_BLOCKS * nt;
    const int2* items = reinterpret_cast<const int2*>(stretch);
    int at[GR];
    T first[GR];
#pragma unroll
    for (int u = 0; u < GR; ++u) {
      const int i = lo + u * step;
      const int2 w = i < p.prog_stretch ? items[i] : make_int2(0, -1);
      const T* src = w.y >= 0 ? source(static_cast<int>(static_cast<unsigned>(w.x) >> 26))
                              : nullptr;
      at[u] = src ? w.y : -1;
      if (src) first[u] = src[w.x & ((1 << 26) - 1)];
    }
    run(p.prog + 2 * static_cast<long long>(rank) * p.prog_local, p.prog_local, tid, nt, here);
    stamp();
    cluster_wait();               // every block runs: the cluster stages block 0's levels
    stamp();
    const auto there = [&](int a, T v) { *cl.map_shared_rank(vals + a, 0u) = v; };
#pragma unroll
    for (int u = 0; u < GR; ++u)
      if (at[u] >= 0) there(at[u], first[u]);
    run(stretch, p.prog_stretch, lo + GR * step, step, there);
    stamp();
  } else {
    run(stretch, p.prog_stretch, tid, nt, here);
    const T* __restrict__ d0 = static_cast<const T*>(p.lv[0].diag);
    T* r0 = at_smem<T>(smem, p.lv[0].r);
    T* v0 = at_smem<T>(smem, p.lv[0].v);
    gather(tid, p.lv[0].n, nt, [](int i) { return i; },     // the top in block 0: r, s
           [&](int i) { return Term2<T>{rtop[i], d0[i]}; },
           [&](int i, Term2<T> v) {
             r0[i] = v.c;
             v0[i] = (omega * v.c) / v.a;
           });
  }
  if (C >= 1 && p.lv[0].stage) {  // the top's neighbours' s from their r and diag
    __syncthreads();
    const TailLevel& L = p.lv[0];
    const T* sr = at_smem<T>(smem, L.sr);
    const T* sdiag = at_smem<T>(smem, L.sdiag);
    T* ss = at_smem<T>(smem, L.ss);
    for (int u = tid; u < hdr[0][2]; u += nt) ss[u] = (omega * sr[u]) / sdiag[u];
  }
  if (C == 0) {                   // the prologue's parts all in one (no cluster)
    stamp();
    stamp();
    stamp();
  }
  __syncthreads();
  stamp();
  const auto ready = [&](int k) {
    if (p.lv[k].stage && mine(k))
      for (const long long t0 = clock64(); !mbar_done(&mbar[k]);)
        if (clock64() - t0 > TAIL_WAIT_CLOCKS) __trap();
  };

  // a row's own r and s on a level: the top's (staged or from global
  // memory), or the level's vectors
  const auto own_top = [&](const View<T>& F) {
    return [&F, rtop, omega](int i, T& r, T& s) {
      if (F.stage) {
        r = F.sr[i];
        s = F.ss[i];
      } else {
        const int g = F.grow[i];
        r = rtop[g];
        s = (omega * r) / F.diag[g];
      }
    };
  };
  const auto own_vec = [&](const View<T>& F) {
    return [&F](int i, T& r, T& s) {
      r = F.r[i];
      s = F.v[i];
    };
  };
  // body(cf, own, nbr) with level k's source accessors: the coefficients
  // (staging fixed), a row's own r and s, and term t's neighbour s
  const auto with_source = [&](int k, const View<T>& F, auto body) {
    with_coefs(F, [&](auto cf) {
      if (k == 0 && C >= 1) {
        if constexpr (decltype(cf)::staged)
          body(cf, own_top(F), [&F](int t) { return F.sv[F.tslot[t]]; });
        else
          body(cf, own_top(F), [&F, rtop, omega](int t) {
            const int j = F.addr[t];
            return (omega * rtop[j]) / F.diag[j];
          });
      } else if (k < C) {
        body(cf, own_vec(F), [&F, &cl](int t) { return fetch(cl, F.v, F.addr[t]); });
      } else {
        body(cf, own_vec(F), [&F](int t) { return F.v[F.addr[t]]; });
      }
    });
  };
  // x'' of row q of level k (view F) into the level below (view M), or into
  // x_out
  const auto expand = [&](int k, const View<T>& F, const View<T>& M, int q, T x) {
    if (k == 0) {
      static_cast<T*>(p.x_out)[F.grow[q]] = x;
      return;
    }
    const int a1 = F.poff[q + 1];
    if (k == C) {                 // block 0 into level P's rows, where they live
      const T* __restrict__ SP = at_smem<T>(smem, p.sp);
      const T* __restrict__ vP = static_cast<const T*>(p.lv[P].valid);
      T* xP = at_smem<T>(smem, p.lv[P].v);
      for (int a = F.poff[q]; a < a1; ++a) {
        const int j = F.pmem[a];
        const T xp = SP[j] + (vP ? x * (F.lvalid ? F.lvalid[j] : vP[j]) : x);
        if (P == 0)
          xs[j] = xp;
        else
          store_at(cl, xP, F.ldst[j], xp);
      }
      return;
    }
    const bool has_valid = p.lv[k - 1].valid != nullptr;
    for (int a = F.poff[q]; a < a1; ++a) {
      const int j = F.pmem[a];
      const T add = has_valid ? x * M.val(j) : x;
      if (k == 1 && C >= 2) {     // into the top's x' (global)
        const int g = M.grow[j];
        const T s = M.stage ? M.ss[j] : (omega * rtop[g]) / M.diag[g];
        xs[g] = s + add;
      } else {
        M.v[j] = M.v[j] + add;
      }
    }
  };
  // level k's restriction into this block's rows of level k + 1
  const auto down = [&](int k) {
    ready(k);
    ready(k + 1);
    const View<T> F = view<T>(p, k, rank, smem), Q = view<T>(p, k + 1, rank, smem);
    const int n = hdr[k + 1][0];
    with_source(k, F, [&](const auto& cf, auto own, auto nbr) {
      for (int q = tid; q < n; q += nt) {
        const T acc = restrict_row<T, B>(cf, F.toff, Q.mem, Q.moff[q], Q.moff[q + 1], own, nbr);
        Q.r[q] = acc;
        Q.v[q] = (omega * acc) / Q.d(q);
      }
    });
  };
  // level k's smoothing of this block's rows, each expanded below
  const auto up = [&](int k, auto nbr_of) {
    const View<T> F = view<T>(p, k, rank, smem);
    const View<T> M = view<T>(p, k > 0 ? k - 1 : 0, rank, smem);
    const auto nbr = nbr_of(F);
    with_coefs(F, [&](auto cf) {
      for (int q = tid; q < hdr[k][0]; q += nt) {
        const T x = k == 0 && C >= 1 ? __ldcg(xs + F.grow[q]) : F.v[q];
        const T r = k == 0 && C >= 1 ? (F.stage ? F.sr[q] : rtop[F.grow[q]]) : F.r[q];
        expand(k, F, M, q, smooth_row<T, B>(cf, F.toff, q, x, r, omega, nbr));
      }
    });
  };

  // ---- down the cluster levels
  for (int k = 0; k + 1 < C; ++k) {
    down(k);
    cluster_arrive();
    cluster_wait();
    stamp();
  }
  // ---- level P's r1 and s into block 0
  if (C >= 1) {
    ready(P);
    const View<T> F = view<T>(p, P, rank, smem);
    T* R1 = at_smem<T>(smem, p.r1);
    T* SP = at_smem<T>(smem, p.sp);
    with_source(P, F, [&](const auto& cf, auto own, auto nbr) {
      for (int q = tid; q < hdr[P][0]; q += nt) {
        const int i[2] = {q, q};
        T r1[2], r, s;
        residual2<T, B>(cf, F.toff, i, 1, own, nbr, r1);
        own(q, r, s);
        const int g = F.grow[q];
        *cl.map_shared_rank(R1 + g, 0u) = r1[0];
        *cl.map_shared_rank(SP + g, 0u) = s;
      }
    });
    cluster_arrive();
    cluster_wait();
    stamp();
  }
  // ---- block 0: level C .. the coarsest and back
  if (rank == 0) {
    if (C >= 1) {                 // level C from level P's r1
      ready(C);
      const View<T> Q = view<T>(p, C, rank, smem);
      const T* __restrict__ R1 = at_smem<T>(smem, p.r1);
      for (int q = tid; q < hdr[C][0]; q += nt) {
        T acc = T(0);
        for (int a = Q.moff[q]; a < Q.moff[q + 1]; ++a) acc = acc + R1[Q.mem[a]];
        Q.r[q] = acc;
        Q.v[q] = (omega * acc) / Q.d(q);
      }
      __syncthreads();
      stamp();
    }
    for (int k = C; k + 1 < K; ++k) {
      down(k);
      __syncthreads();
      stamp();
    }
    {                             // the coarsest: x = s, then the sweeps
      ready(K - 1);
      const View<T> Z = view<T>(p, K - 1, rank, smem);
      const int n = hdr[K - 1][0];
      T* xa = Z.v;
      T* xb = at_smem<T>(smem, p.xb);
      with_coefs(Z, [&](auto cf) {
        if (n <= nt) {
          // one row a thread, its first CT terms in registers; the sweeps
          // meet at a barrier of the warps that hold rows
          const int used = (n + 31) & ~31;
          if (tid < used) {
            const bool act = tid < n;
            const int t0 = act ? Z.toff[tid] : 0, t1 = act ? Z.toff[tid + 1] : 0;
            const int len = t1 - t0 < CT ? t1 - t0 : CT;
            const T r = act ? Z.r[tid] : T(0), d = act ? cf.d(tid) : T(1);
            T c[CT];
            int col[CT];
#pragma unroll
            for (int u = 0; u < CT; ++u) {
              c[u] = u < len ? cf.c(t0 + u) : T(0);
              col[u] = u < len ? Z.addr[t0 + u] : 0;
            }
            T* a = xa;
            T* b = xb;
            for (int s = 0; s < p.sweeps; ++s) {
              if (act) {
                T v[CT];
#pragma unroll
                for (int u = 0; u < CT; ++u) v[u] = a[col[u]];
                T acc = T(0);
#pragma unroll
                for (int u = 0; u < CT; ++u)
                  if (u < len) acc = acc + c[u] * v[u];
                for (int t = t0 + CT; t < t1; ++t) acc = acc + cf.c(t) * a[Z.addr[t]];
                const T x = a[tid];
                b[tid] = x + (omega * (r - (d * x + acc))) / d;
              }
              named_sync(1, used);
              T* tmp = a;
              a = b;
              b = tmp;
            }
          }
        } else {
          T* a = xa;
          T* b = xb;
          for (int s = 0; s < p.sweeps; ++s) {
            for (int q = tid; q < n; q += nt)
              b[q] = smooth_row<T, B>(cf, Z.toff, q, a[q], Z.r[q], omega,
                                      [&](int t) { return a[Z.addr[t]]; });
            __syncthreads();
            T* tmp = a;
            a = b;
            b = tmp;
          }
        }
      });
      __syncthreads();
      const T* res = p.sweeps & 1 ? xb : xa;
      const View<T> M = view<T>(p, K > 1 ? K - 2 : 0, rank, smem);
      for (int q = tid; q < n; q += nt) expand(K - 1, Z, M, q, res[q]);
      __syncthreads();
      if (K - 1 > C) stamp();
    }
    for (int k = K - 2; k >= C; --k) {
      up(k, [](const View<T>& F) { return [&F](int t) { return F.v[F.addr[t]]; }; });
      __syncthreads();
      if (k > C) stamp();
    }
  }
  if (C >= 1) {
    cluster_arrive();
    cluster_wait();
  }
  stamp();                        // the coarsest or block 0's last level up
  // ---- up the cluster levels; the top's x' from global memory, into x_out
  for (int k = P; k >= 1; --k) {
    up(k, [&](const View<T>& F) { return [&F, &cl](int t) { return fetch(cl, F.v, F.addr[t]); }; });
    cluster_arrive();
    cluster_wait();
    stamp();
  }
  if (C >= 1) {
    up(0, [&](const View<T>& F) { return [&F, xs](int t) { return __ldcg(xs + F.addr[t]); }; });
    stamp();
  }
  if (timed) {
    p.stamps[e] += static_cast<long long>(global_ns() - ns0);
    p.stamps[e + 1] += clock64() - clk0;
  }
}

inline int blocks(int n) { return (n + AMG_THREADS - 1) / AMG_THREADS; }

template <typename T>
int matvec(int n, int k, const void* off, const void* pos, const void* col, int nf,
           const void* diag, const void* upper, const void* lower, const void* x, void* y,
           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int*>(off);
  const auto* p = static_cast<const int*>(pos);
  const auto* c = static_cast<const int*>(col);
  const auto* d = static_cast<const T*>(diag);
  const auto* u = static_cast<const T*>(upper);
  const auto* l = static_cast<const T*>(lower);
  const auto* xx = static_cast<const T*>(x);
  auto* yy = static_cast<T*>(y);
  switch (k) {
    case 1: fv_matvec_kernel<T, 1><<<blocks(n), AMG_THREADS, 0, s>>>(n, o, p, c, nf, d, u, l, xx, yy); break;
    case 2: fv_matvec_kernel<T, 2><<<blocks(n), AMG_THREADS, 0, s>>>(n, o, p, c, nf, d, u, l, xx, yy); break;
    case 3: fv_matvec_kernel<T, 3><<<blocks(n), AMG_THREADS, 0, s>>>(n, o, p, c, nf, d, u, l, xx, yy); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int down(int nc, const void* aoff, const void* acell, const void* off, const void* pos,
         const void* col, int nf, const void* diag, const void* offc, const void* r, T omega,
         void* rc, void* stream) {
  amg_down_kernel<T><<<blocks(nc), AMG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      nc, static_cast<const int*>(aoff), static_cast<const int*>(acell),
      static_cast<const int*>(off), static_cast<const int*>(pos), static_cast<const int*>(col), nf,
      static_cast<const T*>(diag), static_cast<const T*>(offc), static_cast<const T*>(r), omega,
      static_cast<T*>(rc));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int up(int n, const void* off, const void* pos, const void* col, int nf, const void* diag,
       const void* offc, const void* r, T omega, const void* agg, const void* valid,
       const void* xc, void* x, void* stream) {
  amg_up_kernel<T><<<blocks(n), AMG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int*>(off), static_cast<const int*>(pos), static_cast<const int*>(col),
      nf, static_cast<const T*>(diag), static_cast<const T*>(offc), static_cast<const T*>(r),
      omega, static_cast<const int*>(agg), static_cast<const T*>(valid),
      static_cast<const T*>(xc), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

cudaLaunchConfig_t tail_config(int threads, int smem, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(TAIL_BLOCKS, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = TAIL_BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// once per device, outside any capture: allow the opt-in shared memory and
// the 16-block cluster, and say how many such clusters fit on the card at
// once (0: none, the wrapper raises)
template <typename T>
int tail_prepare(int threads, int smem, int* clusters) {
  const void* fn = reinterpret_cast<const void*>(amg_tail_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TAIL_SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = tail_config(threads, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, fn, &cfg));
}

template <typename T>
int tail(const void* params, int threads, int smem, void* stream) {
  if (threads < 32 || threads > TAIL_THREADS || smem < 0 || smem > TAIL_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const TailParams*>(params);
  if (p->levels < 1 || p->levels > TAIL_MAX_LEVELS || p->cluster < 0 ||
      p->cluster >= p->levels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      tail_config(threads, smem, static_cast<cudaStream_t>(stream), attr);
  void* args[] = {const_cast<void*>(params)};
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(amg_tail_kernel<T>), args);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

#define CPF_AMG_ENTRIES(SUFFIX, T)                                                              \
  extern "C" int cpf_fv_matvec_##SUFFIX(int n, int k, const void* off, const void* pos,        \
                                         const void* col, int nf, const void* diag,             \
                                         const void* upper, const void* lower, const void* x,   \
                                         void* y, void* stream) {                               \
    return cpf::matvec<T>(n, k, off, pos, col, nf, diag, upper, lower, x, y, stream);          \
  }                                                                                             \
  extern "C" int cpf_amg_down_##SUFFIX(int nc, const void* aoff, const void* acell,            \
                                        const void* off, const void* pos, const void* col,      \
                                        int nf, const void* diag, const void* offc,             \
                                        const void* r, T omega, void* rc, void* stream) {       \
    return cpf::down<T>(nc, aoff, acell, off, pos, col, nf, diag, offc, r, omega, rc, stream); \
  }                                                                                             \
  extern "C" int cpf_amg_up_##SUFFIX(int n, const void* off, const void* pos, const void* col, \
                                      int nf, const void* diag, const void* offc,               \
                                      const void* r, T omega, const void* agg,                  \
                                      const void* valid, const void* xc, void* x,               \
                                      void* stream) {                                           \
    return cpf::up<T>(n, off, pos, col, nf, diag, offc, r, omega, agg, valid, xc, x, stream);  \
  }                                                                                             \
  extern "C" int cpf_amg_tail_##SUFFIX(const void* params, int threads, int smem,              \
                                        void* stream) {                                         \
    return cpf::tail<T>(params, threads, smem, stream);                                         \
  }                                                                                             \
  extern "C" int cpf_amg_tail_prepare_##SUFFIX(int threads, int smem, void* clusters) {         \
    return cpf::tail_prepare<T>(threads, smem, static_cast<int*>(clusters));                    \
  }

CPF_AMG_ENTRIES(f32, float)
CPF_AMG_ENTRIES(f64, double)
