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
// of 16 blocks, each phase (a level down, the coarsest's sweeps, a level up)
// separated from the next by a cluster barrier instead of a kernel boundary,
// each small level's r and x in the cluster's distributed shared memory.
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
// dynamic shared memory of a block: the opt-in 227 KB (232,448 B) less the
// level table every block copies (16 x 96 B)
constexpr int TAIL_SMEM_MAX = 230912;

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

// One level of the tail as ops/amg_cuda.py:TailLevel fills it: the row
// plan and operator, the restriction onto the next level and the
// prolongation from it (null on the coarsest), and where the level's r and
// x live.  Row i of a level lives in block i >> shift at element
// i & ((1 << shift) - 1) of the block's copy of the vector (shift 31: every
// row in block 0).
struct TailLevel {
  const int* off;
  const int* pos;
  const int* col;
  const void* diag;
  const void* offc;
  const int* aoff;
  const int* acell;
  const int* agg;
  const void* valid;
  int n;
  int nf;
  int shift;
  int r_at;   // element offset of r (the levels below the tail's top)
  int x_at;   // of x (below the top; the coarsest's first sweep buffer)
  int pad;
};

// the tail, passed by value (__grid_constant__: no device table to upload,
// so a CUDA graph captures it whole); ops/amg_cuda.py:TailParams
struct TailParams {
  const void* r_top;   // the top level's r (global, read only)
  void* x_out;         // the top level's x (global)
  double omega;
  int levels;
  int sweeps;
  int xb_at;           // the coarsest's second sweep buffer
  int stage;           // the coarsest's plan and diag copied into block 0's shared memory
  int st_diag;         // where (bytes): diag [n], each term's coefficient and column,
  int st_coef;         // the row offsets [n + 1]
  int st_col;
  int st_off;
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
// coefficient and the values the term reads) are issued before any of
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

// what a term of the tail's rows reads
template <typename T>
struct Term2 {
  T c, a;
};
template <typename T>
struct Term3 {
  T c, r, d;
};
template <typename T>
struct Term5 {
  T c, r, d, xc, v;
};

// a vector of one tail level: in global memory (the top level's r and x;
// x is written inside the kernel, so read at L2 with ld.global.cg, never
// through the read-only path), or spread over the cluster's shared memory,
// a row read from its owner's block
template <typename T>
struct TailVec {
  T* base;      // this block's copy, or the global array
  int shift;
  bool flat;

  __device__ __forceinline__ T* own(int i) const {
    return flat ? base + i : base + (i & ((1u << shift) - 1u));
  }
  // a row of this block's own
  __device__ __forceinline__ T load_own(int i) const { return flat ? __ldcg(base + i) : *own(i); }
  __device__ __forceinline__ T load(const cg::cluster_group& cl, int i) const {
    if (flat) return __ldcg(base + i);
    return *cl.map_shared_rank(base + (i & ((1u << shift) - 1u)), static_cast<unsigned>(i >> shift));
  }
};

// [lo, hi): the rows of an n-row level that block `rank` owns
__device__ __forceinline__ void owned(int n, int shift, unsigned rank, int& lo, int& hi) {
  if (shift >= 31) {
    lo = rank ? n : 0;
    hi = n;
    return;
  }
  const long long a = static_cast<long long>(rank) << shift;
  lo = a < n ? static_cast<int>(a) : n;
  hi = a + (1LL << shift) < n ? static_cast<int>(a + (1LL << shift)) : n;
}

// The static part of a row's work in the tail (indices, diag, the
// prolongation's index and valid), which a thread loads for its first row
// of the next phase while the cluster barrier that ends this phase
// completes: a restriction row c (its first two fine rows i, their term
// ranges and diag) or a level row i.
template <typename T>
struct TailRow {
  int a0, a1;      // a restriction row's fine rows acell[a0 .. a1)
  int i[2];        // the row(s)
  int t0[2], t1[2];
  T d[2];
  int ag;          // the prolongation's index of row i
  T v;             // and its valid (1 without)
};

// fine rows a and a + 1 (those below a1) of a restriction row: their
// indices, diag and term ranges; a missing second row repeats the first
// with no terms
template <typename T>
__device__ __forceinline__ void members(const TailLevel& F, int a, int a1, TailRow<T>& w) {
  const T* __restrict__ diag = static_cast<const T*>(F.diag);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (a + q < a1) {
      w.i[q] = F.acell[a + q];
      w.d[q] = diag[w.i[q]];
      w.t0[q] = F.off[w.i[q]];
      w.t1[q] = F.off[w.i[q] + 1];
    } else {
      w.i[q] = q ? w.i[0] : 0;
      w.d[q] = q ? w.d[0] : T(1);
      w.t0[q] = w.t1[q] = 0;
    }
  }
}

// restriction row c of level k onto k + 1
template <typename T>
__device__ __forceinline__ TailRow<T> down_row(const TailLevel& F, int c) {
  TailRow<T> w;
  w.a0 = F.aoff[c];
  w.a1 = F.aoff[c + 1];
  members<T>(F, w.a0, w.a1, w);
  return w;
}

// level row i on the way up
template <typename T>
__device__ __forceinline__ TailRow<T> up_row(const TailLevel& F, int i) {
  TailRow<T> w;
  w.i[0] = i;
  w.t0[0] = F.off[i];
  w.t1[0] = F.off[i + 1];
  w.d[0] = static_cast<const T*>(F.diag)[i];
  w.ag = F.agg[i];
  w.v = F.valid ? static_cast<const T*>(F.valid)[i] : T(1);
  return w;
}

// the cluster barrier in two halves (release, then acquire at cluster scope)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// the coarsest level in one block: x = omega r / d, then `sweeps` times
// x = x + (omega (r - A x)) / d, xa/xb swapped across __syncthreads; the
// result is left in xa.  off/col/coef/diag are block 0's staged copies or
// the level's own arrays; a thread keeps its first row's r, diag and term
// range in registers over the sweeps.
template <typename T, int B, typename Coef>
__device__ void coarsest_sweeps(int n, const int* off, const int* col, Coef coef, const T* diag,
                                const TailVec<T>& r, T* xa, T* xb, T omega, int sweeps) {
  const auto product = [](const Term2<T>& v) { return v.c * v.a; };
  const int i0 = threadIdx.x;
  const bool mine = i0 < n;
  const T r0 = mine ? r.load_own(i0) : T(0), d0 = mine ? diag[i0] : T(1);
  const int u0 = mine ? off[i0] : 0, u1 = mine ? off[i0 + 1] : 0;
  for (int i = i0; i < n; i += blockDim.x) xa[i] = (omega * (i == i0 ? r0 : r.load_own(i))) /
                                                   (i == i0 ? d0 : diag[i]);
  __syncthreads();
  T* a = xa;
  T* b = xb;
  for (int s = 0; s < sweeps; ++s) {
    for (int i = i0; i < n; i += blockDim.x) {
      const bool first = i == i0;
      const int t0[1] = {first ? u0 : off[i]}, t1[1] = {first ? u1 : off[i + 1]};
      T acc[1];
      row_sums<T, 1, B>(t0, t1, acc, [&](int t) { return Term2<T>{coef(t), a[col[t]]}; },
                        product);
      const T di = first ? d0 : diag[i];
      const T ri = first ? r0 : r.load_own(i);
      b[i] = a[i] + (omega * (ri - (di * a[i] + acc[0]))) / di;
    }
    __syncthreads();
    T* tmp = a;
    a = b;
    b = tmp;
  }
  if (a != xa) {
    for (int i = i0; i < n; i += blockDim.x) xa[i] = a[i];
    __syncthreads();
  }
}

// The small levels of one V-cycle and the coarsest, one launch of one
// cluster: for each level k below the top, amg_down_kernel's rc into level
// k + 1's r; the coarsest's sweeps in block 0; for each level back up,
// amg_up_kernel's x'' (into x_out at the top).  A cluster barrier
// (release/acquire at cluster scope) ends every phase, the last one too, so
// that no block leaves while another still reads its shared memory; between
// its two halves each thread loads the static part of its first row of the
// next phase.
template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
amg_tail_kernel(const __grid_constant__ TailParams p) {
  constexpr int B = tail_batch<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ TailLevel lv[TAIL_MAX_LEVELS];    // the level table, read at every phase
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int tid = static_cast<int>(threadIdx.x);
  const int K = p.levels;
  {
    const int* src = reinterpret_cast<const int*>(p.lv);
    int* dst = reinterpret_cast<int*>(lv);
    const int words = K * static_cast<int>(sizeof(TailLevel) / sizeof(int));
    for (int w = tid; w < words; w += blockDim.x) dst[w] = src[w];
  }
  T* store = reinterpret_cast<T*>(smem);
  const T omega = static_cast<T>(p.omega);
  const TailLevel& C = p.lv[K - 1];
  T* st_diag = reinterpret_cast<T*>(smem + p.st_diag);
  T* st_coef = reinterpret_cast<T*>(smem + p.st_coef);
  int* st_col = reinterpret_cast<int*>(smem + p.st_col);
  int* st_off = reinterpret_cast<int*>(smem + p.st_off);
  __syncthreads();
  // block 0 copies the coarsest's read-only data into its shared memory, in
  // the window of the first cluster barrier where a level is above it
  auto stage = [&] {
    if (!p.stage || rank != 0) return;
    const T* __restrict__ offc = static_cast<const T*>(C.offc);
    const int nnz = C.off[C.n];
    for (int i = tid; i <= C.n; i += blockDim.x) st_off[i] = C.off[i];
    for (int i = tid; i < C.n; i += blockDim.x) st_diag[i] = static_cast<const T*>(C.diag)[i];
    for (int t = tid; t < nnz; t += blockDim.x) {
      st_col[t] = C.col[t];
      st_coef[t] = coef_at(offc, offc, C.pos[t], C.nf);
    }
  };
  auto r_of = [&](int k) {
    if (k == 0) return TailVec<T>{const_cast<T*>(static_cast<const T*>(p.r_top)), 0, true};
    return TailVec<T>{store + lv[k].r_at, lv[k].shift, false};
  };
  auto x_of = [&](int k) {
    if (k == 0 && K > 1) return TailVec<T>{static_cast<T*>(p.x_out), 0, true};
    return TailVec<T>{store + lv[k].x_at, lv[k].shift, false};
  };
  // the first row of this thread on a level of n rows split by `shift`
  auto first = [&](int n, int shift, int& lo, int& hi) {
    owned(n, shift, rank, lo, hi);
    return lo + tid;
  };
  // the static part of this thread's first row of phase `ph` (0 .. K - 2
  // down, K - 1 the coarsest, then up)
  auto prefetch = [&](int ph) {
    TailRow<T> w{};
    int lo, hi;
    if (ph < K - 1) {
      const int c = first(lv[ph + 1].n, lv[ph + 1].shift, lo, hi);
      if (c < hi) w = down_row<T>(lv[ph], c);
    } else if (ph > K - 1 && ph <= 2 * K - 2) {
      const TailLevel& F = lv[2 * K - 2 - ph];
      const int i = first(F.n, F.shift, lo, hi);
      if (i < hi) w = up_row<T>(F, i);
    }
    return w;
  };
  TailRow<T> pre = prefetch(0);
  // down: rc[c] = sum over fine rows i of aggregate c of
  // r[i] - (d[i] x[i] + sum_row off*x[j]), x = omega r / d
  for (int k = 0; k + 1 < K; ++k) {
    const TailLevel& F = lv[k];
    const int* __restrict__ pos = F.pos;
    const int* __restrict__ col = F.col;
    const T* __restrict__ diag = static_cast<const T*>(F.diag);
    const T* __restrict__ offc = static_cast<const T*>(F.offc);
    const int nf = F.nf;
    const TailVec<T> r = r_of(k), rc = r_of(k + 1);
    const auto load = [&](int t) {
      const int j = col[t];
      return Term3<T>{coef_at(offc, offc, pos[t], nf), r.load(cl, j), diag[j]};
    };
    const auto term = [&](const Term3<T>& v) { return v.c * ((omega * v.r) / v.d); };
    int lo, hi;
    for (int c = first(lv[k + 1].n, lv[k + 1].shift, lo, hi); c < hi; c += blockDim.x) {
      TailRow<T> w = c == lo + tid ? pre : down_row<T>(F, c);
      T acc = T(0);
      // the aggregate's fine rows two at a time, their sums in lockstep
      for (int a = w.a0; a < w.a1; a += 2) {
        if (a != w.a0) members<T>(F, a, w.a1, w);     // a third fine row and on
        const int m = w.a1 - a < 2 ? w.a1 - a : 2;
        T ri[2], s[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) ri[q] = r.load(cl, w.i[q]);
        row_sums<T, 2, B>(w.t0, w.t1, s, load, term);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (q < m) acc = acc + (ri[q] - (w.d[q] * ((omega * ri[q]) / w.d[q]) + s[q]));
      }
      *rc.own(c) = acc;
    }
    cluster_arrive();
    pre = prefetch(k + 1);
    if (k == 0) stage();
    cluster_wait();
  }
  // the coarsest, in block 0 (its staged copy: written by block 0 before the
  // last cluster barrier, or, with no level above it, before this one)
  if (K == 1) stage();
  if (rank == 0) {
    __syncthreads();
    if (p.stage) {
      coarsest_sweeps<T, B>(C.n, st_off, st_col, [&](int t) { return st_coef[t]; }, st_diag,
                            r_of(K - 1), store + C.x_at, store + p.xb_at, omega, p.sweeps);
    } else {
      const T* __restrict__ offc = static_cast<const T*>(C.offc);
      const int* __restrict__ pos = C.pos;
      const int nf = C.nf;
      coarsest_sweeps<T, B>(C.n, C.off, C.col,
                            [&](int t) { return coef_at(offc, offc, pos[t], nf); },
                            static_cast<const T*>(C.diag), r_of(K - 1), store + C.x_at,
                            store + p.xb_at, omega, p.sweeps);
    }
    if (K == 1) {
      T* out = static_cast<T*>(p.x_out);
      for (int i = tid; i < C.n; i += blockDim.x) out[i] = store[C.x_at + i];
    }
  }
  cluster_arrive();
  pre = prefetch(K);
  cluster_wait();
  // up: x' = omega r / d + xc[agg] (times valid on a shard), then
  // x'' = x' + (omega (r - (d x' + sum_row off*x'[j]))) / d
  for (int k = K - 2; k >= 0; --k) {
    const TailLevel& F = lv[k];
    const int* __restrict__ pos = F.pos;
    const int* __restrict__ col = F.col;
    const int* __restrict__ agg = F.agg;
    const T* __restrict__ valid = static_cast<const T*>(F.valid);
    const T* __restrict__ diag = static_cast<const T*>(F.diag);
    const T* __restrict__ offc = static_cast<const T*>(F.offc);
    const int nf = F.nf;
    const TailVec<T> r = r_of(k), xc = x_of(k + 1), x = x_of(k);
    // x' of a row from what it reads: omega r / d + xc[agg] (times valid)
    const auto prolonged = [&](T rj, T dj, T xcj, T vj) {
      return (omega * rj) / dj + (valid ? xcj * vj : xcj);
    };
    const auto load = [&](int t) {
      const int j = col[t];
      return Term5<T>{coef_at(offc, offc, pos[t], nf), r.load(cl, j), diag[j],
                      xc.load(cl, agg[j]), valid ? valid[j] : T(0)};
    };
    const auto term = [&](const Term5<T>& v) { return v.c * prolonged(v.r, v.d, v.xc, v.v); };
    int lo, hi;
    for (int i = first(F.n, F.shift, lo, hi); i < hi; i += blockDim.x) {
      const TailRow<T> w = i == lo + tid ? pre : up_row<T>(F, i);
      const T ri = r.load_own(i);
      const T di = w.d[0];
      const T xi = prolonged(ri, di, xc.load(cl, w.ag), w.v);
      const int t0[1] = {w.t0[0]}, t1[1] = {w.t1[0]};
      T s[1];
      row_sums<T, 1, B>(t0, t1, s, load, term);
      *x.own(i) = xi + (omega * (ri - (di * xi + s[0]))) / di;
    }
    cluster_arrive();
    pre = prefetch(2 * K - 1 - k);
    cluster_wait();
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
  if (p->levels < 1 || p->levels > TAIL_MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
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
