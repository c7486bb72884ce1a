// The AMG-CG pressure solve's kernels: the matvec and the three level
// kernels of one V(1,1) cycle.  They replace no Pallas kernel: the JAX
// package leaves the solve to XLA, which fuses the matvec
// (cudaparticlesfoam_tpu/models/fv.py:420-431) and each level of
// amg_vcycle (:537-570) inside the CG's lax.while_loop.  Op by op in torch a
// V-cycle was ~309 launches; here it is 2L + 1 (L levels down, the coarsest,
// L up), and a CG iteration's matvec one more.
//
// Every sum into a row walks a row plan (ops/amg.py:RowPlan, CSR, int32):
// row i's terms offsets[i]..offsets[i+1] in the order fv.index_sum gives
// them (face order of the owner part, then of the neighbour part), summed
// from 0 left to right, then added to diag*x.  The expressions keep the
// plain versions' association, (omega*r)/d, d*x + acc, x + (omega*(r - Ax))/d,
// and the library is built --fmad=false, so each kernel equals its plain
// version (ops/amg.py) bit for bit.
//
// Bound: bytes.  One thread a row reads its plan entries, the coefficients
// and the neighbours' values (L2-resident at these sizes); a level kernel
// recomputes each neighbour's smoothed value in place, so no level writes a
// temporary: down writes the coarse residual, up the corrected x.  The
// coarsest level is one block: its 12 Jacobi sweeps are separated by
// __syncthreads, x ping-pongs between two buffers in shared memory where
// they fit (2 n elements within 48 KB) and in global memory where not.
#include <cuda_runtime.h>

namespace cpf {

constexpr int AMG_THREADS = 256;
constexpr int COARSEST_THREADS_MAX = 1024;
constexpr int COARSEST_SMEM_BYTES = 48 * 1024;

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

// the coarsest level, one block: x = omega r / d, then `sweeps` times
// x = x + (omega (r - A x)) / d; xa/xb in shared memory (kShared) or in x and
// scratch (global: written and read back across __syncthreads, so plain
// loads, not the read-only path)
template <typename T, bool kShared>
__global__ void __launch_bounds__(COARSEST_THREADS_MAX)
amg_coarsest_kernel(int n, const int* __restrict__ off, const int* __restrict__ pos,
                    const int* __restrict__ col, int nf, const T* __restrict__ diag,
                    const T* __restrict__ offc, const T* __restrict__ r, T omega, int sweeps,
                    T* x, T* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xa = kShared ? reinterpret_cast<T*>(smem) : x;
  T* xb = kShared ? xa + n : scratch;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xa[i] = smoothed(r, diag, omega, i);
  __syncthreads();
  for (int s = 0; s < sweeps; ++s) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      T acc = T(0);
      const int t1 = off[i + 1];
      for (int t = off[i]; t < t1; ++t) acc = acc + coef_at(offc, offc, pos[t], nf) * xa[col[t]];
      const T di = diag[i];
      xb[i] = xa[i] + (omega * (r[i] - (di * xa[i] + acc))) / di;
    }
    __syncthreads();
    T* tmp = xa;
    xa = xb;
    xb = tmp;
  }
  if (xa != x)
    for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = xa[i];
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

template <typename T>
int coarsest(int n, const void* off, const void* pos, const void* col, int nf, const void* diag,
             const void* offc, const void* r, T omega, int sweeps, void* x, void* scratch,
             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int threads = n >= COARSEST_THREADS_MAX ? COARSEST_THREADS_MAX : ((n + 31) / 32) * 32;
  const long long smem = 2LL * n * static_cast<long long>(sizeof(T));
  const auto* o = static_cast<const int*>(off);
  const auto* p = static_cast<const int*>(pos);
  const auto* c = static_cast<const int*>(col);
  const auto* d = static_cast<const T*>(diag);
  const auto* oc = static_cast<const T*>(offc);
  const auto* rr = static_cast<const T*>(r);
  if (smem <= COARSEST_SMEM_BYTES) {
    amg_coarsest_kernel<T, true><<<1, threads > 0 ? threads : 32, smem, s>>>(
        n, o, p, c, nf, d, oc, rr, omega, sweeps, static_cast<T*>(x), nullptr);
  } else {
    if (!scratch) return static_cast<int>(cudaErrorInvalidValue);
    amg_coarsest_kernel<T, false><<<1, threads, 0, s>>>(n, o, p, c, nf, d, oc, rr, omega, sweeps,
                                                       static_cast<T*>(x),
                                                       static_cast<T*>(scratch));
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
  extern "C" int cpf_amg_coarsest_##SUFFIX(int n, const void* off, const void* pos,            \
                                            const void* col, int nf, const void* diag,          \
                                            const void* offc, const void* r, T omega,           \
                                            int sweeps, void* x, void* scratch,                 \
                                            void* stream) {                                     \
    return cpf::coarsest<T>(n, off, pos, col, nf, diag, offc, r, omega, sweeps, x, scratch,    \
                            stream);                                                            \
  }

CPF_AMG_ENTRIES(f32, float)
CPF_AMG_ENTRIES(f64, double)
