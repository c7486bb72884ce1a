// rare_kernel<T, L>: the rare stage of one particle sub-step (K7), for the
// layout L (common.cuh: LayoutTet, or LayoutPk for VertexVelocity, the XLA
// rare stage under ly=LAYOUT_PK: the same walk and reflection over the Pk
// table's rows, which keep A | Tinv at 0:12 and carry their neighbour codes
// at 24:28).
//
// Replaces the XLA rare stage of cudaparticlesfoam_tpu/ops/fused.py:
// _rare_stage / _rare_stage_packed (836, 921) with the lane resolver
// _make_run_lanes (795), the bounded walk _walk_mega (285, baryTetSearch,
// RTQuery.cu:35-90) and the multi-bounce reflection _reflect_mega (393,
// RTreflection, RTQuery.cu:109-186).  The plain version is
// ops/fused.py:rare_plain.
//
// One thread per lane over all n lanes; a lane whose pending flag is 0
// returns at once.  The TPU version sorted pending lanes into blocks and an
// arena (lax.sort compaction, several rounds); that only bought speed on a
// machine without per-lane control flow, and each pending lane is resolved
// exactly once either way, so the kernel needs no compaction and the host
// never waits for a count.
//
// Semantics kept from the JAX package: the walk runs max(2, max_hops) hops
// (two are unrolled there before its bounded loop); the re-walk after a
// bounce uses the default 50 hops, not max_hops; an absorbing face
// (bd_escape) ends the lane with tet = -(tet+1); a lane out of bounces keeps
// its non-negative exit tet; the active column is left untouched.
//
// What bounds it on the H100: divergence (pending lanes are ~1% of a warp's
// lanes at the slice's regime, and one deep walker holds its warp) and one
// random 80 B row load per hop.  Later work: compact pending lanes with a
// warp ballot, or fuse this stage into stream_kernel so a pending lane
// continues without a second pass over the mega.
#include "common.cuh"

namespace cpf {

// _walk_mega for one lane: returns the hosting tet, -(lastTet+1) on a domain
// exit, or the last tet when out of hops; `row` ends as the row of the last
// non-negative tet, `slot` as the last crossed face.
template <typename T, typename L>
__device__ void walk(const T* __restrict__ tab, T* row, int* tet, int* slot,
                     T px, T py, T pz, int max_hops) {
  *slot = 0;
  if (*tet < 0) return;
  const int bound = max_hops > 2 ? max_hops : 2;
  for (int h = 0; h < bound; ++h) {
    T w[4], wmin;
    bary(row, px, py, pz, w);
    const int s = argmin4(w, &wmin);
    if (wmin >= T(0)) return;
    const int code = code_of<T, L>(row, s);
    *slot = s;
    if (code < 0) {
      *tet = -(*tet + 1);
      return;
    }
    *tet = code;
    load_row<T, L>(tab + static_cast<long long>(code) * L::ROW_W, row);
  }
}

// _reflect_mega for one lane that the walk left at `*tet` (< 0 = wall hit).
template <typename T, typename L>
__device__ void reflect(const T* __restrict__ tab, T* row, T* p, T* v,
                        int* tet, int slot, const uint8_t* __restrict__ bd_escape,
                        int nbd, int max_bounces) {
  if (*tet >= 0) return;
  *tet = -(*tet + 1);  // the exit tet, whose row is cached
  int s = slot;
  for (int b = 0; b < max_bounces; ++b) {
    const int code_nbr = code_of<T, L>(row, s);
    if (code_nbr < 0 && nbd > 0) {
      int bd = -code_nbr - 1;
      bd = bd < nbd - 1 ? bd : nbd - 1;
      if (bd_escape[bd]) {  // absorbing (outlet) face
        *tet = -(*tet + 1);
        return;
      }
    }
    T gx, gy, gz;
    grad(row, s, &gx, &gy, &gz);
    T w[4];
    bary(row, p[0], p[1], p[2], w);
    const T wv = w[s];
    const T inv_g2 = T(1) / (gx * gx + gy * gy + gz * gz);
    const T f = T(2) * wv * inv_g2;
    p[0] = p[0] - f * gx;
    p[1] = p[1] - f * gy;
    p[2] = p[2] - f * gz;
    const T ug = v[0] * gx + v[1] * gy + v[2] * gz;
    const T fu = T(2) * ug * inv_g2;
    v[0] = v[0] - fu * gx;
    v[1] = v[1] - fu * gy;
    v[2] = v[2] - fu * gz;
    // re-walk the mirrored point from the exit tet
    int wtet = *tet, wslot;
    walk<T, L>(tab, row, &wtet, &wslot, p[0], p[1], p[2], MAX_HOPS_DEFAULT);
    if (wtet >= 0) {
      *tet = wtet;
      return;
    }
    *tet = -(wtet + 1);
    s = wslot;
  }
}

template <typename T, typename L>
__global__ void __launch_bounds__(THREADS)
rare_kernel(const T* __restrict__ tab, T* __restrict__ m,
            const uint8_t* __restrict__ pend,
            const uint8_t* __restrict__ bd_escape, long long n, int nbd,
            int max_hops, int max_bounces, int reflect_wall) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !pend[i]) return;
  T* me = m + i * L::WIDTH;
  T p[3] = {me[P0], me[P0 + 1], me[P0 + 2]};
  T v[3] = {me[V0], me[V0 + 1], me[V0 + 2]};
  int tet = static_cast<int>(me[TET]);
  T row[L::ROW_W];
  load_row<T, L>(me + ROW, row);
  int slot;
  walk<T, L>(tab, row, &tet, &slot, p[0], p[1], p[2], max_hops);
  if (reflect_wall) reflect<T, L>(tab, row, p, v, &tet, slot, bd_escape, nbd, max_bounces);
  me[P0] = p[0];
  me[P0 + 1] = p[1];
  me[P0 + 2] = p[2];
  me[V0] = v[0];
  me[V0 + 1] = v[1];
  me[V0 + 2] = v[2];
  me[TET] = static_cast<T>(tet);
#pragma unroll
  for (int k = 0; k < L::ROW_W; ++k) me[ROW + k] = row[k];
}

template <typename T, typename L = LayoutTet>
int launch_rare(const void* tab, void* m, const void* pend,
                const void* bd_escape, long long n, int nbd, int max_hops,
                int max_bounces, int reflect_wall, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  rare_kernel<T, L><<<static_cast<unsigned>(blocks), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tab), static_cast<T*>(m),
      static_cast<const uint8_t*>(pend), static_cast<const uint8_t*>(bd_escape),
      n, nbd, max_hops, max_bounces, reflect_wall);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

extern "C" int cpf_rare_f32(const void* tab, void* m, const void* pend,
                            const void* bd_escape, long long n, int nbd,
                            int max_hops, int max_bounces, int reflect_wall,
                            void* stream) {
  return cpf::launch_rare<float>(tab, m, pend, bd_escape, n, nbd, max_hops,
                                 max_bounces, reflect_wall, stream);
}

extern "C" int cpf_rare_f64(const void* tab, void* m, const void* pend,
                            const void* bd_escape, long long n, int nbd,
                            int max_hops, int max_bounces, int reflect_wall,
                            void* stream) {
  return cpf::launch_rare<double>(tab, m, pend, bd_escape, n, nbd, max_hops,
                                  max_bounces, reflect_wall, stream);
}

// The VertexVelocity instantiations: tab [nt, 32] (padded), m [n, 40].
extern "C" int cpf_rare_pk_f32(const void* tab, void* m, const void* pend,
                               const void* bd_escape, long long n, int nbd,
                               int max_hops, int max_bounces, int reflect_wall,
                               void* stream) {
  return cpf::launch_rare<float, cpf::LayoutPk>(tab, m, pend, bd_escape, n, nbd, max_hops,
                                                max_bounces, reflect_wall, stream);
}

extern "C" int cpf_rare_pk_f64(const void* tab, void* m, const void* pend,
                               const void* bd_escape, long long n, int nbd,
                               int max_hops, int max_bounces, int reflect_wall,
                               void* stream) {
  return cpf::launch_rare<double, cpf::LayoutPk>(tab, m, pend, bd_escape, n, nbd, max_hops,
                                                 max_bounces, reflect_wall, stream);
}
