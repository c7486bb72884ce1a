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
// Semantics kept from the JAX package: the walk runs max(2, max_hops) hops
// (two are unrolled there before its bounded loop); the re-walk after a
// bounce uses the default 50 hops, not max_hops; an absorbing face
// (bd_escape) ends the lane with tet = -(tet+1); a lane out of bounces keeps
// its non-negative exit tet; the active column is left untouched.
//
// What bounds it on the H100: latency, not bytes.  A pending lane is a
// dependent chain: its flag, its own mega row, then one table row per hop
// of the walk and of every re-walk after a bounce (ops/fused.py:rare_chain
// counts them; ops/traffic.py:latency_bound prices them with the latency
// of one dependent row load, measured by csrc/probe.cu).  The TPU version
// sorted pending lanes into blocks (lax.sort compaction) because it had no
// per-lane control flow; here the kernel compacts them itself, inside one
// wave of resident blocks (pending.cuh), so it lasts about the longest
// chain rather than one chain per wave of a grid over all n lanes.  Rows
// move as 16 B vectors (tile.cuh): the lane's head and cached row in and
// out, each table row of the walk in through the read-only path.  Each
// lane is still resolved by one thread with the same arithmetic, so the
// result is bit for bit that of the plain version.
//
// kRemote: the partitioned mesh's form (cudaparticlesfoam_tpu/parallel/
// partition.py:_make_run_lanes_remote, 392-443, and _reflect_mega's
// remote=(R0, per) branch, ops/fused.py:418-424).  A shard's table holds its
// slab of rows, in-shard neighbours as local ids and a tet g of another shard
// as the code -(R0 + 1 + g), R0 the boundary face count.  A lane whose walk
// exits through such a code, or whose re-walk after a bounce meets one (the
// test comes before the escape test), pauses: its tet becomes the sentinel
// -(per + g + 1) for migration, its point the one reached so far.  The
// instantiations with kRemote = false compile the code above unchanged.
#include "pending.cuh"
#include "walk.cuh"

namespace cpf {

// The migration sentinel of a lane paused at the remote code `code`.
__device__ __forceinline__ int remote_sentinel(int code, int R0, int per) {
  return -(per + (-code - R0 - 1) + 1);
}

// _reflect_mega for one lane that the walk left at `*tet` (< 0 = wall hit).
template <typename T, typename L, bool kRemote>
__device__ void reflect(const T* __restrict__ tab, T* row, T* p, T* v,
                        int* tet, int slot, const uint8_t* __restrict__ bd_escape,
                        int nbd, int max_bounces, int R0, int per) {
  if (*tet >= 0) return;
  *tet = -(*tet + 1);  // the exit tet, whose row is cached
  int s = slot;
  for (int b = 0; b < max_bounces; ++b) {
    const int code_nbr = code_of<T, L>(row, s);
    if (kRemote && code_nbr < -R0) {  // mid-bounce remote crossing: pause
      *tet = remote_sentinel(code_nbr, R0, per);
      return;
    }
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

template <typename T, typename L, bool kRemote>
__global__ void __launch_bounds__(THREADS)
rare_kernel(const T* __restrict__ tab, T* __restrict__ m,
            const uint8_t* __restrict__ pend,
            const uint8_t* __restrict__ bd_escape, long long n, int nbd,
            int max_hops, int max_bounces, int reflect_wall, int R0, int per) {
  for_each_pending(pend, n, [&](long long i) {
    T* me = m + i * L::WIDTH;
    T head[ROW];
    load_vec<T, ROW>(me, head);
    T p[3] = {head[P0], head[P0 + 1], head[P0 + 2]};
    T v[3] = {head[V0], head[V0 + 1], head[V0 + 2]};
    int tet = static_cast<int>(head[TET]);
    T row[L::ROW_W];
    load_vec<T, L::ROW_W>(me + ROW, row);
    int slot;
    walk<T, L>(tab, row, &tet, &slot, p[0], p[1], p[2], max_hops);
    bool paused = false;
    if (kRemote && tet < 0) {  // the walk left the slab through a remote code
      const int exit_code = code_of<T, L>(row, slot);
      if (exit_code < -R0) {
        tet = remote_sentinel(exit_code, R0, per);
        paused = true;
      }
    }
    if (reflect_wall && !paused) {
      reflect<T, L, kRemote>(tab, row, p, v, &tet, slot, bd_escape, nbd, max_bounces, R0, per);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      head[P0 + k] = p[k];
      head[V0 + k] = v[k];
    }
    head[TET] = static_cast<T>(tet);
    store_row_vec<T, ROW>(me, head);
    store_row_vec<T, L::ROW_W>(me + ROW, row);
  });
}

// The grid of one instantiation over n lanes (pending.cuh), its resident
// block count cached per device.
template <typename T, typename L, bool kRemote>
cudaError_t rare_grid(long long n, int* blocks) {
  static int cache[MAX_DEVICES] = {};
  return pending_grid(rare_kernel<T, L, kRemote>, n, cache, blocks);
}

template <typename T, typename L = LayoutTet, bool kRemote = false>
int launch_rare(const void* tab, void* m, const void* pend,
                const void* bd_escape, long long n, int nbd, int max_hops,
                int max_bounces, int reflect_wall, void* stream, int R0 = 0, int per = 0) {
  if (n <= 0) return 0;
  int blocks = 0;
  const cudaError_t err = rare_grid<T, L, kRemote>(n, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  rare_kernel<T, L, kRemote><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tab), static_cast<T*>(m),
      static_cast<const uint8_t*>(pend), static_cast<const uint8_t*>(bd_escape),
      n, nbd, max_hops, max_bounces, reflect_wall, R0, per);
  return static_cast<int>(cudaGetLastError());
}

// Blocks the launch over n lanes would use, or -(cuda error).
template <typename T, typename L>
int grid_or_error(long long n) {
  int blocks = 0;
  const cudaError_t err = rare_grid<T, L, false>(n, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
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

extern "C" int cpf_rare_grid_f32(long long n) { return cpf::grid_or_error<float, cpf::LayoutTet>(n); }
extern "C" int cpf_rare_grid_f64(long long n) { return cpf::grid_or_error<double, cpf::LayoutTet>(n); }
extern "C" int cpf_rare_grid_pk_f32(long long n) { return cpf::grid_or_error<float, cpf::LayoutPk>(n); }
extern "C" int cpf_rare_grid_pk_f64(long long n) { return cpf::grid_or_error<double, cpf::LayoutPk>(n); }

// The partitioned mesh's instantiations (kRemote): R0 boundary faces, per
// tets a shard; tab is the shard's slab, [per, 20] or, with _pk, [per, 32].
#define CPF_RARE_REMOTE(NAME, T, L)                                                      \
  extern "C" int NAME(const void* tab, void* m, const void* pend, const void* bd_escape, \
                      long long n, int nbd, int max_hops, int max_bounces,              \
                      int reflect_wall, int R0, int per, void* stream) {                \
    return cpf::launch_rare<T, L, true>(tab, m, pend, bd_escape, n, nbd, max_hops,       \
                                        max_bounces, reflect_wall, stream, R0, per);     \
  }
CPF_RARE_REMOTE(cpf_rare_remote_f32, float, cpf::LayoutTet)
CPF_RARE_REMOTE(cpf_rare_remote_f64, double, cpf::LayoutTet)
CPF_RARE_REMOTE(cpf_rare_remote_pk_f32, float, cpf::LayoutPk)
CPF_RARE_REMOTE(cpf_rare_remote_pk_f64, double, cpf::LayoutPk)
