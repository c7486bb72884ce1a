// stream_kernel<T, kPhilox, kPass, L>: the stream section of one particle
// sub-step (K1 + K2, and the compacted stage of K3), for the layout L.
//
// Replaces the TPU stream kernels of cudaparticlesfoam_tpu/ops/fused_pallas.py:
// kernel A (_kernel_a / _kernel_a_packed: advect, kick, move, hop-0 test,
// neighbour select), the XLA row gather between kernels, kernel B
// (_kernel_b / _kernel_b_packed: re-test, inline bounce, assembly, pending)
// and the multi-hop chain (_kernel_a_mh / _kernel_a_mh_packed, _kernel_h,
// _kernel_b2 / _kernel_b2_packed).  Semantics are those of the jnp engine,
// cudaparticlesfoam_tpu/ops/fused.py:616-790; the plain version is
// ops/fused.py:stream_plain.  The kPhilox instantiation draws its Brownian
// normals itself (philox.cuh, noise_mode 1 at the C entry): the
// in-kernel-noise twins _kernel_a_k / _kernel_a_packed_k / _kernel_a_mh_k /
// _kernel_a_mh_packed_k.
//
// The kCrossers / kAdmitted passes (stream.cuh) are the block-compacted hop
// gather of hop_compact=4: _kernel_b_packed_c (_b_compute_c) with its staging
// (_compact_hop_rows, _kernel_src_c).  The TPU staged two neighbour rows per
// admitted 4-lane group because its gather cost per index; here each lane
// loads its own row, so what is kept is the semantics, the admission: the
// flag pass writes each lane's hop-0 crossing flag, hop_admit_kernel
// (hop_admit.cu) admits groups and ranks, and the apply pass recomputes the
// sub-step (bit for bit, --fmad=false) and lets only admitted crossers hop.
//
// One thread per lane.  Mosaic could not gather, so the TPU split the cycle
// at every hop and staged rows through the packed/transposed layouts and a
// grouped lane order; a GPU thread loads its neighbour's 80-byte row
// itself, so all of that is one kernel over the natural row-major mega.
//
// What bounds it on the H100: bytes.  Per lane the whole pass reads the
// 128 B mega row and 12 B of xi (none with Philox) and writes the 32 B head
// and a pending byte, plus one 80 B table row read per hop and written back
// per lane that hopped: about 193 MB at the 1M-lane slice with xi (12.8% of
// lanes hop), a bound of 0.058 ms at 3.35 TB/s (ops/traffic.py counts it
// from the run's hop counts).  Design: a block of Tile<T>::LANES lanes
// (tile.cuh; 256 for float) stages its rows through a 32 KB swizzled shared
// tile with 16 B coalesced loads, so every warp access of the mega is whole
// 128 B lines; each thread reads its head and cached row from the tile as
// 16 B chunks and runs the sub-step (expressions unchanged, --fmad=false).
// The new heads go back into the tile and the block writes the head chunks
// (columns 0:8, whole 32 B sectors) out coalesced; a lane that hopped
// stores its new row itself as five 16 B vectors.  The other rows are left
// as they were, and so is the pad (columns 28:32), which pack_state zeroes
// and no kernel writes.  Neighbour rows come through the read-only path as
// five 16 B vectors, and the row's slots are picked by selects (common.cuh:
// pick4), so the row stays in registers.  The kCrossers pass stages in and
// writes only its flag byte.  Measured times are in PERF.md; the earlier
// design (32 scalar accesses per lane row, every warp access touching 32
// lines 128 B apart, the row in local memory) took 0.60 ms on an H100.
// Later work: the random row load per hop (row table 80 MB at 1M tets,
// above the 50 MB L2), and fusing the rare stage in.
//
// L = LayoutPk (VertexVelocity; common.cuh) is the ly=LAYOUT_PK
// instantiation of the same TPU kernels (fused_pallas._a_compute :259-268,
// _b_core under ly): the advecting velocity is the barycentric blend of the
// cached row's 4 vertex velocities at the lane's current position, taken
// before the move, and the hops, the bounce and the absorb read the Pk
// row's columns.  Only the whole pass exists for it (the JAX package keeps
// the compacted hop gather to TetVelocity).  Bytes per lane: the 160 B mega
// row (float32), xi, the head and the flag, and a 128 B padded table row per
// hop, read and written back.  Its rows are 10 chunks wide, so its tile is
// pitched instead of xor-swizzled and holds 160 lanes of float or 96 of
// double (tile.cuh); the rest of the design is the one above.
//
// kRK4 = true is the RK4 integrator, both layouts, the whole pass only.  It
// replaces XLA code of the JAX package, not a Pallas body (fused_pallas's
// supported() and packed_supported() keep RK4 off the TPU kernels):
// fused._stage_velocity (fused.py:515-584) and the RK4 branch of
// _mega_cycle_aligned (:630-650).  The TPU version sorted the lanes whose
// stage point leaves their cell into an arena and walked them in rounds of a
// while_loop; here each thread walks its own lane's stage point (walk.cuh,
// the rare kernel's walk), so there is no sort, no arena, no round loop and
// no host sync, and a cycle stays two launches.  Each of the three stages
// starts from the lane's cached row as the tile holds it (a second row
// buffer; the cached row the move needs stays in registers) and never
// changes the lane's cached row.  What it adds to the bytes: one table row
// per hop of a stage walk (ops/traffic.py, stage_rows); 1-2 hops are
// typical and 50 the bound, so a warp waits for its longest walk.  The
// kRK4 = false instantiations are the code they were before it existed.
#include "stream.cuh"
#include "walk.cuh"

namespace cpf {

// min with NaN propagation (torch.minimum / jnp.minimum)
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// fused._stage_velocity for one lane (ops/fused.py:stage_velocity): the
// velocity `k` at stage point (qx, qy, qz).  The hop-0 test on the lane's
// cached row (tile row r); a live lane that fails it walks from its cached
// tet with the default 50 hops and takes the velocity of the tet it ends in;
// a walk that leaves the domain, and a lane that does not walk, keeps the
// own row's velocity at the stage point (under LayoutPk its blend there).
template <typename T, typename L, typename TL>
__device__ __forceinline__ void stage_velocity(const T* __restrict__ tab,
                                               const typename TL::V* tile, int r, int tet,
                                               bool live, T qx, T qy, T qz, T k[3]) {
  T srow[L::ROW_W];
  TL::template read<ROW, L::ROW_W>(tile, r, srow);
  row_velocity<T, L>(srow, qx, qy, qz, k);
  T w[4];
  bary(srow, qx, qy, qz, w);
  const T wmin = nan_min(nan_min(w[0], w[1]), nan_min(w[2], w[3]));
  if (live && wmin < T(0)) {
    int t = tet, slot;
    walk<T, L>(tab, srow, &t, &slot, qx, qy, qz, MAX_HOPS_DEFAULT);
    if (t >= 0) row_velocity<T, L>(srow, qx, qy, qz, k);
  }
}

// The classical RK4 velocity of a lane at p0 from its k1 `u` (fused.py:
// 630-650, arithmetic order kept): stages at p0 + dt/2 k1, p0 + dt/2 k2 and
// p0 + dt k3, then u = (((k1 + 2 k2) + 2 k3) + k4) / 6.
template <typename T, typename L, typename TL>
__device__ __forceinline__ void rk4_velocity(const T* __restrict__ tab,
                                             const typename TL::V* tile, int r, int tet,
                                             bool live, const T p0[3], T dt, T u[3]) {
  const T half = T(0.5) * dt;
  T k2[3], k3[3], k4[3];
  stage_velocity<T, L, TL>(tab, tile, r, tet, live, p0[0] + half * u[0], p0[1] + half * u[1],
                           p0[2] + half * u[2], k2);
  stage_velocity<T, L, TL>(tab, tile, r, tet, live, p0[0] + half * k2[0],
                           p0[1] + half * k2[1], p0[2] + half * k2[2], k3);
  stage_velocity<T, L, TL>(tab, tile, r, tet, live, p0[0] + dt * k3[0], p0[1] + dt * k3[1],
                           p0[2] + dt * k3[2], k4);
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = (((u[c] + T(2) * k2[c]) + T(2) * k3[c]) + k4[c]) / T(6);
}

template <typename T, bool kPhilox, int kPass, typename L = LayoutTet, bool kRK4 = false>
__global__ void __launch_bounds__(Tile<T, L>::LANES)
stream_kernel(const T* __restrict__ tab, T* __restrict__ m,
              const T* __restrict__ xi, uint8_t* __restrict__ pend,
              uint8_t* __restrict__ adm, long long n, T dt, T sigma, int use_adv,
              int use_brown, int bounce_on, int esc_on, int n_hops, PhiloxKey key) {
  using TL = Tile<T, L>;
  constexpr int WIDTH = L::WIDTH, ROW_W = L::ROW_W;
  __shared__ typename TL::V tile[TL::LANES * TL::PITCH];
  const long long base = static_cast<long long>(blockIdx.x) * TL::LANES;
  const int rows = static_cast<int>(n - base < TL::LANES ? n - base : TL::LANES);
  T* blk = m + base * WIDTH;
  TL::stage_in(tile, blk, rows);

  const int r = threadIdx.x;
  if (r < rows) {
    const long long i = base + r;
    T hd[ROW];  // pos, vel, tet, active
    TL::template read<0, ROW>(tile, r, hd);
    T row[ROW_W];
    TL::template read<ROW, ROW_W>(tile, r, row);

    const int tet = static_cast<int>(hd[TET]);
    const bool act = hd[ACT] > T(0.5);
    const bool alive = use_adv ? (act && tet >= 0) : act;
    const T alf = alive ? T(1) : T(0);
    T u[3];
    row_velocity<T, L>(row, hd[P0], hd[P0 + 1], hd[P0 + 2], u);
    if constexpr (kRK4) {
      static_assert(kPass == kWhole, "the RK4 stream has the whole pass only");
      if (use_adv) rk4_velocity<T, L, TL>(tab, tile, r, tet, alive && tet >= 0, hd, dt, u);
    }
    const T ux = u[0], uy = u[1], uz = u[2];
    T dx, dy, dz, vx, vy, vz;
    if (use_adv) {
      dx = alf * ux * dt;
      dy = alf * uy * dt;
      dz = alf * uz * dt;
      // advected velocity into vel columns (particles.cu:361)
      vx = alive ? ux : hd[V0];
      vy = alive ? uy : hd[V0 + 1];
      vz = alive ? uz : hd[V0 + 2];
    } else {
      dx = dy = dz = T(0);
      vx = hd[V0];
      vy = hd[V0 + 1];
      vz = hd[V0 + 2];
    }
    if (use_brown) {
      T z[3];
      lane_normals<T, kPhilox>(key, xi, i, z);
      dx = dx + alf * sigma * z[0];
      dy = dy + alf * sigma * z[1];
      dz = dz + alf * sigma * z[2];
    }
    // advect kill (particles.cu:333-338)
    const T actf = use_adv ? alf : hd[ACT];

    const T px = hd[P0] + dx;
    const T py = hd[P0 + 1] + dy;
    const T pz = hd[P0 + 2] + dz;

    T w[4], wmin;
    bary(row, px, py, pz, w);
    const int s_cur = argmin4(w, &wmin);
    const bool unresolved = (wmin < T(0)) && (tet >= 0);
    if constexpr (kPass == kCrossers) {
      adm[i] = (unresolved && code_of<T, L>(row, s_cur) >= 0) ? 1 : 0;
    } else {
      const bool admitted = kPass != kAdmitted || adm[i] != 0;
      LaneHead<T> head;
      pend[i] = resolve<T, L>(tab, row, w, s_cur, unresolved, tet, admitted, px, py, pz, vx,
                              vy, vz, actf, n_hops, bounce_on, esc_on, &head) ? 1 : 0;
      TL::template write<0, ROW>(tile, r, head.v);
      if (head.hopped) store_row_vec<T, ROW_W>(m + i * WIDTH + ROW, row);
    }
  }
  if constexpr (kPass != kCrossers) TL::stage_out_heads(tile, blk, rows);
}

template <typename T, bool kPhilox>
using StreamFn = decltype(&stream_kernel<T, kPhilox, kWhole>);

// The instantiation of a (noise, pass, integrator) triple; nullptr for an
// unknown pass, and under LayoutPk or RK4 for any pass but the whole one.
template <typename T, bool kPhilox, typename L, bool kRK4 = false>
StreamFn<T, kPhilox> stream_instance(int pass) {
  if constexpr (kRK4) {
    return pass == kWhole ? stream_kernel<T, kPhilox, kWhole, L, true> : nullptr;
  } else if constexpr (L::VERTEX) {
    return pass == kWhole ? stream_kernel<T, kPhilox, kWhole, L> : nullptr;
  } else {
    switch (pass) {
      case kWhole: return stream_kernel<T, kPhilox, kWhole>;
      case kCrossers: return stream_kernel<T, kPhilox, kCrossers>;
      case kAdmitted: return stream_kernel<T, kPhilox, kAdmitted>;
      default: return nullptr;
    }
  }
}

template <typename T, typename L = LayoutTet>
int launch_stream(const void* tab, void* m, const void* xi, void* pend, void* adm,
                  long long n, T dt, T sigma, int use_adv, int use_brown,
                  int bounce_on, int esc_on, int n_hops, int noise_mode, int pass, int rk4,
                  PhiloxKey key, void* stream) {
  if (n <= 0) return 0;
  constexpr int lanes = Tile<T, L>::LANES;
  const unsigned blocks = static_cast<unsigned>((n + lanes - 1) / lanes);
  // the noise source, the pass and the integrator are template arguments, so
  // the xi instantiation of the whole Euler cycle is the kernel without any
  // Philox, compaction or RK4 code
  auto kernel = rk4 ? (noise_mode == 1 ? stream_instance<T, true, L, true>(pass)
                                       : stream_instance<T, false, L, true>(pass))
                    : (noise_mode == 1 ? stream_instance<T, true, L>(pass)
                                       : stream_instance<T, false, L>(pass));
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, lanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tab), static_cast<T*>(m), static_cast<const T*>(xi),
      static_cast<uint8_t*>(pend), static_cast<uint8_t*>(adm), n, dt, sigma, use_adv,
      use_brown, bounce_on, esc_on, n_hops, key);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

extern "C" int cpf_stream_f32(const void* tab, void* m, const void* xi,
                              void* pend, void* adm, long long n, float dt, float sigma,
                              int use_adv, int use_brown, int bounce_on,
                              int esc_on, int n_hops, int noise_mode, int pass, int rk4,
                              uint32_t k0, uint32_t k1, uint32_t k2, uint32_t k3,
                              void* stream) {
  return cpf::launch_stream<float>(tab, m, xi, pend, adm, n, dt, sigma, use_adv,
                                   use_brown, bounce_on, esc_on, n_hops, noise_mode, pass, rk4,
                                   cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}

extern "C" int cpf_stream_f64(const void* tab, void* m, const void* xi,
                              void* pend, void* adm, long long n, double dt, double sigma,
                              int use_adv, int use_brown, int bounce_on,
                              int esc_on, int n_hops, int noise_mode, int pass, int rk4,
                              uint32_t k0, uint32_t k1, uint32_t k2, uint32_t k3,
                              void* stream) {
  return cpf::launch_stream<double>(tab, m, xi, pend, adm, n, dt, sigma, use_adv,
                                    use_brown, bounce_on, esc_on, n_hops, noise_mode, pass, rk4,
                                    cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}

// The VertexVelocity instantiations: tab [nt, 32] (padded), m [n, 40]; the
// whole pass only.  rk4 = 1 selects the RK4 instantiation (the whole pass,
// either layout).
extern "C" int cpf_stream_pk_f32(const void* tab, void* m, const void* xi,
                                 void* pend, void* adm, long long n, float dt, float sigma,
                                 int use_adv, int use_brown, int bounce_on,
                                 int esc_on, int n_hops, int noise_mode, int pass, int rk4,
                                 uint32_t k0, uint32_t k1, uint32_t k2, uint32_t k3,
                                 void* stream) {
  return cpf::launch_stream<float, cpf::LayoutPk>(
      tab, m, xi, pend, adm, n, dt, sigma, use_adv, use_brown, bounce_on, esc_on, n_hops,
      noise_mode, pass, rk4, cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}

extern "C" int cpf_stream_pk_f64(const void* tab, void* m, const void* xi,
                                 void* pend, void* adm, long long n, double dt, double sigma,
                                 int use_adv, int use_brown, int bounce_on,
                                 int esc_on, int n_hops, int noise_mode, int pass, int rk4,
                                 uint32_t k0, uint32_t k1, uint32_t k2, uint32_t k3,
                                 void* stream) {
  return cpf::launch_stream<double, cpf::LayoutPk>(
      tab, m, xi, pend, adm, n, dt, sigma, use_adv, use_brown, bounce_on, esc_on, n_hops,
      noise_mode, pass, rk4, cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}

extern "C" const char* cpf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
