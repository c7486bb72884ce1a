// stream_kernel<T, kPhilox, kPass>: the stream section of one particle sub-step
// (K1 + K2, and the compacted stage of K3).
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
// What bounds it on the H100: the access pattern of the mega.  Each lane
// reads and writes its 128 B row as 32 scalar accesses, so every warp-wide
// access touches 32 sectors 128 B apart; at 1M lanes that pattern alone
// takes ~0.58 ms (about 440 GB/s), against ~0.17 ms with 16 B vector
// accesses and ~0.09 ms staged through shared memory.  The random 80 B row
// load per mover per hop (row table 80 MB at 1M tets, above the 50 MB L2)
// comes second.  Later work: vector or shared-memory-staged mega access,
// __ldg / L2 persistence for the table, and fusing the rare stage in.
#include "stream.cuh"

namespace cpf {

template <typename T, bool kPhilox, int kPass>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const T* __restrict__ tab, T* __restrict__ m,
              const T* __restrict__ xi, uint8_t* __restrict__ pend,
              uint8_t* __restrict__ adm, long long n, T dt, T sigma, int use_adv,
              int use_brown, int bounce_on, int esc_on, int n_hops, PhiloxKey key) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T* me = m + i * WIDTH;

  const int tet = static_cast<int>(me[TET]);
  const bool act = me[ACT] > T(0.5);
  const bool alive = use_adv ? (act && tet >= 0) : act;
  const T alf = alive ? T(1) : T(0);
  const T ux = me[ROW + VEL], uy = me[ROW + VEL + 1], uz = me[ROW + VEL + 2];
  T dx, dy, dz, vx, vy, vz;
  if (use_adv) {
    dx = alf * ux * dt;
    dy = alf * uy * dt;
    dz = alf * uz * dt;
    // advected velocity into vel columns (particles.cu:361)
    vx = alive ? ux : me[V0];
    vy = alive ? uy : me[V0 + 1];
    vz = alive ? uz : me[V0 + 2];
  } else {
    dx = dy = dz = T(0);
    vx = me[V0];
    vy = me[V0 + 1];
    vz = me[V0 + 2];
  }
  if (use_brown) {
    T z[3];
    lane_normals<T, kPhilox>(key, xi, i, z);
    dx = dx + alf * sigma * z[0];
    dy = dy + alf * sigma * z[1];
    dz = dz + alf * sigma * z[2];
  }
  // advect kill (particles.cu:333-338)
  const T actf = use_adv ? alf : me[ACT];

  const T px = me[P0] + dx;
  const T py = me[P0 + 1] + dy;
  const T pz = me[P0 + 2] + dz;

  T row[ROW_W];
  load_row(me + ROW, row);
  T w[4], wmin;
  bary(row, px, py, pz, w);
  const int s_cur = argmin4(w, &wmin);
  const bool unresolved = (wmin < T(0)) && (tet >= 0);
  if constexpr (kPass == kCrossers) {
    adm[i] = (unresolved && code_of(row, s_cur) >= 0) ? 1 : 0;
    return;
  }
  const bool admitted = kPass != kAdmitted || adm[i] != 0;
  pend[i] = resolve_store(tab, me, row, w, s_cur, unresolved, tet, admitted, px, py, pz,
                          vx, vy, vz, actf, n_hops, bounce_on, esc_on) ? 1 : 0;
}

template <typename T, bool kPhilox>
using StreamFn = decltype(&stream_kernel<T, kPhilox, kWhole>);

// The instantiation of a (noise, pass) pair; nullptr for an unknown pass.
template <typename T, bool kPhilox>
StreamFn<T, kPhilox> stream_instance(int pass) {
  switch (pass) {
    case kWhole: return stream_kernel<T, kPhilox, kWhole>;
    case kCrossers: return stream_kernel<T, kPhilox, kCrossers>;
    case kAdmitted: return stream_kernel<T, kPhilox, kAdmitted>;
    default: return nullptr;
  }
}

template <typename T>
int launch_stream(const void* tab, void* m, const void* xi, void* pend, void* adm,
                  long long n, T dt, T sigma, int use_adv, int use_brown,
                  int bounce_on, int esc_on, int n_hops, int noise_mode, int pass,
                  PhiloxKey key, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  // the noise source and the pass are template arguments, so the xi
  // instantiation of the whole cycle is the kernel without any Philox or
  // compaction code
  auto kernel = noise_mode == 1 ? stream_instance<T, true>(pass) : stream_instance<T, false>(pass);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tab), static_cast<T*>(m), static_cast<const T*>(xi),
      static_cast<uint8_t*>(pend), static_cast<uint8_t*>(adm), n, dt, sigma, use_adv,
      use_brown, bounce_on, esc_on, n_hops, key);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

extern "C" int cpf_stream_f32(const void* tab, void* m, const void* xi,
                              void* pend, void* adm, long long n, float dt, float sigma,
                              int use_adv, int use_brown, int bounce_on,
                              int esc_on, int n_hops, int noise_mode, int pass, uint32_t k0,
                              uint32_t k1, uint32_t k2, uint32_t k3, void* stream) {
  return cpf::launch_stream<float>(tab, m, xi, pend, adm, n, dt, sigma, use_adv,
                                   use_brown, bounce_on, esc_on, n_hops, noise_mode, pass,
                                   cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}

extern "C" int cpf_stream_f64(const void* tab, void* m, const void* xi,
                              void* pend, void* adm, long long n, double dt, double sigma,
                              int use_adv, int use_brown, int bounce_on,
                              int esc_on, int n_hops, int noise_mode, int pass, uint32_t k0,
                              uint32_t k1, uint32_t k2, uint32_t k3, void* stream) {
  return cpf::launch_stream<double>(tab, m, xi, pend, adm, n, dt, sigma, use_adv,
                                    use_brown, bounce_on, esc_on, n_hops, noise_mode, pass,
                                    cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}

extern "C" const char* cpf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
