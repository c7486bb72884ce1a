// stream_kernel<T, kPhilox>: the stream section of one particle sub-step (K1 + K2).
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
#include "common.cuh"
#include "philox.cuh"

namespace cpf {

template <typename T, bool kPhilox>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const T* __restrict__ tab, T* __restrict__ m,
              const T* __restrict__ xi, uint8_t* __restrict__ pend,
              long long n, T dt, T sigma, int use_adv, int use_brown,
              int bounce_on, int esc_on, int n_hops, PhiloxKey key) {
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
    if (kPhilox) {
      philox_normals3(key, i, z);
    } else {
      z[0] = xi[3 * i];
      z[1] = xi[3 * i + 1];
      z[2] = xi[3 * i + 2];
    }
    dx = dx + alf * sigma * z[0];
    dy = dy + alf * sigma * z[1];
    dz = dz + alf * sigma * z[2];
  }
  // advect kill (particles.cu:333-338)
  T actf = use_adv ? alf : me[ACT];

  T px = me[P0] + dx;
  T py = me[P0 + 1] + dy;
  T pz = me[P0 + 2] + dz;

  T row[ROW_W];
  load_row(me + ROW, row);
  T w[4], wmin;
  bary(row, px, py, pz, w);
  int s_cur = argmin4(w, &wmin);
  bool unresolved = (wmin < T(0)) && (tet >= 0);
  int cur_tet = tet;
  bool wall = false;
  int wall_slot = 0;

  // inline hops; a lane that is resolved would only recompute the same
  // weights, so it leaves the loop
  for (int h = 0; h < n_hops && unresolved; ++h) {
    const int code = code_of(row, s_cur);
    if (code < 0) {
      wall = true;
      wall_slot = s_cur;
      unresolved = false;
      break;
    }
    load_row(tab + static_cast<long long>(code) * ROW_W, row);
    cur_tet = code;
    bary(row, px, py, pz, w);
    s_cur = argmin4(w, &wmin);
    unresolved = wmin < T(0);
  }

  // inline single bounce on the last hop's weights, or absorb through the
  // row's escape mask (fused.py:729-762)
  int tet1 = cur_tet;
  if (n_hops > 0 && bounce_on) {
    bool refl = wall;
    bool esc = false;
    if (esc_on) {
      const int code_w = code_of(row, wall_slot);
      const int escm = static_cast<int>(row[ESC]);
      esc = wall && code_w < 0 && ((escm >> wall_slot) & 1);
      refl = wall && !esc;
    }
    const T rf = refl ? T(1) : T(0);
    T gx, gy, gz;
    grad(row, wall_slot, &gx, &gy, &gz);
    const T wv = w[wall_slot];
    const T gg = gx * gx + gy * gy + gz * gz;
    // rf-masked reciprocal: a bare 1/gg would poison dead lanes with NaN
    const T inv_g2 = rf / (gg + (T(1) - rf));
    const T f = T(2) * wv * inv_g2;
    px = px - f * gx;
    py = py - f * gy;
    pz = pz - f * gz;
    const T fu = T(2) * (vx * gx + vy * gy + vz * gz) * inv_g2;
    vx = vx - fu * gx;
    vy = vy - fu * gy;
    vz = vz - fu * gz;
    T w2[4];
    bary(row, px, py, pz, w2);
    // min(...) >= 0 with NaN propagation, as torch.minimum / jnp.minimum
    const bool landed = refl && w2[0] >= T(0) && w2[1] >= T(0) &&
                        w2[2] >= T(0) && w2[3] >= T(0);
    wall = refl && !landed;
    if (esc) {
      tet1 = -(cur_tet + 1);
      actf = T(0);
    }
  }

  me[P0] = px;
  me[P0 + 1] = py;
  me[P0 + 2] = pz;
  me[V0] = vx;
  me[V0 + 1] = vy;
  me[V0 + 2] = vz;
  me[TET] = static_cast<T>(tet1);
  me[ACT] = actf;
#pragma unroll
  for (int k = 0; k < ROW_W; ++k) me[ROW + k] = row[k];
#pragma unroll
  for (int k = ROW + ROW_W; k < WIDTH; ++k) me[k] = T(0);
  pend[i] = (unresolved || wall) ? 1 : 0;
}

template <typename T>
int launch_stream(const void* tab, void* m, const void* xi, void* pend,
                  long long n, T dt, T sigma, int use_adv, int use_brown,
                  int bounce_on, int esc_on, int n_hops, int noise_mode,
                  PhiloxKey key, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  // the noise source is a template argument, so the xi instantiation is the
  // kernel without any Philox code
  auto kernel = noise_mode == 1 ? stream_kernel<T, true> : stream_kernel<T, false>;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tab), static_cast<T*>(m), static_cast<const T*>(xi),
      static_cast<uint8_t*>(pend), n, dt, sigma, use_adv, use_brown, bounce_on,
      esc_on, n_hops, key);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

extern "C" int cpf_stream_f32(const void* tab, void* m, const void* xi,
                              void* pend, long long n, float dt, float sigma,
                              int use_adv, int use_brown, int bounce_on,
                              int esc_on, int n_hops, int noise_mode, uint32_t k0,
                              uint32_t k1, uint32_t k2, uint32_t k3, void* stream) {
  return cpf::launch_stream<float>(tab, m, xi, pend, n, dt, sigma, use_adv,
                                   use_brown, bounce_on, esc_on, n_hops, noise_mode,
                                   cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}

extern "C" int cpf_stream_f64(const void* tab, void* m, const void* xi,
                              void* pend, long long n, double dt, double sigma,
                              int use_adv, int use_brown, int bounce_on,
                              int esc_on, int n_hops, int noise_mode, uint32_t k0,
                              uint32_t k1, uint32_t k2, uint32_t k3, void* stream) {
  return cpf::launch_stream<double>(tab, m, xi, pend, n, dt, sigma, use_adv,
                                    use_brown, bounce_on, esc_on, n_hops, noise_mode,
                                    cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}

extern "C" const char* cpf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
