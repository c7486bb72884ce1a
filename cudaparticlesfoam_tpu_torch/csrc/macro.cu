// macro_stream_kernel<T, kPhilox, kPass>: one trip of a macro cycle, k bary
// sub-steps per pass over the mega (K4, macro_cycles = k in 2..8).
//
// Replaces the TPU macro kernels of cudaparticlesfoam_tpu/ops/fused_pallas.py:
// macro kernel A (_ak_compute via _kernel_ak_packed with XLA noise planes and
// _kernel_ak_packed_k with in-kernel noise), the hop gather, and macro kernel
// B (_kernel_bk_packed for trip 0, _kernel_bk_packed_c for the compacted
// trips, each with the phase advance of _phase_rows).  The plain version is
// ops/fused.py:macro_stream_plain; fused.mega_macro runs k trips of this
// kernel, each followed by rare_kernel.
//
// One thread per lane.  A lane reads its phase (sub-steps done this macro
// cycle); at phase k it returns at once.  Otherwise it advances sub-steps
// phase..k-1 from its cached row, each with that sub-step's noise, until the
// first face crossing or wall hit, and resolves that one as stream_kernel
// does with one inline hop (stream.cuh: the hop, the inline bounce or absorb,
// the pending flag); the phase becomes j+1 for a lane stopped at sub-step j
// and k for a lane that finished.  Every expression is stream_kernel's, so k
// sub-steps here equal k cycles of stream_kernel + rare_kernel bit for bit
// (--fmad=false).  Noise: xi [k, n, 3], or Philox drawn on demand with the
// key of sub-step j (step0 + j in the key's last word), the stream the
// per-cycle kernel draws.  The TPU wrote [3k, n] noise planes in trip 0
// because its hardware PRNG cannot be replayed; Philox can, so there are
// no planes.  The compacted trips (t >= 1) run the kCrossers pass,
// hop_admit_kernel, then the kAdmitted pass, as the per-cycle compacted
// gather does.
//
// What bounds it on the H100: in trip 0 the strided 128 B lane access (each
// lane's row as 32 scalar accesses, which stream_kernel no longer has: it
// stages its rows through a shared tile, tile.cuh), plus the extra
// sub-steps' arithmetic and noise of lanes that do not cross (no memory
// traffic); in later trips only the lanes that stopped earlier do work,
// and the others read one byte of phase.  Trip 0 takes 0.62 ms at 1M lanes,
// 16% of its bytes bound (PERF.md); staging it is the next step.
#include "stream.cuh"

namespace cpf {

template <typename T, bool kPhilox, int kPass>
__global__ void __launch_bounds__(THREADS)
macro_stream_kernel(const T* __restrict__ tab, T* __restrict__ m,
                    const T* __restrict__ xi, uint8_t* __restrict__ phase,
                    uint8_t* __restrict__ pend, uint8_t* __restrict__ adm, long long n,
                    int k, T dt, T sigma, int use_adv, int use_brown, int bounce_on,
                    int esc_on, PhiloxKey key) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ph0 = phase[i];
  if (ph0 >= k) {  // finished in an earlier trip
    if constexpr (kPass == kCrossers) {
      adm[i] = 0;
    } else {
      pend[i] = 0;
    }
    return;
  }
  T* me = m + i * WIDTH;

  const int tet = static_cast<int>(me[TET]);
  const bool act = me[ACT] > T(0.5);
  const bool alive = use_adv ? (act && tet >= 0) : act;
  const T alf = alive ? T(1) : T(0);
  const T ux = me[ROW + VEL], uy = me[ROW + VEL + 1], uz = me[ROW + VEL + 2];
  T vx = me[V0], vy = me[V0 + 1], vz = me[V0 + 2];
  T px = me[P0], py = me[P0 + 1], pz = me[P0 + 2];
  // advect kill (particles.cu:333-338)
  const T actf = use_adv ? alf : me[ACT];

  T row[ROW_W];
  load_row(me + ROW, row);
  T w[4], wmin;
  int s_cur = 0;
  bool need = false;
  int ph = ph0;
  for (; ph < k; ++ph) {
    // stream_kernel's sub-step, from the carried point
    T dx, dy, dz;
    if (use_adv) {
      dx = alf * ux * dt;
      dy = alf * uy * dt;
      dz = alf * uz * dt;
      vx = alive ? ux : vx;
      vy = alive ? uy : vy;
      vz = alive ? uz : vz;
    } else {
      dx = dy = dz = T(0);
    }
    if (use_brown) {
      T z[3];
      lane_normals<T, kPhilox>(PhiloxKey{key.k0, key.k1, key.k2, key.k3 + ph},
                               xi + static_cast<long long>(ph) * n * 3, i, z);
      dx = dx + alf * sigma * z[0];
      dy = dy + alf * sigma * z[1];
      dz = dz + alf * sigma * z[2];
    }
    px = px + dx;
    py = py + dy;
    pz = pz + dz;
    bary(row, px, py, pz, w);
    s_cur = argmin4(w, &wmin);
    need = (wmin < T(0)) && (tet >= 0);
    if (need) break;
  }
  if constexpr (kPass == kCrossers) {
    adm[i] = (need && code_of(row, s_cur) >= 0) ? 1 : 0;
    return;
  }
  const bool admitted = kPass != kAdmitted || adm[i] != 0;
  LaneHead<T> head;
  pend[i] = resolve(tab, row, w, s_cur, need, tet, admitted, px, py, pz, vx, vy, vz, actf, 1,
                    bounce_on, esc_on, &head) ? 1 : 0;
  store_lane(me, head, row);
  phase[i] = static_cast<uint8_t>(need ? ph + 1 : k);
}

template <typename T, bool kPhilox>
using MacroFn = decltype(&macro_stream_kernel<T, kPhilox, kWhole>);

template <typename T, bool kPhilox>
MacroFn<T, kPhilox> macro_instance(int pass) {
  switch (pass) {
    case kWhole: return macro_stream_kernel<T, kPhilox, kWhole>;
    case kCrossers: return macro_stream_kernel<T, kPhilox, kCrossers>;
    case kAdmitted: return macro_stream_kernel<T, kPhilox, kAdmitted>;
    default: return nullptr;
  }
}

template <typename T>
int launch_macro(const void* tab, void* m, const void* xi, void* phase, void* pend,
                 void* adm, long long n, int k, T dt, T sigma, int use_adv, int use_brown,
                 int bounce_on, int esc_on, int noise_mode, int pass, PhiloxKey key,
                 void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > 8) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  auto kernel = noise_mode == 1 ? macro_instance<T, true>(pass) : macro_instance<T, false>(pass);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tab), static_cast<T*>(m), static_cast<const T*>(xi),
      static_cast<uint8_t*>(phase), static_cast<uint8_t*>(pend), static_cast<uint8_t*>(adm),
      n, k, dt, sigma, use_adv, use_brown, bounce_on, esc_on, key);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

extern "C" int cpf_macro_stream_f32(const void* tab, void* m, const void* xi, void* phase,
                                    void* pend, void* adm, long long n, int k, float dt,
                                    float sigma, int use_adv, int use_brown, int bounce_on,
                                    int esc_on, int noise_mode, int pass, uint32_t k0,
                                    uint32_t k1, uint32_t k2, uint32_t k3, void* stream) {
  return cpf::launch_macro<float>(tab, m, xi, phase, pend, adm, n, k, dt, sigma, use_adv,
                                  use_brown, bounce_on, esc_on, noise_mode, pass,
                                  cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}

extern "C" int cpf_macro_stream_f64(const void* tab, void* m, const void* xi, void* phase,
                                    void* pend, void* adm, long long n, int k, double dt,
                                    double sigma, int use_adv, int use_brown, int bounce_on,
                                    int esc_on, int noise_mode, int pass, uint32_t k0,
                                    uint32_t k1, uint32_t k2, uint32_t k3, void* stream) {
  return cpf::launch_macro<double>(tab, m, xi, phase, pend, adm, n, k, dt, sigma, use_adv,
                                   use_brown, bounce_on, esc_on, noise_mode, pass,
                                   cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}
