// convex_stream_kernel<T, kPhilox, kPass>: the stream section of one ConvexPoly
// sub-step (K5, and the compacted stage of K3).
//
// Replaces the TPU convex stream of cudaparticlesfoam_tpu/ops/fused_pallas.py:
// kernel CA (_ca_compute via _kernel_ca_packed, and _kernel_ca_packed_k with
// in-kernel noise: advect, kick, segment, hop-0 exit test, leak guard,
// neighbour select), the XLA cx-row gather between the kernels, and kernel
// CB (_kernel_cb_packed: hop-1 exit test with came-from suppression,
// assembly, pending flag, displacement).  Semantics are those of the jnp
// engine's stream section, cudaparticlesfoam_tpu/ops/fused_convex.py:110-219;
// the plain version is ops/fused_convex.py:convex_stream_plain.
//
// One thread per lane over the natural row-major [n, 32] mega.  The TPU
// split the cycle at the gather and staged 16 head rows plus the packed
// displacement through HBM; here an interior crosser loads its neighbour's
// 96-byte cx row itself, and every other lane keeps its cached row (only
// dead lanes' caches can differ from the TPU's self-fetch, by design).
// Pending lanes keep their segment start in the pos columns and leave the
// displacement in disp [n, 3] for convex_rare_kernel.
//
// The kCrossers / kAdmitted passes (stream.cuh) are the compacted hop gather
// of hop_compact=4, _kernel_cb_packed_c: the flag pass writes each lane's
// interior-crossing flag (CINT), hop_admit_kernel admits groups and ranks,
// and the apply pass recomputes the sub-step; an interior crosser that was
// not admitted stays pending with its start point, pre-hop tet and row.
//
// What bounds it on the H100: as for stream_kernel, the 128-byte lane
// stride of the mega (32 scalar loads and stores per lane, each warp access
// touching 32 sectors) plus the 12 B disp store; the neighbour row is loaded
// only by the few interior crossers.  Later work: vector or shared-memory
// staged mega access.
#include "convex.cuh"
#include "stream.cuh"

namespace cpf {

template <typename T, bool kPhilox, int kPass>
__global__ void __launch_bounds__(THREADS)
convex_stream_kernel(const T* __restrict__ tab, T* __restrict__ m,
                     const T* __restrict__ xi, uint8_t* __restrict__ pend,
                     uint8_t* __restrict__ adm, T* __restrict__ disp, long long n, T dt,
                     T sigma, int use_adv, int use_brown, int n_hops, PhiloxKey key) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T* me = m + i * WIDTH;

  const int tet = static_cast<int>(me[TET]);
  const bool act = me[ACT] > T(0.5);
  const bool alive = use_adv ? (act && tet >= 0) : act;
  const T alf = alive ? T(1) : T(0);
  const T ux = me[ROW + CX_VEL], uy = me[ROW + CX_VEL + 1], uz = me[ROW + CX_VEL + 2];
  T dx, dy, dz, vx, vy, vz;
  if (use_adv) {
    dx = alf * ux * dt;
    dy = alf * uy * dt;
    dz = alf * uz * dt;
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
  const T actf = use_adv ? alf : me[ACT];

  const T p0[3] = {me[P0], me[P0 + 1], me[P0 + 2]};
  const T pe[3] = {p0[0] + dx, p0[1] + dy, p0[2] + dz};
  const T seg[3] = {pe[0] - p0[0], pe[1] - p0[1], pe[2] - p0[2]};  // not d itself

  T row[CX_W];
#pragma unroll
  for (int k = 0; k < CX_W; ++k) row[k] = me[ROW + k];
  int sup0 = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    if (static_cast<int>(row[CX_NBR + f]) == NO_INLET) sup0 |= 1 << f;
  }
  T dt0;
  const int slot0 = cx_exit(row, p0, seg, sup0, &dt0);
  // leak guard: a start point outside its cached tet (tolerance dust);
  // max with NaN propagation, as torch.max / jnp.max
  T fd_max = T(0);
  bool fd_nan = false;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const T fd = dot3(row + 3 * f, p0) - row[CX_D + f];
    fd_nan = fd_nan || isnan(fd);
    fd_max = (f == 0 || fd > fd_max) ? fd : fd_max;
  }
  const bool outside0 = alive && !fd_nan && fd_max > T(CX_TOL);
  const bool crossing = alive && (slot0 >= 0 || outside0);

  if constexpr (kPass == kCrossers) {
    adm[i] = (crossing && slot0 >= 0 && static_cast<int>(row[CX_NBR + slot0]) >= 0) ? 1 : 0;
    return;
  }
  int tet_new = tet;
  bool res2 = false;
  if (n_hops >= 1 && crossing && slot0 >= 0) {
    const int nxt0 = static_cast<int>(row[CX_NBR + slot0]);
    // interior crosser: one inline hop into the neighbour, if admitted
    if (nxt0 >= 0 && (kPass != kAdmitted || adm[i] != 0)) {
      T nrow[CX_W];
      const T* src = tab + static_cast<long long>(nxt0) * CX_W;
#pragma unroll
      for (int k = 0; k < CX_W; ++k) nrow[k] = src[k];
      const T p1[3] = {p0[0] + dt0 * seg[0], p0[1] + dt0 * seg[1], p0[2] + dt0 * seg[2]};
      const T rem[3] = {pe[0] - p1[0], pe[1] - p1[1], pe[2] - p1[2]};
      int sup1 = 0;  // the inlet face, by its came-from neighbour code
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if (static_cast<int>(nrow[CX_NBR + f]) == tet) sup1 |= 1 << f;
      }
      T dt1;
      if (cx_exit(nrow, p1, rem, sup1, &dt1) < 0) {
        res2 = true;
        tet_new = nxt0;
        // vel keeps the OLD tet's advected velocity (particles.cu:361)
#pragma unroll
        for (int k = 0; k < CX_W; ++k) row[k] = nrow[k];
      }
    }
  }
  const bool pending = crossing && !res2;

  if (!pending) {
    me[P0] = pe[0];
    me[P0 + 1] = pe[1];
    me[P0 + 2] = pe[2];
  }
  me[V0] = vx;
  me[V0 + 1] = vy;
  me[V0 + 2] = vz;
  me[TET] = static_cast<T>(tet_new);
  me[ACT] = actf;
  if (res2) {
#pragma unroll
    for (int k = 0; k < CX_W; ++k) me[ROW + k] = row[k];
  }
  disp[3 * i] = dx;
  disp[3 * i + 1] = dy;
  disp[3 * i + 2] = dz;
  pend[i] = pending ? 1 : 0;
}

template <typename T, bool kPhilox>
using ConvexStreamFn = decltype(&convex_stream_kernel<T, kPhilox, kWhole>);

template <typename T, bool kPhilox>
ConvexStreamFn<T, kPhilox> convex_stream_instance(int pass) {
  switch (pass) {
    case kWhole: return convex_stream_kernel<T, kPhilox, kWhole>;
    case kCrossers: return convex_stream_kernel<T, kPhilox, kCrossers>;
    case kAdmitted: return convex_stream_kernel<T, kPhilox, kAdmitted>;
    default: return nullptr;
  }
}

template <typename T>
int launch_convex_stream(const void* tab, void* m, const void* xi, void* pend, void* adm,
                         void* disp, long long n, T dt, T sigma, int use_adv,
                         int use_brown, int n_hops, int noise_mode, int pass, PhiloxKey key,
                         void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  auto kernel = noise_mode == 1 ? convex_stream_instance<T, true>(pass)
                                : convex_stream_instance<T, false>(pass);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tab), static_cast<T*>(m), static_cast<const T*>(xi),
      static_cast<uint8_t*>(pend), static_cast<uint8_t*>(adm), static_cast<T*>(disp), n, dt,
      sigma, use_adv, use_brown, n_hops, key);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

extern "C" int cpf_convex_stream_f32(const void* tab, void* m, const void* xi,
                                     void* pend, void* adm, void* disp, long long n, float dt,
                                     float sigma, int use_adv, int use_brown,
                                     int n_hops, int noise_mode, int pass, uint32_t k0,
                                     uint32_t k1, uint32_t k2, uint32_t k3,
                                     void* stream) {
  return cpf::launch_convex_stream<float>(tab, m, xi, pend, adm, disp, n, dt, sigma,
                                          use_adv, use_brown, n_hops, noise_mode, pass,
                                          cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}

extern "C" int cpf_convex_stream_f64(const void* tab, void* m, const void* xi,
                                     void* pend, void* adm, void* disp, long long n, double dt,
                                     double sigma, int use_adv, int use_brown,
                                     int n_hops, int noise_mode, int pass, uint32_t k0,
                                     uint32_t k1, uint32_t k2, uint32_t k3,
                                     void* stream) {
  return cpf::launch_convex_stream<double>(tab, m, xi, pend, adm, disp, n, dt, sigma,
                                           use_adv, use_brown, n_hops, noise_mode, pass,
                                           cpf::PhiloxKey{k0, k1, k2, k3}, stream);
}
