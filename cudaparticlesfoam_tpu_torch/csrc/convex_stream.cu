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
// What bounds it on the H100: bytes.  Per lane it reads the 128 B mega row
// and 12 B of xi (none with Philox) and writes the 32 B head, 12 B of disp
// and a pending byte, plus a 96 B cx row read by each interior crosser and
// written back by each lane that hops: 197 MB at the 1M-lane slice with
// Philox (12.7% of lanes load a row), a bound of 0.059 ms at 3.35 TB/s
// (ops/traffic.py).  Design, as stream_kernel's (tile.cuh): a block stages
// its lanes' rows through a 32 KB swizzled shared tile with 16 B coalesced
// loads; each thread reads its head and cx row from the tile as 16 B chunks
// and runs the sub-step (expressions unchanged, --fmad=false); the new heads
// go back into the tile and the block writes the head chunks (columns 0:8,
// whole 32 B sectors) out coalesced.  A lane that hopped writes its new row
// itself as six 16 B stores (whole sectors); the other rows are left as they
// were, which beat writing the whole tile back.  The kCrossers pass stages
// in and writes only its flag byte.  Measured on an H100 at 700 W (PERF.md):
// about 0.10 ms with xi or Philox, against 0.23 and 0.25 ms for the earlier
// design (32 scalar accesses per lane row).  What holds it back: registers
// (the cached and the neighbour cx row are both live) and the random 96 B
// row loads from the 96 MB cx table, above the L2.
#include "convex.cuh"
#include "stream.cuh"

namespace cpf {

// Blocks per SM the register budget of the float kernel must allow
// (__launch_bounds__): left free, ptxas gives it 90 registers, two blocks
// of 256 per SM; three caps it at 80 (a few bytes of spill), which ran
// faster.  The double kernel (parity runs only) is left free: capped alike
// it spills.
template <typename T, bool kPhilox, int kPass>
__global__ void __launch_bounds__(Tile<T>::LANES, sizeof(T) == 4 ? 3 : 1)
convex_stream_kernel(const T* __restrict__ tab, T* __restrict__ m,
                     const T* __restrict__ xi, uint8_t* __restrict__ pend,
                     uint8_t* __restrict__ adm, T* __restrict__ disp, long long n, T dt,
                     T sigma, int use_adv, int use_brown, int n_hops, PhiloxKey key) {
  using TL = Tile<T>;
  __shared__ typename TL::V tile[TL::LANES * TL::CH];
  const long long base = static_cast<long long>(blockIdx.x) * TL::LANES;
  const int rows = static_cast<int>(n - base < TL::LANES ? n - base : TL::LANES);
  T* blk = m + base * WIDTH;
  TL::stage_in(tile, blk, rows);

  const int r = threadIdx.x;
  if (r < rows) {
    const long long i = base + r;
    T hd[ROW];  // pos, vel, tet, active
    TL::template read<0, ROW>(tile, r, hd);
    T row[CX_W];
    TL::template read<ROW, CX_W>(tile, r, row);

    const int tet = static_cast<int>(hd[TET]);
    const bool act = hd[ACT] > T(0.5);
    const bool alive = use_adv ? (act && tet >= 0) : act;
    const T alf = alive ? T(1) : T(0);
    const T ux = row[CX_VEL], uy = row[CX_VEL + 1], uz = row[CX_VEL + 2];
    T dx, dy, dz, vx, vy, vz;
    if (use_adv) {
      dx = alf * ux * dt;
      dy = alf * uy * dt;
      dz = alf * uz * dt;
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
    const T actf = use_adv ? alf : hd[ACT];

    const T p0[3] = {hd[P0], hd[P0 + 1], hd[P0 + 2]};
    const T pe[3] = {p0[0] + dx, p0[1] + dy, p0[2] + dz};
    const T seg[3] = {pe[0] - p0[0], pe[1] - p0[1], pe[2] - p0[2]};  // not d itself

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
      const bool interior =
          crossing && slot0 >= 0 && static_cast<int>(pick4(row + CX_NBR, slot0)) >= 0;
      adm[i] = interior ? 1 : 0;
    } else {
      int tet_new = tet;
      bool res2 = false;
      if (n_hops >= 1 && crossing && slot0 >= 0) {
        const int nxt0 = static_cast<int>(pick4(row + CX_NBR, slot0));
        // interior crosser: one inline hop into the neighbour, if admitted
        if (nxt0 >= 0 && (kPass != kAdmitted || adm[i] != 0)) {
          T nrow[CX_W];
          load_row_vec<T, CX_W>(tab + static_cast<long long>(nxt0) * CX_W, nrow);
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

      // a pending lane keeps its segment start, the pos it was staged with
      if (!pending) {
        hd[P0] = pe[0];
        hd[P0 + 1] = pe[1];
        hd[P0 + 2] = pe[2];
      }
      hd[V0] = vx;
      hd[V0 + 1] = vy;
      hd[V0 + 2] = vz;
      hd[TET] = static_cast<T>(tet_new);
      hd[ACT] = actf;
      TL::template write<0, ROW>(tile, r, hd);
      if (res2) store_row_vec<T, CX_W>(m + i * WIDTH + ROW, row);
      disp[3 * i] = dx;
      disp[3 * i + 1] = dy;
      disp[3 * i + 2] = dz;
      pend[i] = pending ? 1 : 0;
    }
  }
  if constexpr (kPass != kCrossers) TL::stage_out_heads(tile, blk, rows);
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
  constexpr int lanes = Tile<T>::LANES;
  const unsigned blocks = static_cast<unsigned>((n + lanes - 1) / lanes);
  auto kernel = noise_mode == 1 ? convex_stream_instance<T, true>(pass)
                                : convex_stream_instance<T, false>(pass);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, lanes, 0, static_cast<cudaStream_t>(stream)>>>(
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
