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
// A lane reads its phase (sub-steps done this macro cycle); at phase k it is
// finished.  Otherwise it advances sub-steps phase..k-1 from its cached row,
// each with that sub-step's noise, until the first face crossing or wall hit,
// and resolves that one as stream_kernel does with one inline hop
// (stream.cuh: the hop, the inline bounce or absorb, the pending flag); the
// phase becomes j+1 for a lane stopped at sub-step j and k for a lane that
// finished.  Every expression is stream_kernel's, so k sub-steps here equal k
// cycles of stream_kernel + rare_kernel bit for bit (--fmad=false).  Noise:
// xi [k, n, 3], or Philox drawn on demand with the key of sub-step j
// (step0 + j in the key's last word), the stream the per-cycle kernel draws.
// The TPU wrote [3k, n] noise planes in trip 0 because its hardware PRNG
// cannot be replayed; Philox can, so there are no planes.  The compacted
// trips (t >= 1) run the kCrossers pass, hop_admit_kernel, then the
// kAdmitted pass, as the per-cycle compacted gather does.
//
// What bounds it on the H100: bytes.  Trip 0 reads every lane's 128 B row,
// 12 B of xi per sub-step run and a table row per hop, and writes the heads,
// the rows of lanes that hopped and two flag bytes a lane (269 MB at the
// 1M-lane slice with xi, a bound of 0.080 ms at 3.35 TB/s); a later trip
// moves only the rows of the lanes still working (a third after trip 0) and
// one or two flag bytes for every lane (ops/traffic.py counts both from the
// run's phases and hops).
//
// Design.  A block owns Tile<T>::LANES consecutive lanes (256 float, 128
// double), one thread each, and takes one of two paths.
//  * Every lane of the block works (trip 0; the kWhole pass finds out with
//    one __syncthreads_count): the block's contiguous run of rows is staged
//    through the swizzled shared tile as stream_kernel stages it
//    (Tile::stage_in, 16 B coalesced), the new heads go back from the tile
//    (stage_out_heads), and the pending flags and new phases leave as one
//    16 B store per 16 lanes (tile.cuh: store_flags).  A warp walks
//    sub-steps 0..k-1 together, each lane taking part from its phase until
//    it stops (predicated, no early exit), so the warp can load a sub-step's
//    xi cooperatively: its lanes' [3] triples are contiguous (384 B float),
//    read as three coalesced accesses into the warp's slice of shared
//    memory, and only the elements of lanes that run that sub-step.  Philox
//    is arithmetic and needs none of it.
//  * Some lanes are finished (every later trip; the kCrossers and kAdmitted
//    passes are compiled with this path alone, without shared memory or a
//    barrier): a finished lane writes its zero flag and retires at once; a
//    working lane reads its own row as 16 B vectors (one whole 128 B line,
//    256 B for double; no sector is fetched for a finished lane), walks its
//    sub-steps with an early exit, and writes its head as 16 B vectors and
//    its flags as bytes.
// In both a lane that hopped stores its new row itself as 16 B vectors, and
// the pad columns 28:32 are not written (pack_state zeroes them and no
// kernel reads them).
//
// Tried on the card and dropped (PERF.md has the times): for a block with
// part of its lanes working, a list of them in shared memory (ballots and a
// prefix), their rows copied into the tile 8 threads x 16 B a row, and all
// flags moved as 16 B vectors.  At a third of the lanes working it took
// 0.042 ms (flag pass) and 0.067 (apply pass) against 0.031 and 0.052 for the
// lane-per-thread path, and twice its time at 5% and 0.5%: its barriers and
// its 36 KB of shared memory a block cost more than its coalescing saves,
// because a lane's row is one whole line either way.  Thread r keeps lane r in every
// trip: spreading the working lanes over full warps would scatter the xi
// triples and the flag bytes.
//
// Measured at the 1M-lane slice on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md): trip 0 0.14 ms with xi and 0.12 with Philox, 53-57% and 52-55%
// of the bound; trip 1 (a third of the lanes working) 0.031 ms for the flag
// pass and 0.052 for the apply pass, 50% and 44%; trips 2 and 3 (5% and 0.5%
// working) 0.005-0.019 ms a pass, launches that move a flag byte per lane.
// The design before this one (one thread per lane reading and writing its
// 128 B row as 32 scalar accesses 128 B apart, in every trip) took 0.62 ms
// for trip 0 and 0.17 ms for trip 1's apply pass on the same card.
#include "stream.cuh"

namespace cpf {

// One lane's walk through the sub-steps of a trip: stream_kernel's sub-step,
// expression for expression, from the carried point.
template <typename T>
struct LaneWalk {
  T ux, uy, uz, vx, vy, vz, px, py, pz, alf, actf;
  T w[4];
  int tet, s_cur, stop;
  bool alive, need;

  // from the lane's head (pos, vel, tet, active) and cached row
  __device__ __forceinline__ void start(const T* hd, const T* row, int use_adv) {
    tet = static_cast<int>(hd[TET]);
    const bool act = hd[ACT] > T(0.5);
    alive = use_adv ? (act && tet >= 0) : act;
    alf = alive ? T(1) : T(0);
    ux = row[VEL], uy = row[VEL + 1], uz = row[VEL + 2];
    vx = hd[V0], vy = hd[V0 + 1], vz = hd[V0 + 2];
    px = hd[P0], py = hd[P0 + 1], pz = hd[P0 + 2];
    // advect kill (particles.cu:333-338)
    actf = use_adv ? alf : hd[ACT];
    w[0] = w[1] = w[2] = w[3] = T(0);
    s_cur = 0;
    stop = 0;
    need = false;
  }

  // sub-step ph with the normals z; `need` says it stopped at a face
  __device__ __forceinline__ void step(const T* row, const T* z, int ph, T dt, T sigma,
                                       int use_adv, int use_brown) {
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
      dx = dx + alf * sigma * z[0];
      dy = dy + alf * sigma * z[1];
      dz = dz + alf * sigma * z[2];
    }
    px = px + dx;
    py = py + dy;
    pz = pz + dz;
    bary(row, px, py, pz, w);
    T wmin;
    s_cur = argmin4(w, &wmin);
    need = (wmin < T(0)) && (tet >= 0);
    stop = ph;
  }

  // the lane's phase after the trip
  __device__ __forceinline__ uint8_t phase_after(int k) const {
    return static_cast<uint8_t>(need ? stop + 1 : k);
  }
};

template <typename T, bool kPhilox, int kPass>
__global__ void __launch_bounds__(Tile<T>::LANES)
macro_stream_kernel(const T* __restrict__ tab, T* __restrict__ m,
                    const T* __restrict__ xi, uint8_t* __restrict__ phase,
                    uint8_t* __restrict__ pend, uint8_t* __restrict__ adm, long long n,
                    int k, T dt, T sigma, int use_adv, int use_brown, int bounce_on,
                    int esc_on, PhiloxKey key) {
  using TL = Tile<T>;
  constexpr int LANES = TL::LANES;
  constexpr bool kTile = kPass == kWhole;  // the pass that trip 0 runs
  constexpr unsigned FULL = 0xffffffffu;

  const int r = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * LANES;
  const int rows = static_cast<int>(n - base < LANES ? n - base : LANES);
  const long long i = base + r;
  T* me = m + i * WIDTH;
  uint8_t* out = kPass == kCrossers ? adm : pend;

  const int ph0 = r < rows ? static_cast<int>(phase[i]) : k;
  const bool working = ph0 < k;
  bool all = false;
  if constexpr (kTile) all = __syncthreads_count(working) == rows;

  T row[ROW_W];
  LaneWalk<T> walk;

  if (!all) {
    // Some lanes of the block are finished (every trip after the first): a
    // lane per thread, no barrier, no shared memory.  A finished lane writes
    // its zero flag and leaves; a working lane reads its own row as 16 B
    // vectors (one whole line), walks its sub-steps, and writes its own head
    // and flags.
    if (r >= rows) return;
    if (!working) {
      out[i] = 0;
      return;
    }
    T hd[ROW];  // pos, vel, tet, active
    load_vec<T, ROW>(me, hd);
    load_vec<T, ROW_W>(me + ROW, row);
    walk.start(hd, row, use_adv);
    for (int ph = ph0; ph < k; ++ph) {
      T z[3] = {T(0), T(0), T(0)};
      if (use_brown) {
        lane_normals<T, kPhilox>(PhiloxKey{key.k0, key.k1, key.k2, key.k3 + ph},
                                 xi + static_cast<long long>(ph) * n * 3, i, z);
      }
      walk.step(row, z, ph, dt, sigma, use_adv, use_brown);
      if (walk.need) break;
    }
    if constexpr (kPass == kCrossers) {
      out[i] = (walk.need && code_of(row, walk.s_cur) >= 0) ? 1 : 0;
    } else {
      const bool admitted = kPass != kAdmitted || adm[i] != 0;
      LaneHead<T> head;
      out[i] = resolve(tab, row, walk.w, walk.s_cur, walk.need, walk.tet, admitted, walk.px,
                       walk.py, walk.pz, walk.vx, walk.vy, walk.vz, walk.actf, 1, bounce_on,
                       esc_on, &head) ? 1 : 0;
      store_row_vec<T, ROW>(me, head.v);
      if (head.hopped) store_row_vec<T, ROW_W>(me + ROW, row);
      phase[i] = walk.phase_after(k);
    }
    return;
  }

  if constexpr (kTile) {
    // Every lane of the block works (trip 0): the block's run of rows goes
    // through the tile as in stream_kernel, the flags through shared memory.
    __shared__ typename TL::V tile[LANES * TL::CH];
    __shared__ T s_xi[kPhilox ? 1 : LANES * 3];  // a warp's triples of one sub-step
    __shared__ __align__(16) uint8_t s_phase[LANES];
    __shared__ __align__(16) uint8_t s_pend[LANES];
    const int lane = r & 31, warp = r >> 5;
    T* blk = m + base * WIDTH;
    TL::stage_in(tile, blk, rows);

    if (working) {
      T hd[ROW];
      TL::template read<0, ROW>(tile, r, hd);
      TL::template read<ROW, ROW_W>(tile, r, row);
      walk.start(hd, row, use_adv);
    } else {
      walk.need = false;
    }
    for (int ph = 0; ph < k; ++ph) {
      // the warp's lanes that run sub-step ph: from their phase until they stop
      const bool ex = working && !walk.need && ph >= ph0;
      const unsigned run = __ballot_sync(FULL, ex);
      if (run == 0) continue;
      T z[3] = {T(0), T(0), T(0)};
      if (use_brown) {
        if constexpr (kPhilox) {
          if (ex) philox_normals3(PhiloxKey{key.k0, key.k1, key.k2, key.k3 + ph}, i, z);
        } else {
          // xi[ph, lanes of this warp, :]: 96 contiguous elements, element e
          // belongs to the warp's lane e / 3
          const T* src = xi + (static_cast<long long>(ph) * n + base + 32 * warp) * 3;
          T* wx = s_xi + 96 * warp;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int e = lane + 32 * q;
            if ((run >> (e / 3)) & 1u) wx[e] = src[e];
          }
          __syncwarp();
          if (ex) {
            z[0] = wx[3 * lane];
            z[1] = wx[3 * lane + 1];
            z[2] = wx[3 * lane + 2];
          }
          __syncwarp();
        }
      }
      if (ex) walk.step(row, z, ph, dt, sigma, use_adv, use_brown);
    }

    if (working) {
      LaneHead<T> head;
      s_pend[r] = resolve(tab, row, walk.w, walk.s_cur, walk.need, walk.tet, true, walk.px,
                          walk.py, walk.pz, walk.vx, walk.vy, walk.vz, walk.actf, 1, bounce_on,
                          esc_on, &head) ? 1 : 0;
      TL::template write<0, ROW>(tile, r, head.v);
      if (head.hopped) store_row_vec<T, ROW_W>(me + ROW, row);
      s_phase[r] = walk.phase_after(k);
    }
    TL::stage_out_heads(tile, blk, rows);  // begins with the block barrier
    store_flags<LANES>(pend + base, s_pend, rows);
    store_flags<LANES>(phase + base, s_phase, rows);
  }
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
  constexpr int lanes = Tile<T>::LANES;
  const unsigned blocks = static_cast<unsigned>((n + lanes - 1) / lanes);
  auto kernel = noise_mode == 1 ? macro_instance<T, true>(pass) : macro_instance<T, false>(pass);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, lanes, 0, static_cast<cudaStream_t>(stream)>>>(
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
