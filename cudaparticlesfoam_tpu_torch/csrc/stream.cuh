// The per-lane pieces of the bary stream, shared by stream_kernel (one sub-step,
// stream.cu) and macro_stream_kernel (up to k sub-steps, macro.cu), so that the
// two run the same expressions and agree bit for bit: the Brownian normals of one
// lane, and the resolution after the hop-0 test (inline hops, the inline bounce
// or absorb, the lane's mega row and its pending flag).
#pragma once

#include "common.cuh"
#include "philox.cuh"
#include "tile.cuh"

namespace cpf {

// The passes of a stream kernel.  The compacted hop gather (hop_compact=4,
// fused_pallas._compact_hop_rows) needs every lane's crossing flag before any
// hop: kCrossers writes the flags, hop_admit_kernel turns them into admission
// flags, and kAdmitted recomputes the sub-step and resolves it.  A template
// argument, so the kWhole instantiation carries none of it.
enum StreamPass : int {
  kWhole = 0,     // the cycle as it is
  kCrossers = 1,  // flag stage: adm[i] = hop-0 crosser (HMV); the mega is left alone
  kAdmitted = 2,  // apply stage: a crosser whose adm[i] is 0 skips its hop
};

// Standard normals of lane i: drawn in the kernel (Philox) or read from xi [n, 3].
template <typename T, bool kPhilox>
__device__ __forceinline__ void lane_normals(const PhiloxKey& key, const T* __restrict__ xi,
                                             long long i, T z[3]) {
  if (kPhilox) {
    philox_normals3(key, i, z);
  } else {
    z[0] = xi[3 * i];
    z[1] = xi[3 * i + 1];
    z[2] = xi[3 * i + 2];
  }
}

// A lane's mega head after its sub-step: pos, vel, tet, active (columns 0:8;
// its cached row is the `row` resolve() leaves, new if `hopped`).
template <typename T>
struct LaneHead {
  T v[ROW];
  bool hopped;
};

// Everything after the hop-0 test of the moved point (px, py, pz) against the
// cached row: `w`/`s_cur` are its weights and exit slot, `unresolved` the
// crossing test, `tet` the lane's tet.  Up to n_hops inline hops (each mover
// loads its neighbour's row as 16 B vectors); a crosser that was not
// `admitted` skips its first hop and stays pending with its cached row and
// pre-hop tet, keeping the moved point (_b_compute_c with extra_pend,
// fused_pallas.py:371-396).  Then the inline single bounce on the last hop's
// weights, or an absorb through the row's escape mask (fused.py:729-762).
// Leaves the lane's new head in `out` and its cached row in `row`, and
// returns its pending flag; the caller stores them (the head through its
// staged tile, a new row with store_row_vec).  The layout L gives the row's
// width and the columns of its neighbour codes and escape mask.
template <typename T, typename L = LayoutTet>
__device__ __forceinline__ bool resolve(const T* __restrict__ tab, T row[L::ROW_W], T w[4],
                                        int s_cur, bool unresolved, int tet, bool admitted,
                                        T px, T py, T pz, T vx, T vy, T vz, T actf, int n_hops,
                                        int bounce_on, int esc_on, LaneHead<T>* out) {
  T wmin;
  int cur_tet = tet;
  bool wall = false;
  int wall_slot = 0;

  // inline hops; a lane that is resolved would only recompute the same
  // weights, so it leaves the loop
  for (int h = 0; h < n_hops && unresolved; ++h) {
    const int code = code_of<T, L>(row, s_cur);
    if (code < 0) {
      wall = true;
      wall_slot = s_cur;
      unresolved = false;
      break;
    }
    if (!admitted) break;
    load_row_vec<T, L::ROW_W>(tab + static_cast<long long>(code) * L::ROW_W, row);
    cur_tet = code;
    bary(row, px, py, pz, w);
    s_cur = argmin4(w, &wmin);
    unresolved = wmin < T(0);
  }

  int tet1 = cur_tet;
  if (n_hops > 0 && bounce_on) {
    bool refl = wall;
    bool esc = false;
    if (esc_on) {
      const int code_w = code_of<T, L>(row, wall_slot);
      const int escm = static_cast<int>(row[L::ESC]);
      esc = wall && code_w < 0 && ((escm >> wall_slot) & 1);
      refl = wall && !esc;
    }
    const T rf = refl ? T(1) : T(0);
    T gx, gy, gz;
    grad(row, wall_slot, &gx, &gy, &gz);
    const T wv = pick4(w, wall_slot);
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

  out->v[P0] = px;
  out->v[P0 + 1] = py;
  out->v[P0 + 2] = pz;
  out->v[V0] = vx;
  out->v[V0 + 1] = vy;
  out->v[V0 + 2] = vz;
  out->v[TET] = static_cast<T>(tet1);
  out->v[ACT] = actf;
  out->hopped = cur_tet != tet;
  return unresolved || wall;
}

}  // namespace cpf
