// convex_rare_kernel<T>: the rare stage of one ConvexPoly sub-step.
//
// Replaces the XLA convex rare stage of
// cudaparticlesfoam_tpu/ops/fused_convex.py: _rare_stage / _rare_stage_packed
// (270, 327) with the lane resolver _make_run_lanes (222), which runs
// ops/convex.py trace_segment (particleLocator, ConvexQuery.cu:32-216) and
// convex_reflect (convexReflector, ConvexQuery.cu:239-436) and, with
// convex_bary_fix, ops/locate.py walk + reflect_walls (baryTetSearch +
// RTreflection, RTQuery.cu:35-186) on the landed point.  The plain version
// is ops/fused_convex.py:convex_rare_plain.
//
// JAX runs each stage as a lockstep while_loop over all lanes; every one of
// them freezes a finished lane, so a per-lane loop with the same bound
// gives the same result.  Kept from the JAX package: wall codes
// -(startTet+1); the main trace bounded by max_hops, every re-trace after a
// bounce by the default 50 tets; at most 5 convex bounces; absorbing faces
// park the lane at the hit point with its wall code and no displacement;
// the safety net mirrors across the OUTWARD face plane (tet_face_n /
// tet_face_d), not along the Tinv gradient of rare.cu; the active column is
// left untouched.
//
// Tables: tet_row_cx (planes, neighbour codes and face ids of the trace and
// the face matching), tet_a / tet_tinv / tet_nbr (the walk), tet_face_n /
// tet_face_d (reflect_walls), bd_escape, and cx_table for the row refresh.
//
// What bounds it on the H100: latency.  A pending lane is a dependent chain
// of row loads: its flag and mega row, one cx row per traced tet (and per
// re-traced tet after each bounce), with convex_bary_fix one walk row and
// one neighbour entry per hop and one face plane per bounce, and the
// refreshed cx_table row (ops/fused_convex.py:rare_chain counts them).
// The kernel runs in the frame of pending.cuh: one wave of resident blocks
// that compact their own pending lanes, so it lasts about the longest
// chain.  The head, each traced cx row and the refreshed row move as 16 B
// vectors (the face matching and the mirror re-read the row the trace
// ended in, from the cache).
#include "convex.cuh"
#include "pending.cuh"

namespace cpf {

template <typename T>
struct Tables {
  const T* tab;      // cx_table [nt, 24]
  const T* cx;       // tet_row_cx [nt, 24]
  const T* a;        // tet_a [nt, 3]
  const T* tinv;     // tet_tinv [nt, 3, 3]
  const int* nbr;    // tet_nbr [nt, 4]
  const T* face_n;   // tet_face_n [nt, 4, 3]
  const T* face_d;   // tet_face_d [nt, 4]
  const uint8_t* bd_escape;
  int nbd;
};

template <typename T>
__device__ __forceinline__ const T* cx_row(const Tables<T>& tb, int tet) {
  return tb.cx + static_cast<long long>(tet < 0 ? 0 : tet) * CX_W;
}

// trace_segment for one lane: marches pos -> pos + disp from tet_id.
// Returns the code (hosting tet, or -(tet_id+1) on a wall hit, or tet_id
// for a lane that is not live); stop_tet, p_cross and last_face as in
// ops/convex.py.
template <typename T>
__device__ int trace(const Tables<T>& tb, const T pos[3], const T disp[3], int tet_id,
                     int max_tets, int* stop_tet, T p_cross[3], int* last_face) {
  const T pe[3] = {pos[0] + disp[0], pos[1] + disp[1], pos[2] + disp[2]};
  T p0[3] = {pos[0], pos[1], pos[2]};
  int tet = tet_id < 0 ? 0 : tet_id;
  int inlet = -2;
  bool hit_wall = false;
  if (tet_id >= 0) {
    for (int it = 0; it < max_tets; ++it) {
      const T seg[3] = {pe[0] - p0[0], pe[1] - p0[1], pe[2] - p0[2]};
      T r[CX_W];
      load_row_vec<T, CX_W>(cx_row(tb, tet), r);
      int sup = 0;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if (static_cast<int>(r[CX_FID + f]) == inlet) sup |= 1 << f;
      }
      T dt_;
      const int slot = cx_exit(r, p0, seg, sup, &dt_);
      if (slot < 0) break;  // the segment ends inside
      const int nxt = static_cast<int>(pick4(r + CX_NBR, slot));
      const int fid = static_cast<int>(pick4(r + CX_FID, slot));
#pragma unroll
      for (int k = 0; k < 3; ++k) p0[k] = p0[k] + dt_ * seg[k];
      inlet = fid;
      if (nxt < 0) {
        hit_wall = true;
        break;
      }
      tet = nxt;
    }
  }
  *stop_tet = tet;
  *last_face = inlet;
#pragma unroll
  for (int k = 0; k < 3; ++k) p_cross[k] = p0[k];
  if (tet_id < 0) return tet_id;
  return hit_wall ? -(tet_id + 1) : tet;
}

// Slot of the face that ended a trace in `tet` (ops/convex.py:_face_slot):
// first minimum of (id match -> -1, boundary -> plane distance, else inf).
template <typename T>
__device__ int face_slot(const Tables<T>& tb, int tet, const T p[3], int fid) {
  const T* r = cx_row(tb, tet);
  int slot = 0;
  T best = T(0);
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    T score;
    if (static_cast<int>(r[CX_FID + f]) == fid) {
      score = T(-1);
    } else if (static_cast<int>(r[CX_NBR + f]) < 0) {
      score = fabs(r[CX_D + f] - dot3(r + 3 * f, p));
    } else {
      score = T(INFINITY);
    }
    if (f == 0 || score < best) {
      best = score;
      slot = f;
    }
  }
  return slot;
}

template <typename T>
__device__ bool escapes_at(const Tables<T>& tb, int tet, const T p[3], int fid) {
  if (tb.nbd == 0) return false;
  const int code = static_cast<int>(cx_row(tb, tet)[CX_NBR + face_slot(tb, tet, p, fid)]);
  int bd = -code - 1;
  bd = bd < 0 ? 0 : (bd > tb.nbd - 1 ? tb.nbd - 1 : bd);
  return code < 0 && tb.bd_escape[bd];
}

// Mirror p_end and u across the plane of the face that ended a trace.
template <typename T>
__device__ void mirror(const Tables<T>& tb, T p_end[3], T u[3], int tet, const T p_at[3],
                       int fid) {
  const T* r = cx_row(tb, tet);
  const int s = face_slot(tb, tet, p_at, fid);
  const T* n = r + 3 * s;
  const T fp = T(2) * (dot3(p_end, n) - r[CX_D + s]);
  const T fu = T(2) * dot3(u, n);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p_end[k] = p_end[k] - fp * n[k];
    u[k] = u[k] - fu * n[k];
  }
}

// convex_reflect for one lane after the main trace (code < 0 = wall hit).
// Updates pos, disp, vel; returns the new code.
template <typename T>
__device__ int convex_reflect(const Tables<T>& tb, T pos[3], T disp[3], T vel[3],
                              int code, int stop_tet, const T p_cross[3], int hit_face) {
  if (code >= 0) return code;
  T p_end[3] = {pos[0] + disp[0], pos[1] + disp[1], pos[2] + disp[2]};
  T u[3] = {vel[0], vel[1], vel[2]};
  T p_hit[3] = {p_cross[0], p_cross[1], p_cross[2]};
  T p_start[3] = {p_cross[0], p_cross[1], p_cross[2]};
  int tet = stop_tet;
  bool esc = escapes_at(tb, tet, p_cross, hit_face);
  if (!esc) {
    mirror(tb, p_end, u, tet, p_cross, hit_face);  // first bounce
    for (int b = 0; b < CX_MAX_BOUNCES; ++b) {
      const T d[3] = {p_end[0] - p_start[0], p_end[1] - p_start[1], p_end[2] - p_start[2]};
      int s_tet, l_face;
      T p_cr[3];
      const int c2 = trace(tb, p_start, d, tet < 0 ? 0 : tet, CX_MAX_TETS, &s_tet, p_cr,
                           &l_face);
      if (c2 >= 0) {  // landed
        tet = c2;
        break;
      }
      tet = s_tet;
#pragma unroll
      for (int k = 0; k < 3; ++k) p_hit[k] = p_cr[k];
      if (escapes_at(tb, s_tet, p_cr, l_face)) {
        esc = true;
        break;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) p_start[k] = p_cr[k];
      mirror(tb, p_end, u, tet, p_cr, l_face);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    disp[k] = esc ? T(0) : p_end[k] - p_hit[k];
    pos[k] = p_hit[k];
    vel[k] = u[k];
  }
  return esc ? code : tet;
}

// ops/locate.py walk for one lane: (tet, slot) after at most max_hops hops.
template <typename T>
__device__ int bary_walk(const Tables<T>& tb, const T p[3], int tet, int max_hops,
                         int* slot) {
  *slot = -1;
  if (tet < 0) return tet;
  for (int h = 0; h < max_hops; ++h) {
    const T* a = tb.a + static_cast<long long>(tet) * 3;
    const T* t = tb.tinv + static_cast<long long>(tet) * 9;
    const T rel[3] = {p[0] - a[0], p[1] - a[1], p[2] - a[2]};
    T w[4];
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k + 1] = dot3(t + 3 * k, rel);
    w[0] = T(1) - ((w[1] + w[2]) + w[3]);
    T wmin;
    const int s = argmin4(w, &wmin);
    if (wmin >= T(0)) return tet;
    const int nb = tb.nbr[static_cast<long long>(tet) * 4 + s];
    *slot = s;
    if (nb < 0) return -(tet + 1);
    tet = nb;
  }
  return tet;
}

// ops/locate.py reflect_walls for one lane with zero displacement at
// p_land: returns the new code, adds the fix to d2 and updates vel.
template <typename T>
__device__ int reflect_walls(const Tables<T>& tb, const T p_land[3], T d2[3], T vel[3],
                             int tet_id, int max_bounces) {
  T p_ref[3] = {p_land[0] + T(0), p_land[1] + T(0), p_land[2] + T(0)};
  T d_fix[3] = {T(0), T(0), T(0)};
  if (tet_id < 0) {
    int tet_bd = -(tet_id + 1);
    T u[3] = {vel[0], vel[1], vel[2]};
    for (int b = 0; b < max_bounces; ++b) {
      int wslot;
      const int wtet = bary_walk(tb, p_ref, tet_bd, MAX_HOPS_DEFAULT, &wslot);
      if (wtet >= 0) {
        tet_bd = wtet;
        break;
      }
      const int ex_tet = -(wtet + 1);
      const int ex_slot = wslot < 0 ? 0 : wslot;
      const long long fs = static_cast<long long>(ex_tet) * 4 + ex_slot;
      const int code_nbr = tb.nbr[fs];
      if (tb.nbd > 0 && code_nbr < 0) {
        int bd = -code_nbr - 1;
        bd = bd > tb.nbd - 1 ? tb.nbd - 1 : bd;
        if (tb.bd_escape[bd]) {  // absorbing (outlet) face
          tet_bd = -(ex_tet + 1);
          break;
        }
      }
      const T* n = tb.face_n + fs * 3;
      const T fp = T(2) * (dot3(p_ref, n) - tb.face_d[fs]);
      const T fu = T(2) * dot3(u, n);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p_ref[k] = p_ref[k] - fp * n[k];
        u[k] = u[k] - fu * n[k];
      }
      tet_bd = ex_tet;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d_fix[k] = p_ref[k] - p_land[k];
      vel[k] = u[k];
    }
    tet_id = tet_bd;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) d2[k] = d2[k] + d_fix[k];
  return tet_id;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
convex_rare_kernel(Tables<T> tb, T* __restrict__ m, const T* __restrict__ disp,
                   const uint8_t* __restrict__ pend, long long n, int max_hops,
                   int reflect_wall, int bary_fix, int max_bounces) {
  for_each_pending(pend, n, [&](long long i) {
    T* me = m + i * WIDTH;
    T head[ROW];
    load_vec<T, ROW>(me, head);
    T pos[3] = {head[P0], head[P0 + 1], head[P0 + 2]};
    T vel[3] = {head[V0], head[V0 + 1], head[V0 + 2]};
    T d2[3] = {disp[3 * i], disp[3 * i + 1], disp[3 * i + 2]};
    int stop_tet, hit_face;
    T p_cross[3];
    int code = trace(tb, pos, d2, static_cast<int>(head[TET]), max_hops, &stop_tet, p_cross,
                     &hit_face);
    if (reflect_wall) {
      code = convex_reflect(tb, pos, d2, vel, code, stop_tet, p_cross, hit_face);
      if (bary_fix) {
        const T p_land[3] = {pos[0] + d2[0], pos[1] + d2[1], pos[2] + d2[2]};
        int wslot;
        const int tet_chk = bary_walk(tb, p_land, code, MAX_HOPS_DEFAULT, &wslot);
        code = reflect_walls(tb, p_land, d2, vel, tet_chk, max_bounces);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      head[P0 + k] = pos[k] + d2[k];
      head[V0 + k] = vel[k];
    }
    head[TET] = static_cast<T>(code);
    store_row_vec<T, ROW>(me, head);
    T row[CX_W];
    load_row_vec<T, CX_W>(tb.tab + static_cast<long long>(code < 0 ? 0 : code) * CX_W, row);
    store_row_vec<T, CX_W>(me + ROW, row);
  });
}

// The grid of one instantiation over n lanes (pending.cuh), its resident
// block count cached per device.
template <typename T>
cudaError_t convex_rare_grid(long long n, int* blocks) {
  static int cache[MAX_DEVICES] = {};
  return pending_grid(convex_rare_kernel<T>, n, cache, blocks);
}

template <typename T>
int launch_convex_rare(const void* tab, const void* cx, const void* a, const void* tinv,
                       const void* nbr, const void* face_n, const void* face_d,
                       const void* bd_escape, void* m, const void* disp, const void* pend,
                       long long n, int nbd, int max_hops, int reflect_wall, int bary_fix,
                       int max_bounces, void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  const cudaError_t err = convex_rare_grid<T>(n, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables<T> tb{static_cast<const T*>(tab), static_cast<const T*>(cx),
                     static_cast<const T*>(a), static_cast<const T*>(tinv),
                     static_cast<const int*>(nbr), static_cast<const T*>(face_n),
                     static_cast<const T*>(face_d), static_cast<const uint8_t*>(bd_escape),
                     nbd};
  convex_rare_kernel<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tb, static_cast<T*>(m), static_cast<const T*>(disp),
      static_cast<const uint8_t*>(pend), n, max_hops, reflect_wall, bary_fix, max_bounces);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int convex_grid_or_error(long long n) {
  int blocks = 0;
  const cudaError_t err = convex_rare_grid<T>(n, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace cpf

#define CPF_CONVEX_RARE(SUFFIX, T)                                                      \
  extern "C" int cpf_convex_rare_##SUFFIX(                                              \
      const void* tab, const void* cx, const void* a, const void* tinv, const void* nbr, \
      const void* face_n, const void* face_d, const void* bd_escape, void* m,           \
      const void* disp, const void* pend, long long n, int nbd, int max_hops,           \
      int reflect_wall, int bary_fix, int max_bounces, void* stream) {                  \
    return cpf::launch_convex_rare<T>(tab, cx, a, tinv, nbr, face_n, face_d, bd_escape, \
                                      m, disp, pend, n, nbd, max_hops, reflect_wall,    \
                                      bary_fix, max_bounces, stream);                   \
  }
CPF_CONVEX_RARE(f32, float)
CPF_CONVEX_RARE(f64, double)

extern "C" int cpf_convex_rare_grid_f32(long long n) { return cpf::convex_grid_or_error<float>(n); }
extern "C" int cpf_convex_rare_grid_f64(long long n) { return cpf::convex_grid_or_error<double>(n); }
