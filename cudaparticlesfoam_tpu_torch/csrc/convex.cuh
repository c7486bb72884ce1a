// Shared device helpers of the ConvexPoly kernels (convex_stream.cu,
// convex_rare.cu).
//
// Layout (ops/fused_convex.py): the convex mega is row-major [n, 32]:
// 0:3 pos | 3:6 vel | 6 tet | 7 active | 8:32 cached cx_table row.  A cx
// row [24] (tet_row_cx, and cx_table = tet_row_cxe) is outward plane
// normals 0:12 (face i at 3i..3i+2) | offsets 12:16 | neighbour codes 16:20
// | face ids 20:24 (tet_row_cx) or tet velocity 20:23 (cx_table).  Sums over
// xyz keep jnp's order ((x0 + x1) + x2); with --fmad=false each kernel
// agrees with its plain version (ops/convex.py, ops/fused_convex.py) op
// for op.
#pragma once

#include <math.h>

#include "common.cuh"

namespace cpf {

constexpr int CX_W = 24, CX_D = 12, CX_NBR = 16, CX_FID = 20, CX_VEL = 20;
constexpr double CX_TOL = 1e-13;   // ConvexQuery.cu:42
constexpr int CX_MAX_TETS = 50;    // ConvexQuery.cu:169
constexpr int CX_MAX_BOUNCES = 5;  // ConvexQuery.cu:353
constexpr int NO_INLET = -(1 << 30);

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// One traceIntet exit test (convex._exit_face_tables) on a cx row: the
// admitted face (face_dist < tol, tol < dT <= 1, not suppressed) with the
// least dT, scan order with a strict '<'; -1 when the segment p -> p + s
// ends inside.  `sup` is the 4-bit mask of suppressed faces.
template <typename T>
__device__ __forceinline__ int cx_exit(const T* __restrict__ r, const T p[3],
                                       const T s[3], int sup, T* best_dt) {
  const T tol = T(CX_TOL);
  T bdt = T(1.1);
  int bslot = -1;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const T* nf = r + 3 * f;
    const T face_dist = dot3(nf, p) - r[CX_D + f];
    const T denom = -dot3(nf, s);
    T dt_ = face_dist / denom;
    if (isinf(dt_)) dt_ = T(-1);  // parallel segment
    const bool ok = face_dist < tol && dt_ > tol && dt_ <= T(1) && !((sup >> f) & 1);
    const T dtm = ok ? dt_ : T(1.1);
    if (dtm < bdt) {
      bdt = dtm;
      bslot = f;
    }
  }
  *best_dt = bdt;
  return bslot;
}

}  // namespace cpf
