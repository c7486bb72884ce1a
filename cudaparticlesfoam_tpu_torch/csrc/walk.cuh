// The bounded barycentric walk of one lane (_walk_mega, baryTetSearch,
// RTQuery.cu:35-90), shared by rare_kernel (rare.cu: the walk of a pending
// lane and each re-walk after a bounce) and the RK4 instantiations of
// stream_kernel (stream.cu: the walk of a stage point), so that both run the
// same code.
#pragma once

#include "common.cuh"
#include "tile.cuh"

namespace cpf {

// _walk_mega for one lane toward (px, py, pz) from the row `row` of tet
// `*tet`: returns the hosting tet, -(lastTet+1) on a domain exit, or the last
// tet when out of hops, in `*tet`; `row` ends as the row of the last
// non-negative tet, `slot` as the last crossed face.  max(2, max_hops) hops
// (the JAX package unrolls two before its bounded loop).
template <typename T, typename L>
__device__ void walk(const T* __restrict__ tab, T* row, int* tet, int* slot,
                     T px, T py, T pz, int max_hops) {
  *slot = 0;
  if (*tet < 0) return;
  const int bound = max_hops > 2 ? max_hops : 2;
  for (int h = 0; h < bound; ++h) {
    T w[4], wmin;
    bary(row, px, py, pz, w);
    const int s = argmin4(w, &wmin);
    if (wmin >= T(0)) return;
    const int code = code_of<T, L>(row, s);
    *slot = s;
    if (code < 0) {
      *tet = -(*tet + 1);
      return;
    }
    *tet = code;
    load_row_vec<T, L::ROW_W>(tab + static_cast<long long>(code) * L::ROW_W, row);
  }
}

}  // namespace cpf
