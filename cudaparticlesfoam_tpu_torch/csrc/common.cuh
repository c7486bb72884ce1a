// Shared device helpers of the particle stepper kernels (stream.cu, rare.cu).
//
// Layout (ops/fused.py): the mega state is row-major [n, 32] (128 B per lane
// in float32): 0:3 pos | 3:6 vel | 6 tet (exact float integer) | 7 active |
// 8:28 cached tet row | 28:32 pad.  A tet row [20] is A 0:3 | Tinv 3:12
// (row-major) | u 12:15 | neighbour codes 15:19 | escape mask 19.
//
// That is the TetVelocity layout (LayoutTet; the constants below, which the
// kernels that exist for it alone read directly).  The VertexVelocity layout
// (LayoutPk) keeps the head and A | Tinv where they are and differs after
// them: a table row is A 0:3 | Tinv 3:12 | the 4 vertex velocities v0..v3
// 12:24 | neighbour codes 24:28 | escape mask 28 | zero pad 29:32, a copy of
// mesh.tet_row_pk [nt, 29] padded to 32 columns (fused.row_table) so that
// every row starts on a 16 B boundary (128 B a row in float32); the mega is
// [n, 40], head 0:8 and one such padded row at 8:40.  A kernel that serves
// both takes the layout as a template argument, TetVelocity by default.
//
// Every expression keeps the association order of the plain PyTorch
// version in ops/fused.py (which copies cudaparticlesfoam_tpu/ops/fused.py);
// the library is built with --fmad=false, so no multiply-add is contracted
// and a kernel agrees with its plain version op for op.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cpf {

constexpr int P0 = 0, V0 = 3, TET = 6, ACT = 7, ROW = 8, WIDTH = 32;
constexpr int ROW_W = 20, VEL = 12, NBR = 15, ESC = 19;
constexpr int MAX_HOPS_DEFAULT = 50;  // RTQuery.cu:42 (the re-walk bound)
constexpr int THREADS = 256;

// Row-table geometry of an interpolation mode: the mega width, the width of
// the row block a lane caches and a hop moves (the table's row pitch), the
// row offsets of the velocity payload, the neighbour codes and the escape
// mask, and whether the advecting velocity is blended from 4 vertex
// velocities (Pk, particles.cu:245-313) or read as it is.
struct LayoutTet {
  static constexpr int WIDTH = cpf::WIDTH, ROW_W = cpf::ROW_W, VEL = cpf::VEL,
                       NBR = cpf::NBR, ESC = cpf::ESC;
  static constexpr bool VERTEX = false;
};
struct LayoutPk {
  static constexpr int WIDTH = 40, ROW_W = 32, VEL = 12, NBR = 24, ESC = 28;
  static constexpr bool VERTEX = true;
};

// Barycentric weights of (px,py,pz) in a cached row (fused._bary4_rows).
template <typename T>
__device__ __forceinline__ void bary(const T* r, T px, T py, T pz, T w[4]) {
  const T rx = px - r[0];
  const T ry = py - r[1];
  const T rz = pz - r[2];
  const T wb = r[3] * rx + r[4] * ry + r[5] * rz;
  const T wc = r[6] * rx + r[7] * ry + r[8] * rz;
  const T wd = r[9] * rx + r[10] * ry + r[11] * rz;
  w[0] = T(1) - wb - wc - wd;
  w[1] = wb;
  w[2] = wc;
  w[3] = wd;
}

// First-minimum argmin with a strict '<' (fused._argmin4).
template <typename T>
__device__ __forceinline__ int argmin4(const T w[4], T* best) {
  int slot = 0;
  T b = w[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (w[i] < b) {
      b = w[i];
      slot = i;
    }
  }
  *best = b;
  return slot;
}

// a[slot] for a slot in 0..3, by selects: a register array indexed at run
// time would be placed in local memory
template <typename T>
__device__ __forceinline__ T pick4(const T* a, int slot) {
  return slot == 0 ? a[0] : slot == 1 ? a[1] : slot == 2 ? a[2] : a[3];
}

template <typename T, typename L = LayoutTet>
__device__ __forceinline__ int code_of(const T* row, int slot) {
  return static_cast<int>(pick4(row + L::NBR, slot));
}

// The advecting velocity of a lane at (px,py,pz) in its cached row: the row's
// tet velocity, or under LayoutPk the barycentric blend of its 4 vertex
// velocities at that point, ((w0 v0 + w1 v1) + w2 v2) + w3 v3 per component
// (fused._sub_step; fused_pallas._a_compute).
template <typename T, typename L>
__device__ __forceinline__ void row_velocity(const T* row, T px, T py, T pz, T u[3]) {
  if constexpr (L::VERTEX) {
    T w[4];
    bary(row, px, py, pz, w);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[c] = ((w[0] * row[L::VEL + c] + w[1] * row[L::VEL + 3 + c]) +
              w[2] * row[L::VEL + 6 + c]) + w[3] * row[L::VEL + 9 + c];
    }
  } else {
    u[0] = row[L::VEL];
    u[1] = row[L::VEL + 1];
    u[2] = row[L::VEL + 2];
  }
}

// Gradient of barycentric component `slot` (fused._grad_rows): row
// (slot-1) of Tinv, or -(sum of the three rows) for slot 0.
template <typename T>
__device__ __forceinline__ void grad(const T* r, int slot, T* gx, T* gy, T* gz) {
  T g[3];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    g[o] = slot == 0 ? -(r[3 + o] + r[6 + o] + r[9 + o])
                     : slot == 1 ? r[3 + o] : slot == 2 ? r[6 + o] : r[9 + o];
  }
  *gx = g[0];
  *gy = g[1];
  *gz = g[2];
}

}  // namespace cpf
