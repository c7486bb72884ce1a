// A block's tile of mega rows in shared memory, for the staged stream kernels
// (stream.cu, convex_stream.cu, macro.cu).
//
// A block owns LANES consecutive lanes (one thread each); their rows are one
// contiguous run of LANES * WIDTH * sizeof(T) bytes of the mega.  The block
// copies that run into shared memory with 16 B vector loads, consecutive
// threads on consecutive addresses (thread t moves chunk t + LANES * j), so
// every warp-wide access is four whole 128 B lines; the block writes the rows'
// heads back the same way.  In between, each thread reads its own row from
// the tile and writes its head into it as 16 B chunks.
//
// Swizzle: chunk c of tile row r lives at chunk slot r * CH + (c ^ (r & 7)).
// A row is 128 B (float) or 256 B (double), so without it the 8 threads of a
// quarter-warp that each touch chunk c of their own row would all hit the
// same 16 B bank group (an 8-way conflict on 16 B accesses, 32-way on 4 B
// ones); with it they hit 8 distinct groups, on the cooperative copy and on
// the per-row access alike.  Every access goes through slot().
//
// Size: 32 KB (TILE_BYTES, within the 48 KB of static shared memory): 256
// lanes of float or 128 of double.  A 128-lane float tile was no faster.
//
// A layout whose row is not a power of two chunks wide (LayoutPk: 40 columns,
// 10 chunks of float or 20 of double) cannot take the xor, which would leave
// the row.  Its tile rows are pitched one chunk wider than the row instead
// (11 or 21 chunks, an odd count), so 8 consecutive rows start in 8 distinct
// bank groups and the per-row accesses spread as the xor spreads them; the
// tile holds as many whole warps as fit in TILE_BYTES (160 lanes of float,
// 96 of double).
#pragma once

#include "common.cuh"

namespace cpf {

constexpr int TILE_BYTES = 32768;

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  __device__ __forceinline__ static void get(const float4& v, float* d) {
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
  __device__ __forceinline__ static float4 make(const float* s) {
    return make_float4(s[0], s[1], s[2], s[3]);
  }
};
template <> struct Vec16<double> {
  using type = double2;
  __device__ __forceinline__ static void get(const double2& v, double* d) {
    d[0] = v.x; d[1] = v.y;
  }
  __device__ __forceinline__ static double2 make(const double* s) {
    return make_double2(s[0], s[1]);
  }
};

template <typename T, typename L = LayoutTet>
struct Tile {
  using V = typename Vec16<T>::type;
  static constexpr int WIDTH = L::WIDTH;
  static constexpr int EPC = 16 / sizeof(T);               // elements per 16 B chunk
  static constexpr int CH = WIDTH / EPC;                   // chunks per mega row
  static constexpr bool XOR = (CH & (CH - 1)) == 0;        // power of two: xor swizzle
  static constexpr int PITCH = XOR ? CH : (CH | 1);        // chunks per tile row
  static constexpr int LANES = TILE_BYTES / (PITCH * 16) / 32 * 32;
  static_assert(WIDTH % EPC == 0 && (XOR ? CH >= 8 : PITCH % 2 == 1), "row must be whole chunks");
  static_assert(LANES % 32 == 0 && LANES > 0 && LANES <= 1024, "tile must hold whole warps");

  __device__ __forceinline__ static int slot(int r, int c) {
    if constexpr (XOR) {
      return r * CH + (c ^ (r & 7));
    } else {
      return r * PITCH + c;
    }
  }

  // rows [0, rows) of the block's run at `src` into the tile; ends with a
  // block barrier
  __device__ __forceinline__ static void stage_in(V* tile, const T* __restrict__ src, int rows) {
    const V* s = reinterpret_cast<const V*>(src);
    const int total = rows * CH;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int g = threadIdx.x + j * LANES;
      if (g < total) tile[slot(g / CH, g % CH)] = s[g];
    }
    __syncthreads();
  }

  // the heads (columns 0:ROW, whole 32 B sectors) of tile rows [0, rows)
  // back to `dst`, after a block barrier
  __device__ __forceinline__ static void stage_out_heads(const V* tile, T* __restrict__ dst,
                                                         int rows) {
    constexpr int chunks = ROW / EPC;
    __syncthreads();
    V* d = reinterpret_cast<V*>(dst);
    const int total = rows * chunks;
    for (int g = threadIdx.x; g < total; g += LANES) {
      const int r = g / chunks, c = g % chunks;
      d[r * CH + c] = tile[slot(r, c)];
    }
  }

  // columns [col0, col0 + n) of tile row r (whole chunks), to or from a
  // register array
  template <int col0, int n>
  __device__ __forceinline__ static void read(const V* tile, int r, T* out) {
    static_assert(col0 % EPC == 0 && n % EPC == 0, "whole 16 B chunks only");
#pragma unroll
    for (int k = 0; k < n; k += EPC) Vec16<T>::get(tile[slot(r, (col0 + k) / EPC)], out + k);
  }
  template <int col0, int n>
  __device__ __forceinline__ static void write(V* tile, int r, const T* in) {
    static_assert(col0 % EPC == 0 && n % EPC == 0, "whole 16 B chunks only");
#pragma unroll
    for (int k = 0; k < n; k += EPC) tile[slot(r, (col0 + k) / EPC)] = Vec16<T>::make(in + k);
  }
};

// A block's run of `rows` flag bytes (one per lane, `rows` <= LANES) from
// shared memory at `s` to global memory at `g` (both 16 B aligned): one 16 B
// store per 16 lanes by the block's first LANES / 16 threads, single bytes
// only in a ragged last chunk.  The caller places the block barrier.
template <int LANES>
__device__ __forceinline__ void store_flags(uint8_t* __restrict__ g, const uint8_t* s, int rows) {
  if (threadIdx.x < LANES / 16) {
    const int o = 16 * threadIdx.x;
    if (o + 16 <= rows) {
      *reinterpret_cast<uint4*>(g + o) = *reinterpret_cast<const uint4*>(s + o);
    } else {
      for (int q = o; q < rows; ++q) g[q] = s[q];
    }
  }
}

// A table row of `n` elements (a multiple of EPC, 16 B aligned) through the
// read-only path as 16 B vectors, in element order.
template <typename T, int n>
__device__ __forceinline__ void load_row_vec(const T* __restrict__ src, T* row) {
  using V = typename Vec16<T>::type;
  constexpr int EPC = 16 / sizeof(T);
  static_assert(n % EPC == 0, "row width must be whole 16 B chunks");
  const V* s = reinterpret_cast<const V*>(src);
#pragma unroll
  for (int k = 0; k < n / EPC; ++k) Vec16<T>::get(__ldg(s + k), row + k * EPC);
}

// `n` elements (a multiple of EPC, 16 B aligned) of memory the kernel also
// writes, as 16 B vectors: a lane that reads its own mega row.
template <typename T, int n>
__device__ __forceinline__ void load_vec(const T* src, T* out) {
  using V = typename Vec16<T>::type;
  constexpr int EPC = 16 / sizeof(T);
  static_assert(n % EPC == 0, "whole 16 B chunks only");
  const V* s = reinterpret_cast<const V*>(src);
#pragma unroll
  for (int k = 0; k < n / EPC; ++k) Vec16<T>::get(s[k], out + k * EPC);
}

// A row of `n` elements (a multiple of EPC) to `dst` (16 B aligned) as 16 B
// vectors: whole 32 B sectors, for a lane that writes its own mega row.
template <typename T, int n>
__device__ __forceinline__ void store_row_vec(T* __restrict__ dst, const T* row) {
  using V = typename Vec16<T>::type;
  constexpr int EPC = 16 / sizeof(T);
  static_assert(n % EPC == 0, "row width must be whole 16 B chunks");
  V* d = reinterpret_cast<V*>(dst);
#pragma unroll
  for (int k = 0; k < n / EPC; ++k) d[k] = Vec16<T>::make(row + k * EPC);
}

}  // namespace cpf
