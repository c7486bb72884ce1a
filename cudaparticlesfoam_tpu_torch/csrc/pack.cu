// pack_kernel<T, W, TW> and unpack_kernel<T>: the mega array of a run_cycles
// call built from the particle state, and the state read back out of it
// (stepper.PackedRun: the pack at the call's entry, the result at its exit,
// and set_mesh between the two).
//
// They replace no TPU kernel: the JAX package builds and reads the mega with
// XLA ops (cudaparticlesfoam_tpu/ops/fused.py:pack_state and unpack_state).
// On the card the same chain of torch ops (a zeroed [n, W] mega, four
// strided column copies, the clamp of the tet ids, a row gather into an
// [n, TW] temporary and its strided copy; on the way out a cast, a compare,
// two clones and a fill) took 16 device operations and 1.14-1.34 ms a call
// at 1M lanes, half of a 10-sub-step call's device time.  The plain
// versions are ops/fused.py:pack_state and, on CPU tensors, the branch of
// ops/fused_cuda.py:unpack_rows that copies fused.unpack_state.
//
// The mega row (ops/fused.py, ops/fused_convex.py): 0:3 pos | 3:6 vel | 6 tet
// (the int as a float, exact) | 7 active (0 or 1) | 8:8+TW the lane's row of
// the table, row 0 for a negative tet (an escaped or absorbed lane keeps its
// negative code in column 6) | zeros up to W.  One template covers the three
// layouts the port packs, instantiated for the (W, TW) the C entry is handed:
// TetVelocity (32, 20), VertexVelocity (40, 32: the padded tet_row_pk32) and
// the convex engine (32, 24: cx_table, no pad).
//
// What bounds them on the H100: bytes, and the random gather of table rows.
// pack_kernel at 1M lanes in float32 under TetVelocity reads pos, vel, tet
// and active (29 MB) and one 80 B table row a lane (80-96 MB with 32 B
// sector rounding) and writes every 128 B mega row once (128 MB): 237-253 MB,
// 0.071-0.076 ms at 3.35 TB/s.  unpack_kernel reads the 32 B head of each row
// (32 MB) and writes pos, vel, disp (36 MB), tet (4 MB) and active (1 MB):
// 73 MB, 0.022 ms.  PERF.md has the measured times beside these bounds.
//
// Design.  pack_kernel gives each 16 B chunk of a mega row to one thread
// (W * sizeof(T) / 16 threads a row: 8 at W 32 in float32, 10 at W 40, twice
// as many in float64), so thread g writes chunk g of the mega and every warp
// store is 512 contiguous bytes: the mega is written once, whole and
// coalesced, with no separate memset.  A head chunk reads its columns from
// the structure-of-arrays inputs, neighbouring lanes on neighbouring
// addresses (pos and vel by their row stride, so a view such as m[:, 0:3]
// needs no copy); a row chunk loads its 16 B of the lane's table row through
// the read-only path (every layout's table rows start on 16 B boundaries);
// a pad chunk stores zeros.  The threads of one row read its tet together,
// one 4 B word the warp broadcasts.  unpack_kernel stages a block's 256
// heads in shared memory (read as 16 B vectors, the threads of a row on its
// one 32 B sector in float32), writes tet and active a lane a thread, and
// writes the block's run of pos, vel and zero disp as 16 B vectors.  One
// thread a lane storing its own three elements of each, every warp store a
// third used, took 0.055 ms a call inside a run_cycles window on an H100;
// this design takes 0.040 (alone, on one mega unpacked again and again,
// both take 0.057-0.059).  Both only move and convert exact values (int <->
// float with round-to-nearest and truncation, as torch's .to does), so they
// equal their plain versions bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace cpf {

constexpr int PACK_THREADS = 256;

template <typename T, int W, int TW>
__global__ void __launch_bounds__(PACK_THREADS)
pack_kernel(const T* __restrict__ tab, const T* __restrict__ pos, long long pos_stride,
            const T* __restrict__ vel, long long vel_stride, const int* __restrict__ tet,
            const uint8_t* __restrict__ act, T* __restrict__ m, long long n) {
  using V = typename Vec16<T>::type;
  constexpr int EPC = 16 / sizeof(T);   // elements a chunk
  constexpr int CPR = W / EPC;          // chunks a mega row
  constexpr int HEAD = ROW / EPC;       // chunks of the head, columns 0:8
  constexpr int CACHE = (ROW + TW) / EPC;
  static_assert(W % EPC == 0 && TW % EPC == 0 && ROW + TW <= W, "whole 16 B chunks");

  const long long g = static_cast<long long>(blockIdx.x) * PACK_THREADS + threadIdx.x;
  if (g >= n * CPR) return;
  const long long i = g / CPR;
  const int c = static_cast<int>(g - i * CPR);
  const int t = __ldg(tet + i);
  V out;
  if (c < HEAD) {
    T h[EPC];
#pragma unroll
    for (int k = 0; k < EPC; ++k) {
      const int col = c * EPC + k;
      if (col < V0) {
        h[k] = __ldg(pos + i * pos_stride + (col - P0));
      } else if (col < TET) {
        h[k] = __ldg(vel + i * vel_stride + (col - V0));
      } else if (col == TET) {
        h[k] = static_cast<T>(t);
      } else {
        h[k] = __ldg(act + i) ? T(1) : T(0);  // a torch bool is one byte, 0 or 1
      }
    }
    out = Vec16<T>::make(h);
  } else if (c < CACHE) {
    const V* row = reinterpret_cast<const V*>(tab + static_cast<long long>(max(t, 0)) * TW);
    out = __ldg(row + (c - HEAD));
  } else {
    const T z[EPC] = {};
    out = Vec16<T>::make(z);
  }
  reinterpret_cast<V*>(m)[g] = out;
}

template <typename T>
__global__ void __launch_bounds__(PACK_THREADS)
unpack_kernel(const T* __restrict__ m, int width, T* __restrict__ pos, T* __restrict__ vel,
              int* __restrict__ tet, bool* __restrict__ act, T* __restrict__ disp, long long n) {
  using V = typename Vec16<T>::type;
  constexpr int EPC = 16 / sizeof(T);
  constexpr int HC = ROW / EPC;  // 16 B chunks of a row's head
  __shared__ __align__(16) T head[PACK_THREADS * ROW];
  const long long lane0 = static_cast<long long>(blockIdx.x) * PACK_THREADS;
  const int rows = static_cast<int>(min(static_cast<long long>(PACK_THREADS), n - lane0));

  // the block's heads, HC threads a row: each warp load is whole 32 B sectors
  for (int q = threadIdx.x; q < rows * HC; q += PACK_THREADS) {
    const int r = q / HC;
    reinterpret_cast<V*>(head)[q] =
        __ldg(reinterpret_cast<const V*>(m + (lane0 + r) * width) + (q - r * HC));
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const T* h = head + threadIdx.x * ROW;
    tet[lane0 + threadIdx.x] = static_cast<int>(h[TET]);
    act[lane0 + threadIdx.x] = h[ACT] > T(0.5);
  }
  // pos, vel and disp: the block's 3 * rows elements of each, a contiguous
  // run that starts on a 16 B boundary, as 16 B stores; the ragged last
  // block's odd elements one by one
  const int len = 3 * rows, full = len / EPC, odd = len - full * EPC;
  for (int q = threadIdx.x; q < 3 * (full + odd); q += PACK_THREADS) {
    const int a = q < 3 * full ? q / full : (q - 3 * full) / odd;  // 0 pos, 1 vel, 2 disp
    T* out = (a == 0 ? pos : a == 1 ? vel : disp) + 3 * lane0;
    if (q < 3 * full) {
      const int j = q - a * full;
      T v[EPC];
#pragma unroll
      for (int k = 0; k < EPC; ++k) {
        const int e = j * EPC + k, r = e / 3;
        v[k] = a == 2 ? T(0) : head[r * ROW + 3 * a + (e - 3 * r)];
      }
      reinterpret_cast<V*>(out)[j] = Vec16<T>::make(v);
    } else {
      const int e = full * EPC + (q - 3 * full - a * odd), r = e / 3;
      out[e] = a == 2 ? T(0) : head[r * ROW + 3 * a + (e - 3 * r)];
    }
  }
}

template <typename T, int W, int TW>
int launch_pack_shape(const void* tab, const void* pos, long long pos_stride, const void* vel,
                      long long vel_stride, const void* tet, const void* act, void* m,
                      long long n, cudaStream_t stream) {
  constexpr long long CPR = W * sizeof(T) / 16;
  const long long blocks = (n * CPR + PACK_THREADS - 1) / PACK_THREADS;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  pack_kernel<T, W, TW><<<static_cast<unsigned>(blocks), PACK_THREADS, 0, stream>>>(
      static_cast<const T*>(tab), static_cast<const T*>(pos), pos_stride,
      static_cast<const T*>(vel), vel_stride, static_cast<const int*>(tet),
      static_cast<const uint8_t*>(act), static_cast<T*>(m), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pack(const void* tab, const void* pos, long long pos_stride, const void* vel,
                long long vel_stride, const void* tet, const void* act, void* m, long long n,
                int width, int tab_w, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 32 && tab_w == 20) {
    return launch_pack_shape<T, 32, 20>(tab, pos, pos_stride, vel, vel_stride, tet, act, m, n, s);
  }
  if (width == 40 && tab_w == 32) {
    return launch_pack_shape<T, 40, 32>(tab, pos, pos_stride, vel, vel_stride, tet, act, m, n, s);
  }
  if (width == 32 && tab_w == 24) {
    return launch_pack_shape<T, 32, 24>(tab, pos, pos_stride, vel, vel_stride, tet, act, m, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_unpack(const void* m, int width, void* pos, void* vel, void* tet, void* act,
                  void* disp, long long n, void* stream) {
  if (n <= 0) return 0;
  if (width < ROW || (width * sizeof(T)) % 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + PACK_THREADS - 1) / PACK_THREADS;
  unpack_kernel<T><<<static_cast<unsigned>(blocks), PACK_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(m), width, static_cast<T*>(pos), static_cast<T*>(vel),
      static_cast<int*>(tet), static_cast<bool*>(act), static_cast<T*>(disp), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cpf

// tab [nt, tab_w] and m [n, width] 16 B aligned and contiguous; pos and vel
// [n, 3] with adjacent columns and the given row strides (elements); tet [n]
// int32 in [.., nt); act [n] bool.  (width, tab_w) is (32, 20), (40, 32) or
// (32, 24); any other pair returns cudaErrorInvalidValue.
extern "C" int cpf_pack_f32(const void* tab, const void* pos, long long pos_stride,
                            const void* vel, long long vel_stride, const void* tet,
                            const void* act, void* m, long long n, int width, int tab_w,
                            void* stream) {
  return cpf::launch_pack<float>(tab, pos, pos_stride, vel, vel_stride, tet, act, m, n, width,
                                 tab_w, stream);
}

extern "C" int cpf_pack_f64(const void* tab, const void* pos, long long pos_stride,
                            const void* vel, long long vel_stride, const void* tet,
                            const void* act, void* m, long long n, int width, int tab_w,
                            void* stream) {
  return cpf::launch_pack<double>(tab, pos, pos_stride, vel, vel_stride, tet, act, m, n, width,
                                  tab_w, stream);
}

// m [n, width] contiguous and 16 B aligned -> pos, vel, disp (zeros) [n, 3],
// tet [n] int32, act [n] bool, all contiguous.
extern "C" int cpf_unpack_f32(const void* m, int width, void* pos, void* vel, void* tet,
                              void* act, void* disp, long long n, void* stream) {
  return cpf::launch_unpack<float>(m, width, pos, vel, tet, act, disp, n, stream);
}

extern "C" int cpf_unpack_f64(const void* m, int width, void* pos, void* vel, void* tet,
                              void* act, void* disp, long long n, void* stream) {
  return cpf::launch_unpack<double>(m, width, pos, vel, tet, act, disp, n, stream);
}
