// chase_kernel<MODE>: a measuring kernel, not a port of a TPU kernel and
// never called by the port.  It gives the latency of one dependent load on
// the card, the unit of the rare kernels' latency bound
// (ops/traffic.py:latency_bound): one thread follows a chain of `steps`
// loads, each address taken from the value the load before returned.
//
// MODE 0, the neighbour walk: through the neighbour codes of a row table
// (mesh.tet_row, columns nbr .. nbr+3), the face picked by a hash of the
// step, a wall code (< 0) sending the walk back to its own tet.  Rows are
// read through the read-only path, as the rare kernels read table rows, so
// this is the locality a walk really has (neighbours share lines and L2).
// MODE 1, the memory figure: through `next`, a single-cycle permutation
// over a buffer the size of the table, each step a random line.
//
// state[0] holds the chain's position and state[1] the hash; a launch
// starts where the last one stopped, so repeated launches walk on instead
// of replaying the same addresses.  The plain version is ops/probe.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace cpf {

// the hash of the neighbour walk (ops/probe.py:_next_hash): a 32-bit LCG,
// the face its top two bits
__device__ __forceinline__ unsigned next_hash(unsigned h) { return h * 1664525u + 1013904223u; }

template <int MODE>
__global__ void chase_kernel(const float* __restrict__ tab, const int* __restrict__ next,
                             int row_w, int nbr, int steps, int* state) {
  int at = state[0];
  unsigned h = static_cast<unsigned>(state[1]);
  for (int s = 0; s < steps; ++s) {
    if constexpr (MODE == 0) {
      h = next_hash(h);
      const int code =
          static_cast<int>(__ldg(tab + static_cast<long long>(at) * row_w + nbr + (h >> 30)));
      at = code >= 0 ? code : at;
    } else {
      at = __ldcg(next + at);
    }
  }
  state[0] = at;
  state[1] = static_cast<int>(h);
}

}  // namespace cpf

extern "C" int cpf_chase_nbr(const void* tab, int row_w, int nbr, int steps, void* state,
                             void* stream) {
  cpf::chase_kernel<0><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), nullptr, row_w, nbr, steps, static_cast<int*>(state));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cpf_chase_perm(const void* next, int steps, void* state, void* stream) {
  cpf::chase_kernel<1><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      nullptr, static_cast<const int*>(next), 0, 0, steps, static_cast<int*>(state));
  return static_cast<int>(cudaGetLastError());
}
