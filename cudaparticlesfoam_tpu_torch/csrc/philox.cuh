// In-kernel Brownian noise (K6): the JAX package's off-TPU "rbg" stream,
// drawn per lane inside the stream kernels.
//
// Replaces the TPU hardware PRNG of cudaparticlesfoam_tpu/ops/fused_pallas.py
// (_inkernel_noise, used by _kernel_a_k, _kernel_a_packed_k, _kernel_a_mh_k,
// _kernel_a_mh_packed_k and _kernel_ca_packed_k), whose bits exist only on a
// TPU.  Instead the kernels reproduce the stream the JAX package draws with
// lax.rng_bit_generator(k4, (n, 4), uint32) off a TPU (XLA's Philox4x32-10,
// ops/fused.py:178-201): Philox key (k4[0], k4[1]); lane l encrypts the
// 128-bit counter (k4[1], k4[0], k4[3], k4[2]) + l (most significant word
// first) and takes its 4 output words in order; u = bits * 2^-32 + 2^-33,
// then a full-pair Box-Muller gives 3 normals from 4 uniforms.  The plain
// version is ops/fused.py:philox_normals; k4 comes from fused.philox_key.
// Counter-based, so a lane's noise depends only on (key, step, lane), never
// on the launch shape.
#pragma once

#include <stdint.h>

namespace cpf {

struct PhiloxKey {
  uint32_t k0, k1, k2, k3;
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

template <typename T> __device__ __forceinline__ T dlog(T x);
template <> __device__ __forceinline__ float dlog(float x) { return logf(x); }
template <> __device__ __forceinline__ double dlog(double x) { return log(x); }
template <typename T> __device__ __forceinline__ T dsqrt(T x);
template <> __device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
template <typename T> __device__ __forceinline__ T dsin(T x);
template <> __device__ __forceinline__ float dsin(float x) { return sinf(x); }
template <> __device__ __forceinline__ double dsin(double x) { return sin(x); }
template <typename T> __device__ __forceinline__ T dcos(T x);
template <> __device__ __forceinline__ float dcos(float x) { return cosf(x); }
template <> __device__ __forceinline__ double dcos(double x) { return cos(x); }

// 3 standard normals of lane `lane` (philox_normals row `lane`).
template <typename T>
__device__ __forceinline__ void philox_normals3(const PhiloxKey& key, long long lane,
                                                T xi[3]) {
  // 128-bit counter + lane, carried through all four words
  const unsigned long long lo = (static_cast<unsigned long long>(key.k3) << 32) | key.k2;
  const unsigned long long lo2 = lo + static_cast<unsigned long long>(lane);
  const unsigned long long hi = ((static_cast<unsigned long long>(key.k1) << 32) | key.k0) +
                                (lo2 < lo ? 1ull : 0ull);
  uint32_t c[4] = {static_cast<uint32_t>(lo2), static_cast<uint32_t>(lo2 >> 32),
                   static_cast<uint32_t>(hi), static_cast<uint32_t>(hi >> 32)};
  philox4x32_10(c, key.k0, key.k1);
  T u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = static_cast<T>(c[j]) * T(1.0 / 4294967296.0) + T(0.5 / 4294967296.0);
  }
  const T two_pi = T(6.283185307179586);  // (2 pi) rounded to T
  const T r0 = dsqrt(T(-2) * dlog(u[0]));
  const T r1 = dsqrt(T(-2) * dlog(u[1]));
  const T a0 = two_pi * u[2];
  const T a1 = two_pi * u[3];
  xi[0] = r0 * dcos(a0);
  xi[1] = r0 * dsin(a0);
  xi[2] = r1 * dcos(a1);
}

}  // namespace cpf
