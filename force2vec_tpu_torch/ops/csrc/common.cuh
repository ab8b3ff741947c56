// Helpers shared by the force kernels: row loads and stores, warp sums.
//
// A warp owns one embedding row of D = 32 * V floats; lane l holds the V
// contiguous elements [l*V, l*V + V), so a row load is one or two vector
// loads per lane and the warp reads the row's bytes contiguously.  Row
// bases must be 16-byte aligned (the Python wrappers check it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace f2v {

constexpr unsigned kFullMask = 0xffffffffu;
// The embedding width the kernels are built for (force_kernels._KERNEL_DIM).
constexpr int kDim = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__host__ __device__ constexpr int pack_align(int bytes) {
  return bytes < 16 ? bytes : 16;
}

// Load V contiguous elements at p as floats.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[V]) {
  struct alignas(pack_align(sizeof(T) * V)) Pack {
    T v[V];
  };
  const Pack pk = *reinterpret_cast<const Pack*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(pk.v[i]);
}

template <int V>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&v)[V]) {
  struct alignas(pack_align(4 * V)) Pack {
    float v[V];
  };
  Pack pk;
#pragma unroll
  for (int i = 0; i < V; ++i) pk.v[i] = v[i];
  *reinterpret_cast<Pack*>(p) = pk;
}

// Butterfly sum: every lane ends with the same bits (IEEE addition is
// commutative, and each step adds the same two partials on both lanes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float a) {
  return 1.0f / (1.0f + expf(-a));
}

}  // namespace f2v
