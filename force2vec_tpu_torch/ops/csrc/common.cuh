// Helpers shared by the force kernels: row loads and stores, warp sums and
// the sample (repulsion) forces.
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

// Model ids of the sample (repulsion) forces, shared with force_kernels.py
// (_SAMPLE_MODEL_IDS).
enum SampleModel { kTdistRep = 0, kSigmoidRep = 1, kLayoutRep = 2 };
constexpr float kMaxBound = 5.0f;  // models/forces.py::MAXBOUND

// acc += sample_force(xi, s, step), models/forces.py::_<model>_rep, for one
// row held by a warp (lanes hold V elements each).  The per-pair scalar is a
// warp sum, so every lane of the warp must call it.  The one copy both
// repulsion kernels use.
template <int M, int V>
__device__ __forceinline__ void add_sample_force(const float (&xi)[V],
                                                 const float (&s)[V],
                                                 float step, float (&acc)[V]) {
  float vec[V];
  float part = 0.0f;
  if constexpr (M == kSigmoidRep) {
    // -STEP * sigma(xi . s) * s
#pragma unroll
    for (int v = 0; v < V; ++v) part += xi[v] * s[v];
    const float c = -step * sigmoidf(warp_sum(part));
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += c * s[v];
  } else if constexpr (M == kTdistRep) {
    // STEP * clamp(2 / (r (1 + r)) * (xi - s)), zero at r = 0
#pragma unroll
    for (int v = 0; v < V; ++v) {
      vec[v] = xi[v] - s[v];
      part += vec[v] * vec[v];
    }
    const float r2 = warp_sum(part);
    const float d1 = r2 > 0.0f ? 2.0f / (r2 * (1.0f + r2)) : 0.0f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[v] += step * fminf(fmaxf(d1 * vec[v], -kMaxBound), kMaxBound);
    }
  } else {
    // -(1 / r) * (s - xi), zero at r = 0
#pragma unroll
    for (int v = 0; v < V; ++v) {
      vec[v] = s[v] - xi[v];
      part += vec[v] * vec[v];
    }
    const float r2 = warp_sum(part);
    const float c = -(r2 > 0.0f ? 1.0f / r2 : 0.0f);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += c * vec[v];
  }
}

}  // namespace f2v
