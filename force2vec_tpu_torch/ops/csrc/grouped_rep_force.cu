// Repulsion from group-shared negative samples.
//
// Replaces force2vec_tpu/ops/pallas_force.py::grouped_rep_force.  Row r
// belongs to group r / group, and every row of a group repels from the
// same ns sample rows:
//   out[r] = sum_{s < ns} sample_force(xi[r], sg[r / group, s], step)
// xi stays f32; the samples come from the (bf16 or f32) gather replica.
//
// What bounds it: streaming xi in and out, 2 x 64 MB of f32 per iteration
// at the bench shape (131,072 x 128); the samples are 640 KB of bf16.
//
// Design, the TPU kernel's own idea: the [rows, ns, D] expand of the group
// samples never touches device memory.  A block owns up to 32 rows of one
// group, copies that group's [ns, D] block into shared memory once (2.5 KB
// at ns 5, dim 128), and each warp computes whole rows from it, lanes
// holding dim/32 elements each.  Nothing carries across blocks.

#include "common.cuh"

namespace f2v {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerBlock = 32;

template <typename T>
struct RepArgs {
  const float* xi;  // [rows, D]
  const T* sg;      // [ng, ns, D]
  float step;
  float* out;       // [rows, D]
  int rows;
  int group;
  int ns;
  int tiles_per_group;
};

template <typename T, int V, int M>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    grouped_rep_force_kernel(const RepArgs<T> p) {
  constexpr int D = 32 * V;
  extern __shared__ float samples[];  // [ns, D] of this block's group, f32
  const int64_t g = blockIdx.x / p.tiles_per_group;
  const int tile = blockIdx.x % p.tiles_per_group;
  const T* src = p.sg + g * p.ns * D;
  for (int e = threadIdx.x; e < p.ns * D; e += blockDim.x) {
    samples[e] = to_f32(src[e]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t g0 = g * p.group;
  const int64_t lo = g0 + int64_t(tile) * kRowsPerBlock;
  int64_t hi = lo + kRowsPerBlock;
  if (hi > g0 + p.group) hi = g0 + p.group;
  if (hi > p.rows) hi = p.rows;
  for (int64_t r = lo + (threadIdx.x >> 5); r < hi; r += kWarpsPerBlock) {
    float xi[V];
    load_row<float, V>(p.xi + r * D + lane * V, xi);
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int s = 0; s < p.ns; ++s) {
      float sv[V];
      load_row<float, V>(samples + s * D + lane * V, sv);
      add_pair_force<SampleForce<M>, 32, V>(xi, sv, 0.0f, p.step, acc);
    }
    store_row<V>(p.out + r * D + lane * V, acc);
  }
}

template <typename T, int V>
cudaError_t launch_model(int model, const RepArgs<T>& p, int groups,
                         cudaStream_t s) {
  const dim3 grid(groups * p.tiles_per_group);
  const dim3 block(kWarpsPerBlock * 32);
  const size_t smem = size_t(p.ns) * 32 * V * sizeof(float);
  switch (model) {
    case kTdistRep:
      grouped_rep_force_kernel<T, V, kTdistRep><<<grid, block, smem, s>>>(p);
      break;
    case kSigmoidRep:
      grouped_rep_force_kernel<T, V, kSigmoidRep>
          <<<grid, block, smem, s>>>(p);
      break;
    case kLayoutRep:
      grouped_rep_force_kernel<T, V, kLayoutRep><<<grid, block, smem, s>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xi, const void* sg, float step, void* out,
                   int rows, int group, int ns, int dim, int model,
                   cudaStream_t s) {
  const RepArgs<T> p{static_cast<const float*>(xi),
                     static_cast<const T*>(sg),
                     step,
                     static_cast<float*>(out),
                     rows,
                     group,
                     ns,
                     (group + kRowsPerBlock - 1) / kRowsPerBlock};
  const int groups = (rows + group - 1) / group;
  // dim 128 only: the one width a configuration runs and the card checks
  if (dim != kDim) return cudaErrorInvalidValue;
  return launch_model<T, kDim / 32>(model, p, groups, s);
}

}  // namespace
}  // namespace f2v

extern "C" int f2v_grouped_rep_force(const void* xi, const void* sg,
                                     int sg_is_bf16, float step, void* out,
                                     int rows, int group, int ns, int dim,
                                     int model, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (group <= 0 || ns <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sg_is_bf16
             ? f2v::launch<__nv_bfloat16>(xi, sg, step, out, rows, group, ns,
                                          dim, model, s)
             : f2v::launch<float>(xi, sg, step, out, rows, group, ns, dim,
                                  model, s);
}
