// Repulsion from per-row negative samples, with the sample gather in the
// kernel.
//
// Replaces force2vec_tpu/ops/pallas_force.py::ell_force with kind "sample"
// (and the bulk `take` that built its [C, K, D] tile: Mosaic cannot gather
// rows, so the TPU materialised that tile; here it never exists).  For each
// row r, with i = xi_row[r]:
//   out[r] = sum_{k < deg[r]} sample_force(x_i, xg[idx[r, k]], step)
// or, with `accumulate`, out[r] += that sum: one f32 add per element, the
// add that `out.add_(sum)` would make, without the [C, D] temporary.  x_i
// stays f32; only the sample rows come from the (bf16 or f32) gather
// replica.  The per-vertex (-bs 1) repulsion launches it once over every
// table row, with idx the [n_pad, ns] negatives, deg = ns, accumulating
// into the iteration's update.
//
// What bounds it: bytes.  At the bench shape (131,072 rows, dim 128, ns 5,
// bf16 replica) the function reads x (67.1 MB), the replica (33.6 MB), the
// ids (2.6 MB) and, accumulating, out (67.1 MB), and writes out (67.1 MB):
// ~238 MB, 0.071 ms at 3.35 TB/s; its ~0.4 GFLOP of f32 would take
// 0.006 ms.  What the kernel really fetches is 655,360 random sample rows,
// 168 MB of bf16, mostly from the 50 MB L2 that holds the whole replica.
//
// Design: the edge kernel's gather engine (common.cuh::ell_block) over a
// one-entry table.  A 16-lane group owns a row (two rows per warp with a
// bf16 replica), so at ns <= 8 all of a row's samples are in flight
// together; the loop runs k < deg[r]: slots past it are skipped, not
// masked.  The force is common.cuh::SampleForce, the one copy
// grouped_rep_force.cu uses too.

#include "common.cuh"

namespace f2v {
namespace {

template <typename T, int M>
__global__ void __launch_bounds__(kEllThreads, kEllMinBlocks)
    ell_sample_force_kernel(const __grid_constant__ EllArgs<T> p) {
  ell_block<T, SampleForce<M>>(p);
}

template <typename T>
cudaError_t launch(const void* x, const void* xg, const void* idx,
                   const void* deg, const void* xi_row, float step, void* out,
                   int accumulate, int rows, int width, int model,
                   cudaStream_t s) {
  EllArgs<T> p{};
  p.x = static_cast<const float*>(x);
  p.xg = static_cast<const T*>(xg);
  p.nbr = static_cast<const int32_t*>(idx);
  p.deg = static_cast<const int32_t*>(deg);
  p.xi_row = static_cast<const int32_t*>(xi_row);
  p.invd = nullptr;
  p.out = static_cast<float*>(out);
  p.step = step;
  p.accumulate = accumulate != 0;
  const int64_t table[5] = {0, 0, 0, rows, width};
  const int64_t blocks = ell_plan(p, table, 1);
  if (blocks < 0) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (model) {
    case kTdistRep:
      ell_sample_force_kernel<T, kTdistRep><<<grid, kEllThreads, 0, s>>>(p);
      break;
    case kSigmoidRep:
      ell_sample_force_kernel<T, kSigmoidRep><<<grid, kEllThreads, 0, s>>>(p);
      break;
    case kLayoutRep:
      ell_sample_force_kernel<T, kLayoutRep><<<grid, kEllThreads, 0, s>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace f2v

extern "C" int f2v_ell_sample_force(const void* x, const void* xg,
                                    int xg_is_bf16, const void* idx,
                                    const void* deg, const void* xi_row,
                                    float step, void* out, int accumulate,
                                    int rows, int width, int dim, int model,
                                    void* stream) {
  // dim 128 only: the one width a configuration runs and the card checks
  if (dim != f2v::kDim) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return xg_is_bf16
             ? f2v::launch<__nv_bfloat16>(x, xg, idx, deg, xi_row, step, out,
                                          accumulate, rows, width, model, s)
             : f2v::launch<float>(x, xg, idx, deg, xi_row, step, out,
                                  accumulate, rows, width, model, s);
}
