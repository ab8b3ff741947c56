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
// and out are in X's type (f32, or bf16 or f16 with X itself as the
// gather table; such a sum is rounded once before it is added); the sample
// rows come from the gather replica (f32, bf16 or f16: common.cuh::
// with_dtypes).  Rows
// are any multiple of 8 wide up to kMaxDim, one instance per row class
// (common.cuh::with_row_class); the sigmoid comes exact or from the
// reference's lookup table (kSigmoidTableRep).  The per-vertex
// (-bs 1) repulsion launches it once over every table row, with idx the
// [n_pad, ns] negatives, deg = ns, accumulating into the iteration's
// update.
//
// What bounds it: bytes.  At the bench shape (131,072 rows, dim 128, ns 5,
// bf16 replica) the function reads x (67.1 MB), the replica (33.6 MB), the
// ids (2.6 MB) and, accumulating, out (67.1 MB), and writes out (67.1 MB):
// ~238 MB, 0.071 ms at 3.35 TB/s; its ~0.4 GFLOP of f32 would take
// 0.006 ms.  What the kernel really fetches is 655,360 random sample rows,
// 168 MB of bf16, mostly from the 50 MB L2 that holds the whole replica.
//
// Design: the edge kernel's gather engine (common.cuh::ell_block) over a
// one-entry table.  At dim 128 a 16-lane group owns a row (two rows per
// warp with a bf16 replica), so at ns <= 8 all of a row's samples are in
// flight together; the loop runs k < deg[r]: slots past it are skipped, not
// masked.  The force is common.cuh::SampleForce, the one copy
// grouped_rep_force.cu uses too.

#include "common.cuh"

namespace f2v {

// One launch over `rows` rows of `width` sample slots, for gather type T
// and X type TX: defined, with its kernels, in the object the build
// compiles for that pair (-DF2V_GATHER, -DF2V_X).
template <typename T, typename TX>
cudaError_t sample_launch(EllArgs<T, TX>& p, int rows, int width, int model,
                          cudaStream_t s);

#ifdef F2V_X
namespace {

template <typename T, typename TX, int G, int P, bool kFull, int M>
__global__ void __launch_bounds__(kEllThreads,
                                  RowClass<T, G, P, kFull>::kMinBlocks)
    ell_sample_force_kernel(const __grid_constant__ EllArgs<T, TX> p) {
  ell_block<T, TX, RowClass<T, G, P, kFull>, SampleForce<M>>(p);
}

template <typename T, typename TX, int G, int P, bool kFull>
cudaError_t launch(EllArgs<T, TX>& p, int rows, int width, int model,
                   cudaStream_t s) {
  const int64_t table[5] = {0, 0, 0, rows, width};
  const int64_t blocks = ell_plan<RowClass<T, G, P, kFull>>(p, table, 1);
  if (blocks < 0) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(blocks));
  auto go = [&](auto kernel) {
    kernel<<<grid, kEllThreads, 0, s>>>(p);
    return cudaGetLastError();
  };
  switch (model) {
    case kTdistRep:
      return go(ell_sample_force_kernel<T, TX, G, P, kFull, kTdistRep>);
    case kSigmoidRep:
      return go(ell_sample_force_kernel<T, TX, G, P, kFull, kSigmoidRep>);
    case kLayoutRep:
      return go(ell_sample_force_kernel<T, TX, G, P, kFull, kLayoutRep>);
    case kSigmoidTableRep:
      if (p.sm_table == nullptr) return cudaErrorInvalidValue;
      return go(
          ell_sample_force_kernel<T, TX, G, P, kFull, kSigmoidTableRep>);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

template <typename T, typename TX>
cudaError_t sample_launch(EllArgs<T, TX>& p, int rows, int width, int model,
                          cudaStream_t s) {
  return with_row_class<T>(p.dim, [&](auto rc) {
    using RC = decltype(rc);
    return launch<T, TX, RC::G, RC::P, RC::kFull>(p, rows, width, model, s);
  });
}

template cudaError_t sample_launch(
    EllArgs<TypeOf<F2V_GATHER>, TypeOf<F2V_X>>&, int, int, int,
    cudaStream_t);
#endif  // F2V_X

}  // namespace f2v

#ifndef F2V_X
// sm_table: the device's [2048] f32 sigmoid table for kSigmoidTableRep,
// else unused (may be null).  xg_dtype, x_dtype: the gather table's and
// X's (x and out) element types, DType codes (an f32 X with any gather
// type, another X with its own).  step: a device f32 scalar, read by the
// kernel (a captured launch reads each replay's).
extern "C" int f2v_ell_sample_force(const void* x, const void* xg,
                                    int xg_dtype, int x_dtype,
                                    const void* idx, const void* deg,
                                    const void* xi_row, const void* sm_table,
                                    const void* step, void* out,
                                    int accumulate, int rows, int width,
                                    int dim, int model, void* stream) {
  if (step == nullptr) return cudaErrorInvalidValue;
  return f2v::with_dtypes(xg_dtype, x_dtype, [&](auto types) {
    using T = typename decltype(types)::T;
    using TX = typename decltype(types)::TX;
    f2v::EllArgs<T, TX> p{};
    p.x = static_cast<const TX*>(x);
    p.xg = static_cast<const T*>(xg);
    p.nbr = static_cast<const int32_t*>(idx);
    p.deg = static_cast<const int32_t*>(deg);
    p.xi_row = static_cast<const int32_t*>(xi_row);
    p.invd = nullptr;
    p.sm_table = static_cast<const float*>(sm_table);
    p.out = static_cast<TX*>(out);
    p.step = static_cast<const float*>(step);
    p.dim = dim;
    p.accumulate = accumulate != 0;
    return f2v::sample_launch<T, TX>(p, rows, width, model,
                                     static_cast<cudaStream_t>(stream));
  });
}
#endif  // !F2V_X
