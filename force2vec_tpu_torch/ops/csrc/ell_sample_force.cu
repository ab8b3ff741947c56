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
// and out are in X's type (f32, or bf16 with X itself as the bf16 gather
// table: the kXBf16 instances; a bf16 sum is rounded once before it is
// added); the sample rows come from the (bf16 or f32) gather replica.  Rows
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
namespace {

template <typename T, bool kXBf16, int G, int P, bool kFull, int M>
__global__ void __launch_bounds__(kEllThreads,
                                  RowClass<T, G, P, kFull>::kMinBlocks)
    ell_sample_force_kernel(
        const __grid_constant__ EllArgs<T, XElem<kXBf16>> p) {
  ell_block<T, XElem<kXBf16>, RowClass<T, G, P, kFull>, SampleForce<M>>(p);
}

template <typename T, bool kXBf16, int G, int P, bool kFull>
cudaError_t launch(const EllArgs<T, XElem<kXBf16>>& args, int rows,
                   int width, int model, cudaStream_t s) {
  EllArgs<T, XElem<kXBf16>> p = args;
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
      return go(ell_sample_force_kernel<T, kXBf16, G, P, kFull, kTdistRep>);
    case kSigmoidRep:
      return go(ell_sample_force_kernel<T, kXBf16, G, P, kFull, kSigmoidRep>);
    case kLayoutRep:
      return go(ell_sample_force_kernel<T, kXBf16, G, P, kFull, kLayoutRep>);
    case kSigmoidTableRep:
      if (p.sm_table == nullptr) return cudaErrorInvalidValue;
      return go(
          ell_sample_force_kernel<T, kXBf16, G, P, kFull, kSigmoidTableRep>);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, bool kXBf16>
cudaError_t launch(const void* x, const void* xg, const void* idx,
                   const void* deg, const void* xi_row, const void* sm_table,
                   float step, void* out, int accumulate, int rows, int width,
                   int dim, int model, cudaStream_t s) {
  using TX = XElem<kXBf16>;
  EllArgs<T, TX> p{};
  p.x = static_cast<const TX*>(x);
  p.xg = static_cast<const T*>(xg);
  p.nbr = static_cast<const int32_t*>(idx);
  p.deg = static_cast<const int32_t*>(deg);
  p.xi_row = static_cast<const int32_t*>(xi_row);
  p.invd = nullptr;
  p.sm_table = static_cast<const float*>(sm_table);
  p.out = static_cast<TX*>(out);
  p.step = step;
  p.dim = dim;
  p.accumulate = accumulate != 0;
  return with_row_class<T>(dim, [&](auto rc) {
    using RC = decltype(rc);
    return launch<T, kXBf16, RC::G, RC::P, RC::kFull>(p, rows, width, model,
                                                      s);
  });
}

}  // namespace
}  // namespace f2v

// sm_table: the device's [2048] f32 sigmoid table for kSigmoidTableRep,
// else unused (may be null).  x_is_bf16: x and out are bf16 (then xg
// must be bf16 too), else f32.
extern "C" int f2v_ell_sample_force(const void* x, const void* xg,
                                    int xg_is_bf16, int x_is_bf16,
                                    const void* idx, const void* deg,
                                    const void* xi_row, const void* sm_table,
                                    float step, void* out, int accumulate,
                                    int rows, int width, int dim, int model,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    if (!xg_is_bf16) return cudaErrorInvalidValue;
    return f2v::launch<__nv_bfloat16, true>(x, xg, idx, deg, xi_row,
                                            sm_table, step, out, accumulate,
                                            rows, width, dim, model, s);
  }
  return xg_is_bf16
             ? f2v::launch<__nv_bfloat16, false>(x, xg, idx, deg, xi_row,
                                                 sm_table, step, out,
                                                 accumulate, rows, width, dim,
                                                 model, s)
             : f2v::launch<float, false>(x, xg, idx, deg, xi_row, sm_table,
                                         step, out, accumulate, rows, width,
                                         dim, model, s);
}
