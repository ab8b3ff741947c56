// Attraction over ELL buckets, with the neighbour gather in the kernel.
//
// Replaces force2vec_tpu/ops/pallas_force.py::ell_force_mxu (and the bulk
// `take` that fed it).  For each bucket row r, with i = xi_row[r]:
//   out[r] = sum_{k < deg[r]} coeff(a_rk, invd[i], step) * vec_rk
// where a is |x_i - xg_j|^2 (dist2) or x_i . xg_j (dot), vec is x_i - xg_j,
// xg_j - x_i or xg_j, and j = nbr[r, k].  x_i and out are in X's type
// (f32, or bf16 with X itself as the bf16 gather table: the kXBf16
// instances); the neighbour rows come from the (bf16 or f32) gather
// replica xg; the sums are f32, rounded once at the store.  Rows are
// any multiple of 8 wide up to kMaxDim, one instance per row class
// (common.cuh::with_row_class; dims 64 and 128 fill theirs and run with D
// fixed at compile time); the sigmoid coefficient comes exact or from the
// reference's lookup table (kSigmoidTable, the --sm-table mode).
//
// One launch covers a work table (common.cuh): the sync trainer's table
// holds every bucket of its layout, widest first, so that the hub's long
// rows start first and the ~112 K narrow rows fill in behind them.  Hub
// virtual rows write their partial sums to output rows past the table's
// n_pad, which the caller adds into their owners.  The per-bucket entry
// point is a one-entry table over the same kernel.  With `accumulate` a
// launch adds each row's sum into out (one rounded f32 add per element, as
// `out.add_(sum)` makes): the hot/cold gather split runs its cold table
// storing and then its hot table adding into the same rows, two launches,
// so that no launch holds two entries that write one row.
//
// What bounds it: random row reads of the replica.  At the bench shape
// (131,072 vertices, dim 128, bf16) an iteration reads 2.10 M neighbour
// rows of 256 bytes, 537 MB, mostly from the 50 MB L2 that holds the whole
// 34 MB replica; the function's own bytes (each input once, each output
// once) are 178 MB, 0.053 ms at 3.35 TB/s.  The 2.57 M padded ELL slots
// are skipped, not masked.  The earlier design (a warp per row, 8-byte
// loads, 4 rows in flight, 13 launches) read 4.45 G rows/s; the probe
// take_sum reads 10 G rows/s with 16 in flight, so this one keeps 16
// neighbour rows in flight per warp with 16-byte loads (common.cuh::
// ell_block), and reads 11.4 G rows/s in one launch (0.184 ms; 8.9 G rows/s
// at 1,048,576 vertices, whose replica is 5x the L2; H100 SXM at 700 W,
// tools/profile_iter.py).  The TPU kernel's 8-row block-diagonal matmuls and norm-form
// a existed only because Mosaic lacks a cheap lane reduction and a row
// gather; neither limit applies here.

#include "common.cuh"

namespace f2v {
namespace {

template <typename T, bool kXBf16, int G, int P, bool kFull, int M>
__global__ void __launch_bounds__(kEllThreads,
                                  RowClass<T, G, P, kFull>::kMinBlocks)
    ell_edge_force_kernel(
        const __grid_constant__ EllArgs<T, XElem<kXBf16>> p) {
  ell_block<T, XElem<kXBf16>, RowClass<T, G, P, kFull>, EdgeForce<M>>(p);
}

template <typename T, bool kXBf16, int G, int P, bool kFull>
cudaError_t launch(EllArgs<T, XElem<kXBf16>>& p, const int64_t* table,
                   int n_entries, int model, cudaStream_t s) {
  const int64_t blocks =
      ell_plan<RowClass<T, G, P, kFull>>(p, table, n_entries);
  if (blocks < 0) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(blocks));
  auto go = [&](auto kernel) {
    kernel<<<grid, kEllThreads, 0, s>>>(p);
    return cudaGetLastError();
  };
  switch (model) {
    case kTdist:
      return go(ell_edge_force_kernel<T, kXBf16, G, P, kFull, kTdist>);
    case kSigmoid:
      return go(ell_edge_force_kernel<T, kXBf16, G, P, kFull, kSigmoid>);
    case kFr:
      return go(ell_edge_force_kernel<T, kXBf16, G, P, kFull, kFr>);
    case kLinlog:
      return go(ell_edge_force_kernel<T, kXBf16, G, P, kFull, kLinlog>);
    case kForceatlas:
      return go(ell_edge_force_kernel<T, kXBf16, G, P, kFull, kForceatlas>);
    case kSigmoidTable:
      if (p.sm_table == nullptr) return cudaErrorInvalidValue;
      return go(ell_edge_force_kernel<T, kXBf16, G, P, kFull, kSigmoidTable>);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, bool kXBf16>
cudaError_t launch(const void* x, const void* xg, const void* nbr,
                   const void* deg, const void* xi_row, const void* invd,
                   const void* sm_table, float step, void* out,
                   int accumulate, const int64_t* table, int n_entries,
                   int dim, int model, cudaStream_t s) {
  using TX = XElem<kXBf16>;
  EllArgs<T, TX> p{};
  p.x = static_cast<const TX*>(x);
  p.xg = static_cast<const T*>(xg);
  p.nbr = static_cast<const int32_t*>(nbr);
  p.deg = static_cast<const int32_t*>(deg);
  p.xi_row = static_cast<const int32_t*>(xi_row);
  p.invd = static_cast<const TX*>(invd);
  p.sm_table = static_cast<const float*>(sm_table);
  p.out = static_cast<TX*>(out);
  p.step = step;
  p.dim = dim;
  p.accumulate = accumulate != 0;
  return with_row_class<T>(dim, [&](auto rc) {
    using RC = decltype(rc);
    return launch<T, kXBf16, RC::G, RC::P, RC::kFull>(p, table, n_entries,
                                                      model, s);
  });
}

}  // namespace
}  // namespace f2v

// table: [n_entries, 5] int64 in host memory (row_begin, nbr_begin,
// out_begin, rows, width), in launch order.  sm_table: the device's
// [2048] f32 sigmoid table for kSigmoidTable, else unused (may be null).
// accumulate: add into out's rows instead of storing.  x_is_bf16: x,
// invd and out are bf16 (then xg must be bf16 too), else f32.
extern "C" int f2v_ell_edge_force(const void* x, const void* xg,
                                  int xg_is_bf16, int x_is_bf16,
                                  const void* nbr, const void* deg,
                                  const void* xi_row, const void* invd,
                                  const void* sm_table, float step,
                                  void* out, int accumulate,
                                  const void* table, int n_entries, int dim,
                                  int model, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* t = static_cast<const int64_t*>(table);
  if (x_is_bf16) {
    if (!xg_is_bf16) return cudaErrorInvalidValue;
    return f2v::launch<__nv_bfloat16, true>(x, xg, nbr, deg, xi_row, invd,
                                            sm_table, step, out, accumulate,
                                            t, n_entries, dim, model, s);
  }
  return xg_is_bf16
             ? f2v::launch<__nv_bfloat16, false>(x, xg, nbr, deg, xi_row,
                                                 invd, sm_table, step, out,
                                                 accumulate, t, n_entries,
                                                 dim, model, s)
             : f2v::launch<float, false>(x, xg, nbr, deg, xi_row, invd,
                                         sm_table, step, out, accumulate, t,
                                         n_entries, dim, model, s);
}

extern "C" const char* f2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
