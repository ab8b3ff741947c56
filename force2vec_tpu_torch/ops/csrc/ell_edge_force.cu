// Attraction over ELL buckets, with the neighbour gather in the kernel.
//
// Replaces force2vec_tpu/ops/pallas_force.py::ell_force_mxu (and the bulk
// `take` that fed it).  For each bucket row r, with i = xi_row[r]:
//   out[r] = sum_{k < deg[r]} coeff(a_rk, invd[i], step) * vec_rk
// where a is |x_i - xg_j|^2 (dist2) or x_i . xg_j (dot), vec is x_i - xg_j,
// xg_j - x_i or xg_j, and j = nbr[r, k].  x_i and out are in X's type
// (f32, or bf16 or f16 with X itself as the gather table); the neighbour
// rows come from the gather replica xg (f32, bf16 or f16: common.cuh::
// with_dtypes); the sums are f32, rounded once at the store.  Rows are
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
// point is a one-entry table over the same kernel.  A launch stores each
// row's sum: its EllArgs are value-initialised, so the add-into-out flag
// that ell_sample_force sets stays 0.
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

// One launch over the work table in p, for gather type T and X type TX:
// defined, with its kernels, in the object the build compiles for that
// pair (-DF2V_GATHER, -DF2V_X); the entry point's object calls it.
template <typename T, typename TX>
cudaError_t edge_launch(EllArgs<T, TX>& p, const int64_t* table,
                        int n_entries, int model, cudaStream_t s);

#ifdef F2V_X
namespace {

template <typename T, typename TX, int G, int P, bool kFull, int M>
__global__ void __launch_bounds__(kEllThreads,
                                  RowClass<T, G, P, kFull>::kMinBlocks)
    ell_edge_force_kernel(const __grid_constant__ EllArgs<T, TX> p) {
  ell_block<T, TX, RowClass<T, G, P, kFull>, EdgeForce<M>>(p);
}

template <typename T, typename TX, int G, int P, bool kFull>
cudaError_t launch(EllArgs<T, TX>& p, const int64_t* table, int n_entries,
                   int model, cudaStream_t s) {
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
      return go(ell_edge_force_kernel<T, TX, G, P, kFull, kTdist>);
    case kSigmoid:
      return go(ell_edge_force_kernel<T, TX, G, P, kFull, kSigmoid>);
    case kFr:
      return go(ell_edge_force_kernel<T, TX, G, P, kFull, kFr>);
    case kLinlog:
      return go(ell_edge_force_kernel<T, TX, G, P, kFull, kLinlog>);
    case kForceatlas:
      return go(ell_edge_force_kernel<T, TX, G, P, kFull, kForceatlas>);
    case kSigmoidTable:
      if (p.sm_table == nullptr) return cudaErrorInvalidValue;
      return go(ell_edge_force_kernel<T, TX, G, P, kFull, kSigmoidTable>);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

template <typename T, typename TX>
cudaError_t edge_launch(EllArgs<T, TX>& p, const int64_t* table,
                        int n_entries, int model, cudaStream_t s) {
  return with_row_class<T>(p.dim, [&](auto rc) {
    using RC = decltype(rc);
    return launch<T, TX, RC::G, RC::P, RC::kFull>(p, table, n_entries, model,
                                                  s);
  });
}

template cudaError_t edge_launch(EllArgs<TypeOf<F2V_GATHER>, TypeOf<F2V_X>>&,
                                 const int64_t*, int, int, cudaStream_t);
#endif  // F2V_X

}  // namespace f2v

#ifndef F2V_X
// table: [n_entries, 5] int64 in host memory (row_begin, nbr_begin,
// out_begin, rows, width), in launch order.  sm_table: the device's
// [2048] f32 sigmoid table for kSigmoidTable, else unused (may be null).
// xg_dtype, x_dtype: the gather table's and X's (x, invd and out) element
// types, DType codes (an f32 X with any gather type, another X with its
// own).  step: a device f32 scalar, read by the kernel (a captured launch
// reads each replay's).
extern "C" int f2v_ell_edge_force(const void* x, const void* xg,
                                  int xg_dtype, int x_dtype,
                                  const void* nbr, const void* deg,
                                  const void* xi_row, const void* invd,
                                  const void* sm_table, const void* step,
                                  void* out, const void* table,
                                  int n_entries, int dim,
                                  int model, void* stream) {
  if (step == nullptr) return cudaErrorInvalidValue;
  return f2v::with_dtypes(xg_dtype, x_dtype, [&](auto types) {
    using T = typename decltype(types)::T;
    using TX = typename decltype(types)::TX;
    f2v::EllArgs<T, TX> p{};
    p.x = static_cast<const TX*>(x);
    p.xg = static_cast<const T*>(xg);
    p.nbr = static_cast<const int32_t*>(nbr);
    p.deg = static_cast<const int32_t*>(deg);
    p.xi_row = static_cast<const int32_t*>(xi_row);
    p.invd = static_cast<const TX*>(invd);
    p.sm_table = static_cast<const float*>(sm_table);
    p.out = static_cast<TX*>(out);
    p.step = static_cast<const float*>(step);
    p.dim = dim;
    return f2v::edge_launch<T, TX>(p, static_cast<const int64_t*>(table),
                                   n_entries, model,
                                   static_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* f2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif  // !F2V_X
