// Attraction over ELL buckets, with the neighbour gather in the kernel.
//
// Replaces force2vec_tpu/ops/pallas_force.py::ell_force_mxu (and the bulk
// `take` that fed it).  For each bucket row r, with i = xi_row[r]:
//   out[r] = sum_{k < deg[r]} coeff(a_rk, invd[i], step) * vec_rk
// where a is |x_i - xg_j|^2 (dist2) or x_i . xg_j (dot), vec is x_i - xg_j,
// xg_j - x_i or xg_j, and j = nbr[r, k].  x_i stays f32; only the
// neighbour rows come from the (bf16 or f32) gather replica xg.
//
// One launch covers a work table (common.cuh): the sync trainer's table
// holds every bucket of its layout, widest first, so that the hub's long
// rows start first and the ~112 K narrow rows fill in behind them.  Hub
// virtual rows write their partial sums to output rows past the table's
// n_pad, which the caller adds into their owners.  The per-bucket entry
// point is a one-entry table over the same kernel.
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

template <typename T, int M>
__global__ void __launch_bounds__(kEllThreads, kEllMinBlocks)
    ell_edge_force_kernel(const __grid_constant__ EllArgs<T> p) {
  ell_block<T, EdgeForce<M>>(p);
}

template <typename T>
cudaError_t launch(EllArgs<T>& p, const int64_t* table, int n_entries,
                   int model, cudaStream_t s) {
  const int64_t blocks = ell_plan(p, table, n_entries);
  if (blocks < 0) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (model) {
    case kTdist:
      ell_edge_force_kernel<T, kTdist><<<grid, kEllThreads, 0, s>>>(p);
      break;
    case kSigmoid:
      ell_edge_force_kernel<T, kSigmoid><<<grid, kEllThreads, 0, s>>>(p);
      break;
    case kFr:
      ell_edge_force_kernel<T, kFr><<<grid, kEllThreads, 0, s>>>(p);
      break;
    case kLinlog:
      ell_edge_force_kernel<T, kLinlog><<<grid, kEllThreads, 0, s>>>(p);
      break;
    case kForceatlas:
      ell_edge_force_kernel<T, kForceatlas><<<grid, kEllThreads, 0, s>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* xg, const void* nbr,
                   const void* deg, const void* xi_row, const void* invd,
                   float step, void* out, const int64_t* table, int n_entries,
                   int model, cudaStream_t s) {
  EllArgs<T> p{};
  p.x = static_cast<const float*>(x);
  p.xg = static_cast<const T*>(xg);
  p.nbr = static_cast<const int32_t*>(nbr);
  p.deg = static_cast<const int32_t*>(deg);
  p.xi_row = static_cast<const int32_t*>(xi_row);
  p.invd = static_cast<const float*>(invd);
  p.out = static_cast<float*>(out);
  p.step = step;
  p.accumulate = 0;
  return launch<T>(p, table, n_entries, model, s);
}

}  // namespace
}  // namespace f2v

// table: [n_entries, 5] int64 in host memory (row_begin, nbr_begin,
// out_begin, rows, width), in launch order.
extern "C" int f2v_ell_edge_force(const void* x, const void* xg,
                                  int xg_is_bf16, const void* nbr,
                                  const void* deg, const void* xi_row,
                                  const void* invd, float step, void* out,
                                  const void* table, int n_entries, int dim,
                                  int model, void* stream) {
  // dim 128 only: the one width a configuration runs and the card checks
  if (dim != f2v::kDim) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* t = static_cast<const int64_t*>(table);
  return xg_is_bf16
             ? f2v::launch<__nv_bfloat16>(x, xg, nbr, deg, xi_row, invd,
                                          step, out, t, n_entries, model, s)
             : f2v::launch<float>(x, xg, nbr, deg, xi_row, invd, step, out, t,
                                  n_entries, model, s);
}

extern "C" const char* f2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
