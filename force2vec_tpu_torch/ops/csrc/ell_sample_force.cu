// Repulsion from per-row negative samples, with the sample gather in the
// kernel.
//
// Replaces force2vec_tpu/ops/pallas_force.py::ell_force with kind "sample"
// (and the bulk `take` that built its [C, K, D] tile: Mosaic cannot gather
// rows, so the TPU materialised that tile; here it never exists).  For each
// row r, with i = xi_row[r]:
//   out[r] = sum_{k < deg[r]} sample_force(x_i, xg[idx[r, k]], step)
// x_i stays f32; only the sample rows come from the (bf16 or f32) gather
// replica.  The per-vertex (-bs 1) repulsion launches it once over every
// table row, with idx the [n_pad, ns] negatives and deg = ns.
//
// What bounds it: bytes.  At the bench shape (131,072 rows, dim 128, ns 5,
// bf16 replica) the function reads x (67.1 MB), the replica (33.6 MB) and
// the ids (2.6 MB) and writes out (67.1 MB): ~170 MB, 0.051 ms at
// 3.35 TB/s; its ~0.4 GFLOP of f32 would take 0.006 ms.  What the kernel
// really fetches is 655,360 random sample rows, 168 MB of bf16, mostly
// from the 50 MB L2 that holds the whole replica.
//
// Design: the edge kernel's (ell_edge_force.cu).  One warp per row, each
// lane holding dim/32 elements of x_i and of the running sum.  Lanes load
// up to 32 of the row's sample ids at once and hand them out by shuffle;
// up to kInFlight sample rows are loaded before any is used, so at ns <= 8
// every sample of a row is in flight together.  The loop runs k < deg[r]:
// slots past it are skipped, not masked.  The force is
// common.cuh::add_sample_force, the copy grouped_rep_force.cu uses too.

#include "common.cuh"

namespace f2v {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kInFlight = 8;  // sample rows loaded ahead per warp

template <typename T>
struct SampleArgs {
  const float* x;         // [n_pad, D]
  const T* xg;            // [n_pad, D] gather replica
  const int32_t* idx;     // [rows, width] sample rows
  const int32_t* deg;     // [rows] valid samples per row
  const int32_t* xi_row;  // [rows] table row whose x each row uses
  float step;
  float* out;             // [rows, D]
  int rows;
  int width;
};

template <typename T, int V, int M>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ell_sample_force_kernel(const SampleArgs<T> p) {
  constexpr int D = 32 * V;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // whole warp leaves together

  const int64_t i = p.xi_row[row];
  float xi[V];
  load_row<float, V>(p.x + i * D + lane * V, xi);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;

  const int d = p.deg[row];
  const int32_t* irow = p.idx + row * p.width;
  for (int k0 = 0; k0 < d; k0 += 32) {
    const int cnt = min(32, d - k0);
    const int my_j = lane < cnt ? irow[k0 + lane] : 0;
    for (int k = 0; k < cnt; k += kInFlight) {
      float s[kInFlight][V];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int64_t j = __shfl_sync(kFullMask, my_j, k + u);
        if (k + u < cnt) load_row<T, V>(p.xg + j * D + lane * V, s[u]);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (k + u >= cnt) break;  // warp-uniform
        add_sample_force<M, V>(xi, s[u], p.step, acc);
      }
    }
  }
  store_row<V>(p.out + row * D + lane * V, acc);
}

template <typename T, int V>
cudaError_t launch_model(int model, const SampleArgs<T>& p, cudaStream_t s) {
  const dim3 grid((p.rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  switch (model) {
    case kTdistRep:
      ell_sample_force_kernel<T, V, kTdistRep><<<grid, block, 0, s>>>(p);
      break;
    case kSigmoidRep:
      ell_sample_force_kernel<T, V, kSigmoidRep><<<grid, block, 0, s>>>(p);
      break;
    case kLayoutRep:
      ell_sample_force_kernel<T, V, kLayoutRep><<<grid, block, 0, s>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* xg, const void* idx,
                   const void* deg, const void* xi_row, float step, void* out,
                   int rows, int width, int dim, int model, cudaStream_t s) {
  const SampleArgs<T> p{static_cast<const float*>(x),
                        static_cast<const T*>(xg),
                        static_cast<const int32_t*>(idx),
                        static_cast<const int32_t*>(deg),
                        static_cast<const int32_t*>(xi_row),
                        step,
                        static_cast<float*>(out),
                        rows,
                        width};
  // dim 128 only: the one width a configuration runs and the card checks
  if (dim != kDim) return cudaErrorInvalidValue;
  return launch_model<T, kDim / 32>(model, p, s);
}

}  // namespace
}  // namespace f2v

extern "C" int f2v_ell_sample_force(const void* x, const void* xg,
                                    int xg_is_bf16, const void* idx,
                                    const void* deg, const void* xi_row,
                                    float step, void* out, int rows,
                                    int width, int dim, int model,
                                    void* stream) {
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return xg_is_bf16
             ? f2v::launch<__nv_bfloat16>(x, xg, idx, deg, xi_row, step, out,
                                          rows, width, dim, model, s)
             : f2v::launch<float>(x, xg, idx, deg, xi_row, step, out, rows,
                                  width, dim, model, s);
}
