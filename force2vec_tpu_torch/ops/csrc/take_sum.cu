// Sum of K gathered table rows per output row:
//   out[r] = sum_{k < K} f32(tbl[idx[r, k]])
//
// Replaces benchmarks/exp_r3.py::vmem_take, the TPU probe of a row gather
// from a VMEM-resident table (its two lowerings, `take` and `rowloop`,
// computed this one function).  On the H100 the table does not fit a
// block's shared memory: at the probe's H = 16384 it is 4 MB (bf16) or
// 8 MB (f32), 18-36x a block's 227 KB, and every block reads all of it.
// It is read through the 50 MB L2 instead.
//
// What bounds it: bytes.  The function reads the table once (4.2 or 8.4 MB)
// and the [65536, 16] ids (4.2 MB), and writes [65536, 128] f32 (33.6 MB):
// 41.9 / 46.1 MB, 0.0125 / 0.0138 ms at 3.35 TB/s.  The 1,048,576 gathered
// rows (268 / 537 MB) come from L2; their rate is what the probe measures.
//
// Design: the edge kernel's (ell_edge_force.cu).  One warp per output row,
// each lane holding dim/32 elements of the sum in f32.  Lanes load up to 32
// of the row's ids at once and hand them out by shuffle; kInFlight table
// rows are loaded before any is added, so at K = 16 all of a row's reads
// are in flight together.  The rows are added in order k = 0, 1, ...

#include "common.cuh"

namespace f2v {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kInFlight = 16;  // table rows loaded ahead per warp

template <typename T, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    take_sum_kernel(const T* __restrict__ tbl, const int32_t* __restrict__ idx,
                    float* __restrict__ out, int rows, int k) {
  constexpr int D = 32 * V;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  const int32_t* irow = idx + row * k;
  for (int k0 = 0; k0 < k; k0 += 32) {
    const int cnt = min(32, k - k0);
    const int my_j = lane < cnt ? irow[k0 + lane] : 0;
    for (int kk = 0; kk < cnt; kk += kInFlight) {
      float t[kInFlight][V];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int64_t j = __shfl_sync(kFullMask, my_j, kk + u);
        if (kk + u < cnt) load_row<T, V>(tbl + j * D + lane * V, t[u]);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (kk + u >= cnt) break;  // warp-uniform
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += t[u][v];
      }
    }
  }
  store_row<V>(out + row * D + lane * V, acc);
}

template <typename T>
cudaError_t launch(const void* tbl, const void* idx, void* out, int rows,
                   int k, int dim, cudaStream_t s) {
  // dim 128 only: the probe's width
  if (dim != kDim) return cudaErrorInvalidValue;
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  take_sum_kernel<T, kDim / 32><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(tbl), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), rows, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f2v

extern "C" int f2v_take_sum(const void* tbl, int tbl_is_bf16, const void* idx,
                            void* out, int rows, int k, int dim,
                            void* stream) {
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tbl_is_bf16
             ? f2v::launch<__nv_bfloat16>(tbl, idx, out, rows, k, dim, s)
             : f2v::launch<float>(tbl, idx, out, rows, k, dim, s);
}
