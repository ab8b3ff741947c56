// Column sums of a streamed tile: out[0, d] = sum_{t, k} f32(tile[t, k, d]).
//
// Replaces benchmarks/exp_r4.py::ro_call (body ro_kernel), the TPU probe of
// the read-only floor of the force sweep: one pass over a [T, K, D] tile
// that a bulk take wrote to HBM.  The TPU kernel carried the sum in its
// output block from one grid step to the next and never zeroed it, so its
// result depended on what that buffer held; this function is the
// zero-initialised sum.
//
// What bounds it: bytes.  One group of the probe is [4023, 16, 128] bf16,
// 16.5 MB, read once: 0.0049 ms at 3.35 TB/s.  Alone it fits the 50 MB L2;
// the probe streams 40 groups (659 MB), so its loop reads from HBM.
//
// Design: the tile is `rows` = T*K rows of D values, each P 16-byte pieces.
// Pass 1: block b reduces a contiguous slice of rows_per_block rows to a
// [D] partial; thread (sub, piece) adds rows sub, sub + kThreads/P, ... of
// the slice, kUnroll 16-byte loads in flight before it adds them in row
// order; the block's kThreads/P row-partials are then added in order
// through shared memory.  Pass 2: one block adds the partials in block
// order.  No atomics: the summation order, and so the result, is the same
// on every run.  The wrapper allocates the [blocks, D] partials.

#include "common.cuh"

namespace f2v {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    read_sum_partial_kernel(const T* __restrict__ tile,
                            float* __restrict__ partial, int64_t rows,
                            int64_t rows_per_block) {
  constexpr int V = 16 / sizeof(T);      // values per 16-byte piece
  constexpr int P = D / V;               // pieces per row
  constexpr int kRowsPerStep = kThreads / P;
  static_assert(kThreads % P == 0, "a step must cover whole rows");
  __shared__ float part[kRowsPerStep][D];

  const int piece = threadIdx.x % P;
  const int sub = threadIdx.x / P;
  const int64_t r0 = int64_t(blockIdx.x) * rows_per_block;
  const int64_t r1 =
      r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const T* base = tile + piece * V;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  for (int64_t r = r0 + sub; r < r1; r += kUnroll * kRowsPerStep) {
    float x[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ru = r + int64_t(u) * kRowsPerStep;
      if (ru < r1) load_row<T, V>(base + ru * D, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + int64_t(u) * kRowsPerStep >= r1) break;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += x[u][v];
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) part[sub][piece * V + v] = acc[v];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kRowsPerStep; ++i) s += part[i][d];
    partial[int64_t(blockIdx.x) * D + d] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(D)
    read_sum_final_kernel(const float* __restrict__ partial,
                          float* __restrict__ out, int blocks) {
  const int d = threadIdx.x;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[int64_t(b) * D + d];
  out[d] = s;
}

template <typename T>
cudaError_t launch(const void* tile, void* partial, void* out, int rows,
                   int blocks, int rows_per_block, cudaStream_t s) {
  read_sum_partial_kernel<T, kDim><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(tile), static_cast<float*>(partial), rows,
      rows_per_block);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  read_sum_final_kernel<kDim><<<1, kDim, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f2v

// rows: T*K tile rows of dim values; partial: [blocks, dim] f32 scratch;
// blocks * rows_per_block >= rows.
extern "C" int f2v_read_sum(const void* tile, int tile_is_bf16, void* partial,
                            void* out, int rows, int dim, int blocks,
                            int rows_per_block, void* stream) {
  // dim 128 only: the probe's width
  if (dim != f2v::kDim || blocks <= 0 ||
      int64_t(blocks) * rows_per_block < rows) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile_is_bf16
             ? f2v::launch<__nv_bfloat16>(tile, partial, out, rows, blocks,
                                          rows_per_block, s)
             : f2v::launch<float>(tile, partial, out, rows, blocks,
                                  rows_per_block, s);
}
