// Row gather from a table small enough to stay in L2: out[i] = tbl[idx[i]].
//
// Replaces benchmarks/exp_r4.py::_dg_call, the TPU probe of Mosaic's
// dynamic gather from a VMEM-resident [H, D] table.  There every grid step
// gathered H rows into one shared out block, so only the last chunk's rows
// survived; here every gathered row is kept ([n_chunks * H, D]), or the
// compiler could drop the loads whose results nobody reads and the probe
// would time nothing.
//
// What bounds it: bytes.  At the probe's shapes (~4 M rows of 128 values)
// the function writes 1.02 GB (bf16) or 2.05 GB (f32) and reads 16 MB of
// ids; the table (0.5-16 MB) is read once from HBM and then from L2, the
// H100's counterpart of the TPU's VMEM.  At H = 2048, bf16, 1,040 MB in
// all: 0.311 ms at 3.35 TB/s.  What the probe measures is the rate of the
// random row reads from L2 beside the streaming writes.
//
// Design: a row is P 16-byte pieces (16 for bf16, 32 for f32 at D = 128);
// one thread copies one piece, so neighbouring lanes read neighbouring
// bytes of a row and write neighbouring bytes of out.  Each thread has
// kPiecesPerThread pieces in flight.  The stores are streaming (evict
// first), so the output that passes through L2 does not push the table out.

#include "common.cuh"

namespace f2v {
namespace {

constexpr int kThreads = 256;
constexpr int kPiecesPerThread = 4;

template <int P>
__global__ void __launch_bounds__(kThreads)
    resident_gather_kernel(const uint4* __restrict__ tbl,
                           const int32_t* __restrict__ idx,
                           uint4* __restrict__ out, int64_t pieces) {
  const int64_t first =
      int64_t(blockIdx.x) * kThreads * kPiecesPerThread + threadIdx.x;
  uint4 v[kPiecesPerThread];
#pragma unroll
  for (int u = 0; u < kPiecesPerThread; ++u) {
    const int64_t q = first + int64_t(u) * kThreads;
    if (q < pieces) v[u] = tbl[int64_t(idx[q / P]) * P + q % P];
  }
#pragma unroll
  for (int u = 0; u < kPiecesPerThread; ++u) {
    const int64_t q = first + int64_t(u) * kThreads;
    if (q < pieces) __stcs(out + q, v[u]);
  }
}

template <int P>
cudaError_t launch(const void* tbl, const void* idx, void* out, int rows,
                   cudaStream_t s) {
  const int64_t pieces = int64_t(rows) * P;
  const int64_t per_block = int64_t(kThreads) * kPiecesPerThread;
  const dim3 grid(static_cast<unsigned>((pieces + per_block - 1) / per_block));
  resident_gather_kernel<P><<<grid, kThreads, 0, s>>>(
      static_cast<const uint4*>(tbl), static_cast<const int32_t*>(idx),
      static_cast<uint4*>(out), pieces);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f2v

// row_bytes: bytes of one table row, 256 (bf16) or 512 (f32) at D = 128.
extern "C" int f2v_resident_gather(const void* tbl, const void* idx,
                                   void* out, int rows, int row_bytes,
                                   void* stream) {
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (row_bytes) {
    case 256:
      return f2v::launch<16>(tbl, idx, out, rows, s);
    case 512:
      return f2v::launch<32>(tbl, idx, out, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}
