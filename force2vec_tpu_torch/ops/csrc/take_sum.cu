// Sum of K gathered table rows per output row:
//   out[r] = sum_{k < K} f32(tbl[idx[r, k]])
//
// Replaces benchmarks/exp_r3.py::vmem_take, the TPU probe of a row gather
// from a VMEM-resident table (its two lowerings, `take` and `rowloop`,
// computed this one function).  On the H100 the table does not fit a
// block's shared memory: at the probe's H = 16384 it is 4 MB (bf16) or
// 8 MB (f32), 18-36x a block's 227 KB, and every block reads all of it;
// even a 16-block cluster holds only 3.6 MB of distributed shared memory.
// It is read through the 50 MB L2 instead.  Sorting the ids by table tile
// would make the reads local, but it changes the work being measured.
//
// What bounds it: bytes.  The function reads the table once (4.2 or 8.4 MB)
// and the [65536, 16] ids (4.2 MB), and writes [65536, 128] f32 (33.6 MB):
// 41.9 / 46.1 MB, 0.0125 / 0.0138 ms at 3.35 TB/s.  The 1,048,576 gathered
// rows (268 / 537 MB) come from L2; their rate is what the probe measures,
// and it is set by how many row reads are in flight.
//
// Design: rows in flight are bounded by shared memory, not registers.
// Persistent blocks, several per SM, each walk a strided range of chunks of
// kStageIds / K output rows.  A producer warp loads a chunk's ids (one
// coalesced load, one id a lane, kIdsAhead chunks before they are
// needed) and copies the chunk's K rows per output row into the next stage
// of a ring in dynamic shared memory, whose mbarrier completes when they
// have landed.  The copies are 16-byte cp.async pieces spread over the
// producer's lanes (a bf16 row is 16 pieces, so one warp copy moves two
// rows); each lane's cp.async.mbarrier.arrive counts on the stage's
// mbarrier once its pieces have landed.  One cp.async.bulk per row, the
// other filler tried, was slower with bf16 rows on an H100 and no faster
// with f32 (PERF.md §9.6).  Consumer warps wait on the stage, sum each
// output row's K rows in f32 in order k = 0, 1, ... (a warp per output row,
// 4 values a lane), write it with 16-byte stores, and release the stage.

#include "common.cuh"

namespace f2v {
namespace {

// Small blocks, so that an SM holds many producers: on an H100 the rate
// followed the producer warps an SM holds, not the ring's depth (blocks of
// 4 consumers and 64 rows a stage, or 8 and 128, were slower at every
// depth tried).
constexpr int kConsumerWarps = 2;
constexpr int kThreads = 32 * (1 + kConsumerWarps);
// Gathered rows per stage: one id per producer lane, so K <= 32.
constexpr int kStageIds = 32;
constexpr int kIdsPerLane = kStageIds / 32;
// Chunks whose ids the producer has loaded ahead: the id loads' latency
// stays off the copies' path.
constexpr int kIdsAhead = 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Arrive on bar once this thread's earlier cp.async copies have landed
// (.noinc: the arrival counts against the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kStageIds * kDim * int(sizeof(T));
}

// The barriers, then the ring at a 128-byte boundary.
__host__ __device__ inline size_t ring_offset(int stages) {
  return (size_t(16) * stages + 127) / 128 * 128;
}

template <typename T>
size_t smem_bytes(int stages) {
  return ring_offset(stages) + size_t(stages) * stage_bytes<T>();
}

// Lane l's ids of chunk c (its first n of rps * k, flat): ids l + 32 j;
// none past the last chunk.
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ idx,
                                         int64_t c, int rps, int k, int rows,
                                         int lane, int (&ids)[kIdsPerLane]) {
  const int n = int(max(int64_t(0), min(int64_t(rps), rows - c * rps))) * k;
#pragma unroll
  for (int j = 0; j < kIdsPerLane; ++j) {
    const int i = lane + 32 * j;
    ids[j] = i < n ? idx[c * rps * k + i] : 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    take_sum_kernel(const T* __restrict__ tbl, const int32_t* __restrict__ idx,
                    float* __restrict__ out, int rows, int k, int stages) {
  constexpr int kRowBytes = kDim * int(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  unsigned char* ring = smem + ring_offset(stages);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rps = kStageIds / k;  // output rows per stage
  const int chunks = (rows + rps - 1) / rps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);  // each producer lane's arrival
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {  // the producer
    // ids[u] holds the ids of this block's chunk t with t % kIdsAhead == u,
    // loaded kIdsAhead chunks before they are used
    int ids[kIdsAhead][kIdsPerLane];
#pragma unroll
    for (int u = 0; u < kIdsAhead; ++u) {
      load_ids(idx, blockIdx.x + int64_t(u) * gridDim.x, rps, k, rows, lane,
               ids[u]);
    }
    for (int t0 = 0;; t0 += kIdsAhead) {
#pragma unroll
      for (int u = 0; u < kIdsAhead; ++u) {
        const int t = t0 + u;
        const int64_t c = blockIdx.x + int64_t(t) * gridDim.x;
        if (c >= chunks) return;
        const int s = t % stages;
        const int n = int(min(int64_t(rps), rows - c * rps)) * k;
        mbar_wait(&empty[s], ((t / stages) & 1) ^ 1);
        unsigned char* dst = ring + size_t(s) * stage_bytes<T>();
        constexpr int kPieces = kRowBytes / 16;    // 16-byte pieces a row
        constexpr int kRowsPerOp = 32 / kPieces;  // rows a warp copy covers
        const int q = lane % kPieces;
#pragma unroll
        for (int j = 0; j < kIdsPerLane; ++j) {  // rows 32 j + [0, 32)
#pragma unroll 4
          for (int m = 0; m < 32 / kRowsPerOp; ++m) {
            const int i = 32 * j + m * kRowsPerOp + lane / kPieces;
            const int id = __shfl_sync(kFullMask, ids[u][j], i % 32);
            if (i < n) {
              cp_async16(dst + i * kRowBytes + q * 16,
                         reinterpret_cast<const unsigned char*>(
                             tbl + int64_t(id) * kDim) + q * 16);
            }
          }
        }
        cp_async_arrive(&full[s]);
        load_ids(idx, c + int64_t(kIdsAhead) * gridDim.x, rps, k, rows, lane,
                 ids[u]);
      }
    }
  } else {  // the consumers: a warp per output row of the stage
    const int cw = warp - 1;
    for (int c = blockIdx.x, t = 0; c < chunks; c += gridDim.x, ++t) {
      const int s = t % stages;
      mbar_wait(&full[s], (t / stages) & 1);
      const int64_t r0 = int64_t(c) * rps;
      const int nr = min(int64_t(rps), rows - r0);
      const T* src = reinterpret_cast<const T*>(ring + size_t(s) *
                                                stage_bytes<T>()) + lane * 4;
      for (int rr = cw; rr < nr; rr += kConsumerWarps) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const T* row = src + rr * k * kDim;
#pragma unroll 4
        for (int kk = 0; kk < k; ++kk) {
          float v[4];
          load_row<T, 4>(row + kk * kDim, v);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] += v[e];
        }
        store_row<4>(out + (r0 + rr) * kDim + lane * 4, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
}

template <typename T>
cudaError_t occupancy(int stages, int* res) {
  const size_t smem = smem_bytes<T>(stages);
  cudaError_t err = cudaFuncSetAttribute(
      take_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  res[0] = int(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &res[1], take_sum_kernel<T>, kThreads, smem);
}

template <typename T>
cudaError_t launch(const void* tbl, const void* idx, void* out, int rows,
                   int k, int dim, int stages, cudaStream_t s) {
  // dim 128 only: the probe's width
  if (dim != kDim || k < 1 || k > kStageIds || stages < 1) {
    return cudaErrorInvalidValue;
  }
  int res[2], dev = 0, sms = 0;
  cudaError_t err = occupancy<T>(stages, res);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return err;
  }
  if (res[1] < 1) return cudaErrorInvalidConfiguration;
  const int rps = kStageIds / k;
  const int chunks = (rows + rps - 1) / rps;
  take_sum_kernel<T><<<min(chunks, sms * res[1]), kThreads, res[0], s>>>(
      static_cast<const T*>(tbl), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), rows, k, stages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f2v

extern "C" int f2v_take_sum(const void* tbl, int tbl_is_bf16, const void* idx,
                            void* out, int rows, int k, int dim, int stages,
                            void* stream) {
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tbl_is_bf16 ? f2v::launch<__nv_bfloat16>(tbl, idx, out, rows, k, dim,
                                                  stages, s)
                     : f2v::launch<float>(tbl, idx, out, rows, k, dim, stages,
                                          s);
}

// res[0]: dynamic shared memory bytes per block at `stages`; res[1]: blocks
// an SM holds.
extern "C" int f2v_take_sum_occupancy(int tbl_is_bf16, int stages,
                                      void* res) {
  int* r = static_cast<int*>(res);
  return tbl_is_bf16 ? f2v::occupancy<__nv_bfloat16>(stages, r)
                     : f2v::occupancy<float>(stages, r);
}
