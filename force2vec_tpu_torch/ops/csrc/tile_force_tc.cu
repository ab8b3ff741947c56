// tdist edge sweep over a materialised tile, with the D-axis reduction on
// the tensor cores:
//   a_rk   = sum_d (xi[r, d] - xj[r, k, d])^2
//   out[r] = sum_{k < deg[r]} clip(-2 / (1 + a_rk) * (xi[r] - xj[r, k]), +-5)
//            * step
//
// Replaces benchmarks/exp_r3.py::mxu_force (body mxu_kernel, nested in
// exp_sweepvar), the TPU prototype that took a_rk as a matmul of the
// squared differences by a ones vector on the MXU.  Here the same product
// runs on Hopper's tensor cores with mma.sync (TF32, m16n8k8, B = ones,
// which TF32 holds exactly); the coefficient, the clip, the step and the
// masked sum over K run on the CUDA cores, as mxu_kernel does on the VPU.
//
// Precision: one TF32 pass.  Each squared difference is rounded to TF32
// (cvt.rna, round to nearest), at most 2^-11 of itself; the products by 1
// and their f32 sums are exact up to f32 rounding.  So |da| <= 2^-11 * a,
// the coefficient moves by at most 2^-11 * a / (1 + a) of itself, and with
// |2 (xi - xj)_d / (1 + a)| <= 1 the clip never binds, so each term moves
// by at most 2^-11 of itself.  chip_smoke.py holds the kernel to
// (1e-5 + 2^-11) * sum |terms|.  3xTF32 would keep the f32 bound at three
// times the tensor-core work; the probe asks what one pass costs, and a
// term error of 2^-11 is far below the bf16 rounding of xj itself.
//
// What bounds it: bytes.  Over the bench layout's 13 buckets the function
// reads the real slots of the bf16 tile (2,097,122 rows of 256 bytes, 537
// MB; slots past deg are skipped, not read), xi and deg, and writes out.
// The tensor-core work (2 * 128 flops per slot at 495 TFLOP/s) is < 1% of
// that time.
//
// Design: one warp per tile row.  The warp takes the row's slots eight at
// a time, one per 4-lane group; lane t of group g holds values
// 32 j + 8 t + [0, 8) (j < 4) of slot k0 + g, so a group reads a slot's
// bytes contiguously.  Each lane feeds its 32 squared differences to 8
// mma.sync as A fragments.  Whatever the fragment layout, the A rows g and
// g + 8 come only from group g's lanes, and with B = ones every column of C
// holds its row's sum, so c0 + c2 of any lane of group g is a_{r, k0+g}.
// Slots at or past deg[r] enter as zero differences and add exactly 0.
// The per-slot sums are then added across the 8 groups by shuffles.

#include "common.cuh"

namespace f2v {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSlots = 8;   // slots per step: one per 4-lane group
constexpr int kVals = 8;    // contiguous values per piece
constexpr int kPieces = kDim / (4 * kVals);  // pieces per lane and slot
static_assert(kPieces * kVals % 4 == 0, "A fragments take 4 values");

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += A x ones, A the warp's [16, 8] TF32 fragment a.
__device__ __forceinline__ void mma_row_sums(float (&c)[4],
                                             const uint32_t (&a)[4]) {
  const uint32_t one = 0x3f800000u;  // 1.0f, exact in TF32
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(one), "r"(one));
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    tile_force_tc_kernel(const float* __restrict__ xi,
                         const T* __restrict__ xj,
                         const int32_t* __restrict__ deg, float step,
                         float* __restrict__ out, int rows, int width) {
  constexpr int D = kDim;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int off = 8 * (lane & 3);
  const int64_t row =
      int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together

  float x[kPieces][kVals];
  float acc[kPieces][kVals];
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    load_row<float, kVals>(xi + row * D + 32 * j + off, x[j]);
#pragma unroll
    for (int v = 0; v < kVals; ++v) acc[j][v] = 0.0f;
  }
  const int d = min(deg[row], width);
  const T* xrow = xj + row * int64_t(width) * D;
  for (int k0 = 0; k0 < d; k0 += kSlots) {  // warp-uniform
    const int k = k0 + g;
    float diff[kPieces][kVals];
    if (k < d) {
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        load_row<T, kVals>(xrow + int64_t(k) * D + 32 * j + off, diff[j]);
#pragma unroll
        for (int v = 0; v < kVals; ++v) diff[j][v] = x[j][v] - diff[j][v];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
#pragma unroll
        for (int v = 0; v < kVals; ++v) diff[j][v] = 0.0f;
      }
    }
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int m = 0; m < kPieces * kVals / 4; ++m) {
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = diff[m / 2][(m % 2) * 4 + i];
        a[i] = to_tf32(e * e);
      }
      mma_row_sums(c, a);
    }
    const float coef = -2.0f / (1.0f + (c[0] + c[2]));
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
#pragma unroll
      for (int v = 0; v < kVals; ++v) {
        acc[j][v] += fminf(fmaxf(coef * diff[j][v], -kMaxBound), kMaxBound) *
                     step;
      }
    }
  }
  // add the 8 groups' partial sums: lanes with the same (lane & 3)
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
#pragma unroll
    for (int v = 0; v < kVals; ++v) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        acc[j][v] += __shfl_xor_sync(kFullMask, acc[j][v], o);
      }
    }
  }
  // group j < kPieces writes piece j (constant indices keep acc in registers)
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    if (g == j) store_row<kVals>(out + row * D + 32 * j + off, acc[j]);
  }
}

template <typename T>
cudaError_t launch(const void* xi, const void* xj, const void* deg,
                   float step, void* out, int rows, int width, int dim,
                   cudaStream_t s) {
  // dim 128 only: the probe's width (kPieces covers it exactly)
  if (dim != kDim) return cudaErrorInvalidValue;
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  tile_force_tc_kernel<T><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const float*>(xi), static_cast<const T*>(xj),
      static_cast<const int32_t*>(deg), step, static_cast<float*>(out), rows,
      width);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f2v

extern "C" int f2v_tile_force_tc(const void* xi, const void* xj,
                                 int xj_is_bf16, const void* deg, float step,
                                 void* out, int rows, int width, int dim,
                                 void* stream) {
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return xj_is_bf16
             ? f2v::launch<__nv_bfloat16>(xi, xj, deg, step, out, rows, width,
                                          dim, s)
             : f2v::launch<float>(xi, xj, deg, step, out, rows, width, dim, s);
}
