// Attraction over one ELL bucket, with the neighbour gather in the kernel.
//
// Replaces force2vec_tpu/ops/pallas_force.py::ell_force_mxu (and the bulk
// `take` that fed it).  For each bucket row r, with i = xi_row[r]:
//   out[r] = sum_{k < deg[r]} coeff(a_rk, invd[i], step) * vec_rk
// where a is |x_i - xg_j|^2 (dist2) or x_i . xg_j (dot), vec is x_i - xg_j,
// xg_j - x_i or xg_j, and j = nbr[r, k].  x_i stays f32; only the
// neighbour rows come from the (bf16 or f32) gather replica xg.
//
// What bounds it: random row reads of the replica.  At the bench shape
// (131,072 vertices, dim 128, bf16) an iteration reads 2.10 M neighbour
// rows of 256 bytes, 537 MB; the 2.57 M padded ELL slots are skipped, not
// masked.  The whole 32 MB replica fits in the H100's 50 MB L2, which a
// later change may exploit.
//
// Design: one warp per row, each lane holding dim/32 elements of x_i and of
// the running sum.  The warp loads up to 32 neighbour ids at once and hands
// them out with shuffles; four neighbour rows are loaded before any is used,
// so four row reads are in flight per warp.  The per-pair scalar a is a
// butterfly warp sum.  The TPU kernel's 8-row block-diagonal matmuls and
// norm-form a existed only because Mosaic lacks a cheap lane reduction and
// a row gather; neither limit applies here.

#include "common.cuh"

namespace f2v {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kInFlight = 4;  // neighbour rows loaded ahead per warp

// Model ids shared with force_kernels.py (_EDGE_MODEL_IDS).
enum EdgeModel { kTdist = 0, kSigmoid = 1, kFr = 2, kLinlog = 3,
                 kForceatlas = 4 };

template <typename T>
struct EdgeArgs {
  const float* x;        // [n_pad, D]
  const T* xg;           // [n_pad, D] gather replica
  const int32_t* nbr;    // [rows, width]
  const int32_t* deg;    // [rows]
  const int32_t* xi_row; // [rows] table row of each bucket row's vertex
  const float* invd;     // [n_pad] 1 / (deg + 1)
  float step;
  float* out;            // [rows, D]
  int rows;
  int width;
};

// The per-pair scalar of models/forces.py::_<model>_coeff.
template <int M>
__device__ __forceinline__ float edge_coeff(float a, float invd, float step) {
  if constexpr (M == kTdist) {
    return step * -2.0f / (1.0f + a);
  } else if constexpr (M == kSigmoid) {
    return step * invd * (1.0f - sigmoidf(a));
  } else if constexpr (M == kFr) {
    return a > 0.0f ? a + 1.0f / a : 0.0f;
  } else if constexpr (M == kLinlog) {
    return log2f(1.0f + sqrtf(fmaxf(a, 0.0f)));
  } else {
    return a > 0.0f ? sqrtf(a) + 1.0f / a : 0.0f;
  }
}

template <typename T, int V, int M>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ell_edge_force_kernel(const EdgeArgs<T> p) {
  constexpr int D = 32 * V;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // whole warp leaves together

  const int64_t i = p.xi_row[row];
  float xi[V];
  load_row<float, V>(p.x + i * D + lane * V, xi);
  const float invd_i = p.invd[i];
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;

  const int d = p.deg[row];
  const int32_t* nrow = p.nbr + row * p.width;
  for (int k0 = 0; k0 < d; k0 += 32) {
    const int cnt = min(32, d - k0);
    const int my_j = lane < cnt ? nrow[k0 + lane] : 0;
    for (int k = 0; k < cnt; k += kInFlight) {
      float xj[kInFlight][V];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int64_t j = __shfl_sync(kFullMask, my_j, k + u);
        if (k + u < cnt) load_row<T, V>(p.xg + j * D + lane * V, xj[u]);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (k + u >= cnt) break;  // warp-uniform
        float vec[V];
        float part = 0.0f;
        if constexpr (M == kSigmoid) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            vec[v] = xj[u][v];
            part += xi[v] * xj[u][v];
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            vec[v] = M == kTdist ? xi[v] - xj[u][v] : xj[u][v] - xi[v];
            part += vec[v] * vec[v];
          }
        }
        const float c = edge_coeff<M>(warp_sum(part), invd_i, p.step);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += c * vec[v];
      }
    }
  }
  store_row<V>(p.out + row * D + lane * V, acc);
}

template <typename T, int V>
cudaError_t launch_model(int model, const EdgeArgs<T>& p, cudaStream_t s) {
  const dim3 grid((p.rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  switch (model) {
    case kTdist:
      ell_edge_force_kernel<T, V, kTdist><<<grid, block, 0, s>>>(p);
      break;
    case kSigmoid:
      ell_edge_force_kernel<T, V, kSigmoid><<<grid, block, 0, s>>>(p);
      break;
    case kFr:
      ell_edge_force_kernel<T, V, kFr><<<grid, block, 0, s>>>(p);
      break;
    case kLinlog:
      ell_edge_force_kernel<T, V, kLinlog><<<grid, block, 0, s>>>(p);
      break;
    case kForceatlas:
      ell_edge_force_kernel<T, V, kForceatlas><<<grid, block, 0, s>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* xg, const void* nbr,
                   const void* deg, const void* xi_row, const void* invd,
                   float step, void* out, int rows, int width, int dim,
                   int model, cudaStream_t s) {
  const EdgeArgs<T> p{static_cast<const float*>(x),
                      static_cast<const T*>(xg),
                      static_cast<const int32_t*>(nbr),
                      static_cast<const int32_t*>(deg),
                      static_cast<const int32_t*>(xi_row),
                      static_cast<const float*>(invd),
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

extern "C" int f2v_ell_edge_force(const void* x, const void* xg,
                                  int xg_is_bf16, const void* nbr,
                                  const void* deg, const void* xi_row,
                                  const void* invd, float step, void* out,
                                  int rows, int width, int dim, int model,
                                  void* stream) {
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return xg_is_bf16
             ? f2v::launch<__nv_bfloat16>(x, xg, nbr, deg, xi_row, invd,
                                          step, out, rows, width, dim, model,
                                          s)
             : f2v::launch<float>(x, xg, nbr, deg, xi_row, invd, step, out,
                                  rows, width, dim, model, s);
}

extern "C" const char* f2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
