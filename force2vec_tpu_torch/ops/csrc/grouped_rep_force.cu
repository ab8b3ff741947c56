// Repulsion from group-shared negative samples.
//
// Replaces force2vec_tpu/ops/pallas_force.py::grouped_rep_force.  Row r
// belongs to group r / group, and every row of a group repels from the
// same ns sample rows:
//   out[r] = sum_{s < ns} sample_force(xi[r], sg[r / group, s], step)
// xi and out are in X's type (f32, or bf16 with the samples gathered from
// X itself: the kXBf16 instances; the sums are f32, rounded once at the
// store); the samples come from the (bf16 or f32) gather replica.  Rows
// are any multiple of 8 wide up to kMaxDim; the sigmoid comes exact or from
// the reference's lookup table (kSigmoidTableRep).
//
// What bounds it: streaming xi in and out, 2 x 64 MB of f32 per iteration
// at the bench shape (131,072 x 128), 2 x 32 MB with X in bf16; the
// samples are 640 KB of bf16.
//
// Design, the TPU kernel's own idea: the [rows, ns, D] expand of the group
// samples never touches device memory.  A block owns up to 4 rounds of
// rows of one group, copies that group's [ns, D] block into shared memory
// as f32 once (2.5 KB at ns 5, dim 128), and each group of lanes computes
// whole rows from it: the f32 row classes of common.cuh (RowClass<float>:
// one row a warp, a 16-byte piece a lane, at dim 128; two rows a warp at
// dim 64; a warp with 8 pieces a lane at dim 1024), whatever X's type (a
// bf16 X reads and writes 8 bytes of each piece's 4 elements).  Samples past
// kMaxSampleBytes of shared memory (ns > 12 at dim 1024) go in chunks, a
// launch each, the later ones adding into what the last stored, so every
// ns fits and the sum runs over s in order either way (with a bf16 X each
// later chunk adds into the rounded sum before it).  Nothing carries across
// blocks.

#include "common.cuh"

namespace f2v {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRounds = 4;  // rounds of rows a block (32 rows at a row a warp)
// shared memory of samples a launch (force_kernels._MAX_SAMPLE_BYTES)
constexpr int kMaxSampleBytes = 48 * 1024;

struct RepArgs {
  const void* xi;         // [rows, dim], X's type (kXBf16: bf16, else f32)
  const void* sg;         // [ng, ns, dim], bf16 or f32
  const float* sm_table;  // [2048] sigmoid table; read only by table models
  float step;
  void* out;              // [rows, dim], X's type
  int rows;
  int group;
  int ns;
  int dim;
  int c0;   // this launch's samples: [c0, c0 + cn) of each group's ns
  int cn;
  int add;  // add into out (a later chunk of samples) instead of storing
  int tiles_per_group;
  int sg_is_bf16;
};

// samples[0, cn·dim) = f32 of group g's samples [c0, c0 + cn).
__device__ __forceinline__ void fill_samples(const RepArgs& p, float* samples,
                                             int64_t g, int c0, int cn) {
  const int64_t src = (g * p.ns + c0) * int64_t(p.dim);
  const int count = cn * p.dim;
  if (p.sg_is_bf16) {
    const __nv_bfloat16* sg = static_cast<const __nv_bfloat16*>(p.sg) + src;
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      samples[e] = to_f32(sg[e]);
    }
  } else {
    const float* sg = static_cast<const float*>(p.sg) + src;
    for (int e = threadIdx.x; e < count; e += blockDim.x) samples[e] = sg[e];
  }
}

// The rows [warp_first + k·rounds, hi) of one group against the cn samples
// in shared memory: each warp's rows start together, so that all its lanes
// take part in every group sum (a lane past the last row computes on
// zeros).  ``add``: add into the rows an earlier chunk of samples stored.
template <bool kXBf16, int G, int P, bool kFull, int M>
__device__ __forceinline__ void rep_rows(const RepArgs& p,
                                         const float* samples,
                                         int warp_first, int hi,
                                         int cn, bool add) {
  using RC = RowClass<float, G, P, kFull>;
  using F = SampleForce<M>;
  using TX = XElem<kXBf16>;
  const TX* xs = static_cast<const TX*>(p.xi);
  TX* out = static_cast<TX*>(p.out);
  constexpr int E = RC::E;  // f32 elements a 16-byte piece
  constexpr int kRowsPerRound = kWarpsPerBlock * (32 / G);
  const int64_t dim = kFull ? RC::D : p.dim;
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  // a lane's piece c is the row's piece c·G + gl, there when c·G < mine
  // (tested where used: eight flags held across the loops spilled)
  const int mine = int(dim / E) - gl;
  for (int rw = warp_first; rw < hi; rw += kRowsPerRound) {
    const int r = rw + lane / G;
    const bool live = G == 32 || r < hi;  // a warp's one row is live
    float xi[P][E], acc[P][E];
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const int64_t off = int64_t(r) * dim + (c * G + gl) * E;
      if (live && (kFull || c * G < mine)) {
        load_row<TX, E>(xs + off, xi[c]);
        if (add) {
          load_row<TX, E>(out + off, acc[c]);
        } else {
#pragma unroll
          for (int v = 0; v < E; ++v) acc[c][v] = 0.0f;
        }
      } else {
#pragma unroll
        for (int v = 0; v < E; ++v) xi[c][v] = acc[c][v] = 0.0f;
      }
    }
    for (int s = 0; s < cn; ++s) {
      // up to 2 pieces a lane the sample's pieces stay in registers
      // between the scalar and the terms; wider, they are read from
      // shared memory twice (held, 8 pieces a lane spilled)
      constexpr bool kHold = P <= 2;
      const float* sp = samples + s * dim;
      float sv[kHold ? P : 1][E];
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < P; ++c) {
        if (kFull || c * G < mine) {
          float t[E];
          load_row<float, E>(sp + (c * G + gl) * E, t);
          const float pc = pair_part<F, E>(xi[c], t);
          part = c == 0 ? pc : part + pc;  // no 0 + x a sample
          if constexpr (kHold) {
#pragma unroll
            for (int v = 0; v < E; ++v) sv[c][v] = t[v];
          }
        }
      }
      const float cf = F::coeff(group_sum<G>(part), 0.0f, p.step,
                                p.sm_table);
#pragma unroll
      for (int c = 0; c < P; ++c) {
        if (kFull || c * G < mine) {
          float t[E];
          if constexpr (kHold) {
#pragma unroll
            for (int v = 0; v < E; ++v) t[v] = sv[c][v];
          } else {
            load_row<float, E>(sp + (c * G + gl) * E, t);
          }
#pragma unroll
          for (int v = 0; v < E; ++v) {
            acc[c][v] += F::term(cf, F::vec(xi[c][v], t[v]), p.step);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < P; ++c) {
      if (live && (kFull || c * G < mine)) {
        store_x<TX, E>(out + int64_t(r) * dim + (c * G + gl) * E, acc[c]);
      }
    }
  }
}

// One piece a lane streams x_i in and out with little arithmetic: 8 blocks
// an SM (32 registers, every warp slot of the SM) keep enough loads in
// flight; left to choose, the compiler took 40 registers (6 blocks), and
// tdist at dim 128 ran 8% slower on an H100.  The sigmoid family's exact
// and table σ need more registers than 32 hold and keep the default.
template <int M>
constexpr int kRepMinBlocks(int pieces) {
  return pieces == 1 && (M == kTdistRep || M == kLayoutRep) ? 8 : 1;
}

template <bool kXBf16, int G, int P, bool kFull, int M>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kRepMinBlocks<M>(P))
    grouped_rep_force_kernel(const RepArgs p) {
  constexpr int kRowsPerBlock = kRounds * kWarpsPerBlock * (32 / G);
  extern __shared__ float4 smem[];  // [chunk, dim] of this block's group
  float* samples = reinterpret_cast<float*>(smem);
  const int g = blockIdx.x / p.tiles_per_group;
  const int tile = blockIdx.x % p.tiles_per_group;
  // rows in 32 bits (rows < 2^31; g·group < rows): 64-bit ones took the
  // registers that 8 blocks an SM do not have
  const int64_t g0 = int64_t(g) * p.group;
  const int64_t lo = g0 + int64_t(tile) * kRowsPerBlock;
  int64_t end = lo + kRowsPerBlock;
  if (end > g0 + p.group) end = g0 + p.group;
  if (end > p.rows) end = p.rows;
  if (lo >= end) return;  // the whole block: no row of this group left
  const int hi = int(end);
  const int warp_first = int(lo) + (threadIdx.x >> 5) * (32 / G);
  fill_samples(p, samples, g, p.c0, p.cn);
  __syncthreads();
  rep_rows<kXBf16, G, P, kFull, M>(p, samples, warp_first, hi, p.cn,
                                   p.add != 0);
}

// One launch, or with more samples than kMaxSampleBytes of shared memory
// holds one launch a chunk of them, each later one adding into the rows the
// last stored (the sum still runs over the samples in order).
template <bool kXBf16, int G, int P, bool kFull>
cudaError_t launch(int model, RepArgs p, int groups, cudaStream_t s) {
  constexpr int kRowsPerBlock = kRounds * kWarpsPerBlock * (32 / G);
  p.tiles_per_group = (p.group + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t blocks = int64_t(groups) * p.tiles_per_group;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  void (*kernel)(RepArgs) = nullptr;
  switch (model) {
    case kTdistRep:
      kernel = grouped_rep_force_kernel<kXBf16, G, P, kFull, kTdistRep>;
      break;
    case kSigmoidRep:
      kernel = grouped_rep_force_kernel<kXBf16, G, P, kFull, kSigmoidRep>;
      break;
    case kLayoutRep:
      kernel = grouped_rep_force_kernel<kXBf16, G, P, kFull, kLayoutRep>;
      break;
    case kSigmoidTableRep:
      if (p.sm_table == nullptr) return cudaErrorInvalidValue;
      kernel = grouped_rep_force_kernel<kXBf16, G, P, kFull, kSigmoidTableRep>;
      break;
    default:
      return cudaErrorInvalidValue;
  }
  const int chunk = kMaxSampleBytes / (p.dim * int(sizeof(float)));
  const size_t smem =
      size_t(p.ns < chunk ? p.ns : chunk) * p.dim * sizeof(float);
  for (int c0 = 0; c0 < p.ns; c0 += chunk) {
    p.c0 = c0;
    p.cn = p.ns - c0 < chunk ? p.ns - c0 : chunk;
    p.add = c0 > 0;
    kernel<<<dim3(static_cast<unsigned>(blocks)), kWarpsPerBlock * 32, smem,
             s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace f2v

// sm_table: the device's [2048] f32 sigmoid table for kSigmoidTableRep,
// else unused (may be null).  xi_is_bf16: xi and out are bf16 (then sg
// must be bf16 too), else f32.
extern "C" int f2v_grouped_rep_force(const void* xi, const void* sg,
                                     int sg_is_bf16, int xi_is_bf16,
                                     const void* sm_table, float step,
                                     void* out, int rows, int group, int ns,
                                     int dim, int model, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (group <= 0 || ns <= 0 || dim < f2v::kRowAlign || dim > f2v::kMaxDim ||
      (xi_is_bf16 && !sg_is_bf16)) {
    return cudaErrorInvalidValue;
  }
  const f2v::RepArgs p{xi,
                       sg,
                       static_cast<const float*>(sm_table),
                       step,
                       out,
                       rows,
                       group,
                       ns,
                       dim,
                       0,
                       ns,
                       0,
                       0,
                       sg_is_bf16 != 0};
  const int groups = (rows + group - 1) / group;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the f32 row classes: the samples and x_i are f32 in the kernel
  return f2v::with_row_class<float>(dim, [&](auto rc) {
    using RC = decltype(rc);
    return xi_is_bf16
               ? f2v::launch<true, RC::G, RC::P, RC::kFull>(model, p, groups,
                                                            s)
               : f2v::launch<false, RC::G, RC::P, RC::kFull>(model, p,
                                                             groups, s);
  });
}
