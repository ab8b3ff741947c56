// Repulsion from group-shared negative samples, with the update's last
// passes folded into the same launch.
//
// Replaces force2vec_tpu/ops/pallas_force.py::grouped_rep_force.  Row r
// belongs to group r / group, and every row of a group repels from the
// same ns sample rows:
//   rep[r] = sum_{s < ns} sample_force(xi[r], sg[r / group, s], step)
// summed over s in order in f32 and rounded once to X's type (f32, or bf16
// or f16 with the samples gathered from X itself; an f32 X's samples are
// f32, bf16 or f16, a runtime flag).  Rows are
// any multiple of 8 wide up to kMaxDim; the sigmoid comes exact or from the
// reference's lookup table (kSigmoidTableRep).  Three output modes, a
// runtime flag of one set of instances:
//   store: out[r] = rep[r];
//   add:   out[r] = out[r] + rep[r], rep rounded to X's type first
//          (common.cuh::store_or_add): out.add_(rep) of a store, bit for
//          bit;
//   apply: X[r] = X[r] + (upd[r] + rep[r]) in place (xi is X), rep and
//          upd + rep each rounded to X's type first: upd.add_(rep) then
//          x.add_(upd) of a store, bit for bit (the JAX iteration's
//          x + (upd + rep)), and upd left as it was.  Each element of X is
//          read and written by one thread, its read before its write; the
//          samples are a copy gathered before the launch.  With an f32 X
//          and xg_next given, each row's new X is also written rounded to
//          xg_next's type (bf16 or f16, a runtime flag: torch's cast, bit
//          for bit), the replica the next iteration gathers from; the
//          sigmoid family's instances only (kStoresReplica: rwalk's
//          repulsion, which the sync trainer runs in this mode beside a
//          2-byte replica).
//
// What bounds it: by its bytes, memory.  At the bench shape (131,072 x
// 128) store reads xi and writes out, 2 x 33.6 MB with X in bf16 (0.020 ms
// at 3.35 TB/s), 2 x 67.1 MB in f32; add and apply read a second [rows, D]
// operand (out, or upd) as well; the samples are 655 KB.  Its f32
// arithmetic (ns samples' distance, coefficient and terms a row) is of the
// same order as the bytes: warps in flight, not stages in shared memory,
// hide its latencies (PERF.md §9.6).
//
// Design, the TPU kernel's own idea: the [rows, ns, D] expand of the group
// samples never touches device memory.  A block owns up to kRounds rounds
// of rows of one group, copies that group's [ns, D] block into shared
// memory as f32 once (2.5 KB at ns 5, dim 128; 16-byte loads, a bf16 or
// f16 sg widened on the way), and each group of lanes computes whole rows
// from it in the row classes of X's type (common.cuh::with_row_class: at
// dim 128 a bf16 or f16 row is 16 lanes of one 16-byte piece, two rows a
// warp; an f32 row 32 lanes of one).  A lane loads its pieces of x_i, sums
// the samples in order, and writes by the mode: the store, or out's or
// upd's pieces loaded then and added.  Many small blocks keep the SM's
// warp slots full (8 blocks of 8 warps at 32 registers for tdist and the
// layout family at four f32 a lane).  Tried on an H100 and dropped
// (PERF.md §9.6): a persistent design with the row tiles streamed through
// a 4-stage cp.async.bulk ring by a producer warp and 4 consumer warps
// (20-24 warps an SM; slower in store, no faster in apply).
//
// Samples past kMaxSampleBytes of f32 (ns > 12 at dim 1024) go in chunks,
// a launch each: each chunk before the last leaves its rows' f32 sums in
// an f32 scratch ``part`` (no rounding), the next continues them in order,
// and the last applies the mode.  So a chunked sum rounds exactly as an
// unchunked one, in every mode.  Nothing carries across blocks.
//
// The build compiles the kernels once per X type, an object each
// (-DF2V_X), beside the entry point's object.

#include "common.cuh"

namespace f2v {

constexpr int kWarpsPerBlock = 8;
constexpr int kRounds = 4;  // rounds of rows a block (32 rows at a row a warp)
// shared memory of f32 samples a launch (force_kernels._MAX_SAMPLE_BYTES)
constexpr int kMaxSampleBytes = 48 * 1024;

enum RepMode { kStoreMode = 0, kAddMode = 1, kApplyMode = 2 };

struct RepArgs {
  const void* xi;         // [rows, dim], X's type; apply: X itself
  const void* sg;         // [ng, ns, dim], of type sg_dtype
  const float* sm_table;  // [2048] sigmoid table; read only by table models
  const void* upd;        // apply: [rows, dim], X's type
  void* out;              // [rows, dim], X's type; apply: X (== xi)
  float* part;            // [rows, dim] f32 sums between chunks, or null
  void* xg_next;          // apply, f32 X: [rows, dim] the next replica, or null
  const float* step;      // the step, a device scalar (read by each replay)
  int rows;
  int group;
  int ns;
  int dim;
  int mode;      // RepMode, applied by the last chunk
  int sg_dtype;  // DType code
  int xg_next_dtype;  // DType code of xg_next: kBf16 or kF16
  int c0;        // this launch's samples: [c0, c0 + cn) of each group's ns
  int cn;
  int part_in;   // continue the f32 sums in part (a chunk after the first)
  int part_out;  // leave the f32 sums in part (a chunk before the last)
  int tiles_per_group;
};

// The rep_launch of X type TX: defined, with its kernels, in the object the
// build compiles for that type; the entry point's object calls it.
template <typename TX>
cudaError_t rep_launch(int model, RepArgs p, cudaStream_t s);

#ifdef F2V_X
namespace {

// samples[0, cn·dim) = f32 of the T samples of group g, [c0, c0 + cn), a
// 16-byte piece at a time (dim is a multiple of 8: every piece is whole).
template <typename T>
__device__ __forceinline__ void fill_typed(const RepArgs& p, float* samples,
                                           int64_t g) {
  constexpr int E = 16 / int(sizeof(T));
  const T* sg = static_cast<const T*>(p.sg) + (g * p.ns + p.c0) * p.dim;
  const int count = p.cn * p.dim;
  for (int e = threadIdx.x * E; e < count; e += blockDim.x * E) {
    float v[E];
    load_row<T, E>(sg + e, v);
    store_row<E>(samples + e, v);
  }
}

__device__ __forceinline__ void fill_samples(const RepArgs& p, float* samples,
                                             int64_t g) {
  if (p.sg_dtype == kBf16) {
    fill_typed<__nv_bfloat16>(p, samples, g);
  } else if (p.sg_dtype == kF16) {
    fill_typed<__half>(p, samples, g);
  } else {
    fill_typed<float>(p, samples, g);
  }
}

// The instances that hold the next replica's store: an f32 X and the
// sigmoid family's repulsion.  tdist's and the layout family's f32
// instances run 8 blocks an SM at 32 registers (kRepMinBlocks), where the
// store spilled 4 to 12 bytes; the sync trainer never asks them for it
// (tdist's iteration writes its replica in ell_edge_apply).
template <typename TX, int M>
constexpr bool kStoresReplica = std::is_same_v<TX, float> &&
                                (M == kSigmoidRep || M == kSigmoidTableRep);

// X's new row piece o, at element off, into the next replica (apply with
// an f32 X): a piece of 4 f32 as 4 bf16 or f16, one 8-byte store.
template <typename TX, int M, int E>
__device__ __forceinline__ void store_replica(const RepArgs& p, int64_t off,
                                              const float (&o)[E]) {
  if constexpr (kStoresReplica<TX, M>) {
    if (p.xg_next_dtype == kBf16) {
      store_x<__nv_bfloat16, E>(static_cast<__nv_bfloat16*>(p.xg_next) + off,
                                o);
    } else {
      store_x<__half, E>(static_cast<__half*>(p.xg_next) + off, o);
    }
  }
}

// The rows [warp_first + k·rounds, hi) of one group against the cn samples
// in shared memory, then the mode's write: each warp's rows start
// together, so that all its lanes take part in every group sum (a lane
// past the last row computes on zeros and writes nothing).
template <typename TX, int G, int P, bool kFull, int M>
__device__ __forceinline__ void rep_rows(const RepArgs& p,
                                         const float* samples, float step,
                                         int warp_first, int hi) {
  using RC = RowClass<TX, G, P, kFull>;
  using F = SampleForce<M>;
  const TX* xs = static_cast<const TX*>(p.xi);
  TX* out = static_cast<TX*>(p.out);
  // add: out's row; apply: upd's
  const TX* second = static_cast<const TX*>(
      p.mode == kApplyMode ? p.upd : static_cast<const void*>(p.out));
  constexpr int E = RC::E;  // elements a 16-byte piece: 8 bf16 or f16, 4 f32
  constexpr int kRowsPerRound = kWarpsPerBlock * (32 / G);
  // up to 8 elements a lane the sample's pieces stay in registers between
  // the scalar and the terms; more, they are read from shared memory twice
  // (held, 8 f32 pieces a lane spilled, and so did the 32-lane f32 row
  // that fills its class, in the 32 registers of 8 blocks an SM)
  constexpr bool kHold =
      P * E <= 8 && !(E == 4 && P == 1 && G == 32 && kFull);
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
        if (p.part_in) {
          load_row<float, E>(p.part + off, acc[c]);
        } else {
#pragma unroll
          for (int v = 0; v < E; ++v) acc[c][v] = 0.0f;
        }
      } else {
#pragma unroll
        for (int v = 0; v < E; ++v) xi[c][v] = acc[c][v] = 0.0f;
      }
    }
    for (int s = 0; s < p.cn; ++s) {
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
      const float cf = F::coeff(group_sum<G>(part), 0.0f, step, p.sm_table);
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
            acc[c][v] += F::term(cf, F::vec(xi[c][v], t[v]), step);
          }
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      if (!(kFull || c * G < mine)) continue;
      const int64_t off = int64_t(r) * dim + (c * G + gl) * E;
      if (p.part_out) {
        store_row<E>(p.part + off, acc[c]);
      } else if (p.mode == kStoreMode) {
        store_x<TX, E>(out + off, acc[c]);
      } else {
        float o[E];
        load_row<TX, E>(second + off, o);
#pragma unroll
        for (int v = 0; v < E; ++v) {
          const float sum = __fadd_rn(o[v], round_to<TX>(acc[c][v]));
          o[v] = p.mode == kAddMode ? sum
                                    : __fadd_rn(xi[c][v], round_to<TX>(sum));
        }
        store_x<TX, E>(out + off, o);
        if (p.xg_next != nullptr) store_replica<TX, M, E>(p, off, o);
      }
    }
  }
}

// Four f32 a lane stream x_i in and out with little arithmetic: 8 blocks an
// SM (32 registers, every warp slot of the SM) keep enough loads in
// flight; left to choose, the compiler took 40 registers (6 blocks), and
// tdist at dim 128 ran 8% slower on an H100.  The sigmoid family's exact
// and table σ need more registers than 32 hold, and so do eight elements a
// lane (a bf16 or f16 piece, two f32 ones): they keep the compiler's
// choice, but for tdist's one-piece 2-byte rows that fill 4 to 16 lanes
// (dims 32 to 128), which fit 40 registers (6 blocks): with the step read
// from device memory the compiler took 45 to 48 (5 blocks), and dim 128
// ran 9% slower on an H100.
template <int M>
constexpr int kRepMinBlocks(int elements, int x_bytes, int lanes,
                            bool full) {
  if (elements == 4 && (M == kTdistRep || M == kLayoutRep)) return 8;
  const bool one_piece_2byte = x_bytes == 2 && elements == 8;
  return M == kTdistRep && one_piece_2byte && full && lanes >= 4 &&
                 lanes <= 16
             ? 6
             : 1;
}

template <typename TX, int G, int P, bool kFull, int M>
__global__ void __launch_bounds__(
    kWarpsPerBlock * 32,
    kRepMinBlocks<M>(P * RowClass<TX, G, P, kFull>::E, int(sizeof(TX)), G,
                     kFull))
    grouped_rep_force_kernel(const RepArgs p) {
  constexpr int kRowsPerBlock = kRounds * kWarpsPerBlock * (32 / G);
  extern __shared__ float4 smem[];  // [cn, dim] of this block's group
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
  // the step, one word for the block, loaded while the samples are staged
  const float step = __ldg(p.step);
  fill_samples(p, samples, g);
  __syncthreads();
  rep_rows<TX, G, P, kFull, M>(p, samples, step, warp_first, hi);
}

// The instance for `model`, or null.
template <typename TX, int G, int P, bool kFull>
void (*kernel_for(int model))(RepArgs) {
  switch (model) {
    case kTdistRep:
      return grouped_rep_force_kernel<TX, G, P, kFull, kTdistRep>;
    case kSigmoidRep:
      return grouped_rep_force_kernel<TX, G, P, kFull, kSigmoidRep>;
    case kLayoutRep:
      return grouped_rep_force_kernel<TX, G, P, kFull, kLayoutRep>;
    case kSigmoidTableRep:
      return grouped_rep_force_kernel<TX, G, P, kFull, kSigmoidTableRep>;
    default:
      return nullptr;
  }
}

// One launch, or with more samples than kMaxSampleBytes of f32 holds one a
// chunk of them, the f32 sums passed on in p.part.
template <typename TX, int G, int P, bool kFull>
cudaError_t launch(int model, RepArgs p, cudaStream_t s) {
  void (*kernel)(RepArgs) = kernel_for<TX, G, P, kFull>(model);
  if (kernel == nullptr ||
      (model == kSigmoidTableRep && p.sm_table == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int chunk = kMaxSampleBytes / (p.dim * int(sizeof(float)));
  if (p.ns > chunk && p.part == nullptr) return cudaErrorInvalidValue;
  constexpr int kRowsPerBlock = kRounds * kWarpsPerBlock * (32 / G);
  const int span = p.group < p.rows ? p.group : p.rows;
  p.tiles_per_group = (span + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t blocks =
      int64_t((p.rows + p.group - 1) / p.group) * p.tiles_per_group;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  for (int c0 = 0; c0 < p.ns; c0 += chunk) {
    p.c0 = c0;
    p.cn = p.ns - c0 < chunk ? p.ns - c0 : chunk;
    p.part_in = c0 > 0;
    p.part_out = c0 + p.cn < p.ns;
    const size_t smem = size_t(p.cn) * p.dim * sizeof(float);
    kernel<<<dim3(static_cast<unsigned>(blocks)), kWarpsPerBlock * 32, smem,
             s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// X's type picks the row classes: 16-byte pieces of 8 bf16 or f16, or of
// 4 f32
template <typename TX>
cudaError_t rep_launch(int model, RepArgs p, cudaStream_t s) {
  return with_row_class<TX>(p.dim, [&](auto rc) {
    using RC = decltype(rc);
    return launch<TX, RC::G, RC::P, RC::kFull>(model, p, s);
  });
}

template cudaError_t rep_launch<TypeOf<F2V_X>>(int, RepArgs, cudaStream_t);
#endif  // F2V_X

}  // namespace f2v

#ifndef F2V_X
// mode: 0 store (into out), 1 add (into out), 2 apply (xi is X, out must
// be xi, upd the update; xg_next: null, or with an f32 xi and the sigmoid
// family's model a [rows, dim] buffer of type xg_next_dtype (bf16 or f16)
// that takes X's new rows rounded to it).  sm_table: the device's [2048] f32 sigmoid table
// for kSigmoidTableRep, else unused (may be null).  sg_dtype, xi_dtype: the
// samples' and xi's (xi, out and upd) element types, DType codes (an f32
// xi with samples of any type, another xi with its own).  part: an f32
// [rows, dim] scratch when ns · dim · 4 passes kMaxSampleBytes, else
// unused.  step: a device f32 scalar, read by the kernel (a captured launch
// reads each replay's).
extern "C" int f2v_grouped_rep_force(const void* xi, const void* sg,
                                     int sg_dtype, int xi_dtype,
                                     const void* sm_table, const void* step,
                                     void* out, const void* upd, void* part,
                                     void* xg_next, int xg_next_dtype,
                                     int mode, int rows, int group, int ns,
                                     int dim, int model, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (step == nullptr || group <= 0 || ns <= 0 || dim < f2v::kRowAlign ||
      dim > f2v::kMaxDim || dim % f2v::kRowAlign != 0 ||
      mode < f2v::kStoreMode || mode > f2v::kApplyMode ||
      (mode == f2v::kApplyMode && (upd == nullptr || out != xi)) ||
      (xg_next != nullptr &&
       (mode != f2v::kApplyMode || xi_dtype != f2v::kF32 ||
        (model != f2v::kSigmoidRep && model != f2v::kSigmoidTableRep) ||
        (xg_next_dtype != f2v::kBf16 && xg_next_dtype != f2v::kF16)))) {
    return cudaErrorInvalidValue;
  }
  f2v::RepArgs p{};
  p.xi = xi;
  p.sg = sg;
  p.sm_table = static_cast<const float*>(sm_table);
  p.upd = upd;
  p.out = out;
  p.part = static_cast<float*>(part);
  p.step = static_cast<const float*>(step);
  p.rows = rows;
  p.group = group;
  p.ns = ns;
  p.dim = dim;
  p.mode = mode;
  p.sg_dtype = sg_dtype;
  p.xg_next = xg_next;
  p.xg_next_dtype = xg_next_dtype;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f2v::with_dtypes(sg_dtype, xi_dtype, [&](auto types) {
    return f2v::rep_launch<typename decltype(types)::TX>(model, p, s);
  });
}
#endif  // !F2V_X
