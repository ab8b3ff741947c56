// The force kernels with the embedding dim split over tp ranks.
//
// Replaces the JAX package's tp sync step, which runs in jnp ops because
// Pallas is off at tp > 1 (force2vec_tpu/train/sync.py:269), its pair
// scalars completed by a psum over tp (force2vec_tpu/dist/spmd.py:44-51).
// Under tp a rank holds d = D / tp columns of every row, so a pair's scalar
// a (|x_i - xg_j|^2, or x_i . xg_j for the sigmoid family) is a sum over
// the ranks, and the fused kernels, which reduce a row's whole width in
// registers, cannot make it.  A force over a work table (common.cuh) then
// takes two launches around the caller's all_reduce:
//
//   tp_pair_partial: part[s] = this rank's share of a, for every slot s of
//                    the table (0 in the padded slots k >= deg);
//   tp_pair_force:   out[out_begin + r] = sum_{k < deg[r]}
//                      term(coeff(a[s], invd[i], step), vec(x_i, xg_j))
//                    over this rank's d columns, with a the reduced scalars;
//
// with the force models of the fused kernels (common.cuh's EdgeForce and
// SampleForce): the edge forces for the attraction, the sample forces for
// the repulsion (group-shared negatives as one row of ns ids per row).  The
// sync trainer lays the attraction's and the repulsion's tables end to end,
// so an iteration makes one tp_pair_partial launch and one all_reduce, then
// a tp_pair_force launch for each on its slice of the scalars.  x_i and out
// are in X's type (f32, or bf16 or f16 with X itself as the gather table:
// common.cuh::with_dtypes); the pair scalars stay f32 whatever X's type,
// and so does the caller's all_reduce of them (the JAX package's jnp step
// forms them in X's dtype).
//
// What bounds them: bytes.  At the main path's shapes (tp = 2, d = 64
// columns a rank, bf16 gathers, main's edge table) each reads 2.10 M
// neighbour rows of 128 bytes, mostly from the L2 that holds the whole
// 17 MB replica half; the functions' own bytes (each input once, each
// output once) take 0.0209 ms (partial, with 10.3 MB of scalars written)
// and 0.0304 ms (force, with the scalars read) at 3.35 TB/s.
//
// Design: both are instances of the fused kernels' gather engine
// (common.cuh::ell_block) over the row classes of with_row_class (16-byte
// pieces, G lanes a row, U neighbour rows in flight a group, x_i loaded
// once per row over its whole width), with a scalar policy:
// tp_pair_partial stores each slot's group sum (kStore) and sums no
// force; tp_pair_force reads the scalars a round at a time beside the ids
// (kLoad) and makes no dot product.  The design before it (a warp per
// table row, one slot at a time, 2- or 4-byte loads at stride 32, x_i
// reloaded per slot or 256-column block) took 0.2321 and 0.2316 ms there.

#include "common.cuh"

namespace f2v {

// The two launches for gather type T and X type TX: defined, with their
// kernels, in the object the build compiles for that pair (-DF2V_GATHER,
// -DF2V_X); the entry points' object calls them.
template <typename T, typename TX>
cudaError_t partial_launch(EllArgs<T, TX>& p, const int64_t* table, int n,
                           int dot, cudaStream_t s);
template <typename T, typename TX>
cudaError_t force_launch(EllArgs<T, TX>& p, const int64_t* table, int n,
                         int kind, int model, cudaStream_t s);

#ifdef F2V_X
namespace {

template <typename T, typename TX, int G, int P, bool kFull, bool kDot>
__global__ void __launch_bounds__(kEllThreads,
                                  RowClass<T, G, P, kFull>::kMinBlocks)
    tp_pair_partial_kernel(const __grid_constant__ EllArgs<T, TX> p) {
  ell_block<T, TX, RowClass<T, G, P, kFull>, PairScalar<kDot>, kStore>(p);
}

// kLoad keeps a few registers more than the fused kernels (a slot offset
// and its scalar a round): rows that fill 16 or 32 lanes of one piece
// spilled at the fused classes' 5 blocks an SM (96 registers) and take
// 4 (up to 102 used, none spilled, on an H100).
template <class RC>
constexpr int load_min_blocks() {
  return RC::P == 1 && RC::G >= 16 && RC::kFull ? 4 : RC::kMinBlocks;
}

template <typename T, typename TX, int G, int P, bool kFull, class F>
__global__ void __launch_bounds__(
    kEllThreads, load_min_blocks<RowClass<T, G, P, kFull>>())
    tp_pair_force_kernel(const __grid_constant__ EllArgs<T, TX> p) {
  ell_block<T, TX, RowClass<T, G, P, kFull>, F, kLoad>(p);
}

template <class RC, class A, class Kernel>
cudaError_t run(Kernel kernel, A& p, const int64_t* table, int n,
                cudaStream_t s) {
  const int64_t blocks = ell_plan<RC>(p, table, n);
  if (blocks < 0) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  kernel<<<dim3(static_cast<unsigned>(blocks)), kEllThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TX, class RC>
cudaError_t force(EllArgs<T, TX>& p, const int64_t* table, int n, int kind,
                  int model, cudaStream_t s) {
  if (p.sm_table == nullptr && ((kind == 0 && model == kSigmoidTable) ||
                                (kind == 1 && model == kSigmoidTableRep))) {
    return cudaErrorInvalidValue;
  }
  auto go = [&](auto f) {
    return run<RC>(
        tp_pair_force_kernel<T, TX, RC::G, RC::P, RC::kFull, decltype(f)>,
        p, table, n, s);
  };
  if (kind == 0) {
    switch (model) {
      case kTdist: return go(EdgeForce<kTdist>{});
      case kSigmoid: return go(EdgeForce<kSigmoid>{});
      case kFr: return go(EdgeForce<kFr>{});
      case kLinlog: return go(EdgeForce<kLinlog>{});
      case kForceatlas: return go(EdgeForce<kForceatlas>{});
      case kSigmoidTable: return go(EdgeForce<kSigmoidTable>{});
      default: return cudaErrorInvalidValue;
    }
  }
  if (kind != 1) return cudaErrorInvalidValue;
  switch (model) {
    case kTdistRep: return go(SampleForce<kTdistRep>{});
    case kSigmoidRep: return go(SampleForce<kSigmoidRep>{});
    case kLayoutRep: return go(SampleForce<kLayoutRep>{});
    case kSigmoidTableRep: return go(SampleForce<kSigmoidTableRep>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

template <typename T, typename TX>
cudaError_t partial_launch(EllArgs<T, TX>& p, const int64_t* table, int n,
                           int dot, cudaStream_t s) {
  return with_row_class<T>(p.dim, [&](auto rc) {
    using RC = decltype(rc);
    return dot ? run<RC>(tp_pair_partial_kernel<T, TX, RC::G, RC::P,
                                                RC::kFull, true>,
                         p, table, n, s)
               : run<RC>(tp_pair_partial_kernel<T, TX, RC::G, RC::P,
                                                RC::kFull, false>,
                         p, table, n, s);
  });
}

template <typename T, typename TX>
cudaError_t force_launch(EllArgs<T, TX>& p, const int64_t* table, int n,
                         int kind, int model, cudaStream_t s) {
  return with_row_class<T>(p.dim, [&](auto rc) {
    return force<T, TX, decltype(rc)>(p, table, n, kind, model, s);
  });
}

using PairArgs = EllArgs<TypeOf<F2V_GATHER>, TypeOf<F2V_X>>;
template cudaError_t partial_launch(PairArgs&, const int64_t*, int, int,
                                    cudaStream_t);
template cudaError_t force_launch(PairArgs&, const int64_t*, int, int, int,
                                  cudaStream_t);
#endif  // F2V_X

}  // namespace f2v

#ifndef F2V_X
namespace {

// The arguments both entry points share, for gather type T and X type TX.
template <typename T, typename TX>
f2v::EllArgs<T, TX> args(const void* x, const void* xg, const void* nbr,
                         const void* deg, const void* xi_row, int dim) {
  f2v::EllArgs<T, TX> p{};
  p.x = static_cast<const TX*>(x);
  p.xg = static_cast<const T*>(xg);
  p.nbr = static_cast<const int32_t*>(nbr);
  p.deg = static_cast<const int32_t*>(deg);
  p.xi_row = static_cast<const int32_t*>(xi_row);
  p.dim = dim;
  return p;
}

}  // namespace

// table: [n_entries, 5] int64 in host memory, as f2v_ell_edge_force's.
// dim: this rank's columns, a multiple of kRowAlign up to kMaxDim, rows
// 16-byte aligned.  dot: a is x_i . xg_j, else |x_i - xg_j|^2.  part:
// [slots] f32, one per slot of nbr.  xg_dtype, x_dtype: the gather table's
// and x's element types, DType codes (an f32 x with any gather type,
// another x with its own).
extern "C" int f2v_tp_pair_partial(const void* x, const void* xg,
                                   int xg_dtype, int x_dtype,
                                   const void* nbr, const void* deg,
                                   const void* xi_row, void* part,
                                   const void* table, int n_entries, int dim,
                                   int dot, void* stream) {
  return f2v::with_dtypes(xg_dtype, x_dtype, [&](auto types) {
    using T = typename decltype(types)::T;
    using TX = typename decltype(types)::TX;
    auto p = args<T, TX>(x, xg, nbr, deg, xi_row, dim);
    p.part = static_cast<float*>(part);
    return f2v::partial_launch<T, TX>(p, static_cast<const int64_t*>(table),
                                      n_entries, dot,
                                      static_cast<cudaStream_t>(stream));
  });
}

// kind: 0 the edge force (model an EdgeModel id), 1 the sample force
// (a SampleModel id).  a: [slots] f32 reduced scalars.  invd: read only by
// the sigmoid edge forces; sm_table only by the table models.  xg_dtype,
// x_dtype: as f2v_tp_pair_partial's (x, invd and out in x's type).  step:
// a device f32 scalar, read by the kernel.
extern "C" int f2v_tp_pair_force(const void* x, const void* xg,
                                 int xg_dtype, int x_dtype,
                                 const void* nbr, const void* deg,
                                 const void* xi_row, const void* invd,
                                 const void* sm_table, const void* a,
                                 const void* step, void* out,
                                 const void* table, int n_entries, int dim,
                                 int kind, int model, void* stream) {
  if (step == nullptr) return cudaErrorInvalidValue;
  return f2v::with_dtypes(xg_dtype, x_dtype, [&](auto types) {
    using T = typename decltype(types)::T;
    using TX = typename decltype(types)::TX;
    auto p = args<T, TX>(x, xg, nbr, deg, xi_row, dim);
    p.invd = static_cast<const TX*>(invd);
    p.sm_table = static_cast<const float*>(sm_table);
    p.a = static_cast<const float*>(a);
    p.out = static_cast<TX*>(out);
    p.step = static_cast<const float*>(step);
    return f2v::force_launch<T, TX>(p, static_cast<const int64_t*>(table),
                                    n_entries, kind, model,
                                    static_cast<cudaStream_t>(stream));
  });
}
#endif  // !F2V_X
