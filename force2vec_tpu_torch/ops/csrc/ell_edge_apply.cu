// The sync iteration's attraction, repulsion and update of X in one launch.
//
// Over a work table (common.cuh::ell_plan) whose entries each either apply
// or store.  For each row r of an applying entry, with i = xi_row[r]:
//   att = sum_{k < deg[r]} edge_force(x_i, xg[nbr[r, k]])   (or upd[r])
//   rep = sum_{s < ns} sample_force(x_i, xg[negs[i / group, s]])
//   X[i] = X[i] + (att + rep)
// with att and rep each summed in f32 in slot order and rounded to X's
// type, and att + rep rounded once more: the bits of the edge kernel's
// store, then grouped_rep_force.cu's `apply` (or ell_sample_force.cu's
// add into the update followed by `x.add_(upd)`).  A storing entry writes its rows'
// attraction sums into out, as ell_edge_force.cu does: the hub's virtual
// rows, whose owners a second launch over the owner rows applies from
// their ordered sums (`upd`, ops/segment.py::owner_sums).  Where xg_next
// is given, an applied row also writes its new X rounded to the replica's
// type into xg_next[i] (__float2bfloat16_rn / __float2half_rn, the bits
// of torch's cast): the replica the next iteration gathers from, so that
// no cast of X runs between iterations.  It must be a buffer other than
// xg, which the launch's other rows are still reading.  group is the
// batch of rows that share their negatives (1 for per-vertex negatives,
// `-bs 1`, whose negs are [n_pad, ns]): one code path for both.  The
// update never goes through device memory.
//
// In place, and why that is safe: during the launch no row of X is read
// but by its own row, before its own write.  The neighbours and the
// samples come from the replica xg, a buffer of its own (an f32 X beside a
// bf16 or f16 replica: common.cuh::F2V_APPLY_PAIRS, the only pairs built);
// the one exception, the hub's virtual rows reading their owners' x_i, is
// why the owners are applied by a second launch.  The caller's table puts
// each applied X row in one entry row, and no owner among them
// (force_kernels.ell_edge_apply).
//
// Design: the edge kernel's gather engine (common.cuh::ell_block) with an
// epilogue (ApplyRep): when a row's slot loop ends, its x_i and f32
// attraction are in registers; the epilogue runs the same loop over the
// row's ns sample ids (the samples of a group's rows are the same few
// replica rows, which its blocks read through the L1 and L2), then writes
// X.  At com-Youtube's shape (1.135 M rows, dim 128, bf16 replica) that
// leaves out the update's write and read back (2 x 581 MB) and a second
// read of X (581 MB) that the separate `apply` pass made.

#include "common.cuh"

namespace f2v {

// The edge kernel's arguments and the fused launch's own.
template <typename T, typename TX>
struct ApplyArgs : EllArgs<T, TX> {
  TX* xw;                // X itself, written: the applied rows
  const int32_t* negs;   // [groups, ns] sample ids, rows of xg
  const TX* upd;         // [rows, dim] the applied rows' attraction, or null
  T* xg_next;            // [n_pad, dim] the next replica, written, or null
  uint64_t apply_mask;   // bit k: entry k applies (else stores into out)
  int group;             // rows a set of negatives serves
  int ns;                // samples a set
};

// One launch over the work table in p, for gather type T and X type TX:
// defined, with its kernels, in the objects the build compiles for the
// pairs of F2V_APPLY_PAIRS (-DF2V_GATHER, -DF2V_X).
template <typename T, typename TX>
cudaError_t apply_launch(ApplyArgs<T, TX>& p, const int64_t* table,
                         int n_entries, int model, cudaStream_t s);

#ifdef F2V_X
namespace {

// A word loaded again where the epilogue uses it (an L1 hit), so that it
// is not held in a register over the slot loop: the edge kernel's loop
// fills the 96 registers of 5 blocks an SM, and the row's X index and the
// step held over it spilled.
__device__ __forceinline__ int reload(const int32_t* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float reload(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// ell_block's epilogue: the row's repulsion, summed by the same gather
// loop over its ns sample ids, then X's update in place; a storing entry's
// rows store their sums.
template <int MRep>
struct ApplyRep {
  template <typename T, typename TX, class RC, class A>
  __device__ static __forceinline__ void finish(
      const A& p, const EllEntry& e, int r, bool live, int gl, int64_t dim,
      const bool (&has)[RC::P], const float (&xi)[RC::P][RC::E],
      const float (&att)[RC::P][RC::E]) {
    constexpr int G = RC::G, P = RC::P, E = RC::E;
    if (!((p.apply_mask >> (&e - p.e)) & 1u)) {  // the whole block alike
      if (live) {
        TX* o = p.out + (e.out_begin + r) * dim;
#pragma unroll
        for (int c = 0; c < P; ++c) {
          if (has[c]) store_x<TX, E>(o + (c * G + gl) * E, att[c]);
        }
      }
      return;
    }
    const int i = live ? reload(p.xi_row + e.row_begin + r) : 0;
    const float step = reload(p.step);
    const int n = live ? p.ns : 0;
    const int32_t* ids = p.negs + int64_t(i / p.group) * p.ns;
    float rep[P][E];
#pragma unroll
    for (int c = 0; c < P; ++c) {
#pragma unroll
      for (int v = 0; v < E; ++v) rep[c][v] = 0.0f;
    }
    // up to 4 sample rows in flight a group, so that they and the row's
    // attraction and repulsion sums fit the edge kernel's registers (96
    // at one piece a lane, 5 blocks an SM): holding 8, the rows that fill
    // 16 or 32 lanes spilled up to 64 bytes and the launch took 5% longer
    // (2.173 ms against 2.075 at 1,048,576 vertices, an H100); at 4
    // blocks an SM, 8 rows took the launch to the edge launch and `apply`
    // apart.  Prefetching a row's samples into the L1 before its slot
    // loop made it 7% slower.
    ell_rounds<T, RC, SampleForce<MRep>, kCompute, (RC::U > 4 ? 4 : RC::U)>(
        p, ids, 0, n, p.ns, p.ns, live, e, gl, dim, has, xi, 0.0f, step,
        rep);
    if (!live) return;
    TX* xo = p.xw + int64_t(i) * dim;
    T* xn = p.xg_next == nullptr ? nullptr : p.xg_next + int64_t(i) * dim;
    const TX* u = p.upd == nullptr ? nullptr : p.upd + (e.out_begin + r) * dim;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      if (!has[c]) continue;
      float a[E];
      if (u != nullptr) {
        load_row<TX, E>(u + (c * G + gl) * E, a);
      } else {
#pragma unroll
        for (int v = 0; v < E; ++v) a[v] = round_to<TX>(att[c][v]);
      }
      float o[E];
#pragma unroll
      for (int v = 0; v < E; ++v) {
        o[v] = __fadd_rn(xi[c][v], round_to<TX>(__fadd_rn(
                                       a[v], round_to<TX>(rep[c][v]))));
      }
      store_x<TX, E>(xo + (c * G + gl) * E, o);
      // the row's piece in the replica's type: one 16-byte store
      if (xn != nullptr) store_x<T, E>(xn + (c * G + gl) * E, o);
    }
  }
};

// The edge kernel's blocks an SM, but for the table sigma's rows that fill
// 32 lanes of one piece (dim 256 with a 2-byte replica), whose table
// pointer held over both loops spilled 8 bytes at 5 (96 registers): 4.
template <class RC, int M>
constexpr int apply_min_blocks() {
  return M == kSigmoidTable && RC::P == 1 && RC::G == 32 ? 4
                                                          : RC::kMinBlocks;
}

template <typename T, typename TX, int G, int P, bool kFull, int M, int MRep>
__global__ void __launch_bounds__(
    kEllThreads, apply_min_blocks<RowClass<T, G, P, kFull>, M>())
    ell_edge_apply_kernel(const __grid_constant__ ApplyArgs<T, TX> p) {
  ell_block<T, TX, RowClass<T, G, P, kFull>, EdgeForce<M>, kCompute,
            ApplyRep<MRep>>(p);
}

template <typename T, typename TX, int G, int P, bool kFull>
cudaError_t launch(ApplyArgs<T, TX>& p, const int64_t* table, int n_entries,
                   int model, cudaStream_t s) {
  const int64_t blocks =
      ell_plan<RowClass<T, G, P, kFull>>(p, table, n_entries);
  if (blocks < 0) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(blocks));
  auto go = [&](auto kernel) {
    kernel<<<grid, kEllThreads, 0, s>>>(p);
    return cudaGetLastError();
  };
  // the models with an add update and a CSR attraction, each edge force
  // with its own sample force
  switch (model) {
    case kTdist:
      return go(ell_edge_apply_kernel<T, TX, G, P, kFull, kTdist, kTdistRep>);
    case kSigmoid:
      return go(
          ell_edge_apply_kernel<T, TX, G, P, kFull, kSigmoid, kSigmoidRep>);
    case kSigmoidTable:
      if (p.sm_table == nullptr) return cudaErrorInvalidValue;
      return go(ell_edge_apply_kernel<T, TX, G, P, kFull, kSigmoidTable,
                                      kSigmoidTableRep>);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

template <typename T, typename TX>
cudaError_t apply_launch(ApplyArgs<T, TX>& p, const int64_t* table,
                         int n_entries, int model, cudaStream_t s) {
  return with_row_class<T>(p.dim, [&](auto rc) {
    using RC = decltype(rc);
    return launch<T, TX, RC::G, RC::P, RC::kFull>(p, table, n_entries, model,
                                                  s);
  });
}

template cudaError_t apply_launch(
    ApplyArgs<TypeOf<F2V_GATHER>, TypeOf<F2V_X>>&, const int64_t*, int, int,
    cudaStream_t);
#endif  // F2V_X

}  // namespace f2v

#ifndef F2V_X
// table: [n_entries, 5] int64 in host memory (row_begin, nbr_begin,
// out_begin, rows, width), in launch order; apply_mask: bit k set where
// entry k applies (its rows' X updated in place, upd's rows out_begin + r
// read as their attraction when upd is not null), else entry k stores its
// rows' attraction into out's rows out_begin + r.  negs: [groups, ns]
// int32 sample ids, rows of xg, row i taking set i / group.  model: the
// edge model (EdgeModel: tdist, sigmoid or sigmoid with the table), whose
// sample force is its own.  xg_dtype, x_dtype: a pair of
// F2V_APPLY_PAIRS; x must not be xg.  xg_next: null, or a [n_pad, dim]
// buffer of xg's type, neither x nor xg, into which each applied row
// writes its new X rounded to that type.  step: a device f32 scalar, read by
// the kernel (a captured launch reads each replay's).
extern "C" int f2v_ell_edge_apply(const void* x, const void* xg,
                                  int xg_dtype, int x_dtype,
                                  const void* nbr, const void* deg,
                                  const void* xi_row, const void* invd,
                                  const void* sm_table, const void* step,
                                  void* out, const void* negs,
                                  const void* upd, void* xg_next,
                                  unsigned long long apply_mask, int group,
                                  int ns, const void* table, int n_entries,
                                  int dim, int model, void* stream) {
  if (step == nullptr || negs == nullptr || group <= 0 || ns <= 0 ||
      x == xg || xg_next == x || xg_next == xg) {
    return cudaErrorInvalidValue;
  }
  auto go = [&](auto types) {
    using T = typename decltype(types)::T;
    using TX = typename decltype(types)::TX;
    f2v::ApplyArgs<T, TX> p{};
    p.x = static_cast<const TX*>(x);
    p.xw = static_cast<TX*>(const_cast<void*>(x));
    p.xg = static_cast<const T*>(xg);
    p.nbr = static_cast<const int32_t*>(nbr);
    p.deg = static_cast<const int32_t*>(deg);
    p.xi_row = static_cast<const int32_t*>(xi_row);
    p.invd = static_cast<const TX*>(invd);
    p.sm_table = static_cast<const float*>(sm_table);
    p.out = static_cast<TX*>(out);
    p.step = static_cast<const float*>(step);
    p.dim = dim;
    p.negs = static_cast<const int32_t*>(negs);
    p.upd = static_cast<const TX*>(upd);
    p.xg_next = static_cast<T*>(xg_next);
    p.apply_mask = apply_mask;
    p.group = group;
    p.ns = ns;
    return f2v::apply_launch<T, TX>(p, static_cast<const int64_t*>(table),
                                    n_entries, model,
                                    static_cast<cudaStream_t>(stream));
  };
#define F2V_CALL_PAIR(G, X)                                                 \
  if (xg_dtype == (G) && x_dtype == (X)) {                                  \
    return go(f2v::Types<f2v::TypeOf<G>, f2v::TypeOf<X>>{});                \
  }
  F2V_APPLY_PAIRS(F2V_CALL_PAIR)
#undef F2V_CALL_PAIR
  return cudaErrorInvalidValue;
}
#endif  // !F2V_X
