// Helpers shared by the force kernels: row loads and stores, lane-group
// sums, the force models, and the ELL gather engine (ell_block) that
// ell_edge_force.cu, ell_sample_force.cu, tp_pair_force.cu and
// ell_edge_apply.cu all run.
//
// A group of G lanes holds one embedding row of D elements, D a runtime
// argument, a multiple of 8 up to kMaxDim (the trainers hold X at the dim
// rounded up to 8, the padding columns 0): the row is cut into 16-byte
// pieces (8 bf16 or f16, or 4 f32 elements), and piece q lies with lane
// q % G of the group, as that lane's piece q / G, so that each round of a
// group's loads reads contiguous bytes.  A row class (RowClass: G lanes, P pieces
// a lane) covers up to G·P pieces; the kernels are instantiated for a few
// classes and the host picks the narrowest that holds the row
// (with_row_class).  Row bases must be 16-byte aligned (the Python wrappers
// check it).
//
// X (the rows x_i are read from, with invd) and a force's output are in
// X's element type TX: float, __nv_bfloat16 or __half.  A bf16 or f16 X
// gathers from itself, so only gathers of its own type pair with it; an
// f32 X gathers from a replica of any of the three (with_dtypes).  Every
// sum and force stays in f32; a bf16 or f16 output is rounded once, at
// the store (the JAX package's MXU kernel: f32 accumulation, cast to
// xi.dtype); an f16 one past 65,504 rounds to ±inf, as the JAX cast does.
// No flag of the build flushes f16 subnormals (_build.NVCC_FLAGS).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace f2v {

constexpr unsigned kFullMask = 0xffffffffu;
// The embedding width of the benchmark probes, which reproduce fixed TPU
// probe shapes (probe_kernels._KERNEL_DIM).  The force kernels take their
// width D at run time, up to kMaxDim (force_kernels.KERNEL_MAX_DIM).
constexpr int kDim = 128;
constexpr int kMaxDim = 1024;
constexpr int kRowAlign = 8;  // D is a multiple of it (force_kernels.ROW_ALIGN)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// v in T, rounded to nearest even (an f16 past its range: ±inf).
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else if constexpr (std::is_same_v<T, __half>) {
    return __float2half_rn(v);
  } else {
    return __float2bfloat16_rn(v);
  }
}

// v rounded to T, as f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The element types' codes in the C entry points' dtype arguments
// (force_kernels._DTYPE_CODES), and the type of each.
enum DType { kF32 = 0, kBf16 = 1, kF16 = 2 };
template <int kCode>
struct CodeType {
  using type = float;
};
template <>
struct CodeType<kBf16> {
  using type = __nv_bfloat16;
};
template <>
struct CodeType<kF16> {
  using type = __half;
};
template <int kCode>
using TypeOf = typename CodeType<kCode>::type;

// A (gather, X) element type pair, as a tag.
template <typename T_, typename TX_>
struct Types {
  using T = T_;
  using TX = TX_;
};

// The (gather, X) pairs the kernels take, as DType codes: an f32 X with a
// replica of any type, a bf16 or f16 X with its own type (X is its own
// gather table).  The one list of them: with_dtypes dispatches on it, the
// build (_build.dtype_pairs) reads it to compile each pair's kernels in an
// object of its own (-DF2V_GATHER and -DF2V_X name the pair), so that no
// nvcc job holds more than one pair's instances, and the wrappers
// (force_kernels._check_x) refuse any other pair by name.
#define F2V_DTYPE_PAIRS(PAIR) PAIR(0, 0) PAIR(1, 0) PAIR(2, 0) PAIR(1, 1) PAIR(2, 2)

// The pairs of the fused attraction-repulsion-apply launch
// (ell_edge_apply.cu): an f32 X beside a bf16 or f16 replica, the one case
// in which the replica is a buffer of its own, so that the launch may
// write X while its rows gather from the replica.  The build
// (_build.splits) compiles ell_edge_apply.cu for these pairs alone.
#define F2V_APPLY_PAIRS(PAIR) PAIR(1, 0) PAIR(2, 0)

// Calls fn(Types<T, TX>{}) for a gather table of code `xg` beside an X of
// code `x`, a pair of F2V_DTYPE_PAIRS; cudaErrorInvalidValue for any other.
template <class Fn>
cudaError_t with_dtypes(int xg, int x, Fn&& fn) {
#define F2V_CALL_PAIR(G, X) \
  if (xg == (G) && x == (X)) return fn(Types<TypeOf<G>, TypeOf<X>>{});
  F2V_DTYPE_PAIRS(F2V_CALL_PAIR)
#undef F2V_CALL_PAIR
  return cudaErrorInvalidValue;
}

__host__ __device__ constexpr int pack_align(int bytes) {
  return bytes < 16 ? bytes : 16;
}

template <typename T, int V>
struct alignas(pack_align(sizeof(T) * V)) Pack {
  T v[V];
};

// Load V contiguous elements at p as floats.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(pk.v[i]);
}

template <int V>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&v)[V]) {
  Pack<float, V> pk;
#pragma unroll
  for (int i = 0; i < V; ++i) pk.v[i] = v[i];
  *reinterpret_cast<Pack<float, V>*>(p) = pk;
}

// Store V f32 values at p in X's type TX, each rounded once.
template <typename TX, int V>
__device__ __forceinline__ void store_x(TX* __restrict__ p,
                                        const float (&v)[V]) {
  if constexpr (std::is_same_v<TX, float>) {
    store_row<V>(p, v);
  } else {
    Pack<TX, V> pk;
#pragma unroll
    for (int i = 0; i < V; ++i) pk.v[i] = from_f32<TX>(v[i]);
    *reinterpret_cast<Pack<TX, V>*>(p) = pk;
  }
}

// Store v at p in TX, or with `accumulate` store p + v: v rounded to TX
// (the value a store would write), added to p's value in f32 and rounded
// once more, the add a separate `out.add_(v)` of the stored v would make.
template <typename TX, int V>
__device__ __forceinline__ void store_or_add(TX* __restrict__ p,
                                             const float (&v)[V],
                                             bool accumulate) {
  if (!accumulate) {
    store_x<TX, V>(p, v);
    return;
  }
  float s[V];
  load_row<TX, V>(p, s);
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = __fadd_rn(s[i], round_to<TX>(v[i]));
  store_x<TX, V>(p, s);
}

// Butterfly sum over aligned groups of G lanes: every lane of a group ends
// with the same bits (IEEE addition is commutative, and each step adds the
// same two partials on both lanes).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// A row class: a row of up to G·P 16-byte pieces held by G lanes, P pieces
// a lane, E elements a piece.  kFull: the row fills the class exactly (D =
// G·P·E, a compile-time constant, every lane holding P pieces); else D is
// the kernel's runtime argument and a lane's pieces past the row's end are
// not loaded and count as 0.  U is how many neighbour rows a group has in
// flight (8 pieces, 128 bytes, a lane); kMinBlocks the blocks per SM its
// register budget is set for (ell_block keeps 2·P·E f32 of x_i and the sum
// and U·P pieces a lane in registers: the wide classes get more of them).
template <typename T, int G_, int P_, bool kFull_>
struct RowClass {
  static constexpr int G = G_;
  static constexpr int P = P_;
  static constexpr bool kFull = kFull_;
  static constexpr int E = 16 / int(sizeof(T));
  static constexpr int D = G * P * E;  // the row's elements when kFull
  static constexpr int U = P == 1 ? (G < 8 ? G : 8) : 8 / P;
  static constexpr int kMinBlocks = P == 1 ? 5 : P == 2 ? 4 : 3;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of 2");
  static_assert(P == 1 || G == 32, "pieces past one a lane fill whole warps");
  static_assert(G % U == 0, "a group's ids must cover whole rounds");
};

// Calls fn(RowClass<T, G, P, kFull>{}) for the narrowest class that holds a
// row of `dim` elements (a multiple of kRowAlign in [kRowAlign, kMaxDim]),
// kFull when the row fills it; returns cudaErrorInvalidValue for any other
// dim.  The classes: G = 1 (2-byte types only: one piece), 2, 4, 8, 16, 32
// lanes of one piece, then 32 lanes of 2, 4 and (f32 only: 1024 f32 are
// 256 pieces) 8.  Dims 64 and 128 fill 8 and 16 lanes of bf16 or f16, 16
// and 32 of f32: they run with D fixed at compile time, as the kernels did
// before they took other widths.  A class no row can fill in part (2-byte
// pieces are any count, f32 pieces an even one) has no runtime-D
// instance.
template <typename T, int G, int P, class Fn>
cudaError_t with_class(int pieces, Fn&& fn) {
  if (pieces == G * P) return fn(RowClass<T, G, P, true>{});
  constexpr int kLeast = sizeof(T) == 2 ? 1 : 2;  // a partial row's pieces
  if constexpr (G * P / 2 + kLeast < G * P) {
    return fn(RowClass<T, G, P, false>{});
  }
  return cudaErrorInvalidValue;
}

template <typename T, class Fn>
cudaError_t with_row_class(int dim, Fn&& fn) {
  if (dim < kRowAlign || dim > kMaxDim || dim % kRowAlign != 0) {
    return cudaErrorInvalidValue;
  }
  const int pieces = dim * int(sizeof(T)) / 16;
  if constexpr (sizeof(T) == 2) {
    if (pieces <= 1) return with_class<T, 1, 1>(pieces, fn);
  }
  if (pieces <= 2) return with_class<T, 2, 1>(pieces, fn);
  if (pieces <= 4) return with_class<T, 4, 1>(pieces, fn);
  if (pieces <= 8) return with_class<T, 8, 1>(pieces, fn);
  if (pieces <= 16) return with_class<T, 16, 1>(pieces, fn);
  if (pieces <= 32) return with_class<T, 32, 1>(pieces, fn);
  if (pieces <= 64) return with_class<T, 32, 2>(pieces, fn);
  if (pieces <= 128) return with_class<T, 32, 4>(pieces, fn);
  if constexpr (sizeof(T) == 4) {
    if (pieces <= 256) return with_class<T, 32, 8>(pieces, fn);
  }
  return cudaErrorInvalidValue;
}

// The force models divide with __fdividef (at most 2 ulp): every divisor is
// ≥ 1 or a positive squared distance, far from its 2^126 limit, and the
// precise division's slow path gave the kernels a stack frame and spills.
// The sigmoid keeps the precise division: sigmoid's 1 - sigmoid(a) cancels
// where sigmoid(a) is near 1, and 2 ulp there moved whole terms by more
// than the plain version's own rounding.
__device__ __forceinline__ float sigmoidf(float a) {
  return 1.0f / (1.0f + expf(-a));
}

// The reference's lookup-table sigmoid (fast_SM, sample/algorithms.cpp:
// 765-770), as models/forces.py::table_sigmoid computes it: entry
// int((v + 6) * 2048/12) of the float32 table that models/forces.py::
// make_sm_table builds (passed in, never recomputed here), 1 above 6 and 0
// below -6.  The sum and the product round separately, as torch's two
// float32 operations do: a fused multiply-add could move an index across a
// bin edge.
constexpr int kSmTableSize = 2048;                // SM_TABLE_SIZE
constexpr float kSmBound = 6.0f;                  // SM_BOUND
constexpr float kSmResolution = 2048.0f / 12.0f;  // SM_RESOLUTION in f32
__device__ __forceinline__ float table_sigmoid(float v,
                                               const float* __restrict__ tbl) {
  if (v > kSmBound) return 1.0f;
  if (v < -kSmBound) return 0.0f;
  const int idx = int(__fmul_rn(__fadd_rn(v, kSmBound), kSmResolution));
  return __ldg(tbl + min(max(idx, 0), kSmTableSize - 1));
}

// -- the force models -----------------------------------------------------------
//
// Every force is one scalar per pair times one vector, elementwise:
//   a = sum_d vec_d^2 (or xi . xj when kDot), c = coeff(a, invd, step, tbl),
//   force_d = term(c, vec_d, step).  tbl is the sigmoid table; only the
// table models read it.

// Model ids of the edge (attraction) forces, shared with force_kernels.py
// (_EDGE_MODEL_IDS); models/forces.py::_<model>_coeff.
// kSigmoidTable is sigmoid with the table's σ (_sigmoid_table_coeff).
enum EdgeModel { kTdist = 0, kSigmoid = 1, kFr = 2, kLinlog = 3,
                 kForceatlas = 4, kSigmoidTable = 5 };

template <int M>
struct EdgeForce {
  static constexpr bool kDot = M == kSigmoid || M == kSigmoidTable;
  static constexpr bool kUsesInvd = kDot;
  __device__ static __forceinline__ float vec(float xi, float xj) {
    if constexpr (M == kTdist) return xi - xj;
    else if constexpr (kDot) return xj;
    else return xj - xi;
  }
  __device__ static __forceinline__ float coeff(float a, float invd,
                                                float step,
                                                const float* tbl) {
    if constexpr (M == kTdist) {
      return __fdividef(step * -2.0f, 1.0f + a);
    } else if constexpr (M == kSigmoid) {
      return step * invd * (1.0f - sigmoidf(a));
    } else if constexpr (M == kSigmoidTable) {
      return step * invd * (1.0f - table_sigmoid(a, tbl));
    } else if constexpr (M == kFr) {
      return a > 0.0f ? a + __fdividef(1.0f, a) : 0.0f;
    } else if constexpr (M == kLinlog) {
      return log2f(1.0f + sqrtf(fmaxf(a, 0.0f)));
    } else {
      return a > 0.0f ? sqrtf(a) + __fdividef(1.0f, a) : 0.0f;
    }
  }
  __device__ static __forceinline__ float term(float c, float v, float) {
    return c * v;
  }
};

// Model ids of the sample (repulsion) forces, shared with force_kernels.py
// (_SAMPLE_MODEL_IDS); models/forces.py::_<model>_rep.
// kSigmoidTableRep is sigmoid with the table's σ (_sigmoid_table_rep).
enum SampleModel { kTdistRep = 0, kSigmoidRep = 1, kLayoutRep = 2,
                   kSigmoidTableRep = 3 };
constexpr float kMaxBound = 5.0f;  // models/forces.py::MAXBOUND

template <int M>
struct SampleForce {
  static constexpr bool kDot = M == kSigmoidRep || M == kSigmoidTableRep;
  static constexpr bool kUsesInvd = false;
  __device__ static __forceinline__ float vec(float xi, float s) {
    if constexpr (M == kTdistRep) return xi - s;
    else if constexpr (kDot) return s;
    else return s - xi;
  }
  __device__ static __forceinline__ float coeff(float a, float, float step,
                                                const float* tbl) {
    if constexpr (M == kTdistRep) {
      // 2 / (r (1 + r)), zero at r = 0
      return a > 0.0f ? __fdividef(2.0f, a * (1.0f + a)) : 0.0f;
    } else if constexpr (M == kSigmoidRep) {
      return -step * sigmoidf(a);
    } else if constexpr (M == kSigmoidTableRep) {
      return -step * table_sigmoid(a, tbl);
    } else {
      return -(a > 0.0f ? __fdividef(1.0f, a) : 0.0f);
    }
  }
  __device__ static __forceinline__ float term(float c, float v, float step) {
    if constexpr (M == kTdistRep) {
      return step * fminf(fmaxf(c * v, -kMaxBound), kMaxBound);
    } else {
      return c * v;
    }
  }
};

// The pair scalar alone, for tp_pair_partial: x_i . xg_j (kDot), else
// |x_i - xg_j|^2.  Only pair_part reads it.
template <bool kDot_>
struct PairScalar {
  static constexpr bool kDot = kDot_;
  static constexpr bool kUsesInvd = false;
  __device__ static __forceinline__ float vec(float xi, float xj) {
    return xi - xj;
  }
};

// One lane's share of a pair's scalar a (its V elements of the row).
template <class F, int V>
__device__ __forceinline__ float pair_part(const float (&xi)[V],
                                           const float (&xj)[V]) {
  float part = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float d = F::kDot ? xj[v] : F::vec(xi[v], xj[v]);
    part += (F::kDot ? xi[v] : d) * d;
  }
  return part;
}

// -- the ELL gather engine ---------------------------------------------------------
//
// A work table is a list of entries, each a block of `rows` rows with
// `width` id slots per row.  Row r of an entry computes
//   out[out_begin + r] = sum_{k < deg[row_begin + r]} force(x[i], xg[j_k])
//   with i = xi_row[row_begin + r], j_k = nbr[nbr_begin + r * width + k],
// x_i from X (f32, bf16 or f16, read as f32) and the neighbour rows from
// the gather replica xg (f32, bf16 or f16), which is X itself when X is
// bf16 or f16.  One launch covers the whole table: each entry owns a run
// of consecutive blocks, in table order, so the caller's order (widest
// first) is the order in which rows start.
//
// A group of G lanes owns a row (RowClass): at dim 128, two rows per warp
// with a bf16 replica, whose rows are 16 lanes of 16-byte loads, so that
// one warp load instruction fetches two neighbour rows; one with f32 (dim
// 64: four and two; dim 32 bf16: eight rows of 4 lanes; dim 512 bf16: one
// row, 2 pieces a lane).  Per row, one coalesced load brings up to G ids to
// the group's lanes; U neighbour rows per group (8 for one piece a lane, 16
// per bf16 warp at dim 128) are loaded before any is used; the pairs'
// scalars are group sums over G lanes (4 shuffle steps for bf16 at dim
// 128), issued for all of them together so that they do not wait behind
// one another; then the updates, in slot order.  A lane's pieces past the
// row's end are not loaded and count as 0.  (A whole warp per wide row,
// its two groups taking alternate slots, was tried on an H100 and was no
// faster on the bench layout; its code cost registers.)
//
// A scalar policy (ScalarMode) says where each pair's a comes from and what
// becomes of it, so that the split-dim kernels (tp_pair_force.cu) run on
// the same engine:
//   kCompute: a from the row's whole width, then the force (the fused
//             kernels);
//   kStore:   a from these columns alone, stored per slot, part[s] (0 in
//             the padded slots k >= deg), and no force: lane l of a group
//             keeps the scalar of the round's slot l and the group stores
//             its G slots with one coalesced store a round;
//   kLoad:    a read per slot, p.a[s] (G scalars a round, with the round's
//             G ids), then the force; no dot product.
enum ScalarMode { kCompute = 0, kStore = 1, kLoad = 2 };

constexpr int kEllWarps = 4;  // warps per block
constexpr int kEllThreads = kEllWarps * 32;
constexpr int kMaxEntries = 64;  // force_kernels._MAX_ENTRIES
// RowClass::U and kMinBlocks: 8 pieces in flight a lane, 4 KB a warp (16
// bf16 rows or 8 f32 rows at dim 128; 16 f32 rows spill at this register
// budget); 5 blocks of 4 warps an SM leave 96 registers a thread, where no
// one-piece instance spills (3 of 8 warps, 80 registers, spilled and ran
// slower on an H100).

struct EllEntry {
  int64_t row_begin;  // first row of deg and xi_row
  int64_t nbr_begin;  // first slot of nbr
  int64_t out_begin;  // first output row
  int rows;
  int width;
  int block_begin;  // first block of the launch
};

// T: the gather table's element type; TX: X's (x, invd and out): float
// with any T, or bf16 or f16 with the same T (with_dtypes).
template <typename T, typename TX>
struct EllArgs {
  const TX* x;            // [n_pad, dim]
  const T* xg;            // [n_pad, dim] gather replica
  const int32_t* nbr;     // every entry's [rows, width] ids, flat
  const int32_t* deg;     // [rows] valid slots per row
  const int32_t* xi_row;  // [rows] table row whose x (and invd) a row uses
  const TX* invd;         // [n_pad] 1 / (deg + 1); read only by sigmoid
  const float* sm_table;  // [2048] sigmoid table; read only by table models
  TX* out;                // [out rows, dim]
  const float* a;         // [slots] pair scalars, read by kLoad
  float* part;            // [slots] pair scalars, written by kStore
  // the step, a device scalar, so that a captured launch reads the value
  // of each replay; not read by kStore
  const float* step;
  int dim;                // elements a row: a multiple of kRowAlign
  int accumulate;         // store out + sum instead of sum
  int n_entries;
  EllEntry e[kMaxEntries];
};

// Fill p's entries from the host's [n, 5] int64 table (row_begin,
// nbr_begin, out_begin, rows, width), for row class RC.  Returns the number
// of blocks the launch needs, or -1 for a malformed table.
template <class RC, class A>
inline int64_t ell_plan(A& p, const int64_t* table, int n) {
  if (n < 1 || n > kMaxEntries) return -1;
  constexpr int64_t kRowsPerBlock = kEllWarps * (32 / RC::G);
  int64_t blocks = 0;
  for (int k = 0; k < n; ++k) {
    const int64_t* q = table + 5 * k;
    if (q[0] < 0 || q[1] < 0 || q[2] < 0 || q[3] < 0 ||
        q[3] > INT_MAX - kRowsPerBlock || q[4] < 0 || q[4] > INT_MAX) {
      return -1;
    }
    p.e[k] = EllEntry{q[0], q[1], q[2], int(q[3]), int(q[4]), int(blocks)};
    blocks += (q[3] + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > INT_MAX) return -1;
  }
  p.n_entries = n;
  return blocks;
}

// The entry that owns this block: the last whose block_begin ≤ blockIdx.x
// (of EllArgs' entries, or any argument block with n_entries and e).
template <class A>
__device__ __forceinline__ const EllEntry& ell_entry(const A& p) {
  int k = 0;
  while (k + 1 < p.n_entries && int(blockIdx.x) >= p.e[k + 1].block_begin) ++k;
  return p.e[k];
}

// Element v of a lane's 16 loaded bytes as f32.  The bytes stay a uint4:
// loaded into a bf16 array, the in-flight rows' elements went through local
// memory (a stack frame and spills); as words they stay in registers, and
// the compiler converts them where they are used (a bf16 by a shift, an
// f16 by a conversion instruction).
template <typename T>
__device__ __forceinline__ float piece_f32(const uint4& q, int v) {
  const int k = sizeof(T) == 2 ? v / 2 : v;
  const uint32_t w = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else if constexpr (std::is_same_v<T, __half>) {
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>(v % 2 == 0 ? w : w >> 16)));
  } else {
    return __uint_as_float(v % 2 == 0 ? w << 16 : w & 0xffff0000u);
  }
}

// ell_block's slot loop: force F of each of one row's slots [0, n) (ids
// at `ids`, the row's first slot s0 of entry e's table), summed into acc
// in slot order, each pair's scalar as Mode says, U rows in flight a
// group (RowClass::U unless a caller holds fewer).  The warp's lanes run
// its longest row's n_max slots together (rounds_end: kStore covers the
// whole width).  A lane's pieces past the row's end are not loaded and
// count as 0.
template <typename T, class RC, class F, int Mode, int U = RC::U, class A>
__device__ __forceinline__ void ell_rounds(
    const A& p, const int32_t* ids, int64_t s0, int n, int n_max,
    int rounds_end, bool live, const EllEntry& e, int gl, int64_t dim,
    const bool (&has)[RC::P], const float (&xi)[RC::P][RC::E], float invd_i,
    float step, float (&acc)[RC::P][RC::E]) {
  constexpr int G = RC::G, P = RC::P, E = RC::E;
  static_assert(G % U == 0, "a group's ids must cover whole rounds");
  constexpr bool kStores = Mode == kStore;
  for (int i0 = 0; i0 < rounds_end; i0 += G) {
    const int my_j = i0 + gl < n ? ids[i0 + gl] : 0;
    // kLoad: the scalar of this lane's slot; kStore: the one it stores
    float my_a = 0.0f;
    if (Mode == kLoad && i0 + gl < n) my_a = p.a[s0 + i0 + gl];
    const int cnt = min(G, n_max - i0);
    for (int k = 0; k < cnt; k += U) {
      uint4 xj[U][P];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t j = __shfl_sync(kFullMask, my_j, k + u, G);
        if (i0 + k + u < n) {
#pragma unroll
          for (int c = 0; c < P; ++c) {
            // a piece past the row's end counts as 0
            xj[u][c] = has[c] ? *reinterpret_cast<const uint4*>(
                                    p.xg + j * dim + (c * G + gl) * E)
                              : make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
      float a[U];  // the pairs' scalars (kLoad takes each as it uses it)
      if constexpr (Mode != kLoad) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          a[u] = 0.0f;
          if (i0 + k + u < n) {
#pragma unroll
            for (int c = 0; c < P; ++c) {
              float f[E];
#pragma unroll
              for (int v = 0; v < E; ++v) f[v] = piece_f32<T>(xj[u][c], v);
              const float part = pair_part<F, E>(xi[c], f);
              a[u] = c == 0 ? part : a[u] + part;
            }
          }
        }
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            a[u] += __shfl_xor_sync(kFullMask, a[u], o);
          }
        }
      }
      if constexpr (kStores) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (gl == k + u) my_a = a[u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // kLoad: slot k + u's scalar from the lane that read it
          const float au = Mode == kLoad
                               ? __shfl_sync(kFullMask, my_a, k + u, G)
                               : a[u];
          if (i0 + k + u < n) {
            const float cf = F::coeff(au, invd_i, step, p.sm_table);
#pragma unroll
            for (int c = 0; c < P; ++c) {
#pragma unroll
              for (int v = 0; v < E; ++v) {
                acc[c][v] += F::term(
                    cf, F::vec(xi[c][v], piece_f32<T>(xj[u][c], v)), step);
              }
            }
          }
        }
      }
    }
    if (kStores && live && i0 + gl < e.width) p.part[s0 + i0 + gl] = my_a;
  }
}

// ell_block's epilogue where a kernel sums one force: each row's sum
// stored in out (or, with p.accumulate, added into it).  Another epilogue
// (Epi) takes the row over after its slot loop instead:
//   Epi::finish<T, TX, RC>(p, e, r, live, gl, dim, has, xi, acc)
// with the entry e, the row r of it (live: a row of the entry), and x_i
// and the row's f32 sum as a lane holds them (ell_edge_apply.cu: the
// repulsion and X's update).
struct StoreSum {};

// The body of the ELL kernels: this block's entry, one row of RC::D
// (kFull) or p.dim elements per group of RC::G lanes, each pair's scalar
// as Mode says, then the epilogue Epi.  A is EllArgs<T, TX> or an argument
// block that extends it.
template <typename T, typename TX, class RC, class F, int Mode = kCompute,
          class Epi = StoreSum, class A>
__device__ __forceinline__ void ell_block(const A& p) {
  constexpr int G = RC::G, P = RC::P, E = RC::E;
  constexpr bool kStores = Mode == kStore;
  constexpr int NG = 32 / G;  // rows per warp
  const EllEntry& e = ell_entry(p);
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  // 32-bit row numbers: ell_plan keeps rows + the last warp's below 2^31
  const int warp_row =
      ((int(blockIdx.x) - e.block_begin) * kEllWarps + (threadIdx.x >> 5)) *
      NG;
  if (warp_row >= e.rows) return;  // whole warp leaves together
  const int r = warp_row + lane / G;
  const bool live = r < e.rows;
  const int n = live ? p.deg[e.row_begin + r] : 0;
  const int64_t dim = RC::kFull ? RC::D : p.dim;
  bool has[P];  // a lane's piece c is the row's piece c·G + gl
#pragma unroll
  for (int c = 0; c < P; ++c) has[c] = RC::kFull || c * G + gl < dim / E;
  float xi[P][E];
  float invd_i = 0.0f;
  const int64_t i = live ? p.xi_row[e.row_begin + r] : 0;
#pragma unroll
  for (int c = 0; c < P; ++c) {
    if (live && has[c]) {
      load_row<TX, E>(p.x + i * dim + (c * G + gl) * E, xi[c]);
    } else {
#pragma unroll
      for (int v = 0; v < E; ++v) xi[c][v] = 0.0f;
    }
  }
  if (F::kUsesInvd && live) invd_i = to_f32(p.invd[i]);
  const int64_t s0 = e.nbr_begin + int64_t(r) * e.width;  // the row's slots
  const int32_t* ids = p.nbr + s0;
  int n_max = n;  // the warp's loops run to its longest row
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
    n_max = max(n_max, __shfl_xor_sync(kFullMask, n_max, o));
  }
  float acc[P][E];
#pragma unroll
  for (int c = 0; c < P; ++c) {
#pragma unroll
    for (int v = 0; v < E; ++v) acc[c][v] = 0.0f;
  }

  // the step: one load a thread, the same word for the whole block
  float step = 0.0f;
  if constexpr (!kStores) step = __ldg(p.step);

  // kStore's rounds cover the whole width, the padded slots' 0s included
  const int rounds_end = kStores ? e.width : n_max;
  ell_rounds<T, RC, F, Mode>(p, ids, s0, n, n_max, rounds_end, live, e,
                             gl, dim, has, xi, invd_i, step, acc);
  if constexpr (std::is_same_v<Epi, StoreSum>) {
    if (!kStores && live) {
      TX* o = p.out + (e.out_begin + r) * dim;
#pragma unroll
      for (int c = 0; c < P; ++c) {
        if (has[c]) {
          store_or_add<TX, E>(o + (c * G + gl) * E, acc[c], p.accumulate);
        }
      }
    }
  } else {
    Epi::template finish<T, TX, RC>(p, e, r, live, gl, dim, has, xi, acc);
  }
}

// -- asynchronous copies into shared memory ---------------------------------------
//
// The rings of take_sum.cu and tile_force_tc.cu: copies that land in shared
// memory without holding registers, each stage's completion counted by an
// mbarrier (arrivals and, for bulk copies, bytes).  A wait names the parity
// of the phase it waits for: a stage's n-th fill completes phase n, so the
// n-th wait on it passes parity n & 1.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises; then fence and __syncthreads before any use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive, and raise the bytes the phase waits for by `bytes`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed.  A ring that never
// fills is a fault: after ~2^34 clock cycles (seconds) the kernel traps, so
// the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start < 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Orders this thread's earlier generic accesses to shared memory before its
// later copy-engine ones.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory by the copy engine, completing that many bytes on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace f2v
