// Helpers shared by the force kernels: row loads and stores, lane-group
// sums, the force models, and the ELL gather engine (ell_block) that
// ell_edge_force.cu and ell_sample_force.cu both run.
//
// A group of lanes holds one D = 128 embedding row: lane l of the group
// holds the V contiguous elements [l*V, l*V + V), so a row load is one
// vector load per lane and the group reads the row's bytes contiguously.
// Row bases must be 16-byte aligned (the Python wrappers check it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace f2v {

constexpr unsigned kFullMask = 0xffffffffu;
// The embedding width the kernels are built for (force_kernels._KERNEL_DIM).
constexpr int kDim = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// Store v at p, or with `accumulate` store p + v: one rounded f32 add per
// element, the add a separate `out.add_(v)` would make.
template <int V>
__device__ __forceinline__ void store_or_add(float* __restrict__ p,
                                             const float (&v)[V],
                                             bool accumulate) {
  if (!accumulate) {
    store_row<V>(p, v);
    return;
  }
  float s[V];
  load_row<float, V>(p, s);
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = __fadd_rn(s[i], v[i]);
  store_row<V>(p, s);
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

// How a row of T is spread over lanes with 16-byte loads: kG lanes per row
// (bf16 16, f32 32), kV elements per lane (bf16 8, f32 4).
template <typename T>
struct RowLanes {
  static constexpr int kG = kDim * int(sizeof(T)) / 16;
  static constexpr int kV = kDim / kG;
};

// The force models divide with __fdividef (at most 2 ulp): every divisor is
// ≥ 1 or a positive squared distance, far from its 2^126 limit, and the
// precise division's slow path gave the kernels a stack frame and spills.
// The sigmoid keeps the precise division: sigmoid's 1 - sigmoid(a) cancels
// where sigmoid(a) is near 1, and 2 ulp there moved whole terms by more
// than the plain version's own rounding.
__device__ __forceinline__ float sigmoidf(float a) {
  return 1.0f / (1.0f + expf(-a));
}

// -- the force models -----------------------------------------------------------
//
// Every force is one scalar per pair times one vector, elementwise:
//   a = sum_d vec_d^2 (or xi . xj when kDot), c = coeff(a, invd, step),
//   force_d = term(c, vec_d, step).

// Model ids of the edge (attraction) forces, shared with force_kernels.py
// (_EDGE_MODEL_IDS); models/forces.py::_<model>_coeff.
enum EdgeModel { kTdist = 0, kSigmoid = 1, kFr = 2, kLinlog = 3,
                 kForceatlas = 4 };

template <int M>
struct EdgeForce {
  static constexpr bool kDot = M == kSigmoid;
  static constexpr bool kUsesInvd = M == kSigmoid;
  __device__ static __forceinline__ float vec(float xi, float xj) {
    if constexpr (M == kTdist) return xi - xj;
    else if constexpr (M == kSigmoid) return xj;
    else return xj - xi;
  }
  __device__ static __forceinline__ float coeff(float a, float invd,
                                                float step) {
    if constexpr (M == kTdist) {
      return __fdividef(step * -2.0f, 1.0f + a);
    } else if constexpr (M == kSigmoid) {
      return step * invd * (1.0f - sigmoidf(a));
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
enum SampleModel { kTdistRep = 0, kSigmoidRep = 1, kLayoutRep = 2 };
constexpr float kMaxBound = 5.0f;  // models/forces.py::MAXBOUND

template <int M>
struct SampleForce {
  static constexpr bool kDot = M == kSigmoidRep;
  static constexpr bool kUsesInvd = false;
  __device__ static __forceinline__ float vec(float xi, float s) {
    if constexpr (M == kTdistRep) return xi - s;
    else if constexpr (M == kSigmoidRep) return s;
    else return s - xi;
  }
  __device__ static __forceinline__ float coeff(float a, float, float step) {
    if constexpr (M == kTdistRep) {
      // 2 / (r (1 + r)), zero at r = 0
      return a > 0.0f ? __fdividef(2.0f, a * (1.0f + a)) : 0.0f;
    } else if constexpr (M == kSigmoidRep) {
      return -step * sigmoidf(a);
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

// One lane's share of a pair's scalar a.
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

// acc += force(xi, xj) for one row held by a group of G lanes.  The scalar
// is a group sum, so every lane of the warp must call it.
// grouped_rep_force.cu's force; ell_block issues the same steps for many
// pairs at once.
template <class F, int G, int V>
__device__ __forceinline__ void add_pair_force(const float (&xi)[V],
                                               const float (&xj)[V],
                                               float invd, float step,
                                               float (&acc)[V]) {
  const float c = F::coeff(group_sum<G>(pair_part<F, V>(xi, xj)), invd, step);
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] += F::term(c, F::vec(xi[v], xj[v]), step);
}

// -- the ELL gather engine ---------------------------------------------------------
//
// A work table is a list of entries, each a block of `rows` rows with
// `width` id slots per row.  Row r of an entry computes
//   out[out_begin + r] = sum_{k < deg[row_begin + r]} force(x[i], xg[j_k])
//   with i = xi_row[row_begin + r], j_k = nbr[nbr_begin + r * width + k],
// x_i in f32 and the neighbour rows from the (bf16 or f32) gather replica
// xg.  One launch covers the whole table: each entry owns a run of
// consecutive blocks, in table order, so the caller's order (widest first)
// is the order in which rows start.
//
// A group of kG lanes owns a row: two rows per warp with a bf16 replica,
// whose rows are 16 lanes of 16-byte loads, so that one warp load
// instruction fetches two neighbour rows; one with f32.  Per row, one
// coalesced load brings up to kG ids to the group's lanes; 8 neighbour
// rows per group (16 per bf16 warp) are loaded before any is used; the
// pairs' scalars are group sums over kG lanes (4 shuffle steps for bf16),
// issued for all of them together so that they do not wait behind one
// another; then the updates, in slot order.  (A whole warp per wide row,
// its two groups taking alternate slots, was tried on an H100 and was no
// faster on the bench layout; its code cost registers.)

constexpr int kEllWarps = 4;  // warps per block
constexpr int kEllThreads = kEllWarps * 32;
constexpr int kMaxEntries = 64;  // force_kernels._MAX_ENTRIES
// Neighbour rows loaded ahead per group: 4 KB per warp, 16 bf16 rows or 8
// f32 rows (16 f32 rows spill at this register budget).
constexpr int kEllInFlight = 8;
// Blocks per SM the register budget is set for: 5 of 4 warps leave 96
// registers a thread, where no instance spills; 3 of 8 warps (80
// registers) spilled and ran slower on an H100.
constexpr int kEllMinBlocks = 5;

struct EllEntry {
  int64_t row_begin;  // first row of deg and xi_row
  int64_t nbr_begin;  // first slot of nbr
  int64_t out_begin;  // first output row
  int rows;
  int width;
  int block_begin;  // first block of the launch
};

template <typename T>
struct EllArgs {
  const float* x;         // [n_pad, D]
  const T* xg;            // [n_pad, D] gather replica
  const int32_t* nbr;     // every entry's [rows, width] ids, flat
  const int32_t* deg;     // [rows] valid slots per row
  const int32_t* xi_row;  // [rows] table row whose x (and invd) a row uses
  const float* invd;      // [n_pad] 1 / (deg + 1); read only by sigmoid
  float* out;             // [out rows, D]
  float step;
  int accumulate;         // store out + sum instead of sum
  int n_entries;
  EllEntry e[kMaxEntries];
};

// Fill p's entries from the host's [n, 5] int64 table (row_begin,
// nbr_begin, out_begin, rows, width).  Returns the number of blocks the
// launch needs, or -1 for a malformed table.
template <typename T>
inline int64_t ell_plan(EllArgs<T>& p, const int64_t* table, int n) {
  if (n < 1 || n > kMaxEntries) return -1;
  constexpr int64_t kRowsPerBlock = kEllWarps * (32 / RowLanes<T>::kG);
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

// The entry that owns this block: the last whose block_begin ≤ blockIdx.x.
template <typename T>
__device__ __forceinline__ const EllEntry& ell_entry(const EllArgs<T>& p) {
  int k = 0;
  while (k + 1 < p.n_entries && int(blockIdx.x) >= p.e[k + 1].block_begin) ++k;
  return p.e[k];
}

// Element v of a lane's 16 loaded bytes as f32.  The bytes stay a uint4:
// loaded into a bf16 array, the in-flight rows' elements went through local
// memory (a stack frame and spills); as words they stay in registers, and
// the compiler converts them where they are used.
template <typename T>
__device__ __forceinline__ float piece_f32(const uint4& q, int v) {
  const int k = sizeof(T) == 2 ? v / 2 : v;
  const uint32_t w = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
  if (sizeof(T) == 4) return __uint_as_float(w);
  return __uint_as_float(v % 2 == 0 ? w << 16 : w & 0xffff0000u);
}

// The body of both ELL kernels: this block's entry, one row per group.
template <typename T, class F>
__device__ __forceinline__ void ell_block(const EllArgs<T>& p) {
  constexpr int G = RowLanes<T>::kG;
  constexpr int V = RowLanes<T>::kV;
  constexpr int NG = 32 / G;  // rows per warp
  constexpr int U = kEllInFlight;
  static_assert(G % U == 0, "a group's ids must cover whole rounds");
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
  float xi[V];
  float invd_i = 0.0f;
  if (live) {
    const int64_t i = p.xi_row[e.row_begin + r];
    load_row<float, V>(p.x + i * kDim + gl * V, xi);
    if (F::kUsesInvd) invd_i = p.invd[i];
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) xi[v] = 0.0f;
  }
  const int32_t* ids = p.nbr + e.nbr_begin + int64_t(r) * e.width;
  int n_max = n;  // the warp's loops run to its longest row
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
    n_max = max(n_max, __shfl_xor_sync(kFullMask, n_max, o));
  }
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;

  for (int i0 = 0; i0 < n_max; i0 += G) {
    const int my_j = i0 + gl < n ? ids[i0 + gl] : 0;
    const int cnt = min(G, n_max - i0);
    for (int k = 0; k < cnt; k += U) {
      uint4 xj[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t j = __shfl_sync(kFullMask, my_j, k + u, G);
        if (i0 + k + u < n) {
          xj[u] = *reinterpret_cast<const uint4*>(p.xg + j * kDim + gl * V);
        }
      }
      float a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        a[u] = 0.0f;
        if (i0 + k + u < n) {
          float f[V];
#pragma unroll
          for (int v = 0; v < V; ++v) f[v] = piece_f32<T>(xj[u], v);
          a[u] = pair_part<F, V>(xi, f);
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          a[u] += __shfl_xor_sync(kFullMask, a[u], o);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + k + u < n) {
          const float c = F::coeff(a[u], invd_i, p.step);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[v] += F::term(c, F::vec(xi[v], piece_f32<T>(xj[u], v)),
                              p.step);
          }
        }
      }
    }
  }
  if (live) {
    store_or_add<V>(p.out + (e.out_begin + r) * kDim + gl * V, acc,
                    p.accumulate);
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
