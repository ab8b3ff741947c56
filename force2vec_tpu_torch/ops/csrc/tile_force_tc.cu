// tdist edge sweep over materialised tiles, with the D-axis reduction on
// the tensor cores.  For each entry of a work table (xi, xj, deg):
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
// (to nearest, ties away from zero), at most 2^-11 of itself; the products
// by 1 and their f32 sums are exact up to f32 rounding.  So |da| <= 2^-11 * a,
// the coefficient moves by at most 2^-11 * a / (1 + a) of itself, and with
// |2 (xi - xj)_d / (1 + a)| <= 1 the clip never binds, so each term moves
// by at most 2^-11 of itself.  chip_smoke.py holds the kernel to
// (1e-5 + 2^-11) * sum |terms|.  3xTF32 would keep the f32 bound at three
// times the tensor-core work; the probe asks what one pass costs, and a
// term error of 2^-11 is far below the bf16 rounding of xj itself.
//
// What bounds it: bytes.  Over the bench layout's 13 buckets the function
// reads the real slots of the bf16 tiles (2,097,122 rows of 256 bytes, 537
// MB; slots past deg are skipped, not read), xi and deg, and writes out.
// The tensor-core work (2 * 128 flops per slot at 495 TFLOP/s) is < 1% of
// that time.
//
// Design: one launch over every entry of the table (widest first, as the
// caller orders them), streamed through shared memory.  Persistent warps
// walk the table's rows (warp w of W takes rows w, w + W, ...).  Each warp
// owns a ring of kStages stages; lane 0 fills a stage with one
// cp.async.bulk of up to kChunk of a row's real slots, which lie
// contiguously in xj (plus the row's xi with its first chunk), and the
// stage's mbarrier completes when the bytes have landed.  A row with no
// real slots takes one empty chunk, so that its zero is written.  The warp
// keeps kStages chunks in flight and refills a stage as soon as it has
// swept it; the clamped deg of its next 32 rows is loaded a lane each.
// The sweep of a stage takes its slots eight at a time, one per 4-lane
// group; lane t of group g reads values 32 ((j + g) % 4) + 8 t + [0, 8)
// (j < 4) of slot k0 + g, the pieces rotated by group so that the eight
// slots' reads spread over the banks, and feeds its 32 squared differences
// to 8 mma.sync as A fragments.  Whatever the fragment layout, the A rows g
// and g + 8 come only from group g's lanes, and with B = ones every column
// of C holds its row's sum, so c0 + c2 of any lane of group g is
// a_{r, k0+g}.  Slots at or past deg[r] enter as zero differences and add
// exactly 0.  The update reads the differences again from shared memory
// rather than holding them, so that 2 blocks of 8 warps fit an SM's
// registers.  At a row's last chunk the 8 groups' partial sums meet in the
// swept stage and each lane adds 4 values over them.  On an H100 the
// sweep's instructions, not its bytes in flight, set its time: a ring of 3
// stages was no faster than 2, fewer warps an SM were slower, and so was a
// mapping with 16 values a lane (3 blocks an SM).

#include "common.cuh"

namespace f2v {
namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMinBlocks = 2;  // blocks an SM holds with bf16 tiles
constexpr int kStages = 2;  // ring stages per warp
constexpr int kChunk = 24;  // slots per stage
constexpr int kSlots = 8;   // slots per step: one per 4-lane group
constexpr int kVals = 8;    // contiguous values per piece
constexpr int kPieces = kDim / (4 * kVals);  // pieces per lane and slot
constexpr int kChains = 2;  // mma.sync accumulators per step
static_assert(kPieces * kVals % 4 == 0, "A fragments take 4 values");
static_assert(kChunk % kSlots == 0, "a stage holds whole steps");
// Row stride (floats) of the 8 groups' partial sums, written into a swept
// stage: 4 floats of padding spread the groups over the banks.
constexpr int kRedStride = kDim + 4;
static_assert(kSlots * kRedStride * 4 <= kChunk * kDim * 2,
              "a stage holds the partial sums");

struct TileEntry {
  const float* xi;      // [rows, D]
  const void* xj;       // [rows, width, D]
  const int32_t* deg;   // [rows]
  float* out;           // [rows, D]
  int row_begin;        // first row of the launch's row space
  int rows;
  int width;
};

struct TileArgs {
  float step;
  int n_entries;
  int total_rows;
  TileEntry e[kMaxEntries];
};

// A stage's work: slots [k0, k0 + n) of row `row` of entry `entry`, whose
// clamped deg is d.
struct Chunk {
  int entry, row, k0, n, d;
};

// One warp's ring.
template <typename T>
struct alignas(16) TileRing {
  T xj[kStages][kChunk * kDim];
  float xi[kStages][kDim];
  Chunk meta[kStages];
  uint64_t full[kStages];
};

// x >= 0 as a TF32 operand, rounded to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds it: half a TF32 unit added to the bits, since
// the tensor cores ignore the low 13 bits of a .tf32 operand (CUTLASS's
// round_half_ulp_truncate).  One integer add in place of the conversion.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
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

// dv = x - xj over one piece of a slot; zero differences past the chunk's
// slots.
template <typename T>
__device__ __forceinline__ void piece_diff(const T* xj,
                                           const float (&x)[kVals], bool live,
                                           float (&dv)[kVals]) {
  if (live) {
    load_row<T, kVals>(xj, dv);
#pragma unroll
    for (int v = 0; v < kVals; ++v) dv[v] = x[v] - dv[v];
  } else {
#pragma unroll
    for (int v = 0; v < kVals; ++v) dv[v] = 0.0f;
  }
}

// The entry that holds row `row` of the launch: the last whose row_begin
// is at most row.
__device__ __forceinline__ int entry_of(const TileArgs& p, int64_t row) {
  int e = p.n_entries - 1;
  while (e > 0 && row < p.e[e].row_begin) --e;
  return e;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
    tile_force_tc_kernel(const __grid_constant__ TileArgs p) {
  constexpr int D = kDim;
  constexpr uint32_t kSlotBytes = D * sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  TileRing<T>& ring = reinterpret_cast<TileRing<T>*>(smem)[threadIdx.x >> 5];
  const int g = lane >> 2;
  const int off = 8 * (lane & 3);
  const int gw = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int nw = gridDim.x * kWarpsPerBlock;
  if (gw >= p.total_rows) return;  // whole warp leaves together
  const int my_rows = (p.total_rows - gw + nw - 1) / nw;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&ring.full[s], 1);
    mbar_fence_init();
  }
  __syncwarp();

  // The producer's cursor: the next chunk is slots pk0... of the warp's row
  // pi; dlane is the clamped deg of the warp's row 32 * batch + lane.
  int pi = 0, pk0 = 0, batch = -1, dlane = 0, issued = 0;
  int pe = 0;  // the entry of row pi: rows only grow
  const auto produce = [&](int s) {  // warp-uniform; lane 0 issues
    if (pi / 32 != batch) {
      batch = pi / 32;
      const int64_t row = gw + int64_t(nw) * (32 * batch + lane);
      dlane = 0;
      if (row < p.total_rows) {
        const TileEntry& e = p.e[entry_of(p, row)];
        dlane = min(max(e.deg[row - e.row_begin], 0), e.width);
      }
    }
    const int d = __shfl_sync(kFullMask, dlane, pi % 32);
    const int64_t row = gw + int64_t(nw) * pi;
    while (pe + 1 < p.n_entries && row >= p.e[pe + 1].row_begin) ++pe;
    const TileEntry& e = p.e[pe];
    const int r = int(row - e.row_begin);
    const int n = min(kChunk, d - pk0);  // 0 for a row with no real slots
    if (lane == 0) {
      // the stage may have held the sums' generic writes: order them before
      // the copy engine's
      fence_proxy_async();
      ring.meta[s] = Chunk{pe, r, pk0, n, d};
      const bool first = pk0 == 0 && n > 0;
      mbar_arrive_expect_tx(&ring.full[s],
                            n * kSlotBytes + (first ? D * sizeof(float) : 0));
      if (n > 0) {
        bulk_copy_g2s(ring.xj[s],
                      static_cast<const T*>(e.xj) +
                          (int64_t(r) * e.width + pk0) * D,
                      n * kSlotBytes, &ring.full[s]);
      }
      if (first) {
        bulk_copy_g2s(ring.xi[s], e.xi + int64_t(r) * D, D * sizeof(float),
                      &ring.full[s]);
      }
    }
    pk0 += kChunk;
    if (pk0 >= d) {
      ++pi;
      pk0 = 0;
    }
    ++issued;
  };

  for (int s = 0; s < kStages && pi < my_rows; ++s) produce(s);
  float x[kPieces][kVals] = {};
  float acc[kPieces][kVals] = {};
  for (int ct = 0; ct < issued; ++ct) {  // issued grows as stages refill
    const int s = ct % kStages;
    mbar_wait(&ring.full[s], (ct / kStages) & 1);
    const Chunk m = ring.meta[s];
    if (m.k0 == 0) {  // a new row
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        if (m.n > 0) {
          load_row<float, kVals>(ring.xi[s] + 32 * ((j + g) % kPieces) + off,
                                 x[j]);
        }
#pragma unroll
        for (int v = 0; v < kVals; ++v) acc[j][v] = 0.0f;
      }
    }
    for (int k0 = 0; k0 < m.n; k0 += kSlots) {  // warp-uniform
      // slot k's piece j; zero differences past the chunk's slots
      const int k = k0 + g;
      // piece j of slot k at xk + 32 ((j + g) % kPieces)
      const T* xk = ring.xj[s] + k * D + off;
      const bool live = k < m.n;
      // kChains independent accumulators shorten the chain of dependent
      // mma.sync; their sums are added at the end
      float c[kChains][4] = {};
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        float dv[kVals];
        piece_diff<T>(xk + 32 * ((j + g) % kPieces), x[j], live, dv);
#pragma unroll
        for (int h = 0; h < kVals / 4; ++h) {
          uint32_t a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = to_tf32(dv[4 * h + i] * dv[4 * h + i]);
          }
          mma_row_sums(c[(j * kVals / 4 + h) % kChains], a);
        }
      }
      float a_rk = 0.0f;
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch) a_rk += c[ch][0] + c[ch][2];
      const float coef = -2.0f / (1.0f + a_rk);
      // the differences again, from shared memory, rather than held
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        float dv[kVals];
        piece_diff<T>(xk + 32 * ((j + g) % kPieces), x[j], live, dv);
#pragma unroll
        for (int v = 0; v < kVals; ++v) {
          acc[j][v] +=
              fminf(fmaxf(coef * dv[v], -kMaxBound), kMaxBound) * p.step;
        }
      }
    }
    if (m.k0 + m.n >= m.d) {  // the row's last chunk: write it
      // add the 8 groups' partial sums through the swept stage: group g's
      // sums in row g of red, then lane l adds values 4 l + [0, 4) over g
      float* red = reinterpret_cast<float*>(ring.xj[s]);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        store_row<kVals>(
            red + g * kRedStride + 32 * ((j + g) % kPieces) + off, acc[j]);
      }
      __syncwarp();
      float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        float v[4];
        load_row<float, 4>(red + q * kRedStride + 4 * lane, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[i] += v[i];
      }
      store_row<4>(p.e[m.entry].out + int64_t(m.row) * D + 4 * lane, sum);
    }
    __syncwarp();  // the stage is swept: refill it
    if (pi < my_rows) produce(s);
  }
}

template <typename T>
size_t smem_bytes() {
  return kWarpsPerBlock * sizeof(TileRing<T>);
}

// Fill p's entries from the host's [n, 6] int64 table (xi, xj, deg, out
// row offset, rows, width).  Returns false for a malformed table.
inline bool tile_plan(TileArgs& p, const int64_t* table, int n, float* out) {
  if (n < 1 || n > kMaxEntries) return false;
  int64_t rows = 0;
  for (int k = 0; k < n; ++k) {
    const int64_t* q = table + 6 * k;
    if (q[3] < 0 || q[4] < 0 || q[5] < 0 || q[5] > INT_MAX) return false;
    p.e[k] = TileEntry{reinterpret_cast<const float*>(q[0]),
                       reinterpret_cast<const void*>(q[1]),
                       reinterpret_cast<const int32_t*>(q[2]),
                       out + q[3] * kDim, int(rows), int(q[4]), int(q[5])};
    rows += q[4];
    // the walk's row numbers stay below 2^31 - 32 warps per block's stride
    if (rows > INT_MAX / 2) return false;
  }
  p.n_entries = n;
  p.total_rows = int(rows);
  return true;
}

template <typename T>
cudaError_t occupancy(int* per_sm) {
  const auto kernel = tile_force_tc_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_bytes<T>()));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, kWarpsPerBlock * 32, smem_bytes<T>());
}

template <typename T>
cudaError_t launch(const TileArgs& p, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = occupancy<T>(&per_sm);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = (p.total_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  tile_force_tc_kernel<T>
      <<<min(blocks, sms * per_sm), kWarpsPerBlock * 32, smem_bytes<T>(), s>>>(
          p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f2v

// table: host [n_entries, 6] int64, per entry (in launch order) the device
// pointers of xi, xj and deg, the entry's first row of out, its rows and its
// width.
extern "C" int f2v_tile_force_tc(const void* table, int n_entries,
                                 int xj_is_bf16, float step, void* out,
                                 int dim, void* stream) {
  // dim 128 only: the probe's width (kPieces covers it exactly)
  if (dim != f2v::kDim) return cudaErrorInvalidValue;
  f2v::TileArgs p{};
  p.step = step;
  if (!f2v::tile_plan(p, static_cast<const int64_t*>(table), n_entries,
                      static_cast<float*>(out))) {
    return cudaErrorInvalidValue;
  }
  if (p.total_rows == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return xj_is_bf16 ? f2v::launch<__nv_bfloat16>(p, s)
                    : f2v::launch<float>(p, s);
}

// res[0]: dynamic shared memory bytes per block; res[1]: blocks an SM holds.
extern "C" int f2v_tile_force_tc_occupancy(int xj_is_bf16, void* res) {
  int* r = static_cast<int*>(res);
  r[0] = int(xj_is_bf16 ? f2v::smem_bytes<__nv_bfloat16>()
                        : f2v::smem_bytes<float>());
  return xj_is_bf16 ? f2v::occupancy<__nv_bfloat16>(&r[1])
                    : f2v::occupancy<float>(&r[1]);
}
