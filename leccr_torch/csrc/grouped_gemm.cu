// Grouped GEMM over the experts that a mixture-of-experts layer holds
// (ops/grouped_gemm.py): the routed slots sorted by expert are one [M, *]
// matrix whose rows [offsets[g], offsets[g + 1]) belong to expert g, and
// each group meets its own weight of a stack [G, N, K] ([out, in]):
//
//   fwd:  Y[r]  = X[r] · W[g]ᵀ      X [M, K] -> Y [M, N]   (bf16 out)
//   dx:   dX[r] = dY[r] · W[g]      dY [M, N] -> dX [M, K] (bf16 out)
//   dw:   dW[g] = dY_gᵀ · X_g       -> dW [G, N, K]        (f32 out)
//
// No TPU kernel: the JAX package has no MoE tower.  It was added because
// the group sizes are data (the router's choices) and live on the device:
// a product per expert would need them on the host (a sync a layer, which
// also breaks the train step's CUDA graphs), and nothing else the port has
// computes a product of data-dependent length.  The offsets are read on
// the device, by every block, as it walks its work.
//
// What bounds it: at the MoE tower's widths (K, N of 1408 and 2048) and
// ~1,500 rows an expert, each product does ~4 operations a byte of its
// weight and far more per byte of its rows: it is bound by the tensor
// cores (989 TFLOP/s bf16), not by memory.  So the design is the one that
// reaches the tensor cores: wgmma m64n128k16 on 128 x 128 output tiles
// (two consumer warpgroups of 64 rows), fed from a 4-stage ring of 64-wide
// TMA boxes by one producer thread, persistent blocks (one an SM) walking
// the tiles of all groups.  fwd and dx read the operands K-major and
// MN-major as they lie in memory; a row tile that runs past its group
// computes the next group's rows too and stores only its own.  dw
// contracts over a group's rows: in the last box of a group the rows past
// its end are zeroed in shared memory before the product.  Right and
// simple first: each k-step waits for its own product (no product in
// flight across steps) and the producer warpgroup keeps its registers.
//
// Boxes are [64 rows][64 bf16] with the 128-byte swizzle (hopper.cuh):
// every operand is a row-major matrix with a multiple of 64 columns, seen
// by TMA as a [1, columns / 64, rows, 64] tensor (`encode_rows_map`), so a
// box is (row r, column block c).

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;  // rows of a block's output tile
constexpr int kBN = 128;  // columns of a block's output tile
constexpr int kStages = 4;
constexpr int kBoxBytes = kWgTileBytes;         // one 64 x 64 bf16 box
constexpr int kStageBytes = 4 * kBoxBytes;      // A: 2 boxes, B: 2 boxes
constexpr int kBarOff = kStages * kStageBytes;  // full, then empty barriers
constexpr int kSmemBytes = kBarOff + 16 * kStages + 1024;
constexpr int kConsumerThreads = kWgConsumers * kWarpgroup;
constexpr int kBadShape = -3;  // a width off the 128-column tiling

enum Op { kFwd = 0, kDx = 1, kDw = 2 };

struct Maps {
  CUtensorMap a, b;
};

struct Args {
  const int* offsets;  // [groups + 1] on the device
  void* out;
  int groups, rows;    // G, M
  int n, k;            // the stack's [N, K]
};

// ------------------------------------------------ wgmma m64n128k16
#define GG_D64(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d += A·B (64 x 128 from 64 x 16 by 16 x 128), both operands by
// descriptor; TA / TB: the operand is MN-major (its tile's rows are the
// contracted dim).
template <int TA, int TB>
__device__ __forceinline__ void mma128(float (&d)[64], uint64_t a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : GG_D64(d)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}
#undef GG_D64

// ------------------------------------------------------------ the walk
// One output tile of the persistent walk: group g, its first row (fwd, dx:
// of the [M, *] output; dw: of the group's [N, K] weight) and column, the
// group's rows [lo, hi) and the k-steps of 64 it contracts over.
struct Tile {
  int g, row0, col0, lo, hi, steps;
};

// The item-th tile of `op`, or false past the last.  fwd / dx: each
// group's row tiles (as many as its rows need) times the output's column
// tiles, group by group; dw: G x (N / 128) x (K / 128) tiles, each over
// all of its group's rows.
template <int OP>
__device__ __forceinline__ bool locate(const Args& p, int item, Tile& t) {
  if (OP == kDw) {
    const int tn = p.n / kBN, tk = p.k / kBN;
    if (item >= p.groups * tn * tk) return false;
    t.g = item / (tn * tk);
    const int rem = item % (tn * tk);
    t.row0 = (rem / tk) * kBN;
    t.col0 = (rem % tk) * kBN;
    t.lo = p.offsets[t.g];
    t.hi = p.offsets[t.g + 1];
    t.steps = (t.hi - t.lo + 63) / 64;
    return true;
  }
  const int cols = OP == kFwd ? p.n : p.k;
  const int tiles_n = cols / kBN;
  int base = 0;
  for (int g = 0; g < p.groups; ++g) {
    const int lo = p.offsets[g], hi = p.offsets[g + 1];
    const int tiles = (hi - lo + kBM - 1) / kBM * tiles_n;
    if (item < base + tiles) {
      const int local = item - base;
      t.g = g;
      t.row0 = lo + (local / tiles_n) * kBM;
      t.col0 = (local % tiles_n) * kBN;
      t.lo = lo;
      t.hi = hi;
      t.steps = (OP == kFwd ? p.k : p.n) / 64;
      return true;
    }
    base += tiles;
  }
  return false;
}

struct Smem {
  uint32_t base;
  uint8_t* ptr;
  __device__ uint32_t a(int s, int c) const {
    return base + s * kStageBytes + c * kBoxBytes;
  }
  __device__ uint32_t b(int s) const {
    return base + s * kStageBytes + 2 * kBoxBytes;
  }
  __device__ uint32_t full(int s) const { return base + kBarOff + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return base + kBarOff + 8 * kStages + 8 * s;
  }
};

// The producer thread: the A and B boxes of every k-step of every tile
// this block walks, into the ring.
template <int OP>
__device__ void produce(const Maps& maps, const Args& p, const Smem& sm) {
  int t = 0;
  Tile tile;
  for (int item = blockIdx.x; locate<OP>(p, item, tile); item += gridDim.x)
    for (int s = 0; s < tile.steps; ++s, ++t) {
      const int st = t % kStages;
      mbar_wait(sm.empty(st), ((t / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(sm.full(st), kStageBytes);
      for (int x = 0; x < 2; ++x) {
        if (OP == kFwd) {  // X rows x K block s; W[g] rows x K block s
          tma_load_rows(&maps.a, sm.a(st, x), sm.full(st),
                        tile.row0 + 64 * x, s, 0);
          tma_load_rows(&maps.b, sm.b(st) + x * kBoxBytes, sm.full(st),
                        tile.g * p.n + tile.col0 + 64 * x, s, 0);
        } else if (OP == kDx) {  // dY rows x N block s; W[g] N rows x K
          tma_load_rows(&maps.a, sm.a(st, x), sm.full(st),
                        tile.row0 + 64 * x, s, 0);
          tma_load_rows(&maps.b, sm.b(st) + x * kBoxBytes, sm.full(st),
                        tile.g * p.n + 64 * s, tile.col0 / 64 + x, 0);
        } else {  // the group's rows s: dY's N blocks, X's K blocks
          const int r = tile.lo + 64 * s;
          tma_load_rows(&maps.a, sm.a(st, x), sm.full(st), r,
                        tile.row0 / 64 + x, 0);
          tma_load_rows(&maps.b, sm.b(st) + x * kBoxBytes, sm.full(st), r,
                        tile.col0 / 64 + x, 0);
        }
      }
    }
}

// Rows [valid, 64) of a box at generic address `box`, zeroed by the 128
// threads of a warpgroup (a row is 128 contiguous bytes whatever the
// swizzle).
__device__ __forceinline__ void zero_rows(uint8_t* box, int valid,
                                          int lane128) {
  for (int i = lane128; i < (64 - valid) * 8; i += kWarpgroup)
    *reinterpret_cast<uint4*>(box + (valid + i / 8) * 128 + (i % 8) * 16) =
        make_uint4(0, 0, 0, 0);
}

// A consumer warpgroup: its 64 rows of each tile, 4 products a k-step.
template <int OP>
__device__ void consume(const Args& p, const Smem& sm, int wg) {
  const int lane128 = threadIdx.x % kWarpgroup;
  const Frag f{lane128 / kWarp, (lane128 % kWarp) / 4, lane128 % 4};
  int t = 0;
  Tile tile;
  float d[64];
  for (int item = blockIdx.x; locate<OP>(p, item, tile); item += gridDim.x) {
#pragma unroll
    for (int e = 0; e < 64; ++e) d[e] = 0.f;
    for (int s = 0; s < tile.steps; ++s, ++t) {
      const int st = t % kStages;
      mbar_wait(sm.full(st), (t / kStages) & 1);
      const int valid = tile.hi - tile.lo - 64 * s;  // rows of this box
      if (OP == kDw && valid < 64) {
        zero_rows(sm.ptr + (sm.a(st, wg) - sm.base), valid, lane128);
        zero_rows(sm.ptr + (sm.b(st) - sm.base) + wg * kBoxBytes, valid,
                  lane128);
        fence_proxy_async();
        named_sync(1, kConsumerThreads);
      }
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (OP == kFwd)
          mma128<0, 0>(d, kmajor_desc(sm.a(st, wg), ks),
                       kmajor_desc(sm.b(st), ks));
        else if (OP == kDx)
          mma128<0, 1>(d, kmajor_desc(sm.a(st, wg), ks),
                       mnmajor_desc(sm.b(st), ks));
        else
          mma128<1, 1>(d, mnmajor_desc(sm.a(st, wg), ks),
                       mnmajor_desc(sm.b(st), ks));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(d);
      __syncwarp();
      if (threadIdx.x % kWarp == 0) mbar_arrive(sm.empty(st));
    }
    // the tile's 64 x 128 part of this warpgroup
    const int row0 = tile.row0 + 64 * wg;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + f.row(2 * r);
      if (OP == kDw) {
        float* out = static_cast<float*>(p.out) +
                     ((long long)tile.g * p.n + i) * p.k + tile.col0;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          *reinterpret_cast<float2*>(out + f.col(c, 0)) =
              make_float2(d[4 * c + 2 * r], d[4 * c + 2 * r + 1]);
      } else if (i < tile.hi) {
        const int cols = OP == kFwd ? p.n : p.k;
        bf16* out = static_cast<bf16*>(p.out) + (long long)i * cols +
                    tile.col0;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          *reinterpret_cast<uint32_t*>(out + f.col(c, 0)) =
              pack(d[4 * c + 2 * r], d[4 * c + 2 * r + 1]);
      }
    }
  }
}

template <int OP>
__global__ void __launch_bounds__(kWgThreads, 1)
    grouped_gemm_kernel(__grid_constant__ const Maps maps, const Args p) {
  const SmemBase raw = smem_base();
  const Smem sm{raw.base, raw.ptr};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kConsumerThreads / kWarp);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWarpgroup;
  if (wg == kWgConsumers) {
    if (threadIdx.x == kConsumerThreads) produce<OP>(maps, p, sm);
    return;
  }
  consume<OP>(p, sm, wg);
}

// A row-major bf16 [rows, cols] matrix as TMA sees it (see the head).
int encode_matrix(CUtensorMap* map, const void* base, long long rows,
                  int cols) {
  return encode_rows_map(map, base, 1, cols / 64, (int)rows, rows * cols, 64,
                         cols);
}

template <int OP>
int launch(const void* a, long long a_rows, int a_cols, const void* b,
           long long b_rows, int b_cols, const Args& p, void* stream) {
  if (p.n % kBN != 0 || p.k % kBN != 0) return kBadShape;
  Maps maps;
  int rc = encode_matrix(&maps.a, a, a_rows, a_cols);
  if (rc == 0) rc = encode_matrix(&maps.b, b, b_rows, b_cols);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int grid = sm_count();
  if (grid <= 0) grid = 132;
  if (OP == kDw) {
    const int items = p.groups * (p.n / kBN) * (p.k / kBN);
    grid = items < grid ? items : grid;
  }
  if (grid > 0)
    grouped_gemm_kernel<OP><<<grid, kWgThreads, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launch (0 = success),
// -3 where N or K is not a multiple of 128, -10 / -11 where a TMA map
// could not be encoded.  Every pointer is 16-byte aligned; offsets is
// int32 [groups + 1] on the device, offsets[0] = 0, non-decreasing, at
// most m.  Rows of y / dx past offsets[groups] are not written.

// y [m, n] = x [m, k] · w[g]ᵀ by group; w [groups, n, k].
int gg_fwd(const void* x, const void* w, void* y, const int* offsets,
           int groups, int m, int n, int k, void* stream) {
  const Args p{offsets, y, groups, m, n, k};
  return launch<kFwd>(x, m, k, w, (long long)groups * n, k, p, stream);
}

// dx [m, k] = dy [m, n] · w[g] by group.
int gg_dx(const void* dy, const void* w, void* dx, const int* offsets,
          int groups, int m, int n, int k, void* stream) {
  const Args p{offsets, dx, groups, m, n, k};
  return launch<kDx>(dy, m, n, w, (long long)groups * n, k, p, stream);
}

// dw [groups, n, k] (f32) = dy_gᵀ · x_g over each group's rows.
int gg_dw(const void* dy, const void* x, float* dw, const int* offsets,
          int groups, int m, int n, int k, void* stream) {
  const Args p{offsets, dw, groups, m, n, k};
  return launch<kDw>(dy, m, n, x, m, k, p, stream);
}

}  // extern "C"
