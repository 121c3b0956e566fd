// Hopper (sm_90a) building blocks for warp-specialised kernels: wgmma
// products issued by a warpgroup on operands in shared memory (and A in
// registers), the shared-memory matrix descriptor of the 128-byte swizzle,
// mbarriers, TMA tile loads with their host-side tensor maps, setmaxnreg,
// the conversion of a wgmma accumulator into a bf16 A operand, and the walk
// that two consumer warpgroups take over a ring of streamed tiles.  The
// streamed flash forward (kernels 4 and 6, flash_fwd_wgmma.cuh) and the
// streamed backward (kernels 5, 7 and 8, flash_bwd_wgmma.cuh) are built
// from them.
//
// Tiles are [rows][64] bf16, 128 bytes a row, loaded by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B into 1024-byte aligned shared memory: 16-byte
// chunk c of row r lands at chunk c ^ (r % 8).  wgmma reads such a tile
// through a descriptor of layout type B128 in two ways:
// - K-major (the tile's columns are the contracted dim, e.g. B = Kᵀ of
//   S = Q·Kᵀ): 8-row groups 1024 bytes apart (SBO); the k-step of 16
//   columns advances the start address by 32 bytes.
// - MN-major (the tile's rows are contracted, B = K of dQ = dS·K): the
//   instruction's transpose-B flag; 8-row groups of K 1024 bytes apart
//   (SBO); the k-step of 16 rows advances the start address by 2048 bytes.
// Both keep the swizzle's phase since every step stays 1024-byte aligned
// or within one 128-byte row.
//
// wgmma accumulator layout (m64nN, f32, N / 2 registers): thread t of the
// warpgroup (warp w = t / 32, g = (t % 32) / 4, q = t % 4) holds, for each
// 8-column chunk n, d[4n + e] = (row 16 w + g + 8 (e >> 1), column
// 8 n + 2 q + (e & 1)).  The A
// operand in registers (m64k16) is mma.sync's A fragment per warp: rows
// 16 w + g (+8), columns 2 q (+1) and 2 q + 8 (+1).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kWarpgroup = 128;  // threads that issue one wgmma together

// The warp-specialised flash kernels' blocks: one producer warpgroup and
// two consumer warpgroups of 64 rows each, one block per SM.
constexpr int kWgRows = 64;                            // rows of a consumer
constexpr int kWgConsumers = 2;                        // consumer warpgroups
constexpr int kWgBlockRows = kWgRows * kWgConsumers;   // rows a block owns
constexpr int kWgThreads = (kWgConsumers + 1) * kWarpgroup;
constexpr int kWgTileBytes = kWgRows * 64 * 2;         // one 64 x 64 bf16 box
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ descriptors
// A wgmma shared-memory descriptor of the 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units, layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_byte_addr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((smem_byte_addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// Descriptors of a [rows][64] bf16 tile at `tile` (1024-byte aligned), at
// k-step ks of 16: read K-major (contracting over its 64 columns) or
// MN-major (contracting over its rows, 64 columns wide).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int ks) {
  return sw128_desc(tile + 32 * ks, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int ks) {
  return sw128_desc(tile + 2048 * ks, 8192, 1024);
}

// ------------------------------------------------------------------ wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups of this warpgroup pend.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define LECCR_WGMMA_D32(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define LECCR_WGMMA_D32_LIST                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A·B, m64n64k16, A (64 x 16) from registers as four bf16x2 words
// (mma.sync's A fragment per warp), B from shared memory; accumulate = 0
// overwrites d.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      LECCR_WGMMA_D32_LIST ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : LECCR_WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TRANS_B));
}

#define LECCR_WGMMA_D64(d)                                                  \
  LECCR_WGMMA_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),   \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define LECCR_WGMMA_D64_LIST                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A·Bᵀ, m64n128k16: as wgmma_ss with a 128-row K-major B (e.g. the
// scores of 64 queries against a 128-key tile).
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      LECCR_WGMMA_D64_LIST ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : LECCR_WGMMA_D64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A·B, m64nNk16 for N = 16, 32, 48 or 64, both operands from shared
// memory by descriptor, into the first N / 2 registers of d; TA / TB: A / B
// is MN-major (its tile's rows are contracted).  The single-block kernels'
// products over a head's keys rounded up to 16 (the scores' tail box) and
// over half of Dh (dQ split between two warpgroups).
template <int N>
struct WgmmaSS;

#define LECCR_D8(d, o)                                                      \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),              \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define LECCR_WGMMA_SS_N(N, LIST, IA, IB, IACC, ITA, ITB, ...)              \
  template <>                                                               \
  struct WgmmaSS<N> {                                                       \
    template <int TA, int TB, int M>                                        \
    static __device__ __forceinline__ void run(float (&d)[M], uint64_t a,   \
                                               uint64_t b, int accumulate) { \
      static_assert(M >= N / 2, "accumulator narrower than the product");   \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" IACC ", 0;\n"                \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " LIST  \
          ", %" IA ", %" IB ", p, 1, 1, %" ITA ", %" ITB ";\n}\n"           \
          : __VA_ARGS__                                                     \
          : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));             \
    }                                                                       \
  };

LECCR_WGMMA_SS_N(16, "{%0, %1, %2, %3, %4, %5, %6, %7}", "8", "9", "10",
                 "11", "12", LECCR_D8(d, 0))
LECCR_WGMMA_SS_N(32,
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
                 "%13, %14, %15}",
                 "16", "17", "18", "19", "20", LECCR_D8(d, 0),
                 LECCR_D8(d, 8))
LECCR_WGMMA_SS_N(48,
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
                 "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}",
                 "24", "25", "26", "27", "28", LECCR_D8(d, 0),
                 LECCR_D8(d, 8), LECCR_D8(d, 16))
LECCR_WGMMA_SS_N(64, LECCR_WGMMA_D32_LIST, "32", "33", "34", "35", "36",
                 LECCR_D8(d, 0), LECCR_D8(d, 8), LECCR_D8(d, 16),
                 LECCR_D8(d, 24))

#undef LECCR_D8
#undef LECCR_WGMMA_SS_N

// d (+)= A·B, m64n64k16, bf16 operands, f32 accumulators; A and B from
// shared memory by descriptor; accumulate = 0 overwrites d.  TRANS_B: B is
// MN-major (the tile's rows are contracted).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  WgmmaSS<64>::run<0, TRANS_B>(d, a, b, accumulate);
}
#undef LECCR_WGMMA_D32
#undef LECCR_WGMMA_D32_LIST
#undef LECCR_WGMMA_D64
#undef LECCR_WGMMA_D64_LIST

// The A operand of k-step ks (accumulator columns 16 ks .. 16 ks + 15) of a
// m64nN accumulator, rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&c)[N], int ks,
                                         uint32_t (&a)[4]) {
  const int n = 2 * ks;
  a[0] = pack(c[4 * n], c[4 * n + 1]);
  a[1] = pack(c[4 * n + 2], c[4 * n + 3]);
  a[2] = pack(c[4 * n + 4], c[4 * n + 5]);
  a[3] = pack(c[4 * n + 6], c[4 * n + 7]);
}

// -------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase awaits.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of parity `parity`.  A
// phase that never completes is a fault of the kernel: after some 2^26
// suspended polls (seconds) it traps, so the launch fails rather than
// hangs the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}

// ------------------------------------------------------------------- TMA
// A 64 x 64 box of a 4-D tensor map (dims innermost first: Dh, L, H, B) at
// element coordinates (0, row, h, b) into shared memory `dst`; completion
// counted on `bar` in bytes.  Rows past the tensor's end are zero-filled.
__device__ __forceinline__ void tma_load_rows(const CUtensorMap* map,
                                              uint32_t dst, uint32_t bar,
                                              int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

// --------------------------------------------------------------- setmaxnreg
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barrier over `threads` threads (a multiple of 32), id 1-15: wait
// for all of them, or arrive without waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's earlier shared-memory writes before later reads of
// the async proxy (a wgmma operand written with st.shared).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x, which the compiler must take as new wherever this stands: a
// descriptor built from it in a loop is rebuilt each turn (a few integer
// operations) rather than hoisted into registers that a loop is short of.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// 2^x (ex2.approx: two ulps; -inf gives +0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------- warp-specialised walk over a ring
// Dynamic shared memory aligned to 1024 bytes (the 128-byte swizzle's
// period): its shared address and its generic address.
struct SmemBase {
  uint32_t base;
  uint8_t* ptr;
};

__device__ __forceinline__ SmemBase smem_base() {
  extern __shared__ __align__(16) uint8_t wg_smem_raw[];
  const uint32_t raw = smem_addr(wg_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  return {base, wg_smem_raw + (base - raw)};
}

// A ring of STAGES streamed tiles: its full and empty mbarriers, each
// array 8 bytes a barrier.  Tile t sits in stage t % STAGES; the barriers'
// phase parity for it is (t / STAGES) & 1.
template <int STAGES>
struct Ring {
  uint32_t full0, empty0;
  __device__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return empty0 + 8 * s; }
};

// Barrier set-up by thread 0: `own` (the block's own rows, one arrival),
// the ring's full barriers (`full_count` arrivals of the producer) and
// empty ones (one arrival per consumer warp).
template <int STAGES>
__device__ __forceinline__ void ring_init(uint32_t own,
                                          const Ring<STAGES>& ring,
                                          int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full(s), full_count);
      mbar_init(ring.empty(s), kWgConsumers * kWarpgroup / kWarp);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// Keeps the compiler from moving reads or writes of a wgmma accumulator
// across the asynchronous product (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// A register A operand stays live (and unmoved) until the wait that ends
// the product reading it.
template <int K>
__device__ __forceinline__ void fence_a(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[k][x])::"memory");
}

// The accumulator's element e of 8-column chunk n lies in row
// 16 warp + g + 8 (e >> 1), column 8 n + 2 q + (e & 1) of the warpgroup's
// 64-row tile.
struct Frag {
  int warp, g, q;
  __device__ int row(int e) const { return 16 * warp + g + 8 * (e >> 1); }
  __device__ int col(int n, int e) const { return 8 * n + 2 * q + (e & 1); }
};

// The two consumer warpgroups take turns at issuing their products, so
// that one computes its exponentials while the other's products run (named
// barriers 3 and 4, each shared by both warpgroups' 256 threads).  Warpgroup
// 0 goes first; each phase's `take` waits for the other warpgroup's `pass`
// of its previous phase.  Both run the same phases, and warpgroup 1 skips
// its last pass, so every barrier completes exactly.
struct WgTurns {
  int wg;
  __device__ explicit WgTurns(int w) : wg(w) {
    if (wg == 1) named_arrive(3, 2 * kWarpgroup);
  }
  __device__ void take() const { named_sync(3 + wg, 2 * kWarpgroup); }
  // predicated rather than branched: it sits between a product's issue and
  // its wait
  __device__ void pass(bool last) const {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p bar.arrive %0, %1;\n}\n"
        ::"r"(4 - wg), "r"(2 * kWarpgroup), "r"((int)!(last && wg == 1))
        : "memory");
  }
};

// A consumer warpgroup's walk over n streamed tiles of `ring`, in n + 1
// turns: turn t issues prev(stage of tile t - 1) (the products that
// contract over that tile's rows, from the operands compute() left in
// registers) and next(stage of tile t) (the products over Dh), waits for
// both (settle), releases tile t - 1's stage and runs compute(stage, t) on
// tile t's products.  The ring has carried t0 tiles before this walk (a
// persistent block's earlier work items), so tile t sits in stage
// (t0 + t) % STAGES.  The first and last turns are peeled, so that no
// product is issued or awaited under a condition (ptxas serialises wgmma on
// divergent paths): a warpgroup whose rows all lie past L computes on TMA's
// zero fill and stores nothing.
template <int STAGES, class Prev, class Next, class Settle, class Compute>
__device__ __forceinline__ void wg_walk(const Ring<STAGES>& ring, int n,
                                        int wg, Prev prev, Next next,
                                        Settle settle, Compute compute,
                                        int t0 = 0) {
  const WgTurns turns(wg);
  const bool signal = threadIdx.x % kWarp == 0;
  mbar_wait(ring.full(t0 % STAGES), (t0 / STAGES) & 1);
  turns.take();
  wgmma_fence();
  next(t0 % STAGES);
  wgmma_commit();
  turns.pass(false);
  settle();
  compute(t0 % STAGES, 0);
  for (int t = 1; t < n; ++t) {
    const int s = (t0 + t) % STAGES, sp = (t0 + t - 1) % STAGES;
    mbar_wait(ring.full(s), ((t0 + t) / STAGES) & 1);
    turns.take();
    wgmma_fence();
    prev(sp);
    next(s);
    wgmma_commit();
    turns.pass(false);
    settle();
    __syncwarp();
    if (signal) mbar_arrive(ring.empty(sp));
    compute(s, t);
  }
  const int sp = (t0 + n - 1) % STAGES;
  turns.take();
  wgmma_fence();
  prev(sp);
  wgmma_commit();
  turns.pass(true);
  settle();
  __syncwarp();
  if (signal) mbar_arrive(ring.empty(sp));
}

// Stores a warpgroup's 64 x 64 f32 result, rounded to bf16, to rows
// [row0, min(row0 + 64, n)) of `dst` (row stride `stride`).
__device__ __forceinline__ void store_rows(const float (&d)[32], bf16* dst,
                                           long long stride, int row0, int n,
                                           const Frag& f) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + f.row(2 * r);
    if (i < n)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + i * stride + f.col(c, 0)) =
            pack(d[4 * c + 2 * r], d[4 * c + 2 * r + 1]);
  }
}

// ------------------------------------------------------- host: tensor maps
// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query so that the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The current device's SM count (cudaDevAttrMultiProcessorCount), asked
// once a device: the grid of a persistent launch.  0 if it cannot be read.
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

// Error codes of the host side, beside CUDA's (all positive).
constexpr int kBadVariant = -2;    // wgmma asked for other than bf16, Dh 64
constexpr int kNoEncoder = -10;    // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = -11;  // it refused the map

// A bf16 [B, H, L, 64] head tensor with element strides (sb, sh, sl, 1) as
// a 4-D TMA map (64, L, H, B), box 64 x 64 rows, 128-byte swizzle, zero
// fill past L.  Returns 0 or an error code.
int encode_rows_map(CUtensorMap* map, const void* base, int batch, int heads,
                    int len, long long sb, long long sh, long long sl) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kNoEncoder;
  // The encoder is not a runtime-API call: it refuses the map on a thread
  // that no runtime call has yet bound to the device's context, as PyTorch's
  // autograd worker thread can be in a fresh process.  cudaFree(nullptr)
  // binds it, once a thread.
  static thread_local bool bound = false;
  if (!bound) {
    cudaFree(nullptr);
    bound = true;
  }
  const cuuint64_t dims[4] = {64, (cuuint64_t)len, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};  // bytes, dims 1-3
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

}  // namespace
