// The streamed flash forward on Hopper's wgmma and TMA: kernel 6 (tiled,
// flash_tiled_attention.cu, dropout head group head_group(H)) and kernel 4
// (chunked, flash_chunked_attention.cu, head group 2) for bf16 at Dh = 64
// with TMA-eligible q, k and v, in the semantics stated at the head of those
// files.  Each file wraps `wgmma_fwd` in its own __global__ function, so
// that a profile keeps the two kernels apart.
//
// What bounds it: at the high-resolution step's [8, 16, 2705, 64] kernel 6
// does 4 B H L^2 Dh = 240 GFLOP (0.242 ms at 989 TFLOP/s) on 89 MB, and
// B H L^2 = 0.94 G exponentials.  The SFU gives 16 ex2 a clock per SM,
// about as long as the products (~0.22-0.25 ms at 1.75-1.98 GHz), and each
// score also takes ~5 FP32 operations (the scale-and-subtract FMA, the max,
// the sum, the bf16 rounding).  So the forward nears the tensor-core rate
// only while one warpgroup's exponentials run under the other's products.
//
// The design, per block of 384 threads (three warpgroups) owning 128 query
// rows of one (b, h):
// - warpgroup 0 is the producer.  It gives registers back (setmaxnreg 40)
//   and one warp works: it loads the block's Q once by TMA (two boxes of
//   64 x 64, one per consumer; a box past L comes back zero-filled), then
//   streams 128-key tiles of K and V (two boxes each) through a ring of
//   kFwdStages stages with full and empty mbarriers.  Beside each stage it
//   writes the tile's 128 key-padding bits (keys at or past Lk, masked keys).
// - warpgroups 1 and 2 are consumers of 64 rows each.  Per key tile a
//   consumer issues S = Q·Kᵀ (four m64n128k16 wgmma from shared memory, so
//   the tile's whole 128-key S exists before any p is formed: the TPU kernel
//   rounds p against the running max of each 128-key tile), sets padded
//   keys to -inf with one select a score (only in a tile that has any),
//   takes the row max over the 128 keys, p = exp2(s·c - m·log2(e)) with c =
//   scale·log2(e) (one FFMA and ex2.approx; m, in natural-log units, is the
//   raw max times scale, exactly the max of the scaled scores), l += p, then
//   p *= keep, and rounds p to bf16 as the register A operand of O += P·V
//   (eight m64n64k16 wgmma, V read MN-major from the same stage).  The
//   dropout test is one branch a tile, never one a score.
// - the walk (hopper.cuh `wg_walk`) issues tile t's S with tile t - 1's
//   P·V in one turn, and the two consumers take turns at issuing, so one
//   computes its exponentials while the other's products run.  The first
//   and last turns are peeled, so no wgmma is issued or awaited under a
//   branch; a consumer whose rows all lie past L computes on the zero fill
//   and writes nothing.
// - the epilogue writes out = o / l (0 where l = 0: a row with no key) to
//   [B, L, H, Dh] storage and lse = m + log l (-inf there) to [B, H, Lq],
//   rows past L not written.  No atomics: a deterministic result.
//
// Resources: 16 KB of Q + kFwdStages x 32 KB of K and V tiles + the bits
// (~145 KB with the alignment slack); 168 registers a thread at launch (S
// 64, O 32, the previous tile's P 32 while the turn's products run).  One
// block (two consumer warpgroups) is resident per SM.  Overlapping a
// warpgroup's own softmax with its next S would need a second S (64 more
// registers), past what ptxas grants a 384-thread block.

#pragma once

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kFwdStages = 4;                        // K/V tiles in flight
constexpr int kFwdTileBytes = kTile * kTcDim * 2;    // one [128][64] bf16
constexpr int kFwdBoxes = kFwdTileBytes / kWgTileBytes;  // TMA boxes a tile
constexpr int kFwdPadWords = kTile / 32;             // padding bits a tile

// The tensor maps of q, k and v, each [B, H, L, 64] in boxes of 64 rows.
struct FwdMaps {
  CUtensorMap q, k, v;
};

// Offsets (bytes) from the 1024-byte aligned base of shared memory.
constexpr int kFwdQOff = 0;  // [consumer] Q box
constexpr int kFwdStageOff = kFwdQOff + kWgConsumers * kWgTileBytes;
constexpr int kFwdPadOff = kFwdStageOff + kFwdStages * 2 * kFwdTileBytes;
constexpr int kFwdBarOff = kFwdPadOff + kFwdStages * kFwdPadWords * 4;
constexpr int kFwdBars = 1 + 2 * kFwdStages;  // q, full[], empty[]

// Dynamic shared memory of a launch: the layout above, plus the slack that
// aligns its base to 1024 bytes.
constexpr size_t fwd_wgmma_smem_bytes() {
  return 1024 + kFwdBarOff + 8 * kFwdBars;
}

struct FwdSmem {
  uint32_t base;  // shared address of the aligned base
  uint8_t* ptr;   // its generic address
  __device__ uint32_t q(int wg) const {
    return base + kFwdQOff + wg * kWgTileBytes;
  }
  __device__ uint32_t k(int s) const {
    return base + kFwdStageOff + 2 * s * kFwdTileBytes;
  }
  __device__ uint32_t v(int s) const { return k(s) + kFwdTileBytes; }
  __device__ uint32_t* pad(int s) const {
    return reinterpret_cast<uint32_t*>(ptr + kFwdPadOff +
                                       s * kFwdPadWords * 4);
  }
  __device__ uint32_t q_bar() const { return base + kFwdBarOff; }
  __device__ Ring<kFwdStages> ring() const {
    return {base + kFwdBarOff + 8, base + kFwdBarOff + 8 + 8 * kFwdStages};
  }
};

// The producer warp: the block's Q, then every key tile's K and V boxes
// and padding bits into the ring.
__device__ __forceinline__ void fwd_produce(const FwdMaps& maps,
                                            const FwdSmem& sm,
                                            const Params& p, int b, int h,
                                            int row0, int n_tiles) {
  const int lane = threadIdx.x;
  const Ring<kFwdStages> ring = sm.ring();
  if (lane == 0) {
    mbar_arrive_expect_tx(sm.q_bar(), kWgConsumers * kWgTileBytes);
    for (int w = 0; w < kWgConsumers; ++w)
      tma_load_rows(&maps.q, sm.q(w), sm.q_bar(), row0 + w * kWgRows, h, b);
  }
  const unsigned char* mask =
      p.mask ? p.mask + (long long)b * p.lk : nullptr;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kFwdStages, j0 = t * kTile;
    mbar_wait(ring.empty(s), ((t / kFwdStages) & 1) ^ 1);
    uint32_t bits[kFwdPadWords];
#pragma unroll
    for (int w = 0; w < kFwdPadWords; ++w) {
      const int j = j0 + 32 * w + lane;
      bits[w] = __ballot_sync(0xffffffffu, j >= p.lk || (mask && mask[j]));
    }
    if (lane == 0) {
      uint32_t* pad = sm.pad(s);
#pragma unroll
      for (int w = 0; w < kFwdPadWords; ++w) pad[w] = bits[w];
      mbar_arrive_expect_tx(ring.full(s), 2 * kFwdTileBytes);
#pragma unroll
      for (int x = 0; x < kFwdBoxes; ++x) {
        tma_load_rows(&maps.k, sm.k(s) + x * kWgTileBytes, ring.full(s),
                      j0 + x * kWgRows, h, b);
        tma_load_rows(&maps.v, sm.v(s) + x * kWgTileBytes, ring.full(s),
                      j0 + x * kWgRows, h, b);
      }
    }
  }
}

// The forward body of kernels 4 and 6 (grid (B * H, ceil(Lq / 128)),
// kWgThreads threads).
__device__ __forceinline__ void wgmma_fwd(const FwdMaps& maps,
                                          const Params& p) {
  const SmemBase base = smem_base();
  const FwdSmem sm{base.base, base.ptr};
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kWgBlockRows;
  const int n_tiles = (p.lk + kTile - 1) / kTile;
  ring_init(sm.q_bar(), sm.ring(), 1);

  if (threadIdx.x < kWarpgroup) {  // ------------------------- producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x < kWarp) fwd_produce(maps, sm, p, b, h, row0, n_tiles);
    return;
  }

  regs_inc<kConsumerRegs>();  // ------------------------------ consumers
  const int wg = threadIdx.x / kWarpgroup - 1, t = threadIdx.x % kWarpgroup;
  const int lane = t % kWarp;
  const Frag f{t / kWarp, lane >> 2, lane & 3};
  const int wrow0 = row0 + wg * kWgRows;
  const float c = p.scale * kLog2e;
  const uint32_t qa = sm.q(wg);
  float o[32], sc[64];  // O (64 x 64), S then P (64 x 128 keys)
  uint32_t a[8][4];     // round(p) of the previous tile, A over its keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this
#pragma unroll                                  // thread's columns only
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  const TileHash hash(p.drop, b, h, p.hg);

  // p of key tile kt (its stage s) from S, rounded into a; O and l rescaled
  // to the new running max.  Padding and dropout are tested once a tile.
  auto softmax = [&](int s, int kt, auto drop, auto padded) {
    if constexpr (decltype(padded)::value) {
      const uint32_t* pad = sm.pad(s);
      uint32_t w[kFwdPadWords];
#pragma unroll
      for (int x = 0; x < kFwdPadWords; ++x) w[x] = pad[x] >> (2 * f.q);
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((w[n >> 2] >> (8 * (n & 3) + (e & 1))) & 1u)
            sc[4 * n + e] = -INFINITY;
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[4 * n + e]);
    float bias[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(tmax[r]) * p.scale);
      const float safe = m_new > -INFINITY ? m_new : 0.f;  // no key yet
      alpha[r] = exp2_approx((m[r] - safe) * kLog2e);     // 0 from -inf
      bias[r] = safe * kLog2e;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] *= alpha[(e >> 1) & 1];
    const int j0 = kt * kTile;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pij = exp2_approx(fmaf(sc[4 * n + e], c, -bias[r]));
        l[r] += pij;
        if constexpr (decltype(drop)::value)
          pij *= hash.keep(wrow0 + f.row(e), j0 + f.col(n, e));
        sc[4 * n + e] = pij;
      }
#pragma unroll
    for (int k = 0; k < 8; ++k) acc_to_a(sc, k, a[k]);
  };
  mbar_wait(sm.q_bar(), 0);
  wg_walk(
      sm.ring(), n_tiles, wg,
      [&](int sp) {  // O += P·V over the previous tile's keys
        fence_acc(o);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          wgmma_rs<1>(o, a[k], mnmajor_desc(sm.v(sp), k));
      },
      [&](int s) {  // S = Q·Kᵀ over the tile's 128 keys
        const uint32_t q = opaque(qa);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss128(sc, kmajor_desc(q, k), kmajor_desc(sm.k(s), k), k);
      },
      [&] {
        wgmma_wait<0>();
        fence_acc(o);
        fence_acc(sc);
        fence_a(a);
      },
      [&](int s, int kt) {
        const uint32_t* pad = sm.pad(s);
        bool any = false;
#pragma unroll
        for (int x = 0; x < kFwdPadWords; ++x) any |= pad[x] != 0u;
        if (p.drop.on) {
          if (any)
            softmax(s, kt, std::true_type(), std::true_type());
          else
            softmax(s, kt, std::true_type(), std::false_type());
        } else {
          if (any)
            softmax(s, kt, std::false_type(), std::true_type());
          else
            softmax(s, kt, std::false_type(), std::false_type());
        }
      });

  // out = o / l (0 for a row with no key), lse = m + log l (-inf there)
  const long long rows = ((long long)b * p.heads + h) * p.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const float safe = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[4 * n + 2 * r] /= safe;
      o[4 * n + 2 * r + 1] /= safe;
    }
    const int i = wrow0 + f.row(2 * r);
    if (f.q == 0 && i < p.lq)
      p.lse[rows + i] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
  }
  store_rows(o, static_cast<bf16*>(p.out) + b * p.sout.b + h * p.sout.h,
             p.sout.l, wrow0, p.lq, f);
}

// ------------------------------------------------------------------- host
// Launches `kernel` (a file's wrapper of wgmma_fwd) for bf16 q, k, v at
// Dh = 64 whose rows and outer strides are 16-byte aligned: builds the three
// tensor maps from Params' strides and launches the grid (B * H, blocks of
// 128 query rows).  Returns 0, a CUDA error, or a negative code of
// hopper.cuh's map encoding.
template <class Kernel>
int launch_wgmma_fwd(Kernel kernel, const Params& p, int batch,
                     cudaStream_t stream) {
  FwdMaps maps;
  int rc = encode_rows_map(&maps.q, p.q, batch, p.heads, p.lq, p.sq.b,
                           p.sq.h, p.sq.l);
  if (rc == 0)
    rc = encode_rows_map(&maps.k, p.k, batch, p.heads, p.lk, p.sk.b, p.sk.h,
                         p.sk.l);
  if (rc == 0)
    rc = encode_rows_map(&maps.v, p.v, batch, p.heads, p.lk, p.sv.b, p.sv.h,
                         p.sv.l);
  if (rc != 0) return rc;
  const int smem = (int)fwd_wgmma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(batch * p.heads, (p.lq + kWgBlockRows - 1) / kWgBlockRows),
           kWgThreads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace
