// The streamed flash backward on Hopper's wgmma and TMA: the dq pass and the
// dk/dv pass for bf16 at Dh = 64 with TMA-eligible views, in the semantics
// stated at the head of flash_tiled_attention.cu.  The tiled kernels 7 and 8
// (flash_tiled_attention.cu, dropout head group head_group(H)) and the
// chunked kernel 5's two launches (flash_chunked_attention.cu, head group 2
// or 1) run these bodies; each file wraps `wgmma_dq` and `wgmma_dkv` in
// __global__ functions of its own, so that a profile keeps them apart.
//
// What bounds them: operations.  The dq pass does 3 and the dk/dv pass 4
// products of 2 B H L^2 Dh: at the high-resolution step's [8, 16, 2705, 64]
// 120 GFLOP each (0.364 and 0.485 ms at 989 TFLOP/s) on ~89 MB, at the
// long-sequence step's [32, 16, 577, 64] 22 GFLOP each (0.066 and 0.088 ms)
// on ~76 MB.  Beside the products every score takes an exp2, a few FMAs and
// a rounding.
//
// The design, per block of 384 threads (three warpgroups).  A work item is
// 128 rows of one (b, h) (queries for the dq pass, keys for the dk/dv pass).
// - warpgroup 0 is the producer.  It gives registers back (setmaxnreg 40)
//   and one warp works.  Per item it loads the item's own rows once by TMA
//   into one of two own-row buffers (Q, G and the forward's output O, or K
//   and V; boxes of 64 x 64; a box wholly past L comes back zero-filled),
//   with a side row beside them (the rows' lse·log2(e), or the keys'
//   padding bits), then streams the other side's tiles of 64 rows (K, V or
//   Q, G) through a ring of kWgStages stages with full and empty mbarriers.
//   Beside each tile it writes a side row: the tile's 64 key-padding bits
//   (dq pass) or its rows' lse·log2(e) and delta (dk/dv pass; +inf for a
//   row past Lq or with lse = -inf, so that p = exp2(s·c - lse2) = 0 there).
// - warpgroups 1 and 2 are consumers of 64 rows each.  Per streamed tile a
//   consumer issues two wgmma chains from shared memory (S = Q·Kᵀ and
//   dP = G·Vᵀ, or Sᵀ = K·Qᵀ and dPᵀ = V·Gᵀ), computes p = exp2(s·c - lse2)
//   (one FFMA and ex2.approx), ds (and pd) per element in registers, rounds
//   them to bf16 as register A operands, and issues dQ += dS·K (or
//   dV += Pdᵀ·G and dK += dSᵀ·Q) with B read transposed from the same tile.
//   The dq pass issues a tile's dQ product together with the next tile's S
//   and dP; the dk/dv pass drains its dK/dV products first, since 168
//   registers do not hold both tiles' operands.  The two consumers take
//   turns at issuing (hopper.cuh's wg_walk), so one computes its
//   exponentials while the other's products run.  The dropout test is one
//   branch a tile.
// - the dq pass first computes delta = rowsum(g·out) (f32) for its rows
//   from the own G and O tiles in shared memory and writes it for the dk/dv
//   pass.
// - the schedule is persistent: the grid is one block per SM (or one per
//   item, when there are fewer), and block x takes items x, x + grid, ... in
//   that fixed order, rows fastest, so the blocks at work at one time share
//   a head's streamed tiles in L2.  The ring and the two own-row buffers
//   carry across items: while the consumers finish item n's last tiles and
//   store its result, the producer has already loaded item n + 1's own
//   rows and side row and keeps the ring full with its first tiles, so a
//   block's fixed cost (the own-row loads, lse and the padding of the own
//   rows, the ring's fill, the launch) is paid once a launch rather than
//   once an item.  A consumer releases its own-row buffer after its last
//   product of the item; the producer waits for that before it reuses the
//   buffer for item n + 2.  The launch can also take a grid of one block an
//   item (each block then walks one item): the tiled file times both.
// - the ragged edge: an item is 128 rows, two consumers of 64, because the
//   two consumers share the streamed tiles of their (b, h).  At L = 577 =
//   9 · 64 + 1 the last item gives its second consumer one row, a full walk
//   for one row.  Items of 64 rows would not help: a head still needs
//   ceil(577 / 64) = 10 consumer walks of 64 rows (m64 is wgmma's least
//   height) whatever pairs them, and pairing consumers of different heads
//   would need a ring each.  So the waste stays at 63 of 640 rows a head
//   (10%), the same as the padding of the streamed side's last tile.
// Rows past L are zero-filled by TMA and keys past Lk are padding, so
// nothing is padded in device memory; outputs go to [B, L, H, Dh] storage,
// rows past L not written.  Each output row is summed by one block in f32
// in registers and rounded once: no atomics, a deterministic result.  The
// dropout mask is regenerated per element from the accumulator's (row,
// column) with absolute indices, so the 64-row tiles change nothing of it.
//
// Resources: two own-row buffers (dq: 3 x 16 KB each; dk/dv: 2 x 16 KB) + 4
// stages x 16.5 KB + the side rows (164.6 KB / 132.6 KB with the alignment
// slack); 168 registers a thread, no spills.  ptxas allocates the consumers
// within the launch's 168 (setmaxnreg moves the registers at run time but
// does not raise what ptxas allocates), which is what bounds the tiles at
// 64 x 64.  One block (two consumer warpgroups) is resident per SM.  Why not
// other shapes: 128-key tiles would need 64 more accumulator registers a
// consumer; two 64-row blocks per SM would need twice the threads at the
// same registers.

#pragma once

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWgStages = 4;                   // streamed tiles' ring
constexpr int kWgSideBytes = 2 * kWgRows * 4;  // lse2 + delta rows
constexpr int kOwnSideBytes = kWgBlockRows * 4;  // own rows' lse2 or bits

// The tensor maps of a pass and its number of work items.  Dq pass: Q, G,
// O own, K, V streamed; dk/dv: K, V own (own2 unused), Q, G streamed.
struct WgMaps {
  CUtensorMap own0, own1, own2, str0, str1;
  int items;  // B * H * ceil(own rows / kWgBlockRows)
};

// Shared memory of a pass with OPS own operands, as offsets (bytes) from the
// 1024-byte aligned base: two own-row buffers [buf][operand][consumer], the
// ring's stages [stage][operand], the ring's side rows, the own buffers'
// side rows, the dq pass's delta rows, then the barriers own_full[2],
// own_empty[2], full[kWgStages], empty[kWgStages].
template <int OPS>
struct BwdLayout {
  static constexpr int kOwnBuf = OPS * kWgConsumers * kWgTileBytes;
  static constexpr int kStage = 2 * kOwnBuf;
  static constexpr int kSide = kStage + kWgStages * 2 * kWgTileBytes;
  static constexpr int kOwnSide = kSide + kWgStages * kWgSideBytes;
  static constexpr int kDelta = kOwnSide + 2 * kOwnSideBytes;
  static constexpr int kBar = kDelta + kWgBlockRows * 4;
  static constexpr int kBars = 4 + 2 * kWgStages;
  // dynamic shared memory of a launch, with the slack that aligns its base
  // to 1024 bytes (the 128-byte swizzle's period)
  static constexpr size_t kBytes = 1024 + kBar + 8 * kBars;
};

constexpr int kDqOps = 3, kDkvOps = 2;

// Dynamic shared memory of pass `which` (1: dq, 2: dk/dv).
constexpr size_t wgmma_smem_bytes(int which) {
  return which == 1 ? BwdLayout<kDqOps>::kBytes : BwdLayout<kDkvOps>::kBytes;
}

template <int OPS>
struct BwdSmem {
  using L = BwdLayout<OPS>;
  uint32_t base;  // shared address of the aligned base
  uint8_t* ptr;   // its generic address
  __device__ uint32_t own(int buf, int operand, int wg) const {
    return base + ((buf * OPS + operand) * kWgConsumers + wg) * kWgTileBytes;
  }
  __device__ const uint8_t* own_ptr(int buf, int operand, int wg) const {
    return ptr + (own(buf, operand, wg) - base);
  }
  __device__ uint32_t stage(int s, int operand) const {
    return base + L::kStage + (2 * s + operand) * kWgTileBytes;
  }
  __device__ float* side(int s) const {
    return reinterpret_cast<float*>(ptr + L::kSide + s * kWgSideBytes);
  }
  __device__ float* own_side(int buf) const {
    return reinterpret_cast<float*>(ptr + L::kOwnSide + buf * kOwnSideBytes);
  }
  __device__ float* delta_rows() const {
    return reinterpret_cast<float*>(ptr + L::kDelta);
  }
  __device__ uint32_t own_full(int buf) const {
    return base + L::kBar + 8 * buf;
  }
  __device__ uint32_t own_empty(int buf) const {
    return base + L::kBar + 16 + 8 * buf;
  }
  __device__ Ring<kWgStages> ring() const {
    return {base + L::kBar + 32, base + L::kBar + 32 + 8 * kWgStages};
  }
};

// Barrier set-up by thread 0: own_full takes the producer warp's 32
// arrivals (one with the TMA bytes), own_empty one arrival per consumer
// warp, the ring's full barriers `full_count` arrivals of the producer and
// its empty ones one per consumer warp.
template <int OPS>
__device__ __forceinline__ BwdSmem<OPS> bwd_init(int full_count) {
  const SmemBase sb = smem_base();
  const BwdSmem<OPS> sm{sb.base, sb.ptr};
  if (threadIdx.x == 0) {
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(sm.own_full(buf), kWarp);
      mbar_init(sm.own_empty(buf), kWgConsumers * kWarpgroup / kWarp);
    }
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(sm.ring().full(s), full_count);
      mbar_init(sm.ring().empty(s), kWgConsumers * kWarpgroup / kWarp);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return sm;
}

// A work item: 128 own rows from row0 of (b, h); rows fastest.
struct Item {
  int b, h, row0;
  __device__ Item(int item, int heads, int own_len) {
    const int blocks = (own_len + kWgBlockRows - 1) / kWgBlockRows;
    const int bh = item / blocks;
    b = bh / heads;
    h = bh % heads;
    row0 = (item % blocks) * kWgBlockRows;
  }
};

// The producer warp's own-row loads of item `it` into buffer `buf`: OPS
// operands for each consumer warpgroup (a box wholly past the tensor's end
// is zero-filled).  Lane 0 alone; it arrives on own_full with the bytes.
template <int OPS>
__device__ __forceinline__ void load_own(const WgMaps& maps,
                                         const BwdSmem<OPS>& sm, int buf,
                                         const Item& it) {
  const CUtensorMap* map[3] = {&maps.own0, &maps.own1, &maps.own2};
  mbar_arrive_expect_tx(sm.own_full(buf), OPS * kWgConsumers * kWgTileBytes);
#pragma unroll
  for (int w = 0; w < kWgConsumers; ++w)
#pragma unroll
    for (int op = 0; op < OPS; ++op)
      tma_load_rows(map[op], sm.own(buf, op, w), sm.own_full(buf),
                    it.row0 + w * kWgRows, it.h, it.b);
}

// ------------------------------------------------- the dq pass: delta, dq
__device__ __forceinline__ void wgmma_dq(const WgMaps& maps, const Params& p) {
  const BwdSmem<kDqOps> sm = bwd_init<kDqOps>(1);
  const int n_tiles = (p.lk + kWgRows - 1) / kWgRows;

  if (threadIdx.x < kWarpgroup) {  // ------------------------- producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x >= kWarp) return;
    const int lane = threadIdx.x;
    int t = 0;  // streamed tiles so far, over the block's items
    for (int item = blockIdx.x, n = 0; item < maps.items;
         item += gridDim.x, ++n) {
      const Item it(item, p.heads, p.lq);
      const int buf = n & 1;
      const long long rows = ((long long)it.b * p.heads + it.h) * p.lq;
      mbar_wait(sm.own_empty(buf), ((n >> 1) & 1) ^ 1);
      float* side = sm.own_side(buf);
#pragma unroll
      for (int x = 0; x < kWgBlockRows / kWarp; ++x) {
        const int r = kWarp * x + lane, i = it.row0 + r;
        const float l = i < p.lq ? p.lse[rows + i] : -INFINITY;
        side[r] = finite(l) ? l * kLog2e : INFINITY;  // p = 0 on such a row
      }
      if (lane == 0)
        load_own(maps, sm, buf, it);
      else
        mbar_arrive(sm.own_full(buf));
      const unsigned char* mask =
          p.mask ? p.mask + (long long)it.b * p.lk : nullptr;
      for (int kt = 0; kt < n_tiles; ++kt, ++t) {
        const int s = t % kWgStages, j0 = kt * kWgRows;
        mbar_wait(sm.ring().empty(s), ((t / kWgStages) & 1) ^ 1);
        uint32_t bits[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = j0 + 32 * half + lane;
          bits[half] =
              __ballot_sync(0xffffffffu, j >= p.lk || (mask && mask[j]));
        }
        if (lane == 0) {
          uint32_t* pad = reinterpret_cast<uint32_t*>(sm.side(s));
          pad[0] = bits[0];
          pad[1] = bits[1];
          mbar_arrive_expect_tx(sm.ring().full(s), 2 * kWgTileBytes);
          tma_load_rows(&maps.str0, sm.stage(s, 0), sm.ring().full(s), j0,
                        it.h, it.b);
          tma_load_rows(&maps.str1, sm.stage(s, 1), sm.ring().full(s), j0,
                        it.h, it.b);
        }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();  // ------------------------------ consumers
  const int wg = threadIdx.x / kWarpgroup - 1, t = threadIdx.x % kWarpgroup;
  const int lane = t % kWarp;
  const Frag f{t / kWarp, lane >> 2, lane & 3};
  const float c = p.scale * kLog2e;
  float* delta_rows = sm.delta_rows() + wg * kWgRows;
  for (int item = blockIdx.x, n = 0; item < maps.items;
       item += gridDim.x, ++n) {
    const Item it(item, p.heads, p.lq);
    const int buf = n & 1, wrow0 = it.row0 + wg * kWgRows;
    mbar_wait(sm.own_full(buf), (n >> 1) & 1);

    // delta = rowsum(g * out) from the own G and O tiles: two threads a
    // row, 32 features each, read through the 128-byte swizzle (16-byte
    // chunk c of row r at chunk c ^ (r % 8)); 0 past Lq (the zero fill)
    {
      const int r = t / 2, half = t & 1;
      const uint8_t* gr = sm.own_ptr(buf, 1, wg) + r * 128;
      const uint8_t* orow = sm.own_ptr(buf, 2, wg) + r * 128;
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int chunk = ((4 * half + u) ^ (r & 7)) * 16;
        const uint4 gv = *reinterpret_cast<const uint4*>(gr + chunk);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + chunk);
        const bf16* ge = reinterpret_cast<const bf16*>(&gv);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int x = 0; x < 8; ++x)
          part = fmaf(__bfloat162float(ge[x]), __bfloat162float(oe[x]), part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const int i = wrow0 + r;
      if (half == 0) {
        delta_rows[r] = part;
        if (i < p.lq)
          p.delta[((long long)it.b * p.heads + it.h) * p.lq + i] = part;
      }
    }
    named_sync(1 + wg, kWarpgroup);
    float delta[2], lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] = delta_rows[f.row(2 * r)];
      lse2[r] = sm.own_side(buf)[wg * kWgRows + f.row(2 * r)];
    }

    const uint32_t qa = sm.own(buf, 0, wg), ga = sm.own(buf, 1, wg);
    float dq[32], sc[32], dp[32];
    uint32_t a[4][4];  // round(ds) of the previous tile, A over its keys
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] = 0.f;
    const TileHash hash(p.drop, it.b, it.h, p.hg);
    // ds of tile kt (its stage s) from S and dP, rounded into a; the
    // dropout test is made once a tile, not once a score
    auto ds_tile = [&](int s, int kt, auto drop) {
      const int j0 = kt * kWgRows;
      const uint32_t* pad = reinterpret_cast<const uint32_t*>(sm.side(s));
      const uint32_t pad0 = pad[0] >> (2 * f.q), pad1 = pad[1] >> (2 * f.q);
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool padded =
              ((nn < 4 ? pad0 : pad1) >> (8 * (nn % 4) + (e & 1))) & 1u;
          const float pij = exp2_approx(fmaf(sc[4 * nn + e], c, -lse2[r]));
          float dpv = dp[4 * nn + e];
          if constexpr (decltype(drop)::value)
            dpv *= hash.keep(wrow0 + f.row(e), j0 + f.col(nn, e));
          const float ds = pij * (dpv - delta[r]) * p.scale;
          sc[4 * nn + e] = padded ? 0.f : ds;
        }
#pragma unroll
      for (int k = 0; k < 4; ++k) acc_to_a(sc, k, a[k]);
    };
    wg_walk(
        sm.ring(), n_tiles, wg,
        [&](int sp) {  // dQ += dS·K over the previous tile's keys
          fence_acc(dq);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_rs<1>(dq, a[k], mnmajor_desc(sm.stage(sp, 0), k));
        },
        [&](int s) {  // S = Q·Kᵀ, dP = G·Vᵀ
          const uint32_t q = opaque(qa), g = opaque(ga);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_ss<0>(sc, kmajor_desc(q, k),
                        kmajor_desc(sm.stage(s, 0), k), k);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_ss<0>(dp, kmajor_desc(g, k),
                        kmajor_desc(sm.stage(s, 1), k), k);
        },
        [&] {
          wgmma_wait<0>();
          fence_acc(dq);
          fence_acc(sc);
          fence_acc(dp);
          fence_a(a);
        },
        [&](int s, int kt) {  // ds, rounded into a
          if (p.drop.on)
            ds_tile(s, kt, std::true_type());
          else
            ds_tile(s, kt, std::false_type());
        },
        n * n_tiles);
    // the item's products are done: its own rows may be overwritten
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.own_empty(buf));
    store_rows(dq,
               static_cast<bf16*>(p.out) + it.b * p.sout.b + it.h * p.sout.h,
               p.sout.l, wrow0, p.lq, f);
  }
}

// --------------------------------------------------- the dk/dv pass
__device__ __forceinline__ void wgmma_dkv(const WgMaps& maps,
                                          const Params& p) {
  const BwdSmem<kDkvOps> sm = bwd_init<kDkvOps>(kWarp);
  const int n_tiles = (p.lq + kWgRows - 1) / kWgRows;

  if (threadIdx.x < kWarpgroup) {  // ------------------------- producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x >= kWarp) return;
    const int lane = threadIdx.x;
    int t = 0;  // streamed tiles so far, over the block's items
    for (int item = blockIdx.x, n = 0; item < maps.items;
         item += gridDim.x, ++n) {
      const Item it(item, p.heads, p.lk);
      const int buf = n & 1;
      const long long rows = ((long long)it.b * p.heads + it.h) * p.lq;
      mbar_wait(sm.own_empty(buf), ((n >> 1) & 1) ^ 1);
      // the own keys' padding bits, 32 a word
      const unsigned char* mask =
          p.mask ? p.mask + (long long)it.b * p.lk : nullptr;
      uint32_t bits[kWgBlockRows / kWarp];
#pragma unroll
      for (int x = 0; x < kWgBlockRows / kWarp; ++x) {
        const int j = it.row0 + kWarp * x + lane;
        bits[x] = __ballot_sync(0xffffffffu, j >= p.lk || (mask && mask[j]));
      }
      if (lane == 0) {
        uint32_t* words = reinterpret_cast<uint32_t*>(sm.own_side(buf));
#pragma unroll
        for (int x = 0; x < kWgBlockRows / kWarp; ++x) words[x] = bits[x];
        load_own(maps, sm, buf, it);
      } else {
        mbar_arrive(sm.own_full(buf));
      }
      for (int qt = 0; qt < n_tiles; ++qt, ++t) {
        const int s = t % kWgStages, i0 = qt * kWgRows;
        mbar_wait(sm.ring().empty(s), ((t / kWgStages) & 1) ^ 1);
        float* side = sm.side(s);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int il = 32 * half + lane, i = i0 + il;
          const float l = i < p.lq ? p.lse[rows + i] : -INFINITY;
          side[il] = finite(l) ? l * kLog2e : INFINITY;  // p = 0 there
          side[kWgRows + il] = i < p.lq ? p.delta[rows + i] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(sm.ring().full(s), 2 * kWgTileBytes);
          tma_load_rows(&maps.str0, sm.stage(s, 0), sm.ring().full(s), i0,
                        it.h, it.b);
          tma_load_rows(&maps.str1, sm.stage(s, 1), sm.ring().full(s), i0,
                        it.h, it.b);
        } else {
          mbar_arrive(sm.ring().full(s));
        }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();  // ------------------------------ consumers
  const int wg = threadIdx.x / kWarpgroup - 1, t = threadIdx.x % kWarpgroup;
  const int lane = t % kWarp;
  const Frag f{t / kWarp, lane >> 2, lane & 3};
  const float c = p.scale * kLog2e;
  for (int item = blockIdx.x, n = 0; item < maps.items;
       item += gridDim.x, ++n) {
    const Item it(item, p.heads, p.lk);
    const int buf = n & 1, wrow0 = it.row0 + wg * kWgRows;
    mbar_wait(sm.own_full(buf), (n >> 1) & 1);
    const uint32_t* words = reinterpret_cast<const uint32_t*>(
        sm.own_side(buf));
    bool padded[2];
    int key[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int local = wg * kWgRows + f.row(2 * r);
      key[r] = it.row0 + local;
      padded[r] = (words[local / kWarp] >> (local % kWarp)) & 1u;
    }

    const uint32_t ka = sm.own(buf, 0, wg), va = sm.own(buf, 1, wg);
    float dk[32], dv[32], st[32], dpt[32];  // Sᵀ, dPᵀ: rows keys, cols
    uint32_t apd[4][4], ads[4][4];  // queries; round(pd), round(ds) of the
#pragma unroll                      // previous tile
    for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;
    const TileHash hash(p.drop, it.b, it.h, p.hg);
    // pd and ds of query tile qt (its stage s) from Sᵀ and dPᵀ, rounded
    // into apd and ads; the dropout test is made once a tile
    auto pd_ds_tile = [&](int s, int qt, auto drop) {
      const int i0 = qt * kWgRows;
      const float* lse_s = sm.side(s);
      const float* delta_s = lse_s + kWgRows;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_s + f.col(nn, 0));
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta_s + f.col(nn, 0));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float pij =
              exp2_approx(fmaf(st[4 * nn + e], c, -((e & 1) ? l2.y : l2.x)));
          float pd = pij, dpv = dpt[4 * nn + e];
          if constexpr (decltype(drop)::value) {
            const float keep = hash.keep(i0 + f.col(nn, e), key[r]);
            pd *= keep;
            dpv *= keep;
          }
          const float ds = pij * (dpv - ((e & 1) ? d2.y : d2.x)) * p.scale;
          st[4 * nn + e] = padded[r] ? 0.f : pd;
          dpt[4 * nn + e] = padded[r] ? 0.f : ds;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc_to_a(st, k, apd[k]);
        acc_to_a(dpt, k, ads[k]);
      }
    };
    wg_walk(
        sm.ring(), n_tiles, wg,
        [&](int sp) {  // dV += Pdᵀ·G, dK += dSᵀ·Q over the previous
                       // queries, drained before Sᵀ and dPᵀ take registers:
                       // 168 do not hold dK, dV, Sᵀ, dPᵀ and the two A
                       // operands at once
          fence_acc(dv);
          fence_acc(dk);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_rs<1>(dv, apd[k], mnmajor_desc(sm.stage(sp, 1), k));
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_rs<1>(dk, ads[k], mnmajor_desc(sm.stage(sp, 0), k));
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(dv);
          fence_acc(dk);
          fence_a(apd);
          fence_a(ads);
          wgmma_fence();
        },
        [&](int s) {  // Sᵀ = K·Qᵀ, dPᵀ = V·Gᵀ
          const uint32_t kt = opaque(ka), vt = opaque(va);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_ss<0>(st, kmajor_desc(kt, k),
                        kmajor_desc(sm.stage(s, 0), k), k);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_ss<0>(dpt, kmajor_desc(vt, k),
                        kmajor_desc(sm.stage(s, 1), k), k);
        },
        [&] {
          wgmma_wait<0>();
          fence_acc(st);
          fence_acc(dpt);
        },
        [&](int s, int qt) {  // pd and ds, rounded into apd and ads
          if (p.drop.on)
            pd_ds_tile(s, qt, std::true_type());
          else
            pd_ds_tile(s, qt, std::false_type());
        },
        n * n_tiles);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.own_empty(buf));
    store_rows(dk, static_cast<bf16*>(p.dk) + it.b * p.sdk.b + it.h * p.sdk.h,
               p.sdk.l, wrow0, p.lk, f);
    store_rows(dv, static_cast<bf16*>(p.dv) + it.b * p.sdv.b + it.h * p.sdv.h,
               p.sdv.l, wrow0, p.lk, f);
  }
}

// ------------------------------------------------------------------- host
// Launches `kernel` (a file's wrapper of wgmma_dq, which = 1, or wgmma_dkv,
// which = 2) with bf16 operands at Dh = 64 whose rows and outer strides are
// 16-byte aligned: builds the tensor maps from Params' strides and launches
// one block per SM (`persistent`; fewer when there are fewer items) or one
// block per item.  Returns 0, a CUDA error, or a negative code of
// hopper.cuh's map encoding.
template <class Kernel>
int launch_wgmma_bwd(Kernel kernel, int which, const Params& p, int batch,
                     bool persistent, cudaStream_t stream) {
  const bool dq = which == 1;
  const int own_len = dq ? p.lq : p.lk, str_len = dq ? p.lk : p.lq;
  const void* own[3] = {dq ? p.q : p.k, dq ? p.g : p.v, p.o};
  const void* str[2] = {dq ? p.k : p.q, dq ? p.v : p.g};
  const Strides own_s[3] = {dq ? p.sq : p.sk, dq ? p.sg : p.sv, p.so};
  const Strides str_s[2] = {dq ? p.sk : p.sq, dq ? p.sv : p.sg};
  WgMaps maps = {};
  CUtensorMap* m[5] = {&maps.own0, &maps.own1, &maps.own2, &maps.str0,
                       &maps.str1};
  for (int t = 0; t < 5; ++t) {
    if (t == 2 && !dq) continue;  // the dk/dv pass has two own operands
    const Strides& st = t < 3 ? own_s[t] : str_s[t - 3];
    const int rc = encode_rows_map(m[t], t < 3 ? own[t] : str[t - 3], batch,
                                   p.heads, t < 3 ? own_len : str_len, st.b,
                                   st.h, st.l);
    if (rc != 0) return rc;
  }
  maps.items =
      batch * p.heads * ((own_len + kWgBlockRows - 1) / kWgBlockRows);
  int grid = maps.items;
  if (persistent) {
    const int sms = sm_count();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    grid = grid < sms ? grid : sms;
  }
  const int smem = (int)wgmma_smem_bytes(which);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kWgThreads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace
