// The streamed flash backward on Hopper's wgmma and TMA: the dq pass
// (kernel 7) and the dk/dv pass (kernel 8) of flash_tiled_attention.cu for
// bf16 at Dh = 64 with 16-byte aligned rows, in the semantics stated at the
// head of that file (the chunked kernel 5 runs the same passes at another
// head group and may take these bodies later).
//
// What bounds them: operations.  At the high-resolution step's
// [8, 16, 2705, 64] the dq pass does 3 and the dk/dv pass 4 products of
// 2 B H L^2 Dh = 120 GFLOP (0.364 and 0.485 ms at 989 TFLOP/s) on ~89 MB.
// Beside the products every score takes an exp2, a few FMAs and a rounding.
//
// The design, per block of 384 threads (three warpgroups) owning 128 rows of
// one (b, h) (queries for the dq pass, keys for the dk/dv pass):
// - warpgroup 0 is the producer.  It gives registers back (setmaxnreg 40)
//   and one warp works: it loads the block's own rows of two operands once
//   by TMA (Q, G or K, V; 4 boxes of 64 x 64; a box wholly past L comes back
//   zero-filled), then streams the other side's tiles of 64 rows (K, V or
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
// - the dq pass first computes delta = rowsum(g·out) (f32, 16-byte loads of
//   the kernel's own rounded output) for its rows and writes it for the
//   dk/dv pass.
// Rows past L are zero-filled by TMA and keys past Lk are padding, so
// nothing is padded in device memory; outputs go to [B, L, H, Dh] storage,
// rows past L not written.  Each block sums its rows' outputs in f32 in
// registers and rounds once: no atomics, a deterministic result.  The
// dropout mask is regenerated per element from the accumulator's (row,
// column) with absolute indices, so the 64-row tiles change nothing of it.
//
// Resources: shared memory 32 KB of own rows + 4 stages x 16.5 KB (99.6 KB
// with the alignment slack); 168 registers a thread, no spills.  ptxas
// allocates the consumers within the launch's 168 (setmaxnreg moves the
// registers at run time but does not raise what ptxas allocates), which is
// what bounds the tiles at 64 x 64.  One block (two consumer warpgroups) is
// resident per SM.  Why not other shapes: 128-key tiles would need 64 more
// accumulator registers a consumer; two 64-row blocks per SM would need
// twice the threads at the same registers.

#pragma once

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWgStages = 4;                   // streamed tiles' ring
constexpr int kWgSideBytes = 2 * kWgRows * 4;  // lse2 + delta rows

// The tensor maps of a pass: the block's own rows (two operands) and the
// streamed ones.  Dq pass: Q, G own, K, V streamed; dk/dv: K, V own, Q, G.
struct WgMaps {
  CUtensorMap own0, own1, str0, str1;
};

// Offsets (bytes) from the 1024-byte aligned base of shared memory.
constexpr int kOwnOff = 0;  // [operand][consumer] tiles
constexpr int kStageOff = kOwnOff + 2 * kWgConsumers * kWgTileBytes;
constexpr int kSideOff = kStageOff + kWgStages * 2 * kWgTileBytes;
constexpr int kDeltaOff = kSideOff + kWgStages * kWgSideBytes;
constexpr int kBarOff = kDeltaOff + kWgBlockRows * 4;
constexpr int kBars = 1 + 2 * kWgStages;  // own, full[], empty[]

// Dynamic shared memory of a launch: the layout above, plus the slack that
// aligns its base to 1024 bytes (the 128-byte swizzle's period).
constexpr size_t wgmma_smem_bytes() { return 1024 + kBarOff + 8 * kBars; }

struct WgSmem {
  uint32_t base;    // shared address of the aligned base
  uint8_t* ptr;     // its generic address
  __device__ uint32_t own(int operand, int wg) const {
    return base + kOwnOff + (operand * kWgConsumers + wg) * kWgTileBytes;
  }
  __device__ uint32_t stage(int s, int operand) const {
    return base + kStageOff + (2 * s + operand) * kWgTileBytes;
  }
  __device__ float* side(int s) const {
    return reinterpret_cast<float*>(ptr + kSideOff + s * kWgSideBytes);
  }
  __device__ float* delta_rows() const {
    return reinterpret_cast<float*>(ptr + kDeltaOff);
  }
  __device__ uint32_t own_bar() const { return base + kBarOff; }
  __device__ Ring<kWgStages> ring() const {
    return {base + kBarOff + 8, base + kBarOff + 8 + 8 * kWgStages};
  }
  __device__ uint32_t full(int s) const { return ring().full(s); }
  __device__ uint32_t empty(int s) const { return ring().empty(s); }
};

__device__ __forceinline__ WgSmem wg_smem() {
  const SmemBase sm = smem_base();
  return {sm.base, sm.ptr};
}

// Barrier set-up: the empty barriers take one arrival per consumer warp,
// the full ones `full_count` (the producer's lanes that write the side row).
__device__ __forceinline__ void wg_init(const WgSmem& sm, int full_count) {
  ring_init(sm.own_bar(), sm.ring(), full_count);
}

// The producer warp's own-row loads: two operands for each consumer
// warpgroup (a box wholly past the tensor's end is zero-filled).
__device__ __forceinline__ void load_own(const WgMaps& maps, const WgSmem& sm,
                                         int row0, int h, int b) {
  mbar_arrive_expect_tx(sm.own_bar(), kWgConsumers * 2 * kWgTileBytes);
  for (int w = 0; w < kWgConsumers; ++w) {
    tma_load_rows(&maps.own0, sm.own(0, w), sm.own_bar(), row0 + w * kWgRows,
                  h, b);
    tma_load_rows(&maps.own1, sm.own(1, w), sm.own_bar(), row0 + w * kWgRows,
                  h, b);
  }
}

// --------------------------------------------- kernel 7: delta and dq
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_dq_kernel(__grid_constant__ const WgMaps maps, const Params p) {
  const WgSmem sm = wg_smem();
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kWgBlockRows;
  const int n_tiles = (p.lk + kWgRows - 1) / kWgRows;
  wg_init(sm, 1);

  if (threadIdx.x < kWarpgroup) {  // ------------------------- producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x >= kWarp) return;
    const int lane = threadIdx.x;
    if (lane == 0) load_own(maps, sm, row0, h, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kWgStages, j0 = t * kWgRows;
      mbar_wait(sm.empty(s), ((t / kWgStages) & 1) ^ 1);
      uint32_t bits[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = j0 + 32 * half + lane;
        bits[half] = __ballot_sync(
            0xffffffffu,
            j >= p.lk || (p.mask && p.mask[(long long)b * p.lk + j]));
      }
      if (lane == 0) {
        uint32_t* pad = reinterpret_cast<uint32_t*>(sm.side(s));
        pad[0] = bits[0];
        pad[1] = bits[1];
        mbar_arrive_expect_tx(sm.full(s), 2 * kWgTileBytes);
        tma_load_rows(&maps.str0, sm.stage(s, 0), sm.full(s), j0, h, b);
        tma_load_rows(&maps.str1, sm.stage(s, 1), sm.full(s), j0, h, b);
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();  // ------------------------------ consumers
  const int wg = threadIdx.x / kWarpgroup - 1, t = threadIdx.x % kWarpgroup;
  const int lane = t % kWarp;
  const Frag f{t / kWarp, lane >> 2, lane & 3};
  const int wrow0 = row0 + wg * kWgRows;
  const long long rows = ((long long)b * p.heads + h) * p.lq;

  // delta = rowsum(g * out): two threads a row, 32 features each
  float* delta_rows = sm.delta_rows() + wg * kWgRows;
  {
    const int i = wrow0 + t / 2;
    float part = 0.f;
    if (i < p.lq) {
      const bf16* gr = static_cast<const bf16*>(p.g) + b * p.sg.b +
                       h * p.sg.h + i * p.sg.l + 32 * (t & 1);
      const bf16* orow = static_cast<const bf16*>(p.o) + b * p.so.b +
                         h * p.so.h + i * p.so.l + 32 * (t & 1);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gr + 8 * u);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * u);
        const bf16* ge = reinterpret_cast<const bf16*>(&gv);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int x = 0; x < 8; ++x)
          part = fmaf(__bfloat162float(ge[x]), __bfloat162float(oe[x]), part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((t & 1) == 0) {
      delta_rows[t / 2] = part;  // 0 past Lq
      if (i < p.lq) p.delta[rows + i] = part;
    }
  }
  named_sync(1 + wg, kWarpgroup);
  float delta[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wrow0 + f.row(2 * r);
    const float l = i < p.lq ? p.lse[rows + i] : -INFINITY;
    delta[r] = i < p.lq ? delta_rows[f.row(2 * r)] : 0.f;
    lse2[r] = finite(l) ? l * kLog2e : INFINITY;  // p = 0 on an empty row
  }

  const float c = p.scale * kLog2e;
  const uint32_t qa = sm.own(0, wg), ga = sm.own(1, wg);
  float dq[32], sc[32], dp[32];
  uint32_t a[4][4];  // round(ds) of the previous tile, A over its keys
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] = 0.f;
  const TileHash hash(p.drop, b, h, p.hg);
  // ds of tile kt (its stage s) from S and dP, rounded into a; the dropout
  // test is made once a tile, not once a score
  auto ds_tile = [&](int s, int kt, auto drop) {
    const int j0 = kt * kWgRows;
    const uint32_t* pad = reinterpret_cast<const uint32_t*>(sm.side(s));
    const uint32_t pad0 = pad[0] >> (2 * f.q), pad1 = pad[1] >> (2 * f.q);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool padded =
            ((n < 4 ? pad0 : pad1) >> (8 * (n % 4) + (e & 1))) & 1u;
        const float pij = exp2_approx(fmaf(sc[4 * n + e], c, -lse2[r]));
        float dpv = dp[4 * n + e];
        if constexpr (decltype(drop)::value)
          dpv *= hash.keep(wrow0 + f.row(e), j0 + f.col(n, e));
        const float ds = pij * (dpv - delta[r]) * p.scale;
        sc[4 * n + e] = padded ? 0.f : ds;
      }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_to_a(sc, k, a[k]);
  };
  mbar_wait(sm.own_bar(), 0);
  wg_walk(
      sm.ring(), n_tiles, wg,
      [&](int sp) {  // dQ += dS·K over the previous tile's keys
        fence_acc(dq);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_rs<1>(dq, a[k], mnmajor_desc(sm.stage(sp, 0), k));
      },
      [&](int s) {  // S = Q·Kᵀ, dP = G·Vᵀ
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss<0>(sc, kmajor_desc(qa, k), kmajor_desc(sm.stage(s, 0), k),
                      k);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss<0>(dp, kmajor_desc(ga, k), kmajor_desc(sm.stage(s, 1), k),
                      k);
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
      });
  store_rows(dq, static_cast<bf16*>(p.out) + b * p.sout.b + h * p.sout.h,
             p.sout.l, wrow0, p.lq, f);
}

// ----------------------------------------------- kernel 8: dk and dv
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_dkv_kernel(__grid_constant__ const WgMaps maps, const Params p) {
  const WgSmem sm = wg_smem();
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kWgBlockRows;
  const int n_tiles = (p.lq + kWgRows - 1) / kWgRows;
  const long long rows = ((long long)b * p.heads + h) * p.lq;
  wg_init(sm, kWarp);

  if (threadIdx.x < kWarpgroup) {  // ------------------------- producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x >= kWarp) return;
    const int lane = threadIdx.x;
    if (lane == 0) load_own(maps, sm, row0, h, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kWgStages, i0 = t * kWgRows;
      mbar_wait(sm.empty(s), ((t / kWgStages) & 1) ^ 1);
      float* side = sm.side(s);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int il = 32 * half + lane, i = i0 + il;
        const float l = i < p.lq ? p.lse[rows + i] : -INFINITY;
        side[il] = finite(l) ? l * kLog2e : INFINITY;  // p = 0 there
        side[kWgRows + il] = i < p.lq ? p.delta[rows + i] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(sm.full(s), 2 * kWgTileBytes);
        tma_load_rows(&maps.str0, sm.stage(s, 0), sm.full(s), i0, h, b);
        tma_load_rows(&maps.str1, sm.stage(s, 1), sm.full(s), i0, h, b);
      } else {
        mbar_arrive(sm.full(s));
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();  // ------------------------------ consumers
  const int wg = threadIdx.x / kWarpgroup - 1, t = threadIdx.x % kWarpgroup;
  const int lane = t % kWarp;
  const Frag f{t / kWarp, lane >> 2, lane & 3};
  const int wrow0 = row0 + wg * kWgRows;
  bool padded[2];
  int key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = wrow0 + f.row(2 * r);
    padded[r] = key[r] >= p.lk ||
                (p.mask && p.mask[(long long)b * p.lk + key[r]]);
  }

  const float c = p.scale * kLog2e;
  const uint32_t ka = sm.own(0, wg), va = sm.own(1, wg);
  float dk[32], dv[32], st[32], dpt[32];  // Sᵀ, dPᵀ: rows keys, cols queries
  uint32_t apd[4][4], ads[4][4];  // round(pd), round(ds) of the previous tile
#pragma unroll
  for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;
  const TileHash hash(p.drop, b, h, p.hg);
  // pd and ds of query tile qt (its stage s) from Sᵀ and dPᵀ, rounded into
  // apd and ads; the dropout test is made once a tile
  auto pd_ds_tile = [&](int s, int qt, auto drop) {
    const int i0 = qt * kWgRows;
    const float* lse_s = sm.side(s);
    const float* delta_s = lse_s + kWgRows;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + f.col(n, 0));
      const float2 d2 =
          *reinterpret_cast<const float2*>(delta_s + f.col(n, 0));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pij =
            exp2_approx(fmaf(st[4 * n + e], c, -((e & 1) ? l2.y : l2.x)));
        float pd = pij, dpv = dpt[4 * n + e];
        if constexpr (decltype(drop)::value) {
          const float keep = hash.keep(i0 + f.col(n, e), key[r]);
          pd *= keep;
          dpv *= keep;
        }
        const float ds = pij * (dpv - ((e & 1) ? d2.y : d2.x)) * p.scale;
        st[4 * n + e] = padded[r] ? 0.f : pd;
        dpt[4 * n + e] = padded[r] ? 0.f : ds;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc_to_a(st, k, apd[k]);
      acc_to_a(dpt, k, ads[k]);
    }
  };
  mbar_wait(sm.own_bar(), 0);
  wg_walk(
      sm.ring(), n_tiles, wg,
      [&](int sp) {  // dV += Pdᵀ·G, dK += dSᵀ·Q over the previous queries,
                     // drained before Sᵀ and dPᵀ take registers: 168 do not
                     // hold dK, dV, Sᵀ, dPᵀ and the two A operands at once
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
          wgmma_ss<0>(st, kmajor_desc(kt, k), kmajor_desc(sm.stage(s, 0), k),
                      k);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss<0>(dpt, kmajor_desc(vt, k), kmajor_desc(sm.stage(s, 1), k),
                      k);
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
      });
  store_rows(dk, static_cast<bf16*>(p.dk) + b * p.sdk.b + h * p.sdk.h,
             p.sdk.l, wrow0, p.lk, f);
  store_rows(dv, static_cast<bf16*>(p.dv) + b * p.sdv.b + h * p.sdv.h,
             p.sdv.l, wrow0, p.lk, f);
}

// ------------------------------------------------------------------- host
// Launches pass `which` (1: dq, 2: dk/dv) with bf16 operands at Dh = 64
// whose rows and outer strides are 16-byte aligned: builds the four tensor
// maps from Params' strides and launches the grid (B * H, blocks of 128
// own rows).  Returns 0, a CUDA error, or a negative code of hopper.cuh's
// map encoding.
int launch_wgmma_bwd(int which, const Params& p, int batch,
                     cudaStream_t stream) {
  const bool dq = which == 1;
  const int own_len = dq ? p.lq : p.lk, str_len = dq ? p.lk : p.lq;
  const void* own[2] = {dq ? p.q : p.k, dq ? p.g : p.v};
  const void* str[2] = {dq ? p.k : p.q, dq ? p.v : p.g};
  const Strides own_s[2] = {dq ? p.sq : p.sk, dq ? p.sg : p.sv};
  const Strides str_s[2] = {dq ? p.sk : p.sq, dq ? p.sv : p.sg};
  WgMaps maps;
  CUtensorMap* m[4] = {&maps.own0, &maps.own1, &maps.str0, &maps.str1};
  for (int t = 0; t < 4; ++t) {
    const Strides& st = t < 2 ? own_s[t] : str_s[t - 2];
    const int rc = encode_rows_map(m[t], t < 2 ? own[t] : str[t - 2], batch,
                                   p.heads, t < 2 ? own_len : str_len, st.b,
                                   st.h, st.l);
    if (rc != 0) return rc;
  }
  auto kernel = dq ? wgmma_dq_kernel : wgmma_dkv_kernel;
  const int smem = (int)wgmma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(batch * p.heads, (own_len + kWgBlockRows - 1) / kWgBlockRows),
           kWgThreads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace
