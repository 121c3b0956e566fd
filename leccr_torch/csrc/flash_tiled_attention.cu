// Tiled flash tower self-attention, forward and backward, for Hopper
// (sm_90a): the regime past the chunked one.
//
// Replaces: leccr_tpu/ops/flash_attention.py `_tiled_fwd_kernel` (kernel 6,
// :267), `_tiled_dq_kernel` (kernel 7, :318) and `_tiled_dkv_kernel` (kernel
// 8, :349), with the per-tile dropout mask of `_tile_keep_from` at the head
// group hg = `_head_group(H)`: the Pallas kernels `flash_tower_attention`
// takes past `fits_chunked`, i.e. past 2560 tokens in bf16 and 1408 in f32
// at an even head count and Dh = 64 (ViT-L/14 @728: 2705 tokens).
//
// What it computes, per (batch b, head h), with scale = 1/sqrt(Dh) and the
// other side streamed in tiles of kTile = 128 (the TPU's _TILE_Q/_TILE_K):
//   kernel 6  s_ij = (q_i . k_j) * scale in f32, -inf where mask[b, j] != 0;
//             per key tile: m' = max(m, max_j s), alpha = exp(m - m') (0 while
//             m = -inf), p_ij = exp(s_ij - m') (0 where s = -inf), l = l*alpha
//             + sum_j p, then p *= keep_ij, o = o*alpha + sum_j round(p_ij) v_j;
//             at the end out_i = round(o / l) and lse_i = m + log l, or out 0
//             and lse -inf for a row with no key.  p is rounded to the input
//             dtype against the running max of each 128-key tile, as on the
//             TPU, so the key tiling is part of the result.
//   kernel 7  delta_i = sum_d g_id out_id (f32, from the rounded output; the
//             TPU package takes it outside the kernel), written for kernel 8;
//             p_ij = exp(s_ij - lse_i) (0 where s or lse is -inf); dp_ij =
//             (g_i . v_j) * keep_ij; ds_ij = round(p_ij (dp_ij - delta_i)
//             scale); dq_i = sum_j ds_ij k_j, summed in f32, rounded once.
//   kernel 8  the same p, dp and ds per (query, key); pd = round(p * keep);
//             dv_j = sum_i pd_ij g_i and dk_j = sum_i ds_ij q_i, summed in
//             f32, rounded once.
// keep_ij in {0, 1/(1-rate)} is the JAX package's interpret-mode tile hash
// (flash_attention.py:234-246) with hg = the largest divisor of H that is
// <= 8 (16 heads: 8; 12: 6; 3: 3), hi = h / hg, hh = h % hg, qi = i / 128,
// kj = j / 128: the counter hh*128^2 + (i % 128)*128 + (j % 128) plus
// seed_b*0x9E3779B9 + hi*0x27D4EB2F + qi*0x85EBCA77 + kj*0xC2B2AE3D (uint32
// wrap, seed_b = seed + b*0x9E3779B9), then the murmur3 finalizer; kept where
// the hash >= uint32(rate * 2^32).  The chunked kernels hash the same way
// with hg = 2 (or 1), so the two families' masks differ wherever the groups
// do.  The backward kernels regenerate the mask rather than store it.
//
// What bounds it: at the path's [8, 16, 2705, 64] in bf16 kernel 6 does
// 4 B H L^2 Dh = 240 GFLOP (0.242 ms at the card's 989 TFLOP/s) on 89 MB of
// q, k, v and out (0.026 ms at 3.35 TB/s), kernel 7 6 B H L^2 Dh (0.364 ms)
// and kernel 8 8 B H L^2 Dh (0.485 ms): all three are bound by operations.
// Besides the products every score takes an exp (and, with dropout, the
// hash) on the scalar units.
//
// The design: the TPU grid (B, H/hg, Lqp/128, Lkp/128) carries scratch along
// its sequential last axis; blocks here run in no order, so a block owns one
// (b, h, 128-row tile) of its side (queries for kernels 6 and 7, keys for
// kernel 8) and loops over the other side's tiles itself (128 rows; 64 in
// the wgmma passes of kernels 7 and 8).  Nothing crosses blocks: no
// atomics, a deterministic result.  The ragged edge is handled in the
// kernels (rows past L are never read or written, keys past
// Lk count as padding), so nothing is padded in device memory; loads take
// any outer strides and outputs go to [B, L, H, Dh] storage.  Variants:
// - bf16 at Dh = 64 with 16-byte aligned rows and outer strides (the
//   "wgmma" variant the caller picks, `tiled_variant`: every launch of the
//   high-resolution step): warp-specialised bodies, one TMA producer warp
//   and two consumer warpgroups issuing wgmma.  Kernel 6 runs
//   flash_fwd_wgmma.cuh (128-key tiles; the chunked kernel 4 wraps the same
//   body), kernels 7 and 8 flash_bwd_wgmma.cuh (64-row tiles; the chunked
//   kernel 5 wraps the same passes).  The passes take a grid of one block
//   per 128-row item or a persistent one (a block per SM walking the
//   items): `persistent`, a launch parameter that the caller fixes
//   (ops/flash_attention.py, TILED_BWD_PERSISTENT) from both schedules'
//   times at the high-resolution step's shape (PERF.md);
// - every other case: the scalar f32-FMA bodies of flash_tiles.cuh, a block
//   of 8 warps owning 64 rows (two blocks per 128-row tile).
// Kernel 6 is bound by the tensor cores and the SFU alike (an exp2 per
// score beside 4 Dh flops of products, flash_fwd_wgmma.cuh); its time, and
// 7 and 8's, stand in PERF.md beside their bounds.

#include "flash_bwd_wgmma.cuh"
#include "flash_fwd_wgmma.cuh"
#include "flash_tiles.cuh"

namespace {

// ------------------------------------------------------ scalar kernels
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps* kWarp) tiled_fwd_kernel(Params p) {
  streamed_fwd<T, DH>(p);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps* kWarp) tiled_dq_kernel(Params p) {
  streamed_dq<T, DH>(p);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps* kWarp) tiled_dkv_kernel(Params p) {
  streamed_dkv<T, DH>(p);
}

// ------------------------------------------------- kernel 6 on wgmma
__global__ void __launch_bounds__(kWgThreads, 1)
    tiled_fwd_wgmma_kernel(__grid_constant__ const FwdMaps maps,
                           const Params p) {
  wgmma_fwd(maps, p);
}

// ------------------------------------------- kernels 7 and 8 on wgmma
__global__ void __launch_bounds__(kWgThreads, 1)
    tiled_dq_wgmma_kernel(__grid_constant__ const WgMaps maps,
                          const Params p) {
  wgmma_dq(maps, p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    tiled_dkv_wgmma_kernel(__grid_constant__ const WgMaps maps,
                           const Params p) {
  wgmma_dkv(maps, p);
}

typedef void (*Kernel)(Params);

// Launch `which` (0: kernel 6, 1: kernel 7, 2: kernel 8) on the scalar
// bodies, grid (B * H, blocks of the side it owns).
template <typename T, int DH>
int run(int which, const Params& p, int batch, cudaStream_t s) {
  const int n = which == 2 ? p.lk : p.lq;
  const Kernel scalar[3] = {tiled_fwd_kernel<T, DH>, tiled_dq_kernel<T, DH>,
                            tiled_dkv_kernel<T, DH>};
  return launch(scalar[which], dim3(batch * p.heads, (n + kRows - 1) / kRows),
                kWarps, smem_bytes(which, DH), s, p);
}

// Launch `which` on its wgmma variant (wgmma: bf16 at Dh = 64 only; the
// backward passes on the persistent grid or one block per item) or on the
// scalar bodies.
int dispatch(int which, int dtype, int dh, const Params& p, int batch,
             void* stream, bool wgmma, bool persistent = false) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (dtype != 1 || dh != kTcDim) return kBadVariant;
    if (which == 0)
      return launch_wgmma_fwd(tiled_fwd_wgmma_kernel, p, batch, s);
    if (which == 1)
      return launch_wgmma_bwd(tiled_dq_wgmma_kernel, 1, p, batch, persistent,
                              s);
    return launch_wgmma_bwd(tiled_dkv_wgmma_kernel, 2, p, batch, persistent,
                            s);
  }
  if (dtype == 1)
    return by_dim(dh, [&](auto d) {
      return run<bf16, decltype(d)::value>(which, p, batch, s);
    });
  return by_dim(dh, [&](auto d) {
    return run<float, decltype(d)::value>(which, p, batch, s);
  });
}

}  // namespace

extern "C" {

// Head dims the kernels are compiled for.
int ftl_supported_dim(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128;
}

// Bytes of dynamic shared memory of launch `which` (0: kernel 6, 1: kernel
// 7, 2: kernel 8) for head dim dh and wgmma as the launches take them.
size_t ftl_smem_bytes(int which, int dh, int wgmma) {
  if (!wgmma) return smem_bytes(which, dh);
  return which == 0 ? fwd_wgmma_smem_bytes() : wgmma_smem_bytes(which);
}

// Kernel 6.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, out share it).
// strides: 12 element strides, (b, h, l) of q, k, v, out.  lse: [B, H, Lq]
// f32 out.  hg: heads per dropout head group.  seed/threshold/keep_scale/
// dropout: the dropout mask (see the head of this file).  vec: 1 when every
// staged row starts 16-byte aligned and Dh spans whole 16-byte words (the
// scalar body's 16-byte loads).  wgmma: 1 takes the wgmma variant (bf16 at
// Dh = 64; q, k, v with 16-byte aligned rows and outer strides).  Returns
// cudaGetLastError() after the launch (0 = success), -1 for an unsupported
// head dim, -2 for wgmma at another dtype or head dim, -10 / -11 when a TMA
// map could not be encoded.
int ftl_forward(const void* q, const void* k, const void* v,
                const unsigned char* mask, void* out, float* lse, int dtype,
                int batch, int heads, int lq, int lk, int dh, int hg,
                const long long* strides, float scale, unsigned int seed,
                unsigned int threshold, float keep_scale, int dropout,
                int vec, int wgmma, void* stream) {
  Params p = make_params(q, k, v, mask, lse, heads, lq, lk, hg, scale, seed,
                         threshold, keep_scale, dropout, vec);
  p.out = out;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.sout = strides_at(strides, 3);
  return dispatch(0, dtype, dh, p, batch, stream, wgmma);
}

// Kernel 7: delta [B, H, Lq] f32 (written) and dq.  o: the forward's output;
// g: d(out).  strides: 18 element strides, (b, h, l) of q, k, v, o, g, dq.
// wgmma: 1 takes the wgmma variant (bf16 at Dh = 64; q, k, v, o, g with
// 16-byte aligned rows and outer strides), 0 the scalar one (vec: its
// 16-byte loads); persistent: the wgmma variant's grid, 1 a block per SM
// walking the 128-row items, 0 a block per item.  Other arguments and the
// returned code as ftl_forward.
int ftl_dq(const void* q, const void* k, const void* v,
           const unsigned char* mask, const void* o, const float* lse,
           const void* g, void* dq, float* delta, int dtype, int batch,
           int heads, int lq, int lk, int dh, int hg,
           const long long* strides, float scale, unsigned int seed,
           unsigned int threshold, float keep_scale, int dropout, int vec,
           int wgmma, int persistent, void* stream) {
  Params p = make_params(q, k, v, mask, const_cast<float*>(lse), heads, lq,
                         lk, hg, scale, seed, threshold, keep_scale, dropout,
                         vec);
  p.o = o;
  p.g = g;
  p.out = dq;
  p.delta = delta;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  p.sg = strides_at(strides, 4);
  p.sout = strides_at(strides, 5);
  return dispatch(1, dtype, dh, p, batch, stream, wgmma, persistent);
}

// Kernel 8: dk and dv from lse and kernel 7's delta.  strides: 18 element
// strides, (b, h, l) of q, k, v, g, dk, dv.  Other arguments and the
// returned code as ftl_dq.
int ftl_dkv(const void* q, const void* k, const void* v,
            const unsigned char* mask, const float* lse, const float* delta,
            const void* g, void* dk, void* dv, int dtype, int batch,
            int heads, int lq, int lk, int dh, int hg,
            const long long* strides, float scale, unsigned int seed,
            unsigned int threshold, float keep_scale, int dropout, int vec,
            int wgmma, int persistent, void* stream) {
  Params p = make_params(q, k, v, mask, const_cast<float*>(lse), heads, lq,
                         lk, hg, scale, seed, threshold, keep_scale, dropout,
                         vec);
  p.g = g;
  p.dk = dk;
  p.dv = dv;
  p.delta = const_cast<float*>(delta);
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.sg = strides_at(strides, 3);
  p.sdk = strides_at(strides, 4);
  p.sdv = strides_at(strides, 5);
  return dispatch(2, dtype, dh, p, batch, stream, wgmma, persistent);
}

}  // extern "C"
