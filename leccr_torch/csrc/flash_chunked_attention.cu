// Chunked flash tower self-attention, forward and backward, for Hopper
// (sm_90a): the long-sequence regime.
//
// Replaces: leccr_tpu/ops/flash_attention.py `_chunk_fwd_kernel` (with the
// per-tile dropout mask of `_tile_keep_from`) and `_chunk_bwd_kernel`, the
// Pallas kernels `flash_tower_attention` takes past the single-block VMEM
// budget (`fits_vmem`) and within `fits_chunked`: ViT-L/14 @336 (577 tokens)
// in the vision tower, and text or captions at the 200-token bucket.
//
// What it computes, per (batch b, head h), with scale = 1/sqrt(Dh) and keys
// streamed in tiles of kTile = 128 (the TPU kernel's _CHUNK):
//   forward   s_ij = (q_i . k_j) * scale in f32, -inf where mask[b, j] != 0;
//             per key tile: m' = max(m, max_j s), alpha = exp(m - m') (0 while
//             m = -inf), p_ij = exp(s_ij - m') (0 where s = -inf), l = l*alpha
//             + sum_j p, then p *= keep_ij, o = o*alpha + sum_j round(p_ij) v_j;
//             at the end out_i = round(o / l) and lse_i = m + log l, or out 0
//             and lse -inf for a row with no key.  The rounding of the
//             UNNORMALISED p to the input dtype, relative to the running max
//             of each 128-key tile, is the TPU kernel's, so the key tiling is
//             part of the result; the query tiling is not.
//   backward  delta_i = sum_d g_id out_id (f32, from the rounded output);
//             p_ij = exp(s_ij - lse_i) (0 where s or lse is -inf);
//             pd = p * keep; dv_j = sum_i round(pd_ij) g_i; dp_ij = (g_i .
//             v_j) * keep_ij; ds_ij = round(p_ij (dp_ij - delta_i) scale);
//             dq_i = sum_j ds_ij k_j; dk_j = sum_i ds_ij q_i.  dq, dk and dv
//             each sum in f32 and round to the input dtype once.
// keep_ij in {0, 1/(1-rate)} is the JAX package's interpret-mode tile hash
// (flash_attention.py:234-246): with hg = 2 heads per group when H is even
// (else 1), hi = h / hg, hh = h % hg, qi = i / 128, kj = j / 128, the counter
// hh*128^2 + (i % 128)*128 + (j % 128) plus seed_b*0x9E3779B9 +
// hi*0x27D4EB2F + qi*0x85EBCA77 + kj*0xC2B2AE3D (uint32 wrap, seed_b = seed +
// b*0x9E3779B9), then the murmur3 finalizer; kept where the hash >=
// uint32(rate * 2^32).  It is not the single-block kernels' mask, and the
// backward regenerates it rather than storing it.
//
// What bounds it: at ViT-L/14 @336 (B=32, H=16, L=577, Dh=64) in bf16 a
// forward does 4 B H L^2 Dh = 44 GFLOP on 152 MB of q, k, v and out (0.044
// ms at the card's 989 TFLOP/s, 0.045 ms at 3.35 TB/s: both about equal), a
// backward 10 B H L^2 Dh = 109 GFLOP on 304 MB (0.110 ms, operations).  At
// the 200-token text bucket both directions are bound by bytes.
//
// The design: blocks run in no order, so the TPU kernel's (q-chunk, k-chunk)
// loops become (a) a grid over (b, h, row tiles) and (b) a loop inside the
// block over 128-row tiles of the other side, staged in shared memory.  The
// backward is two launches, deterministic and without atomics: one over query
// rows (delta and dq), one over key rows (dk and dv), as in the single-block
// kernels.  The ragged edge is handled in the kernels: rows past L are never
// read or written, keys past Lk count as padding, and nothing is padded in
// device memory.  Loads take the innermost stride 1 and any outer strides
// (head-split views, CLIP's packed in_proj chunks), and outputs go to
// [B, L, H, Dh] storage, so no transpose copies are needed.  Variants:
// - the forward in bf16 at Dh = 64 with 16-byte aligned rows and outer
//   strides (the "wgmma" variant the caller picks, `tiled_variant`: every
//   launch of the long-sequence step) runs flash_fwd_wgmma.cuh, the
//   warp-specialised wgmma + TMA body that the tiled kernel 6 wraps too (one
//   TMA producer warp, two consumer warpgroups, 128-key tiles); it is bound
//   by the tensor cores and the SFU alike (an exp2 per score);
// - the backward in bf16 at Dh = 64 with 16-byte aligned rows and outer
//   strides (the "wgmma" variant, `tiled_variant` of q, k, v, g and out:
//   every launch of the long-sequence step) runs flash_bwd_wgmma.cuh, the
//   warp-specialised wgmma + TMA dq and dk/dv passes that the tiled kernels
//   7 and 8 wrap too, on their persistent schedule (one block per SM
//   walking 128-row work items, the next item's own rows and first tiles
//   loaded under the current item's last tiles and epilogue): at 577
//   tokens a block streams only ten 64-row tiles an item, so a block's
//   fixed cost weighs about four times what it does at 2705;
// - every other case runs the scalar f32-FMA bodies of flash_tiles.cuh, a
//   block of 8 warps owning 64 rows.
// The two families differ only in the mask's head group (hg, an argument).

#include "flash_bwd_wgmma.cuh"
#include "flash_fwd_wgmma.cuh"
#include "flash_tiles.cuh"

namespace {

// The scalar kernels (any dtype and head dim): a block owns kRows rows.
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps* kWarp) chunk_fwd_kernel(Params p) {
  streamed_fwd<T, DH>(p);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps* kWarp)
    chunk_bwd_dq_kernel(Params p) {
  streamed_dq<T, DH>(p);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps* kWarp)
    chunk_bwd_dkv_kernel(Params p) {
  streamed_dkv<T, DH>(p);
}

// ----------------------------------------------- the forward on wgmma
__global__ void __launch_bounds__(kWgThreads, 1)
    chunk_fwd_wgmma_kernel(__grid_constant__ const FwdMaps maps,
                           const Params p) {
  wgmma_fwd(maps, p);
}

// ----------------------------------------------- the backward on wgmma
__global__ void __launch_bounds__(kWgThreads, 1)
    chunk_bwd_dq_wgmma_kernel(__grid_constant__ const WgMaps maps,
                              const Params p) {
  wgmma_dq(maps, p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    chunk_bwd_dkv_wgmma_kernel(__grid_constant__ const WgMaps maps,
                               const Params p) {
  wgmma_dkv(maps, p);
}

dim3 grid_of(const Params& p, int batch, int n, int rows) {
  return dim3(batch * p.heads, (n + rows - 1) / rows);
}

template <typename T, int DH>
int forward(const Params& p, int batch, cudaStream_t s) {
  return launch(chunk_fwd_kernel<T, DH>, grid_of(p, batch, p.lq, kRows),
                kWarps, smem_bytes(0, DH), s, p);
}

template <typename T, int DH>
int backward(const Params& p, int batch, cudaStream_t s) {
  const int rc = launch(chunk_bwd_dq_kernel<T, DH>,
                        grid_of(p, batch, p.lq, kRows), kWarps,
                        smem_bytes(1, DH), s, p);
  if (rc != 0) return rc;
  return launch(chunk_bwd_dkv_kernel<T, DH>, grid_of(p, batch, p.lk, kRows),
                kWarps, smem_bytes(2, DH), s, p);
}

}  // namespace

extern "C" {

// Head dims the kernels are compiled for.
int fca_chunk_supported_dim(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128;
}

// Bytes of dynamic shared memory of each launch (0: forward, 1: backward dq
// pass, 2: backward dk/dv pass) for head dim dh and wgmma (the launch's
// variant) as the launches take them.
size_t fca_chunk_smem_bytes(int which, int dh, int wgmma) {
  if (!wgmma) return smem_bytes(which, dh);
  return which == 0 ? fwd_wgmma_smem_bytes() : wgmma_smem_bytes(which);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out share it).  strides: 12
// element strides, (b, h, l) of q, k, v, out.  lse: [B, H, Lq] f32 out.  hg:
// heads per dropout head group.  seed/threshold/keep_scale/dropout: the
// dropout mask (see the head of this file).  vec: 1 when every q/k/v row
// starts 16-byte aligned and Dh spans whole 16-byte words (the scalar
// body's 16-byte loads).  wgmma: 1 takes the wgmma variant (bf16 at Dh = 64;
// q, k, v with 16-byte aligned rows and outer strides).  Returns
// cudaGetLastError() after the launch (0 = success), -1 for an unsupported
// head dim, -2 for wgmma at another dtype or head dim, -10 / -11 when a TMA
// map could not be encoded.
int fca_chunk_forward(const void* q, const void* k, const void* v,
                      const unsigned char* mask, void* out, float* lse,
                      int dtype, int batch, int heads, int lq, int lk, int dh,
                      int hg, const long long* strides, float scale,
                      unsigned int seed, unsigned int threshold,
                      float keep_scale, int dropout, int vec, int wgmma,
                      void* stream) {
  Params p = make_params(q, k, v, mask, lse, heads, lq, lk, hg, scale, seed,
                         threshold, keep_scale, dropout, vec);
  p.out = out;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.sout = strides_at(strides, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (dtype != 1 || dh != kTcDim) return kBadVariant;
    return launch_wgmma_fwd(chunk_fwd_wgmma_kernel, p, batch, s);
  }
  if (dtype == 1)
    return by_dim(dh, [&](auto d) {
      return forward<__nv_bfloat16, decltype(d)::value>(p, batch, s);
    });
  return by_dim(dh, [&](auto d) {
    return forward<float, decltype(d)::value>(p, batch, s);
  });
}

// Backward: two launches on `stream` (delta and dq, then dk and dv).
// strides: 24 element strides, (b, h, l) of q, k, v, o, g, dq, dk, dv.  o:
// the forward's output; delta: [B, H, Lq] f32 scratch the first launch
// writes and the second reads.  vec covers q, k, v and g.  wgmma: 1 takes
// the wgmma passes on their persistent schedule (bf16 at Dh = 64; q, k, v,
// o and g with 16-byte aligned rows and outer strides).  Other arguments
// and the returned code as fca_chunk_forward.
int fca_chunk_backward(const void* q, const void* k, const void* v,
                       const unsigned char* mask, const void* o,
                       const float* lse, const void* g, void* dq, void* dk,
                       void* dv, float* delta, int dtype, int batch,
                       int heads, int lq, int lk, int dh, int hg,
                       const long long* strides, float scale,
                       unsigned int seed, unsigned int threshold,
                       float keep_scale, int dropout, int vec, int wgmma,
                       void* stream) {
  Params p = make_params(q, k, v, mask, const_cast<float*>(lse), heads, lq,
                         lk, hg, scale, seed, threshold, keep_scale, dropout,
                         vec);
  p.o = o;
  p.g = g;
  p.out = dq;
  p.dk = dk;
  p.dv = dv;
  p.delta = delta;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  p.sg = strides_at(strides, 4);
  p.sout = strides_at(strides, 5);
  p.sdk = strides_at(strides, 6);
  p.sdv = strides_at(strides, 7);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (dtype != 1 || dh != kTcDim) return kBadVariant;
    const int rc = launch_wgmma_bwd(chunk_bwd_dq_wgmma_kernel, 1, p, batch,
                                    true, s);
    if (rc != 0) return rc;
    return launch_wgmma_bwd(chunk_bwd_dkv_wgmma_kernel, 2, p, batch, true,
                            s);
  }
  if (dtype == 1)
    return by_dim(dh, [&](auto d) {
      return backward<__nv_bfloat16, decltype(d)::value>(p, batch, s);
    });
  return by_dim(dh, [&](auto d) {
    return backward<float, decltype(d)::value>(p, batch, s);
  });
}

}  // extern "C"
