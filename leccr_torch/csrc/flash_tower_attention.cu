// Flash tower self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces: leccr_tpu/ops/flash_attention.py `_fwd_kernel` (with the
// dropout mask of `_keep_mask`) and `_bwd_kernel`, the single-block Pallas
// kernels behind `flash_tower_attention` that the CLIP vision tower and the
// mBERT text tower call in training.
//
// What it computes, per (batch b, head h), with scale = 1/sqrt(Dh):
//   forward   s_ij = (q_i . k_j) * scale in f32; s_ij = -FLT_MAX (f32 min,
//             never -inf) where mask[b, j] != 0; lse_i = max_j s + log sum_j
//             exp(s - max); p_ij = exp(s_ij - max) / sum; p *= keep_ij;
//             out_i = sum_j round(p_ij) v_j (f32 sums, stored in q's dtype).
//   backward  p_ij = exp(s_ij - lse_i); pd = p * keep; dv_j = sum_i
//             round(pd_ij) g_i; dp_ij = (g_i . v_j) * keep_ij;
//             delta_i = sum_j dp_ij p_ij; ds_ij = round(p_ij (dp_ij -
//             delta_i) scale); dq_i = sum_j ds_ij k_j; dk_j = sum_i ds_ij q_i.
// round() is a rounding to the input dtype (bf16 or f32), at the points
// where the TPU kernel casts.  keep_ij is the dropout factor in
// {0, 1/(1-rate)}: the counter-based murmur3 hash of the JAX package's
// interpret mode (flash_attention.py:64-73), keyed by the per-example seed
// seed_b = seed + b * 0x9E3779B9 (uint32 wrap) and the counter
// h*Lq*Lk + i*Lk + j, kept where the hash >= uint32(rate * 2^32).  The
// backward regenerates the mask from the seed, so it is never stored.  These
// are not the TPU hardware PRNG's bits (nothing can reproduce those); they
// are the JAX package's own interpret-mode contract, so the CPU tests match
// the JAX kernel bit for bit in the mask.
//
// What bounds it: bytes.  At the tower shapes (L <= 169, Dh = 64) one head
// does ~4 L^2 Dh flops forward against ~4 L Dh elements moved: at most ~70
// flops per byte in bf16, below the ~295 at which an H100 stops being
// bound by device memory.  The least time is the bytes of q, k, v, out and
// lse (forward) or q, k, v, g, lse -> dq, dk, dv (backward) at 3.35 TB/s:
// per flagship train step (12 x [128,12,145,64] vision, 12 x [256,12,64,64]
// text and 12 x [128,12,64,64] caption forwards, the vision and text
// backwards) 0.957 ms for the forward's 157 GFLOP and 1.352 ms for the
// backward's 345 GFLOP.
//
// What the design does about it: every input is read from device memory
// once, and the [L, L] scores, probabilities, masks and dp never leave the
// SM.  Loads take the innermost stride 1 and any outer strides, so the
// caller passes head-split views without a transpose copy.  Two variants,
// chosen by the caller from the shapes before the launch
// (ops/flash_attention.py, single_block_variant):
// - Hopper (`single_fwd_wgmma_kernel`, `single_bwd_wgmma_kernel`), bf16 at
//   Dh = 64 with TMA-eligible views and Lk <= 192, every call of the train
//   steps: persistent blocks walk the (b, h) heads; each head's K and V are
//   loaded once by TMA (128-byte swizzled 64-row boxes, zero-filled past Lk)
//   while the previous head is computed, query tiles of 64 rows stream
//   through a TMA ring, and the products run on wgmma with f32 accumulators
//   in registers.  The forward holds a tile's whole score rows (the keys
//   rounded up to 16), so each row's exact max and sum come before any p is
//   rounded; the backward is one launch and one pass of 5 products a tile
//   (Sᵀ, dPᵀ, dV, dK, dQ), its delta summed over every key inside the block.
//   A product of two bf16 values is exact in f32, so only the order of the
//   f32 sums and exp2.approx (two ulps) on the scaled exponent differ from
//   the scalar bodies; the roundings to bf16 (p, pd, ds, the outputs) sit at
//   the same points.  The design of each kernel is stated at its definition;
//   the layouts are in flash_single_layout.h;
// - scalar f32 FMA, for f32 (TF32 would break its 1e-5 tolerance), other
//   head dims and unaligned views: operands staged as f32 (rows padded by
//   one float, so lanes that walk different rows at the same feature hit
//   different banks); each warp owns one row at a time, lanes split the
//   other side's rows for the dot products, warp shuffles give the row max
//   and sums, lanes split the features for the weighted sums.  It is bound
//   by shared-memory traffic on the FP32 pipe, not by device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "flash_single_layout.h"
#include "hopper.cuh"

namespace {

struct Strides {
  long long b, h, l;  // element strides of dims 0, 1, 2; dim 3 has stride 1
};

struct Dropout {
  const unsigned int* seed;  // the call's int32 seed, as uint32, in device
                             // memory (read only where on): the same launch
                             // serves every step of a replayed CUDA graph
  unsigned int threshold;  // keep where hash >= threshold
  float scale;             // 1 / (1 - rate), in f32
  int on;                  // rate > 0
  int h0;                  // the first head's index among the layer's heads
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;              // backward: d(out), any outer strides
  const unsigned char* mask;  // [B, Lk] bool, nonzero = padding; or null
  void* out;                  // forward: out; backward: dq
  void* dk;
  void* dv;
  float* lse;    // [B, H, Lq] f32
  float* delta;  // [B, H, Lq] f32 (backward scratch)
  Strides sq, sk, sv, sg, so, sdk, sdv;
  int heads, lq, lk, rows;  // rows: rows of the block's tile
  float scale;
  Dropout drop;
  int vec;  // 1: staged rows are 16-byte aligned and span 16-byte words
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// x rounded to T and widened back: the TPU kernel's `.astype(dtype)`.
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int t = 0; t < Vec<T>::n; ++t) dst[t] = to_f32(e[t]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The call's seed, read from its device slot where dropout is on.
__device__ __forceinline__ unsigned int seed_of(const Dropout& d) {
  return d.on ? __ldg(d.seed) : 0u;
}

// The dropout factor of element (b, h, i, j) in {0, scale} under `seed`
// (seed_of(d)); the counter takes the head's index among the layer's heads,
// h0 + h.
__device__ __forceinline__ float keep_factor(const Dropout& d,
                                             unsigned int seed, int b, int h,
                                             int i, int j, int lq, int lk) {
  const unsigned int seed_b = seed + (unsigned int)b * 0x9E3779B9u;
  unsigned int x = (unsigned int)(d.h0 + h) *
                       ((unsigned int)lq * (unsigned int)lk) +
                   (unsigned int)i * (unsigned int)lk + (unsigned int)j;
  x += seed_b * 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;  // murmur3 finalizer
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= d.threshold ? d.scale : 0.f;
}

// All of the block's threads copy rows [0, n) of a [n, DH] head matrix
// (row stride `stride` elements) into shared memory as f32, row pitch `ld`.
template <typename T, int DH>
__device__ __forceinline__ void stage(const T* src, long long stride, int n,
                                      float* dst, int ld, int vec) {
  if (vec) {
    constexpr int w = Vec<T>::n, per_row = DH / w;
#pragma unroll 4
    for (int e = threadIdx.x; e < n * per_row; e += blockDim.x) {
      const int r = e / per_row, d = (e % per_row) * w;
      float t[w];
      load16(src + r * stride + d, t);
#pragma unroll
      for (int u = 0; u < w; ++u) dst[r * ld + d + u] = t[u];
    }
  } else {
    for (int e = threadIdx.x; e < n * DH; e += blockDim.x) {
      const int r = e / DH, d = e % DH;
      dst[r * ld + d] = to_f32(src[r * stride + d]);
    }
  }
}

// One warp copies a [DH] row into its shared-memory row buffer.
template <typename T, int DH>
__device__ __forceinline__ void load_row(const T* src, float* dst, int lane) {
#pragma unroll
  for (int d = lane; d < DH; d += kWarp) dst[d] = to_f32(src[d]);
}

// a . b over DH features: `a` is a 16-byte aligned row that every lane of
// the warp reads (a broadcast), `b` a padded row of a staged matrix.
template <int DH>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    acc = fmaf(x.x, b[d], acc);
    acc = fmaf(x.y, b[d + 1], acc);
    acc = fmaf(x.z, b[d + 2], acc);
    acc = fmaf(x.w, b[d + 3], acc);
  }
  return acc;
}

// Features each lane owns in the weighted sums.
__host__ __device__ constexpr int kLanesPer(int dh) {
  return (dh + kWarp - 1) / kWarp;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// ------------------------------------------------------------- forward
// Shared memory (floats): K [lk][DH+1], V [lk][DH+1], per warp a q row
// [DH] and a score row [lk] (each rounded up to 4 floats), then the mask
// row [lk] as bytes.
template <typename T, int DH>
__global__ void fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const unsigned int seed = seed_of(p.drop);
  const int lq = p.lq, lk = p.lk, ld = DH + 1;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int mat = round4(lk * ld), per_warp = round4(DH) + round4(lk);
  float* ks = smem;
  float* vs = ks + mat;
  float* qrow = vs + mat + warp * per_warp;
  float* srow = qrow + round4(DH);
  unsigned char* pad =
      reinterpret_cast<unsigned char*>(vs + mat + n_warps * per_warp);

  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * p.rows;
  const int row_end = min(row0 + p.rows, lq);
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  stage<T, DH>(kg, p.sk.l, lk, ks, ld, p.vec);
  stage<T, DH>(vg, p.sv.l, lk, vs, ld, p.vec);
  for (int j = threadIdx.x; j < lk; j += blockDim.x)
    pad[j] = p.mask ? p.mask[(long long)b * lk + j] : 0;
  __syncthreads();

  constexpr int kD = kLanesPer(DH);
  for (int i = row0 + warp; i < row_end; i += n_warps) {
    load_row<T, DH>(static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h +
                        i * p.sq.l, qrow, lane);
    __syncwarp();
    float m = -FLT_MAX;
    for (int j = lane; j < lk; j += kWarp) {
      float s = dot<DH>(qrow, ks + j * ld) * p.scale;
      if (pad[j]) s = -FLT_MAX;
      srow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < lk; j += kWarp) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0)
      p.lse[((long long)b * p.heads + h) * lq + i] = m + logf(sum);
    for (int j = lane; j < lk; j += kWarp) {
      float pj = srow[j] / sum;
      if (p.drop.on) pj *= keep_factor(p.drop, seed, b, h, i, j, lq, lk);
      srow[j] = round_to(pj, T());
    }
    __syncwarp();  // srow is read by every lane below
    float acc[kD];
#pragma unroll
    for (int t = 0; t < kD; ++t) acc[t] = 0.f;
    for (int j = 0; j < lk; ++j) {
      const float pj = srow[j];
      const float* vr = vs + j * ld;
#pragma unroll
      for (int t = 0; t < kD; ++t)
        if (lane + t * kWarp < DH)
          acc[t] = fmaf(pj, vr[lane + t * kWarp], acc[t]);
    }
    T* og = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h + i * p.so.l;
#pragma unroll
    for (int t = 0; t < kD; ++t)
      if (lane + t * kWarp < DH) store(og + lane + t * kWarp, acc[t]);
    __syncwarp();  // qrow and srow are rewritten for the next row
  }
}

// ------------------------------------------- backward, pass 1: dq, delta
// Shared memory (floats): K and V [lk][DH+1], per warp a q row, a g row
// [DH] and two rows [lk] (p, then dp, then ds), then the mask as bytes.
template <typename T, int DH>
__global__ void bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const unsigned int seed = seed_of(p.drop);
  const int lq = p.lq, lk = p.lk, ld = DH + 1;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int mat = round4(lk * ld);
  const int per_warp = 2 * round4(DH) + 2 * round4(lk);
  float* ks = smem;
  float* vs = ks + mat;
  float* qrow = vs + mat + warp * per_warp;
  float* grow = qrow + round4(DH);
  float* prow = grow + round4(DH);
  float* dsrow = prow + round4(lk);
  unsigned char* pad =
      reinterpret_cast<unsigned char*>(vs + mat + n_warps * per_warp);

  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * p.rows;
  const int row_end = min(row0 + p.rows, lq);
  stage<T, DH>(static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h, p.sk.l,
               lk, ks, ld, p.vec);
  stage<T, DH>(static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h, p.sv.l,
               lk, vs, ld, p.vec);
  for (int j = threadIdx.x; j < lk; j += blockDim.x)
    pad[j] = p.mask ? p.mask[(long long)b * lk + j] : 0;
  __syncthreads();

  constexpr int kD = kLanesPer(DH);
  for (int i = row0 + warp; i < row_end; i += n_warps) {
    load_row<T, DH>(static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h +
                        i * p.sq.l, qrow, lane);
    load_row<T, DH>(static_cast<const T*>(p.g) + b * p.sg.b + h * p.sg.h +
                        i * p.sg.l, grow, lane);
    __syncwarp();
    const long long row = ((long long)b * p.heads + h) * lq + i;
    const float lse = p.lse[row];
    float partial = 0.f;
    for (int j = lane; j < lk; j += kWarp) {
      float s = dot<DH>(qrow, ks + j * ld) * p.scale;
      if (pad[j]) s = -FLT_MAX;
      const float pj = expf(s - lse);
      float dp = dot<DH>(grow, vs + j * ld);
      if (p.drop.on) dp *= keep_factor(p.drop, seed, b, h, i, j, lq, lk);
      prow[j] = pj;
      dsrow[j] = dp;
      partial = fmaf(dp, pj, partial);
    }
    const float delta = warp_sum(partial);
    if (lane == 0) p.delta[row] = delta;
    for (int j = lane; j < lk; j += kWarp)
      dsrow[j] = round_to(prow[j] * (dsrow[j] - delta) * p.scale, T());
    __syncwarp();
    float acc[kD];
#pragma unroll
    for (int t = 0; t < kD; ++t) acc[t] = 0.f;
    for (int j = 0; j < lk; ++j) {
      const float ds = dsrow[j];
      const float* kr = ks + j * ld;
#pragma unroll
      for (int t = 0; t < kD; ++t)
        if (lane + t * kWarp < DH)
          acc[t] = fmaf(ds, kr[lane + t * kWarp], acc[t]);
    }
    T* dq = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h + i * p.so.l;
#pragma unroll
    for (int t = 0; t < kD; ++t)
      if (lane + t * kWarp < DH) store(dq + lane + t * kWarp, acc[t]);
    __syncwarp();
  }
}

// ------------------------------------------ backward, pass 2: dk, dv
// Shared memory (floats): Q and G [lq][DH+1], lse and delta [lq], per warp
// a k row, a v row [DH] and two rows [lq] (round(pd), ds).
template <typename T, int DH>
__global__ void bwd_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  const unsigned int seed = seed_of(p.drop);
  const int lq = p.lq, lk = p.lk, ld = DH + 1;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int mat = round4(lq * ld);
  const int per_warp = 2 * round4(DH) + 2 * round4(lq);
  float* qs = smem;
  float* gs = qs + mat;
  float* lse = gs + mat;
  float* delta = lse + round4(lq);
  float* krow = delta + round4(lq) + warp * per_warp;
  float* vrow = krow + round4(DH);
  float* pdrow = vrow + round4(DH);
  float* dsrow = pdrow + round4(lq);

  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * p.rows;
  const int row_end = min(row0 + p.rows, lk);
  stage<T, DH>(static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.l,
               lq, qs, ld, p.vec);
  stage<T, DH>(static_cast<const T*>(p.g) + b * p.sg.b + h * p.sg.h, p.sg.l,
               lq, gs, ld, p.vec);
  const long long rows = ((long long)b * p.heads + h) * lq;
  for (int i = threadIdx.x; i < lq; i += blockDim.x) {
    lse[i] = p.lse[rows + i];
    delta[i] = p.delta[rows + i];
  }
  __syncthreads();

  constexpr int kD = kLanesPer(DH);
  const int n_warps = blockDim.x / kWarp;
  for (int j = row0 + warp; j < row_end; j += n_warps) {
    load_row<T, DH>(static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h +
                        j * p.sk.l, krow, lane);
    load_row<T, DH>(static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h +
                        j * p.sv.l, vrow, lane);
    const bool padded = p.mask && p.mask[(long long)b * lk + j];
    __syncwarp();
    for (int i = lane; i < lq; i += kWarp) {
      float s = dot<DH>(krow, qs + i * ld) * p.scale;
      if (padded) s = -FLT_MAX;
      const float pij = expf(s - lse[i]);
      float dp = dot<DH>(vrow, gs + i * ld);
      float pd = pij;
      if (p.drop.on) {
        const float keep = keep_factor(p.drop, seed, b, h, i, j, lq, lk);
        pd *= keep;
        dp *= keep;
      }
      pdrow[i] = round_to(pd, T());
      dsrow[i] = round_to(pij * (dp - delta[i]) * p.scale, T());
    }
    __syncwarp();
    float acc_v[kD], acc_k[kD];
#pragma unroll
    for (int t = 0; t < kD; ++t) acc_v[t] = acc_k[t] = 0.f;
    for (int i = 0; i < lq; ++i) {
      const float pd = pdrow[i], ds = dsrow[i];
      const float* gr = gs + i * ld;
      const float* qr = qs + i * ld;
#pragma unroll
      for (int t = 0; t < kD; ++t)
        if (lane + t * kWarp < DH) {
          acc_v[t] = fmaf(pd, gr[lane + t * kWarp], acc_v[t]);
          acc_k[t] = fmaf(ds, qr[lane + t * kWarp], acc_k[t]);
        }
    }
    T* dv = static_cast<T*>(p.dv) + b * p.sdv.b + h * p.sdv.h + j * p.sdv.l;
    T* dk = static_cast<T*>(p.dk) + b * p.sdk.b + h * p.sdk.h + j * p.sdk.l;
#pragma unroll
    for (int t = 0; t < kD; ++t)
      if (lane + t * kWarp < DH) {
        store(dv + lane + t * kWarp, acc_v[t]);
        store(dk + lane + t * kWarp, acc_k[t]);
      }
    __syncwarp();
  }
}

// Shared-memory bytes of each kernel for (lq, lk, DH, warps).
size_t fwd_smem(int lk, int dh, int warps) {
  return sizeof(float) * (2 * (size_t)round4(lk * (dh + 1)) +
                          (size_t)warps * (round4(dh) + round4(lk))) +
         (size_t)lk;
}
size_t bwd_dq_smem(int lk, int dh, int warps) {
  return sizeof(float) * (2 * (size_t)round4(lk * (dh + 1)) +
                          (size_t)warps * (2 * round4(dh) + 2 * round4(lk))) +
         (size_t)lk;
}
size_t bwd_dkv_smem(int lq, int dh, int warps) {
  return sizeof(float) * (2 * (size_t)round4(lq * (dh + 1)) +
                          2 * (size_t)round4(lq) +
                          (size_t)warps * (2 * round4(dh) + 2 * round4(lq)));
}

template <typename K>
int launch(K kernel, dim3 grid, int warps, size_t smem, cudaStream_t stream,
           const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, warps * kWarp, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int forward(const Params& p, int batch, int warps, cudaStream_t s) {
  const dim3 grid(batch * p.heads, (p.lq + p.rows - 1) / p.rows);
  return launch(fwd_kernel<T, DH>, grid, warps, fwd_smem(p.lk, DH, warps), s,
                p);
}

template <typename T, int DH>
int backward(const Params& p, int batch, int warps, cudaStream_t s) {
  const dim3 grid_q(batch * p.heads, (p.lq + p.rows - 1) / p.rows);
  int rc = launch(bwd_dq_kernel<T, DH>, grid_q, warps,
                  bwd_dq_smem(p.lk, DH, warps), s, p);
  if (rc != 0) return rc;
  const dim3 grid_k(batch * p.heads, (p.lk + p.rows - 1) / p.rows);
  return launch(bwd_dkv_kernel<T, DH>, grid_k, warps,
                bwd_dkv_smem(p.lq, DH, warps), s, p);
}

// ------------------------------------------------ Hopper kernels (wgmma)
// bf16 at Dh = 64 with TMA-eligible views, Lk <= kSbMaxBoxes * 64 = 192
// (the caller's rule): every call of the train steps.  Layouts in
// flash_single_layout.h; the building blocks (wgmma, TMA, mbarriers) in
// hopper.cuh.  Keys past Lk come from TMA's zero fill and are no keys at
// all (kNoKey: excluded from the max and the sums, p = 0); masked keys score
// f32 min (kPaddedKey: p = exp(f32 min - m), which is 1 in a row whose every
// key is masked and 0 otherwise).
constexpr float kNeg = -FLT_MAX;  // a masked key's score
constexpr unsigned char kRealKey = 0, kPaddedKey = 1, kNoKey = 2;

// The tensor maps of q, k, v and g (the backward's d(out)), each
// [B, H, L, 64] in boxes of 64 rows, and the number of heads B * H.
struct SbMaps {
  CUtensorMap q, k, v, g;
  int items;
};

// keep_factor's hash for the elements of one head: the counter
// (h0 + h) Lq Lk + i Lk + j plus the example's seed term, murmur3-finalised;
// kept where it is >= the threshold.  `seed` is the call's (seed_of), which
// thread 0 copies to shared memory before the block's first barrier: read
// there at a static address it costs no address registers, and the forward
// reads it only where its last loop over the scores needs the hash (at the
// head's start the base would be live where the registers are fullest).
struct SbHash {
  unsigned int base;
  __device__ SbHash(const Dropout& d, unsigned int seed, int b, int h, int lq,
                    int lk) {
    const unsigned int seed_b = seed + (unsigned int)b * 0x9E3779B9u;
    base = (unsigned int)(d.h0 + h) * ((unsigned int)lq * (unsigned int)lk) +
           seed_b * 0x9E3779B9u;
  }
  __device__ bool kept(int i, int j, int lk, unsigned int threshold) const {
    unsigned int x =
        base + (unsigned int)i * (unsigned int)lk + (unsigned int)j;
    x = (x ^ (x >> 16)) * 0x85EBCA6Bu;  // murmur3 finalizer
    x = (x ^ (x >> 13)) * 0xC2B2AE35u;
    x ^= x >> 16;
    return x >= threshold;
  }
};

// Item n of a persistent block: the head blockIdx.x + n gridDim.x, as (b, h).
struct SbHead {
  int b, h;
  __device__ SbHead(int n, int heads) {
    const int item = blockIdx.x + n * gridDim.x;
    b = item / heads;
    h = item % heads;
  }
};

// The heads a persistent block walks: items blockIdx.x, blockIdx.x +
// gridDim.x, ... below `items`.
__device__ __forceinline__ int sb_heads(int items) {
  return (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
}

// --------------------------------------------------------------- kernel 2
// The forward, for Lk <= 16 NKS keys (NKS = ceil(Lk / 16)).  A persistent
// block of one producer warpgroup and two consumer warpgroups walks its
// heads; the tiles of 64 query rows of all of them form one stream, and
// consumer w takes the stream's tiles w, w + 2, ...
// - the producer warp loads each head's K and V once by TMA (NKB boxes of 64
//   rows each, zero-filled past Lk) into one of kKvBufs head buffers, with
//   the keys' padding bits beside it, then the head's Q tiles into a ring of
//   kSbQStages stages.  A head buffer is reused once both consumers are past
//   every tile of its head.
// - a consumer issues S = Q·Kᵀ over the head's keys rounded up to 16 (n64
//   products for whole boxes, one n16/n32/n48 for the last), releases its Q
//   stage, takes each row's exact max over its keys and then p = exp2(s·c -
//   m·log2(e)) (c = scale·log2(e); m, in natural-log units, is the raw max
//   times scale, so masked keys' f32 min is never scaled), their sum l, lse
//   = m + log l, and p·(1/l)·keep rounded to bf16 as the register A operand
//   of O = P·V (NKS products, V read MN-major).  Dropout and masking are
//   tested once a tile, not once a score.
// - rows past Lq compute on the zero fill and store nothing.
template <int NKS>
__global__ void __launch_bounds__(kWgThreads, 1)
    single_fwd_wgmma_kernel(__grid_constant__ const SbMaps maps,
                            const Params p) {
  constexpr int NKB = (NKS + 3) / 4;  // 64-key boxes
  constexpr int TAIL = NKS % 4;       // 16-key steps of a partial last box
  using L = SbFwdLayout<NKB>;
  __shared__ unsigned int sb_seed;
  const SmemBase sb = smem_base();
  const uint32_t bar = sb.base + L::kBar;
  auto kv_full = [&](int x) { return bar + 8 * x; };
  auto kv_empty = [&](int x) { return bar + 8 * (L::kKvBufs + x); };
  auto q_full = [&](int s) { return bar + 8 * (2 * L::kKvBufs + s); };
  auto q_empty = [&](int s) {
    return bar + 8 * (2 * L::kKvBufs + kSbQStages + s);
  };
  auto k_box = [&](int x, int c) {
    return sb.base + x * L::kKv + c * kSbBox;
  };
  auto v_box = [&](int x, int c) { return k_box(x, c) + NKB * kSbBox; };
  auto q_tile = [&](int s) { return sb.base + L::kQ + s * kSbBox; };
  auto pad_words = [&](int x) {
    return reinterpret_cast<uint32_t*>(sb.ptr + L::kPad +
                                       x * L::kPadWords * 4);
  };
  if (threadIdx.x == 0) {
    for (int x = 0; x < L::kKvBufs; ++x) {
      mbar_init(kv_full(x), 1);
      mbar_init(kv_empty(x), kWgConsumers * kWarpgroup / kWarp);
    }
    for (int s = 0; s < kSbQStages; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), kWarpgroup / kWarp);
    }
    mbar_init_fence();
    sb_seed = seed_of(p.drop);
  }
  __syncthreads();
  const int n_qt = (p.lq + kWgRows - 1) / kWgRows;
  const int n_heads = sb_heads(maps.items), n_tiles = n_heads * n_qt;

  if (threadIdx.x < kWarpgroup) {  // ------------------------- producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x >= kWarp) return;
    const int lane = threadIdx.x;
    for (int n = 0, t = 0; n < n_heads; ++n) {
      const SbHead hd(n, p.heads);
      const int x = n % L::kKvBufs;
      mbar_wait(kv_empty(x), ((n / L::kKvBufs) & 1) ^ 1);
      const unsigned char* mask =
          p.mask ? p.mask + (long long)hd.b * p.lk : nullptr;
      uint32_t bits[2 * NKB], any = 0u;
#pragma unroll
      for (int w = 0; w < 2 * NKB; ++w) {
        const int j = 32 * w + lane;
        bits[w] = __ballot_sync(0xffffffffu, mask && j < p.lk && mask[j]);
        any |= bits[w];
      }
      if (lane == 0) {
        uint32_t* words = pad_words(x);
#pragma unroll
        for (int w = 0; w < 2 * NKB; ++w) words[w] = bits[w];
        words[L::kPadWords - 1] = any;
        mbar_arrive_expect_tx(kv_full(x), 2 * NKB * kSbBox);
#pragma unroll
        for (int c = 0; c < NKB; ++c) {
          tma_load_rows(&maps.k, k_box(x, c), kv_full(x), c * kWgRows, hd.h,
                        hd.b);
          tma_load_rows(&maps.v, v_box(x, c), kv_full(x), c * kWgRows, hd.h,
                        hd.b);
        }
      }
      for (int qt = 0; qt < n_qt; ++qt, ++t) {
        const int s = t % kSbQStages;
        mbar_wait(q_empty(s), ((t / kSbQStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(q_full(s), kSbBox);
          tma_load_rows(&maps.q, q_tile(s), q_full(s), qt * kWgRows, hd.h,
                        hd.b);
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
  // the last 16-key step, the only one that can hold keys past Lk: box
  // kEdgeBox, 8-key groups kEdgeN and kEdgeN + 1
  constexpr int kEdgeBox = (NKS - 1) / 4, kEdgeN = 2 * ((NKS - 1) % 4);
  int released = 0;  // heads this warpgroup is past
  for (int u = wg; u < n_tiles; u += kWgConsumers) {
    const int n = u / n_qt, qt = u % n_qt, s = u % kSbQStages;
    const int x = n % L::kKvBufs;
    for (; released < n; ++released) {
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty(released % L::kKvBufs));
    }
    const SbHead hd(n, p.heads);
    mbar_wait(kv_full(x), (n / L::kKvBufs) & 1);
    mbar_wait(q_full(s), (u / kSbQStages) & 1);

    float sc[NKB][32];  // S, then P: box c's 64 keys
    const uint32_t qs = opaque(q_tile(s)), kb = opaque(k_box(x, 0));
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < NKB; ++cb)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t a = kmajor_desc(qs, k);
        const uint64_t b = kmajor_desc(kb + cb * kSbBox, k);
        if (cb < NKB - 1 || TAIL == 0)
          WgmmaSS<64>::run<0, 0>(sc[cb], a, b, k);
        else
          WgmmaSS<16 * (TAIL == 0 ? 4 : TAIL)>::template run<0, 0>(sc[cb], a,
                                                                   b, k);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NKB; ++cb)  // the tail box's live registers only
#pragma unroll
      for (int e = 0; e < (cb < NKB - 1 || TAIL == 0 ? 32 : 8 * TAIL); ++e)
        asm volatile("" : "+f"(sc[cb][e])::"memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty(s));  // Q is read

    const uint32_t* words = pad_words(x);
    const int i0 = qt * kWgRows;
    float m[2], inv[2];
    // P of the tile from S: masking and dropout are tested once a tile
    auto softmax = [&](auto drop, auto padded) {
      uint32_t w[2 * NKB];
      if constexpr (decltype(padded)::value)
#pragma unroll
        for (int z = 0; z < 2 * NKB; ++z) w[z] = words[z] >> (2 * f.q);
      // code of element e of 8-key group n in box cb
      auto code = [&](int cb, int n, int e) {
        unsigned char k = kRealKey;
        if constexpr (decltype(padded)::value)
          if ((w[2 * cb + (n >> 2)] >> (8 * (n & 3) + (e & 1))) & 1u)
            k = kPaddedKey;
        if (cb == kEdgeBox && (n >> 1) == (kEdgeN >> 1) &&
            64 * cb + f.col(n, e) >= p.lk)
          k = kNoKey;
        return k;
      };
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int cb = 0; cb < NKB; ++cb)
#pragma unroll
        for (int n = 0; n < (cb < NKB - 1 || TAIL == 0 ? 8 : 2 * TAIL); ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& v = sc[cb][4 * n + e];
            if (code(cb, n, e) != kRealKey) v = -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
          }
      float bias[2], l[2] = {0.f, 0.f};
      bool real[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        real[r] = mx[r] > -INFINITY;  // a row with a key that is not masked
        m[r] = real[r] ? mx[r] * p.scale : kNeg;
        bias[r] = real[r] ? m[r] * kLog2e : 0.f;
      }
#pragma unroll
      for (int cb = 0; cb < NKB; ++cb)
#pragma unroll
        for (int n = 0; n < (cb < NKB - 1 || TAIL == 0 ? 8 : 2 * TAIL); ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float& v = sc[cb][4 * n + e];
            float pv = exp2_approx(fmaf(v, c, -bias[r]));  // 0 from -inf
            if constexpr (decltype(padded)::value)
              if (!real[r]) pv = code(cb, n, e) == kPaddedKey ? 1.f : 0.f;
            l[r] += pv;
            v = pv;
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = 1.f / l[r];
        m[r] += logf(l[r]);  // lse
      }
      const SbHash hash(p.drop, sb_seed, hd.b, hd.h, p.lq, p.lk);
#pragma unroll
      for (int cb = 0; cb < NKB; ++cb)
#pragma unroll
        for (int n = 0; n < (cb < NKB - 1 || TAIL == 0 ? 8 : 2 * TAIL); ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pv = sc[cb][4 * n + e] * inv[e >> 1];
            if constexpr (decltype(drop)::value)
              pv = hash.kept(i0 + f.row(e), 64 * cb + f.col(n, e), p.lk,
                             p.drop.threshold)
                       ? pv * p.drop.scale
                       : 0.f;
            sc[cb][4 * n + e] = pv;
          }
    };
    const bool any = words[L::kPadWords - 1] != 0u;
    if (p.drop.on) {
      if (any)
        softmax(std::true_type(), std::true_type());
      else
        softmax(std::true_type(), std::false_type());
    } else {
      if (any)
        softmax(std::false_type(), std::true_type());
      else
        softmax(std::false_type(), std::false_type());
    }
    const long long rows = ((long long)hd.b * p.heads + hd.h) * p.lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + f.row(2 * r);
      if (f.q == 0 && i < p.lq) p.lse[rows + i] = m[r];
    }

    // O = round(P)·V over the NKS 16-key steps
    uint32_t a[NKS][4];
#pragma unroll
    for (int k = 0; k < NKS; ++k) acc_to_a(sc[k / 4], k % 4, a[k]);
    float o[32];  // the first product overwrites it
    const uint32_t vb = opaque(v_box(x, 0));
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < NKS; ++k)
      wgmma_rs<1>(o, a[k], mnmajor_desc(vb + (k / 4) * kSbBox, k % 4), k);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    fence_a(a);
    store_rows(o, static_cast<bf16*>(p.out) + hd.b * p.so.b + hd.h * p.so.h,
               p.so.l, i0, p.lq, f);
  }
  for (; released < n_heads; ++released) {
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty(released % L::kKvBufs));
  }
}

// --------------------------------------------------------------- kernel 3
// The backward in one pass and one launch, 5 products a tile: a persistent
// block of NW consumer warpgroups (NW = ceil(Lk / 64)) walks its heads;
// warpgroup w owns the head's keys [64 w, 64 w + 64).  K and V stay in shared
// memory for the head (two head buffers, so the next head's loads overlap
// this one's work), and dK and dV are summed in registers over the head's
// query tiles and stored once.  Thread 0 streams the (Q, dO) tiles of 64
// queries of all the block's heads through a ring of kStages stages by TMA,
// kStages - 1 tiles ahead, and K and V a head ahead: a stage or
// head buffer is reloaded after the barrier that follows the last products
// reading it, so no empty barriers are needed.  Per query tile, in
// sub-tiles of CW queries (CW = 32 at NW = 3, where 168 registers do not
// hold dK, dV, Sᵀ and dPᵀ of 64 queries beside the rest; else 64):
// - Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (rows: the warpgroup's keys), once;
// - p = exp2(s·c - lse·log2(e)) for real keys (the masked keys' p =
//   exp(f32 min - lse) comes from the side row, so f32 min is never
//   scaled), dp·keep with the keep bit hashed once and kept in a register,
//   and each warp's sums of dp·p over its keys for each query;
// - delta = sum over the whole row (every key is in the block): the sums
//   of the 4 NW warps through shared memory, added in a fixed order;
// - ds = round(p (dp - delta) scale) and pd = round(p keep), the register A
//   operands of dK += dSᵀ·Q and dV += Pdᵀ·dO, issued with the next
//   sub-tile's Sᵀ and dPᵀ; dSᵀ also goes to shared memory, where, once
//   every sub-tile's is there, dQ = dS·K (A read MN-major from the dSᵀ
//   tiles) is taken over all of the head's keys and written complete: by
//   warpgroup 0 at NW = 1, in two 32-column halves by warpgroups 0 and 1
//   otherwise (at NW = 3 warpgroup 2 repeats warpgroup 1's half and stores
//   nothing, so that every warpgroup issues the same products).
// No atomics: a deterministic result.
template <int NW>
__global__ void __launch_bounds__(NW* kWarpgroup, NW == 1 ? 2 : 1)
    single_bwd_wgmma_kernel(__grid_constant__ const SbMaps maps,
                            const Params p) {
  using L = SbBwdLayout<NW>;
  __shared__ unsigned int sb_seed;
  constexpr int kThreads = NW * kWarpgroup;
  constexpr int kDqCols = NW == 1 ? 64 : 32;  // dQ columns of a warpgroup
  constexpr int CW = NW == 3 ? 32 : 64;       // queries of a sub-tile
  constexpr int SUB = 64 / CW, KS = CW / 16;  // sub-tiles; their k-steps
  const SmemBase sb = smem_base();
  const uint32_t bar = sb.base + L::kBar;
  auto kv_full = [&](int x) { return bar + 8 * x; };
  auto full = [&](int s) { return bar + 8 * (L::kKvBufs + s); };
  auto k_box = [&](int x, int w) {
    return sb.base + x * L::kKv + w * kSbBox;
  };
  auto q_tile = [&](int s) { return sb.base + L::kStage + 2 * s * kSbBox; };
  float* side = reinterpret_cast<float*>(sb.ptr + L::kSide);
  float* partials = reinterpret_cast<float*>(sb.ptr + L::kPart);
  float* delta_s = reinterpret_cast<float*>(sb.ptr + L::kDelta);
  if (threadIdx.x == 0) {
    for (int x = 0; x < L::kKvBufs; ++x) mbar_init(kv_full(x), 1);
    for (int s = 0; s < L::kStages; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
    sb_seed = seed_of(p.drop);
  }
  __syncthreads();
  const int n_qt = (p.lq + kWgRows - 1) / kWgRows;
  const int n_heads = sb_heads(maps.items), n_tiles = n_heads * n_qt;
  // thread 0's loads: head n's K and V into buffer n % kKvBufs; tile u's Q
  // and dO into stage u % kStages
  auto load_kv = [&](int n) {
    const SbHead hd(n, p.heads);
    const int x = n % L::kKvBufs;
    mbar_arrive_expect_tx(kv_full(x), 2 * NW * kSbBox);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      tma_load_rows(&maps.k, k_box(x, w), kv_full(x), w * kWgRows, hd.h,
                    hd.b);
      tma_load_rows(&maps.v, k_box(x, w) + NW * kSbBox, kv_full(x),
                    w * kWgRows, hd.h, hd.b);
    }
  };
  auto load_tile = [&](int u) {
    const SbHead hd(u / n_qt, p.heads);
    const int s = u % L::kStages, row = (u % n_qt) * kWgRows;
    mbar_arrive_expect_tx(full(s), 2 * kSbBox);
    tma_load_rows(&maps.q, q_tile(s), full(s), row, hd.h, hd.b);
    tma_load_rows(&maps.g, q_tile(s) + kSbBox, full(s), row, hd.h, hd.b);
  };
  if (threadIdx.x == 0) {
    for (int n = 0; n < L::kKvBufs - 1 && n < n_heads; ++n) load_kv(n);
    for (int u = 0; u < L::kStages && u < n_tiles; ++u) load_tile(u);
  }

  const int wg = threadIdx.x / kWarpgroup, t = threadIdx.x % kWarpgroup;
  const int lane = t % kWarp;
  const Frag f{t / kWarp, lane >> 2, lane & 3};
  const float c = p.scale * kLog2e;
  float* lse2_row = side + wg * 2 * kWgRows;  // this warpgroup's side rows
  float* pp_row = lse2_row + kWgRows;
  float* part_row = partials + (wg * 4 + f.warp) * kWgRows;
  // the codes of this thread's two keys for head n, 2 bits each
  auto key_codes = [&](int n) {
    const SbHead hd(n, p.heads);
    int codes = 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = wg * kWgRows + f.row(2 * r);
      const int k = j >= p.lk ? kNoKey
                    : p.mask && p.mask[(long long)hd.b * p.lk + j]
                        ? kPaddedKey
                        : kRealKey;
      codes |= k << (2 * r);
    }
    return codes;
  };
  int code = 0, next_code = key_codes(0);
  float dk[32], dv[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;

  for (int u = 0; u < n_tiles; ++u) {
    const int n = u / n_qt, qt = u % n_qt, s = u % L::kStages;
    const int x = n % L::kKvBufs;
    const SbHead hd(n, p.heads);
    const int i0 = qt * kWgRows;
    if (qt == 0) {  // a new head: its keys' codes were loaded a head ago
      code = next_code;
      if (n + 1 < n_heads) next_code = key_codes(n + 1);
    }
    // this tile's lse, read while the first products run: rows past Lq get
    // lse2 = +inf and pp = 0, so their p is 0 (threads t and t + 64 write
    // the same values)
    const int r_own = t % kWgRows, i_own = i0 + r_own;
    const bool has_row = i_own < p.lq;
    const float lse_own =
        has_row ? p.lse[((long long)hd.b * p.heads + hd.h) * p.lq + i_own]
                : 0.f;
    mbar_wait(kv_full(x), (n / L::kKvBufs) & 1);
    mbar_wait(full(s), (u / L::kStages) & 1);

    float st[CW / 2], dpt[CW / 2];  // Sᵀ, dPᵀ of a sub-tile: rows the
    uint32_t apd[KS][4], ads[KS][4];  // warpgroup's keys, columns queries
    float dq[kDqCols / 2];
    // Sᵀ and dPᵀ over the queries of sub-tile sub
    auto issue_sdp = [&](int sub) {
      const uint32_t kw = opaque(k_box(x, wg));
      const uint32_t qs = opaque(q_tile(s)) + sub * CW * 128;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        WgmmaSS<CW>::template run<0, 0>(st, kmajor_desc(kw, k),
                                        kmajor_desc(qs, k), k);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        WgmmaSS<CW>::template run<0, 0>(dpt, kmajor_desc(kw + NW * kSbBox, k),
                                        kmajor_desc(qs + kSbBox, k), k);
    };
    // dV += Pdᵀ·dO and dK += dSᵀ·Q over the queries of sub-tile sub
    auto issue_dvdk = [&](int sub) {
      const uint32_t qs = opaque(q_tile(s));
#pragma unroll
      for (int k = 0; k < KS; ++k)
        wgmma_rs<1>(dv, apd[k], mnmajor_desc(qs + kSbBox, sub * KS + k));
#pragma unroll
      for (int k = 0; k < KS; ++k)
        wgmma_rs<1>(dk, ads[k], mnmajor_desc(qs, sub * KS + k));
    };
    // dQ = dS·K over the head's keys: this warpgroup's columns
    const int dq_col0 = NW == 1 ? 0 : 32 * (wg < 1 ? wg : 1);
    auto issue_dq = [&] {
      const uint32_t d0 = opaque(sb.base + L::kDs);
      const uint32_t k0 = opaque(k_box(x, 0) + 2 * dq_col0);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          WgmmaSS<kDqCols>::template run<1, 1>(
              dq, mnmajor_desc(d0 + w * kSbBox, k),
              mnmajor_desc(k0 + w * kSbBox, k), w + k);
    };

    wgmma_fence();
    issue_sdp(0);
    wgmma_commit();
    lse2_row[r_own] = has_row ? lse_own * kLog2e : INFINITY;
    pp_row[r_own] = has_row ? exp2_approx((kNeg - lse_own) * kLog2e) : 0.f;
    named_sync(4 + wg, kWarpgroup);
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);

    const SbHash hash(p.drop, sb_seed, hd.b, hd.h, p.lq, p.lk);
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      const int c0 = sub * CW;  // the sub-tile's first column
      // pass 1: p, dp·keep, the keep bits, and the warp's sums of dp·p
      // over its 16 keys for each query (reduced over the lanes g as soon
      // as a column pair is done; lane g = 0 writes them)
      uint32_t kept = 0xFFFFFFFFu;  // bit 4 n + e
      auto pass1 = [&](auto drop) {
#pragma unroll
        for (int n = 0; n < CW / 8; ++n) {
          const int col = c0 + f.col(n, 0);
          const float2 l2 = *reinterpret_cast<const float2*>(lse2_row + col);
          const float2 pp2 = *reinterpret_cast<const float2*>(pp_row + col);
          float part[2] = {0.f, 0.f};  // columns col and col + 1
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = (code >> (e & 2)) & 3;  // row e >> 1's code
            float pv = exp2_approx(
                fmaf(st[4 * n + e], c, -((e & 1) ? l2.y : l2.x)));
            pv = kc == kRealKey     ? pv
                 : kc == kPaddedKey ? ((e & 1) ? pp2.y : pp2.x)
                                    : 0.f;
            float dpk = dpt[4 * n + e];
            if constexpr (decltype(drop)::value) {
              if (hash.kept(i0 + col + (e & 1), wg * kWgRows + f.row(e),
                            p.lk, p.drop.threshold)) {
                dpk *= p.drop.scale;
              } else {
                dpk = 0.f;
                kept &= ~(1u << (4 * n + e));
              }
            }
            part[e & 1] = fmaf(dpk, pv, part[e & 1]);
            st[4 * n + e] = pv;
            dpt[4 * n + e] = dpk;
          }
#pragma unroll
          for (int z = 0; z < 2; ++z) {  // over the lanes g of the warp
            part[z] += __shfl_xor_sync(0xffffffffu, part[z], 4);
            part[z] += __shfl_xor_sync(0xffffffffu, part[z], 8);
            part[z] += __shfl_xor_sync(0xffffffffu, part[z], 16);
          }
          if (f.g == 0)
            *reinterpret_cast<float2*>(part_row + col) =
                make_float2(part[0], part[1]);
        }
      };
      if (p.drop.on)
        pass1(std::true_type());
      else
        pass1(std::false_type());
      named_sync(1, kThreads);
      // every warpgroup is past the products of tile u - 1: its stage and,
      // at a head's first tile, the buffer of head n - 1 may be reloaded
      if (sub == 0 && threadIdx.x == 0) {
        if (u >= 1 && u - 1 + L::kStages < n_tiles)
          load_tile(u - 1 + L::kStages);
        if (qt == 0 && n + L::kKvBufs - 1 < n_heads)
          load_kv(n + L::kKvBufs - 1);
      }
      if (threadIdx.x < CW) {
        float d = 0.f;
#pragma unroll
        for (int z = 0; z < 4 * NW; ++z)
          d += partials[z * kWgRows + c0 + threadIdx.x];
        delta_s[c0 + threadIdx.x] = d;
      }
      named_sync(2, kThreads);

      // pass 2: ds and pd, rounded into the A operands; dSᵀ to shared
      // memory: row = key (16 warp + g + 8 (z & 1)), 16-byte chunk
      // (c0 + 16 k) / 8 + (z >> 1) at chunk ^ (row % 8) (the 128-byte
      // swizzle), 4 bytes per q
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta_s + c0 + f.col(n, 0));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = st[4 * n + e];
          dpt[4 * n + e] =
              pv * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x)) * p.scale;
          st[4 * n + e] = (kept >> (4 * n + e)) & 1u
                              ? (p.drop.on ? pv * p.drop.scale : pv)
                              : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        acc_to_a(st, k, apd[k]);
        acc_to_a(dpt, k, ads[k]);
      }
      uint8_t* ds_ptr = sb.ptr + L::kDs + wg * kSbBox;
#pragma unroll
      for (int k = 0; k < KS; ++k)
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          const int row = 16 * f.warp + f.g + 8 * (z & 1);
          const int chunk = c0 / 8 + 2 * k + (z >> 1);
          *reinterpret_cast<uint32_t*>(ds_ptr + row * 128 +
                                       ((chunk ^ (row & 7)) << 4) +
                                       4 * f.q) = ads[k][z];
        }
      if (sub + 1 < SUB) {  // this sub-tile's dV, dK with the next's Sᵀ, dPᵀ
        wgmma_fence();
        issue_dvdk(sub);
        issue_sdp(sub + 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);
      } else {  // the last: its dV, dK and, with every dSᵀ written, dQ
        fence_proxy_async();
        named_sync(3, kThreads);
        wgmma_fence();
        issue_dvdk(sub);
        issue_dq();
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dq);
      }
      fence_acc(dv);
      fence_acc(dk);
      fence_a(apd);
      fence_a(ads);
    }

    if (NW != 3 || wg < 2) {  // warpgroup 2 repeats warpgroup 1's half
      bf16* dst = static_cast<bf16*>(p.out) + hd.b * p.so.b + hd.h * p.so.h +
                  dq_col0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + f.row(2 * r);
        if (i < p.lq)
#pragma unroll
          for (int n = 0; n < kDqCols / 8; ++n)
            *reinterpret_cast<uint32_t*>(dst + i * p.so.l + f.col(n, 0)) =
                pack(dq[4 * n + 2 * r], dq[4 * n + 2 * r + 1]);
      }
    }
    if (qt == n_qt - 1) {  // the head's last tile: dK and dV are complete
      store_rows(dk, static_cast<bf16*>(p.dk) + hd.b * p.sdk.b +
                         hd.h * p.sdk.h,
                 p.sdk.l, wg * kWgRows, p.lk, f);
      store_rows(dv, static_cast<bf16*>(p.dv) + hd.b * p.sdv.b +
                         hd.h * p.sdv.h,
                 p.sdv.l, wg * kWgRows, p.lk, f);
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;
    }
  }
}

// Host: the tensor maps of a launch (q, k, v; g for the backward) from
// Params' strides.  Returns 0 or a negative code of hopper.cuh's encoding.
int sb_maps(SbMaps* maps, const Params& p, int batch, bool backward) {
  int rc = encode_rows_map(&maps->q, p.q, batch, p.heads, p.lq, p.sq.b,
                           p.sq.h, p.sq.l);
  if (rc == 0)
    rc = encode_rows_map(&maps->k, p.k, batch, p.heads, p.lk, p.sk.b, p.sk.h,
                         p.sk.l);
  if (rc == 0)
    rc = encode_rows_map(&maps->v, p.v, batch, p.heads, p.lk, p.sv.b, p.sv.h,
                         p.sv.l);
  if (rc == 0 && backward)
    rc = encode_rows_map(&maps->g, p.g, batch, p.heads, p.lq, p.sg.b, p.sg.h,
                         p.sg.l);
  maps->items = batch * p.heads;
  return rc;
}

// A persistent launch of `kernel`: as many blocks as fit on the card at
// once (at most one per head).
template <class Kernel>
int sb_launch(Kernel kernel, int threads, size_t smem, const SbMaps& maps,
              const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0 || per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const int grid = maps.items < sms * per_sm ? maps.items : sms * per_sm;
  kernel<<<grid, threads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

template <int NKS>
int sb_forward_at(const SbMaps& maps, const Params& p, cudaStream_t s) {
  return sb_launch(single_fwd_wgmma_kernel<NKS>, kWgThreads,
                   SbFwdLayout<(NKS + 3) / 4>::kBytes, maps, p, s);
}

int sb_forward(const Params& p, int batch, cudaStream_t s) {
  SbMaps maps;
  const int rc = sb_maps(&maps, p, batch, false);
  if (rc != 0) return rc;
  switch ((p.lk + 15) / 16) {
    case 1: return sb_forward_at<1>(maps, p, s);
    case 2: return sb_forward_at<2>(maps, p, s);
    case 3: return sb_forward_at<3>(maps, p, s);
    case 4: return sb_forward_at<4>(maps, p, s);
    case 5: return sb_forward_at<5>(maps, p, s);
    case 6: return sb_forward_at<6>(maps, p, s);
    case 7: return sb_forward_at<7>(maps, p, s);
    case 8: return sb_forward_at<8>(maps, p, s);
    case 9: return sb_forward_at<9>(maps, p, s);
    case 10: return sb_forward_at<10>(maps, p, s);
    case 11: return sb_forward_at<11>(maps, p, s);
    case 12: return sb_forward_at<12>(maps, p, s);
  }
  return kBadVariant;  // more keys than the score rows hold
}

template <int NW>
int sb_backward_at(const SbMaps& maps, const Params& p, cudaStream_t s) {
  return sb_launch(single_bwd_wgmma_kernel<NW>, NW * kWarpgroup,
                   SbBwdLayout<NW>::kBytes, maps, p, s);
}

int sb_backward(const Params& p, int batch, cudaStream_t s) {
  SbMaps maps;
  const int rc = sb_maps(&maps, p, batch, true);
  if (rc != 0) return rc;
  switch (sb_boxes(p.lk)) {
    case 1: return sb_backward_at<1>(maps, p, s);
    case 2: return sb_backward_at<2>(maps, p, s);
    case 3: return sb_backward_at<3>(maps, p, s);
  }
  return kBadVariant;
}

// Calls fn(std::integral_constant<int, DH>) for the runtime head dim; -1 for
// one the kernels are not compiled for.
template <typename Fn>
int by_dim(int dh, Fn fn) {
  switch (dh) {
    case 16: return fn(std::integral_constant<int, 16>());
    case 32: return fn(std::integral_constant<int, 32>());
    case 64: return fn(std::integral_constant<int, 64>());
    case 128: return fn(std::integral_constant<int, 128>());
  }
  return -1;
}

Params make_params(const void* q, const void* k, const void* v,
                   const unsigned char* mask, float* lse, int heads, int lq,
                   int lk, int rows, float scale, const unsigned int* seed,
                   unsigned int threshold, float keep_scale, int dropout,
                   int h0, int vec) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.lse = lse;
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.rows = rows;
  p.scale = scale;
  p.drop = {seed, threshold, keep_scale, dropout, h0};
  p.vec = vec;
  return p;
}

Strides strides_at(const long long* s, int t) {
  return {s[3 * t], s[3 * t + 1], s[3 * t + 2]};
}

}  // namespace

extern "C" {

// Head dims the kernels are compiled for.
int fta_supported_dim(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128;
}

// Bytes of dynamic shared memory each launch needs (0: forward, 1: backward
// dq pass, 2: backward dk/dv pass); the caller checks them against the
// card's per-block limit before launching.
size_t fta_smem_bytes(int which, int lq, int lk, int dh, int warps) {
  if (which == 0) return fwd_smem(lk, dh, warps);
  if (which == 1) return bwd_dq_smem(lk, dh, warps);
  return bwd_dkv_smem(lq, dh, warps);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out share it).  strides: 12
// element strides, (b, h, l) of q, k, v, out.  lse: [B, H, Lq] f32 out.
// seed/threshold/keep_scale/dropout: the dropout mask (see the head of this
// file); seed points at the call's uint32 seed in device memory, read by
// the kernel (so a CUDA graph replays the launch under each step's seed),
// and may be null where dropout is off.  h0: the index of the call's first
// head among the layer's heads (0 unless a tensor-parallel rank holds a
// slice of them): the mask hashes h0 + h.  rows: query rows per block;
// warps: warps per block.  vec: 1 when every K/V row starts 16-byte aligned
// and Dh spans whole 16-byte words.
// Returns cudaGetLastError() after the launch (0 = success), -1 for an
// unsupported head dim.
int fta_forward(const void* q, const void* k, const void* v,
                const unsigned char* mask, void* out, float* lse, int dtype,
                int batch, int heads, int lq, int lk, int dh,
                const long long* strides, float scale,
                const unsigned int* seed,
                unsigned int threshold, float keep_scale, int dropout, int h0,
                int rows, int warps, int vec, void* stream) {
  Params p = make_params(q, k, v, mask, lse, heads, lq, lk, rows, scale, seed,
                         threshold, keep_scale, dropout, h0, vec);
  p.out = out;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return by_dim(dh, [&](auto d) {
      return forward<__nv_bfloat16, decltype(d)::value>(p, batch, warps, s);
    });
  return by_dim(dh, [&](auto d) {
    return forward<float, decltype(d)::value>(p, batch, warps, s);
  });
}

// Backward: two launches on `stream` (dq and delta, then dk and dv).
// strides: 21 element strides, (b, h, l) of q, k, v, g, dq, dk, dv.
// delta: [B, H, Lq] f32 scratch the first launch writes and the second
// reads.  vec covers q, k, v and g.  Other arguments as fta_forward.
int fta_backward(const void* q, const void* k, const void* v,
                 const unsigned char* mask, const float* lse, const void* g,
                 void* dq, void* dk, void* dv, float* delta, int dtype,
                 int batch, int heads, int lq, int lk, int dh,
                 const long long* strides, float scale,
                 const unsigned int* seed,
                 unsigned int threshold, float keep_scale, int dropout, int h0,
                 int rows, int warps, int vec, void* stream) {
  Params p = make_params(q, k, v, mask, const_cast<float*>(lse), heads, lq,
                         lk, rows, scale, seed, threshold, keep_scale,
                         dropout, h0, vec);
  p.g = g;
  p.out = dq;
  p.dk = dk;
  p.dv = dv;
  p.delta = delta;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.sg = strides_at(strides, 3);
  p.so = strides_at(strides, 4);
  p.sdk = strides_at(strides, 5);
  p.sdv = strides_at(strides, 6);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return by_dim(dh, [&](auto d) {
      return backward<__nv_bfloat16, decltype(d)::value>(p, batch, warps, s);
    });
  return by_dim(dh, [&](auto d) {
    return backward<float, decltype(d)::value>(p, batch, warps, s);
  });
}

// The Hopper kernels: bf16 at Dh = 64, q, k, v (and g for the backward)
// TMA-eligible (16-byte aligned base, unit feature stride, 16-byte multiple
// outer strides), Lk <= 192 (kBadVariant past it).  fta_wgmma_smem_bytes is
// the dynamic shared memory of launch `which` (0: forward, 1: backward) at
// Lk keys, within a block's limit at every Lk (flash_single_layout.h).
// fta_wgmma_forward and fta_wgmma_backward take the arguments of
// fta_forward and fta_backward (h0 included) less dtype, dh, rows, warps and
// vec, and the backward less delta (one pass: delta never leaves the SM).
// Each is one launch of a persistent grid.
size_t fta_wgmma_smem_bytes(int which, int lk) {
  return sb_smem_bytes(which, lk);
}

int fta_wgmma_forward(const void* q, const void* k, const void* v,
                      const unsigned char* mask, void* out, float* lse,
                      int batch, int heads, int lq, int lk,
                      const long long* strides, float scale,
                      const unsigned int* seed, unsigned int threshold,
                      float keep_scale, int dropout, int h0, void* stream) {
  Params p = make_params(q, k, v, mask, lse, heads, lq, lk, kWgRows, scale,
                         seed, threshold, keep_scale, dropout, h0, 1);
  p.out = out;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  return sb_forward(p, batch, static_cast<cudaStream_t>(stream));
}

int fta_wgmma_backward(const void* q, const void* k, const void* v,
                       const unsigned char* mask, const float* lse,
                       const void* g, void* dq, void* dk, void* dv, int batch,
                       int heads, int lq, int lk, const long long* strides,
                       float scale, const unsigned int* seed,
                       unsigned int threshold,
                       float keep_scale, int dropout, int h0, void* stream) {
  Params p = make_params(q, k, v, mask, const_cast<float*>(lse), heads, lq,
                         lk, kWgRows, scale, seed, threshold, keep_scale,
                         dropout, h0, 1);
  p.g = g;
  p.out = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.sg = strides_at(strides, 3);
  p.so = strides_at(strides, 4);
  p.sdk = strides_at(strides, 5);
  p.sdv = strides_at(strides, 6);
  return sb_backward(p, batch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
