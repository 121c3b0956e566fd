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
// once per block, and the [L, L] scores, probabilities, masks and dp never
// leave the SM.  One block takes one (b, h) and a tile of rows and stages
// the other side's two [L, Dh] operands of that head in shared memory.  The
// backward is two launches: one per query tile (delta, then dq), one per
// key tile (dk and dv, recomputing p from lse), so no block writes what
// another reads and nothing needs atomics.  Loads take the innermost stride
// 1 and any outer strides, so the caller passes head-split views without a
// transpose copy.  Two variants, chosen by the caller from the shapes before
// the launch (ops/flash_attention.py, single_block_variant):
// - tensor cores (`*_tc_kernel`), bf16 at Dh = 64 with 16-byte aligned
//   rows, every call of the train steps: a block is 4 warps of 16 rows; the
//   head's operands are staged as bf16 by cp.async (rows of 72 bf16, so
//   ldmatrix reads are free of bank conflicts), the products run on mma.sync
//   m16n8k16 with f32 accumulators, and each warp holds its rows as A
//   fragments and its sums as C fragments in registers, sweeping the staged
//   rows 32 at a time.  The row's exact max and sum come before any p is
//   rounded, and its delta before any ds: the forward holds the warp's
//   whole score rows in registers (one product q kᵀ and one exp per score;
//   up to 192 keys, past which the caller takes the scalar kernels), and
//   the dq pass sweeps the keys twice (delta = sum dp p; then ds and ds k),
//   recomputing the scores on the tensor cores rather than holding two
//   rows of them.
//   A product of two bf16 values is exact in f32, so only the order of the
//   f32 sums differs from the scalar bodies; the roundings to
//   bf16 (p, pd, ds, the outputs) sit at the same points, and scores stay
//   f32 with expf, so f32 min on a padded key never meets an overflow;
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

#include "tensor_core.cuh"

namespace {

struct Strides {
  long long b, h, l;  // element strides of dims 0, 1, 2; dim 3 has stride 1
};

struct Dropout {
  unsigned int seed;       // the call's int32 seed, as uint32
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

// The dropout factor of element (b, h, i, j) in {0, scale}; the counter
// takes the head's index among the layer's heads, h0 + h.
__device__ __forceinline__ float keep_factor(const Dropout& d, int b, int h,
                                             int i, int j, int lq, int lk) {
  const unsigned int seed_b = d.seed + (unsigned int)b * 0x9E3779B9u;
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
      if (p.drop.on) pj *= keep_factor(p.drop, b, h, i, j, lq, lk);
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
      if (p.drop.on) dp *= keep_factor(p.drop, b, h, i, j, lq, lk);
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
        const float keep = keep_factor(p.drop, b, h, i, j, lq, lk);
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

// ------------------------------------------------ tensor-core kernels
// bf16 at Dh = 64 with 16-byte aligned rows.  Each thread owns rows g and
// g + 8 of its warp's 16 (g = lane / 4, t = lane % 4): element e of an
// n-tile's C fragment lies in row g + 8 (e >> 1), column 8 nt + 2t + (e & 1).
// The staged side is swept in chunks of kChunk rows (keys, or queries in the
// dk/dv pass); rows past its length are staged as zeros and rounded up to a
// whole chunk, and the per-key code below keeps them out of every sum.
constexpr int kTcWarps = 4;             // warps of a block
constexpr int kTcRows = 16 * kTcWarps;  // rows a block owns (= ROWS)
constexpr int kChunk = 32;              // staged rows per sweep step
constexpr int kNT = kChunk / 8;         // n-tiles of a chunk
constexpr int kKS = kTcDim / 16;        // k-steps over the head dim
constexpr int kNF = kTcDim / 8;         // n-tiles over the head dim

// a key's code: a real key, a padded one (scores f32 min), or a staged row
// past Lk, which exists only because the chunk is rounded up: no key at all
constexpr unsigned char kRealKey = 0, kPaddedKey = 1, kNoKey = 2;

__host__ __device__ constexpr int round_chunk(int n) {
  return (n + kChunk - 1) / kChunk * kChunk;
}

// All of the block's threads start copying rows [0, rows) of a [n, 64] head
// matrix (row stride `stride`) into `dst` (row-major, pitch kRowPitch); rows
// at or past n become zeros.
__device__ __forceinline__ void stage_head(const bf16* src, long long stride,
                                           int n, int rows, bf16* dst) {
  constexpr int per_row = kTcDim / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e % per_row) * 8;
    const bool valid = r < n;
    cp_async16(dst + r * kRowPitch + c, src + (valid ? r * stride : 0) + c,
               valid);
  }
}

// The head (b, h)'s K and V, all round_chunk(Lk) rows, and each key's code.
// Shared memory: K, V [round_chunk(Lk)][kRowPitch] bf16, then the codes.
__device__ __forceinline__ void stage_keys(const Params& p, int b, int h,
                                           bf16* ks, bf16* vs,
                                           unsigned char* code) {
  const int lkc = round_chunk(p.lk);
  stage_head(static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h, p.sk.l,
             p.lk, lkc, ks);
  stage_head(static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h, p.sv.l,
             p.lk, lkc, vs);
  cp_async_commit();
  for (int j = threadIdx.x; j < lkc; j += blockDim.x)
    code[j] = j >= p.lk ? kNoKey
              : p.mask && p.mask[(long long)b * p.lk + j] ? kPaddedKey
                                                          : kRealKey;
}

// The f32 score of product `acc` for a key of code `c`: scaled, or f32 min
// for a padded key.
__device__ __forceinline__ float score(float acc, unsigned char c,
                                      float scale) {
  return c == kPaddedKey ? -FLT_MAX : acc * scale;
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// Rows r of a warp's 16 as bf16 pairs from C fragments: row row0 + g + 8 r,
// features 8 nf + 2t and 8 nf + 2t + 1 of a head matrix at `dst` (row
// stride `stride`); rows at or past n are not written.
__device__ __forceinline__ void store_rows(const float (&acc)[kNF][4],
                                           bf16* dst, long long stride,
                                           int row0, int n) {
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    if (i < n)
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf)
        *reinterpret_cast<uint32_t*>(dst + i * stride + 8 * nf + 2 * t) =
            pack(acc[nf][2 * r], acc[nf][2 * r + 1]);
  }
}

// The forward (kernel 2): one block per (b, h, kTcRows query rows), for
// Lk <= NC kChunk.  The warp's whole score rows stay in registers: one
// product q kᵀ and one exp per score, the row's exact max and sum before any
// p is rounded.
template <int NC>
__global__ void __launch_bounds__(kTcWarps* kWarp) fwd_tc_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int lkc = round_chunk(p.lk);
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* vs = ks + lkc * kRowPitch;
  unsigned char* code = reinterpret_cast<unsigned char*>(vs + lkc * kRowPitch);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kTcRows + warp * 16;

  stage_keys(p, b, h, ks, vs, code);
  uint32_t qa[kKS][4];
  load_a(static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.l,
         row0, p.lq, qa);
  cp_async_wait<0>();
  __syncthreads();
  if (row0 >= p.lq) return;  // warp-uniform, and no barrier follows

  // the scores, -inf for keys past Lk (so exp gives them 0 and the max,
  // taken over at least one real or padded key, never sees them)
  float s[NC][kNT][4], m[2] = {-FLT_MAX, -FLT_MAX}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    zero(s[c]);
    mma_nt<kNT, kKS>(s[c], qa, ks + c * kChunk * kRowPitch);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned char k = code[c * kChunk + 8 * nt + 2 * t + (e & 1)];
        s[c][nt][e] = k == kNoKey ? -INFINITY
                                  : score(s[c][nt][e], k, p.scale);
        m[e >> 1] = fmaxf(m[e >> 1], s[c][nt][e]);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][nt][e] = expf(s[c][nt][e] - m[e >> 1]);
        sum[e >> 1] += s[c][nt][e];
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = quad_sum(sum[r]);
    const int i = row0 + g + 8 * r;
    if (i < p.lq && t == 0)
      p.lse[((long long)b * p.heads + h) * p.lq + i] = m[r] + logf(sum[r]);
  }
  // p = exp(s - max) / sum times keep, rounded; out += round(p) v
  float o[kNF][4];
  zero(o);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pj = s[c][nt][e] / sum[r];
        if (p.drop.on)
          pj *= keep_factor(p.drop, b, h, row0 + g + 8 * r,
                            c * kChunk + 8 * nt + 2 * t + (e & 1), p.lq, p.lk);
        s[c][nt][e] = pj;
      }
    uint32_t pa[kNT / 2][4];  // round(p) as A fragments over the chunk's keys
    c_to_a<kNT / 2>(s[c], pa);
    mma_nn<kNF, kNT / 2>(o, pa, vs + c * kChunk * kRowPitch);
  }
  store_rows(o, static_cast<bf16*>(p.out) + b * p.so.b + h * p.so.h, p.so.l,
             row0, p.lq);
}

// The backward's dq pass (kernel 3, first launch): one block per (b, h,
// kTcRows query rows); writes delta for the dk/dv pass.
__global__ void __launch_bounds__(kTcWarps* kWarp)
    bwd_dq_tc_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int lkc = round_chunk(p.lk);
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* vs = ks + lkc * kRowPitch;
  unsigned char* code = reinterpret_cast<unsigned char*>(vs + lkc * kRowPitch);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kTcRows + warp * 16;
  const long long rows = ((long long)b * p.heads + h) * p.lq;

  stage_keys(p, b, h, ks, vs, code);
  uint32_t qa[kKS][4], ga[kKS][4];
  load_a(static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.l,
         row0, p.lq, qa);
  load_a(static_cast<const bf16*>(p.g) + b * p.sg.b + h * p.sg.h, p.sg.l,
         row0, p.lq, ga);
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    lse[r] = i < p.lq ? p.lse[rows + i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (row0 >= p.lq) return;

  // sweep 1: delta = sum_j dp p over the keys, from the unrounded p
  float delta[2] = {0.f, 0.f};
  for (int c0 = 0; c0 < lkc; c0 += kChunk) {
    float s[kNT][4], dp[kNT][4];
    zero(s);
    zero(dp);
    mma_nt<kNT, kKS>(s, qa, ks + c0 * kRowPitch);
    mma_nt<kNT, kKS>(dp, ga, vs + c0 * kRowPitch);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, j = c0 + 8 * nt + 2 * t + (e & 1);
        const unsigned char c = code[j];
        if (c != kNoKey) {
          const float pij = expf(score(s[nt][e], c, p.scale) - lse[r]);
          float dpv = dp[nt][e];
          if (p.drop.on)
            dpv *= keep_factor(p.drop, b, h, row0 + g + 8 * r, j, p.lq, p.lk);
          delta[r] = fmaf(dpv, pij, delta[r]);
        }
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    delta[r] = quad_sum(delta[r]);
    const int i = row0 + g + 8 * r;
    if (i < p.lq && t == 0) p.delta[rows + i] = delta[r];
  }
  // sweep 2: ds = round(p (dp - delta) scale); dq += ds k
  float dq[kNF][4];
  zero(dq);
  for (int c0 = 0; c0 < lkc; c0 += kChunk) {
    float s[kNT][4], dp[kNT][4];
    zero(s);
    zero(dp);
    mma_nt<kNT, kKS>(s, qa, ks + c0 * kRowPitch);
    mma_nt<kNT, kKS>(dp, ga, vs + c0 * kRowPitch);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, j = c0 + 8 * nt + 2 * t + (e & 1);
        const unsigned char c = code[j];
        float ds = 0.f;
        if (c != kNoKey) {
          const float pij = expf(score(s[nt][e], c, p.scale) - lse[r]);
          float dpv = dp[nt][e];
          if (p.drop.on)
            dpv *= keep_factor(p.drop, b, h, row0 + g + 8 * r, j, p.lq, p.lk);
          ds = pij * (dpv - delta[r]) * p.scale;
        }
        s[nt][e] = ds;
      }
    uint32_t dsa[kNT / 2][4];  // round(ds) as A fragments over the keys
    c_to_a<kNT / 2>(s, dsa);
    mma_nn<kNF, kNT / 2>(dq, dsa, ks + c0 * kRowPitch);
  }
  store_rows(dq, static_cast<bf16*>(p.out) + b * p.so.b + h * p.so.h, p.so.l,
             row0, p.lq);
}

// The backward's dk/dv pass (kernel 3, second launch): one block per (b, h,
// kTcRows key rows), sweeping the queries.  Shared memory: Q, G
// [round_chunk(Lq)][kRowPitch] bf16, then lse and delta [round_chunk(Lq)].
__global__ void __launch_bounds__(kTcWarps* kWarp)
    bwd_dkv_tc_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int lqc = round_chunk(p.lq);
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* gs = qs + lqc * kRowPitch;
  float* lse_s = reinterpret_cast<float*>(gs + lqc * kRowPitch);
  float* delta_s = lse_s + lqc;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kTcRows + warp * 16;
  const long long rows = ((long long)b * p.heads + h) * p.lq;

  stage_head(static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.l,
             p.lq, lqc, qs);
  stage_head(static_cast<const bf16*>(p.g) + b * p.sg.b + h * p.sg.h, p.sg.l,
             p.lq, lqc, gs);
  cp_async_commit();
  for (int i = threadIdx.x; i < lqc; i += blockDim.x) {
    lse_s[i] = i < p.lq ? p.lse[rows + i] : 0.f;
    delta_s[i] = i < p.lq ? p.delta[rows + i] : 0.f;
  }
  uint32_t ka[kKS][4], va[kKS][4];
  load_a(static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h, p.sk.l,
         row0, p.lk, ka);
  load_a(static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h, p.sv.l,
         row0, p.lk, va);
  bool padded[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = row0 + g + 8 * r;
    padded[r] = j < p.lk && p.mask && p.mask[(long long)b * p.lk + j];
  }
  cp_async_wait<0>();
  __syncthreads();
  if (row0 >= p.lk) return;

  float dk[kNF][4], dv[kNF][4];
  zero(dk);
  zero(dv);
  for (int c0 = 0; c0 < lqc; c0 += kChunk) {
    float s[kNT][4], dp[kNT][4];  // transposed: rows = keys, columns = queries
    zero(s);
    zero(dp);
    mma_nt<kNT, kKS>(s, ka, qs + c0 * kRowPitch);
    mma_nt<kNT, kKS>(dp, va, gs + c0 * kRowPitch);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = c0 + 8 * nt + 2 * t + (e & 1);
        float pd = 0.f, ds = 0.f;
        if (i < p.lq) {
          const float sv = padded[r] ? -FLT_MAX : s[nt][e] * p.scale;
          const float pij = expf(sv - lse_s[i]);
          float dpv = dp[nt][e];
          pd = pij;
          if (p.drop.on) {
            const float keep = keep_factor(p.drop, b, h, i, row0 + g + 8 * r,
                                           p.lq, p.lk);
            pd *= keep;
            dpv *= keep;
          }
          ds = pij * (dpv - delta_s[i]) * p.scale;
        }
        dp[nt][e] = pd;
        s[nt][e] = ds;
      }
    uint32_t pda[kNT / 2][4], dsa[kNT / 2][4];  // round(pd), round(ds)
    c_to_a<kNT / 2>(dp, pda);
    c_to_a<kNT / 2>(s, dsa);
    mma_nn<kNF, kNT / 2>(dv, pda, gs + c0 * kRowPitch);
    mma_nn<kNF, kNT / 2>(dk, dsa, qs + c0 * kRowPitch);
  }
  store_rows(dk, static_cast<bf16*>(p.dk) + b * p.sdk.b + h * p.sdk.h,
             p.sdk.l, row0, p.lk);
  store_rows(dv, static_cast<bf16*>(p.dv) + b * p.sdv.b + h * p.sdv.h,
             p.sdv.l, row0, p.lk);
}

// Shared-memory bytes of each tensor-core launch (0: forward, 1: dq pass,
// 2: dk/dv pass): two staged [round_chunk(L)][kRowPitch] bf16 operands, then
// a code byte per key or lse and delta per query.
size_t tc_smem(int which, int lq, int lk) {
  const size_t operands = 2 * (size_t)kRowPitch * sizeof(bf16);
  if (which == 2)
    return (size_t)round_chunk(lq) * (operands + 2 * sizeof(float));
  return (size_t)round_chunk(lk) * (operands + 1);
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

// The forward's register-resident score rows: Lk <= 192 (the caller's rule).
constexpr int kMaxKeyChunks = 6;

int tc_forward(const Params& p, int batch, cudaStream_t s) {
  const dim3 grid(batch * p.heads, (p.lq + kTcRows - 1) / kTcRows);
  const size_t smem = tc_smem(0, p.lq, p.lk);
  switch (round_chunk(p.lk) / kChunk) {
    case 1: return launch(fwd_tc_kernel<1>, grid, kTcWarps, smem, s, p);
    case 2: return launch(fwd_tc_kernel<2>, grid, kTcWarps, smem, s, p);
    case 3: return launch(fwd_tc_kernel<3>, grid, kTcWarps, smem, s, p);
    case 4: return launch(fwd_tc_kernel<4>, grid, kTcWarps, smem, s, p);
    case 5: return launch(fwd_tc_kernel<5>, grid, kTcWarps, smem, s, p);
    case kMaxKeyChunks:
      return launch(fwd_tc_kernel<kMaxKeyChunks>, grid, kTcWarps, smem, s, p);
  }
  return -1;  // more keys than the score rows hold
}

int tc_backward(const Params& p, int batch, cudaStream_t s) {
  const dim3 grid_q(batch * p.heads, (p.lq + kTcRows - 1) / kTcRows);
  int rc = launch(bwd_dq_tc_kernel, grid_q, kTcWarps, tc_smem(1, p.lq, p.lk),
                  s, p);
  if (rc != 0) return rc;
  const dim3 grid_k(batch * p.heads, (p.lk + kTcRows - 1) / kTcRows);
  return launch(bwd_dkv_tc_kernel, grid_k, kTcWarps, tc_smem(2, p.lq, p.lk),
                s, p);
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
                   int lk, int rows, float scale, unsigned int seed,
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
// file).  h0: the index of the call's first head among the layer's heads
// (0 unless a tensor-parallel rank holds a slice of them): the mask hashes
// h0 + h.  rows: query rows per block; warps: warps per block.  vec: 1 when
// every K/V row starts 16-byte aligned and Dh spans whole 16-byte words.
// Returns cudaGetLastError() after the launch (0 = success), -1 for an
// unsupported head dim.
int fta_forward(const void* q, const void* k, const void* v,
                const unsigned char* mask, void* out, float* lse, int dtype,
                int batch, int heads, int lq, int lk, int dh,
                const long long* strides, float scale, unsigned int seed,
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
                 const long long* strides, float scale, unsigned int seed,
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

// The tensor-core kernels: bf16 at Dh = 64, every staged row (K and V; Q and
// G for the backward) 16-byte aligned, Lk <= 192 (fta_tc_forward returns -1
// past it).  fta_tc_smem_bytes is the shared
// memory of launch `which` (0: forward, 1: dq pass, 2: dk/dv pass), which
// the caller checks against the card's per-block limit.  fta_tc_forward and
// fta_tc_backward take the arguments of fta_forward and fta_backward (h0
// included) less
// dtype, dh, rows, warps and vec (a block owns kTcRows = 64 rows).
size_t fta_tc_smem_bytes(int which, int lq, int lk) {
  return tc_smem(which, lq, lk);
}

int fta_tc_forward(const void* q, const void* k, const void* v,
                   const unsigned char* mask, void* out, float* lse,
                   int batch, int heads, int lq, int lk,
                   const long long* strides, float scale, unsigned int seed,
                   unsigned int threshold, float keep_scale, int dropout,
                   int h0, void* stream) {
  Params p = make_params(q, k, v, mask, lse, heads, lq, lk, kTcRows, scale,
                         seed, threshold, keep_scale, dropout, h0, 1);
  p.out = out;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  return tc_forward(p, batch, static_cast<cudaStream_t>(stream));
}

int fta_tc_backward(const void* q, const void* k, const void* v,
                    const unsigned char* mask, const float* lse, const void* g,
                    void* dq, void* dk, void* dv, float* delta, int batch,
                    int heads, int lq, int lk, const long long* strides,
                    float scale, unsigned int seed, unsigned int threshold,
                    float keep_scale, int dropout, int h0, void* stream) {
  Params p = make_params(q, k, v, mask, const_cast<float*>(lse), heads, lq,
                         lk, kTcRows, scale, seed, threshold, keep_scale,
                         dropout, h0, 1);
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
  return tc_backward(p, batch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
