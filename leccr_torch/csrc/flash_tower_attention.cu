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
// What bounds it: memory.  At the tower shapes (L <= 145, Dh = 64) one head
// does ~4 L^2 Dh flops forward against ~4 L Dh elements moved: at most ~70
// flops per byte in bf16, below the ~295 at which an H100 stops being
// memory-bound.  The least time is the bytes of q, k, v, out and lse
// (forward) or q, k, v, g, lse -> dq, dk, dv (backward) at 3.35 TB/s.
//
// What the design does about it: every input is read from device memory
// once per block, and the [L, L] scores, probabilities, masks and dp never
// leave the SM.  One block takes one (b, h) and a tile of rows; it stages
// that head's two [L, Dh] operands in shared memory as f32 (rows padded by
// one float, so lanes that walk different rows at the same feature hit
// different banks), and each warp owns one row at a time: lanes split the
// other side's rows for the dot products, warp shuffles give the row max
// and sums, lanes split the features for the weighted sums.  The backward
// is two launches: one per query row (dq and delta), one per key row (dk
// and dv, recomputing p from lse), so no block writes what another reads.
// Loads take the innermost stride 1 and any outer strides, so the caller
// passes head-split views without a transpose copy.  Tensor cores (wgmma,
// mma.sync) and TMA are left to a later change: this version spends its time
// on shared-memory traffic, not on device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;

struct Strides {
  long long b, h, l;  // element strides of dims 0, 1, 2; dim 3 has stride 1
};

struct Dropout {
  unsigned int seed;       // the call's int32 seed, as uint32
  unsigned int threshold;  // keep where hash >= threshold
  float scale;             // 1 / (1 - rate), in f32
  int on;                  // rate > 0
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

// The dropout factor of element (b, h, i, j) in {0, scale}.
__device__ __forceinline__ float keep_factor(const Dropout& d, int b, int h,
                                             int i, int j, int lq, int lk) {
  const unsigned int seed_b = d.seed + (unsigned int)b * 0x9E3779B9u;
  unsigned int x = (unsigned int)h * ((unsigned int)lq * (unsigned int)lk) +
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
                   int vec) {
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
  p.drop = {seed, threshold, keep_scale, dropout};
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
// file).  rows: query rows per block; warps: warps per block.  vec: 1 when
// every K/V row starts 16-byte aligned and Dh spans whole 16-byte words.
// Returns cudaGetLastError() after the launch (0 = success), -1 for an
// unsupported head dim.
int fta_forward(const void* q, const void* k, const void* v,
                const unsigned char* mask, void* out, float* lse, int dtype,
                int batch, int heads, int lq, int lk, int dh,
                const long long* strides, float scale, unsigned int seed,
                unsigned int threshold, float keep_scale, int dropout,
                int rows, int warps, int vec, void* stream) {
  Params p = make_params(q, k, v, mask, lse, heads, lq, lk, rows, scale, seed,
                         threshold, keep_scale, dropout, vec);
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
                 unsigned int threshold, float keep_scale, int dropout,
                 int rows, int warps, int vec, void* stream) {
  Params p = make_params(q, k, v, mask, const_cast<float*>(lse), heads, lq,
                         lk, rows, scale, seed, threshold, keep_scale,
                         dropout, vec);
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

}  // extern "C"
