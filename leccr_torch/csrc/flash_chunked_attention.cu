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
// loops become (a) a grid over (b, h, 64-row tiles) and (b) a loop inside the
// block over 128-row tiles of the other side, staged in shared memory.  The
// backward is two launches, deterministic and without atomics: one over query
// rows (delta and dq), one over key rows (dk and dv), as in the single-block
// kernels.  The ragged edge is handled in the kernels: rows past L are never
// read or written, keys past Lk count as padding, and nothing is padded in
// device memory.  Loads take the innermost stride 1 and any outer strides
// (head-split views, CLIP's packed in_proj chunks), and outputs go to
// [B, L, H, Dh] storage, so no transpose copies are needed.  Two variants:
// - bf16 at Dh = 64 with 16-byte aligned rows (the path: every tower has
//   64-wide heads) does its products on tensor cores (mma.sync, see the
//   "tensor-core kernels" section below);
// - every other case runs scalar f32 FMAs: tiles staged as f32 (rows padded
//   by one float so that lanes walking different rows at the same feature
//   hit different banks), each of the block's 8 warps owning 8 rows whose
//   state it carries across tiles in registers; lanes split a tile's 128
//   rows for the dot products, warp shuffles give the max and sums, lanes
//   split the features for the weighted sums.
// Both stay far above the bound (see PERF.md): no TMA, no wgmma, no
// pipelining of the tile loads, one 64-row tile per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 128;        // rows of the streamed tile (TPU _CHUNK)
constexpr int kWarps = 8;         // warps per block
constexpr int kRowsPerWarp = 8;   // rows each warp owns
constexpr int kRows = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kPerLane = kTile / kWarp;       // tile rows a lane scores

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
  const void* g;              // backward: d(out)
  const void* o;              // backward: the forward's (rounded) output
  const unsigned char* mask;  // [B, Lk] bool, nonzero = padding; or null
  void* out;                  // forward: out; backward: dq
  void* dk;
  void* dv;
  float* lse;    // [B, H, Lq] f32
  float* delta;  // [B, H, Lq] f32 (backward scratch)
  Strides sq, sk, sv, sg, so, sout, sdk, sdv;
  int heads, lq, lk, hg;  // hg: heads per dropout head group
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
// jnp.isfinite: false for +-inf and NaN.
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

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

// The dropout factor of element (b, h, i, j) in {0, scale}: the tile hash.
__device__ __forceinline__ float tile_keep(const Dropout& d, int b, int h,
                                           int hg, int i, int j) {
  const unsigned int seed_b = d.seed + (unsigned int)b * 0x9E3779B9u;
  const unsigned int hi = h / hg, hh = h % hg;
  const unsigned int qi = i / kTile, kj = j / kTile;
  unsigned int x = hh * (unsigned int)(kTile * kTile) +
                   (unsigned int)(i % kTile) * kTile + (unsigned int)(j % kTile);
  x += seed_b * 0x9E3779B9u + hi * 0x27D4EB2Fu + qi * 0x85EBCA77u +
       kj * 0xC2B2AE3Du;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;  // murmur3 finalizer
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= d.threshold ? d.scale : 0.f;
}

// All of the block's threads copy rows [0, n) of a [n, DH] head matrix (row
// stride `stride` elements) into shared memory as f32, row pitch `ld`.
template <typename T, int DH>
__device__ __forceinline__ void stage(const T* src, long long stride, int n,
                                      float* dst, int ld, int vec) {
  if (vec) {
    constexpr int w = Vec<T>::n, per_row = DH / w;
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

// a . b over DH features: `a` is a 16-byte aligned row that every lane of
// the warp reads (a broadcast), `b` a padded row of a staged tile.
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
__host__ __device__ constexpr int lanes_per(int dh) {
  return (dh + kWarp - 1) / kWarp;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// floats of one staged [kTile][DH+1] tile
__host__ __device__ constexpr int tile_floats(int dh) {
  return round4(kTile * (dh + 1));
}

// ------------------------------------------------------------- forward
// Shared memory (floats): the block's Q rows [kRows][DH], the K and V tiles
// [kTile][DH+1], per warp a p row [kTile], then the tile's padding as bytes.
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps* kWarp)
    chunk_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int ld = DH + 1, kD = lanes_per(DH);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* qs = smem;
  float* ks = qs + kRows * DH;
  float* vs = ks + tile_floats(DH);
  float* prow = vs + tile_floats(DH) + warp * kTile;
  unsigned char* pad =
      reinterpret_cast<unsigned char*>(vs + tile_floats(DH) + kWarps * kTile);

  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kRows;
  stage<T, DH>(static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h +
                   row0 * p.sq.l,
               p.sq.l, min(kRows, p.lq - row0), qs, DH, p.vec);
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kD];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kD; ++t) acc[r][t] = 0.f;
  }

  const int n_tiles = (p.lk + kTile - 1) / kTile;
  for (int kj = 0; kj < n_tiles; ++kj) {
    const int j0 = kj * kTile, n_keys = min(kTile, p.lk - j0);
    __syncthreads();  // every warp is done with the previous tile
    stage<T, DH>(kg + j0 * p.sk.l, p.sk.l, n_keys, ks, ld, p.vec);
    stage<T, DH>(vg + j0 * p.sv.l, p.sv.l, n_keys, vs, ld, p.vec);
    for (int j = threadIdx.x; j < kTile; j += blockDim.x)
      pad[j] = j >= n_keys ||
               (p.mask && p.mask[(long long)b * p.lk + j0 + j]);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = row0 + warp + r * kWarps;
      if (i < p.lq) {  // warp-uniform
        const float* qrow = qs + (i - row0) * DH;
        float s[kPerLane];
        float tmax = -INFINITY;
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          const int j = lane + t * kWarp;
          s[t] = pad[j] ? -INFINITY : dot<DH>(qrow, ks + j * ld) * p.scale;
          tmax = fmaxf(tmax, s[t]);
        }
        const float m_new = fmaxf(m[r], warp_max(tmax));
        const float safe_m = finite(m_new) ? m_new : 0.f;
        const float alpha = finite(m[r]) ? expf(m[r] - safe_m) : 0.f;
        float psum = 0.f;
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          const int j = lane + t * kWarp;
          float pj = finite(s[t]) ? expf(s[t] - safe_m) : 0.f;
          psum += pj;
          if (p.drop.on) pj *= tile_keep(p.drop, b, h, p.hg, i, j0 + j);
          prow[j] = round_to(pj, T());
        }
        l[r] = l[r] * alpha + warp_sum(psum);
        m[r] = m_new;
        __syncwarp();  // prow is read by every lane below
        float pv[kD];
#pragma unroll
        for (int t = 0; t < kD; ++t) pv[t] = 0.f;
        for (int j = 0; j < n_keys; ++j) {
          const float pj = prow[j];
          const float* vr = vs + j * ld;
#pragma unroll
          for (int t = 0; t < kD; ++t)
            if (lane + t * kWarp < DH)
              pv[t] = fmaf(pj, vr[lane + t * kWarp], pv[t]);
        }
#pragma unroll
        for (int t = 0; t < kD; ++t) acc[r][t] = acc[r][t] * alpha + pv[t];
        __syncwarp();  // prow is rewritten for the next row
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + warp + r * kWarps;
    if (i < p.lq) {
      const float safe = l[r] > 0.f ? l[r] : 1.f;
      T* og = static_cast<T*>(p.out) + b * p.sout.b + h * p.sout.h +
              i * p.sout.l;
#pragma unroll
      for (int t = 0; t < kD; ++t)
        if (lane + t * kWarp < DH) store(og + lane + t * kWarp, acc[r][t] / safe);
      if (lane == 0)
        p.lse[((long long)b * p.heads + h) * p.lq + i] =
            l[r] > 0.f ? m[r] + logf(safe) : -INFINITY;
    }
  }
}

// ------------------------------------- backward, pass 1: delta and dq
// Shared memory (floats): the block's Q and G rows [kRows][DH], the K and V
// tiles [kTile][DH+1], per warp a ds row [kTile], then the padding bytes.
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps* kWarp)
    chunk_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int ld = DH + 1, kD = lanes_per(DH);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* qs = smem;
  float* gs = qs + kRows * DH;
  float* ks = gs + kRows * DH;
  float* vs = ks + tile_floats(DH);
  float* dsrow = vs + tile_floats(DH) + warp * kTile;
  unsigned char* pad =
      reinterpret_cast<unsigned char*>(vs + tile_floats(DH) + kWarps * kTile);

  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kRows;
  const int n_rows = min(kRows, p.lq - row0);
  stage<T, DH>(static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h +
                   row0 * p.sq.l,
               p.sq.l, n_rows, qs, DH, p.vec);
  stage<T, DH>(static_cast<const T*>(p.g) + b * p.sg.b + h * p.sg.h +
                   row0 * p.sg.l,
               p.sg.l, n_rows, gs, DH, p.vec);
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const long long rows = ((long long)b * p.heads + h) * p.lq;
  __syncthreads();  // gs is read below

  // delta = rowsum(g * out) from the rounded output, and each row's lse
  float lse[kRowsPerWarp], delta[kRowsPerWarp], acc[kRowsPerWarp][kD];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + warp + r * kWarps;
    lse[r] = delta[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kD; ++t) acc[r][t] = 0.f;
    if (i < p.lq) {
      const T* orow = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h +
                      i * p.so.l;
      const float* grow = gs + (i - row0) * DH;
      float partial = 0.f;
      for (int d = lane; d < DH; d += kWarp)
        partial = fmaf(grow[d], to_f32(orow[d]), partial);
      delta[r] = warp_sum(partial);
      lse[r] = p.lse[rows + i];
      if (lane == 0) p.delta[rows + i] = delta[r];
    }
  }

  const int n_tiles = (p.lk + kTile - 1) / kTile;
  for (int kj = 0; kj < n_tiles; ++kj) {
    const int j0 = kj * kTile, n_keys = min(kTile, p.lk - j0);
    __syncthreads();
    stage<T, DH>(kg + j0 * p.sk.l, p.sk.l, n_keys, ks, ld, p.vec);
    stage<T, DH>(vg + j0 * p.sv.l, p.sv.l, n_keys, vs, ld, p.vec);
    for (int j = threadIdx.x; j < kTile; j += blockDim.x)
      pad[j] = j >= n_keys ||
               (p.mask && p.mask[(long long)b * p.lk + j0 + j]);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = row0 + warp + r * kWarps;
      if (i < p.lq) {
        const float* qrow = qs + (i - row0) * DH;
        const float* grow = gs + (i - row0) * DH;
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          const int j = lane + t * kWarp;
          float ds = 0.f;
          if (!pad[j]) {
            const float s = dot<DH>(qrow, ks + j * ld) * p.scale;
            const float pij = finite(lse[r]) ? expf(s - lse[r]) : 0.f;
            float dp = dot<DH>(grow, vs + j * ld);
            if (p.drop.on) dp *= tile_keep(p.drop, b, h, p.hg, i, j0 + j);
            ds = round_to(pij * (dp - delta[r]) * p.scale, T());
          }
          dsrow[j] = ds;
        }
        __syncwarp();
        for (int j = 0; j < n_keys; ++j) {
          const float ds = dsrow[j];
          const float* kr = ks + j * ld;
#pragma unroll
          for (int t = 0; t < kD; ++t)
            if (lane + t * kWarp < DH)
              acc[r][t] = fmaf(ds, kr[lane + t * kWarp], acc[r][t]);
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + warp + r * kWarps;
    if (i < p.lq) {
      T* dq = static_cast<T*>(p.out) + b * p.sout.b + h * p.sout.h +
              i * p.sout.l;
#pragma unroll
      for (int t = 0; t < kD; ++t)
        if (lane + t * kWarp < DH) store(dq + lane + t * kWarp, acc[r][t]);
    }
  }
}

// --------------------------------------- backward, pass 2: dk and dv
// Shared memory (floats): the block's K and V rows [kRows][DH], the Q and G
// tiles [kTile][DH+1], the tile's lse and delta [kTile], per warp a
// round(pd) row and a ds row [kTile].
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps* kWarp)
    chunk_bwd_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int ld = DH + 1, kD = lanes_per(DH);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* kr_s = smem;
  float* vr_s = kr_s + kRows * DH;
  float* qs = vr_s + kRows * DH;
  float* gs = qs + tile_floats(DH);
  float* lse_s = gs + tile_floats(DH);
  float* delta_s = lse_s + kTile;
  float* pdrow = delta_s + kTile + warp * 2 * kTile;
  float* dsrow = pdrow + kTile;

  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kRows;
  const int n_rows = min(kRows, p.lk - row0);
  stage<T, DH>(static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h +
                   row0 * p.sk.l,
               p.sk.l, n_rows, kr_s, DH, p.vec);
  stage<T, DH>(static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h +
                   row0 * p.sv.l,
               p.sv.l, n_rows, vr_s, DH, p.vec);
  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* gg = static_cast<const T*>(p.g) + b * p.sg.b + h * p.sg.h;
  const long long rows = ((long long)b * p.heads + h) * p.lq;

  float acc_k[kRowsPerWarp][kD], acc_v[kRowsPerWarp][kD];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < kD; ++t) acc_k[r][t] = acc_v[r][t] = 0.f;

  const int n_tiles = (p.lq + kTile - 1) / kTile;
  for (int qi = 0; qi < n_tiles; ++qi) {
    const int i0 = qi * kTile, n_q = min(kTile, p.lq - i0);
    __syncthreads();
    stage<T, DH>(qg + i0 * p.sq.l, p.sq.l, n_q, qs, ld, p.vec);
    stage<T, DH>(gg + i0 * p.sg.l, p.sg.l, n_q, gs, ld, p.vec);
    for (int i = threadIdx.x; i < n_q; i += blockDim.x) {
      lse_s[i] = p.lse[rows + i0 + i];
      delta_s[i] = p.delta[rows + i0 + i];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int j = row0 + warp + r * kWarps;
      if (j < p.lk) {
        const float* krow = kr_s + (j - row0) * DH;
        const float* vrow = vr_s + (j - row0) * DH;
        const bool padded = p.mask && p.mask[(long long)b * p.lk + j];
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          const int i = lane + t * kWarp;
          float pd = 0.f, ds = 0.f;
          if (i < n_q && !padded) {
            const float s = dot<DH>(krow, qs + i * ld) * p.scale;
            const float l = lse_s[i];
            const float pij = finite(l) ? expf(s - l) : 0.f;
            float dp = dot<DH>(vrow, gs + i * ld);
            pd = pij;
            if (p.drop.on) {
              const float keep = tile_keep(p.drop, b, h, p.hg, i0 + i, j);
              pd *= keep;
              dp *= keep;
            }
            pd = round_to(pd, T());
            ds = round_to(pij * (dp - delta_s[i]) * p.scale, T());
          }
          pdrow[i] = pd;
          dsrow[i] = ds;
        }
        __syncwarp();
        for (int i = 0; i < n_q; ++i) {
          const float pd = pdrow[i], ds = dsrow[i];
          const float* gr = gs + i * ld;
          const float* qr = qs + i * ld;
#pragma unroll
          for (int t = 0; t < kD; ++t)
            if (lane + t * kWarp < DH) {
              acc_v[r][t] = fmaf(pd, gr[lane + t * kWarp], acc_v[r][t]);
              acc_k[r][t] = fmaf(ds, qr[lane + t * kWarp], acc_k[r][t]);
            }
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int j = row0 + warp + r * kWarps;
    if (j < p.lk) {
      T* dv = static_cast<T*>(p.dv) + b * p.sdv.b + h * p.sdv.h + j * p.sdv.l;
      T* dk = static_cast<T*>(p.dk) + b * p.sdk.b + h * p.sdk.h + j * p.sdk.l;
#pragma unroll
      for (int t = 0; t < kD; ++t)
        if (lane + t * kWarp < DH) {
          store(dv + lane + t * kWarp, acc_v[r][t]);
          store(dk + lane + t * kWarp, acc_k[r][t]);
        }
    }
  }
}

// ---------------------------------------------- bf16 tensor-core kernels
// The same three launches for bf16 at Dh = 64 (every tower of the path),
// with the products on tensor cores: mma.sync m16n8k16, bf16 operands, f32
// accumulators.  A product of two bf16 values is exact in f32, so only the
// order of the f32 sums differs from the scalar kernels; the roundings to
// bf16 (p, pd, ds, the outputs) sit at the same points.  A block is 4
// warps; each warp owns 16 rows and keeps them in registers as mma
// fragments (its q, g, k or v rows as A operands, its f32 sums as C
// fragments).  The streamed 128-row tiles are staged in shared memory as
// bf16, row-major (rows padded by 8 values) where a product contracts over
// Dh and transposed where it contracts over the tile's rows, so that every
// B fragment is one 32-bit load without bank conflicts.  The backward
// passes take a tile in two halves of 64 columns to bound the registers
// (the mask hashes absolute indices, so the halves change nothing).
//
// Fragment layout (PTX ISA, mma.m16n8k16 .bf16), g = lane / 4, t = lane % 4:
// A (16x16) regs {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)};
// B (16x8) regs {(k 2t..2t+1, n g), (k 2t+8.., n g)}; C (16x8) floats
// {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.

constexpr int kTcWarps = 4;
constexpr int kTcRows = kTcWarps * 16;  // rows a block owns
constexpr int kTcDim = 64;              // the head dim of the tensor-core path
constexpr int kRowPitch = kTcDim + 8;   // bf16 per staged row-major row
constexpr int kColPitch = kTile + 8;    // bf16 per staged transposed row

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragments of 16 rows x 64 features of a head matrix in device
// memory (rows from `row0`, row stride `stride`); rows at or past `n` are 0.
__device__ __forceinline__ void load_a(const bf16* src, long long stride,
                                       int row0, int n,
                                       uint32_t (&a)[kTcDim / 16][4]) {
  const int g = (threadIdx.x % kWarp) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < kTcDim / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + 8 * (r & 1);
      const int col = 16 * ks + 2 * t + 8 * (r >> 1);
      a[ks][r] = row < n ? ld32(src + row * stride + col) : 0u;
    }
}

// All of the block's threads stage rows [r0, r0 + kTile) of a [n, 64] head
// matrix (row stride `stride`): row-major into `rm` (pitch kRowPitch) and
// transposed into `cm` (pitch kColPitch), each when not null.  Rows at or
// past n are zeros.
__device__ __forceinline__ void stage_tc(const bf16* src, long long stride,
                                         int r0, int n, bf16* rm, bf16* cm) {
  constexpr int per_row = kTcDim / 8;
  for (int e = threadIdx.x; e < kTile * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e % per_row) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      raw = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    if (rm) *reinterpret_cast<uint4*>(rm + r * kRowPitch + c) = raw;
    if (cm) {
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) cm[(c + u) * kColPitch + r] = v[u];
    }
  }
}

// acc[n-tile] += A (16 x 16*KS from `a`) . B where B's column n of n-tile
// nt, rows 16ks..16ks+15, lie at b[(8 nt + n) * pitch + 16 ks ...].
template <int NT, int KS>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4],
                                         const uint32_t (&a)[KS][4],
                                         const bf16* b, int pitch) {
  const int g = (threadIdx.x % kWarp) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const bf16* row = b + (8 * nt + g) * pitch + 16 * ks + 2 * t;
      mma(acc[nt], a[ks], ld32(row), ld32(row + 8));
    }
}

// The A fragments of a 16 x 16*KS matrix held as C fragments of 8-column
// n-tiles (two per 16-column k-step), rounded to bf16.
template <int KS>
__device__ __forceinline__ void c_to_a(const float (&c)[2 * KS][4],
                                       uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    a[ks][0] = pack(c[2 * ks][0], c[2 * ks][1]);
    a[ks][1] = pack(c[2 * ks][2], c[2 * ks][3]);
    a[ks][2] = pack(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    a[ks][3] = pack(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Each thread owns rows g and g + 8 of its warp's 16: element e of an
// n-tile's C fragment lies in row g + 8 (e >> 1), column 8 nt + 2t + (e & 1).
// Shared memory (bf16): the K tile row-major, the V tile transposed, then
// the tile's padding bytes.
__global__ void __launch_bounds__(kTcWarps* kWarp)
    chunk_fwd_tc_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  constexpr int KS = kTcDim / 16, NF = kTcDim / 8, NT = kTile / 8;
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* vt = ks + kTile * kRowPitch;
  unsigned char* pad =
      reinterpret_cast<unsigned char*>(vt + kTcDim * kColPitch);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kTcRows + warp * 16;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;

  uint32_t qa[KS][4];
  load_a(static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.l,
         row0, p.lq, qa);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NF][4];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nf][e] = 0.f;

  const int n_tiles = (p.lk + kTile - 1) / kTile;
  for (int kj = 0; kj < n_tiles; ++kj) {
    const int j0 = kj * kTile;
    __syncthreads();  // every warp is done with the previous tile
    stage_tc(kg, p.sk.l, j0, p.lk, ks, nullptr);
    stage_tc(vg, p.sv.l, j0, p.lk, nullptr, vt);
    for (int j = threadIdx.x; j < kTile; j += blockDim.x)
      pad[j] = j0 + j >= p.lk ||
               (p.mask && p.mask[(long long)b * p.lk + j0 + j]);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    mma_rows<NT, KS>(s, qa, ks, kRowPitch);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = pad[8 * nt + 2 * t + (e & 1)]
                            ? -INFINITY : s[nt][e] * p.scale;
        s[nt][e] = v;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], v);
      }
    float safe_m[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(tmax[r]));
      safe_m[r] = finite(m_new) ? m_new : 0.f;
      alpha[r] = finite(m[r]) ? expf(m[r] - safe_m[r]) : 0.f;
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pj = finite(s[nt][e]) ? expf(s[nt][e] - safe_m[r]) : 0.f;
        psum[r] += pj;
        if (p.drop.on)
          pj *= tile_keep(p.drop, b, h, p.hg, row0 + g + 8 * r,
                          j0 + 8 * nt + 2 * t + (e & 1));
        s[nt][e] = pj;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(psum[r]);
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nf][e] *= alpha[e >> 1];
    uint32_t pa[NT / 2][4];  // round(p) as A fragments over the tile's keys
    c_to_a<NT / 2>(s, pa);
    mma_rows<NF, NT / 2>(o, pa, vt, kColPitch);
  }

  bf16* og = static_cast<bf16*>(p.out) + b * p.sout.b + h * p.sout.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    if (i < p.lq) {
      const float safe = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
        *reinterpret_cast<uint32_t*>(og + i * p.sout.l + 8 * nf + 2 * t) =
            pack(o[nf][2 * r] / safe, o[nf][2 * r + 1] / safe);
      if (t == 0)
        p.lse[((long long)b * p.heads + h) * p.lq + i] =
            l[r] > 0.f ? m[r] + logf(safe) : -INFINITY;
    }
  }
}

// Backward pass 1 (delta and dq).  Shared memory (bf16): the K and V tiles
// row-major, the K tile transposed, then the tile's padding bytes.
__global__ void __launch_bounds__(kTcWarps* kWarp)
    chunk_bwd_dq_tc_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  constexpr int KS = kTcDim / 16, NF = kTcDim / 8, NH = 8;  // NH: n-tiles
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);              // of a half tile
  bf16* vs = ks + kTile * kRowPitch;
  bf16* kt = vs + kTile * kRowPitch;
  unsigned char* pad =
      reinterpret_cast<unsigned char*>(kt + kTcDim * kColPitch);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kTcRows + warp * 16;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;
  const bf16* gg = static_cast<const bf16*>(p.g) + b * p.sg.b + h * p.sg.h;
  const bf16* og = static_cast<const bf16*>(p.o) + b * p.so.b + h * p.so.h;
  const long long rows = ((long long)b * p.heads + h) * p.lq;

  uint32_t qa[KS][4], ga[KS][4];
  load_a(static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.l,
         row0, p.lq, qa);
  load_a(gg, p.sg.l, row0, p.lq, ga);
  // delta = rowsum(g * out) from the rounded output: each lane of a quad
  // sums 16 features of rows g and g + 8
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    float partial = 0.f;
    lse[r] = 0.f;
    if (i < p.lq) {
      for (int d = 16 * t; d < 16 * t + 16; ++d)
        partial = fmaf(to_f32(gg[i * p.sg.l + d]), to_f32(og[i * p.so.l + d]),
                       partial);
      lse[r] = p.lse[rows + i];
    }
    delta[r] = quad_sum(partial);
    if (i < p.lq && t == 0) p.delta[rows + i] = delta[r];
  }
  float dq[NF][4];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nf][e] = 0.f;

  const int n_tiles = (p.lk + kTile - 1) / kTile;
  for (int kj = 0; kj < n_tiles; ++kj) {
    const int j0 = kj * kTile;
    __syncthreads();
    stage_tc(kg, p.sk.l, j0, p.lk, ks, kt);
    stage_tc(vg, p.sv.l, j0, p.lk, vs, nullptr);
    for (int j = threadIdx.x; j < kTile; j += blockDim.x)
      pad[j] = j0 + j >= p.lk ||
               (p.mask && p.mask[(long long)b * p.lk + j0 + j]);
    __syncthreads();
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * kTile / 2;  // the half's first key in the tile
      float s[NH][4], dp[NH][4];
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      mma_rows<NH, KS>(s, qa, ks + c0 * kRowPitch, kRowPitch);
      mma_rows<NH, KS>(dp, ga, vs + c0 * kRowPitch, kRowPitch);
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, jl = c0 + 8 * nt + 2 * t + (e & 1);
          float ds = 0.f;
          if (!pad[jl]) {
            const float sv = s[nt][e] * p.scale;
            const float pij = finite(lse[r]) ? expf(sv - lse[r]) : 0.f;
            float dpv = dp[nt][e];
            if (p.drop.on)
              dpv *= tile_keep(p.drop, b, h, p.hg, row0 + g + 8 * r, j0 + jl);
            ds = pij * (dpv - delta[r]) * p.scale;
          }
          s[nt][e] = ds;
        }
      uint32_t dsa[NH / 2][4];  // round(ds) as A fragments over the keys
      c_to_a<NH / 2>(s, dsa);
      mma_rows<NF, NH / 2>(dq, dsa, kt + c0, kColPitch);
    }
  }

  bf16* dqg = static_cast<bf16*>(p.out) + b * p.sout.b + h * p.sout.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    if (i < p.lq)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
        *reinterpret_cast<uint32_t*>(dqg + i * p.sout.l + 8 * nf + 2 * t) =
            pack(dq[nf][2 * r], dq[nf][2 * r + 1]);
  }
}

// Backward pass 2 (dk and dv), rows = keys.  Shared memory: the Q and G
// tiles row-major and transposed (bf16), then the tile's lse and delta
// (f32).
__global__ void __launch_bounds__(kTcWarps* kWarp)
    chunk_bwd_dkv_tc_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  constexpr int KS = kTcDim / 16, NF = kTcDim / 8, NH = 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* gs = qs + kTile * kRowPitch;
  bf16* qt = gs + kTile * kRowPitch;
  bf16* gt = qt + kTcDim * kColPitch;
  float* lse_s = reinterpret_cast<float*>(gt + kTcDim * kColPitch);
  float* delta_s = lse_s + kTile;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int row0 = blockIdx.y * kTcRows + warp * 16;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* gg = static_cast<const bf16*>(p.g) + b * p.sg.b + h * p.sg.h;
  const long long rows = ((long long)b * p.heads + h) * p.lq;

  uint32_t ka[KS][4], va[KS][4];
  load_a(static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h, p.sk.l,
         row0, p.lk, ka);
  load_a(static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h, p.sv.l,
         row0, p.lk, va);
  bool padded[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = row0 + g + 8 * r;
    padded[r] = j >= p.lk || (p.mask && p.mask[(long long)b * p.lk + j]);
  }
  float dk[NF][4], dv[NF][4];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nf][e] = dv[nf][e] = 0.f;

  const int n_tiles = (p.lq + kTile - 1) / kTile;
  for (int qi = 0; qi < n_tiles; ++qi) {
    const int i0 = qi * kTile;
    __syncthreads();
    stage_tc(qg, p.sq.l, i0, p.lq, qs, qt);
    stage_tc(gg, p.sg.l, i0, p.lq, gs, gt);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const bool real = i0 + i < p.lq;
      lse_s[i] = real ? p.lse[rows + i0 + i] : -INFINITY;
      delta_s[i] = real ? p.delta[rows + i0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * kTile / 2;  // the half's first query in the tile
      float s[NH][4], dp[NH][4];
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      mma_rows<NH, KS>(s, ka, qs + c0 * kRowPitch, kRowPitch);
      mma_rows<NH, KS>(dp, va, gs + c0 * kRowPitch, kRowPitch);
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, il = c0 + 8 * nt + 2 * t + (e & 1);
          float pd = 0.f, ds = 0.f;
          if (i0 + il < p.lq && !padded[r]) {
            const float sv = s[nt][e] * p.scale;
            const float l = lse_s[il];
            const float pij = finite(l) ? expf(sv - l) : 0.f;
            float dpv = dp[nt][e];
            pd = pij;
            if (p.drop.on) {
              const float keep = tile_keep(p.drop, b, h, p.hg, i0 + il,
                                           row0 + g + 8 * r);
              pd *= keep;
              dpv *= keep;
            }
            ds = pij * (dpv - delta_s[il]) * p.scale;
          }
          dp[nt][e] = pd;
          s[nt][e] = ds;
        }
      uint32_t pda[NH / 2][4], dsa[NH / 2][4];  // round(pd), round(ds)
      c_to_a<NH / 2>(dp, pda);
      c_to_a<NH / 2>(s, dsa);
      mma_rows<NF, NH / 2>(dv, pda, gt + c0, kColPitch);
      mma_rows<NF, NH / 2>(dk, dsa, qt + c0, kColPitch);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = row0 + g + 8 * r;
    if (j < p.lk) {
      bf16* dvg = static_cast<bf16*>(p.dv) + b * p.sdv.b + h * p.sdv.h +
                  j * p.sdv.l;
      bf16* dkg = static_cast<bf16*>(p.dk) + b * p.sdk.b + h * p.sdk.h +
                  j * p.sdk.l;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        *reinterpret_cast<uint32_t*>(dvg + 8 * nf + 2 * t) =
            pack(dv[nf][2 * r], dv[nf][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dkg + 8 * nf + 2 * t) =
            pack(dk[nf][2 * r], dk[nf][2 * r + 1]);
      }
    }
  }
}

// Shared-memory bytes of the tensor-core launches (0, 1, 2 as below).
size_t tc_smem_bytes(int which) {
  const size_t rm = (size_t)kTile * kRowPitch * sizeof(bf16);
  const size_t cm = (size_t)kTcDim * kColPitch * sizeof(bf16);
  if (which == 0) return rm + cm + kTile;
  if (which == 1) return 2 * rm + cm + kTile;
  return 2 * rm + 2 * cm + 2 * kTile * sizeof(float);
}

// Shared-memory bytes of each launch (0: forward, 1: backward dq pass, 2:
// backward dk/dv pass) for head dim dh.
size_t smem_bytes(int which, int dh) {
  const size_t f = sizeof(float);
  const size_t rows = (size_t)kRows * dh, tile = (size_t)tile_floats(dh);
  const size_t per_warp = (size_t)kWarps * kTile;
  if (which == 0) return f * (rows + 2 * tile + per_warp) + kTile;
  if (which == 1) return f * (2 * rows + 2 * tile + per_warp) + kTile;
  return f * (2 * rows + 2 * tile + 2 * kTile + 2 * per_warp);
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

// bf16 at Dh = 64 with 16-byte aligned rows takes the tensor-core kernels.
template <typename T, int DH>
bool tensor_cores(const Params& p) {
  return std::is_same<T, bf16>::value && DH == kTcDim && p.vec;
}

dim3 grid_of(const Params& p, int batch, int n, int rows) {
  return dim3(batch * p.heads, (n + rows - 1) / rows);
}

template <typename T, int DH>
int forward(const Params& p, int batch, cudaStream_t s) {
  if (tensor_cores<T, DH>(p))
    return launch(chunk_fwd_tc_kernel, grid_of(p, batch, p.lq, kTcRows),
                  kTcWarps, tc_smem_bytes(0), s, p);
  return launch(chunk_fwd_kernel<T, DH>, grid_of(p, batch, p.lq, kRows),
                kWarps, smem_bytes(0, DH), s, p);
}

template <typename T, int DH>
int backward(const Params& p, int batch, cudaStream_t s) {
  int rc;
  if (tensor_cores<T, DH>(p)) {
    rc = launch(chunk_bwd_dq_tc_kernel, grid_of(p, batch, p.lq, kTcRows),
                kTcWarps, tc_smem_bytes(1), s, p);
    if (rc != 0) return rc;
    return launch(chunk_bwd_dkv_tc_kernel, grid_of(p, batch, p.lk, kTcRows),
                  kTcWarps, tc_smem_bytes(2), s, p);
  }
  rc = launch(chunk_bwd_dq_kernel<T, DH>, grid_of(p, batch, p.lq, kRows),
              kWarps, smem_bytes(1, DH), s, p);
  if (rc != 0) return rc;
  return launch(chunk_bwd_dkv_kernel<T, DH>, grid_of(p, batch, p.lk, kRows),
                kWarps, smem_bytes(2, DH), s, p);
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
                   int lk, int hg, float scale, unsigned int seed,
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
  p.hg = hg;
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
int fca_chunk_supported_dim(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128;
}

// Bytes of dynamic shared memory of each launch (0: forward, 1: backward dq
// pass, 2: backward dk/dv pass); they depend on the head dim only.
size_t fca_chunk_smem_bytes(int which, int dh) { return smem_bytes(which, dh); }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out share it).  strides: 12
// element strides, (b, h, l) of q, k, v, out.  lse: [B, H, Lq] f32 out.  hg:
// heads per dropout head group.  seed/threshold/keep_scale/dropout: the
// dropout mask (see the head of this file).  vec: 1 when every q/k/v row
// starts 16-byte aligned and Dh spans whole 16-byte words (bf16 at Dh = 64
// with vec takes the tensor-core kernels).  Returns cudaGetLastError() after
// the launch (0 = success), -1 for an unsupported head dim.
int fca_chunk_forward(const void* q, const void* k, const void* v,
                      const unsigned char* mask, void* out, float* lse,
                      int dtype, int batch, int heads, int lq, int lk, int dh,
                      int hg, const long long* strides, float scale,
                      unsigned int seed, unsigned int threshold,
                      float keep_scale, int dropout, int vec,
                      void* stream) {
  Params p = make_params(q, k, v, mask, lse, heads, lq, lk, hg, scale, seed,
                         threshold, keep_scale, dropout, vec);
  p.out = out;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.sout = strides_at(strides, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
// writes and the second reads.  vec covers q, k, v and g.  Other arguments
// as fca_chunk_forward.
int fca_chunk_backward(const void* q, const void* k, const void* v,
                       const unsigned char* mask, const void* o,
                       const float* lse, const void* g, void* dq, void* dk,
                       void* dv, float* delta, int dtype, int batch,
                       int heads, int lq, int lk, int dh, int hg,
                       const long long* strides, float scale,
                       unsigned int seed, unsigned int threshold,
                       float keep_scale, int dropout, int vec,
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
  if (dtype == 1)
    return by_dim(dh, [&](auto d) {
      return backward<__nv_bfloat16, decltype(d)::value>(p, batch, s);
    });
  return by_dim(dh, [&](auto d) {
    return backward<float, decltype(d)::value>(p, batch, s);
  });
}

}  // extern "C"
