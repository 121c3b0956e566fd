// Shared pieces of the streamed flash-attention kernels for Hopper (sm_90a):
// the chunked kernels 4/5 (flash_chunked_attention.cu) and the tiled kernels
// 6-8 (flash_tiled_attention.cu).  Both families stream 128-row tiles of the
// other side through shared memory with running state in registers; they
// differ only in the dropout mask's head group (Params.hg).  This header
// holds their launch parameters, the interpret-mode tile hash (per element,
// and per (b, h) for the wgmma kernels), the element helpers and the kernel
// bodies that each file wraps in its own __global__ functions: scalar (f32
// FMA, any dtype and head dim) for kernels 4-8.  The bf16 forward of
// kernels 4 and 6 runs flash_fwd_wgmma.cuh, the bf16 backward of kernels 5,
// 7 and 8 flash_bwd_wgmma.cuh (wgmma and TMA, for TMA-eligible views).
//
// The scalar bodies, per (batch b, head h) and a block of kRows rows (8
// warps of 8 rows, each warp carrying its rows' state across tiles in
// registers): tiles are staged as f32, rows padded by one float so that
// lanes walking different rows at the same feature hit different banks;
// lanes split a tile's 128 rows for the dot products, warp shuffles give the
// max and sums, lanes split the features for the weighted sums.  The
// semantics (rounding points, -inf padding, the mask) are stated at the head
// of each .cu file.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

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
  int h0;                  // the first head's index among the layer's heads
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

// The dropout factor of element (b, h, i, j) in {0, scale}: the tile hash,
// over the head's index among the layer's heads, h0 + h (hg need not
// divide the heads of the call).
__device__ __forceinline__ float tile_keep(const Dropout& d, int b, int h,
                                           int hg, int i, int j) {
  const unsigned int seed_b = d.seed + (unsigned int)b * 0x9E3779B9u;
  const unsigned int ha = (unsigned int)(d.h0 + h);
  const unsigned int hi = ha / hg, hh = ha % hg;
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

// tile_keep for one (b, h), with the terms that do not depend on (i, j)
// summed once (uint32 sums wrap, so the order is free): the wgmma kernels
// test it once per accumulator element, with absolute indices.
struct TileHash {
  unsigned int base, threshold;
  float scale;
  __device__ TileHash(const Dropout& d, int b, int h, int hg)
      : threshold(d.threshold), scale(d.scale) {
    const unsigned int seed_b = d.seed + (unsigned int)b * 0x9E3779B9u;
    const unsigned int ha = (unsigned int)(d.h0 + h);
    base = (ha % hg) * (kTile * kTile) + seed_b * 0x9E3779B9u +
           (ha / hg) * 0x27D4EB2Fu;
  }
  __device__ float keep(int i, int j) const {  // i, j >= 0
    unsigned int x = base + (unsigned int)(i % kTile) * kTile +
                     (unsigned int)(j % kTile) +
                     (unsigned int)(i / kTile) * 0x85EBCA77u +
                     (unsigned int)(j / kTile) * 0xC2B2AE3Du;
    x = (x ^ (x >> 16)) * 0x85EBCA6Bu;  // murmur3 finalizer
    x = (x ^ (x >> 13)) * 0xC2B2AE35u;
    x ^= x >> 16;
    return x >= threshold ? scale : 0.f;
  }
};

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
// Scalar bodies.  Each is launched on a grid (B * H, ceil(L / kRows)) of
// kWarps warps; the file that wraps it says which rows are the block's.
// Shared memory (floats): the block's Q rows [kRows][DH], the K and V tiles
// [kTile][DH+1], per warp a p row [kTile], then the tile's padding as bytes.
template <typename T, int DH>
__device__ __forceinline__ void streamed_fwd(const Params& p) {
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
__device__ __forceinline__ void streamed_dq(const Params& p) {
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
__device__ __forceinline__ void streamed_dkv(const Params& p) {
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

// Shared-memory bytes of each scalar launch (0: forward, 1: backward dq
// pass, 2: backward dk/dv pass) for head dim dh.
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
  p.hg = hg;
  p.scale = scale;
  p.drop = {seed, threshold, keep_scale, dropout, h0};
  p.vec = vec;
  return p;
}

Strides strides_at(const long long* s, int t) {
  return {s[3 * t], s[3 * t + 1], s[3 * t + 2]};
}

}  // namespace
