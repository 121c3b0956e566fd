// Fused InfoNCE statistics and backward for Hopper (sm_90a).
//
// Replaces, in leccr_tpu/ops/infonce.py:
//   kernel  9  `_stats_kernel`  (:86, wrapper `_stats_pallas` :129)
//   kernel 10  `_bwd_dq_kernel` (:202, wrapper `_bwd_raw_pallas` :259)
//   kernel 11  `_bwd_dk_kernel` (:229, same wrapper)
//
// What they compute, for q [M, E], k [N, E] (f32, row-major), int32 ids
// idx_q [M], idx_k [N] and a scalar inv_temp read from device memory:
//   l_ij     = (q_i . k_j) * inv_temp
//   pos_ij   = idx_q[i] == idx_k[j]
//   kernel 9:  lse_i = log sum_j exp(l_ij), pos_sum_i = sum_j pos_ij l_ij,
//              pos_cnt_i = sum_j pos_ij                      (three f32 [M])
//   w_ij     = exp(l_ij - lse_i) - pos_ij / max(pos_cnt_i, 1)
//   kernel 10: dq_raw_i = sum_j w_ij k_j                     (f32 [M, E])
//   kernel 11: dk_raw_j = sum_i w_ij q_i                     (f32 [N, E])
// The [M, N] logits never reach device memory: each kernel recomputes the
// tile it needs, as the TPU kernels do.  A row with no positive has
// pos_cnt 0 and gets no label term (max(pc, 1)).
//
// What bounds them: operations.  Kernel 9 does 2*M*N*E flops, kernels 10
// and 11 4*M*N*E each (the logits again, then the weighted sum), on at most
// (M + N) * E * 4 bytes in and M * E * 4 (or N * E * 4) out: at
// M = N = 4096, E = 256, 8.6 GFLOP against 8.4 MB, about 1 000 flops per
// byte.  All arithmetic is full f32 (a TF32 product keeps ~3 digits, and a
// logit error of 1e-3 * inv_temp = 14.3 would break the tolerance), so the
// bound is the card's 67 TFLOP/s f32 rate: 0.128 ms for kernel 9 and
// 0.256 ms for kernels 10 and 11 at that shape.
//
// What the design does about it: each block owns a tile of 32 rows (q rows
// for kernels 9 and 10, k rows for kernel 11), keeps them in shared memory
// for its whole life, and streams the other side through shared memory in
// tiles of 64 rows; the loop over those tiles inside the block takes the
// place of the TPU's sequential grid axis, so no state crosses blocks: no
// atomics, no second pass, a deterministic result.  256 threads compute the
// 32 x 64 logit tile as 2 x 4 register tiles with FMAs.  Kernel 9 carries
// per-thread running (max, sum, positive sum, count) over its columns in
// registers and merges the 16 threads of a row with warp shuffles at the
// end (logaddexp).  Kernels 10 and 11 write the weight tile to shared
// memory and accumulate weights x streamed rows into 32 registers a thread
// (E <= 256).  Rows past M or N are masked in the kernels (the TPU's
// lse = +inf padding of the dq pass has no counterpart here).  32-row tiles
// give 128 blocks at M = 4096, about one per SM; with few own rows (a ring
// block of 256 q rows against 32 768 keys) kernel 9 fills only 8 SMs, and a
// split over columns with a logaddexp merge is later work, as are
// wgmma/TMA and 3xTF32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOwn = 32;     // rows a block owns
constexpr int kStream = 64;  // rows of one streamed tile
constexpr int kMaxE = 256;   // features: 4 column groups of 64 in the sums

// Rows [row0, row0 + rows) of a row-major [*, e] f32 matrix into shared
// memory with a row stride of e + 1 floats (so that 16 threads reading 16
// different rows at one feature hit 16 banks); rows at or past n_valid are
// zero.  e is a multiple of 4 and rows start 16-byte aligned (the wrapper
// checks), so each thread loads 16 bytes at a time.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int n_valid,
                                          int e) {
  const int vec = e / 4;
  const int ld = e + 1;
  for (int t = threadIdx.x; t < rows * vec; t += kThreads) {
    const int r = t / vec, c = (t % vec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_valid)
      v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * e + c);
    float* d = dst + r * ld + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// acc[r][c] = own[2 * ty + r] . stream[tx + 16 * c] over e features, both
// tiles in shared memory with row stride e + 1.
__device__ __forceinline__ void dot_tile(const float* own, const float* stream,
                                         int e, int ty, int tx,
                                         float acc[2][4]) {
  const int ld = e + 1;
  const float* a0 = own + (2 * ty) * ld;
  const float* a1 = a0 + ld;
  const float* b = stream + tx * ld;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < e; ++kk) {
    const float a[2] = {a0[kk], a1[kk]};
    float bv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[16 * c * ld + kk];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
  }
}

// Kernel 9: one block per 32 q rows, streaming every k tile.
__global__ void __launch_bounds__(kThreads)
    infonce_stats_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const int* __restrict__ idx_q,
                         const int* __restrict__ idx_k,
                         const float* __restrict__ inv_temp, int m, int n,
                         int e, float* __restrict__ lse,
                         float* __restrict__ pos_sum,
                         float* __restrict__ pos_cnt) {
  extern __shared__ float smem[];
  float* own = smem;
  float* stream = own + kOwn * (e + 1);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kOwn;
  const float invt = *inv_temp;
  load_rows(own, q, row0, kOwn, m, e);
  int my_idx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 2 * ty + r;
    my_idx[r] = i < m ? idx_q[i] : 0;  // rows past m are never written
  }
  float mx[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
  float ps[2] = {0.f, 0.f}, pc[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < n; j0 += kStream) {
    __syncthreads();  // the previous tile is read (and `own` is stored)
    load_rows(stream, k, j0, kStream, n, e);
    __syncthreads();
    float acc[2][4];
    dot_tile(own, stream, e, ty, tx, acc);
    bool valid[4];
    int col_idx[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      valid[c] = j < n;
      col_idx[c] = valid[c] ? idx_k[j] : 0;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] *= invt;
        if (valid[c]) tile_max = fmaxf(tile_max, acc[r][c]);
      }
      // a tile with no valid column leaves the state alone; exp(-inf) = 0
      // rescales the empty sum of a row that had none so far
      if (tile_max > mx[r]) {
        s[r] *= expf(mx[r] - tile_max);
        mx[r] = tile_max;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!valid[c]) continue;
        s[r] += expf(acc[r][c] - mx[r]);
        if (col_idx[c] == my_idx[r]) {
          ps[r] += acc[r][c];
          pc[r] += 1.f;
        }
      }
    }
  }
  // merge the 16 threads of each row (lanes 0-15 and 16-31 of a warp hold
  // different rows; xor offsets below 16 stay inside each half)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[r], off);
      const float os = __shfl_xor_sync(0xffffffffu, s[r], off);
      const float ops = __shfl_xor_sync(0xffffffffu, ps[r], off);
      const float opc = __shfl_xor_sync(0xffffffffu, pc[r], off);
      const float nm = fmaxf(mx[r], om);
      s[r] = nm == -INFINITY
                 ? 0.f
                 : s[r] * expf(mx[r] - nm) + os * expf(om - nm);
      mx[r] = nm;
      ps[r] += ops;
      pc[r] += opc;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 2 * ty + r;
      if (i < m) {
        lse[i] = mx[r] + logf(s[r]);
        pos_sum[i] = ps[r];
        pos_cnt[i] = pc[r];
      }
    }
  }
}

// Kernels 10 (kDk false) and 11 (kDk true).  The block owns 32 rows of
// `own` (q for dq, k for dk) and streams `other` (k for dq, q for dk);
// lse and pos_cnt belong to q's rows: the own rows for dq, the streamed
// rows for dk.  out[own row] = sum over streamed rows of w * other row.
template <bool kDk>
__global__ void __launch_bounds__(kThreads)
    infonce_bwd_kernel(const float* __restrict__ own_g,
                       const float* __restrict__ other_g,
                       const int* __restrict__ idx_own,
                       const int* __restrict__ idx_other,
                       const float* __restrict__ inv_temp,
                       const float* __restrict__ lse,
                       const float* __restrict__ pos_cnt, int n_own,
                       int n_other, int e, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* own = smem;
  float* stream = own + kOwn * (e + 1);
  float* wt = stream + kStream * (e + 1);  // [kOwn][kStream] weights
  const int ld = e + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kOwn;
  const float invt = *inv_temp;
  load_rows(own, own_g, row0, kOwn, n_own, e);
  bool own_valid[2];
  int own_idx[2];
  float own_lse[2] = {0.f, 0.f}, own_ipc[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 2 * ty + r;
    own_valid[r] = i < n_own;
    own_idx[r] = own_valid[r] ? idx_own[i] : 0;
    if (!kDk && own_valid[r]) {
      own_lse[r] = lse[i];
      own_ipc[r] = 1.f / fmaxf(pos_cnt[i], 1.f);
    }
  }
  // the weighted sum: this thread's 8 own rows x 4 features
  const int ecol = threadIdx.x % 64, rgrp = threadIdx.x / 64;
  float acc[8][4];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[rr][cc] = 0.f;

  for (int j0 = 0; j0 < n_other; j0 += kStream) {
    __syncthreads();  // the previous tile and weights are read
    load_rows(stream, other_g, j0, kStream, n_other, e);
    __syncthreads();
    float sc[2][4];
    dot_tile(own, stream, e, ty, tx, sc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      const bool valid = j < n_other;
      const int jdx = valid ? idx_other[j] : 0;
      float j_lse = 0.f, j_ipc = 0.f;
      if (kDk && valid) {
        j_lse = lse[j];
        j_ipc = 1.f / fmaxf(pos_cnt[j], 1.f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float w = 0.f;
        if (valid && own_valid[r]) {
          const float l = sc[r][c] * invt;
          w = expf(l - (kDk ? j_lse : own_lse[r]));
          if (jdx == own_idx[r]) w -= kDk ? j_ipc : own_ipc[r];
        }
        wt[(2 * ty + r) * kStream + tx + 16 * c] = w;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kStream; ++jj) {
      const float* srow = stream + jj * ld;
      float sv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int f = ecol + 64 * cc;
        sv[cc] = f < e ? srow[f] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const float w = wt[(8 * rgrp + rr) * kStream + jj];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          acc[rr][cc] = fmaf(w, sv[cc], acc[rr][cc]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int i = row0 + 8 * rgrp + rr;
    if (i >= n_own) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int f = ecol + 64 * cc;
      if (f < e) out[(size_t)i * e + f] = acc[rr][cc];
    }
  }
}

size_t stats_smem(int e) {
  return sizeof(float) * (size_t)(kOwn + kStream) * (e + 1);
}

size_t bwd_smem(int e) {
  return stats_smem(e) + sizeof(float) * (size_t)kOwn * kStream;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// The widest E the kernels take (their sums keep 4 groups of 64 features
// per thread); E must also be a multiple of 4.
int infonce_max_dim() { return kMaxE; }

// Bytes of dynamic shared memory a launch needs (which: 0 stats, 1 dq or
// dk); the caller checks it against the card's per-block limit.
size_t infonce_smem_bytes(int which, int e) {
  return which == 0 ? stats_smem(e) : bwd_smem(e);
}

// Kernel 9.  q [m, e], k [n, e] f32 row-major, 16-byte aligned; idx_q [m],
// idx_k [n] int32; inv_temp: one f32 in device memory; lse, pos_sum,
// pos_cnt: f32 [m].  Returns cudaGetLastError() after the launch.
int infonce_stats(const float* q, const float* k, const int* idx_q,
                  const int* idx_k, const float* inv_temp, int m, int n, int e,
                  float* lse, float* pos_sum, float* pos_cnt, void* stream) {
  const size_t smem = stats_smem(e);
  int err = prepare(infonce_stats_kernel, smem);
  if (err) return err;
  infonce_stats_kernel<<<(m + kOwn - 1) / kOwn, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, k, idx_q, idx_k, inv_temp, m, n, e, lse, pos_sum, pos_cnt);
  return (int)cudaGetLastError();
}

// Kernel 10: dq_raw [m, e] from q, k, the ids, inv_temp and q's lse and
// pos_cnt [m] (kernel 9's outputs).
int infonce_bwd_dq(const float* q, const float* k, const int* idx_q,
                   const int* idx_k, const float* inv_temp, const float* lse,
                   const float* pos_cnt, int m, int n, int e, float* dq,
                   void* stream) {
  const size_t smem = bwd_smem(e);
  int err = prepare(infonce_bwd_kernel<false>, smem);
  if (err) return err;
  infonce_bwd_kernel<false><<<(m + kOwn - 1) / kOwn, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      q, k, idx_q, idx_k, inv_temp, lse, pos_cnt, m, n, e, dq);
  return (int)cudaGetLastError();
}

// Kernel 11: dk_raw [n, e], arguments as kernel 10's.
int infonce_bwd_dk(const float* q, const float* k, const int* idx_q,
                   const int* idx_k, const float* inv_temp, const float* lse,
                   const float* pos_cnt, int m, int n, int e, float* dk,
                   void* stream) {
  const size_t smem = bwd_smem(e);
  int err = prepare(infonce_bwd_kernel<true>, smem);
  if (err) return err;
  infonce_bwd_kernel<true><<<(n + kOwn - 1) / kOwn, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      k, q, idx_k, idx_q, inv_temp, lse, pos_cnt, n, m, e, dk);
  return (int)cudaGetLastError();
}

}  // extern "C"
