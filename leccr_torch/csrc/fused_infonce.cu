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
// byte.  All arithmetic is full f32 on the CUDA cores (a TF32 product keeps
// ~3 digits, and a logit error of 1e-3 * inv_temp = 14.3 would break the
// tolerance), so the bound is the card's 67 TFLOP/s f32 rate: 0.128 ms for
// kernel 9 and 0.256 ms for kernels 10 and 11 at that shape.
//
// What the design does about it:
// - Register tiles.  Each thread keeps a tile of products in registers and
//   reads its operands from shared memory as 16-byte vectors, four features
//   of a row at a time: kernel 9 an 8 x 8 logit tile (8 + 8 float4 reads
//   feed 256 FMAs, 4 a float read), kernels 10/11 a 4 x 4 logit tile and
//   then an 8-row x 8-feature tile of the weighted sum (8 weight float4s +
//   8 streamed float4s feed 256 FMAs).  Rows are staged row-major with a
//   pitch of 4 (mod 32) floats, so the 8 rows that a quarter-warp reads at
//   one feature lie in 8 distinct 16-byte bank groups, and the rows that
//   the other operand's lanes share are broadcasts: no read conflicts.
// - A split grid.  The grid is row tiles x S splits of the streamed side
//   (`split_plan` in ops/infonce.py picks S from the shape and the card's
//   SM count: S = 1 once the row tiles alone fill the card, else ~2 blocks
//   an SM or more, the fewest that minimise waves x tiles a block, since
//   each kernel holds one block an SM).  Each block walks its split's tiles in order; with S > 1 it
//   writes a partial (kernel 9: max, sum, positive sum, count; kernels
//   10/11: its rows' [rows, E] sum) to a workspace, and a small second
//   kernel merges the S partials of a row in split order (logaddexp, or a
//   sum).  No atomics: the result is the same bits from call to call.
// - Asynchronous copies.  16-byte `cp.async` (zero-filling rows and
//   features past M, N or E) keep the next operands in flight while the
//   current ones are multiplied.  cp.async rather than TMA: the tiles are
//   f32 rows of a runtime E (any multiple of 4), a TMA box would need a
//   tensor map per shape and call, and kernel 9 stages its rows with a
//   pitch that TMA's boxes cannot give without a swizzle that the 16-byte
//   vector reads would then have to undo.
//
// Kernel 9 (`infonce_stats_kernel`): 256 threads own 128 q rows x a split
// of 128-column k tiles; E is streamed in chunks of 32 features (128 bytes
// a row) of the q tile and the k tile through a ring of 3 stages, so chunk
// c + 2 loads while chunk c is multiplied.  After a tile's last chunk the
// epilogue scales by inv_temp, masks columns >= N, updates each of the
// thread's rows' running max and sum (expf) and compares ids against the
// tile's idx_k (staged beside the last chunk) and the block's idx_q; the
// running statistics wait in shared memory between tiles, so the 64
// accumulators and 16 operand vectors have the registers to themselves
// (168 registers against 254 when they stayed in registers, as fast).  At
// the end the 16 threads of a row merge by shuffles.  Shared memory: the
// ring 112 128 B + q ids 512 B + statistics 32 768 B = 145 408 B.
//
// Kernels 10/11 (`infonce_bwd_dq_kernel`, `infonce_bwd_dk_kernel`: one
// body, `bwd_body<kDk>`, with q and k swapped for dk): 256 threads own 64
// rows of `own` (q for dq, k for dk) for the whole call and stream 64-row
// tiles of `other` (k for dq, q for dk) over their split, two tiles in
// flight.  A tile gives the 64 x 64 logits, then w (expf, minus the label
// term) into shared memory, then acc += w . other_tile into 64 registers a
// thread.  The streamed tile must be whole in shared memory for that second
// product.  Budget at E = 256 (row pitch 260 floats): own 66 560 B +
// streamed 2 x 66 560 B + w 64 x 80 x 4 = 20 480 B + the streamed rows'
// ids, lse and pos_cnt 1 536 B = 221 696 B of the 232 448 a block may use.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kThreads = 256;
constexpr int kMaxE = 256;  // kernels 10/11 keep 8 features of 256 a thread

// kernel 9: a block's tile (a thread's rows ty + 16 r, r < kStatsReps), the
// E chunk and the ring
constexpr int kStatsReps = 8;
constexpr int kStatsRows = 16 * kStatsReps;
constexpr int kStatFloats = kStatsReps * kThreads;  // one statistic, a block
constexpr int kStatsCols = 128;
constexpr int kChunk = 32;
constexpr int kChunkPitch = kChunk + 4;  // floats a staged row: 4 (mod 32)
constexpr int kStages = 3;
// one stage: the q chunk [128][36], the k chunk [128][36], the k tile's ids
constexpr int kStageFloats =
    (kStatsRows + kStatsCols) * kChunkPitch + kStatsCols;

// kernels 10/11: own rows a block, streamed rows a tile
constexpr int kBwdRows = 64;
constexpr int kBwdCols = 64;
constexpr int kWPitch = kBwdCols + 16;  // w rows: two rows 16 banks apart
constexpr int kSide = 3 * kBwdCols;     // ids, lse, pos_cnt of a tile

// Floats a staged row of E features takes in kernels 10/11: E rounded up to
// 32 (the tail zero-filled) plus 4, which is 4 (mod 32).
__host__ __device__ __forceinline__ int bwd_pitch(int e) {
  return (e + 31) / 32 * 32 + 4;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float part_of(float4 v, int f) {
  return f == 0 ? v.x : f == 1 ? v.y : f == 2 ? v.z : v.w;
}

// acc[r][c] += a[r] . b[c] over 4 features, in feature order.
template <int R, int C>
__device__ __forceinline__ void fma_tile(float (&acc)[R][C],
                                         const float4 (&a)[R],
                                         const float4 (&b)[C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        acc[r][c] = fmaf(part_of(a[r], f), part_of(b[c], f), acc[r][c]);
}

// (max, sum) of a running logsumexp merged with another; -inf with 0 is the
// empty state, and two empty states stay empty (no NaN).
__device__ __forceinline__ void lse_merge(float& mx, float& s, float om,
                                          float os) {
  const float nm = fmaxf(mx, om);
  s = nm == -INFINITY ? 0.f : s * expf(mx - nm) + os * expf(om - nm);
  mx = nm;
}

// Kernel 9.  Grid (row tiles, splits); split y takes the k tiles
// [y * tiles, (y + 1) * tiles).  With one split it writes lse, pos_sum and
// pos_cnt; otherwise part[y][0..3][row] = (max, sum, pos_sum, pos_cnt).
__global__ void __launch_bounds__(kThreads, 1)
    infonce_stats_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const int* __restrict__ idx_q,
                         const int* __restrict__ idx_k,
                         const float* __restrict__ inv_temp, int m, int n,
                         int e, int tiles, float* __restrict__ part,
                         float* __restrict__ lse, float* __restrict__ pos_sum,
                         float* __restrict__ pos_cnt) {
  extern __shared__ __align__(16) float smem[];
  int* q_ids = reinterpret_cast<int*>(smem + kStages * kStageFloats);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kStatsRows;
  const int tile0 = blockIdx.y * tiles;
  const int n_tiles =
      min(tiles, (n + kStatsCols - 1) / kStatsCols - tile0);
  const int chunks = (e + kChunk - 1) / kChunk;
  const int steps = n_tiles * chunks;
  const float invt = *inv_temp;

  // Step s: chunk s % chunks of k tile s / chunks, with the q rows' same
  // chunk, into stage s % kStages; the tile's ids with its last chunk.
  auto issue = [&](int step) {
    if (step < steps) {
      float* st = smem + (step % kStages) * kStageFloats;
      const int col0 = (tile0 + step / chunks) * kStatsCols;
      const int f0 = (step % chunks) * kChunk;
      constexpr int kSegs = kChunk / 4;  // 16-byte pieces a row's chunk
#pragma unroll
      for (int it = 0; it < kStatsRows * kSegs / kThreads; ++it) {
        const int i = tid + it * kThreads, r = i / kSegs, f = i % kSegs * 4;
        const bool ok = f0 + f < e && row0 + r < m;
        cp_async16(st + r * kChunkPitch + f,
                   ok ? q + (size_t)(row0 + r) * e + f0 + f : q, ok);
      }
#pragma unroll
      for (int it = 0; it < kStatsCols * kSegs / kThreads; ++it) {
        const int i = tid + it * kThreads, r = i / kSegs, f = i % kSegs * 4;
        const bool ok = f0 + f < e && col0 + r < n;
        cp_async16(st + (kStatsRows + r) * kChunkPitch + f,
                   ok ? k + (size_t)(col0 + r) * e + f0 + f : k, ok);
      }
      if (step % chunks == chunks - 1 && tid < kStatsCols) {
        int* ids = reinterpret_cast<int*>(
            st + (kStatsRows + kStatsCols) * kChunkPitch);
        const bool ok = col0 + tid < n;
        cp_async4(ids + tid, ok ? idx_k + col0 + tid : idx_k, ok);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  for (int r = tid; r < kStatsRows; r += kThreads)
    q_ids[r] = row0 + r < m ? idx_q[row0 + r] : 0;  // read after a barrier
  // rows ty + 16 r of q, tx + 16 c of k; this thread's running (max, sum,
  // pos_sum, pos_cnt) of row r at stat[r * kThreads + {0, 1, 2, 3} *
  // kStatFloats] (a warp's accesses are contiguous)
  float* stat = reinterpret_cast<float*>(q_ids + kStatsRows) + tid;
  float acc[kStatsReps][8];
#pragma unroll
  for (int r = 0; r < kStatsReps; ++r) {
    stat[r * kThreads] = -INFINITY;
    stat[r * kThreads + kStatFloats] = 0.f;
    stat[r * kThreads + 2 * kStatFloats] = 0.f;
    stat[r * kThreads + 3 * kStatFloats] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }

  issue(0);
  issue(1);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<1>();  // this step's group has landed (the next may fly)
    __syncthreads();     // for every thread; the stage of step - 1 is free
    issue(step + 2);
    const float* st = smem + (step % kStages) * kStageFloats;
    const float* a_s = st + ty * kChunkPitch;
    const float* b_s = st + (kStatsRows + tx) * kChunkPitch;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      float4 a[kStatsReps], b[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = ld4(b_s + 16 * c * kChunkPitch + kk);
#pragma unroll
      for (int r = 0; r < kStatsReps; ++r)
        a[r] = ld4(a_s + 16 * r * kChunkPitch + kk);
      fma_tile(acc, a, b);
    }
    if (step % chunks != chunks - 1) continue;

    // The tile's logits are whole: fold them into this thread's running
    // statistics of its rows, kept in shared memory between tiles so that
    // they hold no registers in the loop above.
    const int col0 = (tile0 + step / chunks) * kStatsCols;
    const int* ids =
        reinterpret_cast<const int*>(st + (kStatsRows + kStatsCols) *
                                              kChunkPitch);
    bool valid[8];
    int col_idx[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      valid[c] = col0 + tx + 16 * c < n;
      col_idx[c] = ids[tx + 16 * c];
    }
#pragma unroll
    for (int r = 0; r < kStatsReps; ++r) {
      float* sr = stat + r * kThreads;  // (max, sum, pos_sum, pos_cnt)
      float mx = sr[0], s = sr[kStatFloats], ps = sr[2 * kStatFloats],
            pc = sr[3 * kStatFloats];
      float tile_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // masked by -inf, not by branches
        acc[r][c] = valid[c] ? acc[r][c] * invt : -INFINITY;
        tile_max = fmaxf(tile_max, acc[r][c]);
      }
      // a tile with no valid column leaves the state alone; exp(-inf) = 0
      // rescales the empty sum of a row that had none so far
      if (tile_max > mx) {
        s *= expf(mx - tile_max);
        mx = tile_max;
      }
      const int my_idx = q_ids[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        // no branch: a masked column adds exp(-inf) = 0 (its logit is
        // -inf, and so may mx be, when this thread saw no valid column)
        s += expf(valid[c] ? acc[r][c] - mx : -INFINITY);
        const bool pos = valid[c] && col_idx[c] == my_idx;
        ps += pos ? acc[r][c] : 0.f;
        pc += pos ? 1.f : 0.f;
        acc[r][c] = 0.f;
      }
      sr[0] = mx;
      sr[kStatFloats] = s;
      sr[2 * kStatFloats] = ps;
      sr[3 * kStatFloats] = pc;
    }
  }
  // merge the 16 threads of each row (lanes 0-15 and 16-31 of a warp hold
  // different rows; xor offsets below 16 stay inside each half)
#pragma unroll
  for (int r = 0; r < kStatsReps; ++r) {
    const float* sr = stat + r * kThreads;
    float mx = sr[0], s = sr[kStatFloats], ps = sr[2 * kStatFloats],
          pc = sr[3 * kStatFloats];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx, off);
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
      pc += __shfl_xor_sync(0xffffffffu, pc, off);
      lse_merge(mx, s, om, os);
    }
    const int i = row0 + ty + 16 * r;
    if (tx != 0 || i >= m) continue;
    if (gridDim.y == 1) {
      lse[i] = mx + logf(s);
      pos_sum[i] = ps;
      pos_cnt[i] = pc;
    } else {
      float* p = part + (size_t)blockIdx.y * 4 * m + i;
      p[0] = mx;
      p[m] = s;
      p[2 * (size_t)m] = ps;
      p[3 * (size_t)m] = pc;
    }
  }
}

// Splits a merge thread reads before it folds them in (a ring block has
// hundreds: one load latency a split would dominate the merge).
constexpr int kMergeAhead = 8;

// Kernel 9's merge: the S partials of each q row in split order.  Past the
// last split the empty state (-inf, 0, 0, 0) changes no bit.
__global__ void __launch_bounds__(kThreads)
    infonce_stats_merge_kernel(const float* __restrict__ part, int splits,
                               int m, float* __restrict__ lse,
                               float* __restrict__ pos_sum,
                               float* __restrict__ pos_cnt) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  float mx = -INFINITY, s = 0.f, ps = 0.f, pc = 0.f;
  for (int y0 = 0; y0 < splits; y0 += kMergeAhead) {
    float v[kMergeAhead][4];
#pragma unroll
    for (int u = 0; u < kMergeAhead; ++u) {
      const float* p = part + (size_t)(y0 + u) * 4 * m + i;
      const bool ok = y0 + u < splits;
#pragma unroll
      for (int x = 0; x < 4; ++x)
        v[u][x] = ok ? p[x * (size_t)m] : (x == 0 ? -INFINITY : 0.f);
    }
#pragma unroll
    for (int u = 0; u < kMergeAhead; ++u) {
      lse_merge(mx, s, v[u][0], v[u][1]);
      ps += v[u][2];
      pc += v[u][3];
    }
  }
  lse[i] = mx + logf(s);
  pos_sum[i] = ps;
  pos_cnt[i] = pc;
}

// Kernels 10 (kDk false) and 11 (kDk true).  Grid (own row tiles, splits):
// the block owns 64 rows of `own` (q for dq, k for dk) and streams the
// 64-row tiles [y * tiles, (y + 1) * tiles) of `other` (k for dq, q for
// dk); lse and pos_cnt belong to q's rows: the own rows for dq, the
// streamed rows for dk.  out[own row] = sum over streamed rows of w * other
// row; with S > 1 the block writes part[y][own row] instead.
template <bool kDk>
__device__ __forceinline__ void bwd_body(
    const float* __restrict__ own_g, const float* __restrict__ other_g,
    const int* __restrict__ idx_own, const int* __restrict__ idx_other,
    const float* __restrict__ inv_temp, const float* __restrict__ lse,
    const float* __restrict__ pos_cnt, int n_own, int n_other, int e,
    int tiles, float* __restrict__ part, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = bwd_pitch(e);
  const int segs = (pitch - 4) / 4;  // 16-byte pieces a staged row
  float* own = smem;                                  // [64][pitch]
  float* oth = own + kBwdRows * pitch;                // 2 x [64][pitch]
  float* wt = oth + 2 * kBwdCols * pitch;             // [64][kWPitch]
  float* side = wt + kBwdRows * kWPitch;              // 2 x [3][64]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBwdRows;
  const int tile0 = blockIdx.y * tiles;
  const int n_tiles = min(tiles, (n_other + kBwdCols - 1) / kBwdCols - tile0);
  const float invt = *inv_temp;

  // rows [r0, r0 + 64) of a [*, e] matrix, zero past n_valid and past e:
  // 8 threads a row, 16 bytes each, 32 rows a pass (segs is a multiple of
  // 8, so no index needs a division)
  auto stage_rows = [&](float* dst, const float* src, int r0, int n_valid) {
#pragma unroll
    for (int pass = 0; pass < 64 / (kThreads / 8); ++pass) {
      const int r = pass * (kThreads / 8) + tid / 8;
      const bool row_ok = r0 + r < n_valid;
      for (int f = tid % 8 * 4; f < segs * 4; f += 32) {
        const bool ok = row_ok && f < e;
        cp_async16(dst + r * pitch + f,
                   ok ? src + (size_t)(r0 + r) * e + f : src, ok);
      }
    }
  };
  auto stage_tile = [&](int t) {
    const int j0 = (tile0 + t) * kBwdCols;
    stage_rows(oth + (t & 1) * kBwdCols * pitch, other_g, j0, n_other);
    if (tid < kBwdCols) {
      float* sd = side + (t & 1) * kSide;
      const int j = j0 + tid;
      const bool ok = j < n_other;
      cp_async4(sd + tid, ok ? idx_other + j : idx_other, ok);
      if (kDk) {
        cp_async4(sd + kBwdCols + tid, ok ? lse + j : lse, ok);
        cp_async4(sd + 2 * kBwdCols + tid, ok ? pos_cnt + j : pos_cnt, ok);
      }
    }
  };

  // the logits: rows sy + 16 r of own, sx + 16 c of the tile
  const int sx = tid % 16, sy = tid / 16;
  bool own_ok[4];
  int own_idx[4];
  float own_lse[4], own_ipc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + sy + 16 * r;
    own_ok[r] = i < n_own;
    own_idx[r] = own_ok[r] ? idx_own[i] : 0;
    own_lse[r] = !kDk && own_ok[r] ? lse[i] : 0.f;
    own_ipc[r] = !kDk && own_ok[r] ? 1.f / fmaxf(pos_cnt[i], 1.f) : 0.f;
  }
  // the weighted sum: own rows ry + 8 r, features 4 fx.. and 4 (fx + 32)..
  const int fx = tid % 32, ry = tid / 32;
  const bool g_ok[2] = {4 * fx < e, 4 * (fx + 32) < e};
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  stage_rows(own, own_g, row0, n_own);
  stage_tile(0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // tile t (and the own rows) landed
    __syncthreads();     // for every thread; tile t - 1 and w are read
    if (t + 1 < n_tiles) stage_tile(t + 1);
    cp_async_commit();
    const float* ot = oth + (t & 1) * kBwdCols * pitch;
    const float* sd = side + (t & 1) * kSide;

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    const float* a_s = own + sy * pitch;
    const float* b_s = ot + sx * pitch;
#pragma unroll 4
    for (int kk = 0; kk < e; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ld4(b_s + 16 * c * pitch + kk);
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(a_s + 16 * r * pitch + kk);
      fma_tile(sc, a, b);
    }
    const int j0 = (tile0 + t) * kBwdCols;
    const int* sid = reinterpret_cast<const int*>(sd);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jj = sx + 16 * c;
      const bool ok = j0 + jj < n_other;
      const int jdx = sid[jj];
      const float j_lse = kDk ? sd[kBwdCols + jj] : 0.f;
      const float j_ipc =
          kDk ? 1.f / fmaxf(sd[2 * kBwdCols + jj], 1.f) : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // no branch: exp(-inf) = 0 masks
        const bool live = ok && own_ok[r];
        const float w = expf(live ? sc[r][c] * invt -
                                        (kDk ? j_lse : own_lse[r])
                                  : -INFINITY);
        const bool pos = live && jdx == own_idx[r];
        wt[(sy + 16 * r) * kWPitch + jj] =
            pos ? w - (kDk ? j_ipc : own_ipc[r]) : w;
      }
    }
    __syncthreads();  // w is whole

    const float* w_s = wt + ry * kWPitch;
#pragma unroll 2
    for (int j = 0; j < kBwdCols; j += 4) {
      float4 o[2][4];  // [feature group][streamed row j .. j + 3]
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          o[g][jj] = g_ok[g] ? ld4(ot + (j + jj) * pitch + 4 * (fx + 32 * g))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 w = ld4(w_s + 8 * r * kWPitch + j);
        const float wj[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            float* a = acc[r] + 4 * g;
            a[0] = fmaf(wj[jj], o[g][jj].x, a[0]);
            a[1] = fmaf(wj[jj], o[g][jj].y, a[1]);
            a[2] = fmaf(wj[jj], o[g][jj].z, a[2]);
            a[3] = fmaf(wj[jj], o[g][jj].w, a[3]);
          }
      }
    }
  }
  float* dst = gridDim.y == 1 ? out : part + (size_t)blockIdx.y * n_own * e;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = row0 + ry + 8 * r;
    if (i >= n_own) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g)
      if (g_ok[g])
        *reinterpret_cast<float4*>(dst + (size_t)i * e + 4 * (fx + 32 * g)) =
            make_float4(acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2],
                        acc[r][4 * g + 3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    infonce_bwd_dq_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const int* __restrict__ idx_q,
                          const int* __restrict__ idx_k,
                          const float* __restrict__ inv_temp,
                          const float* __restrict__ lse,
                          const float* __restrict__ pos_cnt, int m, int n,
                          int e, int tiles, float* __restrict__ part,
                          float* __restrict__ dq) {
  bwd_body<false>(q, k, idx_q, idx_k, inv_temp, lse, pos_cnt, m, n, e,
                  tiles, part, dq);
}

__global__ void __launch_bounds__(kThreads, 1)
    infonce_bwd_dk_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const int* __restrict__ idx_q,
                          const int* __restrict__ idx_k,
                          const float* __restrict__ inv_temp,
                          const float* __restrict__ lse,
                          const float* __restrict__ pos_cnt, int m, int n,
                          int e, int tiles, float* __restrict__ part,
                          float* __restrict__ dk) {
  bwd_body<true>(k, q, idx_k, idx_q, inv_temp, lse, pos_cnt, n, m, e, tiles,
                 part, dk);
}

// Kernels 10/11's merge: out = part[0] + part[1] + ... in split order, 16
// bytes a thread over `vecs` float4s of out.
__global__ void __launch_bounds__(kThreads)
    infonce_bwd_merge_kernel(const float4* __restrict__ part, int splits,
                             long long vecs, float4* __restrict__ out) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= vecs) return;
  float4 s = part[i];
  for (int y0 = 1; y0 < splits; y0 += kMergeAhead) {
    float4 v[kMergeAhead];
#pragma unroll
    for (int u = 0; u < kMergeAhead; ++u)
      v[u] = y0 + u < splits ? part[(y0 + u) * vecs + i]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kMergeAhead; ++u) {  // + 0 past the end: exact
      s.x += v[u].x;
      s.y += v[u].y;
      s.z += v[u].z;
      s.w += v[u].w;
    }
  }
  out[i] = s;
}

size_t stats_smem() {  // the ring, the block's q ids, the statistics
  return sizeof(float) *
         ((size_t)kStages * kStageFloats + kStatsRows + 4 * kStatFloats);
}

size_t bwd_smem(int e) {
  return sizeof(float) * ((size_t)(kBwdRows + 2 * kBwdCols) * bwd_pitch(e) +
                          kBwdRows * kWPitch + 2 * kSide);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename Kernel>
int launch_bwd(Kernel kernel, const float* q, const float* k,
               const int* idx_q, const int* idx_k, const float* inv_temp,
               const float* lse, const float* pos_cnt, int m, int n, int e,
               int own_rows, int splits, int tiles, float* part, float* out,
               void* stream) {
  const size_t smem = bwd_smem(e);
  int err = prepare(kernel, smem);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((own_rows + kBwdRows - 1) / kBwdRows, splits);
  kernel<<<grid, kThreads, smem, st>>>(q, k, idx_q, idx_k, inv_temp, lse,
                                       pos_cnt, m, n, e, tiles, part, out);
  err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  const long long vecs = (long long)own_rows * e / 4;
  infonce_bwd_merge_kernel<<<(unsigned)((vecs + kThreads - 1) / kThreads),
                             kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(part), splits, vecs,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The widest E the kernels take; E must also be a multiple of 4.
int infonce_max_dim() { return kMaxE; }

// A block's tile (axis 0: own rows, 1: streamed rows a tile) of kernel 9
// (which 0) or kernels 10/11 (which 1): the wrapper's split plan uses them.
int infonce_tile(int which, int axis) {
  if (which == 0) return axis == 0 ? kStatsRows : kStatsCols;
  return axis == 0 ? kBwdRows : kBwdCols;
}

// Bytes of dynamic shared memory a launch needs (which: 0 stats, 1 dq or
// dk); the caller checks it against the card's per-block limit.
size_t infonce_smem_bytes(int which, int e) {
  return which == 0 ? stats_smem() : bwd_smem(e);
}

// Kernel 9.  q [m, e], k [n, e] f32 row-major, 16-byte aligned; idx_q [m],
// idx_k [n] int32; inv_temp: one f32 in device memory; lse, pos_sum,
// pos_cnt: f32 [m].  splits x tiles k tiles of 128 cover n (the wrapper's
// `split_plan`); with splits > 1, part is a [splits, 4, m] f32 workspace
// and a merge kernel follows.  Returns cudaGetLastError() after the
// launches.
int infonce_stats(const float* q, const float* k, const int* idx_q,
                  const int* idx_k, const float* inv_temp, int m, int n, int e,
                  int splits, int tiles, float* part, float* lse,
                  float* pos_sum, float* pos_cnt, void* stream) {
  const size_t smem = stats_smem();
  int err = prepare(infonce_stats_kernel, smem);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kStatsRows - 1) / kStatsRows, splits);
  infonce_stats_kernel<<<grid, kThreads, smem, st>>>(
      q, k, idx_q, idx_k, inv_temp, m, n, e, tiles, part, lse, pos_sum,
      pos_cnt);
  err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  infonce_stats_merge_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                               st>>>(part, splits, m, lse, pos_sum, pos_cnt);
  return (int)cudaGetLastError();
}

// Kernel 10: dq_raw [m, e] from q, k, the ids, inv_temp and q's lse and
// pos_cnt [m] (kernel 9's outputs).  splits x tiles k tiles of 64 cover n;
// with splits > 1, part is a [splits, m, e] f32 workspace.
int infonce_bwd_dq(const float* q, const float* k, const int* idx_q,
                   const int* idx_k, const float* inv_temp, const float* lse,
                   const float* pos_cnt, int m, int n, int e, int splits,
                   int tiles, float* part, float* dq, void* stream) {
  return launch_bwd(infonce_bwd_dq_kernel, q, k, idx_q, idx_k, inv_temp, lse,
                    pos_cnt, m, n, e, m, splits, tiles, part, dq, stream);
}

// Kernel 11: dk_raw [n, e], arguments as kernel 10's with the roles of the
// sides swapped: splits x tiles q tiles of 64 cover m, part is
// [splits, n, e].
int infonce_bwd_dk(const float* q, const float* k, const int* idx_q,
                   const int* idx_k, const float* inv_temp, const float* lse,
                   const float* pos_cnt, int m, int n, int e, int splits,
                   int tiles, float* part, float* dk, void* stream) {
  return launch_bwd(infonce_bwd_dk_kernel, q, k, idx_q, idx_k, inv_temp, lse,
                    pos_cnt, m, n, e, n, splits, tiles, part, dk, stream);
}

}  // extern "C"
