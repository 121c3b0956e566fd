// Fused cross-attention forward for Hopper (sm_90a).
//
// Replaces: leccr_tpu/ops/pallas_attention.py `_attn_kernel` (the Pallas
// kernel that `fused_cross_attention` launches for the caption-interaction
// stacks of `LECCRModel.embed_images`).
//
// What it computes, per (batch b, head h, query row i):
//   s_j   = (q_i . k_j) * (1/sqrt(Dh))               in f32
//   s_j   = -FLT_MAX        where mask[b, j] != 0     (f32 min, never -inf)
//   p_j   = exp(s_j - max s) / sum_j exp(s_j - max s)
//   out_i = sum_j p_j v_j, stored in q's dtype (bf16 or f32)
// A row whose keys are all padded therefore gives the uniform mean of v,
// exactly as the TPU kernel does, and never NaN.
//
// What bounds it: memory.  Per head it does about 4*Lq*Lk*Dh flops against
// (Lq + 2*Lk)*Dh input and Lq*Dh output elements; at the path's shapes
// ((Lq,Lk) = (4,200), (145,4), (4,145), Dh = 64) that is at most ~4 flops per
// byte, far below the ~295 flops/byte at which an H100 stops being
// memory-bound.  The least time is the bytes of q, k, v, the bool mask and
// out at 3.35 TB/s: 8 µs at (4,200), 6 µs at (145,4) and (4,145) for the
// path's B = 64, H = 8 in bf16.  So the kernel has to keep enough bytes in
// flight on every SM, waste no lanes on the few rows of the short side,
// and read every input byte from device memory once.  No tensor cores: at
// 4 flops a byte the products are not what takes the time.
//
// The design: four bodies, chosen by the caller from the shapes
// (`fused_body` in ops/fused_cross_attention.py).  In the two small
// bodies a block owns one (b, h) and all its rows; they are compiled for
// rows of 4, 8 or 16 chunks of 16 bytes (Dh = 32, 64, 128 in bf16).
// - few queries (Lq <= 16: the slots attending the caption tokens or the
//   vision tokens).  256 threads issue every load of the head at once (K
//   and V by cp.async in two groups, so that the scores run while V still
//   lands, 16 bytes a thread a copy: ~51 KB a block at Lk = 200, four
//   blocks an SM, at most 64 registers a thread; q widened to f32).
//   Scores: a key a thread (warps split the key range, every lane has a
//   key), the q rows read from shared memory; each thread walks its key's
//   16-byte chunks from its own starting chunk on, so the lanes of one
//   16-byte phase hit distinct banks of K.  Softmax: a warp a query row,
//   max and sum by warp shuffles over the scores in shared memory.  p·v:
//   lanes over feature pairs, warps over key ranges, then the eight warps'
//   partial outputs (over the dead K rows) summed in warp order, an
//   element a thread.
// - few keys (Lk <= 16: the vision tokens attending the slots).  K and V
//   (at most 16 rows) are staged once as f32, and up to 256 q rows at a
//   time by cp.async, all in flight at once (rows padded by 16 bytes, so
//   the threads that read one chunk of neighbouring rows hit distinct
//   banks).  A thread owns a query row: every score and the softmax stay
//   in its registers, K and V are read as broadcasts, and it writes its
//   out row over its q row in the tile, which the block then stores whole
//   lines at a time.
// - key tiles (wide heads, 128 < Dh <= 512: the video model's interaction
//   width 4096 at 8 heads gives Dh = 512, 1 KB a bf16 row).  No block
//   holds a whole head's K and V: a block owns one (b, h) and up to 16
//   query rows and streams the keys in tiles of 16 through a double buffer
//   (cp.async, 16 bytes a copy: the next tile lands while this one is
//   used), with an online f32 softmax.  Scores: a warp a key, lanes over
//   its 16-byte chunks, a warp sum per (row, key); each tile rescales the
//   rows' running sum and output by exp(old max - new max), so a row whose
//   keys are all padded (every score f32 min) keeps exp(0) = 1 per key and
//   ends as the mean of v.  p·v: a thread a feature pair, over the tile's
//   keys.  Per (b, h) at (Lq, Lk) = (2, 200) it reads 400 KB of K and V
//   in bf16, so the bound is the bytes: ~63 µs a call at B = 64, H = 8.
// - every other shape (and unaligned views, or head dims the other bodies
//   do not take): one block per (b, h) and 8 query rows, K and V staged as
//   f32 (rows padded by one float), a warp a query row with lanes over keys
//   for the scores and over features for p·v.  Its shared memory grows
//   with Lk·Dh: at Dh = 512 it holds at most 52 keys.
// Loads of q/k/v take the innermost stride 1 and any outer strides, so the
// caller passes head-split views without a transpose copy.  Every body sums
// in a fixed order: the result does not depend on the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kGeneralWarps = 8;  // the general body: query rows a block
constexpr int kBlock = 256;       // threads of a few-queries/few-keys block
constexpr int kBlockWarps = kBlock / kWarp;
constexpr int kFew = 16;          // Lq (Lk) bound of the few-queries (-keys)
constexpr int kPairs = 2;         // feature pairs a lane in p·v: Dh <= 128
constexpr int kFkTileRows = 256;  // q rows (and threads) of a few-keys block
constexpr int kSmallBlocksPerSm = 4;  // resident few-queries blocks an SM

constexpr int kKt = 16;           // keys a tile of the key-tiles body
constexpr int kKtMaxDh = 2 * kBlock;  // its widest head: 2 features a thread

// Bodies, as the caller names them.
constexpr int kGeneral = 0, kFewQueries = 1, kFewKeys = 2, kKeyTiles = 3;

struct Strides {
  long long b, h, l;  // element strides of dims 0, 1, 2; dim 3 has stride 1
};

struct Params {
  int vec;  // 1: q/k/v rows start 16-byte aligned, Dh a multiple of 16 bytes
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;  // [B, Lk] bool, nonzero = padding; or null
  void* out;
  Strides sq, sk, sv, so;
  int heads, lq, lk, dh;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Elements of T in one 16-byte load.
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

// A 16-byte chunk of T widened to f32, and f32 values rounded into one.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* dst) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int t = 0; t < Vec<T>::n; ++t) dst[t] = to_f32(e[t]);
}
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* src) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int t = 0; t < Vec<T>::n; ++t) store(e + t, src[t]);
  return raw;
}

// One 16-byte load of Vec<T>::n elements, widened to f32.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  unpack16<T>(*reinterpret_cast<const uint4*>(src), dst);
}

// Two neighbouring elements widened to f32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 bytes from device to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
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

template <typename T>
__device__ __forceinline__ const T* head(const void* base, const Strides& s,
                                         int b, int h) {
  return static_cast<const T*>(base) + b * s.b + h * s.h;
}

// --------------------------------------------------- few queries (Lq <= 16)
// Shared memory (bytes, each piece 16-byte aligned): K [Lk][Dh] T, reused
// for the warps' partial outputs [8][Lq][Dh] f32 once the scores are taken;
// V [Lk][Dh] T; the scores, then p, [Lq][Lk] f32; q [Lq][Dh] f32.
struct FqLayout {
  size_t v, s, q, total;
};

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

__host__ __device__ inline FqLayout fq_layout(int lq, int lk, int dh,
                                              int item) {
  const size_t row = (size_t)dh * item;
  const size_t k = lk * row, part = (size_t)kBlockWarps * lq * dh * 4;
  FqLayout l;
  l.v = round16(k > part ? k : part);
  l.s = l.v + round16(lk * row);
  l.q = l.s + round16((size_t)lq * lk * 4);
  l.total = l.q + round16((size_t)lq * dh * 4);
  return l;
}

// QMAX: the query rows the registers are sized for (>= Lq); CHUNKS: the
// 16-byte chunks of a row (Dh = CHUNKS · 16 / size).
template <typename T, int QMAX, int CHUNKS>
__global__ void __launch_bounds__(kBlock, kSmallBlocksPerSm)
    fca_few_queries_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int n = Vec<T>::n, dh = CHUNKS * n;
  const int lq = p.lq, lk = p.lk;
  const FqLayout lay = fq_layout(lq, lk, dh, sizeof(T));
  T* ks = reinterpret_cast<T*>(smem_bytes);
  float* part = reinterpret_cast<float*>(smem_bytes);
  T* vs = reinterpret_cast<T*>(smem_bytes + lay.v);
  float* ss = reinterpret_cast<float*>(smem_bytes + lay.s);
  float* qs = reinterpret_cast<float*>(smem_bytes + lay.q);
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;

  // every load of the head in flight at once: K (the first copy group),
  // V (the second, awaited only after the scores) and q, widened to f32
  const T* kg = head<T>(p.k, p.sk, b, h);
  const T* vg = head<T>(p.v, p.sv, b, h);
  const T* qg = head<T>(p.q, p.sq, b, h);
  for (int e = tid; e < lk * CHUNKS; e += kBlock) {
    const int j = e / CHUNKS, c = (e % CHUNKS) * n;
    cp_async16(ks + j * dh + c, kg + j * p.sk.l + c);
  }
  cp_async_commit();
  for (int e = tid; e < lk * CHUNKS; e += kBlock) {
    const int j = e / CHUNKS, c = (e % CHUNKS) * n;
    cp_async16(vs + j * dh + c, vg + j * p.sv.l + c);
  }
  cp_async_commit();
  for (int e = tid; e < lq * CHUNKS; e += kBlock) {
    const int i = e / CHUNKS, c = (e % CHUNKS) * n;
    load16(qg + i * p.sq.l + c, qs + i * dh + c);
  }
  cp_async_wait<1>();
  __syncthreads();

  // scores, a key a thread; its 16-byte chunks from chunk (tid % CHUNKS) on
  const unsigned char* mask = p.mask ? p.mask + (long long)b * lk : nullptr;
  for (int j = tid; j < lk; j += kBlock) {
    float acc[QMAX];
#pragma unroll
    for (int i = 0; i < QMAX; ++i) acc[i] = 0.f;
#pragma unroll
    for (int step = 0; step < CHUNKS; ++step) {
      const int c = (step + tid) % CHUNKS;
      float kf[n];
      load16(ks + j * dh + c * n, kf);
#pragma unroll
      for (int i = 0; i < QMAX; ++i)
        if (i < lq) {
          const float4* qf =
              reinterpret_cast<const float4*>(qs + i * dh + c * n);
#pragma unroll
          for (int t = 0; t < n / 4; ++t) {
            const float4 x = qf[t];
            acc[i] = fmaf(x.x, kf[4 * t], acc[i]);
            acc[i] = fmaf(x.y, kf[4 * t + 1], acc[i]);
            acc[i] = fmaf(x.z, kf[4 * t + 2], acc[i]);
            acc[i] = fmaf(x.w, kf[4 * t + 3], acc[i]);
          }
        }
    }
    const bool padded = mask && mask[j];
#pragma unroll
    for (int i = 0; i < QMAX; ++i)
      if (i < lq) ss[i * lk + j] = padded ? -FLT_MAX : acc[i] * p.scale;
  }
  __syncthreads();

  // softmax, a warp a query row: p = exp(s - max) / sum
  for (int i = warp; i < lq; i += kBlockWarps) {
    float* row = ss + i * lk;
    float m = -FLT_MAX;
    for (int j = lane; j < lk; j += kWarp) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < lk; j += kWarp) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < lk; j += kWarp) row[j] = row[j] / sum;
  }
  cp_async_wait<0>();
  __syncthreads();

  // p·v: a warp a range of keys, a lane feature pairs 2 (lane + 32 t); the
  // partial outputs go over the K rows, which no one reads any more
  const int span = (lk + kBlockWarps - 1) / kBlockWarps;
  const int j_lo = warp * span, j_hi = min(lk, j_lo + span);
#pragma unroll
  for (int t = 0; t < kPairs; ++t) {
    const int d = 2 * (lane + kWarp * t);
    if (d >= dh) break;
    float acc[QMAX][2];
#pragma unroll
    for (int i = 0; i < QMAX; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int j = j_lo; j < j_hi; ++j) {
      const float2 vj = load2(vs + j * dh + d);
#pragma unroll
      for (int i = 0; i < QMAX; ++i)
        if (i < lq) {
          const float pj = ss[i * lk + j];
          acc[i][0] = fmaf(pj, vj.x, acc[i][0]);
          acc[i][1] = fmaf(pj, vj.y, acc[i][1]);
        }
    }
#pragma unroll
    for (int i = 0; i < QMAX; ++i)
      if (i < lq)
        *reinterpret_cast<float2*>(part + (warp * lq + i) * dh + d) =
            make_float2(acc[i][0], acc[i][1]);
  }
  __syncthreads();

  // the warps' partials summed in warp order, an element a thread
  T* og = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h;
  for (int e = tid; e < lq * dh; e += kBlock) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kBlockWarps; ++w) o += part[w * lq * dh + e];
    store(og + (e / dh) * p.so.l + e % dh, o);
  }
}

// ------------------------------------------------------ few keys (Lk <= 16)
// Shared memory: K, V [Lk][Dh] f32, the keys' padding bytes, then a tile of
// q rows [min(Lq, kFkTileRows)][Dh + 16 bytes] T (the pad puts the rows
// that neighbouring threads read at the same chunk in distinct banks).
__host__ __device__ inline size_t fk_q_offset(int lk, int dh) {
  return round16(2 * (size_t)lk * dh * 4 + lk);
}

__host__ __device__ inline size_t fk_smem_bytes(int lq, int lk, int dh,
                                                int item) {
  const int rows = lq < kFkTileRows ? lq : kFkTileRows;
  return fk_q_offset(lk, dh) + (size_t)rows * (dh * item + 16);
}

// Threads of a few-keys block: a row each, up to kFkTileRows.
int fk_threads(int lq) {
  const int rows = lq < kFkTileRows ? lq : kFkTileRows;
  return (rows + kWarp - 1) / kWarp * kWarp;
}

// CHUNKS: the 16-byte chunks of a row (Dh = CHUNKS · 16 / size).
template <typename T, int CHUNKS>
__global__ void __launch_bounds__(kFkTileRows)
    fca_few_keys_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int n = Vec<T>::n, dh = CHUNKS * n, pitch = dh + n;
  const int lq = p.lq, lk = p.lk;
  float* kf = reinterpret_cast<float*>(smem_bytes);
  float* vf = kf + lk * dh;
  unsigned char* pad = reinterpret_cast<unsigned char*>(vf + lk * dh);
  T* qs = reinterpret_cast<T*>(smem_bytes + fk_q_offset(lk, dh));
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int tid = threadIdx.x;

  const T* kg = head<T>(p.k, p.sk, b, h);
  const T* vg = head<T>(p.v, p.sv, b, h);
  const T* qg = head<T>(p.q, p.sq, b, h);
  T* og = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h;
  for (int e = tid; e < lk * CHUNKS; e += blockDim.x) {
    const int j = e / CHUNKS, c = (e % CHUNKS) * n;
    load16(kg + j * p.sk.l + c, kf + j * dh + c);
    load16(vg + j * p.sv.l + c, vf + j * dh + c);
  }
  if (tid < lk) pad[tid] = p.mask ? p.mask[(long long)b * lk + tid] : 0;

  // a tile of q rows at a time, all of its loads in flight at once
  for (int r0 = 0; r0 < lq; r0 += kFkTileRows) {
    const int rows = min(kFkTileRows, lq - r0);
    for (int e = tid; e < rows * CHUNKS; e += blockDim.x) {
      const int i = e / CHUNKS, c = (e % CHUNKS) * n;
      cp_async16(qs + i * pitch + c, qg + (r0 + i) * p.sq.l + c);
    }
    cp_async_wait_all();
    __syncthreads();
    // a row a thread: its scores over the keys (K read as a broadcast),
    // the softmax, then its out row over its own q row in the tile
    for (int i = tid; i < rows; i += blockDim.x) {
      float s[kFew];
#pragma unroll
      for (int j = 0; j < kFew; ++j) s[j] = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        float qv[n];
        load16(qs + i * pitch + c * n, qv);
#pragma unroll
        for (int j = 0; j < kFew; ++j)
          if (j < lk) {
            const float4* kr =
                reinterpret_cast<const float4*>(kf + j * dh + c * n);
#pragma unroll
            for (int t = 0; t < n / 4; ++t) {
              const float4 x = kr[t];
              s[j] = fmaf(qv[4 * t], x.x, s[j]);
              s[j] = fmaf(qv[4 * t + 1], x.y, s[j]);
              s[j] = fmaf(qv[4 * t + 2], x.z, s[j]);
              s[j] = fmaf(qv[4 * t + 3], x.w, s[j]);
            }
          }
      }
      float m = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < kFew; ++j)
        if (j < lk) {
          s[j] = pad[j] ? -FLT_MAX : s[j] * p.scale;
          m = fmaxf(m, s[j]);
        }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kFew; ++j)
        if (j < lk) {
          s[j] = expf(s[j] - m);
          sum += s[j];
        }
#pragma unroll
      for (int j = 0; j < kFew; ++j)
        if (j < lk) s[j] = s[j] / sum;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        float o[n];
#pragma unroll
        for (int t = 0; t < n; ++t) o[t] = 0.f;
#pragma unroll
        for (int j = 0; j < kFew; ++j)
          if (j < lk) {
            const float4* vr =
                reinterpret_cast<const float4*>(vf + j * dh + c * n);
#pragma unroll
            for (int t = 0; t < n / 4; ++t) {
              const float4 x = vr[t];
              o[4 * t] = fmaf(s[j], x.x, o[4 * t]);
              o[4 * t + 1] = fmaf(s[j], x.y, o[4 * t + 1]);
              o[4 * t + 2] = fmaf(s[j], x.z, o[4 * t + 2]);
              o[4 * t + 3] = fmaf(s[j], x.w, o[4 * t + 3]);
            }
          }
        *reinterpret_cast<uint4*>(qs + i * pitch + c * n) = pack16<T>(o);
      }
    }
    __syncthreads();
    // the tile's out rows stored whole lines at a time
    for (int e = tid; e < rows * CHUNKS; e += blockDim.x) {
      const int i = e / CHUNKS, c = (e % CHUNKS) * n;
      *reinterpret_cast<uint4*>(og + (r0 + i) * p.so.l + c) =
          *reinterpret_cast<const uint4*>(qs + i * pitch + c);
    }
    __syncthreads();  // the tile is read before the next one overwrites it
  }
}

// ------------------------------------------- key tiles (128 < Dh <= 512)
// Shared memory (bytes, each piece 16-byte aligned): q [QMAX][Dh] T; K
// [2][kKt][Dh] T and V [2][kKt][Dh] T (the double buffer); the tile's
// scores, then exp, [QMAX][kKt] f32; the rows' running max, sum and this
// tile's rescale, [3][QMAX] f32.
struct KtLayout {
  size_t k, v, p, stat, total;
};

__host__ __device__ inline KtLayout kt_layout(int qmax, int dh, int item) {
  const size_t row = (size_t)dh * item;
  KtLayout l;
  l.k = round16(qmax * row);
  l.v = l.k + 2 * kKt * row;
  l.p = l.v + 2 * kKt * row;
  l.stat = l.p + round16((size_t)qmax * kKt * 4);
  l.total = l.stat + round16(3 * (size_t)qmax * 4);
  return l;
}

// The query rows a key-tiles block takes: 4 when Lq <= 4 (the slots), else
// 16 (blockIdx.y walks the tiles of rows).
__host__ __device__ inline int kt_rows(int lq) { return lq <= 4 ? 4 : kFew; }

template <typename T, int QMAX>
__global__ void __launch_bounds__(kBlock) fca_key_tiles_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int n = Vec<T>::n;
  constexpr int kMaxChunks = kKtMaxDh / n / kWarp;  // a lane's, per row
  const int dh = p.dh, lk = p.lk, chunks = dh / n;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int r0 = blockIdx.y * QMAX, rows = min(QMAX, p.lq - r0);
  const KtLayout lay = kt_layout(QMAX, dh, sizeof(T));
  T* qs = reinterpret_cast<T*>(smem_bytes);
  T* ks = reinterpret_cast<T*>(smem_bytes + lay.k);
  T* vs = reinterpret_cast<T*>(smem_bytes + lay.v);
  float* ps = reinterpret_cast<float*>(smem_bytes + lay.p);
  float* row_max = reinterpret_cast<float*>(smem_bytes + lay.stat);
  float* row_sum = row_max + QMAX;
  float* row_scale = row_sum + QMAX;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;

  const T* qg = head<T>(p.q, p.sq, b, h) + (long long)r0 * p.sq.l;
  const T* kg = head<T>(p.k, p.sk, b, h);
  const T* vg = head<T>(p.v, p.sv, b, h);
  const unsigned char* mask = p.mask ? p.mask + (long long)b * lk : nullptr;
  const long long k_row = p.sk.l, v_row = p.sv.l;
  const int tiles = (lk + kKt - 1) / kKt;

  // K and V of tile t into buffer t % 2, as one copy group
  auto stage = [&](int t) {
    const int j0 = t * kKt, keys = min(kKt, lk - j0);
    T* kb = ks + (t & 1) * kKt * dh;
    T* vb = vs + (t & 1) * kKt * dh;
    for (int e = tid; e < keys * chunks; e += kBlock) {
      const int j = e / chunks, c = (e % chunks) * n;
      cp_async16(kb + j * dh + c, kg + (j0 + j) * k_row + c);
      cp_async16(vb + j * dh + c, vg + (j0 + j) * v_row + c);
    }
    cp_async_commit();
  };
  for (int e = tid; e < rows * chunks; e += kBlock) {  // q joins tile 0
    const int i = e / chunks, c = (e % chunks) * n;
    cp_async16(qs + i * dh + c, qg + (long long)i * p.sq.l + c);
  }
  stage(0);
  if (tid < QMAX) {
    row_max[tid] = -FLT_MAX;
    row_sum[tid] = 0.f;
  }

  const int d0 = 2 * tid;  // this thread's output feature pair
  float acc[QMAX][2];
#pragma unroll
  for (int i = 0; i < QMAX; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = t * kKt, keys = min(kKt, lk - j0);
    const T* kb = ks + (t & 1) * kKt * dh;
    const T* vb = vs + (t & 1) * kKt * dh;

    // scores: a warp a key, its chunks over the lanes (lane + 32 u)
    for (int j = warp; j < keys; j += kBlockWarps) {
      float kf[kMaxChunks][n];
#pragma unroll
      for (int u = 0; u < kMaxChunks; ++u)
        if (lane + kWarp * u < chunks)
          load16(kb + j * dh + (lane + kWarp * u) * n, kf[u]);
      const bool padded = mask && mask[j0 + j];
#pragma unroll
      for (int i = 0; i < QMAX; ++i)
        if (i < rows) {
          float part = 0.f;
#pragma unroll
          for (int u = 0; u < kMaxChunks; ++u)
            if (lane + kWarp * u < chunks) {
              float qf[n];
              load16(qs + i * dh + (lane + kWarp * u) * n, qf);
#pragma unroll
              for (int e = 0; e < n; ++e) part = fmaf(qf[e], kf[u][e], part);
            }
          const float s = warp_sum(part);
          if (lane == 0) ps[i * kKt + j] = padded ? -FLT_MAX : s * p.scale;
        }
    }
    __syncthreads();

    // the online softmax, a warp a row, a lane a key of the tile
    for (int i = warp; i < rows; i += kBlockWarps) {
      float* pr = ps + i * kKt;
      const float s = lane < keys ? pr[lane] : -FLT_MAX;
      const float m_old = row_max[i];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float e = lane < keys ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(e);
      if (lane < keys) pr[lane] = e;
      if (lane == 0) {
        const float rescale = expf(m_old - m_new);  // 1 while all padded
        row_scale[i] = rescale;
        row_sum[i] = row_sum[i] * rescale + sum;
        row_max[i] = m_new;
      }
    }
    __syncthreads();

    // p·v: a thread its feature pair, over the tile's keys in order
    if (d0 < dh) {
#pragma unroll
      for (int i = 0; i < QMAX; ++i)
        if (i < rows) {
          acc[i][0] *= row_scale[i];
          acc[i][1] *= row_scale[i];
        }
      for (int j = 0; j < keys; ++j) {
        const float2 vj = load2(vb + j * dh + d0);
#pragma unroll
        for (int i = 0; i < QMAX; ++i)
          if (i < rows) {
            const float pj = ps[i * kKt + j];
            acc[i][0] = fmaf(pj, vj.x, acc[i][0]);
            acc[i][1] = fmaf(pj, vj.y, acc[i][1]);
          }
      }
    }
    __syncthreads();  // the next tile rewrites the scores and this buffer
  }

  if (d0 < dh) {
    T* og = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h +
            (long long)r0 * p.so.l;
#pragma unroll
    for (int i = 0; i < QMAX; ++i)
      if (i < rows) {
        store(og + i * p.so.l + d0, acc[i][0] / row_sum[i]);
        store(og + i * p.so.l + d0 + 1, acc[i][1] / row_sum[i]);
      }
  }
}

// ---------------------------------------------------------- every shape
// Shared memory: K [Lk][Dh+1] f32, V [Lk][Dh] f32, per warp a q row [Dh]
// and a score row [Lk], then the mask row [Lk] as bytes.
template <typename T>
__global__ void fca_general_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  float* smem = reinterpret_cast<float*>(smem_bytes);
  const int dh = p.dh, lk = p.lk;
  const int kstride = dh + 1;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  float* ks = smem;
  float* vs = ks + lk * kstride;
  float* qrow = vs + lk * dh + warp * (dh + lk);
  float* srow = qrow + dh;
  unsigned char* pad =
      reinterpret_cast<unsigned char*>(vs + lk * dh + n_warps * (dh + lk));

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int i = blockIdx.y * n_warps + warp;  // this warp's query row

  const T* kg = head<T>(p.k, p.sk, b, h);
  const T* vg = head<T>(p.v, p.sv, b, h);
  const T* qg = head<T>(p.q, p.sq, b, h) + i * p.sq.l;
  if (p.vec) {  // every thread keeps 2 x 16 bytes in flight per step
    constexpr int n = Vec<T>::n;
    const int per_row = dh / n;
#pragma unroll 4
    for (int e = threadIdx.x; e < lk * per_row; e += blockDim.x) {
      const int j = e / per_row, d = (e % per_row) * n;
      float kv[n], vv[n];
      load16(kg + j * p.sk.l + d, kv);
      load16(vg + j * p.sv.l + d, vv);
#pragma unroll
      for (int t = 0; t < n; ++t) {
        ks[j * kstride + d + t] = kv[t];
        vs[j * dh + d + t] = vv[t];
      }
    }
    if (i < p.lq)
      for (int d = lane * n; d < dh; d += kWarp * n) load16(qg + d, qrow + d);
  } else {
    for (int e = threadIdx.x; e < lk * dh; e += blockDim.x) {
      const int j = e / dh, d = e % dh;
      ks[j * kstride + d] = to_f32(kg[j * p.sk.l + d]);
      vs[j * dh + d] = to_f32(vg[j * p.sv.l + d]);
    }
    if (i < p.lq)
      for (int d = lane; d < dh; d += kWarp) qrow[d] = to_f32(qg[d]);
  }
  for (int j = threadIdx.x; j < lk; j += blockDim.x)
    pad[j] = p.mask ? p.mask[(long long)b * lk + j] : 0;
  __syncthreads();
  if (i >= p.lq) return;  // no block-wide barrier follows

  float m = -FLT_MAX;
  for (int j = lane; j < lk; j += kWarp) {
    const float* kr = ks + j * kstride;
    float acc = 0.f;
    for (int d = 0; d < dh; ++d) acc = fmaf(qrow[d], kr[d], acc);
    float s = acc * p.scale;
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
  for (int j = lane; j < lk; j += kWarp) srow[j] = srow[j] / sum;
  __syncwarp();  // srow written by every lane, read by every lane below

  T* og = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h + i * p.so.l;
  for (int d = lane; d < dh; d += kWarp) {
    float acc = 0.f;
    for (int j = 0; j < lk; ++j) acc = fmaf(srow[j], vs[j * dh + d], acc);
    store(og + d, acc);
  }
}

size_t general_smem_bytes(int lk, int dh) {
  return sizeof(float) * ((size_t)lk * (dh + 1) + (size_t)lk * dh +
                          (size_t)kGeneralWarps * (dh + lk)) +
         (size_t)lk;
}

// The 16-byte chunks of a row that the two small bodies are compiled for.
bool small_chunks(int chunks) {
  return chunks == 4 || chunks == 8 || chunks == 16;
}

// Whether `body` takes these shapes (the caller's choice, checked).
bool takes(int body, int lq, int lk, int dh, int item, int vec) {
  if (body == kGeneral) return true;
  if (!vec || dh * item % 16 != 0) return false;
  if (body == kKeyTiles) return dh <= kKtMaxDh;
  if (!small_chunks(dh * item / 16)) return false;
  return body == kFewQueries ? lq <= kFew && dh <= 2 * kWarp * kPairs
                             : body == kFewKeys && lk <= kFew;
}

template <typename K>
int launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
           const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// Calls fn(std::integral_constant<int, CHUNKS>()) for a row's 16-byte
// chunks (4, 8 or 16; `takes` checked them).
template <typename Fn>
int by_chunks(int chunks, Fn fn) {
  if (chunks == 4) return fn(std::integral_constant<int, 4>());
  if (chunks == 8) return fn(std::integral_constant<int, 8>());
  return fn(std::integral_constant<int, 16>());
}

template <typename T>
int run(int body, const Params& p, int batch, size_t smem, cudaStream_t s) {
  const int bh = batch * p.heads, chunks = p.dh * (int)sizeof(T) / 16;
  if (body == kFewQueries)
    return by_chunks(chunks, [&](auto c) {
      constexpr int C = decltype(c)::value;
      if (p.lq <= 4)
        return launch(fca_few_queries_kernel<T, 4, C>, dim3(bh), kBlock,
                      smem, s, p);
      return launch(fca_few_queries_kernel<T, kFew, C>, dim3(bh), kBlock,
                    smem, s, p);
    });
  if (body == kFewKeys)
    return by_chunks(chunks, [&](auto c) {
      return launch(fca_few_keys_kernel<T, decltype(c)::value>, dim3(bh),
                    fk_threads(p.lq), smem, s, p);
    });
  if (body == kKeyTiles) {
    const int qmax = kt_rows(p.lq);
    const dim3 grid(bh, (p.lq + qmax - 1) / qmax);
    if (qmax == 4)
      return launch(fca_key_tiles_kernel<T, 4>, grid, kBlock, smem, s, p);
    return launch(fca_key_tiles_kernel<T, kFew>, grid, kBlock, smem, s, p);
  }
  return launch(fca_general_kernel<T>,
                dim3(bh, (p.lq + kGeneralWarps - 1) / kGeneralWarps),
                kGeneralWarps * kWarp, smem, s, p);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `body` (0: every shape, 1: few
// queries, 2: few keys, 3: key tiles) needs at these shapes; dtype: 0 =
// float32, 1 = bfloat16.  The caller checks it against the card's
// per-block limit.
size_t fca_smem_bytes(int body, int lq, int lk, int dh, int dtype) {
  const int item = dtype == 1 ? 2 : 4;
  if (body == kFewQueries) return fq_layout(lq, lk, dh, item).total;
  if (body == kFewKeys) return fk_smem_bytes(lq, lk, dh, item);
  if (body == kKeyTiles) return kt_layout(kt_rows(lq), dh, item).total;
  return general_smem_bytes(lk, dh);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// strides: 12 element strides, (b, h, l) for q, k, v, out in that order.
// vec: 1 when every q/k/v row starts 16-byte aligned and Dh spans whole
// 16-byte words (the caller checks), so rows load 16 bytes at a time.
// body: 0 every shape, 1 few queries (Lq <= 16, vec, Dh <= 128), 2 few keys
// (Lk <= 16, vec, Dh·size/16 a power of 2 up to 32), 3 key tiles (vec, Dh
// <= 512); out's rows must be 16-byte aligned for 1 and 2.  Returns
// cudaGetLastError() after the launch (0 = success), or -2 for a body that
// does not take these shapes.
int fca_forward(const void* q, const void* k, const void* v,
                const unsigned char* mask, void* out, int dtype, int batch,
                int heads, int lq, int lk, int dh, const long long* strides,
                float scale, int vec, int body, void* stream) {
  Params p;
  p.vec = vec;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.out = out;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.dh = dh;
  p.scale = scale;
  if (!takes(body, lq, lk, dh, dtype == 1 ? 2 : 4, vec)) return -2;
  const size_t smem = fca_smem_bytes(body, lq, lk, dh, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run<__nv_bfloat16>(body, p, batch, smem, s);
  return run<float>(body, p, batch, smem, s);
}

}  // extern "C"
