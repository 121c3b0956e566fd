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
// - wide heads (128 < Dh <= 512: the video model's interaction width 4096
//   at 8 heads gives Dh = 512, 1 KB a bf16 row), two bodies with 4-warp
//   blocks whose lanes span a row's features (16 a lane at Dh = 512), so a
//   score is a butterfly sum that every lane holds.  Per (b, h) at (Lq, Lk)
//   = (2, 200) K and V are 400 KB in bf16 against 4 KB of q and out, ~2
//   flops a byte: what counts is bytes in flight on every SM, in whole
//   waves (B = 64, H = 8: 512 heads on 132 SMs), with no barrier per key.
//   * key ranges (Lk > 2): a block owns one (b, h), one split of its keys
//     and 2 (Lq <= 2) or 4 query rows.  Its warps take consecutive ranges
//     of the split; each runs the online softmax of its rows in registers
//     (running max, sum and out) while its K and V rows stream through its
//     own cp.async ring (6 slots of 2 KB in bf16, 5 keys in flight, 4
//     blocks an SM).  The block then merges its warps in warp order.  Over
//     few keys (Lk <= 16) and more than 2 rows a warp takes 2 rows of its
//     own over every key instead, and stores them without a merge.
//     Where the heads alone would not fill the card, the wrapper splits the
//     keys over blocks (`wide_split_plan` in ops/fused_cross_attention.py)
//     and a second pass merges the splits' f32 (max, sum, out) in split
//     order; a call is one launch of the kernel whatever its passes.
//   * query rows (Lk <= 2: the frames attending the video model's 2
//     slots): a block reads the head's K and V once, widened into every
//     warp's registers; a warp takes 8 query rows (their loads in flight
//     while it computes) and one at a time: scores by butterfly sums, the
//     softmax in registers, out stored 16 bytes a lane.
//   A padded key's score is f32 min through every merge: a range of padded
//   keys weighs exp(f32 min - max) = 0 beside a real key and 1 where every
//   key is padded, so a fully padded row still ends as the mean of v.
// - every other shape (and unaligned views, or head dims the other bodies
//   do not take): one block per (b, h) and 8 query rows, K and V staged as
//   f32 (rows padded by one float), a warp a query row with lanes over keys
//   for the scores and over features for p·v.  Its shared memory grows
//   with Lk·Dh: at Dh = 512 it holds at most 52 keys.
// Loads of q/k/v take the innermost stride 1 and any outer strides, so the
// caller passes head-split views without a transpose copy.  Every body sums
// in a fixed order (no atomics): two calls give the same bits.

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

// The wide bodies (128 < Dh <= 512).
constexpr int kWideWarps = 4;  // warps of a wide block
constexpr int kWideThreads = kWideWarps * kWarp;
constexpr int kWideMaxDh = 512;  // 16 features a lane
constexpr int kWideRingBytes = 12 * 1024;  // a key-ranges warp's ring
constexpr int kWideWarpRows = 8;  // q rows a warp of the query-rows body
constexpr int kWideRowKeys = 2;  // its most keys: K and V fit in registers
constexpr int kWideBlockRows = kWideWarps * kWideWarpRows;

// Bodies, as the caller names them.
constexpr int kGeneral = 0, kFewQueries = 1, kFewKeys = 2,
              kWideKeyRanges = 3, kWideQueryRows = 4;

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
  int bh, heads, lq, lk, dh;  // bh: batch x heads
  float scale;
  // the key-ranges body: keys cut into `splits` ranges of `split_keys`
  // (the last one shorter), and with more than one split the f32 partials
  // [splits][B·H·Lq][Dh] then (max, sum) [splits][B·H·Lq][2]
  int splits, split_keys;
  float* work;
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

// ---------------------------------------- wide heads (128 < Dh <= 512)
// Both wide bodies run blocks of kWideWarps warps whose lanes span a row's
// 16-byte chunks (chunk lane + 32 u: Dh / 32 features a lane, 16 at Dh =
// 512 in either dtype), so a score is a butterfly sum over the warp that
// leaves the same bits in every lane.
template <typename T>
struct Wide {
  static constexpr int n = Vec<T>::n;                   // elements a chunk
  static constexpr int u = kWideMaxDh / n / kWarp;      // chunks a lane
  // slots of a warp's ring: K and V rows at Dh = 512, 6 in bf16, 3 in f32
  static constexpr int ring = kWideRingBytes / (2 * kWideMaxDh * sizeof(T));
};

// Rows a warp of the key-ranges body owns: 2 for Lq <= 2 (the slots),
// else 4 (blockIdx.z walks the groups of rows).
__host__ __device__ inline int wide_rows(int lq) { return lq <= 2 ? 2 : 4; }

// Whether the key-ranges body's warps own rows rather than key ranges: over
// few keys (Lk <= kFew, at most 4 a warp's range) a block of 4-row groups
// would be all start-up; a warp then takes 2 rows of its own over every
// key (R = 2: 4 blocks an SM), and a block 4 such pairs (one split).
__host__ __device__ inline bool wide_warp_rows(int lq, int lk) {
  return lk <= kFew && lq > 2;
}

// Key ranges.  Shared memory: per warp a ring of key slots, each K [Dh] T
// then V [Dh] T; once the keys are done, the same bytes hold the warps'
// partial outputs [warps][rows][Dh] f32 and their (max, sum) [warps][rows][2].
__host__ __device__ inline size_t wkr_smem_bytes(int lq, int dh, int item) {
  const size_t slots = kWideRingBytes / (2 * kWideMaxDh * item);
  const size_t ring = (size_t)kWideWarps * slots * 2 * dh * item;
  const size_t merge = (size_t)kWideWarps * wide_rows(lq) * (dh + 2) * 4;
  return ring > merge ? ring : merge;
}

// Block (b·H + h, split, group of R rows).  The split's keys are cut into
// kWideWarps consecutive ranges, one a warp; a warp walks its range with
// the online softmax in registers (running max, sum and out of its R rows),
// its K and V rows streaming through its own cp.async ring (no barrier in
// the walk: a lane reads back only the chunks it copied).  Then the block
// merges its warps in warp order and stores out (one split) or the split's
// f32 (max, sum, out) in p.work for fca_wide_merge_kernel.  Where
// `wide_warp_rows` holds (launched with R = 2), block (b·H + h, 0, group of
// 4R rows) instead: a warp walks every key for its own R rows and stores
// them, no merge.
template <typename T, int R>
__global__ void __launch_bounds__(kWideThreads, R == 2 ? 4 : 2)
    fca_wide_key_ranges_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int n = Wide<T>::n, U = Wide<T>::u, S = Wide<T>::ring;
  const int dh = p.dh, chunks = dh / n;
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const bool own_rows = wide_warp_rows(p.lq, p.lk);
  const int split = blockIdx.y;
  const int r0 = (own_rows ? blockIdx.z * kWideWarps + warp : blockIdx.z) * R;
  const int rows = min(R, p.lq - r0);
  if (rows <= 0) return;  // a warp past Lq owns no rows: no barrier follows
  const int s_lo = split * p.split_keys;
  const int s_hi = min(p.lk, s_lo + p.split_keys);
  const int per = own_rows ? s_hi - s_lo
                           : (s_hi - s_lo + kWideWarps - 1) / kWideWarps;
  const int lo = own_rows ? s_lo : min(s_hi, s_lo + warp * per);
  const int hi = min(s_hi, lo + per);

  const T* kg = head<T>(p.k, p.sk, b, h);
  const T* vg = head<T>(p.v, p.sv, b, h);
  T* ring = reinterpret_cast<T*>(smem_bytes) + (size_t)warp * S * 2 * dh;
  // key j's K and V rows into slot (j - lo) % S as one copy group (an empty
  // group past the range, so that a wait always counts the same groups)
  auto fetch = [&](int j) {
    if (j < hi) {
      T* slot = ring + (size_t)((j - lo) % S) * 2 * dh;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = (lane + kWarp * u) * n;
        if (c < dh) {
          cp_async16(slot + c, kg + j * p.sk.l + c);
          cp_async16(slot + dh + c, vg + j * p.sv.l + c);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t + 1 < S; ++t) fetch(lo + t);

  // this warp's q rows widened to f32; the running max, sum and out
  const T* qg = head<T>(p.q, p.sq, b, h) + (long long)r0 * p.sq.l;
  float q[R][U][n], acc[R][U][n], m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (lane + kWarp * u) * n;
#pragma unroll
      for (int e = 0; e < n; ++e) q[i][u][e] = acc[i][u][e] = 0.f;
      if (i < rows && c < dh) load16(qg + i * p.sq.l + c, q[i][u]);
    }
  }

  // the keys' padding bytes, a lane each, fetched 32 keys ahead
  const unsigned char* mask = p.mask ? p.mask + (long long)b * p.lk : nullptr;
  unsigned char pad_next = mask && lo + lane < hi ? mask[lo + lane] : 0;
  unsigned pad_bits = 0;
#pragma unroll 1
  for (int j = lo; j < hi; ++j) {
    const int t = j - lo;
    if (t % kWarp == 0) {
      pad_bits = __ballot_sync(0xffffffffu, pad_next != 0);
      pad_next = mask && j + kWarp + lane < hi ? mask[j + kWarp + lane] : 0;
    }
    // refill the slot that the previous key was read from: in-order
    // dispatch has sent out every instruction of that iteration, the
    // reads' users among them, so the reads are done before this copy
    // can land
    fetch(j + S - 1);
    cp_async_wait<S - 1>();  // key j's group (this lane's copies) landed
    const T* slot = ring + (size_t)(t % S) * 2 * dh;
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (lane + kWarp * u) * n;
      if (c < dh) {
        float kf[n];
        load16(slot + c, kf);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < n; ++e) s[i] = fmaf(q[i][u][e], kf[e], s[i]);
      }
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)  // R butterflies side by side
#pragma unroll
      for (int i = 0; i < R; ++i)
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
    float vf[U][n];  // V read after the scores: K's registers are free
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (lane + kWarp * u) * n;
#pragma unroll
      for (int e = 0; e < n; ++e) vf[u][e] = 0.f;
      if (c < dh) load16(slot + dh + c, vf[u]);
    }
    const bool padded = (pad_bits >> (t % kWarp)) & 1u;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i >= rows) break;
      const float si = padded ? -FLT_MAX : s[i] * p.scale;
      if (si > m[i]) {  // the same in every lane: the branch is uniform
        const float rescale = expf(m[i] - si);  // 0 after padded keys
        l[i] *= rescale;
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int e = 0; e < n; ++e) acc[i][u][e] *= rescale;
        m[i] = si;
      }
      const float w = expf(si - m[i]);  // 1 for a padded key while all are
      l[i] += w;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < n; ++e)
          acc[i][u][e] = fmaf(w, vf[u][e], acc[i][u][e]);
    }
  }
  cp_async_wait<0>();
  if (own_rows) {  // the warp's rows saw every key: out = acc / sum
    T* og = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h +
            (long long)r0 * p.so.l;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i >= rows) break;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = (lane + kWarp * u) * n;
        if (c >= dh) continue;
        float o[n];
#pragma unroll
        for (int e = 0; e < n; ++e) o[e] = acc[i][u][e] / l[i];
        *reinterpret_cast<uint4*>(og + i * p.so.l + c) = pack16<T>(o);
      }
    }
    return;
  }
  __syncthreads();  // every ring is idle: its bytes now hold the partials

  float* part = reinterpret_cast<float*>(smem_bytes);  // [warps][R][Dh]
  float* stat = part + (size_t)kWideWarps * R * dh;    // [warps][R][2]
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i >= rows) break;
    float* dst = part + (size_t)(warp * R + i) * dh;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (lane + kWarp * u) * n;
      if (c < dh)
#pragma unroll
        for (int e = 0; e < n; e += 4)
          *reinterpret_cast<float4*>(dst + c + e) = make_float4(
              acc[i][u][e], acc[i][u][e + 1], acc[i][u][e + 2],
              acc[i][u][e + 3]);
    }
    if (lane == 0) {
      stat[(warp * R + i) * 2] = m[i];
      stat[(warp * R + i) * 2 + 1] = l[i];
    }
  }
  __syncthreads();

  // the warps merged in warp order, a thread a 16-byte chunk of a row: a
  // range whose keys are all padded (max f32 min) weighs exp(f32 min - max)
  // = 0 beside a real key, 1 when every key is padded (then out is the
  // mean of v); an empty range adds 0 to the sum and to out
  const int rows_total = p.bh * p.lq;
  for (int e = tid; e < rows * chunks; e += kWideThreads) {
    const int i = e / chunks, c = (e % chunks) * n;
    float mx = -FLT_MAX;
#pragma unroll
    for (int w = 0; w < kWideWarps; ++w)
      mx = fmaxf(mx, stat[(w * R + i) * 2]);
    float sum = 0.f, o[n];
#pragma unroll
    for (int x = 0; x < n; ++x) o[x] = 0.f;
#pragma unroll
    for (int w = 0; w < kWideWarps; ++w) {
      const float f = expf(stat[(w * R + i) * 2] - mx);
      sum = fmaf(stat[(w * R + i) * 2 + 1], f, sum);
      const float* src = part + (size_t)(w * R + i) * dh + c;
#pragma unroll
      for (int x = 0; x < n; ++x) o[x] = fmaf(f, src[x], o[x]);
    }
    if (p.splits == 1) {
#pragma unroll
      for (int x = 0; x < n; ++x) o[x] = o[x] / sum;
      T* og = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h +
              (r0 + i) * p.so.l + c;
      *reinterpret_cast<uint4*>(og) = pack16<T>(o);
    } else {
      const size_t row =
          (size_t)split * rows_total + (size_t)bh * p.lq + r0 + i;
      float* dst = p.work + row * dh + c;
#pragma unroll
      for (int x = 0; x < n; x += 4)
        *reinterpret_cast<float4*>(dst + x) =
            make_float4(o[x], o[x + 1], o[x + 2], o[x + 3]);
      if (c == 0) {
        float* st = p.work + (size_t)p.splits * rows_total * dh + row * 2;
        st[0] = mx;
        st[1] = sum;
      }
    }
  }
}

// The key-ranges body's second pass when it ran more than one split: a
// thread a 16-byte chunk of an out row, the splits' (max, sum, out) from
// p.work merged in split order by the same rule as the warps.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    fca_wide_merge_kernel(Params p) {
  constexpr int n = Vec<T>::n;
  const int dh = p.dh, chunks = dh / n;
  const int rows_total = p.bh * p.lq;
  const long long e = (long long)blockIdx.x * kWideThreads + threadIdx.x;
  if (e >= (long long)rows_total * chunks) return;
  const int row = (int)(e / chunks), c = (int)(e % chunks) * n;
  const float* stat = p.work + (size_t)p.splits * rows_total * dh;
  float mx = -FLT_MAX;
  for (int sp = 0; sp < p.splits; ++sp)
    mx = fmaxf(mx, stat[((size_t)sp * rows_total + row) * 2]);
  float sum = 0.f, o[n];
#pragma unroll
  for (int x = 0; x < n; ++x) o[x] = 0.f;
  for (int sp = 0; sp < p.splits; ++sp) {
    const size_t r = (size_t)sp * rows_total + row;
    const float f = expf(stat[r * 2] - mx);
    sum = fmaf(stat[r * 2 + 1], f, sum);
    const float4* src = reinterpret_cast<const float4*>(p.work + r * dh + c);
#pragma unroll
    for (int x = 0; x < n / 4; ++x) {
      const float4 v4 = src[x];
      o[4 * x] = fmaf(f, v4.x, o[4 * x]);
      o[4 * x + 1] = fmaf(f, v4.y, o[4 * x + 1]);
      o[4 * x + 2] = fmaf(f, v4.z, o[4 * x + 2]);
      o[4 * x + 3] = fmaf(f, v4.w, o[4 * x + 3]);
    }
  }
#pragma unroll
  for (int x = 0; x < n; ++x) o[x] = o[x] / sum;
  const int bh = row / p.lq, i = row % p.lq;
  T* og = static_cast<T*>(p.out) + (bh / p.heads) * p.so.b +
          (bh % p.heads) * p.so.h + (long long)i * p.so.l + c;
  *reinterpret_cast<uint4*>(og) = pack16<T>(o);
}

// Query rows (Lk <= kWideRowKeys).  Shared memory: K [Lk][Dh] T, V [Lk][Dh]
// T, then per warp its kWideWarpRows q rows [Dh] T.
__host__ __device__ inline size_t wqr_smem_bytes(int lk, int dh, int item) {
  return (2 * (size_t)lk + kWideBlockRows) * dh * item;
}

// Block (b·H + h, group of kWideBlockRows rows): the head's K and V are
// read once (cp.async, one barrier) and widened into every warp's
// registers, a warp's q rows land in two copy groups (its second half
// still in flight while it computes the first), and a warp takes a row at
// a time: its scores by butterfly sums (every lane holds each), the
// softmax in registers, out stored 16 bytes a lane.
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 4)
    fca_wide_query_rows_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int n = Wide<T>::n, U = Wide<T>::u, K = kWideRowKeys;
  constexpr int half = (kWideWarpRows + 1) / 2;
  const int dh = p.dh, lk = p.lk, chunks = dh / n;
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int r0 = blockIdx.y * kWideBlockRows + warp * kWideWarpRows;
  const int rows = max(0, min(kWideWarpRows, p.lq - r0));
  T* ks = reinterpret_cast<T*>(smem_bytes);
  T* vs = ks + (size_t)lk * dh;
  T* qs = vs + (size_t)lk * dh + (size_t)warp * kWideWarpRows * dh;

  const T* kg = head<T>(p.k, p.sk, b, h);
  const T* vg = head<T>(p.v, p.sv, b, h);
  const T* qg = head<T>(p.q, p.sq, b, h) + (long long)r0 * p.sq.l;
  for (int e = tid; e < lk * chunks; e += kWideThreads) {
    const int j = e / chunks, c = (e % chunks) * n;
    cp_async16(ks + j * dh + c, kg + j * p.sk.l + c);
    cp_async16(vs + j * dh + c, vg + j * p.sv.l + c);
  }
  cp_async_commit();
#pragma unroll
  for (int g = 0; g < 2; ++g) {  // a lane copies (and later reads) its chunks
#pragma unroll
    for (int i = g * half; i < kWideWarpRows && i < (g + 1) * half; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = (lane + kWarp * u) * n;
        if (i < rows && c < dh)
          cp_async16(qs + i * dh + c, qg + i * p.sq.l + c);
      }
    cp_async_commit();
  }
  const bool pad_lane =
      p.mask && lane < lk && p.mask[(long long)b * lk + lane] != 0;
  const unsigned pad_bits = __ballot_sync(0xffffffffu, pad_lane);
  cp_async_wait<2>();
  __syncthreads();  // K and V of the head, every thread's copies

  float kr[K][U][n], vr[K][U][n];  // this lane's features of K and V
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (lane + kWarp * u) * n;
#pragma unroll
      for (int e = 0; e < n; ++e) kr[j][u][e] = vr[j][u][e] = 0.f;
      if (j < lk && c < dh) {
        load16(ks + j * dh + c, kr[j][u]);
        load16(vs + j * dh + c, vr[j][u]);
      }
    }

  T* og = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h +
          (long long)r0 * p.so.l;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    if (g == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    for (int i = g * half; i < (g + 1) * half && i < rows; ++i) {
      float qf[U][n], s[K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = (lane + kWarp * u) * n;
#pragma unroll
        for (int e = 0; e < n; ++e) qf[u][e] = 0.f;
        if (c < dh) load16(qs + i * dh + c, qf[u]);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {  // 0 past Lk (K and V are 0 there)
        s[j] = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int e = 0; e < n; ++e) s[j] = fmaf(qf[u][e], kr[j][u][e], s[j]);
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1)  // K butterflies side by side
#pragma unroll
        for (int j = 0; j < K; ++j)
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      float mx = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (j < lk) {
          s[j] = (pad_bits >> j) & 1u ? -FLT_MAX : s[j] * p.scale;
          mx = fmaxf(mx, s[j]);
        }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        s[j] = j < lk ? expf(s[j] - mx) : 0.f;
        sum += s[j];
      }
      const float inv = 1.f / sum;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = (lane + kWarp * u) * n;
        if (c >= dh) continue;
        float o[n];
#pragma unroll
        for (int e = 0; e < n; ++e) {
          o[e] = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j)
            o[e] = fmaf(s[j] * inv, vr[j][u][e], o[e]);
        }
        *reinterpret_cast<uint4*>(og + i * p.so.l + c) = pack16<T>(o);
      }
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
  if (body == kWideKeyRanges) return dh <= kWideMaxDh;
  if (body == kWideQueryRows) return dh <= kWideMaxDh && lk <= kWideRowKeys;
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
int run(int body, const Params& p, size_t smem, cudaStream_t s) {
  const int bh = p.bh, chunks = p.dh * (int)sizeof(T) / 16;
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
  if (body == kWideKeyRanges) {
    const bool own_rows = wide_warp_rows(p.lq, p.lk);
    const int r = own_rows ? 2 : wide_rows(p.lq);
    const int rows = own_rows ? r * kWideWarps : r;  // a block's
    const dim3 grid(bh, p.splits, (p.lq + rows - 1) / rows);
    const int rc =
        r == 2 ? launch(fca_wide_key_ranges_kernel<T, 2>, grid, kWideThreads,
                        smem, s, p)
               : launch(fca_wide_key_ranges_kernel<T, 4>, grid, kWideThreads,
                        smem, s, p);
    if (rc != 0 || p.splits == 1) return rc;
    const long long items = (long long)bh * p.lq * (p.dh / Vec<T>::n);
    return launch(fca_wide_merge_kernel<T>,
                  dim3((unsigned)((items + kWideThreads - 1) / kWideThreads)),
                  kWideThreads, 0, s, p);
  }
  if (body == kWideQueryRows)
    return launch(fca_wide_query_rows_kernel<T>,
                  dim3(bh, (p.lq + kWideBlockRows - 1) / kWideBlockRows),
                  kWideThreads, smem, s, p);
  return launch(fca_general_kernel<T>,
                dim3(bh, (p.lq + kGeneralWarps - 1) / kGeneralWarps),
                kGeneralWarps * kWarp, smem, s, p);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `body` (0: every shape, 1: few
// queries, 2: few keys, 3: wide key ranges, 4: wide query rows) needs at
// these shapes; dtype: 0 = float32, 1 = bfloat16.  The caller checks it
// against the card's per-block limit.
size_t fca_smem_bytes(int body, int lq, int lk, int dh, int dtype) {
  const int item = dtype == 1 ? 2 : 4;
  if (body == kFewQueries) return fq_layout(lq, lk, dh, item).total;
  if (body == kFewKeys) return fk_smem_bytes(lq, lk, dh, item);
  if (body == kWideKeyRanges) return wkr_smem_bytes(lq, dh, item);
  if (body == kWideQueryRows) return wqr_smem_bytes(lk, dh, item);
  return general_smem_bytes(lk, dh);
}

// Blocks of the wide key-ranges body one SM holds at once for these shapes
// (the CUDA occupancy calculator: registers, threads, shared memory), or a
// negative CUDA error.  The caller plans the body's key splits with it.
int fca_wide_blocks_per_sm(int lq, int dh, int dtype) {
  const size_t smem = fca_smem_bytes(kWideKeyRanges, lq, 1, dh, dtype);
  int blocks = 0;
  cudaError_t err;
  auto occupancy = [&](auto kernel) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          kWideThreads, smem);
  };
  const bool two = wide_rows(lq) == 2;
  if (dtype == 1)
    two ? occupancy(fca_wide_key_ranges_kernel<__nv_bfloat16, 2>)
        : occupancy(fca_wide_key_ranges_kernel<__nv_bfloat16, 4>);
  else
    two ? occupancy(fca_wide_key_ranges_kernel<float, 2>)
        : occupancy(fca_wide_key_ranges_kernel<float, 4>);
  return err == cudaSuccess ? blocks : -(int)err;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// strides: 12 element strides, (b, h, l) for q, k, v, out in that order.
// vec: 1 when every q/k/v row starts 16-byte aligned and Dh spans whole
// 16-byte words (the caller checks), so rows load 16 bytes at a time.
// body: 0 every shape, 1 few queries (Lq <= 16, vec, Dh <= 128), 2 few keys
// (Lk <= 16, vec, Dh·size/16 a power of 2 up to 32), 3 wide key ranges
// (vec, Dh <= 512), 4 wide query rows (vec, Dh <= 512, Lk <= 2); out's
// rows must be 16-byte aligned for 1-4.  splits, split_keys: body 3's key
// splits (every key in one split, none empty; 1 and Lk for the others);
// work: body 3's f32 workspace of splits x B·H·Lq x (Dh + 2) when splits >
// 1, else null.  Returns cudaGetLastError() after the launches (0 =
// success), or -2 for a body or split that does not take these shapes.
int fca_forward(const void* q, const void* k, const void* v,
                const unsigned char* mask, void* out, int dtype, int batch,
                int heads, int lq, int lk, int dh, const long long* strides,
                float scale, int vec, int body, int splits, int split_keys,
                float* work, void* stream) {
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
  p.bh = batch * heads;
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.dh = dh;
  p.scale = scale;
  p.splits = splits;
  p.split_keys = split_keys;
  p.work = work;
  if (!takes(body, lq, lk, dh, dtype == 1 ? 2 : 4, vec)) return -2;
  const bool covered = splits >= 1 && split_keys >= 1 &&
                       (long long)(splits - 1) * split_keys < lk &&
                       (long long)splits * split_keys >= lk;
  if (body == kWideKeyRanges
          ? !covered || (splits > 1 && (!work || wide_warp_rows(lq, lk)))
          : splits != 1)
    return -2;
  const size_t smem = fca_smem_bytes(body, lq, lk, dh, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run<__nv_bfloat16>(body, p, smem, s);
  return run<float>(body, p, smem, s);
}

}  // extern "C"
