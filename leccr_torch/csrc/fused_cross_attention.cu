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
// out at 3.35 TB/s.
//
// What the design does about it: every input byte is read from device
// memory once per block and every output byte written once; the scores and
// probabilities never leave the SM.  One block takes one (b, h) and a tile of
// query rows; it stages that head's K and V in shared memory as f32 (rows
// padded by one float so that the score loop, where lanes walk different
// keys at the same feature, is free of bank conflicts), and each warp owns
// one query row: lanes split the keys for the scores, warp shuffles give the
// row max and sum, lanes split the features for p.v.  All of a block's
// loads (K, V with 16-byte loads where aligned, the mask row, every warp's
// q row) are issued before its single barrier, so it waits on device memory
// once.
// Loads of q/k/v take the innermost stride 1 and any outer strides, so the
// caller passes head-split views without a transpose copy.  Tensor cores
// (wgmma) and TMA are left to a later change: at these arithmetic
// intensities the gain is in bytes moved and latency hidden, not flops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

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

// One 16-byte load of Vec<T>::n elements, widened to f32.
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

// Shared memory: K [Lk][Dh+1] f32, V [Lk][Dh] f32, per warp a q row [Dh]
// and a score row [Lk], then the mask row [Lk] as bytes.
template <typename T>
__global__ void fca_kernel(Params p) {
  extern __shared__ float smem[];
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

  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h +
                i * p.sq.l;
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

template <typename T>
int launch(const Params& p, int batch, int warps, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fca_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * p.heads, (p.lq + warps - 1) / warps);
  fca_kernel<T><<<grid, warps * kWarp, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the caller checks it
// against the card's per-block limit before launching.
size_t fca_smem_bytes(int lk, int dh, int warps) {
  return sizeof(float) * ((size_t)lk * (dh + 1) + (size_t)lk * dh +
                          (size_t)warps * (dh + lk)) +
         (size_t)lk;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// strides: 12 element strides, (b, h, l) for q, k, v, out in that order.
// vec: 1 when every q/k/v row starts 16-byte aligned and Dh spans whole
// 16-byte words (the caller checks), so rows load 16 bytes at a time.
// warps: query rows per block; all of the block's threads stage K and V.
// Returns cudaGetLastError() after the launch (0 = success).
int fca_forward(const void* q, const void* k, const void* v,
                const unsigned char* mask,
                void* out, int dtype, int batch, int heads, int lq, int lk,
                int dh, const long long* strides, float scale, int warps,
                int vec, void* stream) {
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
  const size_t smem = fca_smem_bytes(lk, dh, warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, batch, warps, smem, s);
  return launch<float>(p, batch, warps, smem, s);
}

}  // extern "C"
