// Tensor-core building blocks for Hopper (sm_90a) shared by the flash
// kernels: the single-block kernels 2/3 (flash_tower_attention.cu), the
// streamed bodies of kernels 4-8 (flash_tiles.cuh) and hopper.cuh.  mma.sync m16n8k16 on
// bf16 with f32 accumulators, the fragment conversions between its C and A
// operands, ldmatrix reads of row-major tiles staged in shared memory (rows
// of kRowPitch bf16, so the eight rows of one 8x8 matrix start in distinct
// 16-byte bank groups), and cp.async copies from device memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

// bf16 at Dh = 64: mma.sync m16n8k16, bf16 operands, f32 accumulators.
// Fragment layout (PTX ISA, mma.m16n8k16 .bf16), g = lane / 4, t = lane % 4:
// A (16x16) regs {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)};
// B (16x8) regs {(k 2t..2t+1, n g), (k 2t+8.., n g)}; C (16x8) floats
// {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.

constexpr int kTcDim = 64;              // the head dim of the tensor-core path
constexpr int kRowPitch = kTcDim + 8;   // bf16 per staged row-major row

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from device to shared memory, asynchronously; when !valid, 16
// zero bytes and nothing read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8 and receives, of matrix m, register m = (row l / 4,
// columns 2(l % 4), 2(l % 4) + 1); with .trans, (rows 2(l % 4) and
// 2(l % 4) + 1, column l / 4).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// acc[nt] += A . B over 16*KS features for NT 8-column n-tiles, where
// column n of B is row n of the staged tile `b` (row-major [n][Dh]): the
// products that contract over Dh (q kᵀ, g vᵀ, k qᵀ, v gᵀ).  Matrices 0-3 of
// one ldmatrix are (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
// (n 8-15, k 8-15): the two B registers of two n-tiles.
template <int NT, int KS>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4],
                                       const uint32_t (&a)[KS][4],
                                       const bf16* b) {
  const int lane = threadIdx.x % kWarp, m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int n2 = 0; n2 < NT / 2; ++n2)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t f[4];
      ldsm4(f, b + (16 * n2 + 8 * (m >> 1) + r) * kRowPitch + 16 * ks +
                   8 * (m & 1));
      mma(acc[2 * n2], a[ks], f[0], f[1]);
      mma(acc[2 * n2 + 1], a[ks], f[2], f[3]);
    }
}

// acc[nf] += A . B over 16*KS rows of the staged tile `b` (row-major
// [rows][Dh], k = its rows, n = Dh): the products that contract over the
// tile's rows (p v, ds k, dsᵀ q, pdᵀ g).  Matrices 0-3 of one transposed
// ldmatrix are (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
// (k 8-15, n 8-15).
template <int NF, int KS>
__device__ __forceinline__ void mma_nn(float (&acc)[NF][4],
                                       const uint32_t (&a)[KS][4],
                                       const bf16* b) {
  const int lane = threadIdx.x % kWarp, m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int n2 = 0; n2 < NF / 2; ++n2)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t f[4];
      ldsm4_t(f, b + (16 * ks + 8 * (m & 1) + r) * kRowPitch + 16 * n2 +
                     8 * (m >> 1));
      mma(acc[2 * n2], a[ks], f[0], f[1]);
      mma(acc[2 * n2 + 1], a[ks], f[2], f[3]);
    }
}

}  // namespace
