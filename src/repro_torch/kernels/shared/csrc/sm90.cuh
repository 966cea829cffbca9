// Warp-level tensor-core and asynchronous-copy helpers shared by the
// bf16 kernels (gmm/csrc/gmm.cu, flash_attention/csrc/flash_attention.cu):
// cp.async from device to shared memory, ldmatrix (plain and transposed)
// from shared memory into mma fragments, and mma.sync.m16n8k16 with bf16
// inputs and f32 sums; and read-only loads pinned where they are written
// (the f32 short-span flash kernel, advantages/csrc/advantages.cu).
// Header only; the build's digest covers it.
#pragma once
#include <cuda_bf16.h>

namespace sm90 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled (src unread) if !ok.
// kL2Prefetch: L2 fetches the 256-byte run around them (a row of a wide
// tile); else only the 16 bytes' sector.
template <bool kL2Prefetch = true>
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  if (kL2Prefetch)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// acc += a (16 x 16, row) * b (16 x 8, col): bf16 products, f32 sums.
// Fragments of lane l, g = l >> 2, t = l & 3: a {(g, 2t..2t+1),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)}; b {(k 2t..2t+1, n g),
// (k 2t + 8.., n g)}; acc {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1)}.
__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two f32 as one bf16x2 register, lo in the low half (round to nearest)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Read-only global loads that stay where they are written: nvcc may sink
// an __ldg (read-only, so free to move past stores) down to its first
// use, a round trip each; a volatile asm load is issued in program order,
// and issue_here() keeps the loads above it above it.
__device__ __forceinline__ float ld_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float4 ld_nc4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ void issue_here() {
  asm volatile("" ::: "memory");
}

}  // namespace sm90
