// Grouped (per-expert) matrix product for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `gmm_ecd` in
// src/repro/kernels/gmm/kernel.py:33 (pallas_call at :42): for every
// expert e, out[e] = x[e] @ w[e] with x (E, C, d), w (E, d, f), out
// (E, C, f); every product and sum in f32 (inputs converted exactly, no
// TF32), the result rounded once to x's dtype (float32 or bfloat16).
//
// What bounds it on this card: in the MoE FFN of the LM serving path C
// is the expert capacity, 8 at decode and 15 at prefill (batch 4,
// prompt 32), while w is a whole layer's experts (64 x 2048 x 1408 bf16,
// 369 MB). Each weight element meets at most C rows, so the call is
// bound by reading w once from device memory: ~0.11 ms at 3.35 TB/s,
// against ~3 us of bf16 tensor-core math or ~44 us of f32 FMAs on the
// CUDA cores at C = 8.
//
// Design: read every weight element exactly once per C-tile, straight
// from device memory into registers, and keep all C rows of the tile in
// registers beside it. One block of 2 warps per (128-column f-tile,
// C-tile, expert); a thread owns two adjacent columns of f (one 4-byte
// bf16 pair or one 8-byte f32 pair per row of w, so a warp reads 128 or
// 256 contiguous bytes of a w row) and all BC rows of the C-tile, with
// BC = 8, 16 or 32, the smallest that covers C (larger C takes more
// C-tiles of 32). The x tile (BC rows x 128 of d) is staged in shared
// memory as f32 and read as float4 broadcasts; a thread issues the loads
// of 32 rows of w before it uses them.
// Ragged C, d and f are masked in the kernel: no pad copy. The d sum
// runs in order, in one thread per output: the result is the same
// bitwise from call to call.
// Tensor cores (mma.sync/wgmma), TMA and a persistent grid are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;          // 2 warps
constexpr int kCols = 2 * kThreads;   // columns of f per block
constexpr int kChunk = 128;           // d-chunk of x staged in shared memory
constexpr int kBatch = 32;            // rows of w loaded ahead of their FMAs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float zero_of(const float*) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(const __nv_bfloat16*) {
  return __float2bfloat16(0.f);
}

// A thread's two adjacent elements of a w row as loaded.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 f32(float2 v) { return v; }
  static __device__ __forceinline__ float2 zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ float2 make(float a, float b) {
    return make_float2(a, b);
  }
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 f32(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ __nv_bfloat162 zero() {
    return __floats2bfloat162_rn(0.f, 0.f);
  }
  static __device__ __forceinline__ __nv_bfloat162 make(__nv_bfloat16 a,
                                                        __nv_bfloat16 b) {
    __nv_bfloat162 r;
    r.x = a;
    r.y = b;
    return r;
  }
};

// two adjacent elements; `pair` = both in range and 2-aligned
template <typename T>
__device__ __forceinline__ typename Pair<T>::type load2(const T* p, bool in0,
                                                        bool in1, bool pair) {
  using P = Pair<T>;
  if (pair) return *reinterpret_cast<const typename P::type*>(p);
  const T z = zero_of(p);
  return P::make(in0 ? p[0] : z, in1 ? p[1] : z);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b, bool in1,
                                       bool pair);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b,
                                              bool in1, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
    return;
  }
  p[0] = a;
  if (in1) p[1] = b;
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(
    __nv_bfloat16* p, float a, float b, bool in1, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    return;
  }
  p[0] = __float2bfloat16(a);
  if (in1) p[1] = __float2bfloat16(b);
}

// grid (ceil(f / kCols), ceil(C / BC), E); x, w, out contiguous.
// kPair: f is even and w, out are aligned to two elements, so a thread's
// two columns load and store as one vector (both in or both out).
template <typename T, int BC, bool kPair>
__global__ void __launch_bounds__(kThreads) gmm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int C, int d, int f) {
  using P = Pair<T>;
  __shared__ __align__(16) float sx[BC][kChunk];
  const int tid = threadIdx.x;
  const int col = blockIdx.x * kCols + 2 * tid;
  const int c0 = blockIdx.y * BC;
  const int e = blockIdx.z;
  const bool in0 = col < f, in1 = col + 1 < f;
  const T* xe = x + (int64_t(e) * C + c0) * d;
  const T* we = w + int64_t(e) * d * f + col;
  const int rows = min(BC, C - c0);

  float acc[BC][2];
#pragma unroll
  for (int r = 0; r < BC; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kChunk) {
    __syncthreads();  // the previous chunk of x is consumed
    for (int i = tid; i < BC * kChunk; i += kThreads) {
      const int r = i / kChunk, k = i - r * kChunk;
      sx[r][k] = (r < rows && d0 + k < d) ? to_f32(xe[int64_t(r) * d + d0 + k])
                                          : 0.f;
    }
    __syncthreads();
    const int kend = min(kChunk, d - d0);
    for (int k0 = 0; k0 < kend; k0 += kBatch) {
      typename P::type wv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool krow = d0 + k0 + j < d;
        wv[j] = (krow && in0)
                    ? load2<T>(we + int64_t(d0 + k0 + j) * f, in0, in1, kPair)
                    : P::zero();
      }
#pragma unroll
      for (int j = 0; j < kBatch; j += 4) {
        const float2 w0 = P::f32(wv[j]), w1 = P::f32(wv[j + 1]),
                     w2 = P::f32(wv[j + 2]), w3 = P::f32(wv[j + 3]);
#pragma unroll
        for (int r = 0; r < BC; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(&sx[r][k0 + j]);
          acc[r][0] = fmaf(xv.x, w0.x, acc[r][0]);
          acc[r][1] = fmaf(xv.x, w0.y, acc[r][1]);
          acc[r][0] = fmaf(xv.y, w1.x, acc[r][0]);
          acc[r][1] = fmaf(xv.y, w1.y, acc[r][1]);
          acc[r][0] = fmaf(xv.z, w2.x, acc[r][0]);
          acc[r][1] = fmaf(xv.z, w2.y, acc[r][1]);
          acc[r][0] = fmaf(xv.w, w3.x, acc[r][0]);
          acc[r][1] = fmaf(xv.w, w3.y, acc[r][1]);
        }
      }
    }
  }

  if (!in0) return;
  T* oe = out + (int64_t(e) * C + c0) * f + col;
#pragma unroll
  for (int r = 0; r < BC; ++r)
    if (r < rows) store2<T>(oe + int64_t(r) * f, acc[r][0], acc[r][1], in1, kPair);
}

template <typename T, int BC>
cudaError_t launch_bc(const void* x, const void* w, void* out, int E, int C,
                      int d, int f, cudaStream_t stream) {
  const dim3 grid((f + kCols - 1) / kCols, (C + BC - 1) / BC, E);
  const uintptr_t align = 2 * sizeof(T);
  const bool pair = f % 2 == 0 && reinterpret_cast<uintptr_t>(w) % align == 0
                    && reinterpret_cast<uintptr_t>(out) % align == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (pair)
    gmm_kernel<T, BC, true><<<grid, kThreads, 0, stream>>>(xt, wt, ot, C, d, f);
  else
    gmm_kernel<T, BC, false><<<grid, kThreads, 0, stream>>>(xt, wt, ot, C, d, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bc(const void* x, const void* w, void* out, int E, int C,
                        int d, int f, cudaStream_t stream) {
  if (C <= 8) return launch_bc<T, 8>(x, w, out, E, C, d, f, stream);
  if (C <= 16) return launch_bc<T, 16>(x, w, out, E, C, d, f, stream);
  return launch_bc<T, 32>(x, w, out, E, C, d, f, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike); x (E, C, d),
// w (E, d, f), out (E, C, f), all contiguous. Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a dtype or shape it does not take).
int gmm_ecd(const void* x, const void* w, void* out, int dtype, int E, int C,
            int d, int f, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || (C + 7) / 8 > 65535 || d < 0 || f <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_bc<float>(x, w, out, E, C, d, f, s);
  if (dtype == 1) return dispatch_bc<__nv_bfloat16>(x, w, out, E, C, d, f, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
