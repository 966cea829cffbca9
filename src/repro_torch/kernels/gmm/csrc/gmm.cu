// Grouped (per-expert) matrix product for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `gmm_ecd` in
// src/repro/kernels/gmm/kernel.py:33 (pallas_call at :42): for every
// expert e, out[e] = x[e] @ w[e] with x (E, C, d), w (E, d, f), out
// (E, C, f); the products of the inputs summed in f32, the result rounded
// once to x's dtype: float32 on the CUDA cores (no TF32), bfloat16 on the
// tensor cores.
//
// What bounds it on this card: in the MoE FFN of the LM serving path C
// is the expert capacity, 8 at decode and 15 at prefill (batch 4,
// prompt 32), while w is a whole layer's experts (64 x 2048 x 1408 bf16,
// 369 MB). Each weight element meets at most C rows, so the call is
// bound by reading w once from device memory: ~0.11 ms at 3.35 TB/s,
// against ~3 us of bf16 tensor-core math. A kernel that converts w to f32
// and runs C FMAs per element on the CUDA cores spends ~44 us on them at
// C = 8 and, fed by plain loads, reaches a third of the memory rate.
//
// bfloat16, on the tensor cores, w streamed through shared memory: per
// expert the kernel computes out^T = w^T x^T with mma.sync.m16n8k16
// (bf16 in, f32 accumulate): f is M, C is N in tiles of 8 (decode C = 8
// is one tile, prefill C = 15 two, masked), d is K. One block of 4 warps
// per (128-column f-tile, C-tile of 8, 16 or 32 rows, expert); a warp
// owns 32 columns of f. A ring of kStages shared-memory stages, each
// kBK rows of w (kBK x 128, rows padded to keep ldmatrix free of bank
// conflicts) and the matching kBK columns of x, is filled by cp.async
// (16 bytes a thread, bypassing L1) kStages - 1 stages ahead of the
// tensor cores, which read w with ldmatrix.trans (the A fragments of
// w^T from the (d, f) row-major tile) and x with ldmatrix. At decode
// every SM holds 3 blocks, ~150 KB of w in flight. Ragged C, d and f are
// zero-filled in the copies; where f or d is not a multiple of 8 or a
// pointer is not 16-byte aligned the same kernel stages the tiles with
// plain loads. Each output is one thread's sum over d in a fixed order
// (the tensor core's sum within each k16 step, then the steps in order):
// bitwise the same from call to call. No split-K, no atomics.
//
// float32 keeps the CUDA-core kernel below: every product and sum in f32
// (inputs exact, no TF32, as the port's f32 reference requires); a block
// of 2 warps per (128-column f-tile, C-tile, expert), a thread owns two
// adjacent columns of f and all BC rows of the C-tile (BC = 8, 16 or 32),
// the x tile staged in shared memory as f32, w read straight into
// registers 32 rows ahead. The dtype switch in gmm_ecd() below is the
// only dispatch between the two.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../shared/csrc/sm90.cuh"

namespace {

constexpr int kThreads = 64;          // 2 warps
constexpr int kCols = 2 * kThreads;   // columns of f per block
constexpr int kChunk = 128;           // d-chunk of x staged in shared memory
constexpr int kBatch = 32;            // rows of w loaded ahead of their FMAs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float zero_of(const float*) { return 0.f; }

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

// ---- bfloat16: tensor cores fed by a cp.async ring ----

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kBM = 128;          // columns of f per block (M)
constexpr int kBK = 64;           // rows of w per stage (K)
constexpr int kStages = 4;        // 3 stages (48 KB of w) in flight
constexpr int kMT = kBM / (kMmaThreads / 32) / 16;  // m16 tiles per warp
constexpr int kWS = kBM + 8;      // padded row of a stage's w tile
constexpr int kXS = kBK + 8;      // padded row of a stage's x tile

template <int NT>  // n8 tiles of C per block
__host__ __device__ constexpr int stage_elems() {
  return kBK * kWS + 8 * NT * kXS;
}
template <int NT>
__host__ __device__ constexpr int mma_smem_bytes() {
  return kStages * stage_elems<NT>() * 2;
}

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldmatrix_x2;
using sm90::ldmatrix_x4_trans;
using sm90::mma_bf16;

// grid (ceil(f / kBM), ceil(C / (8 NT)), E), kMmaThreads threads,
// mma_smem_bytes<NT>() of dynamic shared memory; x, w, out contiguous.
// kVec: f and d are multiples of 8 and x, w are 16-byte aligned, so the
// tiles are staged by 16-byte cp.async; else by plain loads.
template <int NT, bool kVec>
__global__ void __launch_bounds__(kMmaThreads) gmm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ out, int C, int d, int f) {
  extern __shared__ __align__(16) __nv_bfloat16 ring[];
  constexpr int BN = 8 * NT, SE = stage_elems<NT>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.x * kBM, c0 = blockIdx.y * BN, e = blockIdx.z;
  const __nv_bfloat16* we = w + int64_t(e) * d * f;
  const __nv_bfloat16* xe = x + int64_t(e) * C * d;
  const int ktiles = (d + kBK - 1) / kBK;

  // stage s: w rows [k0, k0 + kBK) x columns [f0, f0 + kBM) as
  // [kBK][kWS], then x rows [c0, c0 + BN) x columns [k0, k0 + kBK) as
  // [BN][kXS]; out-of-range elements are zero
  auto load = [&](int s, int kt) {
    __nv_bfloat16* sw = ring + s * SE;
    __nv_bfloat16* sx = sw + kBK * kWS;
    const int k0 = kt * kBK;
    if (kVec) {
#pragma unroll
      for (int i = 0; i < kBK * kBM / 8 / kMmaThreads; ++i) {
        const int c = tid + i * kMmaThreads;
        const int r = c / (kBM / 8), q = c % (kBM / 8) * 8;
        const bool ok = k0 + r < d && f0 + q < f;
        cp_async16(sw + r * kWS + q,
                   ok ? we + int64_t(k0 + r) * f + f0 + q : we, ok);
      }
      for (int c = tid; c < BN * kBK / 8; c += kMmaThreads) {
        const int r = c / (kBK / 8), q = c % (kBK / 8) * 8;
        const bool ok = c0 + r < C && k0 + q < d;
        cp_async16(sx + r * kXS + q,
                   ok ? xe + int64_t(c0 + r) * d + k0 + q : xe, ok);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int c = tid; c < kBK * kBM; c += kMmaThreads) {
        const int r = c / kBM, q = c % kBM;
        sw[r * kWS + q] = k0 + r < d && f0 + q < f
                              ? we[int64_t(k0 + r) * f + f0 + q]
                              : zero;
      }
      for (int c = tid; c < BN * kBK; c += kMmaThreads) {
        const int r = c / kBK, q = c % kBK;
        sx[r * kXS + q] = c0 + r < C && k0 + q < d
                              ? xe[int64_t(c0 + r) * d + k0 + q]
                              : zero;
      }
    }
  };

  float acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's)
    __syncthreads();               // ... every thread's; stage kt - 1 is free
    if (kt + kStages - 1 < ktiles)
      load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* sw = ring + kt % kStages * SE;
    const __nv_bfloat16* sx = sw + kBK * kWS;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A = w^T: lane l addresses row kk + (l & 7) + (l >> 4) * 8 of the
      // tile at column (l >> 3 & 1) * 8 of its warp's 16-column slice
      unsigned a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4_trans(a[mt], sw + (kk + (lane & 7) + (lane >> 4) * 8) * kWS
                                     + (warp * kMT + mt) * 16
                                     + (lane >> 3 & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        unsigned b[2];  // B = x^T: rows of x, k halves kk and kk + 8
        ldmatrix_x2(b, sx + (nt * 8 + (lane & 7)) * kXS + kk
                           + (lane >> 3 & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt][nt], a[mt], b);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator i of a lane: f row (lane >> 2) + 8 (i >> 1), C column
  // 2 (lane & 3) + (i & 1) of its 16 x 8 tile
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = f0 + (warp * kMT + mt) * 16 + (lane >> 2) + (i >> 1) * 8;
        const int n = c0 + nt * 8 + (lane & 3) * 2 + (i & 1);
        if (m < f && n < C)
          out[(int64_t(e) * C + n) * f + m] = __float2bfloat16(acc[mt][nt][i]);
      }
}

template <int NT, bool kVec>
cudaError_t launch_mma(const void* x, const void* w, void* out, int E, int C,
                       int d, int f, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<NT>();
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_bf16_kernel<NT, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((f + kBM - 1) / kBM, (C + 8 * NT - 1) / (8 * NT), E);
  gmm_bf16_kernel<NT, kVec><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      C, d, f);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_nt(const void* x, const void* w, void* out, int E, int C,
                      int d, int f, cudaStream_t stream) {
  const bool vec = f % 8 == 0 && d % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  return vec ? launch_mma<NT, true>(x, w, out, E, C, d, f, stream)
             : launch_mma<NT, false>(x, w, out, E, C, d, f, stream);
}

cudaError_t dispatch_bf16(const void* x, const void* w, void* out, int E,
                          int C, int d, int f, cudaStream_t stream) {
  if (C <= 8) return launch_nt<1>(x, w, out, E, C, d, f, stream);
  if (C <= 16) return launch_nt<2>(x, w, out, E, C, d, f, stream);
  return launch_nt<4>(x, w, out, E, C, d, f, stream);
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
  if (dtype == 1) return dispatch_bf16(x, w, out, E, C, d, f, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
