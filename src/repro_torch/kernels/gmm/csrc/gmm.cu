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
// float32, on the CUDA cores (every product and sum in f32, inputs exact:
// no TF32, as the port's f32 reference requires), w streamed through a
// ring of shared-memory stages like the bf16 kernel's. A block owns one
// expert's 128-column f-tile for all its C rows while C <= 64 (C-tiles of
// 64 past that), so each weight byte is read from device memory once: at
// decode (C = 8) and at prefill (C = 15) the call is bound by that read,
// at C = 60 (a 128-token prompt) by the FMAs (2 C d f per expert, 67
// TFLOP/s). Stages of BK rows of w (BK x 128) and the matching BK columns
// of x are filled by 16-byte cp.async STAGES - 1 stages ahead of the
// FMAs; each thread keeps a register tile of TM rows of C by TN columns of
// f, reads w from shared memory as float4 and x as float4 along d (a
// warp's rows adjacent, so its x reads are broadcasts), and runs TM x TN
// FMAs per k. Ragged C, d and f are zero-filled in the copies; where f or
// d is not a multiple of 4 or a pointer is not 16-byte aligned the same
// kernel copies single floats (the same sums in the same order). Each
// output is one thread's sum over d in order: bitwise the same from call
// to call. No split-K, no atomics. The dtype switch in gmm_ecd() below is
// the only dispatch between the two.
//
// Rows that hold no input, both dtypes: an MoE layer packs each expert's
// routed tokens into the first rows of its C capacity rows and zeros the
// rest, so a caller may pass each expert's count of rows that hold input
// (`nrows`, E int64 on the card, each clamped to [0, C]; null: all C).
// Rows at or past expert e's count n_e are written as zeros and their x
// is never read: a block whose rows all lie past n_e stores zeros over
// its tile and returns before its first copy; a block that holds n_e
// copies x's rows below it (the rest zero-filled) and writes zeros past
// it. Rows below n_e take the same copies and the same sums in the same
// order as with no count: bitwise the same outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../shared/csrc/sm90.cuh"

namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;

// expert e's rows that hold input, clamped to [0, C]; C with no counts
__device__ __forceinline__ int rows_held(const int64_t* nrows, int e, int C) {
  if (nrows == nullptr) return C;
  const int64_t n = nrows[e];
  return n < 0 ? 0 : n > C ? C : int(n);
}

// ---- float32: CUDA cores fed by a cp.async ring ----

// 4 bytes from global to shared memory, zero-filled (src unread) if !ok:
// the scalar-copy instance's stage
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(sm90::smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// A block of (BM / TM) x (BN / TN) threads over BM rows of C and BN
// columns of f; thread (tx, ty) owns rows ty + i BM / TM (i < TM) and, in
// each of TN / 4 column groups of BN / (TN / 4), the 4 columns at 4 tx. A
// stage is BK rows of w ([BK][BN]) then BM rows of x ([BM][kXS], BK
// columns of d each; padded where a warp holds rows of two ty, which
// then read x rows apart in other banks).
template <int BM, int BN, int BK, int TM, int TN>
struct F32Tile {
  static constexpr int kTY = BM / TM, kTX = BN / TN;
  static constexpr int kThreads = kTY * kTX;
  static constexpr int kNG = TN / 4;
  static constexpr int kXS = kTX >= 32 ? BK : BK + 4;
  static constexpr int kStage = BK * BN + BM * kXS;  // floats
  static_assert(BM % TM == 0 && BN % TN == 0 && TN % 4 == 0 && BK % 4 == 0,
                "tiles");
};

// acc[4 g + c] += x_k w_k[g][c] for the 4 k of xv in order
template <int NG>
__device__ __forceinline__ void fma_row(float (&acc)[4 * NG], float4 xv,
                                        const float4 (&wv)[4][NG]) {
  const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      acc[4 * g + 0] = fmaf(xs[j], wv[j][g].x, acc[4 * g + 0]);
      acc[4 * g + 1] = fmaf(xs[j], wv[j][g].y, acc[4 * g + 1]);
      acc[4 * g + 2] = fmaf(xs[j], wv[j][g].z, acc[4 * g + 2]);
      acc[4 * g + 3] = fmaf(xs[j], wv[j][g].w, acc[4 * g + 3]);
    }
}

// rows x min(BN, f - f0) outputs from column f0 of the rows at oe (f
// apart) <- 0, by NT threads; kVec: float4 stores (f a multiple of 4)
template <int BN, int NT, bool kVec>
__device__ void zero_tile_f32(float* oe, int rows, int f0, int f, int tid) {
  const int cols = min(BN, f - f0), q4 = kVec ? cols / 4 : cols;
  for (int c = tid; c < rows * q4; c += NT) {
    float* p = oe + int64_t(c / q4) * f + f0 + (kVec ? 4 : 1) * (c % q4);
    if constexpr (kVec)
      *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
    else
      *p = 0.f;
  }
}

// grid (ceil(f / BN), ceil(C / BM), E), F32Tile's threads, STAGES stages
// of dynamic shared memory; x, w, out contiguous; nrows null or E counts.
// kVec: f and d are multiples of 4 and x, w, out 16-byte aligned, so the
// stages fill by 16-byte copies and the output stores as float4; else
// single floats.
template <int BM, int BN, int BK, int TM, int TN, int STAGES, int MINB,
          bool kVec>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
    gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out,
                   const int64_t* __restrict__ nrows, int C, int d, int f) {
  using T = F32Tile<BM, BN, BK, TM, TN>;
  constexpr int TY = T::kTY, TX = T::kTX, NT = T::kThreads, NG = T::kNG,
                XS = T::kXS, SE = T::kStage, GW = BN / NG;
  extern __shared__ __align__(16) float f32_ring[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int f0 = blockIdx.x * BN, c0 = blockIdx.y * BM, e = blockIdx.z;
  const float* we = w + int64_t(e) * d * f;
  const float* xe = x + (int64_t(e) * C + c0) * d;
  // rows [0, live) of the tile hold input, [live, min(BM, C - c0)) are
  // written as 0; the bound min(BM, C - c0) is taken again after the
  // loop, so the loop holds one register for both
  const int live = max(0, min(BM, rows_held(nrows, e, C) - c0));
  if (live == 0) {  // uniform over the block: no barrier is skipped
    zero_tile_f32<BN, NT, kVec>(out + (int64_t(e) * C + c0) * f,
                                min(BM, C - c0), f0, f, tid);
    return;
  }
  const int ktiles = (d + BK - 1) / BK;

  // stage s <- w rows [k0, k0 + BK) x columns [f0, f0 + BN), then x rows
  // [c0, c0 + BM) x columns [k0, k0 + BK); out-of-range elements zero.
  // 16-byte copies: a thread's chunks are rows RW (RX) apart in one
  // column, so their sources and destinations are fixed offsets from
  // one pointer a stage
  constexpr int CW = BN / 4, CX = BK / 4;  // 16-byte chunks a row
  constexpr int RW = NT / CW, RX = NT / CX;
  static_assert(!kVec || (NT % CW == 0 && NT % CX == 0), "copy layout");
  const int wr = tid / CW, wq = tid % CW * 4, xr = tid / CX,
            xq = tid % CX * 4;
  const bool wcol = f0 + wq < f;
  const float* wsrc = we + int64_t(wr) * f + f0 + wq;
  const float* xsrc = xe + int64_t(xr) * d + xq;
  auto load = [&](int s, int kt) {
    float* sw = f32_ring + s * SE;
    float* sx = sw + BK * BN;
    const int k0 = kt * BK;
    if constexpr (kVec) {
      const float* ws = wsrc + int64_t(k0) * f;
#pragma unroll
      for (int i = 0; i < (BK + RW - 1) / RW; ++i) {
        const int r = wr + i * RW;
        if (BK % RW == 0 || r < BK) {
          const bool ok = wcol && k0 + r < d;
          cp_async16(sw + r * BN + wq, ok ? ws + int64_t(i * RW) * f : we,
                     ok);
        }
      }
#pragma unroll
      for (int i = 0; i < (BM + RX - 1) / RX; ++i) {
        const int r = xr + i * RX;
        if (BM % RX == 0 || r < BM) {
          const bool ok = r < live && k0 + xq < d;
          cp_async16(sx + r * XS + xq,
                     ok ? xsrc + int64_t(i * RX) * d + k0 : xe, ok);
        }
      }
    } else {
      for (int c = tid; c < BK * BN; c += NT) {
        const int r = c / BN, q = c % BN;
        const bool ok = k0 + r < d && f0 + q < f;
        cp_async4(sw + r * BN + q,
                  ok ? we + int64_t(k0 + r) * f + f0 + q : we, ok);
      }
      for (int c = tid; c < BM * BK; c += NT) {
        const int r = c / BK, q = c % BK;
        const bool ok = r < live && k0 + q < d;
        cp_async4(sx + r * XS + q, ok ? xe + int64_t(r) * d + k0 + q : xe,
                  ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's)
    __syncthreads();              // ... every thread's; stage kt - 1 is free
    if (kt + STAGES - 1 < ktiles)
      load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const float* sw = f32_ring + kt % STAGES * SE;
    const float* sx = sw + BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 wv[4][NG];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int g = 0; g < NG; ++g)
          wv[j][g] = *reinterpret_cast<const float4*>(
              sw + (kk + j) * BN + g * GW + 4 * tx);
#pragma unroll
      for (int i = 0; i < TM; ++i)
        fma_row<NG>(acc[i], *reinterpret_cast<const float4*>(
                                sx + (ty + i * TY) * XS + kk),
                    wv);
    }
  }
  cp_async_wait<0>();

  float* oe = out + (int64_t(e) * C + c0) * f;
  const int rows = min(BM, C - c0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * TY;
    if (r >= rows) continue;
    const bool held = r < live;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = f0 + g * GW + 4 * tx;
      float* p = oe + int64_t(r) * f + col;
      const float* a = &acc[i][4 * g];
      if constexpr (kVec) {
        if (col < f)
          *reinterpret_cast<float4*>(p) =
              held ? make_float4(a[0], a[1], a[2], a[3])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < f) p[c] = held ? a[c] : 0.f;
      }
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN, int STAGES, int MINB,
          bool kVec>
cudaError_t launch_f32_as(const void* x, const void* w, void* out,
                          const void* nrows, int E, int C, int d, int f,
                          cudaStream_t stream) {
  using T = F32Tile<BM, BN, BK, TM, TN>;
  constexpr int smem = STAGES * T::kStage * int(sizeof(float));
  const auto kernel = gmm_f32_kernel<BM, BN, BK, TM, TN, STAGES, MINB, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  kernel<<<grid, T::kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), static_cast<const int64_t*>(nrows), C, d, f);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int TM, int TN, int STAGES, int MINB>
cudaError_t launch_f32(const void* x, const void* w, void* out,
                       const void* nrows, int E, int C, int d, int f,
                       cudaStream_t stream) {
  const bool vec = f % 4 == 0 && d % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return vec ? launch_f32_as<BM, BN, BK, TM, TN, STAGES, MINB, true>(
                   x, w, out, nrows, E, C, d, f, stream)
             : launch_f32_as<BM, BN, BK, TM, TN, STAGES, MINB, false>(
                   x, w, out, nrows, E, C, d, f, stream);
}

// the rows of C a block owns (the f32 kernel's BM, the bf16 kernel's 8 NT)
// by dtype and C: the one table that dispatch_f32, dispatch_bf16 and
// gmm_ecd_row_tile() read
int row_tile(int dtype, int C) {
  if (C <= 8) return 8;
  if (C <= 16) return 16;
  return C <= 32 || dtype == 1 ? 32 : 64;
}

// <BM rows of C, BN columns of f, BK rows of d a stage, TM x TN a thread,
// STAGES, blocks an SM> by C: decode (8), prefill at prompt 32 (15) and
// 128 (60), C-tiles of 64 past that. At C <= 16 the call streams w and
// 8 blocks fit an SM (27 KB of stages, <= 128 registers), so a layer's
// 704 or 1024 blocks are all resident at once: no partial last wave
// starves the stream. At C = 60 the FMAs bound it; 32-row stages halve
// the barriers, and 3 blocks an SM fit (168 registers, 75 KB).
cudaError_t dispatch_f32(const void* x, const void* w, void* out,
                         const void* n, int E, int C, int d, int f,
                         cudaStream_t s) {
  switch (row_tile(0, C)) {
    case 8:
      return launch_f32<8, 128, 16, 4, 4, 3, 8>(x, w, out, n, E, C, d, f, s);
    case 16:
      return launch_f32<16, 128, 16, 8, 4, 3, 8>(x, w, out, n, E, C, d, f, s);
    case 32:
      return launch_f32<32, 128, 16, 8, 4, 3, 4>(x, w, out, n, E, C, d, f, s);
    default:
      return launch_f32<64, 128, 32, 8, 8, 3, 2>(x, w, out, n, E, C, d, f, s);
  }
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

using sm90::ldmatrix_x2;
using sm90::ldmatrix_x4_trans;
using sm90::mma_bf16;

// grid (ceil(f / kBM), ceil(C / (8 NT)), E), kMmaThreads threads,
// mma_smem_bytes<NT>() of dynamic shared memory; x, w, out contiguous;
// nrows null or E counts. kVec: f and d are multiples of 8 and x, w are
// 16-byte aligned, so the tiles are staged by 16-byte cp.async; else by
// plain loads.
template <int NT, bool kVec>
__global__ void __launch_bounds__(kMmaThreads) gmm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ out, const int64_t* __restrict__ nrows,
    int C, int d, int f) {
  extern __shared__ __align__(16) __nv_bfloat16 ring[];
  constexpr int BN = 8 * NT, SE = stage_elems<NT>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.x * kBM, c0 = blockIdx.y * BN, e = blockIdx.z;
  const __nv_bfloat16* we = w + int64_t(e) * d * f;
  const __nv_bfloat16* xe = x + int64_t(e) * C * d;
  // rows c0 + [0, live) hold input, c0 + [live, min(BN, C - c0)) give 0
  const int live = max(0, min(BN, rows_held(nrows, e, C) - c0));
  if (live == 0) {  // uniform over the block: no barrier is skipped
    const int rows = min(BN, C - c0), cols = min(kBM, f - f0);
    for (int c = tid; c < rows * cols; c += kMmaThreads)
      out[(int64_t(e) * C + c0 + c / cols) * f + f0 + c % cols] =
          __float2bfloat16(0.f);
    return;
  }
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
        const bool ok = r < live && k0 + q < d;
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
        sx[r * kXS + q] = r < live && k0 + q < d
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
          out[(int64_t(e) * C + n) * f + m] =
              __float2bfloat16(n < c0 + live ? acc[mt][nt][i] : 0.f);
      }
}

template <int NT, bool kVec>
cudaError_t launch_mma(const void* x, const void* w, void* out,
                       const void* nrows, int E, int C, int d, int f,
                       cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<NT>();
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_bf16_kernel<NT, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((f + kBM - 1) / kBM, (C + 8 * NT - 1) / (8 * NT), E);
  gmm_bf16_kernel<NT, kVec><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      static_cast<const int64_t*>(nrows), C, d, f);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_nt(const void* x, const void* w, void* out,
                      const void* nrows, int E, int C, int d, int f,
                      cudaStream_t stream) {
  const bool vec = f % 8 == 0 && d % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  return vec ? launch_mma<NT, true>(x, w, out, nrows, E, C, d, f, stream)
             : launch_mma<NT, false>(x, w, out, nrows, E, C, d, f, stream);
}

cudaError_t dispatch_bf16(const void* x, const void* w, void* out,
                          const void* n, int E, int C, int d, int f,
                          cudaStream_t s) {
  switch (row_tile(1, C)) {
    case 8: return launch_nt<1>(x, w, out, n, E, C, d, f, s);
    case 16: return launch_nt<2>(x, w, out, n, E, C, d, f, s);
    default: return launch_nt<4>(x, w, out, n, E, C, d, f, s);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike); x (E, C, d),
// w (E, d, f), out (E, C, f), all contiguous; nrows null or E int64 on
// the card, expert e's rows that hold input (clamped to [0, C]; rows past
// it are written as zeros and not read). Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a dtype or shape it does not take).
int gmm_ecd(const void* x, const void* w, void* out, const void* nrows,
            int dtype, int E, int C, int d, int f, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || (C + 7) / 8 > 65535 || d < 0 || f <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(x, w, out, nrows, E, C, d, f, s);
  if (dtype == 1) return dispatch_bf16(x, w, out, nrows, E, C, d, f, s);
  return cudaErrorInvalidValue;
}

// the rows of C one block of gmm_ecd owns at this dtype and C (0 for a
// dtype or C it does not take)
int gmm_ecd_row_tile(int dtype, int C) {
  if ((dtype != 0 && dtype != 1) || C <= 0) return 0;
  return row_tile(dtype, C);
}

}  // extern "C"
