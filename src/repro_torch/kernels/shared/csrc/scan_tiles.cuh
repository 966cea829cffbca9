// The blocking shared by the scans over time of (T, B) f32 time-major
// inputs (advantages/csrc/advantages.cu, vtrace/csrc/vtrace.cu): blocks
// of 8 warps; up to T = 32 (kShortT) a block owns 32 columns, lane =
// column, warp w rows 4w..4w+3; above, a block owns a tile of 8 columns
// (a column a warp) and 32K rows a pass (Tile<K>), loaded with every load
// in flight (load_tile), staged in padded shared-memory columns
// (store_smem) and stored in 16-byte row pieces (store_out). Each
// step of a scan is an affine map x -> b + c*x; `compose` joins two.
//
// Everything here lies in the including file's anonymous namespace (a
// kernel's mangled name holds `Mat` as that file's own type). Header
// only; the build's digest covers it.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::issue_here;
using sm90::ld_nc;
using sm90::ld_nc4;

constexpr int kWarps = 8;                // a block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

struct Mat {  // a read-only (T, B) f32 view
  const float* p;
  int64_t s0, s1;
};

__device__ __forceinline__ int padded(int r) { return r + (r >> 5); }

// One pass of the tiled scans: a (32K, kCols) tile, a column a warp.
// kStride is a padded column.
template <int K>
struct Tile {
  static constexpr int kCols = kWarps;
  static constexpr int kRowQuads = kCols / 4;  // float4 pieces of a row
  static constexpr int kRows = 32 * K;
  static constexpr int kStride = kRows + kRows / 32;
  static constexpr int kQuads = kRows * kRowQuads;
  static constexpr int kPer = (kQuads + kThreads - 1) / kThreads;
};

// The 16-byte loads of a tile need unit column stride, a row stride and a
// base that are 16-byte multiples, and the block's columns inside B.
__device__ __forceinline__ bool vec_ok(const Mat& m, int b0, int B,
                                       int cols) {
  return m.s1 == 1 && (m.s0 & 3) == 0 &&
         (reinterpret_cast<uintptr_t>(m.p) & 15) == 0 && b0 + cols <= B;
}

// Issue the loads of rows t_first .. t_first + 32K of m (0 outside
// [0, T) and past B) for this thread's pieces into v.
template <typename Tl>
__device__ __forceinline__ void load_tile(float4 (&v)[Tl::kPer],
                                          const Mat& m, bool vec,
                                          int64_t t_first, int b0, int T,
                                          int B) {
#pragma unroll
  for (int i = 0; i < Tl::kPer; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int64_t t = t_first + q / Tl::kRowQuads;
    const int c = b0 + q % Tl::kRowQuads * 4;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q >= Tl::kQuads || t < 0 || t >= T) continue;
    if (vec) {
      v[i] = ld_nc4(m.p + t * m.s0 + c);
    } else {
      const float* row = m.p + t * m.s0;
      if (c < B) v[i].x = ld_nc(row + int64_t(c) * m.s1);
      if (c + 1 < B) v[i].y = ld_nc(row + int64_t(c + 1) * m.s1);
      if (c + 2 < B) v[i].z = ld_nc(row + int64_t(c + 2) * m.s1);
      if (c + 3 < B) v[i].w = ld_nc(row + int64_t(c + 3) * m.s1);
    }
  }
}

// Write this thread's pieces into the column-major padded tile s.
template <typename Tl>
__device__ __forceinline__ void store_smem(float* s,
                                           const float4 (&v)[Tl::kPer]) {
  constexpr int S = Tl::kStride;
#pragma unroll
  for (int i = 0; i < Tl::kPer; ++i) {
    const int q = threadIdx.x + i * kThreads;
    if (q >= Tl::kQuads) continue;
    const int r = padded(q / Tl::kRowQuads), c = q % Tl::kRowQuads * 4;
    s[c * S + r] = v[i].x;
    s[(c + 1) * S + r] = v[i].y;
    s[(c + 2) * S + r] = v[i].z;
    s[(c + 3) * S + r] = v[i].w;
  }
}

// Store rows 0..n of the tile s to rows t0.. of the contiguous (T, B)
// buffer out, the block's columns from b0 (masked at B).
template <typename Tl>
__device__ __forceinline__ void store_out(float* out, const float* s,
                                          int64_t t0, int n, int b0, int B) {
  constexpr int S = Tl::kStride;
  const bool vec = b0 + Tl::kCols <= B && (B & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int q = threadIdx.x; q < n * Tl::kRowQuads; q += kThreads) {
    const int r = padded(q / Tl::kRowQuads), c = q % Tl::kRowQuads * 4;
    float* row = out + (t0 + q / Tl::kRowQuads) * B + b0 + c;
    const float4 v = make_float4(s[c * S + r], s[(c + 1) * S + r],
                                 s[(c + 2) * S + r], s[(c + 3) * S + r]);
    if (vec) {
      *reinterpret_cast<float4*>(row) = v;
    } else {
      if (b0 + c < B) row[0] = v.x;
      if (b0 + c + 1 < B) row[1] = v.y;
      if (b0 + c + 2 < B) row[2] = v.z;
      if (b0 + c + 3 < B) row[3] = v.w;
    }
  }
}

// (C, Bv) <- (C, Bv) after (Cn, Bn): the map of earlier-applied steps
// (Cn, Bn) composed with ours on the outside.
__device__ __forceinline__ void compose(float& C, float& Bv, float Cn,
                                        float Bn) {
  Bv = fmaf(C, Bn, Bv);
  C *= Cn;
}

// T <= 32: lane = column, warp w rows 4w..4w+3.
constexpr int kShortT = 32;            // the longest T it takes
constexpr int kShortRows = kShortT / kWarps;

// Rows a lane takes per pass of the tiled scans (T > 32): one pass up to
// T = 128, else passes of 512 rows.
inline int choose_k(int T) { return T <= 128 ? 4 : 16; }

// Launch a tiled kernel: a block per Tile<K>::kCols columns, with kArrays
// padded tiles of dynamic shared memory (its limit raised once per
// kernel where that passes 48 KB).
template <int K, int kArrays, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int B, cudaStream_t stream, Args... args) {
  using Tl = Tile<K>;
  constexpr int smem = kArrays * Tl::kCols * Tl::kStride * int(sizeof(float));
  if (smem > 48 * 1024) {
    static bool configured = false;  // once per instantiation
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      configured = true;
    }
  }
  kernel<<<(B + Tl::kCols - 1) / Tl::kCols, kThreads, smem, stream>>>(
      args...);
  return cudaGetLastError();
}

}  // namespace
