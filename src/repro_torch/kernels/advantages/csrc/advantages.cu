// Discounted-return reverse scan and its adjoint for Hopper (sm_90a),
// plain CUDA C++.
//
// Replaces the Pallas TPU kernel `discounted_return_tb` in
// src/repro/kernels/advantages/kernel.py:37 (pallas_call at :43): the
// first-order reverse recurrence
//
//     out_t = base_t + coef_t * out_{t+1},      out_T = init
//
// over (T, B) f32 time-major inputs, which carries PPO's GAE
// (base = delta, coef = gamma*lambda*(1-done), init = 0) and A3C's n-step
// return (base = r, coef = gamma*(1-done), init = V(s_T)). The A3C loss
// differentiates through the n-step return into the bootstrap value, so
// this source also holds the adjoint scan, which runs forward in time:
//
//     a_0 = g_0,  a_t = g_t + coef_{t-1} * a_{t-1}
//     dbase_t = a_t,  dcoef_t = a_t * out_{t+1} (out_T = init),
//     dinit = coef_{T-1} * a_{T-1}
//
// What bounds it on this card: bytes (the forward moves 4*(3TB + B), the
// adjoint 4*(5TB + 2B)) and, at the training path's (T, B) = (32, 32),
// the latency of one launch and one global round trip: a few KB, a few ns
// of bytes. A loop that waits on each batch of loads costs a round trip
// a batch, and a column scanned in order costs T dependent FMAs; the
// design removes both.
//
// Design: each step is an affine map x -> b + c*x, and a run of steps
// composes to one map (C, B) (compose (c1, b1) after (c2, b2): (c1*c2,
// b1 + c1*b2)), so the recurrence is a scan over time: runs of rows are
// composed in parallel, then each run is played from the value entering
// it.
//
// T <= 32 (the training path's (32, 32); discounted_return_*_short): a
// block of 8 warps owns 32 columns, lane = column, so every load and
// store is a coalesced row piece; warp w owns rows 4w..4w+3. Every load
// is issued at once into registers (rows past T and columns past B read
// row T - 1 and column B - 1, unused, so no load waits on a branch); each
// lane composes the map of its 4 rows; after one barrier it composes the
// maps of the warps after it (forward) or before it (adjoint), up to 7,
// from shared memory onto the carry, and plays its rows.
//
// T > 32 (discounted_return_fwd/adj): a block of 8 warps owns 8 columns;
// warp w owns column w of the tile and lane j the K consecutive rows
// jK..jK+K-1 of a pass of 32K rows. A pass:
//   1. every load of the (32K, 8) tile is issued at once, 16-byte vectors
//      where the rows allow it (scalar loads through the strides where
//      not), into registers, then written into shared memory column by
//      column (a padded column: one float of pad every 32 rows, so a warp
//      reading its column at rows jK + s hits 32 banks). The next pass's
//      loads are issued before this pass computes.
//   2. each lane composes the maps of its K rows;
//   3. the warp composes them across lanes with a fixed shuffle tree (5
//      levels, Hillis-Steele), suffix-wise for the forward and
//      prefix-wise for the adjoint;
//   4. each lane plays its K rows from the value entering them and writes
//      its outputs over its inputs in shared memory; the block then
//      stores the tile in 16-byte vectors.
// Passes run from the last rows to the first (forward) or first to last
// (adjoint), the carry between them one register of the warp. So a
// column of T rows costs ceil(T / 32K) passes of 2K + 5 dependent steps,
// not T; K is 4 up to T = 128, else 16 (the host's choice).
//
// Both read their inputs through (row, column) strides (strided views
// and autograd's stride-0 gradients as they lie); b >= B is masked (no
// padding copy); no atomics; the same inputs give the same bits whatever
// their strides (the arithmetic depends on T only). The rounding differs
// from the plain version's sequential chain by the composition order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../shared/csrc/sm90.cuh"

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

template <int K>
__global__ void __launch_bounds__(kThreads)
    discounted_return_fwd(Mat base, Mat coef, const float* init,
                          int64_t init_s, float* out, int T, int B) {
  using Tl = Tile<K>;
  constexpr int S = Tl::kStride, NC = Tl::kCols;
  extern __shared__ float smem[];
  float* sb = smem;              // [NC][S]: base, then out
  float* sc = smem + NC * S;     // [NC][S]: coef
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * NC, b = b0 + w;
  const bool vb = vec_ok(base, b0, B, NC), vc = vec_ok(coef, b0, B, NC);
  const int passes = (T + Tl::kRows - 1) / Tl::kRows;
  float carry = b < B ? ld_nc(init + int64_t(b) * init_s) : 0.f;

  float4 rb[Tl::kPer], rc[Tl::kPer];
  int64_t t0 = int64_t(passes - 1) * Tl::kRows;
  load_tile<Tl>(rb, base, vb, t0, b0, T, B);
  load_tile<Tl>(rc, coef, vc, t0, b0, T, B);
  for (int p = passes - 1; p >= 0; --p, t0 -= Tl::kRows) {
    const int n = T - t0 < Tl::kRows ? int(T - t0) : Tl::kRows;
    if (p != passes - 1) __syncthreads();  // the last pass's tile is stored
    store_smem<Tl>(sb, rb);
    store_smem<Tl>(sc, rc);
    __syncthreads();
    if (p > 0) {  // the next pass's loads fly while this one computes
      load_tile<Tl>(rb, base, vb, t0 - Tl::kRows, b0, T, B);
      load_tile<Tl>(rc, coef, vc, t0 - Tl::kRows, b0, T, B);
      issue_here();
    }
    if (b < B) {  // warp-uniform
      const float* cb = sc + w * S;
      float* bb = sb + w * S;
      float C = 1.f, Bv = 0.f;  // the map of this lane's rows
#pragma unroll
      for (int s = K - 1; s >= 0; --s) {
        const int r = lane * K + s;
        if (r < n) {
          const float c = cb[padded(r)];
          Bv = fmaf(c, Bv, bb[padded(r)]);
          C *= c;
        }
      }
      // suffix scan: lane j ends with the map of lanes j..31
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float Cn = __shfl_down_sync(kFull, C, d);
        const float Bn = __shfl_down_sync(kFull, Bv, d);
        if (lane + d < 32) compose(C, Bv, Cn, Bn);
      }
      const float v = fmaf(C, carry, Bv);
      float acc = __shfl_down_sync(kFull, v, 1);  // the value after my rows
      if (lane == 31) acc = carry;
#pragma unroll
      for (int s = K - 1; s >= 0; --s) {
        const int r = lane * K + s;
        if (r < n) {
          acc = fmaf(cb[padded(r)], acc, bb[padded(r)]);
          bb[padded(r)] = acc;
        }
      }
      carry = __shfl_sync(kFull, acc, 0);  // out at the pass's first row
    }
    __syncthreads();
    store_out<Tl>(out, sb, t0, n, b0, B);
  }
}

// dbase / dcoef / dinit may be null: the caller asks only for the
// gradients autograd needs. The scan over `a` runs either way.
template <int K>
__global__ void __launch_bounds__(kThreads)
    discounted_return_adj(Mat g, Mat coef, Mat out, const float* init,
                          int64_t init_s, float* dbase, float* dcoef,
                          float* dinit, int T, int B) {
  using Tl = Tile<K>;
  constexpr int S = Tl::kStride, NC = Tl::kCols;
  extern __shared__ float smem[];
  float* sg = smem;               // g rows t, then dbase
  float* sp = smem + NC * S;      // coef rows t - 1
  float* so = sp + NC * S;        // out rows t + 1, then dcoef
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * NC, b = b0 + w;
  const bool vg = vec_ok(g, b0, B, NC), vp = vec_ok(coef, b0, B, NC),
             vo = vec_ok(out, b0, B, NC);
  const bool need_o = dcoef != nullptr;
  const int passes = (T + Tl::kRows - 1) / Tl::kRows;
  const float out_T = b < B ? ld_nc(init + int64_t(b) * init_s) : 0.f;
  // coef_{T-1}, for dinit, loaded with the first tile
  const float c_last = dinit && b < B ? ld_nc(coef.p + int64_t(T - 1) * coef.s0
                                               + int64_t(b) * coef.s1)
                                      : 0.f;
  float carry = 0.f;  // a_{-1} = 0 makes a_0 = g_0

  float4 rg[Tl::kPer], rp[Tl::kPer], ro[Tl::kPer];
  int64_t t0 = 0;
  load_tile<Tl>(rg, g, vg, 0, b0, T, B);
  load_tile<Tl>(rp, coef, vp, -1, b0, T, B);
  if (need_o) load_tile<Tl>(ro, out, vo, 1, b0, T, B);
  for (int p = 0; p < passes; ++p, t0 += Tl::kRows) {
    const int n = T - t0 < Tl::kRows ? int(T - t0) : Tl::kRows;
    if (p != 0) __syncthreads();
    store_smem<Tl>(sg, rg);
    store_smem<Tl>(sp, rp);
    if (need_o) store_smem<Tl>(so, ro);
    __syncthreads();
    if (p + 1 < passes) {
      const int64_t t1 = t0 + Tl::kRows;
      load_tile<Tl>(rg, g, vg, t1, b0, T, B);
      load_tile<Tl>(rp, coef, vp, t1 - 1, b0, T, B);
      if (need_o) load_tile<Tl>(ro, out, vo, t1 + 1, b0, T, B);
      issue_here();
    }
    if (b < B) {  // warp-uniform
      float* gb = sg + w * S;
      const float* pb = sp + w * S;
      float* ob = so + w * S;
      float C = 1.f, Bv = 0.f;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int r = lane * K + s;
        if (r < n) {
          const float c = t0 + r > 0 ? pb[padded(r)] : 0.f;
          Bv = fmaf(c, Bv, gb[padded(r)]);
          C *= c;
        }
      }
      // prefix scan: lane j ends with the map of lanes 0..j
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float Cn = __shfl_up_sync(kFull, C, d);
        const float Bn = __shfl_up_sync(kFull, Bv, d);
        if (lane >= d) compose(C, Bv, Cn, Bn);
      }
      const float v = fmaf(C, carry, Bv);
      float acc = __shfl_up_sync(kFull, v, 1);  // a before my rows
      if (lane == 0) acc = carry;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int r = lane * K + s;
        if (r < n) {
          const float c = t0 + r > 0 ? pb[padded(r)] : 0.f;
          acc = fmaf(c, acc, gb[padded(r)]);
          gb[padded(r)] = acc;
          if (need_o)
            ob[padded(r)] = acc * (t0 + r + 1 < T ? ob[padded(r)] : out_T);
        }
      }
      carry = __shfl_sync(kFull, acc, (n - 1) / K);  // a at the last row
      if (p == passes - 1 && dinit && lane == 0) dinit[b] = c_last * carry;
    }
    __syncthreads();
    if (dbase) store_out<Tl>(dbase, sg, t0, n, b0, B);
    if (need_o) store_out<Tl>(dcoef, so, t0, n, b0, B);
  }
}

// T <= 32: lane = column, warp w rows 4w..4w+3 (the design note above).
constexpr int kShortT = 32;            // the longest T it takes
constexpr int kShortRows = kShortT / kWarps;

__global__ void __launch_bounds__(kThreads)
    discounted_return_fwd_short(Mat base, Mat coef, const float* init,
                                int64_t init_s, float* out, int T, int B) {
  __shared__ float sC[kWarps][32], sB[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane, t0 = w * kShortRows;
  // every load unconditional and in flight at once: rows past T and
  // columns past B read row T - 1 and column B - 1 (unused)
  const int64_t bc = min(b, B - 1);
  float bv[kShortRows], cv[kShortRows];
#pragma unroll
  for (int i = 0; i < kShortRows; ++i) {
    const int t = min(t0 + i, T - 1);
    bv[i] = ld_nc(base.p + t * base.s0 + bc * base.s1);
    cv[i] = ld_nc(coef.p + t * coef.s0 + bc * coef.s1);
  }
  float x = ld_nc(init + bc * init_s);
  issue_here();
  float C = 1.f, Bv = 0.f;  // the map of my rows, the last applied first
#pragma unroll
  for (int i = kShortRows - 1; i >= 0; --i) {
    if (t0 + i < T) {
      Bv = fmaf(cv[i], Bv, bv[i]);
      C *= cv[i];
    }
  }
  sC[w][lane] = C;
  sB[w][lane] = Bv;
  __syncthreads();
#pragma unroll
  for (int u = kWarps - 1; u > 0; --u)  // the warps after mine, onto init
    if (u > w) x = fmaf(sC[u][lane], x, sB[u][lane]);
  if (b >= B) return;
#pragma unroll
  for (int i = kShortRows - 1; i >= 0; --i) {
    const int t = t0 + i;
    if (t < T) {
      x = fmaf(cv[i], x, bv[i]);
      out[int64_t(t) * B + b] = x;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    discounted_return_adj_short(Mat g, Mat coef, Mat out, const float* init,
                                int64_t init_s, float* dbase, float* dcoef,
                                float* dinit, int T, int B) {
  __shared__ float sC[kWarps][32], sB[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane, t0 = w * kShortRows;
  const bool need_o = dcoef != nullptr;
  const int64_t bc = min(b, B - 1);  // as in the forward
  // gv: g_t; cv: coef_{t-1} (0 at t = 0); ov: out_{t+1} (init at T - 1)
  float gv[kShortRows], cv[kShortRows], ov[kShortRows];
#pragma unroll
  for (int i = 0; i < kShortRows; ++i) {
    const int tc = min(t0 + i, T - 1);
    gv[i] = ld_nc(g.p + tc * g.s0 + bc * g.s1);
    cv[i] = ld_nc(coef.p + max(tc - 1, 0) * coef.s0 + bc * coef.s1);
    if (need_o) ov[i] = ld_nc(out.p + min(tc + 1, T - 1) * out.s0 +
                              bc * out.s1);
  }
  const float out_T = ld_nc(init + bc * init_s);
  const float c_last = ld_nc(coef.p + int64_t(T - 1) * coef.s0 +
                             bc * coef.s1);
  issue_here();
#pragma unroll
  for (int i = 0; i < kShortRows; ++i) {
    if (t0 + i == 0) cv[i] = 0.f;
    if (t0 + i == T - 1) ov[i] = out_T;
  }
  float C = 1.f, Bv = 0.f;  // the map of my rows, the first applied first
#pragma unroll
  for (int i = 0; i < kShortRows; ++i) {
    if (t0 + i < T) {
      Bv = fmaf(cv[i], Bv, gv[i]);
      C *= cv[i];
    }
  }
  sC[w][lane] = C;
  sB[w][lane] = Bv;
  __syncthreads();
  float x = 0.f;  // a_{-1} = 0 makes a_0 = g_0
#pragma unroll
  for (int u = 0; u < kWarps - 1; ++u)  // the warps before mine
    if (u < w) x = fmaf(sC[u][lane], x, sB[u][lane]);
  if (b >= B) return;
#pragma unroll
  for (int i = 0; i < kShortRows; ++i) {
    const int t = t0 + i;
    if (t < T) {
      x = fmaf(cv[i], x, gv[i]);
      const int64_t k = int64_t(t) * B + b;
      if (dbase) dbase[k] = x;
      if (need_o) dcoef[k] = x * ov[i];
    }
  }
  // the warp that holds row T - 1: dinit = coef_{T-1} a_{T-1}
  if (dinit && t0 <= T - 1 && T - 1 < t0 + kShortRows) dinit[b] = c_last * x;
}

// Rows a lane takes per pass of the tiled scans (T > 32): one pass up to
// T = 128, else passes of 512 rows.
inline int choose_k(int T) { return T <= 128 ? 4 : 16; }

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

extern "C" {

// The launch arguments, packed by the caller (kernel.py's FWD_PARAMS and
// ADJ_PARAMS: little endian, no padding; the layouts below have none on
// x86-64). Inputs are (T, B) f32 with element strides (s0, s1); init is
// (B,) with stride init_s; outputs are contiguous (T, B) buffers, (B,)
// for dinit, or null where not asked for.
struct ScanFwdParams {
  const float *base, *coef, *init;
  float* out;
  int64_t base_s0, base_s1, coef_s0, coef_s1, init_s;
  int T, B;
};
static_assert(sizeof(ScanFwdParams) == 80, "ScanFwdParams is packed");

struct ScanAdjParams {
  const float *g, *coef, *out, *init;
  float *dbase, *dcoef, *dinit;
  int64_t g_s0, g_s1, coef_s0, coef_s1, out_s0, out_s1, init_s;
  int T, B;
};
static_assert(sizeof(ScanAdjParams) == 120, "ScanAdjParams is packed");

// Launch on `stream`, allocate nothing, return cudaGetLastError() after
// the launch (cudaErrorInvalidValue for T or B < 1).
int discounted_return_tb(const ScanFwdParams* p, void* stream) {
  if (p->T < 1 || p->B < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mat base{p->base, p->base_s0, p->base_s1};
  const Mat coef{p->coef, p->coef_s0, p->coef_s1};
  if (p->T <= kShortT) {
    discounted_return_fwd_short<<<(p->B + 31) / 32, kThreads, 0, s>>>(
        base, coef, p->init, p->init_s, p->out, p->T, p->B);
    return cudaGetLastError();
  }
  if (choose_k(p->T) == 4)
    return launch<4, 2>(discounted_return_fwd<4>, p->B, s, base, coef,
                        p->init, p->init_s, p->out, p->T, p->B);
  return launch<16, 2>(discounted_return_fwd<16>, p->B, s, base, coef,
                       p->init, p->init_s, p->out, p->T, p->B);
}

int discounted_return_adjoint_tb(const ScanAdjParams* p, void* stream) {
  if (p->T < 1 || p->B < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mat g{p->g, p->g_s0, p->g_s1};
  const Mat coef{p->coef, p->coef_s0, p->coef_s1};
  const Mat out{p->out, p->out_s0, p->out_s1};
  if (p->T <= kShortT) {
    discounted_return_adj_short<<<(p->B + 31) / 32, kThreads, 0, s>>>(
        g, coef, out, p->init, p->init_s, p->dbase, p->dcoef, p->dinit, p->T,
        p->B);
    return cudaGetLastError();
  }
  if (choose_k(p->T) == 4)
    return launch<4, 3>(discounted_return_adj<4>, p->B, s, g, coef, out,
                        p->init, p->init_s, p->dbase, p->dcoef, p->dinit,
                        p->T, p->B);
  return launch<16, 3>(discounted_return_adj<16>, p->B, s, g, coef, out,
                       p->init, p->init_s, p->dbase, p->dcoef, p->dinit,
                       p->T, p->B);
}

}  // extern "C"
