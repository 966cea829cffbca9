// V-trace targets for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `vtrace_tb` in
// src/repro/kernels/vtrace/kernel.py:46 (pallas_call at :55): from
// log importance ratios, discounts, rewards and values (T, B) f32
// time-major and the bootstrap value V_T (B,),
//
//     rho_t = min(rho_bar, e^{log rho_t}),  c_t = min(c_bar, e^{log rho_t})
//     delta_t = rho_t (r_t + g_t V_{t+1} - V_t)
//     acc_t = delta_t + (g_t c_t) acc_{t+1},   acc_T = 0
//     vs_t  = V_t + acc_t
//     pg_adv_t = rho_t (r_t + g_t vs_{t+1} - V_t),   vs_T = V_T
//
// Both outputs are targets (stop-gradient in the reference), so there is
// no backward.
//
// What bounds it on this card: bytes (4*(6TB + B)) and, at the training
// path's (T, B) = (32, 32), the latency of one launch and one global
// round trip: a few KB, a few ns of bytes. A column scanned in order is
// a chain of T dependent steps, and a loop that waits on each batch of
// loads pays a round trip a batch; the design removes both, as the
// discounted-return scans do (advantages/csrc/advantages.cu, whose
// blocking, shared/csrc/scan_tiles.cuh, this file reuses).
//
// Design: an elementwise prologue forms rho_t, g_t c_t and delta_t from
// row t and V at row t + 1 (V_T = bootstrap), with e^{log rho} computed
// once (full-precision expf) and clipped twice. The recurrence is then
// the affine map x -> delta_t + (g_t c_t) x, composed over runs of rows
// in parallel and played from the value entering each run. The epilogue
// needs only vs_{t+1} = V_{t+1} + acc_{t+1}: playing row t, the value
// entering it is acc_{t+1} (for a run's last row, the carry into the
// run, which the lane already holds), so pg_adv and vs come from one pass
// with no exchange between warps.
//
// T <= 32 (the training path's (32, 32); vtrace_short): a block of 8
// warps owns 32 columns, lane = column (every load and store a coalesced
// row piece); warp w owns rows 4w..4w+3 and loads V at row 4w+4 too.
// Every load is issued at once (rows past T and columns past B read row
// T - 1 and column B - 1, unused); each lane composes the map of its 4
// rows; after one barrier it composes the maps of the warps after it
// from shared memory onto acc_T = 0 and plays its rows.
//
// T > 32 (vtrace_tiled<K>): the tiled blocking of the discounted-return
// forward with four input tiles: a block of 8 warps owns 8 columns, warp
// w column w of the tile, lane j rows jK..jK+K-1 of a pass of 32K rows;
// a pass's loads are all in flight at once (16-byte vectors where the
// rows allow it) and the next pass's are issued before this pass
// computes; each lane composes its K rows' maps, a 5-level shuffle tree
// composes them across lanes (suffix-wise), each lane plays its rows and
// writes vs and pg_adv over log rho and r in shared memory, and the block
// stores both tiles in 16-byte vectors. Passes run from the last rows to
// the first; V at the row after a pass is the first row of the pass
// before it in the loop (a register of the warp), or the bootstrap. K is
// 4 up to T = 128, else 16.
//
// Inputs are read through (row, column) strides (no padding or copy);
// b >= B is masked; no atomics; the same inputs give the same bits
// whatever their strides (the arithmetic depends on T only). nvcc
// contracts products and sums into FMAs, and the recurrence is composed
// in another order than the plain version's sequential loop, so results
// differ from it by rounding only.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../shared/csrc/scan_tiles.cuh"

extern "C" {

// The launch arguments, packed by the caller (kernel.py's VTRACE_PARAMS:
// little endian, no padding; the layout has none on x86-64). Inputs are
// (T, B) f32 with element strides (s0, s1); bootstrap is (B,) with
// stride boot_s; vs and pg_adv are contiguous (T, B) buffers.
struct VtraceParams {
  const float *log_rhos, *discounts, *rewards, *values, *bootstrap;
  float *vs, *pg_adv;
  int64_t lr_s0, lr_s1, d_s0, d_s1, r_s0, r_s1, v_s0, v_s1, boot_s;
  float clip_rho, clip_c;
  int T, B;
};
static_assert(sizeof(VtraceParams) == 144, "VtraceParams is packed");

}  // extern "C"

namespace {

// The prologue of one row: rho, the recurrence's coefficient g c and
// delta, from log rho, g, r, V and V at the next row.
struct Step {
  float rho, coef, delta;
};

__device__ __forceinline__ Step prologue(float log_rho, float g, float r,
                                         float v, float v_next,
                                         float clip_rho, float clip_c) {
  const float e = expf(log_rho);
  const float rho = fminf(clip_rho, e);
  return {rho, g * fminf(clip_c, e), rho * (r + g * v_next - v)};
}

__device__ __forceinline__ float pg_adv(const Step& s, float g, float r,
                                        float v, float vs_next) {
  return s.rho * (r + g * vs_next - v);
}

__global__ void __launch_bounds__(kThreads) vtrace_short(VtraceParams p) {
  constexpr int R = kShortRows;
  __shared__ float sC[kWarps][32], sB[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane, t0 = w * R;
  const int T = p.T, B = p.B;
  // every load unconditional and in flight at once: rows past T and
  // columns past B read row T - 1 and column B - 1 (unused)
  const int64_t bc = min(b, B - 1);
  float lr[R], g[R], r[R], v[R + 1];  // v[R]: V at row t0 + R
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t t = min(t0 + i, T - 1);
    lr[i] = ld_nc(p.log_rhos + t * p.lr_s0 + bc * p.lr_s1);
    g[i] = ld_nc(p.discounts + t * p.d_s0 + bc * p.d_s1);
    r[i] = ld_nc(p.rewards + t * p.r_s0 + bc * p.r_s1);
    v[i] = ld_nc(p.values + t * p.v_s0 + bc * p.v_s1);
  }
  v[R] = ld_nc(p.values + int64_t(min(t0 + R, T - 1)) * p.v_s0 +
               bc * p.v_s1);
  const float boot = ld_nc(p.bootstrap + bc * p.boot_s);
  issue_here();
  Step st[R];
  float C = 1.f, Bv = 0.f;  // the map of my rows, the last applied first
#pragma unroll
  for (int i = R - 1; i >= 0; --i) {
    const float v_next = t0 + i + 1 < T ? v[i + 1] : boot;
    st[i] = prologue(lr[i], g[i], r[i], v[i], v_next, p.clip_rho, p.clip_c);
    if (t0 + i < T) {
      Bv = fmaf(st[i].coef, Bv, st[i].delta);
      C *= st[i].coef;
    }
  }
  sC[w][lane] = C;
  sB[w][lane] = Bv;
  __syncthreads();
  float x = 0.f;  // acc_T = 0
#pragma unroll
  for (int u = kWarps - 1; u > 0; --u)  // the warps after mine
    if (u > w) x = fmaf(sC[u][lane], x, sB[u][lane]);
  if (b >= B) return;
#pragma unroll
  for (int i = R - 1; i >= 0; --i) {
    const int t = t0 + i;
    if (t < T) {  // x is acc_{t+1}
      const float v_next = t + 1 < T ? v[i + 1] : boot;
      const int64_t k = int64_t(t) * B + b;
      p.pg_adv[k] = pg_adv(st[i], g[i], r[i], v[i], v_next + x);
      x = fmaf(st[i].coef, x, st[i].delta);
      p.vs[k] = v[i] + x;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) vtrace_tiled(VtraceParams p) {
  using Tl = Tile<K>;
  constexpr int S = Tl::kStride, NC = Tl::kCols;
  extern __shared__ float smem[];
  float* sl = smem;           // [NC][S]: log rho, then vs
  float* sg = sl + NC * S;    // discounts
  float* sr = sg + NC * S;    // rewards, then pg_adv
  float* sv = sr + NC * S;    // values
  const int T = p.T, B = p.B;
  const Mat lr{p.log_rhos, p.lr_s0, p.lr_s1}, dg{p.discounts, p.d_s0,
                                                  p.d_s1},
      rw{p.rewards, p.r_s0, p.r_s1}, vl{p.values, p.v_s0, p.v_s1};
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * NC, b = b0 + w;
  const bool vec_l = vec_ok(lr, b0, B, NC), vec_g = vec_ok(dg, b0, B, NC),
             vec_r = vec_ok(rw, b0, B, NC), vec_v = vec_ok(vl, b0, B, NC);
  const int passes = (T + Tl::kRows - 1) / Tl::kRows;
  const float boot = b < B ? ld_nc(p.bootstrap + int64_t(b) * p.boot_s)
                           : 0.f;
  float carry = 0.f;      // acc_T = 0
  float v_after = boot;   // V at the row after the pass

  float4 ql[Tl::kPer], qg[Tl::kPer], qr[Tl::kPer], qv[Tl::kPer];
  int64_t t0 = int64_t(passes - 1) * Tl::kRows;
  load_tile<Tl>(ql, lr, vec_l, t0, b0, T, B);
  load_tile<Tl>(qg, dg, vec_g, t0, b0, T, B);
  load_tile<Tl>(qr, rw, vec_r, t0, b0, T, B);
  load_tile<Tl>(qv, vl, vec_v, t0, b0, T, B);
  for (int pass = passes - 1; pass >= 0; --pass, t0 -= Tl::kRows) {
    const int n = T - t0 < Tl::kRows ? int(T - t0) : Tl::kRows;
    if (pass != passes - 1) __syncthreads();  // the last pass is stored
    store_smem<Tl>(sl, ql);
    store_smem<Tl>(sg, qg);
    store_smem<Tl>(sr, qr);
    store_smem<Tl>(sv, qv);
    __syncthreads();
    if (pass > 0) {  // the next pass's loads fly while this one computes
      const int64_t t1 = t0 - Tl::kRows;
      load_tile<Tl>(ql, lr, vec_l, t1, b0, T, B);
      load_tile<Tl>(qg, dg, vec_g, t1, b0, T, B);
      load_tile<Tl>(qr, rw, vec_r, t1, b0, T, B);
      load_tile<Tl>(qv, vl, vec_v, t1, b0, T, B);
      issue_here();
    }
    if (b < B) {  // warp-uniform
      float* lb = sl + w * S;
      const float* gb = sg + w * S;
      float* rb = sr + w * S;
      const float* vb = sv + w * S;
      // V at row t0 + r + 1: in the tile, after the pass, or V_T
      auto v_next = [&](int r) {
        return t0 + r + 1 >= T ? boot
               : r + 1 < Tl::kRows ? vb[padded(r + 1)] : v_after;
      };
      Step st[K];
      float C = 1.f, Bv = 0.f;  // the map of this lane's rows
#pragma unroll
      for (int s = K - 1; s >= 0; --s) {
        const int r = lane * K + s;
        st[s] = prologue(lb[padded(r)], gb[padded(r)], rb[padded(r)],
                         vb[padded(r)], v_next(r), p.clip_rho, p.clip_c);
        if (r < n) {
          Bv = fmaf(st[s].coef, Bv, st[s].delta);
          C *= st[s].coef;
        }
      }
      // suffix scan: lane j ends with the map of lanes j..31
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float Cn = __shfl_down_sync(kFull, C, d);
        const float Bn = __shfl_down_sync(kFull, Bv, d);
        if (lane + d < 32) compose(C, Bv, Cn, Bn);
      }
      const float after = fmaf(C, carry, Bv);
      float acc = __shfl_down_sync(kFull, after, 1);  // after my rows
      if (lane == 31) acc = carry;
#pragma unroll
      for (int s = K - 1; s >= 0; --s) {
        const int r = lane * K + s;
        if (r < n) {  // acc is acc_{t+1}
          const float v = vb[padded(r)];
          rb[padded(r)] = pg_adv(st[s], gb[padded(r)], rb[padded(r)], v,
                                 v_next(r) + acc);
          acc = fmaf(st[s].coef, acc, st[s].delta);
          lb[padded(r)] = v + acc;
        }
      }
      carry = __shfl_sync(kFull, acc, 0);  // acc at the pass's first row
      v_after = vb[padded(0)];
    }
    __syncthreads();
    store_out<Tl>(p.vs, sl, t0, n, b0, B);
    store_out<Tl>(p.pg_adv, sr, t0, n, b0, B);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`, allocate nothing, return cudaGetLastError() after
// the launch (cudaErrorInvalidValue for T or B < 1).
int vtrace_tb(const VtraceParams* p, void* stream) {
  if (p->T < 1 || p->B < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->T <= kShortT) {
    vtrace_short<<<(p->B + 31) / 32, kThreads, 0, s>>>(*p);
    return cudaGetLastError();
  }
  if (choose_k(p->T) == 4) return launch<4, 4>(vtrace_tiled<4>, p->B, s, *p);
  return launch<16, 4>(vtrace_tiled<16>, p->B, s, *p);
}

}  // extern "C"
