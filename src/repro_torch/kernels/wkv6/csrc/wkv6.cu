// Chunked RWKV-6 WKV for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `wkv6_btHN` in
// src/repro/kernels/wkv6/kernel.py:59 (pallas_call at :69), and computes
// the function of its oracle `wkv6_ref` (src/repro/kernels/wkv6/ref.py):
// for every (b, h), with S the (N, N) state,
//     y_t = r_t · (S_{t-1} + u ⊙ k_t v_tᵀ),   S_t = diag(e^{logw_t}) S_{t-1} + k_t v_tᵀ.
// The Pallas kernel starts from S = 0 and drops the final S; this one
// takes an optional initial S (which may alias the output S: each block
// reads its own slice of the state before it writes it) and writes the
// final S. r, k, v, logw (B, T, H, N), u (H, N), S (B, H, N, N), y
// (B, T, H, N), contiguous; r, k, v and u f32 or bf16 (converted in
// registers: the f32 function of their values), logw, S and y f32.
// N <= 64, chunk 1 <= L <= 64.
//
// What bounds it on this card: bytes. At the serve prefill (B 4, T 32, H
// 32, N 64) the call moves ~9.4 MB in f32 (r, k, v, logw, y, S in and
// out), 2.8 us at 3.35 TB/s, against 0.085 G f32 operations (1.3 us at
// 67 TFLOP/s); at T = 512, 88 MB (26 us) against 1.37 G (20 us); a
// decode step (T = 1) is the 4.2 MB of S read and written, 1.3 us. A
// block per (b, h) (128 blocks for 132 SMs) with a chain of thin phases
// is bound by its own latency instead, so the design spreads each (b, h)
// over several blocks by column slices of S and y (column m of S and y
// depend only on that column and the shared r, k, e^{logw}, u) and gives
// each block's phases enough independent work to cover their latency.
//
// Two paths, one launch each:
//  * streaming (T or L below one sub-chunk of 16 steps; every decode
//    step): the per-step recurrence with S in registers. A block holds 32
//    columns of one (b, h) (two blocks per head at N = 64); a warp holds
//    two column quads over every row, each lane 4 columns (16-byte loads
//    straight from device memory) by N / 16 rows, so y's sum over n is a
//    warp-shuffle butterfly in a fixed order and the path has no barrier.
//    A step's loads are issued while the previous step computes.
//  * chunked (T, L >= 16): the state is carried across chunks of the
//    largest multiple of L up to 64 steps (a chunk costs ~2.5 us fixed
//    whatever its length), each cut into sub-chunks of 16 (the last ones
//    zero-padded: a padded step has r = k = v = 0 and logw = 0, so it adds
//    nothing). In log2 units, with lc the cumsum of logw within each
//    sub-chunk, lcp_t its value a row up (0 on a sub-chunk's first row)
//    and tot_s sub-chunk s's total:
//      - within a sub-chunk, score[t, j] = Σ_n r_t k_j 2^{lcp_t − lc_j}
//        (j < t), a difference exponent <= 0, and score[t, t] = Σ r u k;
//      - across sub-chunks (t in s, j in s' < s) the exponent is split at
//        the sub-chunk boundaries, every factor <= 0, so nothing
//        overflows however strong the decay:
//          score[t, j] = Σ_n (r_t 2^{lcp_t}) (k_j 2^{tot_s' − lc_j})
//                            2^{tot_{s'+1} + ... + tot_{s−1}},
//        16 x 16 x N products;
//      - y_t = Σ_{j<=t} score[t, j] v_j + (r_t 2^{lcp_t} 2^{pre_s}) · S
//        (pre_s = tot_0 + ... + tot_{s−1}), and
//        S <- 2^{c_L} ⊙ S + Σ_j (k_j 2^{tot_s(j) − lc_j}) 2^{c_L − c_{e(s(j))}} v_jᵀ
//        (c_L the chunk's total), register-tiled products (4 x 4 a
//        thread, the contraction split over up to 16 lanes and summed by
//        a shuffle butterfly).
//    Every exponent is thus a sum of same-sign terms (logw <= 0) or a
//    difference within one sub-chunk, never a difference of chunk-long
//    cumsums, which at strong decay loses the small exponents' digits.
//    A block of 256 threads holds one column slice (16, 32 or 64 columns:
//    the widest while B·H fills half the SMs) of one (b, h) and walks its
//    chunks in three barrier-separated phases: (1) the chunk's inputs,
//    loaded into registers during the previous chunk, go to shared
//    memory with the cumsum (a 16-lane shuffle scan, a lane a step) and
//    every scaled operand; (2) the scores, within sub-chunks from the
//    last thread down and across them from the first up; (3) y, and the
//    new state into registers (written to shared memory at the next
//    chunk's start). Shared memory is sized by the walked chunk and T.
//    The products were also built on the tensor cores, mma.sync in
//    3xTF32: slower at T = 512 and outside the tolerance at logw = 0
//    (PERF.md), so the CUDA cores keep them.
// Every sum runs in a fixed order and nothing is atomic: a call repeats
// bitwise. The chunked path's exponentials are ex2.approx of log2-unit
// sums (~2 ulp); the streaming path takes expf(logw) a step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

extern "C" {
// The launch arguments, packed by kernel.py (`PARAMS`).
struct WkvParams {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const void* u;
  const float* s0;  // nullptr: zero initial state
  float* y;
  float* s_out;
  int B, T, H, N, L;
  int dtypes;  // bit 0, 1, 2, 3: r, k, v, u are bf16 (else f32)
};
}  // extern "C"
static_assert(sizeof(WkvParams) == 88, "PARAMS in kernel.py packs 88 bytes");

namespace {

using Params = WkvParams;
constexpr int kSub = 16;  // steps a sub-chunk
constexpr int kPairs = kSub * (kSub + 1) / 2;  // (t, j <= t) in a sub-chunk
constexpr int kMaxN = 64;
constexpr int kMaxL = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float ld1(const void* p, size_t i, bool bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

// Elements i..i+3 of a row with `left` elements from i on (<= 0: none);
// those past the row read as 0. `vec`: every row starts 16-byte (f32) or
// 8-byte (bf16) aligned and N % 4 == 0, so four load at once.
__device__ __forceinline__ float4 ld4(const void* p, size_t i, int left,
                                      bool bf, bool vec) {
  if (vec && left >= 4) {
    if (bf) {
      const uint2 w = *reinterpret_cast<const uint2*>(
          static_cast<const __nv_bfloat16*>(p) + i);
      const float2 a =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
      const float2 b =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
      return make_float4(a.x, a.y, b.x, b.y);
    }
    return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  }
  float4 o = zero4();
  if (left > 0) o.x = ld1(p, i, bf);
  if (left > 1) o.y = ld1(p, i + 1, bf);
  if (left > 2) o.z = ld1(p, i + 2, bf);
  if (left > 3) o.w = ld1(p, i + 3, bf);
  return o;
}

__device__ __forceinline__ void st4(float* p, size_t i, int left, bool vec,
                                    float4 x) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(p + i) = x;
    return;
  }
  if (left > 0) p[i] = x.x;
  if (left > 1) p[i + 1] = x.y;
  if (left > 2) p[i + 2] = x.z;
  if (left > 3) p[i + 3] = x.w;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void sts4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float get(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}
// 2^x by the SFU (ex2.approx.ftz: ~2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float4 exp2_4(float4 a) {
  return make_float4(ex2(a.x), ex2(a.y), ex2(a.z), ex2(a.w));
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 shfl4(float4 a, int src) {
  return make_float4(__shfl_sync(kFull, a.x, src), __shfl_sync(kFull, a.y, src),
                     __shfl_sync(kFull, a.z, src), __shfl_sync(kFull, a.w, src));
}
__device__ __forceinline__ float4 shfl_up4(float4 a, int d) {
  return make_float4(__shfl_up_sync(kFull, a.x, d),
                     __shfl_up_sync(kFull, a.y, d),
                     __shfl_up_sync(kFull, a.z, d),
                     __shfl_up_sync(kFull, a.w, d));
}
// acc[i][c] summed over the `parts` consecutive lanes of a group
__device__ __forceinline__ void reduce_parts(float (&acc)[4][4], int parts) {
  for (int off = 1; off < parts; off <<= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[i][c] += __shfl_xor_sync(kFull, acc[i][c], off);
}
// acc[i][c] += a[i] · b[c] over the four components (one fixed order)
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 (&a)[4],
                                       const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[i][c] = fmaf(a[i].x, b[c].x, acc[i][c]);
      acc[i][c] = fmaf(a[i].y, b[c].y, acc[i][c]);
      acc[i][c] = fmaf(a[i].z, b[c].z, acc[i][c]);
      acc[i][c] = fmaf(a[i].w, b[c].w, acc[i][c]);
    }
}
// acc[i][c] += Σ_q a[i].q b[q].c: a's rows against b's rows as columns
__device__ __forceinline__ void mac4(float (&acc)[4][4], const float4 (&a)[4],
                                     const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x = get(a[i], q);
      acc[i][0] = fmaf(x, b[q].x, acc[i][0]);
      acc[i][1] = fmaf(x, b[q].y, acc[i][1]);
      acc[i][2] = fmaf(x, b[q].z, acc[i][2]);
      acc[i][3] = fmaf(x, b[q].w, acc[i][3]);
    }
}

// ---- streaming path: the per-step recurrence, S in registers ----

template <int kNP>  // N rounded up to 16, 32 or 64
struct Stream {
  static constexpr int kCW = kNP < 32 ? kNP : 32;  // columns a block
  static constexpr int kQW = 2;           // column quads a warp
  static constexpr int kG = 32 / kQW;     // row groups: a warp holds all n
  static constexpr int kRows = kNP / kG;  // rows a lane
  static constexpr int kWarps = kCW / 4 / kQW;
  static constexpr int kThreads = 32 * kWarps;
};

// kR consecutive values from i on, those at or past `left` zero
template <int kR>
__device__ __forceinline__ void ld_rows(float (&x)[kR], const void* p,
                                        size_t i, int left, bool bf,
                                        bool vec) {
  if constexpr (kR == 4) {
    const float4 v = ld4(p, i, left, bf, vec);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kR; ++j) x[j] = j < left ? ld1(p, i + j, bf) : 0.f;
  }
}

template <int kR>
struct StepIn {  // one step's inputs of a lane: its rows of r, k, logw
  float r[kR], k[kR], lw[kR];  // and its column quad of v
  float4 v;
};

template <int kNP>
__global__ void __launch_bounds__(Stream<kNP>::kThreads)
    wkv6_stream(Params p, int vec, int nslices) {
  using C = Stream<kNP>;
  constexpr int kR = C::kRows;
  const int N = p.N, H = p.H, T = p.T;
  const int h = blockIdx.x / nslices;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qw = lane % C::kQW, rg = lane / C::kQW;
  const int m0 =
      (blockIdx.x - h * nslices) * C::kCW + 4 * (warp * C::kQW + qw);
  const int n0 = rg * kR;
  const size_t b = blockIdx.y;
  const bool bf_r = p.dtypes & 1, bf_k = p.dtypes & 2, bf_v = p.dtypes & 4,
             bf_u = p.dtypes & 8;
  const size_t sbase = (b * H + h) * N * N;
  // rows past N read r = k = logw = 0: their S stays 0 and adds nothing
  float4 S[kR];
  float uu[kR];
  ld_rows<kR>(uu, p.u, static_cast<size_t>(h) * N + n0, N - n0, bf_u, vec);
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int n = n0 + i;
    S[i] = (p.s0 && n < N)
               ? ld4(p.s0, sbase + static_cast<size_t>(n) * N + m0, N - m0,
                     false, vec)
               : zero4();
  }
  auto load = [&](int t, StepIn<kR>& x) {
    const size_t row = ((b * T + t) * H + h) * N;
    ld_rows<kR>(x.r, p.r, row + n0, N - n0, bf_r, vec);
    ld_rows<kR>(x.k, p.k, row + n0, N - n0, bf_k, vec);
    ld_rows<kR>(x.lw, p.logw, row + n0, N - n0, false, vec);
    x.v = ld4(p.v, row + m0, N - m0, bf_v, vec);
  };
  StepIn<kR> cur, nxt;
  load(0, cur);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) load(t + 1, nxt);  // the next step's loads in flight
    const float4 v4 = cur.v;
    float4 acc = zero4();
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float rr = cur.r[i], kk = cur.k[i], w = expf(cur.lw[i]);
      const float uk = uu[i] * kk;
      // y += r (S + u k v);  S <- w S + k v
      acc.x = fmaf(rr, fmaf(uk, v4.x, S[i].x), acc.x);
      acc.y = fmaf(rr, fmaf(uk, v4.y, S[i].y), acc.y);
      acc.z = fmaf(rr, fmaf(uk, v4.z, S[i].z), acc.z);
      acc.w = fmaf(rr, fmaf(uk, v4.w, S[i].w), acc.w);
      S[i].x = fmaf(w, S[i].x, kk * v4.x);
      S[i].y = fmaf(w, S[i].y, kk * v4.y);
      S[i].z = fmaf(w, S[i].z, kk * v4.z);
      S[i].w = fmaf(w, S[i].w, kk * v4.w);
    }
    // y's sum over n: the warp's row groups (lanes kQW apart), a shuffle
    // butterfly in a fixed order; no barrier
#pragma unroll
    for (int off = C::kQW; off < 32; off <<= 1) {
      acc.x += __shfl_xor_sync(kFull, acc.x, off);
      acc.y += __shfl_xor_sync(kFull, acc.y, off);
      acc.z += __shfl_xor_sync(kFull, acc.z, off);
      acc.w += __shfl_xor_sync(kFull, acc.w, off);
    }
    if (rg == 0)
      st4(p.y, ((b * T + t) * H + h) * N + m0, N - m0, vec, acc);
    cur = nxt;
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int n = n0 + i;
    if (n < N)
      st4(p.s_out, sbase + static_cast<size_t>(n) * N + m0, N - m0, vec, S[i]);
  }
}

// ---- chunked path: sub-chunks of 16, column slices ----

template <int kNP, int kCW>
struct Chunked {
  static constexpr int kThreads = 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int P = kNP + 4;   // pitch of the [t][n] buffers, floats
  static constexpr int PV = kCW + 4;  // pitch of V ([t][m]) and S ([n][m])
  static constexpr int kNQ = kNP / 4;  // n quads
  static constexpr int kMQ = kCW / 4;  // m quads of the slice
  static constexpr int kQI = (kNQ + kWarps - 1) / kWarps;  // quads a warp
  // v quads a thread loads, and the state update's 4 x 4 tiles and the
  // lanes that split each tile's sum
  static constexpr int kVI = (kMaxL * kMQ + kThreads - 1) / kThreads;
  static constexpr int kSTiles = kNQ * kMQ;
  static constexpr int kSParts = kThreads / kSTiles >= 4 ? 4
                                                        : kThreads / kSTiles;
  // shared floats for chunks of up to LP (a multiple of 16) rows: r, k,
  // c (raw), r 2^{lcp}, k 2^{tot - lc}; the scores; V; the state slice;
  // u, 2^{c_L}, the bridge factors G of the sub-chunk pairs (2, 0),
  // (3, 0), (3, 1), the state-update factors Hs and the prefix factors
  // PRE of the four sub-chunks
  static constexpr size_t floats(int LP) {
    return static_cast<size_t>(5 * LP * P + LP * (LP + 4) + LP * PV +
                               kNP * PV + kNP * (2 + 3 + 4 + 4));
  }
};

template <int kNP, int kCW>
__global__ void __launch_bounds__(Chunked<kNP, kCW>::kThreads, 1)
    wkv6_chunked(Params p, int vec, int nslices, int LPm) {
  using C = Chunked<kNP, kCW>;
  constexpr int P = C::P, PV = C::PV, kNQ = C::kNQ, kMQ = C::kMQ;
  constexpr int kT = C::kThreads;
  extern __shared__ float4 smem4[];
  float* R = reinterpret_cast<float*>(smem4);  // r
  float* K = R + LPm * P;    // k
  float* Cs = K + LPm * P;   // local cumsum of logw (log2 units)
  float* RH = Cs + LPm * P;  // r 2^{lcp}
  float* KB = RH + LPm * P;  // k 2^{tot - lc}
  float* SC = KB + LPm * P;  // scores [t][j], pitch PS
  const int PS = LPm + 4;
  float* V = SC + LPm * PS;  // v slice [t][m]
  float* S = V + LPm * PV;   // state slice [n][m]
  float* U = S + kNP * PV;
  float* ECL = U + kNP;
  float* G = ECL + kNP;
  float* Hs = G + 3 * kNP;
  float* PRE = Hs + 4 * kNP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = p.N, H = p.H, T = p.T, L = p.L;
  const int h = blockIdx.x / nslices;
  const int mb = (blockIdx.x - h * nslices) * kCW;  // the slice's first column
  const size_t b = blockIdx.y;
  const bool bf_r = p.dtypes & 1, bf_k = p.dtypes & 2, bf_v = p.dtypes & 4,
             bf_u = p.dtypes & 8;
  const size_t trow = static_cast<size_t>(H) * N;  // stride of t
  const size_t base = (b * T * H + h) * N;
  const size_t sbase = (b * H + h) * N * N;

  // the state update's tile (n0.., m0..) of this thread, and its part
  const int s_tile = tid / C::kSParts, s_part = tid - s_tile * C::kSParts;
  const bool s_lane = s_tile < C::kSTiles;  // warp-uniform
  const int s_n = 4 * (s_tile / kMQ), s_m = 4 * (s_tile % kMQ);
  // the new state of that tile (valid on part 0): first the initial one
  float4 snew[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    snew[i] = (s_lane && s_part == 0 && p.s0 && s_n + i < N)
                  ? ld4(p.s0, sbase + static_cast<size_t>(s_n + i) * N + mb +
                                  s_m, N - mb - s_m, false, vec)
                  : zero4();
  for (int n = tid; n < kNP; n += kT)
    U[n] = n < N ? ld1(p.u, static_cast<size_t>(h) * N + n, bf_u) : 0.f;

  // a chunk's inputs, loaded into registers a chunk ahead: a warp takes
  // a column quad, a lane a row (lane, lane + 32) of r, k and logw; each
  // thread kVI quads of v's slice
  float4 rv[C::kQI][2], kv[C::kQI][2], cv[C::kQI][2], vv[C::kVI];
  auto load_chunk = [&](int t0) {
    const int Lc = min(L, T - t0);
#pragma unroll
    for (int qi = 0; qi < C::kQI; ++qi) {
      const int n = 4 * (warp + C::kWarps * qi);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = lane + 32 * hf;
        rv[qi][hf] = kv[qi][hf] = cv[qi][hf] = zero4();
        if (t < Lc && n < kNP) {
          const size_t gi = base + static_cast<size_t>(t0 + t) * trow + n;
          rv[qi][hf] = ld4(p.r, gi, N - n, bf_r, vec);
          kv[qi][hf] = ld4(p.k, gi, N - n, bf_k, vec);
          cv[qi][hf] = ld4(p.logw, gi, N - n, false, vec);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < C::kVI; ++i) {
      const int e = tid + kT * i, t = e / kMQ, m = mb + 4 * (e % kMQ);
      vv[i] = t < Lc ? ld4(p.v, base + static_cast<size_t>(t0 + t) * trow + m,
                           N - m, bf_v, vec)
                     : zero4();
    }
  };
  load_chunk(0);

  for (int t0 = 0; t0 < T; t0 += L) {
    const int Lc = min(L, T - t0);
    const int NS = (Lc + kSub - 1) / kSub;
    const int LP = NS * kSub;
    __syncthreads();  // the previous chunk is done with every buffer

    // Phase 1. The state the previous chunk left in registers (or the
    // initial one) into S; r, k, v and the cumsum of logw within each
    // sub-chunk (a 16-lane shuffle scan) into R, K, V, C; from the same
    // registers the scaled operands. With lc the local cumsum, lcp its
    // value a row up (0 on a sub-chunk's first row) and tot_s sub-chunk
    // s's total, every exponent is a sum of same-sign terms (logw <= 0)
    // or a difference within one sub-chunk: RH = r 2^{lcp}, KB = k
    // 2^{tot - lc}; c_{t-1} = pre_s + lcp_t, c_L = Σ tot (sub-chunks past
    // the chunk total 0). Then the next chunk's loads are issued.
    if (s_lane && s_part == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) sts4(S + (s_n + i) * PV + s_m, snew[i]);
#pragma unroll
    for (int i = 0; i < C::kVI; ++i) {
      const int e = tid + kT * i, t = e / kMQ;
      if (t < LP) sts4(V + t * PV + 4 * (e % kMQ), vv[i]);
    }
#pragma unroll
    for (int qi = 0; qi < C::kQI; ++qi) {
      // every lane runs the shuffles (warps past the quads on zeros), so
      // they stay in converged code
      const int n = 4 * (warp + C::kWarps * qi);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float4 c4 = cv[qi][hf];
        c4 = make_float4(c4.x * kLog2e, c4.y * kLog2e, c4.z * kLog2e,
                         c4.w * kLog2e);
#pragma unroll
        for (int off = 1; off < kSub; off <<= 1) {
          const float4 x = shfl_up4(c4, off);
          if ((lane & (kSub - 1)) >= off) c4 = add4(c4, x);
        }
        cv[qi][hf] = c4;
      }
      const float4 tot0 = shfl4(cv[qi][0], 15), tot1 = shfl4(cv[qi][0], 31);
      const float4 tot2 = shfl4(cv[qi][1], 15), tot3 = shfl4(cv[qi][1], 31);
      const bool upper = lane >= kSub;  // the odd sub-chunk of a half
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = lane + 32 * hf;
        float4 lcp = shfl_up4(cv[qi][hf], 1);
        if ((lane & (kSub - 1)) == 0) lcp = zero4();
        const float4 tot = hf ? (upper ? tot3 : tot2) : (upper ? tot1 : tot0);
        if (t < LP && n < kNP) {
          const float4 r4 = rv[qi][hf], k4 = kv[qi][hf], c4 = cv[qi][hf];
          sts4(R + t * P + n, r4);
          sts4(K + t * P + n, k4);
          sts4(Cs + t * P + n, c4);
          sts4(RH + t * P + n, mul4(r4, exp2_4(lcp)));
          sts4(KB + t * P + n, mul4(k4, exp2_4(sub4(tot, c4))));
        }
      }
      // the per-sub-chunk factors, one vector a lane: 2^{c_L}; PRE_s =
      // 2^{pre_s}; Hs_s = 2^{c_L - c_{e(s)}}; G for the pairs (2, 0),
      // (3, 0), (3, 1)
      if (lane < 12 && n < kNP) {
        const float4 pre2 = add4(tot0, tot1), pre3 = add4(pre2, tot2);
        const float4 suf1 = add4(tot3, tot2);
        float4 x;
        float* dst;
        switch (lane) {
          case 0: x = add4(pre3, tot3); dst = ECL; break;
          case 1: x = zero4(); dst = PRE; break;
          case 2: x = tot0; dst = PRE + kNP; break;
          case 3: x = pre2; dst = PRE + 2 * kNP; break;
          case 4: x = pre3; dst = PRE + 3 * kNP; break;
          case 5: x = add4(suf1, tot1); dst = Hs; break;
          case 6: x = suf1; dst = Hs + kNP; break;
          case 7: x = tot3; dst = Hs + 2 * kNP; break;
          case 8: x = zero4(); dst = Hs + 3 * kNP; break;
          case 9: x = tot1; dst = G; break;
          case 10: x = add4(tot1, tot2); dst = G + kNP; break;
          default: x = tot2; dst = G + 2 * kNP; break;
        }
        sts4(dst + n, exp2_4(x));
      }
    }
    if (t0 + L < T) load_chunk(t0 + L);
    __syncthreads();  // phase 1 is written

    // Phase 2a: the scores within each sub-chunk, the 136 (t, j <= t)
    // pairs of each sub-chunk's lower triangle in row order, one a thread
    // at a time from the last thread down, over every n (two
    // accumulators), pairwise difference exponents; zeros above the
    // diagonal
    for (int it = kT - 1 - tid; it < NS * kPairs; it += kT) {
      const int s = it / kPairs, e = it - s * kPairs;
      int tl = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
      if ((tl + 1) * (tl + 2) / 2 <= e) ++tl;  // the float root's rounding
      if (tl * (tl + 1) / 2 > e) --tl;
      const int t = kSub * s + tl, j = kSub * s + e - tl * (tl + 1) / 2;
      float acc0 = 0.f, acc1 = 0.f;
      if (j < t) {
        for (int n = 0; n < kNP; n += 4) {
          const float4 r4 = lds4(R + t * P + n), k4 = lds4(K + j * P + n);
          const float4 d = exp2_4(
              sub4(lds4(Cs + (t - 1) * P + n), lds4(Cs + j * P + n)));
          acc0 = fmaf(r4.x * k4.x, d.x, acc0);
          acc1 = fmaf(r4.y * k4.y, d.y, acc1);
          acc0 = fmaf(r4.z * k4.z, d.z, acc0);
          acc1 = fmaf(r4.w * k4.w, d.w, acc1);
        }
      } else {
        for (int n = 0; n < kNP; n += 4) {
          const float4 r4 = lds4(R + t * P + n), k4 = lds4(K + t * P + n);
          const float4 u4 = lds4(U + n);
          acc0 = fmaf(r4.x * u4.x, k4.x, acc0);
          acc1 = fmaf(r4.y * u4.y, k4.y, acc1);
          acc0 = fmaf(r4.z * u4.z, k4.z, acc0);
          acc1 = fmaf(r4.w * u4.w, k4.w, acc1);
        }
      }
      SC[t * PS + j] = acc0 + acc1;
    }
    for (int it = tid; it < NS * kSub * kSub; it += kT) {
      const int s = it / (kSub * kSub), tl = (it / kSub) % kSub,
                jl = it % kSub;
      if (jl > tl) SC[(kSub * s + tl) * PS + kSub * s + jl] = 0.f;
    }

    // Phase 2b: the scores across sub-chunks (t in s, j in s' < s), 4 x 4
    // tiles of 16 x 16 x N products RH_t · (KB_j ⊙ G_{s,s'}), the n quads
    // split over `parts` lanes and summed by a shuffle butterfly
    if (NS > 1) {
      const int tiles = 8 * NS * (NS - 1);
      int parts = 1;
      while (parts < kNQ && tiles * parts * 2 <= kT) parts *= 2;
      const int tile = tid / parts, part = tid - tile * parts;
      float acc[4][4] = {};
      int t = 0, jq = 0;
      if (tile < tiles) {
        int s = 1, rem = tile;
        while (rem >= 16 * s) {
          rem -= 16 * s;
          ++s;
        }
        const int tq = rem / (4 * s);
        jq = rem - tq * 4 * s;
        const int sp = jq >> 2;  // the sub-chunk of j
        const float* g =
            sp == s - 1 ? nullptr : G + ((s - 2) * (s - 1) / 2 + sp) * kNP;
        t = kSub * s + 4 * tq;
        for (int nq = part; nq < kNQ; nq += parts) {
          const int n = 4 * nq;
          float4 a[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = lds4(RH + (t + i) * P + n);
#pragma unroll
          for (int i = 0; i < 4; ++i) bb[i] = lds4(KB + (4 * jq + i) * P + n);
          if (g) {
            const float4 g4 = lds4(g + n);
#pragma unroll
            for (int i = 0; i < 4; ++i) bb[i] = mul4(bb[i], g4);
          }
          outer4(acc, a, bb);
        }
      }
      reduce_parts(acc, parts);  // every lane: converged shuffles
      if (tile < tiles && part == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sts4(SC + (t + i) * PS + 4 * jq,
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
    __syncthreads();  // every score is written

    // Phase 3a: y = score · v + (RH ⊙ 2^{pre_s}) · S, 4 x 4 tiles of
    // (t, m), the sum split over `parts` lanes
    {
      const int tiles = (LP / 4) * kMQ;
      int parts = 1;
      while (parts < 16 && tiles * parts * 2 <= kT) parts *= 2;
      const int tile = tid / parts, part = tid - tile * parts;
      const int tq = tile / kMQ, mq = tile - tq * kMQ;
      const int t = 4 * tq, m = 4 * mq;
      float acc[4][4] = {};
      if (tile < tiles) {
        const float* pre = PRE + (t / kSub) * kNP;
        for (int jq = part; jq <= tq; jq += parts) {
          float4 a[4], vb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = lds4(SC + (t + i) * PS + 4 * jq);
#pragma unroll
          for (int i = 0; i < 4; ++i) vb[i] = lds4(V + (4 * jq + i) * PV + m);
          mac4(acc, a, vb);
        }
        for (int nq = part; nq < kNQ; nq += parts) {
          float4 a[4], sb[4];
          const float4 e4 = lds4(pre + 4 * nq);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = mul4(lds4(RH + (t + i) * P + 4 * nq), e4);
#pragma unroll
          for (int i = 0; i < 4; ++i) sb[i] = lds4(S + (4 * nq + i) * PV + m);
          mac4(acc, a, sb);
        }
      }
      reduce_parts(acc, parts);  // every lane: converged shuffles
      if (tile < tiles && part == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (t + i < Lc)
            st4(p.y, base + static_cast<size_t>(t0 + t + i) * trow + mb + m,
                N - mb - m, vec,
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }

    // Phase 3b: the new state, into registers (S is read by 3a and
    // written at the next chunk's start): 2^{c_L} S + Σ_s Hs_s
    // Σ_{j in s} KB_j v_jᵀ, 4 x 4 tiles of (n, m)
    {
      float acc[4][4] = {};
      for (int s = 0; s < (s_lane ? NS : 0); ++s) {
        float tmp[4][4] = {};
        for (int jl = s_part; jl < 4; jl += C::kSParts) {
          const int j0 = kSub * s + 4 * jl;
          float4 kT4[4], vb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) kT4[i] = lds4(KB + (j0 + i) * P + s_n);
#pragma unroll
          for (int i = 0; i < 4; ++i) vb[i] = lds4(V + (j0 + i) * PV + s_m);
          // tmp[i][c] += Σ_jj kT4[jj].i vb[jj].c
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float x = get(kT4[jj], i);
              tmp[i][0] = fmaf(x, vb[jj].x, tmp[i][0]);
              tmp[i][1] = fmaf(x, vb[jj].y, tmp[i][1]);
              tmp[i][2] = fmaf(x, vb[jj].z, tmp[i][2]);
              tmp[i][3] = fmaf(x, vb[jj].w, tmp[i][3]);
            }
        }
        const float4 h4 = lds4(Hs + s * kNP + s_n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][c] = fmaf(get(h4, i), tmp[i][c], acc[i][c]);
      }
      reduce_parts(acc, C::kSParts);  // every lane: converged shuffles
      if (s_lane) {
        const float4 e4 = lds4(ECL + s_n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 s4 = lds4(S + (s_n + i) * PV + s_m);
          const float e = get(e4, i);
          snew[i] = make_float4(
              fmaf(e, s4.x, acc[i][0]), fmaf(e, s4.y, acc[i][1]),
              fmaf(e, s4.z, acc[i][2]), fmaf(e, s4.w, acc[i][3]));
        }
      }
    }
  }
  if (s_lane && s_part == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (s_n + i < N)
        st4(p.s_out, sbase + static_cast<size_t>(s_n + i) * N + mb + s_m,
            N - mb - s_m, vec, snew[i]);
}

// ---- launchers ----

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

int slices(int N, int cw) { return (N + cw - 1) / cw; }

template <int kNP>
cudaError_t launch_stream(const Params& p, int vec, cudaStream_t st) {
  using C = Stream<kNP>;
  const int ns = slices(p.N, C::kCW);
  if (static_cast<long long>(p.H) * ns > INT_MAX) return cudaErrorInvalidValue;
  wkv6_stream<kNP><<<dim3(p.H * ns, p.B), C::kThreads, 0, st>>>(p, vec, ns);
  return cudaGetLastError();
}

template <int kNP, int kCW>
cudaError_t launch_chunked(const Params& p, int vec, cudaStream_t st) {
  // p.L here is the chunk the kernel walks (see wkv6_btHN)
  using C = Chunked<kNP, kCW>;
  static bool configured = false;  // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_chunked<kNP, kCW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * C::floats(kMaxL)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int LP = (min(p.L, p.T) + kSub - 1) / kSub * kSub;
  const int ns = slices(p.N, kCW);
  if (static_cast<long long>(p.H) * ns > INT_MAX) return cudaErrorInvalidValue;
  wkv6_chunked<kNP, kCW><<<dim3(p.H * ns, p.B), C::kThreads,
                           sizeof(float) * C::floats(LP), st>>>(p, vec, ns,
                                                                 LP);
  return cudaGetLastError();
}

// The column-slice width of the chunked path: the widest slice (no score
// recomputed by another block) while B·H blocks fill half the SMs or
// more, narrower below (launch/profile_wkv.py measures every width).
int choose_cw(int np, long long BH) {
  const int cw = BH >= 64 ? 64 : BH >= 32 ? 32 : 16;
  return cw < np ? cw : np;
}

}  // namespace

extern "C" {

// One launch on `stream`; allocates nothing. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape or dtype set it
// does not take.
int wkv6_btHN(const WkvParams* pp, void* stream) {
  const Params& p = *pp;
  if (p.B <= 0 || p.B > 65535 || p.T <= 0 || p.H <= 0 || p.N <= 0 ||
      p.N > kMaxN || p.L <= 0 || p.L > kMaxL || (p.dtypes & ~15))
    return cudaErrorInvalidValue;
  const int np = p.N <= 16 ? 16 : p.N <= 32 ? 32 : 64;
  const bool bf_r = p.dtypes & 1, bf_k = p.dtypes & 2, bf_v = p.dtypes & 4,
             bf_u = p.dtypes & 8;
  const int vec =
      p.N % 4 == 0 && aligned(p.r, bf_r ? 8 : 16) &&
      aligned(p.k, bf_k ? 8 : 16) && aligned(p.v, bf_v ? 8 : 16) &&
      aligned(p.u, bf_u ? 8 : 16) && aligned(p.logw, 16) &&
      (!p.s0 || aligned(p.s0, 16)) && aligned(p.y, 16) &&
      aligned(p.s_out, 16);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.T < kSub || p.L < kSub) {
    switch (np) {
      case 16: return launch_stream<16>(p, vec, st);
      case 32: return launch_stream<32>(p, vec, st);
      default: return launch_stream<64>(p, vec, st);
    }
  }
  // A chunk costs the chunked path a fixed ~2.5 us whatever its length
  // (launch/profile_wkv.py), so the state is carried across the largest
  // multiple of the caller's chunk that fits one stage of 64 steps: the
  // same function, fewer chunks.
  Params q = p;
  q.L = kMaxL / p.L * p.L;
  const int cw = choose_cw(np, static_cast<long long>(p.B) * p.H);
  switch (np * 100 + cw) {
    case 1616: return launch_chunked<16, 16>(q, vec, st);
    case 3216: return launch_chunked<32, 16>(q, vec, st);
    case 3232: return launch_chunked<32, 32>(q, vec, st);
    case 6416: return launch_chunked<64, 16>(q, vec, st);
    case 6432: return launch_chunked<64, 32>(q, vec, st);
    case 6464: return launch_chunked<64, 64>(q, vec, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
