// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_attention_hsd` in
// src/repro/kernels/flash_attention/kernel.py:77 (pallas_call at :96):
// online-softmax grouped-query attention, query head h reads kv head
// h / G, scale D^-0.5, masks `causal` (kpos <= qpos), `window` (kpos >
// qpos - window) and `valid_len` (kpos < valid_len), f32 accumulation,
// output in q's dtype. The kernel reads the model's (B, S, KVH, G, D)
// layout through strides, masks the ragged edge itself and allocates
// nothing: one launch, no padding copy, no transposes, no scratch. Each
// row only visits keys in [window lower limit, causal upper limit), and a
// block's tile loop runs over the union of its rows' ranges, so fully
// masked tiles are never loaded.
//
// bfloat16, on the tensor cores (flash_fwd_tc): what bounds it on this
// card is, at the LM prefill path's shapes (batch 4, prompt 32), neither
// bytes (0.2-0.6 us at 3.35 TB/s) nor operations (~0.02 us at the bf16
// peak) but the latency of one short block; at a 2048-token prefill, the
// tensor cores (4 D S^2 H / 2 operations, 8-17 us at 989 TFLOP/s against
// ~1 us of bytes). One block per (kv head, batch, query tile): its rows
// are (query, head) pairs r = qpos * G + g of the G query heads that read
// that kv head, so K/V are staged once per group and query tile, not G
// times; a group of at most 128 rows (S = 32 at G <= 3) is one block of
// 8 warps. Warp w owns rows 16w..16w+15 and computes S = Q K^T and O +=
// P V as mma.sync.m16n8k16 (bf16 in, f32 sums). Q is staged once; K and V
// tiles of BN keys come in by 16-byte cp.async into shared-memory rows
// padded by 16 bytes (ldmatrix reads 8 rows in 8 distinct bank groups),
// double-buffered: tile i + 1 loads while tile i is computed. K's
// fragments come by ldmatrix, V's by ldmatrix.trans, Q's once into
// registers or per tile from shared memory (QR). The online softmax (FA2)
// runs on the S accumulators in f32 registers: each lane holds two rows,
// the row max and sum reduce over the 4 lanes of a quad, exponentials are
// ex2.approx of scores in log2 units, O is rescaled only when a row max
// moved. P is rounded to bf16 for the P V product, as in any tensor-core
// flash kernel (the row sum l is of the f32 p); the scale is applied to
// the f32 scores (the reference scales q before the product: the two
// round apart). A warp skips a tile outside all its rows' ranges; masks
// are applied only to tiles that cross a row's range edge. The blocks
// start from the last query tile down, the heaviest under a causal mask
// first. Longer groups take per-head-dim tiles (dispatch_tc_d): 4 warps
// and 128 keys at D = 32, 8 warps and 128 keys at D = 64, 4 warps and 64
// keys at D = 128 (Q from shared memory, 3 blocks an SM) and D = 256.
// Inputs whose base or strides are not 16-byte multiples (cp.async needs
// them), or more than 65535 query tiles per group, take the CUDA-core
// kernel below in bf16 (flash_fwd<__nv_bfloat16>: a block of 4 warps per
// (query tile of 16 rows, head, batch), K/V tiles of 32 keys in shared
// memory, lane j a key for the scores and lane i D / 32 output columns
// for P V).
//
// float32: every product and sum f32 on the CUDA cores (no TF32, as the
// port's f32 reference requires). The policy trunk serves at (B = bucket
// <= 32, H = 4 over KVH = 2, S = 4 or 3, D = 64): a call moves a few
// hundred KB at most and launch latency and one global round trip bound
// it. Where every row's keys lie in [0, kv_end) with kv_end <= 32 (every
// trunk call), the caller picks the short-span kernels (below: one tile
// of keys, one round trip of 16-byte loads; flash_short_reg_f32 keeps
// each lane's share of Q, K and V in registers up to 4 keys at D <= 128,
// the trunk's calls, and flash_short_f32, one key a lane, stages K/V once
// per kv-head group in shared memory for the rest). Longer spans take
// flash_fwd_f32 (below), the f32 forward of the LM prefills served in f32
// (launch/serve.py's default dtype). What bounds it on this card is FMA
// issue on the CUDA cores (4 D operations a kept (query, key) pair at 67
// TFLOP/s) at every LM prefill shape but the shortest, where the bytes
// (each operand read once at 3.35 TB/s) and the latency of one block's
// chain of tiles do; its design keeps the FMA pipes fed from shared
// memory: rows are the (query, head) pairs of one kv head's group, as in
// flash_fwd_tc, so K/V tiles are read once per group and row tile; they
// come in by cp.async, double-buffered (or K and V in turn, each loading
// while the other is consumed); each lane holds a register tile of scores
// (TR rows x BN / 8 keys from 16-byte shared reads) and of O (TR rows x
// D / 8 dims); P goes through the warp's own rows of shared memory.
//
// The f32 kernels' arithmetic, shared so that on a span of at most 32 keys
// from key 0 flash_fwd_f32 gives the short-span kernels' bits: q is scaled
// (q * scale, rounded) before the product; each score is one FMA chain
// over d ascending from 0; m is the row max and p = expf(s - m); l sums a
// tile's p over the key index's bits from the highest down (on 32 keys:
// keys differing in bit 4 first, then bits 3, 2, 1, 0; a wider tile's
// upper keys, +0 on such a span, first); O = sum of fma(p_j, v_j, .) over
// j ascending; o = O * (1 / max(l, 1e-30)). No TF32, no ex2.approx, no
// __expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../shared/csrc/sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockM = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockN = 32;                      // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, KVH, S, kv_end, causal, window;
  float scale;
  // element strides of the batch, head and sequence dims; the head dim
  // (last) is contiguous in every operand
  int64_t q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  // each row's log-sum-exp m + log l (of the scaled scores), f32
  // (B, H, S) contiguous, written by the short-span kernels where set
  // (the training forward; the backward kernel reads it); null to skip
  float* lse;
};

// lse[b, h, qpos] = m + log l: -inf for a row with no key (m = -inf, l = 0)
__device__ __forceinline__ void store_lse(const Args& a, int b, int h,
                                          int qpos, float m, float l) {
  a.lse[(int64_t(b) * a.H + h) * a.S + qpos] = m + logf(l);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBlockM) * D + size_t(kBlockN) * (D + 1) + size_t(kBlockN) * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd(Args a) {
  constexpr int kPer = D / 32;    // output columns per lane
  constexpr int kKStride = D + 1;  // padded K row
  extern __shared__ float smem[];
  float* sQ = smem;                      // [kBlockM][D], scaled by D^-0.5
  float* sK = sQ + kBlockM * D;          // [kBlockN][D + 1]
  float* sV = sK + kBlockN * kKStride;   // [kBlockN][D]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const T* q = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
  const T* k = static_cast<const T*>(a.k) + b * a.k_b + kvh * a.k_h;
  const T* v = static_cast<const T*>(a.v) + b * a.v_b + kvh * a.v_h;
  T* o = static_cast<T*>(a.o) + b * a.o_b + h * a.o_h;

  for (int i = tid; i < kBlockM * D; i += kWarps * 32) {
    const int r = i / D, d = i - (i / D) * D, qpos = q0 + r;
    sQ[i] = qpos < a.S ? load_f32(q + qpos * a.q_s + d) * a.scale : 0.f;
  }

  // each row's key range [lo, hi); an empty range marks a row past S
  int row[kRowsPerWarp], lo[kRowsPerWarp], hi[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPer];
  bool warp_active = false;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    row[r] = r * kWarps + warp;
    const int qpos = q0 + row[r];
    if (qpos < a.S) {
      lo[r] = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
      hi[r] = a.causal ? min(qpos + 1, a.kv_end) : a.kv_end;
    } else {
      lo[r] = 0;
      hi[r] = 0;
    }
    warp_active |= lo[r] < hi[r];
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[r][i] = 0.f;
  }

  // the block's key range: the union of its rows' ranges
  const int q_last = min(q0 + kBlockM, a.S) - 1;
  const int blk_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int blk_hi = a.causal ? min(q_last + 1, a.kv_end) : a.kv_end;

  for (int t0 = blk_lo; t0 < blk_hi; t0 += kBlockN) {
    const int n = min(kBlockN, blk_hi - t0);
    __syncthreads();  // the previous tile is consumed (and sQ is staged)
    for (int i = tid; i < kBlockN * D; i += kWarps * 32) {
      const int j = i / D, d = i - (i / D) * D;
      const bool in = j < n;
      sK[j * kKStride + d] = in ? load_f32(k + (t0 + j) * a.k_s + d) : 0.f;
      sV[i] = in ? load_f32(v + (t0 + j) * a.v_s + d) : 0.f;
    }
    __syncthreads();
    if (!warp_active) continue;  // warp-uniform: all rows past S

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[lane * kKStride + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(sQ[row[r] * D + d], kd, s[r]);
    }

    const int key = t0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool valid = key >= lo[r] && key < hi[r];
      const float tmax = warp_max(valid ? s[r] : -INFINITY);
      if (tmax == -INFINITY) {  // warp-uniform: no key of this row here
        p[r] = 0.f;
        continue;
      }
      const float m_new = fmaxf(m[r], tmax);
      const float alpha = expf(m[r] - m_new);
      p[r] = valid ? expf(s[r] - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[r][i] *= alpha;
    }

    for (int j = 0; j < n; ++j) {
      float vj[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) vj[i] = sV[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + row[r];
    if (qpos >= a.S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      store_f32(o + qpos * a.o_s + lane + 32 * i, acc[r][i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((a.S + kBlockM - 1) / kBlockM, a.H, B);
  flash_fwd<T, D><<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- float32, a short key span: flash_short_f32 ----

constexpr int kShortSpan = 32;     // the longest key range it takes
constexpr int kShortWarps = 8;
constexpr int kShortThreads = kShortWarps * 32;
constexpr int kShortRows = 16;     // most rows of a block: two a warp
constexpr int kShortGroupRows = 8; // rows a block gathers from small groups

// 4 bytes global -> shared (the path for operands that are not 16-byte
// aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(sm90::smem_addr(dst)), "l"(src)
               : "memory");
}

// Blocks of a short-span launch: NG whole (kv head, batch) groups of M =
// S * G rows a block when M is at most 4 (up to 8 rows), else one group's
// rows in tiles of up to 16.
struct ShortPlan {
  int ng, tiles;
  int64_t blocks;
};

ShortPlan short_plan(int B, int KVH, int M) {
  const int ng = M <= kShortGroupRows / 2 ? kShortGroupRows / M : 1;
  const int tiles = M > kShortRows ? (M + kShortRows - 1) / kShortRows : 1;
  const int64_t groups = int64_t(B) * KVH;
  return {ng, tiles, (groups + ng - 1) / ng * tiles};
}

// f32, every row's keys inside [0, kv_end) with kv_end <= 32: one tile of
// keys, so the softmax needs no online rescale. Rows are the (query, head)
// pairs r = qpos * G + g of the G query heads of one kv head; K and V are
// staged once per group. The block's Q rows, K and V come in by cp.async
// (16 bytes where every base and stride allows it, else 4), all in flight
// before one wait. Warp w takes rows w and w + 8, together. Scores: lane
// j is key j and dots its K row with the row's q, 16 bytes at a time from
// shared memory (K rows padded by 4 floats, so the 8 keys of a quarter
// warp's 16-byte reads hit 8 bank groups); the row max and sum are
// flash_fwd's butterflies. P V: lane l owns dims l + 32 i and takes each
// p_j from lane j. All f32 FMAs on the CUDA cores. As in flash_fwd and
// the plain version, q is scaled before the product, and every score, sum
// and product is flash_fwd's, in its order (one FMA chain over d), so a
// call gives flash_fwd's bits wherever flash_fwd's tile starts at key 0
// (the f32 LM agreement amplifies any other rounding through 28 layers).
template <int D>
__global__ void __launch_bounds__(kShortThreads)
    flash_short_f32(Args a, int B, int ng, int tiles) {
  constexpr int C4 = D / 4;     // 16-byte pieces of a row
  constexpr int KS = D + 4;     // padded K row
  constexpr int kPer = D / 32;  // P V dims per lane
  extern __shared__ __align__(16) float sh_short[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KVH, M = a.S * G, n = a.kv_end;
  // the caller keeps B * KVH * tiles < 2^31: int indices
  const int u = blockIdx.x, tile = u % tiles;
  const int g0 = u / tiles * ng;       // first group: g = b * KVH + kvh
  const int ngb = min(ng, B * a.KVH - g0);
  const int r0 = tile * kShortRows;    // first row of the group's tile
  const int rg = tiles > 1 ? min(kShortRows, M - r0) : M;  // rows a group
  const int R = ngb * rg;              // rows of the block
  const int Rmax = ng * (tiles > 1 ? kShortRows : M);
  float* sQ = sh_short;                // [Rmax][D]
  float* sK = sQ + Rmax * D;           // [ng][n][KS]
  float* sV = sK + ng * n * KS;        // [ng][n][D]

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  // 16-byte copies need every base and (b, h, s) stride a multiple of 4
  // floats
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  const int64_t strides = a.q_b | a.q_h | a.q_s | a.k_b | a.k_h | a.k_s |
                          a.v_b | a.v_h | a.v_s;
  const bool vec = (ptrs & 15) == 0 && (strides & 3) == 0;
  auto copy = [&](float* dst, const float* src) {
    if (vec) {
      sm90::cp_async16<false>(dst, src, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + e);
    }
  };
  // thread tid copies piece c of rows tid / C4, + kStep, ...
  constexpr int kStep = kShortThreads / C4;
  const int c = tid % C4 * 4;
  for (int lr = tid / C4; lr < R; lr += kStep) {  // Q
    const int gi = lr / rg, rr = r0 + lr - gi * rg;
    const int g = g0 + gi, b = g / a.KVH, kvh = g - b * a.KVH;
    const int qpos = rr / G, h = kvh * G + rr - qpos * G;
    copy(sQ + lr * D + c, q + b * a.q_b + h * a.q_h + qpos * a.q_s + c);
  }
  for (int row = tid / C4; row < ngb * n; row += kStep) {  // K, V
    const int gi = row / n, j = row - gi * n;
    const int g = g0 + gi, b = g / a.KVH, kvh = g - b * a.KVH;
    copy(sK + row * KS + c, k + b * a.k_b + kvh * a.k_h + j * a.k_s + c);
    copy(sV + row * D + c, v + b * a.v_b + kvh * a.v_h + j * a.v_s + c);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();

  // this warp's rows: warp and warp + 8 (R <= 16), ne of them
  const int ne = warp + kShortWarps < R ? 2 : warp < R ? 1 : 0;
  if (ne == 0) return;  // warp-uniform; no barrier follows
  const float4* sQ4 = reinterpret_cast<const float4*>(sQ);
  const float4* sK4 = reinterpret_cast<const float4*>(sK);
  int gis[2], rrs[2];
  float pr[2], l[2], mxs[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e >= ne) break;
    const int lr = warp + e * kShortWarps;
    gis[e] = lr / rg;
    rrs[e] = r0 + lr - gis[e] * rg;
    const int qpos = rrs[e] / G;
    const int lo = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
    const int hi = a.causal ? min(qpos + 1, n) : n;
    const float4* qrow = sQ4 + lr * C4;
    const float4* krow = sK4 + (gis[e] * n + min(lane, n - 1)) * (KS / 4);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < C4; ++i) {
      const float4 qv = qrow[i], kv = krow[i];
      s = fmaf(qv.x * a.scale, kv.x, s);
      s = fmaf(qv.y * a.scale, kv.y, s);
      s = fmaf(qv.z * a.scale, kv.z, s);
      s = fmaf(qv.w * a.scale, kv.w, s);
    }
    const bool valid = lane >= lo && lane < hi;
    const float mx = warp_max(valid ? s : -INFINITY);
    pr[e] = valid ? expf(s - mx) : 0.f;
    l[e] = warp_sum(pr[e]);
    mxs[e] = mx;
  }
  float acc[2][kPer];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[e][i] = 0.f;
  for (int jj = 0; jj < n; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (e >= ne) break;
      const float pj = __shfl_sync(kFull, pr[e], jj);
      const float* vrow = sV + (gis[e] * n + jj) * D + lane;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[e][i] = fmaf(pj, vrow[32 * i], acc[e][i]);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e >= ne) break;
    const int g = g0 + gis[e], b = g / a.KVH, kvh = g - b * a.KVH;
    const int qpos = rrs[e] / G, h = kvh * G + rrs[e] - qpos * G;
    float* orow = static_cast<float*>(a.o) + b * a.o_b + h * a.o_h +
                  qpos * a.o_s + lane;
    const float inv = 1.f / fmaxf(l[e], 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) orow[32 * i] = acc[e][i] * inv;
    // every lane holds the row's max and sum after the butterflies
    if (a.lse != nullptr && lane == 0) store_lse(a, b, h, qpos, mxs[e], l[e]);
  }
}

// Up to 4 keys (the policy trunk: S = 4 or 3) and D <= 128, each lane's
// share of Q, K and V fits in registers: flash_short_reg_f32 loads it
// there straight from global memory (16 bytes at a time where the
// alignment rule allows, else 4), every load of the warp's rows before
// the first use, with no shared memory and no barrier: the warps of a
// block run apart. For the scores lane l is key j = l / 8 and dots the
// dims of its part p = l % 8, summed over the key's 8 lanes by shuffles;
// the row max and sum are shuffles over the 4 keys. For P V it owns dims
// l + 32 i, taking V's rows of those dims for every key.
// 16 bytes, or 4 pieces of 4 where the alignment rule does not allow it,
// pinned where written (sm90::ld_nc)
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  using sm90::ld_nc;
  return vec ? sm90::ld_nc4(p)
             : make_float4(ld_nc(p), ld_nc(p + 1), ld_nc(p + 2), ld_nc(p + 3));
}

template <int D>
__global__ void __launch_bounds__(kShortThreads)
    flash_short_reg_f32(Args a, int B, int ng, int tiles) {
  constexpr int NP = 4, P = 32 / NP;  // 4 keys of 8 lanes
  constexpr int C4 = D / 4, kQ = C4 / P, kPer = D / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = a.H / a.KVH, M = a.S * G, n = a.kv_end;
  const int u = blockIdx.x, tile = u % tiles;
  const int g0 = u / tiles * ng;
  const int ngb = min(ng, B * a.KVH - g0);
  const int r0 = tile * kShortRows;
  const int rg = tiles > 1 ? min(kShortRows, M - r0) : M;
  const int R = ngb * rg;
  const int ne = warp + kShortWarps < R ? 2 : warp < R ? 1 : 0;
  if (ne == 0) return;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  const int64_t strides = a.q_b | a.q_h | a.q_s | a.k_b | a.k_h | a.k_s |
                          a.v_b | a.v_h | a.v_s;
  const bool vec = (ptrs & 15) == 0 && (strides & 3) == 0;
  const int j = lane / P, p = lane % P, jc = min(j, n - 1);

  // every load of this warp's rows, in flight at once
  float4 qv[2][kQ], kv[2][kQ];
  float vv[2][NP][kPer];
  int gis[2], bs[2], kvhs[2], qps[2], hs[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e >= ne) break;
    const int lr = warp + e * kShortWarps;
    gis[e] = lr / rg;
    const int rr = r0 + lr - gis[e] * rg;
    const int g = g0 + gis[e];
    bs[e] = g / a.KVH;
    kvhs[e] = g - bs[e] * a.KVH;
    qps[e] = rr / G;
    hs[e] = kvhs[e] * G + rr - qps[e] * G;
    const float* qrow = static_cast<const float*>(a.q) + bs[e] * a.q_b +
                        hs[e] * a.q_h + qps[e] * a.q_s;
    const float* kb = static_cast<const float*>(a.k) + bs[e] * a.k_b +
                      kvhs[e] * a.k_h;
    const float* vb = static_cast<const float*>(a.v) + bs[e] * a.v_b +
                      kvhs[e] * a.v_h + lane;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      qv[e][i] = load4(qrow + 4 * (p + P * i), vec);
      kv[e][i] = load4(kb + jc * a.k_s + 4 * (p + P * i), vec);
    }
#pragma unroll
    for (int jj = 0; jj < NP; ++jj)
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        vv[e][jj][i] = sm90::ld_nc(vb + min(jj, n - 1) * a.v_s + 32 * i);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e >= ne) break;
    const int lo = a.window > 0 ? max(0, qps[e] - a.window + 1) : 0;
    const int hi = a.causal ? min(qps[e] + 1, n) : n;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      s = fmaf(qv[e][i].x * a.scale, kv[e][i].x, s);
      s = fmaf(qv[e][i].y * a.scale, kv[e][i].y, s);
      s = fmaf(qv[e][i].z * a.scale, kv[e][i].z, s);
      s = fmaf(qv[e][i].w * a.scale, kv[e][i].w, s);
    }
#pragma unroll
    for (int m = P / 2; m > 0; m >>= 1) s += __shfl_xor_sync(kFull, s, m);
    const bool valid = j >= lo && j < hi;
    float mx = valid ? s : -INFINITY;
#pragma unroll
    for (int m = 16; m >= P; m >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, m));
    const float pr = valid ? expf(s - mx) : 0.f;
    float l = pr;
#pragma unroll
    for (int m = 16; m >= P; m >>= 1) l += __shfl_xor_sync(kFull, l, m);
    float acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NP; ++jj) {
      const float pj = __shfl_sync(kFull, pr, jj * P);  // 0 past n
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(pj, vv[e][jj][i], acc[i]);
    }
    float* orow = static_cast<float*>(a.o) + bs[e] * a.o_b + hs[e] * a.o_h +
                  qps[e] * a.o_s + lane;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) orow[32 * i] = acc[i] * inv;
    // the butterflies over the key lanes (xor 16, 8) leave the row's max
    // and sum in every lane
    if (a.lse != nullptr && lane == 0) store_lse(a, bs[e], hs[e], qps[e], mx, l);
  }
}

template <int D>
cudaError_t launch_short_reg(const Args& a, int B, cudaStream_t stream) {
  const ShortPlan pl = short_plan(B, a.KVH, a.S * (a.H / a.KVH));
  if (pl.blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_short_reg_f32<D><<<unsigned(pl.blocks), kShortThreads, 0, stream>>>(
      a, B, pl.ng, pl.tiles);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_short_staged(const Args& a, int B, cudaStream_t stream) {
  constexpr int KS = D + 4;
  // the most any plan takes: 16 rows of Q, and K, V rows of at most 32
  // keys (or 8 over a block's groups)
  constexpr int kMaxSmem = (kShortRows * D + kShortSpan * (KS + D)) * 4;
  static bool configured = false;  // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_short_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int M = a.S * (a.H / a.KVH);
  const ShortPlan pl = short_plan(B, a.KVH, M);
  if (pl.blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int rows = pl.ng * (pl.tiles > 1 ? kShortRows : M);
  const size_t smem = size_t(rows * D + pl.ng * a.kv_end * (KS + D)) * 4;
  flash_short_f32<D><<<unsigned(pl.blocks), kShortThreads, smem, stream>>>(
      a, B, pl.ng, pl.tiles);
  return cudaGetLastError();
}

// up to 4 keys at D <= 128 in registers, every other span staged
template <int D>
cudaError_t launch_short_d(const Args& a, int B, cudaStream_t stream) {
  if constexpr (D <= 128) {
    if (a.kv_end <= 4) return launch_short_reg<D>(a, B, stream);
  }
  return launch_short_staged<D>(a, B, stream);
}

cudaError_t launch_short(const Args& a, int B, int D, cudaStream_t stream) {
  if (a.kv_end < 1 || a.kv_end > kShortSpan) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_short_d<32>(a, B, stream);
    case 64: return launch_short_d<64>(a, B, stream);
    case 128: return launch_short_d<128>(a, B, stream);
    case 256: return launch_short_d<256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- float32 past 32 keys: flash_fwd_f32 ----

// cp.async moves 16-byte pieces: every base and stride a multiple of 16
// bytes (`per16` elements of the operands' type)
bool aligned16(const Args& a, int per16) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a.q) |
                      reinterpret_cast<uintptr_t>(a.k) |
                      reinterpret_cast<uintptr_t>(a.v) |
                      reinterpret_cast<uintptr_t>(a.o);
  const int64_t st = a.q_b | a.q_h | a.q_s | a.k_b | a.k_h | a.k_s | a.v_b |
                     a.v_h | a.v_s | a.o_b | a.o_h | a.o_s;
  return p % 16 == 0 && st % per16 == 0;
}

// 4 bytes global -> shared, zero-filled (src unread) if !ok
__device__ __forceinline__ void cp_async4z(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(sm90::smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// A block of KS x W warps: W warps of RW = 4 TR rows each take BM rows,
// and KS groups of them (KS = 1 or 2) take the key tiles of BN in turn,
// each its own online softmax over its tiles, merged at the end (a short
// group's chain of tiles halved). Keys come in stages of KS BN: two
// stages of (K, V), or with SPLIT one K and one V buffer loading in turn
// (V while the scores read K, the next K while P V reads V); MB blocks
// share an SM.
template <int D, int W, int TR, int BN, int KS, bool SPLIT, int MB>
struct F32Tile {
  static constexpr int kThreads = KS * W * 32;
  static constexpr int RW = 4 * TR;  // rows a warp: lane group rl = lane / 8
                                     // owns rows rl, rl + 4, ...
  static constexpr int BM = W * RW;  // (query, head) rows a block
  static constexpr int TK = BN / 8;  // keys a lane: kl, kl + 8, ... (kl =
                                     // lane % 8)
  static constexpr int KN = KS * BN;  // keys a stage
  static constexpr int RS = D + 4;   // padded Q, K, V row: 8 rows in 8
                                     // distinct 16-byte bank groups
  static constexpr int PS = BN + 8;  // padded P row: the lanes' scalar
                                     // stores in 32 banks
  static constexpr int kStages = SPLIT ? 1 : 2;
  // Q [BM][RS]; stage s: K [KN][RS] at s * 2 KN RS, V [KN][RS] after it;
  // P [KS BM][PS]. The merge reuses Q's and the stages' memory: m, l [BM]
  // and O [BM][RS].
  static constexpr int kSmem =
      4 * (BM * RS + kStages * 2 * KN * RS + KS * BM * PS);
};

// Grid: one block per (row tile, kv head, batch), linear, the last row
// tiles (the heaviest under a causal mask) of every group first. VEC: the
// operands are read by 16-byte copies, else by 4-byte ones (the same
// arithmetic).
template <int D, int W, int TR, int BN, int KS, bool SPLIT, bool VEC,
          int MB>
__global__ void __launch_bounds__(KS * W * 32, MB)
    flash_fwd_f32(Args a, int groups) {
  using T = F32Tile<D, W, TR, BN, KS, SPLIT, MB>;
  constexpr int NT = T::kThreads, RW = T::RW, BM = T::BM, TK = T::TK;
  constexpr int KN = T::KN, RS = T::RS, PS = T::PS;
  constexpr int C4 = D / 4;   // 16-byte pieces of a row
  constexpr int NC = D / 32;  // P V: a lane's dims 4 kl + 32 c, c < NC
  extern __shared__ __align__(16) float f32_smem[];
  float* sQ = f32_smem;
  float* sKV = sQ + BM * RS;
  float* sP = sKV + T::kStages * 2 * KN * RS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rl = lane >> 3, kl = lane & 7;
  const int kg = warp / W, rw = warp - kg * W;  // key group, row warp
  const int G = a.H / a.KVH, M = a.S * G;
  const int tiles = (M + BM - 1) / BM;
  const int u = blockIdx.x, grp = u % groups;
  const int r0 = (tiles - 1 - u / groups) * BM;
  const int b = grp / a.KVH, kvh = grp - b * a.KVH;
  const float* q = static_cast<const float*>(a.q) + b * a.q_b +
                   int64_t(kvh) * G * a.q_h;
  const float* k = static_cast<const float*>(a.k) + b * a.k_b + kvh * a.k_h;
  const float* v = static_cast<const float*>(a.v) + b * a.v_b + kvh * a.v_h;
  float* o = static_cast<float*>(a.o) + b * a.o_b + int64_t(kvh) * G * a.o_h;

  // key range [lo, hi) of a query position; both grow with qpos
  auto lo_of = [&](int qpos) {
    return a.window > 0 ? max(0, qpos - a.window + 1) : 0;
  };
  auto hi_of = [&](int qpos) {
    return a.causal ? min(qpos + 1, a.kv_end) : a.kv_end;
  };
  const int blk_lo = lo_of(r0 / G);
  const int blk_hi = hi_of((min(r0 + BM, M) - 1) / G);
  const int nstages = blk_hi > blk_lo ? (blk_hi - blk_lo + KN - 1) / KN : 0;

  auto copy16 = [&](float* dst, const float* src, bool ok, const float* any) {
    if constexpr (VEC) {
      sm90::cp_async16<false>(dst, ok ? src : any, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4z(dst + e, ok ? src + e : any, ok);
    }
  };
  // Q rows r0 .. r0 + BM (zero past M), scaled once they land
  for (int c = tid; c < BM * C4; c += NT) {
    const int r = c / C4, d = c % C4 * 4, row = r0 + r;
    const int qpos = row / G;
    copy16(sQ + r * RS + d, q + (row - qpos * G) * a.q_h + qpos * a.q_s + d,
           row < M, q);
  }
  // a stage's K or V rows t0 .. t0 + KN (zero from blk_hi)
  auto load_rows = [&](float* dst, const float* src, int64_t stride, int t0) {
    for (int c = tid; c < KN * C4; c += NT) {
      const int j = c / C4, d = c % C4 * 4;
      copy16(dst + j * RS + d, src + (t0 + j) * stride + d, t0 + j < blk_hi,
             src);
    }
  };
  // stage it's K (V follows it); SPLIT: one buffer each
  auto sK_of = [&](int it) {
    return sKV + (SPLIT ? 0 : (it & 1) * 2 * KN * RS);
  };
  if (nstages > 0) {
    load_rows(sK_of(0), k, a.k_s, blk_lo);
    if (!SPLIT) load_rows(sK_of(0) + KN * RS, v, a.v_s, blk_lo);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  for (int c = tid; c < BM * C4; c += NT) {  // this thread's own pieces
    float4* p = reinterpret_cast<float4*>(sQ + c / C4 * RS + c % C4 * 4);
    float4 x = *p;
    x.x *= a.scale;
    x.y *= a.scale;
    x.z *= a.scale;
    x.w *= a.scale;
    *p = x;
  }

  // this warp's rows wr0 .. w_last (in the group) and their key ranges
  const int wr0 = r0 + rw * RW;
  const bool warp_on = wr0 < M;
  const int w_last = min(wr0 + RW, M) - 1;
  const int w_lo = lo_of(wr0 / G), w_hi = hi_of(w_last / G);
  const int w_maxlo = lo_of(w_last / G), w_minhi = hi_of(wr0 / G);
  // this lane's rows wr0 + rl + 4 i; an empty range past M
  int lo[TR], hi[TR];
  float m[TR], l[TR], acc[TR][NC][4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = wr0 + rl + 4 * i;
    lo[i] = row < M ? lo_of(row / G) : 0;
    hi[i] = row < M ? hi_of(row / G) : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  const float* sQl = sQ + (rw * RW + rl) * RS;
  float* sPl = sP + (kg * BM + rw * RW + rl) * PS;

  for (int it = 0; it < nstages; ++it) {
    const int t0 = blk_lo + it * KN;  // the stage's first key
    const int tk = t0 + kg * BN;      // this key group's tile
    float* sK = sK_of(it);
    float* sV = sK + KN * RS;
    sm90::cp_async_wait<0>();  // this thread's copies of stage it
    __syncthreads();           // ... every thread's; the other buffer free
    if (SPLIT) {
      load_rows(sV, v, a.v_s, t0);
    } else if (it + 1 < nstages) {
      load_rows(sK_of(it + 1), k, a.k_s, t0 + KN);
      load_rows(sK_of(it + 1) + KN * RS, v, a.v_s, t0 + KN);
    }
    sm90::cp_async_commit();
    const bool on = warp_on && tk < w_hi && tk + BN > w_lo;  // warp-uniform
    const float* sKg = sK + kg * BN * RS;
    float p[TR][TK];
    if (on) {
      // S = Q K^T: row rl + 4 i, key kl + 8 t; one FMA chain over d
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int t = 0; t < TK; ++t) p[i][t] = 0.f;
#pragma unroll (D >= 128 ? 4 : 2)
      for (int c = 0; c < C4; ++c) {
        float4 qv[TR], kv[TK];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          qv[i] = *reinterpret_cast<const float4*>(sQl + 4 * i * RS + 4 * c);
#pragma unroll
        for (int t = 0; t < TK; ++t)
          kv[t] = *reinterpret_cast<const float4*>(sKg + (kl + 8 * t) * RS +
                                                   4 * c);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int t = 0; t < TK; ++t) {
            p[i][t] = fmaf(qv[i].x, kv[t].x, p[i][t]);
            p[i][t] = fmaf(qv[i].y, kv[t].y, p[i][t]);
            p[i][t] = fmaf(qv[i].z, kv[t].z, p[i][t]);
            p[i][t] = fmaf(qv[i].w, kv[t].w, p[i][t]);
          }
      }
      // masks only where the tile crosses a row's range edge; online
      // softmax: each row's max and sum over its 8 lanes
      const bool masked = tk < w_maxlo || tk + BN > w_minhi;
      float alpha[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < TK; ++t) {
          const int key = tk + kl + 8 * t;
          if (masked && (key < lo[i] || key >= hi[i])) p[i][t] = -INFINITY;
          mx = fmaxf(mx, p[i][t]);
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_new = fmaxf(m[i], mx);
        // a row with no key yet subtracts 0: its p and alpha stay 0
        const float ref = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = expf(m[i] - ref);
        float part[TK];
#pragma unroll
        for (int t = 0; t < TK; ++t) {
          p[i][t] = expf(p[i][t] - ref);
          part[t] = p[i][t];
        }
        // the tile's sum, the key's highest bit first: the lane's keys
        // differ in bits 3 and up, the row's 8 lanes in bits 2, 1, 0
#pragma unroll
        for (int h = TK / 2; h > 0; h >>= 1)
#pragma unroll
          for (int t = 0; t < h; ++t) part[t] += part[t + h];
        float sum = part[0];
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          sum += __shfl_xor_sync(kFull, sum, off);
        l[i] = l[i] * alpha[i] + sum;
        m[i] = m_new;
#pragma unroll
        for (int t = 0; t < TK; ++t) sPl[4 * i * PS + kl + 8 * t] = p[i][t];
      }
      // rescale O only where a row max moved (warp-uniform vote)
      bool moved = false;
#pragma unroll
      for (int i = 0; i < TR; ++i) moved |= alpha[i] != 1.f;
      if (__any_sync(kFull, moved)) {
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha[i];
      }
      __syncwarp();
    }
    if (SPLIT) {
      sm90::cp_async_wait<0>();  // V of stage it
      __syncthreads();           // ... every thread's; K's buffer free
      if (it + 1 < nstages) load_rows(sKV, k, a.k_s, t0 + KN);
      sm90::cp_async_commit();
    }
    if (on) {
      // O += P V over the warp's keys of the tile (past them p = 0 on
      // every row of the warp), 4 at a time, j ascending
      const int n = min(BN, w_hi - tk);
      const float* sVl = sV + kg * BN * RS + 4 * kl;
#pragma unroll 1
      for (int j = 0; j < n; j += 4) {
        float4 pv[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          pv[i] = *reinterpret_cast<const float4*>(sPl + 4 * i * PS + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float4 vv[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            vv[c] = *reinterpret_cast<const float4*>(sVl + (j + jj) * RS +
                                                     32 * c);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float pj = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                           : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              acc[i][c][0] = fmaf(pj, vv[c].x, acc[i][c][0]);
              acc[i][c][1] = fmaf(pj, vv[c].y, acc[i][c][1]);
              acc[i][c][2] = fmaf(pj, vv[c].z, acc[i][c][2]);
              acc[i][c][3] = fmaf(pj, vv[c].w, acc[i][c][3]);
            }
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
  if constexpr (KS == 2) {
    // merge the second key group's (m, l, O) into the first's through Q's
    // and the stages' shared memory: O = O0 a0 + O1 a1, a = expf(m - max
    // m). A row whose second group saw no key (a span within one tile)
    // keeps the first group's sums exactly: a0 = 1, a1 = 0.
    float* sM = sQ;
    float* sL = sM + BM;
    float* sO = sL + BM;
    __syncthreads();  // every warp is done with Q and the stages
    if (kg == 1) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int r = rw * RW + rl + 4 * i;
        if (kl == 0) {
          sM[r] = m[i];
          sL[r] = l[i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
          *reinterpret_cast<float4*>(sO + r * RS + 4 * kl + 32 * c) =
              make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2],
                          acc[i][c][3]);
      }
    }
    __syncthreads();
    if (kg == 1) return;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = rw * RW + rl + 4 * i;
      const float m1 = sM[r], mm = fmaxf(m[i], m1);
      const float ref = mm == -INFINITY ? 0.f : mm;
      const float a0 = expf(m[i] - ref), a1 = expf(m1 - ref);
      l[i] = l[i] * a0 + sL[r] * a1;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 o1 =
            *reinterpret_cast<const float4*>(sO + r * RS + 4 * kl + 32 * c);
        acc[i][c][0] = acc[i][c][0] * a0 + o1.x * a1;
        acc[i][c][1] = acc[i][c][1] * a0 + o1.y * a1;
        acc[i][c][2] = acc[i][c][2] * a0 + o1.z * a1;
        acc[i][c][3] = acc[i][c][3] * a0 + o1.w * a1;
      }
    }
  }
  if (!warp_on) return;

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = wr0 + rl + 4 * i;
    if (row >= M) continue;
    const int qpos = row / G;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + (row - qpos * G) * a.o_h + qpos * a.o_s + 4 * kl;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 x = make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv,
                                   acc[i][c][2] * inv, acc[i][c][3] * inv);
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(orow + 32 * c) = x;
      } else {
        orow[32 * c] = x.x;
        orow[32 * c + 1] = x.y;
        orow[32 * c + 2] = x.z;
        orow[32 * c + 3] = x.w;
      }
    }
  }
}

template <int D, int W, int TR, int BN, int KS, bool SPLIT, int MB>
cudaError_t launch_f32(const Args& a, int B, cudaStream_t stream) {
  using T = F32Tile<D, W, TR, BN, KS, SPLIT, MB>;
  const bool vec = aligned16(a, 4);
  auto kern = vec ? flash_fwd_f32<D, W, TR, BN, KS, SPLIT, true, MB>
                  : flash_fwd_f32<D, W, TR, BN, KS, SPLIT, false, MB>;
  static bool configured[2] = {false, false};  // the attribute, once each
  if (!configured[vec]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
    configured[vec] = true;
  }
  const int64_t groups = int64_t(B) * a.KVH;
  const int64_t blocks =
      groups * ((int64_t(a.S) * (a.H / a.KVH) + T::BM - 1) / T::BM);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<unsigned(blocks), T::kThreads, T::kSmem, stream>>>(a, int(groups));
  return cudaGetLastError();
}

// Tiles (W, TR, BN, KS, SPLIT, MB) by head dim, from a sweep on the card
// at the f32 LM prefills (launch/profile_flash_tiles.py --f32): at D 128
// a group of at least kLongRows (query, head) rows takes 128-row blocks
// of 4 x 8 register tiles (K/V read half as often), a shorter one 32-row
// blocks on two key groups (its heaviest tile's chain halved); D 256 two
// key groups; 8 rows a lane group or 16-row blocks were slower everywhere
constexpr int64_t kLongRows = 512;

template <int D>
cudaError_t dispatch_f32_d(const Args& a, int B, cudaStream_t stream) {
  const bool long_rows = int64_t(a.S) * (a.H / a.KVH) >= kLongRows;
  if constexpr (D == 32) return launch_f32<D, 4, 4, 64, 1, false, 2>(a, B, stream);
  if constexpr (D == 64) return launch_f32<D, 4, 4, 64, 1, false, 2>(a, B, stream);
  if constexpr (D == 128) {
    if (long_rows) return launch_f32<D, 8, 4, 64, 1, true, 1>(a, B, stream);
    return launch_f32<D, 4, 2, 32, 2, true, 2>(a, B, stream);
  }
  if constexpr (D == 256) return launch_f32<D, 4, 2, 32, 2, true, 1>(a, B, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_f32(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_f32_d<32>(a, B, stream);
    case 64: return dispatch_f32_d<64>(a, B, stream);
    case 128: return dispatch_f32_d<128>(a, B, stream);
    case 256: return dispatch_f32_d<256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bfloat16: tensor cores, K/V staged once per kv-head group ----

// 2^x on the special-function unit (x = -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A block of W warps, each owning 16 rows, takes keys in tiles of BN,
// double-buffered; Q's fragments stay in registers when QR; MB blocks
// share an SM.
template <int D, int W, int BN, bool QR, int MB>
struct Tc {
  static constexpr int kThreads = W * 32;
  static constexpr int BM = W * 16;  // (query, head) rows per block
  static constexpr int RS = D + 8;   // padded smem row, elements
  // Q [BM][RS], then 2 stages of K [BN][RS] and V [BN][RS]
  static constexpr int kSmem = (BM + 4 * BN) * RS * 2;
};

template <int D, int W, int BN, bool QR, int MB>
__global__ void __launch_bounds__(W * 32, MB) flash_fwd_tc(Args a) {
  using T = Tc<D, W, BN, QR, MB>;
  constexpr int BM = T::BM, RS = T::RS, NT = T::kThreads;
  constexpr int KD = D / 16;  // k16 steps over D (S = Q K^T)
  constexpr int NK = BN / 8;  // n8 tiles of keys
  constexpr int ND = D / 8;   // n8 tiles of D (O)
  constexpr int CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) __nv_bfloat16 tc_smem[];
  __nv_bfloat16* sQ = tc_smem;
  __nv_bfloat16* sKV = sQ + BM * RS;  // stage s: K at s * 2 BN RS, V after

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KVH;
  const int M = a.S * G;  // rows of the group, r = qpos * G + g
  // grid (KVH, B, query tiles): the blocks start in order of their linear
  // index, so the last query tiles, the heaviest under a causal mask, go
  // first and the light ones fill in behind them
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           b * a.q_b + int64_t(kvh) * G * a.q_h;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_b + kvh * a.k_h;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_b + kvh * a.v_h;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_b +
                     int64_t(kvh) * G * a.o_h;

  // key range [lo, hi) of a query position; both grow with qpos
  auto lo_of = [&](int qpos) {
    return a.window > 0 ? max(0, qpos - a.window + 1) : 0;
  };
  auto hi_of = [&](int qpos) {
    return a.causal ? min(qpos + 1, a.kv_end) : a.kv_end;
  };
  const int blk_lo = lo_of(r0 / G);
  const int blk_hi = hi_of((min(r0 + BM, M) - 1) / G);
  const int ntiles = blk_hi > blk_lo ? (blk_hi - blk_lo + BN - 1) / BN : 0;

  // Q rows r0 .. r0 + BM (zero past M)
  for (int c = tid; c < BM * CH; c += NT) {
    const int r = c / CH, d = c % CH * 8, row = r0 + r;
    const bool ok = row < M;
    const int qpos = row / G;
    sm90::cp_async16<false>(
        sQ + r * RS + d,
        ok ? q + (row - qpos * G) * a.q_h + qpos * a.q_s + d : q, ok);
  }
  // K/V tiles: thread tid copies chunk d0 of rows j0 + i * kStep, i < kPer
  // (its row and column fixed, so a tile's copies cost an add each)
  constexpr int kStep = NT / CH, kPer = BN / kStep;
  static_assert(NT % CH == 0 && BN % kStep == 0, "tile copy split");
  const int j0 = tid / CH, d0 = tid % CH * 8;
  const __nv_bfloat16* kt = k + j0 * a.k_s + d0;
  const __nv_bfloat16* vt = v + j0 * a.v_s + d0;
  const int64_t k_step = kStep * a.k_s, v_step = kStep * a.v_s;
  __nv_bfloat16* const sKt = sKV + j0 * RS + d0;
  auto load_kv = [&](int stage, int t0) {
    __nv_bfloat16* sK = sKt + stage * 2 * BN * RS;
    const __nv_bfloat16* kp = kt + t0 * a.k_s;
    const __nv_bfloat16* vp = vt + t0 * a.v_s;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const bool ok = t0 + j0 + i * kStep < blk_hi;
      sm90::cp_async16<false>(sK + i * kStep * RS, ok ? kp + i * k_step : k,
                              ok);
      sm90::cp_async16<false>(sK + (BN + i * kStep) * RS,
                              ok ? vp + i * v_step : v, ok);
    }
  };
  if (ntiles > 0) load_kv(0, blk_lo);  // one group with Q
  sm90::cp_async_commit();

  // this warp's rows wr0 .. w_last and their key ranges
  const int wr0 = r0 + warp * 16;
  const bool warp_on = wr0 < M;
  const int w_last = min(wr0 + 16, M) - 1;
  const int w_lo = lo_of(wr0 / G), w_hi = hi_of(w_last / G);
  const int w_maxlo = lo_of(w_last / G), w_minhi = hi_of(wr0 / G);
  // this lane's two rows, lane / 4 and lane / 4 + 8 of the warp's 16
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + (lane >> 2) + 8 * i;
    lo[i] = row < M ? lo_of(row / G) : 0;
    hi[i] = row < M ? hi_of(row / G) : 0;
  }
  const float sl2 = a.scale * 1.4426950408889634f;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  unsigned qf[QR ? KD : 1][4];
  const __nv_bfloat16* sQw =
      sQ + (warp * 16 + (lane & 7) + (lane >> 3 & 1) * 8) * RS + (lane >> 4) * 8;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = blk_lo + it * BN;
    if (it + 1 < ntiles) load_kv((it + 1) & 1, t0 + BN);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // Q and tile it have landed (this thread's)
    __syncthreads();           // ... every thread's
    if (QR && it == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        sm90::ldmatrix_x4(qf[QR ? kd : 0], sQw + kd * 16);
    }
    if (warp_on && t0 < w_hi && t0 + BN > w_lo) {  // warp-uniform
      const __nv_bfloat16* sK = sKV + (it & 1) * 2 * BN * RS;
      const __nv_bfloat16* sV = sK + BN * RS;
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        unsigned qa[4];
        if (QR) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[QR ? kd : 0][e];
        } else {
          sm90::ldmatrix_x4(qa, sQw + kd * 16);
        }
#pragma unroll
        for (int n = 0; n < NK; n += 2) {
          // lanes 0-15: keys 8n.. at d halves 16kd, 16kd + 8; 16-31: 8n + 8..
          unsigned kb[4];
          sm90::ldmatrix_x4(kb, sK + (n * 8 + (lane & 7) + (lane >> 4) * 8) * RS
                                    + kd * 16 + (lane >> 3 & 1) * 8);
          const unsigned b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
          sm90::mma_bf16(s[n], qa, b0);
          sm90::mma_bf16(s[n + 1], qa, b1);
        }
      }
      // mask where the tile crosses a row's range edge; online softmax
      const bool masked = t0 < w_maxlo || t0 + BN > w_minhi;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, key = t0 + n * 8 + (lane & 3) * 2 + (e & 1);
          if (masked && (key < lo[i] || key >= hi[i])) s[n][e] = -INFINITY;
          mx[i] = fmaxf(mx[i], s[n][e]);
        }
      float ref[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // scaled row max; a row with no key yet subtracts 0
        ref[i] = m_new == -INFINITY ? 0.f : m_new * sl2;
        alpha[i] = ex2(m[i] * sl2 - ref[i]);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      // rescale O only where a row max moved (warp-uniform vote)
      if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      }
      // P in bf16: the S accumulators of key tiles 2j, 2j + 1 are the A
      // fragment of key step j of O += P V
      unsigned pa[BN / 16][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p0 = ex2(fmaf(s[n][2 * i], sl2, -ref[i]));
          const float p1 = ex2(fmaf(s[n][2 * i + 1], sl2, -ref[i]));
          l[i] += p0 + p1;
          pa[n >> 1][(n & 1) * 2 + i] = sm90::pack_bf16(p0, p1);
        }
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          // lanes 0-7 keys 16j.., 8-15 keys 16j + 8..; 16-31 the next 8 d
          unsigned vb[4];
          sm90::ldmatrix_x4_trans(
              vb, sV + (j * 16 + (lane & 7) + (lane >> 3 & 1) * 8) * RS
                      + n * 8 + (lane >> 4) * 8);
          const unsigned b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
          sm90::mma_bf16(acc[n], pa[j], b0);
          sm90::mma_bf16(acc[n + 1], pa[j], b1);
        }
      }
    }
    __syncthreads();  // stage it & 1 is free for tile it + 2
  }
  sm90::cp_async_wait<0>();
  if (!warp_on) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + (lane >> 2) + 8 * i;
    if (row >= M) continue;
    const int qpos = row / G;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* orow =
        o + (row - qpos * G) * a.o_h + qpos * a.o_s + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<unsigned*>(orow + n * 8) =
          sm90::pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

template <int D, int W, int BN, bool QR, int MB>
cudaError_t launch_tc(const Args& a, int B, cudaStream_t stream) {
  using T = Tc<D, W, BN, QR, MB>;
  static bool configured = false;  // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_fwd_tc<D, W, BN, QR, MB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int64_t tiles = (int64_t(a.S) * (a.H / a.KVH) + T::BM - 1) / T::BM;
  if (tiles > 65535) return launch<__nv_bfloat16, D>(a, B, stream);  // grid z
  const dim3 grid(a.KVH, B, unsigned(tiles));
  flash_fwd_tc<D, W, BN, QR, MB><<<grid, T::kThreads, T::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// Tiles (W, BN, QR, MB) by head dim, from a sweep at 2048-token causal
// prefills (launch/profile_flash_tiles.py): a group whose rows fit 128
// (the LM prefill path: S = 32, G <= 3) is one block of 8 warps; a longer
// one takes its head dim's tiles below. A block of 8 warps (128 rows)
// halves the K/V copies of 4 but was no faster at D = 128; nor were more
// stages or 32 rows a warp.
template <int D>
cudaError_t dispatch_tc_d(const Args& a, int B, cudaStream_t stream) {
  if (int64_t(a.S) * (a.H / a.KVH) <= 128)
    return launch_tc<D, 8, D <= 128 ? 64 : 32, D <= 128, 1>(a, B, stream);
  if constexpr (D == 32) return launch_tc<D, 4, 128, true, 2>(a, B, stream);
  if constexpr (D == 64) return launch_tc<D, 8, 128, true, 1>(a, B, stream);
  if constexpr (D == 128) return launch_tc<D, 4, 64, false, 3>(a, B, stream);
  if constexpr (D == 256) return launch_tc<D, 4, 64, false, 1>(a, B, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_tc(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_tc_d<32>(a, B, stream);
    case 64: return dispatch_tc_d<64>(a, B, stream);
    case 128: return dispatch_tc_d<128>(a, B, stream);
    case 256: return dispatch_tc_d<256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The launch arguments, packed by the caller (kernel.py's PARAMS: little
// endian, no padding; the layout below has none on x86-64).
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int kind, B, H, KVH, S, D, causal, window, kv_end;
  float scale;
  int64_t q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  float* lse;
};
static_assert(sizeof(FlashParams) == 176, "FlashParams is packed");

// kind, the caller's choice of kernel (kernel.py's `kernel_kind`): 0 =
// float32 (flash_fwd_f32), 1 = bfloat16 (flash_fwd_tc, or flash_fwd in
// bf16 for operands cp.async cannot read), 2 = float32 with kv_end <= 32
// (flash_short_f32); scale is D^-0.5 as the caller rounds it to f32;
// element strides of the batch, head and sequence dims (the head dim is
// contiguous); lse, where not null, (B, H, S) f32 for each row's
// log-sum-exp (kind 2 only: the backward's f32 short spans). Launches on
// `stream`, allocates nothing, and returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for a
// head dim, kind or shape it does not take).
int flash_attention_hsd(const FlashParams* p, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->KVH <= 0 || p->H % p->KVH != 0 ||
      p->S <= 0)
    return cudaErrorInvalidValue;
  if (p->lse != nullptr && p->kind != 2) return cudaErrorInvalidValue;
  Args a{p->q,   p->k,   p->v,   p->o,   p->H,   p->KVH, p->S,
         p->kv_end, p->causal, p->window, p->scale, p->q_b, p->q_h,
         p->q_s, p->k_b, p->k_h, p->k_s, p->v_b, p->v_h, p->v_s,
         p->o_b, p->o_h, p->o_s, p->lse};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->kind == 0) return dispatch_f32(a, p->B, p->D, s);
  if (p->kind == 1)
    return aligned16(a, 8) ? dispatch_tc(a, p->B, p->D, s)
                         : dispatch_d<__nv_bfloat16>(a, p->B, p->D, s);
  if (p->kind == 2) return launch_short(a, p->B, p->D, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
