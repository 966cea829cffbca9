// Flash-attention backward for Hopper (sm_90a), f32, short key spans:
// flash_short_bwd_f32<D, kVec>, plain CUDA C++ on the CUDA cores.
//
// Replaces no Pallas kernel: the reference's `flash_attention_hsd`
// (src/repro/kernels/flash_attention/kernel.py:77, pallas_call at :96)
// is forward-only, and off the TPU its attention dispatcher trains
// through the jnp oracle (src/repro/core/attention.py). On the card the
// port's training path (the policy trunk under --policy trunk) runs the
// forward kernel, so the gradient of that attention is a kernel too:
// this one, launched by the autograd Function in ops.py.
//
// It computes, for grouped-query attention with scale D^-0.5 (q scaled
// before the product, as the forward), from q, k, v, the forward's O and
// row log-sum-exp lse, and dO:
//   Δ_i = Σ_d dO_id O_id;  P_ij = exp(s_ij − lse_i) on the masked keys;
//   dV_j = Σ_{g,i} P_ij dO_i;  dP_ij = dO_i · V_j;  dS_ij = P_ij (dP_ij − Δ_i);
//   dQ_i = scale Σ_j dS_ij K_j;  dK_j = scale Σ_{g,i} dS_ij Q_i,
// with the forward's causal, window and valid_len masks (keys in
// [lo(qpos), hi(qpos)) of [0, kv_end)); a row with no key gets zero
// gradients, and key rows at or past kv_end get zero dK and dV.
//
// What bounds it: at the trunk's training shapes (S = 3 or 4 keys, 4 query
// heads over 2 kv heads, D = 32 or 64, B up to 1024) a call moves q, o,
// dO, dq (B S H D each), k, v, dk, dv (B S KVH D each) and lse: 6.3 MB at
// B 256, D 64, 1.88 us at 3.35 TB/s, against 7 MFLOP: the bytes. On an
// H100 (700 W) a call there takes ~3.8 us of device time: an empty
// kernel's 0.86, then the loads (4 MB in flight at once) land ~1.4 us
// later, phase 1 with its dQ stores takes ~1.0 and phase 2 with the dK
// and dV stores ~0.45 (profile_small_kernels --bwd cuts the kernel at
// each point). Every group reads, then computes, then writes, so reads
// and writes do not overlap; the design keeps the part between them short
// (one round trip, no barrier but __syncwarp, shared reads spread over the
// lanes) and the registers at D <= 64 at 128, so B 1024's 2048 groups run
// in one wave.
//
// Design: a warp per (batch, kv head) group, kWarps groups a block, each
// warp in its own slice of shared memory; no block barrier, no atomics.
// A round takes R query rows of the group (r = qpos * G + g, h = kvh * G
// + g; the trunk's S * G = 8 rows are one round). Every copy of the round
// (the kv_end keys of K and V once, the R rows of q, dO and o, and their
// lse) is in flight at once, by cp.async straight into shared memory: one
// round trip, 16 bytes a copy where every base and stride allows it
// (kVec), else 4, neighbouring lanes on neighbouring addresses; rows past
// the group's last are zero-filled. Then two phases, split by __syncwarp:
//   1. the P = 32 / R lanes P i .. P i + P - 1 take row i, each its
//      16-byte chunks part, part + P, ... of every row (rows padded to D +
//      16 floats, so the two rows of a quarter warp hit separate banks):
//      Δ_i, then key by key s_ij and dP_ij, summed over the row's lanes
//      by xor butterflies (every lane of the row holds the sums), P_ij and
//      dS_ij (zero for a masked pair), and dQ_i += dS_ij K_j over the
//      chunks of K_j just read for s_ij; it writes dQ_i, P_ij and dS_ij;
//   2. lane l owns the C = D / 32 dims [l C, l C + C) of every row and
//      key: its dims of q and dO in registers, it walks the keys in
//      order, each adding every row's dS_ij q_i and P_ij dO_i to dK_j and
//      dV_j (registers within a round; between rounds its own dims of
//      them in shared memory, where no other lane reads).
// The sums run in one fixed order, so a repeat is bitwise. dQ is written
// in each round's phase 1, dK and dV after the last; key rows at or past
// kv_end get zeros. A block takes kWarps groups, fewer where its shared
// memory holds fewer, and fewer where B * KVH groups would leave SMs
// without one (at B 64 one group a block: a group's warp then has its
// SM's shared memory to itself). The strides of every operand are read as given
// (head dim contiguous); the wrapper hands dO over as autograd gives it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../shared/csrc/sm90.cuh"

namespace {

constexpr int kSpan = 32;       // the longest key range it takes
constexpr int kWarps = 4;       // groups a block, a warp each
constexpr int kMaxSmem = 232448;  // a block's shared memory on the card
constexpr unsigned kFull = 0xffffffffu;

// C dims a lane in phase 2, R rows a round, rows padded to DP floats; in
// phase 1 P lanes a row, T 16-byte chunks a lane
template <int D>
struct BwdTile {
  static constexpr int C = D / 32;
  static constexpr int R = D <= 128 ? 8 : 4;
  static constexpr int DP = D + 16;
  static constexpr int P = 32 / R;
  static constexpr int T = D / (4 * P);
  // blocks an SM must hold: at D <= 64, 4 of kWarps groups (128
  // registers a thread at most), so B 1024's 2048 groups run in one wave
  // (the scalar-copy instance, for unaligned operands, spills when held
  // to it and is left free)
  static constexpr int kMinBlocks = D <= 64 ? 4 : 1;
  static_assert(T >= 1, "a lane takes a chunk of every row");
};

// floats of one warp's shared memory for n keys: q, dO and o (R rows
// each), K and V (n rows each), padded; the sums of dK and dV (n x D);
// P and dS (n x R); lse (R)
template <int D>
__host__ __device__ constexpr int warp_floats(int n) {
  using T = BwdTile<D>;
  return (3 * T::R + 2 * n) * T::DP + 2 * n * D + 2 * n * T::R + T::R;
}

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;
  float* dq;
  float* dk;
  float* dv;
  int H, KVH, S, kv_end, causal, window;
  float scale;
  // element strides of the batch, head and sequence dims
  int64_t q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int64_t do_b, do_h, do_s, dq_b, dq_h, dq_s, dk_b, dk_h, dk_s;
  int64_t dv_b, dv_h, dv_s;
};

// W floats global -> shared, asynchronously; `bytes` of them read (the
// rest zero-filled)
template <int W>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               ::"r"(sm90::smem_addr(dst)), "l"(src), "n"(W * 4),
               "r"(bytes)
               : "memory");
}

// C floats of a shared row (16 or 8 bytes at a time, aligned)
template <int C>
__device__ __forceinline__ void lds(float (&x)[C], const float* p) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      x[c] = t.x, x[c + 1] = t.y, x[c + 2] = t.z, x[c + 3] = t.w;
    }
  } else if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

template <int C>
__device__ __forceinline__ void sts(float* p, const float (&x)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// x * scale to a lane's C dims of a global row: vector stores where kVec
// (every output base and stride then a multiple of 16 bytes)
template <int C, bool kVec>
__device__ __forceinline__ void store_dims(float* p, const float (&x)[C],
                                           float scale) {
  if constexpr (kVec) {
    float y[C];
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = x[c] * scale;
    sts<C>(p, y);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = x[c] * scale;
  }
}

template <int D, bool kVec>
__global__ void __launch_bounds__(kWarps * 32,
                                  kVec ? BwdTile<D>::kMinBlocks : 1)
    flash_short_bwd_f32(BwdArgs a, int groups) {
  using Tile = BwdTile<D>;
  constexpr int C = Tile::C, R = Tile::R, DP = Tile::DP, P = Tile::P;
  constexpr int T = Tile::T, W = kVec ? 4 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = blockIdx.x * int(blockDim.x >> 5) + warp;
  if (grp >= groups) return;
  const int n = a.kv_end, G = a.H / a.KVH, M = a.S * G, d0 = lane * C;
  const int b = grp / a.KVH, kvh = grp - b * a.KVH;
  extern __shared__ float4 bwd_smem[];
  float* sQ = reinterpret_cast<float*>(bwd_smem) + warp * warp_floats<D>(n);
  float* sdO = sQ + R * DP;
  float* sO = sdO + R * DP;
  float* sK = sO + R * DP;
  float* sV = sK + n * DP;
  float* sdK = sV + n * DP;  // [n][D], unscaled
  float* sdV = sdK + n * D;
  float* sP = sdV + n * D;   // [n][R]
  float* sdS = sP + n * R;
  float* sL = sdS + n * R;   // [R]

  const float* kb = a.k + b * a.k_b + kvh * a.k_h;
  const float* vb = a.v + b * a.v_b + kvh * a.v_h;
  float* dk_out = a.dk + b * a.dk_b + kvh * a.dk_h + d0;
  float* dv_out = a.dv + b * a.dv_b + kvh * a.dv_h + d0;
  for (int e = lane * W; e < n * D; e += 32 * W) {
    const int j = e / D, d = e - j * D;
    copy_async<W>(sK + j * DP + d, kb + j * a.k_s + d, 4 * W);
    copy_async<W>(sV + j * DP + d, vb + j * a.v_s + d, 4 * W);
  }

  for (int r0 = 0; r0 < M; r0 += R) {
    const int rows = min(R, M - r0);
    if (r0 > 0) __syncwarp();  // the last round's reads are done
    // the round's rows (past the group's last, zeros) and their lse
    for (int e = lane * W; e < R * D; e += 32 * W) {
      const int r = e / D, d = e - r * D;
      const int row = min(r0 + r, M - 1), qpos = row / G;
      const int h = kvh * G + row - qpos * G;
      const int bytes = r < rows ? 4 * W : 0;
      copy_async<W>(sQ + r * DP + d,
                    a.q + b * a.q_b + h * a.q_h + qpos * a.q_s + d, bytes);
      copy_async<W>(sdO + r * DP + d,
                    a.dout + b * a.do_b + h * a.do_h + qpos * a.do_s + d,
                    bytes);
      copy_async<W>(sO + r * DP + d,
                    a.o + b * a.o_b + h * a.o_h + qpos * a.o_s + d, bytes);
    }
    if (lane < rows) {
      const int row = r0 + lane, qpos = row / G;
      copy_async<1>(sL + lane,
                    a.lse + (int64_t(b) * a.H + kvh * G + row - qpos * G) *
                                a.S + qpos, 4);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    __syncwarp();

    // phase 1: lanes P i .. P i + P - 1, row i; chunks part + P t
    {
      const int i = lane / P, part = lane - i * P;
      const int qpos = (r0 + i) / G, h = kvh * G + r0 + i - qpos * G;
      const int lo = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
      const int hi = a.causal ? min(qpos + 1, n) : n;
      const bool live = i < rows;
      float4 qv[T], dov[T], dq[T];
      float delta = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int d = 4 * (part + P * t);
        qv[t] = *reinterpret_cast<const float4*>(sQ + i * DP + d);
        dov[t] = *reinterpret_cast<const float4*>(sdO + i * DP + d);
        const float4 o4 = *reinterpret_cast<const float4*>(sO + i * DP + d);
        delta = fmaf(dov[t].x, o4.x, delta);
        delta = fmaf(dov[t].y, o4.y, delta);
        delta = fmaf(dov[t].z, o4.z, delta);
        delta = fmaf(dov[t].w, o4.w, delta);
        dq[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int m = P / 2; m > 0; m >>= 1)
        delta += __shfl_xor_sync(kFull, delta, m);
      const float lse = sL[i];
#pragma unroll 1  // keys in turn: unrolled they measured no faster
      for (int j = 0; j < n; ++j) {
        float4 kv[T];
        float sc = 0.f, dp = 0.f;
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int d = 4 * (part + P * t);
          kv[t] = *reinterpret_cast<const float4*>(sK + j * DP + d);
          const float4 v4 = *reinterpret_cast<const float4*>(sV + j * DP + d);
          sc = fmaf(qv[t].x * a.scale, kv[t].x, sc);
          sc = fmaf(qv[t].y * a.scale, kv[t].y, sc);
          sc = fmaf(qv[t].z * a.scale, kv[t].z, sc);
          sc = fmaf(qv[t].w * a.scale, kv[t].w, sc);
          dp = fmaf(dov[t].x, v4.x, dp);
          dp = fmaf(dov[t].y, v4.y, dp);
          dp = fmaf(dov[t].z, v4.z, dp);
          dp = fmaf(dov[t].w, v4.w, dp);
        }
#pragma unroll
        for (int m = P / 2; m > 0; m >>= 1) {
          sc += __shfl_xor_sync(kFull, sc, m);
          dp += __shfl_xor_sync(kFull, dp, m);
        }
        const float pr = live && j >= lo && j < hi ? expf(sc - lse) : 0.f;
        const float ds = pr * (dp - delta);
#pragma unroll
        for (int t = 0; t < T; ++t) {
          dq[t].x = fmaf(ds, kv[t].x, dq[t].x);
          dq[t].y = fmaf(ds, kv[t].y, dq[t].y);
          dq[t].z = fmaf(ds, kv[t].z, dq[t].z);
          dq[t].w = fmaf(ds, kv[t].w, dq[t].w);
        }
        if (part == 0) {
          sP[j * R + i] = pr;
          sdS[j * R + i] = ds;
        }
      }
      if (live) {
        float* dqr = a.dq + b * a.dq_b + h * a.dq_h + qpos * a.dq_s;
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float y[4] = {dq[t].x, dq[t].y, dq[t].z, dq[t].w};
          store_dims<4, kVec>(dqr + 4 * (part + P * t), y, a.scale);
        }
      }
    }
    __syncwarp();

    // phase 2: lane l, dims [l C, l C + C) of every row and key; dK and
    // dV from the last round's sums (none in the first), and to the
    // outputs after the last round
    float qx[R][C], dox[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      lds<C>(qx[i], sQ + i * DP + d0);
      lds<C>(dox[i], sdO + i * DP + d0);
    }
    const bool first = r0 == 0, last = r0 + R >= M;
    for (int j = 0; j < n; ++j) {
      float dk[C] = {}, dv[C] = {}, pv[R], dsv[R];
      lds<R>(pv, sP + j * R);  // every lane the same: a broadcast
      lds<R>(dsv, sdS + j * R);
      if (!first) {
        lds<C>(dk, sdK + j * D + d0);
        lds<C>(dv, sdV + j * D + d0);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dk[c] = fmaf(dsv[i], qx[i][c], dk[c]);
          dv[c] = fmaf(pv[i], dox[i][c], dv[c]);
        }
      }
      if (last) {
        store_dims<C, kVec>(dk_out + j * a.dk_s, dk, a.scale);
        store_dims<C, kVec>(dv_out + j * a.dv_s, dv, 1.f);
      } else {
        sts<C>(sdK + j * D + d0, dk);
        sts<C>(sdV + j * D + d0, dv);
      }
    }
  }
  // key rows at or past kv_end get zero dK and dV
  const float zero[C] = {};
  for (int j = n; j < a.S; ++j) {
    store_dims<C, kVec>(dk_out + j * a.dk_s, zero, 1.f);
    store_dims<C, kVec>(dv_out + j * a.dv_s, zero, 1.f);
  }
}

template <int D, bool kVec>
cudaError_t launch_bwd(const BwdArgs& a, int64_t groups, cudaStream_t stream) {
  static bool configured = false;  // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_short_bwd_f32<D, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // groups a block: kWarps, fewer where a block's shared memory holds
  // fewer, and fewer where the groups would leave SMs idle (one a block
  // below one group an SM)
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int per_warp = 4 * warp_floats<D>(a.kv_end);
  int warps = int((groups + sms - 1) / sms);
  if (warps > kWarps) warps = kWarps;
  if (warps > kMaxSmem / per_warp) warps = kMaxSmem / per_warp;
  flash_short_bwd_f32<D, kVec>
      <<<unsigned((groups + warps - 1) / warps), warps * 32,
         size_t(warps) * per_warp, stream>>>(a, int(groups));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch arguments, packed by the caller (kernel.py's BWD_PARAMS:
// little endian; 4 bytes of padding after `scale`, as x86-64 lays it).
struct FlashBwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;
  float* dq;
  float* dk;
  float* dv;
  int B, H, KVH, S, D, causal, window, kv_end;
  float scale;
  int64_t q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int64_t do_b, do_h, do_s, dq_b, dq_h, dq_s, dk_b, dk_h, dk_s;
  int64_t dv_b, dv_h, dv_s;
};
static_assert(sizeof(FlashBwdParams) == 304, "FlashBwdParams layout");

// q, o, dO, dq (B, H, S, D) and k, v, dk, dv (B, KVH, S, D) through their
// (b, h, s) element strides (head dim contiguous), lse (B, H, S)
// contiguous, all f32; keys in [0, kv_end), 1 <= kv_end <= min(S, 32).
// Writes dq, dk and dv whole. Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a shape or head dim it does not take).
int flash_attention_bwd(const FlashBwdParams* p, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->KVH <= 0 || p->H % p->KVH != 0 ||
      p->S <= 0 || p->kv_end < 1 || p->kv_end > kSpan || p->kv_end > p->S)
    return cudaErrorInvalidValue;
  const int64_t groups = int64_t(p->B) * p->KVH;
  if (groups > 0x7fffffff) return cudaErrorInvalidValue;
  BwdArgs a{p->q,    p->k,    p->v,    p->o,    p->dout, p->lse,
            p->dq,   p->dk,   p->dv,   p->H,    p->KVH,  p->S,
            p->kv_end, p->causal, p->window, p->scale,
            p->q_b,  p->q_h,  p->q_s,  p->k_b,  p->k_h,  p->k_s,
            p->v_b,  p->v_h,  p->v_s,  p->o_b,  p->o_h,  p->o_s,
            p->do_b, p->do_h, p->do_s, p->dq_b, p->dq_h, p->dq_s,
            p->dk_b, p->dk_h, p->dk_s, p->dv_b, p->dv_h, p->dv_s};
  // the vector instance where every base and stride is a multiple of 16
  // bytes (lse is copied 4 bytes at a time)
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(p->q) | reinterpret_cast<uintptr_t>(p->k) |
      reinterpret_cast<uintptr_t>(p->v) | reinterpret_cast<uintptr_t>(p->o) |
      reinterpret_cast<uintptr_t>(p->dout) |
      reinterpret_cast<uintptr_t>(p->dq) | reinterpret_cast<uintptr_t>(p->dk) |
      reinterpret_cast<uintptr_t>(p->dv);
  const int64_t strides = p->q_b | p->q_h | p->q_s | p->k_b | p->k_h |
                          p->k_s | p->v_b | p->v_h | p->v_s | p->o_b |
                          p->o_h | p->o_s | p->do_b | p->do_h | p->do_s |
                          p->dq_b | p->dq_h | p->dq_s | p->dk_b | p->dk_h |
                          p->dk_s | p->dv_b | p->dv_h | p->dv_s;
  const bool vec = (ptrs & 15) == 0 && (strides & 3) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->D) {
    case 32: return vec ? launch_bwd<32, true>(a, groups, s)
                        : launch_bwd<32, false>(a, groups, s);
    case 64: return vec ? launch_bwd<64, true>(a, groups, s)
                        : launch_bwd<64, false>(a, groups, s);
    case 128: return vec ? launch_bwd<128, true>(a, groups, s)
                         : launch_bwd<128, false>(a, groups, s);
    case 256: return vec ? launch_bwd<256, true>(a, groups, s)
                         : launch_bwd<256, false>(a, groups, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
