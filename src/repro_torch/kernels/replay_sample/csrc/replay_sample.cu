// Fused prioritized replay draws (Gumbel-top-k) for Hopper (sm_90a), plain
// CUDA C++: the flat buffer's draw and the sharded replay service's
// per-shard draw, both a radix select.
//
// `prioritized_sample_c` replaces the Pallas TPU kernel of that name in
// src/repro/kernels/replay_sample/kernel.py:128 (pallas_call at :137): from
// raw priorities p and standard Gumbel noise g (C,) f32 and the filled
// count `size` (an int32 in device memory),
//
//     nvalid   = max(size, 1)
//     l_i      = alpha * log(p_i + eps)          for i < nvalid, else -inf
//     s_i      = l_i + g_i                       for i < nvalid, else -inf
//     idx      = the top n of s, ties to the lower index (lax.top_k's
//                order); positions j >= nvalid repeat idx[0]
//     w_j      = (nvalid * exp(l_idx_j - m) / Z + 1e-12)^(-beta), over
//                max_j w_j,  m = max l,  Z = sum_i exp(l_i - m)
//
// `shard_topk_c` (replacing the Pallas `shard_topk_c`, kernel.py:104,
// pallas_call at :113) is the sharded replay service's per-shard draw: per
// shard, from its LOCAL filled count (no max(., 1) guard), the top k of
// the same scores in (score desc, index asc) order; slots past the count
// score -inf and rank by position (the Pallas kernel's finite _NEG
// stand-in is a TPU workaround that its ops.py turns back into -inf). No
// weights, no surplus rule. One call covers all R shards.
//
// What bounds both on this card: bytes, 8 per filled slot read (p and g)
// plus 8 per pick written (31 ns at the DQN path shapes, 2.5 us for a 1M
// slot buffer, 5.7 us at four 1M-slot shards). The Pallas kernels keep the
// whole vector resident in VMEM and run n rounds of argmax over it; n
// serial rounds of a block-wide argmax would set the time here, so both
// draws are one radix select with no per-pick rounds:
//
//   Each slot gets a unique 64-bit order key: the score mapped to an
//   order-preserving uint32 (sign flip; -0.0 as +0.0; NaN above +inf, as
//   torch.sort's descending order puts it) in the high word, ~index in the
//   low word, so key order is (score desc, index asc) and ties are broken
//   by the key itself. One block of kSelThreads holds a tile of up to
//   kSelTile scores in shared memory and finds its k-th key by 8-bit digit
//   histograms, most significant digit first, with integer atomics in
//   shared memory spread over kReps copies of the histogram, one add per
//   warp where its lanes share a digit (exact counts in any order:
//   deterministic). A pass stops as soon as the k-th key's bin is taken
//   whole, so only ties reach the index bits. Only filled slots are
//   searched: the -inf slots past them rank by position, so a tile with
//   at most k filled slots takes its first k slots with no search. The
//   k keys at or above the k-th are gathered (a shared counter gives each
//   its slot); the last level ranks each by counting the larger keys
//   among the k and writes it at its rank.
//   A shard of at most kSelTile slots (both replay-plan path shapes) is
//   one block: one launch, no workspace. A larger shard runs one block
//   per tile that writes its k candidates (score, index) unsorted to a
//   workspace, padded with index -1 where a tile holds fewer than k slots,
//   then the same select over the candidates, kSelTile per block, until
//   one block holds them all: two launches at 1M slots, three at 4M with
//   k = 1024.
//
//   The flat draw is the select's R = 1 case over the C slots, its count
//   max(size, 1) read on the device (the host never reads size: a draw
//   syncs nothing). Its first level also writes each tile's partial
//   (m_b, s_b = sum exp(l - m_b)) over its filled slots: each thread keeps
//   an online (max, sum) over its slots, then two block reductions in a
//   fixed tree (no float atomics: bitwise repeatable). Its last level
//   ends in a fused epilogue: m = max m_b and Z = sum s_b exp(m_b - m)
//   over the partials in tile order (one warp, a fixed tree), the chosen
//   logits recomputed from p, idx in key order with positions >= nvalid
//   repeating idx[0], and the weights over their max. One launch at
//   C <= kSelTile. A larger C launches the further levels, but the device
//   decides how many run: when the filled slots fit one tile (the DQN
//   path: C = 20000, size <= 12800), the first level's block 0 holds the
//   whole draw and finishes it, and every other block of that and the
//   later launch returns at once; only a buffer filled past kSelTile
//   slots merges candidates across levels.
//
// Numerics: logits and scores use __fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA, so they round exactly as the plain PyTorch version
// (two roundings, logf) does and the indices agree bitwise. Z is summed in
// another order than the plain version, so weights agree to rounding.
// Limits (checked by the launchers): n, k <= kMaxN, C, chunk <= kMaxChunk
// (4M slots; the reference's capacities reach 1M).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 1024;
constexpr int kMaxChunk = 4096 * 1024;  // slots of one draw or shard

// Block-wide max or sum (fixed order, so deterministic); red holds 33 floats.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_down_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < int(blockDim.x >> 5) ? red[lane] : (kMax ? -INFINITY : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_down_sync(0xffffffffu, v, off);
      v = kMax ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ float logit(float p, float alpha, float eps) {
  return __fmul_rn(alpha, logf(__fadd_rn(p, eps)));
}
__device__ __forceinline__ float logit(const float* prio, int i, float alpha,
                                       float eps) {
  return logit(__ldg(prio + i), alpha, eps);
}

// ---- the radix select: the per-shard draw, and the flat draw as R = 1 ----

constexpr int kSelThreads = 1024;
constexpr int kSelTile = 16384;              // entries per select block
constexpr int kSelItems = kSelTile / kSelThreads;
constexpr int kSelBatch = 8;                 // slots a thread loads at once
constexpr int kBins = 256;                   // 8-bit digits
constexpr int kReps = 8;                     // copies of the histogram
constexpr int kRepStride = kBins + 1;        // a copy per bank offset
// dynamic shared memory: the last level's k keys, scores and indices, the
// tile's scores, and (levels after the first) the tile's indices
constexpr int kSelSmemFirst = kMaxN * 16 + kSelTile * 4;
constexpr int kSelSmemCand = kSelSmemFirst + kSelTile * 4;

// Score order as an unsigned integer: larger key = earlier in the draw.
__device__ __forceinline__ uint32_t order_key(float s) {
  if (s != s) return 0xffffffffu;  // NaN first, as torch.sort descending
  uint32_t b = __float_as_uint(s);
  if (b == 0x80000000u) b = 0u;    // -0.0 ties with +0.0
  return b ^ ((b & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

// The unique order key of entry `pos` of a tile: (score, ~index) for a
// slot, and for a padding entry (index -1) a key below every slot's (a
// slot's high word is at least order_key(-inf) > 0).
__device__ __forceinline__ uint64_t entry_key(float s, int id, int pos) {
  return id >= 0 ? uint64_t(order_key(s)) << 32 | uint32_t(~id)
                 : uint64_t(uint32_t(~pos));
}

// The flat draw's part of a select level (kFlat): its filled count is
// max(*size, 1), read on the device; the first level writes each tile's
// partial (m_b, s_b) to part, the last level the weights to w and the
// indices to idx.
struct Flat {
  const int* size;
  float beta;
  float* part;  // 2 floats per first-level tile
  int nparts;   // first-level tiles
  int* idx;
  float* w;
};

// One level of the select; grid (tiles, R), kSelThreads threads. kFirst:
// the entries are shard row blockIdx.y of prio/gumbel (L = chunk slots,
// the LOCAL count in nvalid[blockIdx.y], or the flat draw's count); else
// row blockIdx.y of the (R, L) candidate lists in_s/in_i of the level
// before. The block takes entries [blockIdx.x * kSelTile, + kSelTile) and
// selects the top kt = min(k, its length) by key. `last` (one tile):
// writes the shard's k in key order to out_s/out_i (R, k), or the flat
// draw's indices and weights. Else: writes them unsorted to list
// (blockIdx.y, blockIdx.x) of out_s/out_i (R, tiles, k), padded to k with
// (-inf, -1). The flat draw whose filled slots fit one tile is done by
// the first level's block 0; every other block of every level then
// returns at once.
template <bool kFirst, bool kFlat>
__global__ void __launch_bounds__(kSelThreads) shard_select_kernel(
    const float* __restrict__ prio, const float* __restrict__ gumbel,
    const int* __restrict__ nvalid, const float* __restrict__ in_s,
    const int* __restrict__ in_i, int L, int k, float alpha, float eps,
    bool last, float* __restrict__ out_s, int* __restrict__ out_i,
    Flat flat) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* ckey = reinterpret_cast<uint64_t*>(smem);
  float* cs = reinterpret_cast<float*>(ckey + kMaxN);
  int* ci = reinterpret_cast<int*>(cs + kMaxN);
  float* sc = reinterpret_cast<float*>(ci + kMaxN);
  int* si = reinterpret_cast<int*>(sc + kSelTile);  // !kFirst only
  __shared__ unsigned hist[kReps * kRepStride];
  __shared__ unsigned tot[kBins];
  __shared__ uint64_t s_prefix;
  __shared__ int s_kr, s_done, s_count;
  __shared__ float red[33], s_mz[2];
  const int tid = threadIdx.x, lane = tid & 31;
  const int shard = blockIdx.y;
  const int start = blockIdx.x * kSelTile;
  const int len = min(kSelTile, L - start);
  const int kt = min(k, len);
  const int count = kFlat ? max(__ldg(flat.size), 1)
                          : (kFirst ? __ldg(nvalid + shard) : 0);
  const bool one_tile = kFlat && count <= kSelTile;
  if (one_tile && (!kFirst || blockIdx.x > 0)) return;
  last = last || one_tile;
  // filled slots of the tile (first level): a prefix
  const int nv = kFirst ? min(max(count - start, 0), len) : 0;

  if (kFirst) {  // scores as the plain draw computes them; loads first
    prio += int64_t(shard) * L + start;
    gumbel += int64_t(shard) * L + start;
    // the flat draw's partial over this thread's filled slots, online
    float m_t = -INFINITY, s_t = 0.f;
    for (int r0 = 0; r0 < kSelItems; r0 += kSelBatch) {
      float p[kSelBatch], g[kSelBatch];
#pragma unroll
      for (int r = 0; r < kSelBatch; ++r) {
        const int j = (r0 + r) * kSelThreads + tid;
        p[r] = j < nv ? __ldg(prio + j) : 0.f;
        g[r] = j < nv ? __ldg(gumbel + j) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kSelBatch; ++r) {
        const int j = (r0 + r) * kSelThreads + tid;
        if (j >= len) continue;
        float s = -INFINITY;
        if (j < nv) {
          const float l = logit(p[r], alpha, eps);
          s = __fadd_rn(l, g[r]);
          if (kFlat) {
            if (l > m_t) {
              s_t = s_t * expf(m_t - l) + 1.f;
              m_t = l;
            } else if (l != -INFINITY) {
              s_t += expf(l - m_t);
            }
          }
        }
        sc[j] = s;
      }
    }
    if (kFlat) {  // m_b = max l, s_b = sum exp(l - m_b): fixed trees
      const float m_b = block_reduce<true>(m_t, red);
      const float s_b = block_reduce<false>(
          m_t == -INFINITY ? 0.f : s_t * expf(m_t - m_b), red);
      if (tid == 0) {
        flat.part[2 * blockIdx.x] = m_b;
        flat.part[2 * blockIdx.x + 1] = s_b;
        s_mz[0] = m_b;
        s_mz[1] = s_b;
      }
    }
  } else {
    in_s += int64_t(shard) * L + start;
    in_i += int64_t(shard) * L + start;
    for (int j = tid; j < len; j += kSelThreads) {
      sc[j] = in_s[j];
      si[j] = in_i[j];
    }
  }
  if (tid == 0) {
    s_prefix = 0;
    s_kr = kt;
    s_done = 0;
    s_count = 0;
  }
  auto key_of = [&](int j) {
    return entry_key(sc[j], kFirst ? start + j : si[j], start + j);
  };

  // Radix select over entries [0, nsel): after the pass over the digit at
  // `shift`, the k-th key's bits from 63 down to `shift` are s_prefix, and
  // s_kr of the kt keys share them. A pass whose bin is taken whole ends
  // the search. In the first level the filled slots lead and the -inf
  // slots past them rank by position, so only the filled ones are
  // searched, and none at all when they number at most kt: the top kt are
  // then the first kt slots.
  const bool direct = kFirst && nv <= kt;
  const int nsel = kFirst ? nv : len;
  const int rounds = direct ? 0 : (nsel + kSelThreads - 1) / kSelThreads;
  int shift = 64 - 8;
  while (rounds) {
    for (int b = tid; b < kReps * kRepStride; b += kSelThreads) hist[b] = 0;
    __syncthreads();
    const uint64_t prefix = s_prefix;
    for (int r = 0; r < rounds; ++r) {
      const int j = r * kSelThreads + tid;
      bool in = false;
      unsigned digit = 0;
      if (j < nsel) {
        const uint64_t key = key_of(j);
        in = shift == 56 || key >> (shift + 8) == prefix;
        digit = unsigned(key >> shift) & (kBins - 1);
      }
      const unsigned ins = __ballot_sync(0xffffffffu, in);
      if (!ins) continue;
      const int leader = __ffs(ins) - 1;
      const unsigned first = __shfl_sync(0xffffffffu, digit, leader);
      if (__all_sync(0xffffffffu, !in || digit == first)) {
        if (lane == leader) atomicAdd(&hist[first], __popc(ins));
      } else if (in) {  // lanes spread over kReps copies of the histogram
        atomicAdd(&hist[(lane & (kReps - 1)) * kRepStride + digit], 1u);
      }
    }
    __syncthreads();
    for (int b = tid; b < kBins; b += kSelThreads) {
      unsigned t = 0;
#pragma unroll
      for (int c = 0; c < kReps; ++c) t += hist[c * kRepStride + b];
      tot[b] = t;
    }
    __syncthreads();
    if (tid < 32) {  // lane l holds bins 255 - 8l down to 248 - 8l
      unsigned cnt[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += cnt[i] = tot[kBins - 1 - 8 * lane - i];
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const unsigned kr = s_kr;
      unsigned above = incl - sum;  // keys in the bins above this lane's
      if (above < kr && kr <= incl) {
        int pick = 0;
#pragma unroll
        for (int i = 0; i < 7; ++i)
          if (pick == i && above + cnt[i] < kr) {
            above += cnt[i];
            pick = i + 1;
          }
        unsigned taken = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (pick == i) taken = cnt[i];
        s_prefix = prefix << 8 | uint64_t(kBins - 1 - 8 * lane - pick);
        s_kr = kr - above;
        s_done = taken == kr - above;
      }
    }
    __syncthreads();
    if (s_done || shift == 0) break;  // keys are unique: done by shift 0
    shift -= 8;
  }

  // Gather the kt entries whose key is at or above the k-th one's.
  __syncthreads();  // s_count and the scores, where no pass ran
  const uint64_t threshold = s_prefix;
  float* os = out_s + (int64_t(shard) * gridDim.x + blockIdx.x) * k;
  int* oi = out_i + (int64_t(shard) * gridDim.x + blockIdx.x) * k;
  const int gather = direct ? (kt + kSelThreads - 1) / kSelThreads : rounds;
  for (int r = 0; r < gather; ++r) {
    const int j = r * kSelThreads + tid;
    const bool take = direct ? j < kt
                             : j < nsel && key_of(j) >> shift >= threshold;
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&s_count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (!take) continue;
    const int pos = base + __popc(ballot & ((1u << lane) - 1u));
    const int id = kFirst ? start + j : si[j];
    if (last) {
      ckey[pos] = key_of(j);
      cs[pos] = sc[j];
      ci[pos] = id;
    } else {
      os[pos] = sc[j];
      oi[pos] = id;
    }
  }
  if (!last) {
    for (int pos = kt + tid; pos < k; pos += kSelThreads) {
      os[pos] = -INFINITY;
      oi[pos] = -1;
    }
    return;
  }

  // Last level (kt = k: a shard holds at least k slots): each key's rank
  // is the count of larger keys, summed by g lanes per key.
  __syncthreads();
  int g = 32;
  while (g > 1 && g * k > kSelThreads) g >>= 1;
  const int c = tid / g, part = tid % g;
  unsigned rank = 0;
  if (c < k) {
    const uint64_t mine = ckey[c];
    for (int o = part; o < k; o += g) rank += ckey[o] > mine;
  }
  for (int off = g / 2; off > 0; off >>= 1)
    rank += __shfl_xor_sync(0xffffffffu, rank, off);
  if (!kFlat) {
    if (c < k && part == 0) {
      os[rank] = cs[c];
      oi[rank] = ci[c];
    }
    return;
  }

  // The flat draw's epilogue: the indices in key order (cs, unread from
  // here, holds them), m and Z from the first level's partials in tile
  // order, the chosen logits recomputed from p, the weights normalized
  // by their max. Positions at or past the filled count repeat the top.
  int* sel = reinterpret_cast<int*>(cs);
  if (c < k && part == 0) sel[rank] = ci[c];
  if (!one_tile && tid < 32) {  // one warp, a fixed tree: deterministic
    float m = -INFINITY, z = 0.f;
    for (int b = tid; b < flat.nparts; b += 32) m = fmaxf(m, flat.part[2 * b]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    for (int b = tid; b < flat.nparts; b += 32) {
      const float s_b = flat.part[2 * b + 1];
      if (s_b > 0.f) z += s_b * expf(flat.part[2 * b] - m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      z += __shfl_xor_sync(0xffffffffu, z, off);
    if (tid == 0) {
      s_mz[0] = m;
      s_mz[1] = z;
    }
  }
  __syncthreads();
  const float m = s_mz[0], z = s_mz[1];
  float w = 0.f;
  if (tid < k) {  // k <= kMaxN = kSelThreads: one position a thread
    const int id = tid < count ? sel[tid] : sel[0];
    const float p = __fdiv_rn(expf(logit(prio, id, alpha, eps) - m), z);
    w = powf(__fadd_rn(__fmul_rn(float(count), p), 1e-12f), -flat.beta);
    flat.idx[tid] = id;
  }
  const float wmax = block_reduce<true>(w, red);
  if (tid < k) flat.w[tid] = __fdiv_rn(w, fmaxf(wmax, 1e-12f));
}

// The select levels of one call: R rows of L entries, the top k of each;
// each level's candidates go to the workspace `ws` (the flat draw's
// partials after them), the last level's to scores/idx (the flat draw:
// its Flat outputs).
template <bool kFlat>
cudaError_t select_levels(const float* prio, const float* gumbel,
                          const int* nvalid, int R, int L, int k, float alpha,
                          float eps, float* ws, float* scores, int* idx,
                          Flat flat, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      shard_select_kernel<true, kFlat>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSelSmemFirst);
  if (err != cudaSuccess) return err;
  const float* in_s = nullptr;
  const int* in_i = nullptr;
  for (int first = 1;; first = 0) {
    const int tiles = (L + kSelTile - 1) / kSelTile;
    const bool last = tiles == 1;
    const int64_t n = int64_t(R) * tiles * k;
    float* os = last ? scores : ws;
    int* oi = last ? idx : reinterpret_cast<int*>(ws + n);
    const dim3 grid(tiles, R);
    if (first) {
      shard_select_kernel<true, kFlat><<<grid, kSelThreads, kSelSmemFirst,
                                         s>>>(
          prio, gumbel, nvalid, nullptr, nullptr, L, k, alpha, eps, last, os,
          oi, flat);
    } else {
      err = cudaFuncSetAttribute(shard_select_kernel<false, kFlat>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSelSmemCand);
      if (err != cudaSuccess) return err;
      shard_select_kernel<false, kFlat><<<grid, kSelThreads, kSelSmemCand,
                                          s>>>(
          kFlat ? prio : nullptr, nullptr, nullptr, in_s, in_i, L, k, alpha,
          eps, last, os, oi, flat);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    in_s = os;
    in_i = oi;
    ws += 2 * n;
    L = tiles * k;
  }
}

}  // namespace

extern "C" {

// The workspace shard_topk_c needs, in 4-byte words: per select level
// before the last, an (R, tiles, k) list of scores and one of indices; 0
// when chunk <= kSelTile (one launch).
long long shard_topk_workspace(int R, int chunk, int k) {
  long long words = 0;
  for (int L = chunk, tiles; (tiles = (L + kSelTile - 1) / kSelTile) > 1;
       L = tiles * k)
    words += 2LL * R * tiles * k;
  return words;
}

// The workspace prioritized_sample_c needs, in 4-byte words: the select
// levels' candidate lists (as shard_topk_c's for one shard), then a
// partial (m_b, s_b) per first-level tile.
long long prioritized_sample_workspace(int C, int n) {
  return shard_topk_workspace(1, C, n) + 2LL * ((C + kSelTile - 1) / kSelTile);
}

// prio, gumbel: (C,) contiguous f32; size: one int32 in device memory;
// workspace `ws` of prioritized_sample_workspace(C, n) words; outputs idx
// (n,) int32 and w (n,) f32. The select levels over the C slots with
// count max(size, 1), on `stream`: one launch when C <= kSelTile, a
// further one while a level leaves more than kSelTile candidates; when
// max(size, 1) <= kSelTile the first launch's block 0 finishes the draw
// and every other block returns at once. Allocates nothing; returns
// cudaGetLastError() (cudaErrorInvalidValue for n < 1, n > C, n > kMaxN
// or C > kMaxChunk).
int prioritized_sample_c(const float* prio, const float* gumbel,
                         const int* size, int C, int n, float alpha,
                         float beta, float eps, float* ws, int* idx, float* w,
                         void* stream) {
  if (n < 1 || n > C || n > kMaxN || C > kMaxChunk)
    return cudaErrorInvalidValue;
  const int tiles = (C + kSelTile - 1) / kSelTile;
  const Flat flat{size, beta, ws + shard_topk_workspace(1, C, n), tiles, idx,
                  w};
  return select_levels<true>(prio, gumbel, nullptr, 1, C, n, alpha, eps, ws,
                             w, idx, flat, static_cast<cudaStream_t>(stream));
}

// The per-shard candidate draw of the sharded replay service (the port of
// the Pallas `shard_topk_c`, src/repro/kernels/replay_sample/kernel.py:104,
// pallas_call at :113), R shards in one call: prio, gumbel (R, chunk)
// contiguous f32; nvalid (R,) int32 in device memory, each shard's LOCAL
// filled count (no max(., 1) guard); workspace `ws` of
// shard_topk_workspace(R, chunk, k) words (may be null when that is 0);
// outputs scores (R, k) f32 and idx (R, k) int32, per shard the top k of
// alpha * log(p + eps) + g over its filled slots in (score desc, index asc)
// order, positions past the filled count (-inf, position). Launches the
// select levels on `stream` (one when chunk <= kSelTile, a further one
// while a level leaves more than kSelTile candidates), allocates
// nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue for R outside [1, 65535], k < 1, k > chunk,
// k > kMaxN or chunk > kMaxChunk).
int shard_topk_c(const float* prio, const float* gumbel, const int* nvalid,
                 int R, int chunk, int k, float alpha, float eps, void* ws,
                 float* scores, int* idx, void* stream) {
  if (R < 1 || R > 65535 || k < 1 || k > chunk || k > kMaxN ||
      chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  return select_levels<false>(prio, gumbel, nvalid, R, chunk, k, alpha, eps,
                              static_cast<float*>(ws), scores, idx, Flat{},
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
