// Fused prioritized replay draw (Gumbel-top-k) for Hopper (sm_90a), plain
// CUDA C++.
//
// Replaces the Pallas TPU kernel `prioritized_sample_c` in
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
// What bounds it on this card: bytes. It must read 8 bytes per filled slot
// (p and g) and write 8n; at C = 1M that is 8 MB, 2.5 us at 3.35 TB/s.
// The Pallas kernel keeps the whole (1, C) vector resident in VMEM and runs
// n rounds of argmax over it; 4 MB does not fit one SM's shared memory, so
// this kernel runs two passes:
//
//   Pass 1, one block per tile of kTile slots: the block reads its tile
//     once (slots past nvalid are never read), keeps logits and scores in
//     shared memory, writes its partial (m_b, s_b = sum exp(l - m_b)) and
//     its top n (score, global index) candidates in (score desc, index
//     asc) order. The selection is n rounds of a block-wide argmax; each
//     thread caches the best of its own slots and only the round's winner
//     rescans, so a round costs one block reduction. A tile with fewer
//     than n filled slots lists its -inf slots in index order, as a stable
//     sort would.
//   Pass 2, one block: a k-way merge of the per-tile lists, one list per
//     thread, n rounds of a block-wide argmax over the list heads under the
//     same (score desc, index asc) order. Comparing on the global index
//     makes the merge exact whatever order the blocks ran in. Then the
//     surplus rule, Z = sum_b s_b exp(m_b - m) in fixed block order (no
//     float atomics: the result is deterministic), the chosen logits
//     recomputed from p and the normalized weights.
//
// Numerics: logits and scores use __fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA, so they round exactly as the plain PyTorch version
// (two roundings, logf) does and the indices agree bitwise. Z is summed in
// another order than the plain version, so weights agree to rounding.
// Limits (checked by the launcher): n <= kMaxN, C <= kTile * kMaxBlocks
// (4M slots; the reference's capacities reach 1M).
//
// `shard_topk_c` (replacing the Pallas `shard_topk_c`, kernel.py:104,
// pallas_call at :113) is the sharded replay service's per-shard draw: per
// shard, from its LOCAL filled count (no max(., 1) guard), the top k of
// the same scores in (score desc, index asc) order; slots past the count
// score -inf and rank by position (the Pallas kernel's finite _NEG
// stand-in is a TPU workaround that its ops.py turns back into -inf). No
// weights, no surplus rule. One call covers all R shards.
//
// What bounds it on this card: bytes, 8 per filled slot read plus 8 per
// candidate written (31 ns at the replay=2 path shape, 5.7 us at four 1M
// slot shards). The draw above picks its n by n rounds of block argmax;
// at k = 64 to 256 those serial rounds, not the bytes, set the time, so
// the per-shard draw is a radix select instead, with no per-pick rounds:
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
//   A shard of at most kSelTile slots (both DQN path shapes) is one block:
//   one launch, no workspace. A larger shard runs one block per tile that
//   writes its k candidates (score, index) unsorted to a workspace,
//   padded with index -1 where a tile holds fewer than k slots, then the
//   same select over the candidates, kSelTile per block, until one block
//   holds them all: two launches at 1M slots, three at 4M with k = 1024.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;       // slots per pass-1 block
constexpr int kThreads = 256;     // pass-1 threads
constexpr int kMaxBlocks = 1024;  // pass 2 gives each pass-1 block a thread
constexpr int kMaxN = 1024;

struct Best {
  float s;
  int i;
};

// The draw order: score descending, then index ascending. NaN marks a taken
// or absent entry and ranks after everything (-inf included).
__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  const bool an = as != as, bn = bs != bs;
  if (an != bn) return bn;
  if (!an && as != bs) return as > bs;
  return ai < bi;
}

__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// The block's best (s, i), returned to every thread. blockDim.x is a
// multiple of 32. `red_*` hold one entry per warp, `win` the result; the
// two barriers keep one call's reads apart from the next call's writes.
__device__ __forceinline__ Best block_best(float s, int i, float* red_s,
                                           int* red_i, Best* win) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(s, i);
  if (lane == 0) {
    red_s[warp] = s;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < int(blockDim.x >> 5);
    s = has ? red_s[lane] : NAN;
    i = has ? red_i[lane] : INT_MAX;
    warp_best(s, i);
    if (lane == 0) *win = Best{s, i};
  }
  __syncthreads();
  return *win;
}

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

// The best untaken slot among this thread's own (j = threadIdx.x + t*kThreads).
__device__ __forceinline__ void own_best(const float* score, int len,
                                         int start, float& bs, int& bi) {
  bs = NAN;
  bi = INT_MAX;
  for (int j = threadIdx.x; j < len; j += kThreads)
    if (better(score[j], start + j, bs, bi)) {
      bs = score[j];
      bi = start + j;
    }
}

// Pass 1: one row of C slots, nvalid = max(size, 1), each block's top n
// candidates and its partial (m_b, s_b) for the weights.
__global__ void __launch_bounds__(kThreads)
    tile_topk_kernel(const float* __restrict__ prio,
                     const float* __restrict__ gumbel,
                     const int* __restrict__ size_p, int C, int n, float alpha,
                     float eps, float* __restrict__ cand_s,
                     int* __restrict__ cand_i, float* __restrict__ part_m,
                     float* __restrict__ part_s) {
  __shared__ float score[kTile];
  __shared__ float lg[kTile];
  __shared__ float red_s[33];
  __shared__ int red_i[32];
  __shared__ Best win;
  const int start = blockIdx.x * kTile;
  const int len = min(kTile, C - start);
  const int nvalid = max(__ldg(size_p), 1);
  const int nv = min(max(nvalid - start, 0), len);  // filled: a prefix
  const int64_t list = blockIdx.x;
  float* out_s = cand_s + list * n;
  int* out_i = cand_i + list * n;

  float m = -INFINITY;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    float l = -INFINITY, s = -INFINITY;
    if (j < nv) {
      l = logit(prio, start + j, alpha, eps);
      s = __fadd_rn(l, __ldg(gumbel + start + j));
    }
    lg[j] = l;
    score[j] = s;
    m = fmaxf(m, l);
  }
  m = block_reduce<true>(m, red_s);
  float z = 0.f;
  for (int j = threadIdx.x; j < nv; j += kThreads) z += expf(lg[j] - m);
  z = block_reduce<false>(z, red_s);
  if (threadIdx.x == 0) {
    part_m[blockIdx.x] = m;
    part_s[blockIdx.x] = z;
  }

  // the first nv picks are the filled slots; pick r >= nv is the -inf slot
  // start + r (index order), and picks past the tile are absent
  const int rounds = min(n, nv);
  float bs;
  int bi;
  own_best(score, len, start, bs, bi);
  for (int r = 0; r < rounds; ++r) {
    const Best w = block_best(bs, bi, red_s, red_i, &win);
    if (threadIdx.x == 0) {
      out_s[r] = w.s;
      out_i[r] = w.i;
    }
    if (w.i == bi) {  // this thread owns the winner
      score[w.i - start] = NAN;
      own_best(score, len, start, bs, bi);
    }
  }
  for (int r = rounds + threadIdx.x; r < n; r += kThreads) {
    out_s[r] = r < len ? -INFINITY : NAN;
    out_i[r] = r < len ? start + r : INT_MAX;
  }
}

__global__ void merge_kernel(const float* __restrict__ prio,
                             const int* __restrict__ size_p, int nblocks,
                             int n, float alpha, float beta, float eps,
                             const float* __restrict__ cand_s,
                             const int* __restrict__ cand_i,
                             const float* __restrict__ part_m,
                             const float* __restrict__ part_s,
                             int* __restrict__ idx_out,
                             float* __restrict__ w_out) {
  __shared__ int sel[kMaxN];
  __shared__ float red_s[33];
  __shared__ int red_i[32];
  __shared__ Best win;
  __shared__ float mz[2];
  const int t = threadIdx.x;
  const float* my_s = cand_s + int64_t(t) * n;
  const int* my_i = cand_i + int64_t(t) * n;
  // the list's head (bs, bi) and the entry after it, loaded one win
  // ahead so a win rarely waits on a load
  float bs = NAN, ns = NAN;
  int bi = INT_MAX, ni = INT_MAX, next = 1;
  if (t < nblocks) {
    bs = my_s[0];
    bi = my_i[0];
    if (n > 1) {
      ns = my_s[1];
      ni = my_i[1];
    }
  }
  for (int r = 0; r < n; ++r) {
    const Best w = block_best(bs, bi, red_s, red_i, &win);
    if (t == 0) sel[r] = w.i;
    if (t < nblocks && w.i == bi) {  // this thread's list head won
      bs = ns;
      bi = ni;
      ++next;
      ns = next < n ? my_s[next] : NAN;
      ni = next < n ? my_i[next] : INT_MAX;
    }
  }
  if (t == 0) {
    float m = -INFINITY;
    for (int b = 0; b < nblocks; ++b) m = fmaxf(m, part_m[b]);
    float z = 0.f;
    for (int b = 0; b < nblocks; ++b)
      if (part_s[b] > 0.f) z += part_s[b] * expf(part_m[b] - m);
    mz[0] = m;
    mz[1] = z;
  }
  __syncthreads();
  const int nvalid = max(__ldg(size_p), 1);
  const float m = mz[0], z = mz[1];
  float wmax = 0.f;
  for (int j = t; j < n; j += blockDim.x) {
    const int id = j < nvalid ? sel[j] : sel[0];  // surplus repeats the top
    const float p = __fdiv_rn(expf(logit(prio, id, alpha, eps) - m), z);
    const float w = powf(__fadd_rn(__fmul_rn(float(nvalid), p), 1e-12f),
                         -beta);
    idx_out[j] = id;
    w_out[j] = w;
    wmax = fmaxf(wmax, w);
  }
  wmax = block_reduce<true>(wmax, red_s);
  for (int j = t; j < n; j += blockDim.x)
    w_out[j] = __fdiv_rn(w_out[j], fmaxf(wmax, 1e-12f));
}

// ---- shard_topk_c: the per-shard draw as a radix select ----

constexpr int kSelThreads = 1024;
constexpr int kSelTile = 16384;              // entries per select block
constexpr int kSelItems = kSelTile / kSelThreads;
constexpr int kSelBatch = 8;                 // slots a thread loads at once
constexpr int kBins = 256;                   // 8-bit digits
constexpr int kReps = 8;                     // copies of the histogram
constexpr int kRepStride = kBins + 1;        // a copy per bank offset
constexpr int kMaxChunk = kTile * kMaxBlocks;  // as the flat draw's C
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

// One level of the select; grid (tiles, R), kSelThreads threads. kFirst:
// the entries are shard row blockIdx.y of prio/gumbel (L = chunk slots,
// the LOCAL count in nvalid[blockIdx.y]); else row blockIdx.y of the
// (R, L) candidate lists in_s/in_i of the level before. The block takes
// entries [blockIdx.x * kSelTile, + kSelTile) and selects the top
// kt = min(k, its length) by key. `last` (one tile): writes the shard's k
// in key order to out_s/out_i (R, k). Else: writes them unsorted to list
// (blockIdx.y, blockIdx.x) of out_s/out_i (R, tiles, k), padded to k with
// (-inf, -1).
template <bool kFirst>
__global__ void __launch_bounds__(kSelThreads) shard_select_kernel(
    const float* __restrict__ prio, const float* __restrict__ gumbel,
    const int* __restrict__ nvalid, const float* __restrict__ in_s,
    const int* __restrict__ in_i, int L, int k, float alpha, float eps,
    bool last, float* __restrict__ out_s, int* __restrict__ out_i) {
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
  const int tid = threadIdx.x, lane = tid & 31;
  const int shard = blockIdx.y;
  const int start = blockIdx.x * kSelTile;
  const int len = min(kSelTile, L - start);
  const int kt = min(k, len);
  // filled slots of the tile (first level): a prefix
  const int nv = kFirst ? min(max(__ldg(nvalid + shard) - start, 0), len) : 0;

  if (kFirst) {  // scores as the flat draw computes them; loads first
    prio += int64_t(shard) * L + start;
    gumbel += int64_t(shard) * L + start;
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
        if (j < len)
          sc[j] = j < nv ? __fadd_rn(logit(p[r], alpha, eps), g[r])
                         : -INFINITY;
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
  if (c < k && part == 0) {
    os[rank] = cs[c];
    oi[rank] = ci[c];
  }
}

}  // namespace

extern "C" {

// Slots per pass-1 block: the wrapper sizes the workspace with it.
int replay_sample_tile() { return kTile; }

// prio, gumbel: (C,) contiguous f32; size: one int32 in device memory;
// workspace from the caller: cand_s, cand_i (ceil(C / kTile) * n) and
// part_m, part_s (ceil(C / kTile)); outputs idx (n,) int32 and w (n,) f32.
// Launches both passes on `stream`, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for n < 1, n > C, n > kMaxN or
// C > kTile * kMaxBlocks).
int prioritized_sample_c(const float* prio, const float* gumbel,
                         const int* size, int C, int n, float alpha,
                         float beta, float eps, float* cand_s, int* cand_i,
                         float* part_m, float* part_s, int* idx, float* w,
                         void* stream) {
  if (n < 1 || n > C || n > kMaxN) return cudaErrorInvalidValue;
  const int nblocks = (C + kTile - 1) / kTile;
  if (nblocks > kMaxBlocks) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_topk_kernel<<<nblocks, kThreads, 0, s>>>(
      prio, gumbel, size, C, n, alpha, eps, cand_s, cand_i, part_m, part_s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = min(kMaxBlocks, (nblocks + 31) / 32 * 32);
  merge_kernel<<<1, threads, 0, s>>>(prio, size, nblocks, n, alpha, beta, eps,
                                     cand_s, cand_i, part_m, part_s, idx, w);
  return cudaGetLastError();
}

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      shard_select_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSelSmemFirst);
  if (err != cudaSuccess) return err;
  const float* in_s = nullptr;
  const int* in_i = nullptr;
  float* next = static_cast<float*>(ws);
  for (int L = chunk, first = 1;; first = 0) {
    const int tiles = (L + kSelTile - 1) / kSelTile;
    const bool last = tiles == 1;
    const int64_t n = int64_t(R) * tiles * k;
    float* os = last ? scores : next;
    int* oi = last ? idx : reinterpret_cast<int*>(next + n);
    const dim3 grid(tiles, R);
    if (first) {
      shard_select_kernel<true><<<grid, kSelThreads, kSelSmemFirst, s>>>(
          prio, gumbel, nvalid, nullptr, nullptr, L, k, alpha, eps, last, os,
          oi);
    } else {
      err = cudaFuncSetAttribute(shard_select_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSelSmemCand);
      if (err != cudaSuccess) return err;
      shard_select_kernel<false><<<grid, kSelThreads, kSelSmemCand, s>>>(
          nullptr, nullptr, nullptr, in_s, in_i, L, k, alpha, eps, last, os,
          oi);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    in_s = os;
    in_i = oi;
    next += 2 * n;
    L = tiles * k;
  }
}

}  // extern "C"
