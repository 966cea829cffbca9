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
// pallas_call at :113) is the sharded replay service's per-shard draw: pass
// 1 exposed on its own over a (tiles, R shards) grid, each shard's LOCAL
// filled count read from device memory with no max(., 1) guard, then one
// merge block per shard down to its k candidates (no weights, no surplus
// rule). Slots past a shard's count come out as (-inf, position) directly:
// the Pallas kernel's finite _NEG stand-in is a TPU workaround that its
// ops.py turns back into -inf. One call covers all R shards. Bound: bytes,
// 8 per filled slot read plus 8 per candidate written.
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

__device__ __forceinline__ float logit(const float* prio, int i, float alpha,
                                       float eps) {
  return __fmul_rn(alpha, logf(__fadd_rn(__ldg(prio + i), eps)));
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

// Pass 1. kShard = false: the flat draw, one row of C slots, nvalid =
// max(size, 1), and the tile's partial (m_b, s_b) for the weights. kShard =
// true: blockIdx.y is the shard, each a row of C slots with its LOCAL count
// in size_p[blockIdx.y], no guard and no partials (the caller weighs
// against the global priority mass).
template <bool kShard>
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
  const int shard = kShard ? blockIdx.y : 0;
  prio += int64_t(shard) * C;
  gumbel += int64_t(shard) * C;
  const int start = blockIdx.x * kTile;
  const int len = min(kTile, C - start);
  const int nvalid = kShard ? __ldg(size_p + shard) : max(__ldg(size_p), 1);
  const int nv = min(max(nvalid - start, 0), len);  // filled: a prefix
  const int64_t list = int64_t(shard) * gridDim.x + blockIdx.x;
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
  if (!kShard) {
    m = block_reduce<true>(m, red_s);
    float z = 0.f;
    for (int j = threadIdx.x; j < nv; j += kThreads) z += expf(lg[j] - m);
    z = block_reduce<false>(z, red_s);
    if (threadIdx.x == 0) {
      part_m[blockIdx.x] = m;
      part_s[blockIdx.x] = z;
    }
  } else {
    __syncthreads();  // score[] complete before the first own_best
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

// Pass 2 of the sharded draw, one block per shard: a k-way merge of the
// shard's per-tile lists (one list per thread) under the (score desc, index
// asc) order, k rounds, writing the shard's k (score, local index) pairs.
// Every tile lists min(k, its length) real entries (filled slots first,
// then its -inf slots in index order), so k <= chunk real entries exist,
// and positions past the shard's filled count come out as (-inf, position).
__global__ void shard_merge_kernel(const float* __restrict__ cand_s,
                                   const int* __restrict__ cand_i,
                                   int nblocks, int k,
                                   float* __restrict__ s_out,
                                   int* __restrict__ i_out) {
  __shared__ float red_s[33];
  __shared__ int red_i[32];
  __shared__ Best win;
  const int t = threadIdx.x;
  const int64_t list = int64_t(blockIdx.x) * nblocks + t;
  float* out_s = s_out + int64_t(blockIdx.x) * k;
  int* out_i = i_out + int64_t(blockIdx.x) * k;
  float bs = NAN, ns = NAN;
  int bi = INT_MAX, ni = INT_MAX, next = 1;
  const float* my_s = cand_s + list * k;
  const int* my_i = cand_i + list * k;
  if (t < nblocks) {
    bs = my_s[0];
    bi = my_i[0];
    if (k > 1) {
      ns = my_s[1];
      ni = my_i[1];
    }
  }
  for (int r = 0; r < k; ++r) {
    const Best w = block_best(bs, bi, red_s, red_i, &win);
    if (t == 0) {
      out_s[r] = w.s;
      out_i[r] = w.i;
    }
    if (t < nblocks && w.i == bi) {  // this thread's list head won
      bs = ns;
      bi = ni;
      ++next;
      ns = next < k ? my_s[next] : NAN;
      ni = next < k ? my_i[next] : INT_MAX;
    }
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
  tile_topk_kernel<false><<<nblocks, kThreads, 0, s>>>(
      prio, gumbel, size, C, n, alpha, eps, cand_s, cand_i, part_m, part_s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = min(kMaxBlocks, (nblocks + 31) / 32 * 32);
  merge_kernel<<<1, threads, 0, s>>>(prio, size, nblocks, n, alpha, beta, eps,
                                     cand_s, cand_i, part_m, part_s, idx, w);
  return cudaGetLastError();
}

// The per-shard candidate draw of the sharded replay service (the port of
// the Pallas `shard_topk_c`, src/repro/kernels/replay_sample/kernel.py:104,
// pallas_call at :113), R shards in one call: prio, gumbel (R, chunk)
// contiguous f32; nvalid (R,) int32 in device memory, each shard's LOCAL
// filled count (no max(., 1) guard); workspace cand_s, cand_i
// (R * ceil(chunk / kTile) * k); outputs scores (R, k) f32 and idx (R, k)
// int32, per shard the top k of alpha * log(p + eps) + g over its filled
// slots in (score desc, index asc) order, positions past the filled count
// (-inf, position). Launches pass 1 over a (tiles, R) grid and one merge
// block per shard on `stream`, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for R outside [1, 65535], k < 1,
// k > chunk, k > kMaxN or chunk > kTile * kMaxBlocks).
int shard_topk_c(const float* prio, const float* gumbel, const int* nvalid,
                 int R, int chunk, int k, float alpha, float eps,
                 float* cand_s, int* cand_i, float* scores, int* idx,
                 void* stream) {
  if (R < 1 || R > 65535 || k < 1 || k > chunk || k > kMaxN)
    return cudaErrorInvalidValue;
  const int nblocks = (chunk + kTile - 1) / kTile;
  if (nblocks > kMaxBlocks) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_topk_kernel<true><<<dim3(nblocks, R), kThreads, 0, s>>>(
      prio, gumbel, nvalid, chunk, k, alpha, eps, cand_s, cand_i, nullptr,
      nullptr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = min(kMaxBlocks, (nblocks + 31) / 32 * 32);
  shard_merge_kernel<<<R, threads, 0, s>>>(cand_s, cand_i, nblocks, k, scores,
                                           idx);
  return cudaGetLastError();
}

}  // extern "C"
