// Flash-attention backward for Hopper (sm_90a), f32, short key spans:
// flash_short_bwd_f32<D>, plain CUDA C++ on the CUDA cores.
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
// dO, dq (B S H D each), k, v, dk, dv (B S KVH D each) and lse: ~6 MB at
// B 256, D 64, about 2 us at 3.35 TB/s, against ~0.1 GFLOP; the bytes,
// and at small B the launch, bound it.
//
// Design: one block of 8 warps per (batch, kv head). It owns the group's
// S * G query rows (r = qpos * G + g, h = kvh * G + g) and all kv_end
// <= 32 keys, so dK and dV are summed over the group inside the block, in
// one fixed order (row by row), with no atomics: a repeat is bitwise. K
// and V are staged once in shared memory (rows padded to D + 1 floats, so
// lane j reading key j at one d hits its own bank); the rows come in
// chunks of 16 with their q and dO. Phase 1, a warp a row: lane j is key
// j and computes s_j and dP_j (one FMA chain over d each), P_j and dS_j;
// Δ is a warp sum over the lanes' dims d = lane + 32 i; dQ's dims
// d = lane + 32 i take each dS_j from lane j by shuffle, and the row
// writes dQ. P and dS go to shared memory. Phase 2: thread t owns the
// (key, dim) elements t, t + 256, ... of dK and dV for the whole call and
// adds the chunk's rows in order. The strides of every operand are read
// as given (head dim contiguous); the wrapper hands dO over as autograd
// gives it when its head dim is contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpan = 32;       // the longest key range it takes
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;      // query rows staged at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
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

// floats of shared memory for n keys
template <int D>
__host__ __device__ constexpr int bwd_smem_floats(int n) {
  return 2 * n * (D + 1) + 2 * kChunk * D + 2 * kChunk * kSpan + 2 * n * D;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_short_bwd_f32(BwdArgs a) {
  constexpr int KS = D + 1;     // padded K, V row
  constexpr int kPer = D / 32;  // dims per lane
  extern __shared__ float bwd_smem[];
  const int n = a.kv_end;
  float* sK = bwd_smem;              // [n][KS]
  float* sV = sK + n * KS;           // [n][KS]
  float* sQ = sV + n * KS;           // [kChunk][D]
  float* sdO = sQ + kChunk * D;      // [kChunk][D]
  float* sP = sdO + kChunk * D;      // [kChunk][kSpan]
  float* sdS = sP + kChunk * kSpan;  // [kChunk][kSpan]
  float* sdK = sdS + kChunk * kSpan; // [n][D], unscaled
  float* sdV = sdK + n * D;          // [n][D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KVH, M = a.S * G;
  const int b = blockIdx.x / a.KVH, kvh = blockIdx.x - b * a.KVH;
  const float* k = a.k + b * a.k_b + kvh * a.k_h;
  const float* v = a.v + b * a.v_b + kvh * a.v_h;
  for (int i = tid; i < n * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    sK[j * KS + d] = k[j * a.k_s + d];
    sV[j * KS + d] = v[j * a.v_s + d];
    sdK[i] = 0.f;
    sdV[i] = 0.f;
  }

  for (int r0 = 0; r0 < M; r0 += kChunk) {
    const int R = min(kChunk, M - r0);
    __syncthreads();  // K, V staged; the last chunk's phase 2 is done
    for (int i = tid; i < R * D; i += kThreads) {
      const int rr = i / D, d = i - rr * D, row = r0 + rr;
      const int qpos = row / G, h = kvh * G + row - qpos * G;
      sQ[i] = a.q[b * a.q_b + h * a.q_h + qpos * a.q_s + d];
      sdO[i] = a.dout[b * a.do_b + h * a.do_h + qpos * a.do_s + d];
    }
    __syncthreads();

    // phase 1: a warp a row, lane j key j
    for (int rr = warp; rr < R; rr += kWarps) {
      const int row = r0 + rr, qpos = row / G, h = kvh * G + row - qpos * G;
      const int lo = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
      const int hi = a.causal ? min(qpos + 1, n) : n;
      const bool valid = lane >= lo && lane < hi;
      const float* qrow = sQ + rr * D;
      const float* dorow = sdO + rr * D;
      const float* krow = sK + min(lane, n - 1) * KS;
      const float* vrow = sV + min(lane, n - 1) * KS;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qrow[d] * a.scale, krow[d], s);
        dp = fmaf(dorow[d], vrow[d], dp);
      }
      const float* orow = a.o + b * a.o_b + h * a.o_h + qpos * a.o_s;
      float delta = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        delta = fmaf(dorow[lane + 32 * i], orow[lane + 32 * i], delta);
      delta = warp_sum(delta);
      const float lse = a.lse[(int64_t(b) * a.H + h) * a.S + qpos];
      const float p = valid ? expf(s - lse) : 0.f;
      const float ds = p * (dp - delta);
      if (lane < n) {
        sP[rr * kSpan + lane] = p;
        sdS[rr * kSpan + lane] = ds;
      }
      float acc[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
      for (int j = 0; j < n; ++j) {
        const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          acc[i] = fmaf(dsj, sK[j * KS + lane + 32 * i], acc[i]);
      }
      float* dqrow = a.dq + b * a.dq_b + h * a.dq_h + qpos * a.dq_s + lane;
#pragma unroll
      for (int i = 0; i < kPer; ++i) dqrow[32 * i] = acc[i] * a.scale;
    }
    __syncthreads();

    // phase 2: thread t owns elements t + 256 m of dK and dV; rows in order
    for (int i = tid; i < n * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      float dk = sdK[i], dv = sdV[i];
      for (int rr = 0; rr < R; ++rr) {
        dv = fmaf(sP[rr * kSpan + j], sdO[rr * D + d], dv);
        dk = fmaf(sdS[rr * kSpan + j], sQ[rr * D + d], dk);
      }
      sdK[i] = dk;
      sdV[i] = dv;
    }
  }

  // each thread writes the elements it summed (the same i); key rows at
  // or past kv_end get zeros
  for (int i = tid; i < a.S * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    const bool in = j < n;
    a.dk[b * a.dk_b + kvh * a.dk_h + j * a.dk_s + d] =
        in ? sdK[i] * a.scale : 0.f;
    a.dv[b * a.dv_b + kvh * a.dv_h + j * a.dv_s + d] = in ? sdV[i] : 0.f;
  }
}

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int kMaxSmem = bwd_smem_floats<D>(kSpan) * 4;
  static bool configured = false;  // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_short_bwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int64_t blocks = int64_t(B) * a.KVH;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = size_t(bwd_smem_floats<D>(a.kv_end)) * 4;
  flash_short_bwd_f32<D><<<unsigned(blocks), kThreads, smem, stream>>>(a);
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
  BwdArgs a{p->q,    p->k,    p->v,    p->o,    p->dout, p->lse,
            p->dq,   p->dk,   p->dv,   p->H,    p->KVH,  p->S,
            p->kv_end, p->causal, p->window, p->scale,
            p->q_b,  p->q_h,  p->q_s,  p->k_b,  p->k_h,  p->k_s,
            p->v_b,  p->v_h,  p->v_s,  p->o_b,  p->o_h,  p->o_s,
            p->do_b, p->do_h, p->do_s, p->dq_b, p->dq_h, p->dq_s,
            p->dk_b, p->dk_h, p->dk_s, p->dv_b, p->dv_h, p->dv_s};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->D) {
    case 32: return launch_bwd<32>(a, p->B, s);
    case 64: return launch_bwd<64>(a, p->B, s);
    case 128: return launch_bwd<128>(a, p->B, s);
    case 256: return launch_bwd<256>(a, p->B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
