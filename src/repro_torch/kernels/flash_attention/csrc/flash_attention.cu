// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_attention_hsd` in
// src/repro/kernels/flash_attention/kernel.py:77 (pallas_call at :96):
// online-softmax grouped-query attention, query head h reads kv head
// h / G, scale D^-0.5 applied to q, masks `causal` (kpos <= qpos),
// `window` (kpos > qpos - window) and `valid_len` (kpos < valid_len),
// f32 accumulation, output in q's dtype.
//
// What bounds it on this card: at the serving shape of the policy trunk
// (B = bucket <= 32, H = 4, S = 4, D = 64) one call reads and writes a few
// tens of KB and does well under a MFLOP, so neither bytes nor operations
// bound it: launch latency does. The design answers that by doing the
// whole attention in ONE launch with no padding copy, no transposes and
// no scratch: the kernel reads the model's (B, S, KVH, G, D) layout
// through strides, masks the ragged edge itself (S = 4 sits far below a
// tile), and allocates nothing. At long S it is bound by the CUDA-core
// f32 FMA rate (no tensor cores yet); making it fast there is later work.
//
// Design: one thread block of 4 warps per (query tile of 16 rows, head,
// batch). Warp w owns rows w, w+4, w+8, w+12 of the tile, so a tiny S
// still spreads over the warps. K/V tiles of 32 keys are staged in
// dynamic shared memory as f32 (D = 256 needs ~80 KB, above the 48 KB
// static limit). For the scores, lane j owns key j of the tile and dots
// it with each of the warp's rows (K rows padded to D+1 floats so the 32
// lanes hit 32 banks); the row max and row sum are warp reductions with
// __shfl_xor_sync. For P.V, lane i owns D/32 output columns and takes
// each p_j from lane j with __shfl_sync. The running (m, l, acc) live in
// f32 registers. Every product and sum is f32 on the CUDA cores (no
// TF32). Each row only visits keys in [window lower limit, causal upper
// limit), and the tile loop of a block runs over the union of its rows'
// ranges, so masked blocks are never loaded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockM = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockN = 32;                      // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
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
};

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; scale is D^-0.5 as the caller
// rounds it to f32 (the reference multiplies q by it). Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a head dim or dtype it does not take).
int flash_attention_hsd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int KVH, int S, int D,
                        int causal, int window, int kv_end, float scale,
                        int64_t q_b,
                        int64_t q_h, int64_t q_s, int64_t k_b, int64_t k_h,
                        int64_t k_s, int64_t v_b, int64_t v_h, int64_t v_s,
                        int64_t o_b, int64_t o_h, int64_t o_s, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0)
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, H, KVH, S, kv_end, causal, window, scale,
         q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(a, B, D, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, B, D, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
