// V-trace targets for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `vtrace_tb` in
// src/repro/kernels/vtrace/kernel.py:46 (pallas_call at :55): from
// log importance ratios, discounts, rewards and values (T, B) f32
// time-major and the bootstrap value V_T (B,),
//
//     rho_t = min(rho_bar, e^{log rho_t}),  c_t = min(c_bar, e^{log rho_t})
//     acc_t = rho_t (r_t + g_t V_{t+1} - V_t) + g_t c_t acc_{t+1}
//     vs_t  = V_t + acc_t
//     pg_adv_t = rho_t (r_t + g_t vs_{t+1} - V_t),   vs_T = V_T
//
// Both outputs are targets (stop-gradient in the reference), so there is
// no backward.
//
// What bounds it on this card: bytes and one serial chain. It moves
// 4*(6TB + B) bytes, and each column is a chain of T dependent FMAs of
// ~4 cycles, T*4/1.98 GHz. At the training path's (T, B) = (32, 32) both
// are a few ns, so launch latency bounds it. The Pallas kernel sweeps
// twice (the scan for vs, then pg_adv over the whole block); here pg_adv_t
// needs only vs_{t+1}, the previous step's value, so one reverse pass
// writes both and no input is read twice. The loads of kUnroll timesteps
// are issued into registers ahead of their FMAs, so at large T the chain
// waits on one load latency per kUnroll steps, not one per step.
//
// Design: one thread owns one batch column b, blocks of kThreads tile B
// and mask b < B (no padding copy); inputs are read through (row, column)
// strides, so the ops layer copies nothing; the carries (acc, V_{t+1},
// vs_{t+1}) live in registers. exp is expf (full precision). nvcc contracts
// products and sums into FMAs, so results differ from an unfused plain
// loop by rounding only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

struct Mat {  // a read-only (T, B) f32 view
  const float* p;
  int64_t s0, s1;
  __device__ __forceinline__ float at(int64_t t, int64_t b) const {
    return __ldg(p + t * s0 + b * s1);
  }
};

struct Carry {
  float acc, v_next, vs_next;
};

__device__ __forceinline__ void vtrace_step(Carry& c, float log_rho,
                                            float disc, float rew, float val,
                                            float clip_rho, float clip_c,
                                            float* vs, float* adv) {
  const float w = expf(log_rho);
  const float rho = fminf(clip_rho, w);
  const float cc = fminf(clip_c, w);
  const float delta = rho * (rew + disc * c.v_next - val);
  c.acc = delta + disc * cc * c.acc;
  const float vs_t = val + c.acc;
  *adv = rho * (rew + disc * c.vs_next - val);
  *vs = vs_t;
  c.v_next = val;
  c.vs_next = vs_t;
}

__global__ void vtrace_kernel(Mat log_rhos, Mat discounts, Mat rewards,
                              Mat values, const float* bootstrap,
                              int64_t boot_s, float clip_rho, float clip_c,
                              float* vs, float* adv, int T, int B) {
  const int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  const float boot = __ldg(bootstrap + b * boot_s);
  Carry c{0.f, boot, boot};
  int t = T - 1;
  for (; t >= kUnroll - 1; t -= kUnroll) {
    float lr[kUnroll], d[kUnroll], r[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      lr[u] = log_rhos.at(t - u, b);
      d[u] = discounts.at(t - u, b);
      r[u] = rewards.at(t - u, b);
      v[u] = values.at(t - u, b);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = int64_t(t - u) * B + b;
      vtrace_step(c, lr[u], d[u], r[u], v[u], clip_rho, clip_c, vs + i,
                  adv + i);
    }
  }
  for (; t >= 0; --t) {
    const int64_t i = int64_t(t) * B + b;
    vtrace_step(c, log_rhos.at(t, b), discounts.at(t, b), rewards.at(t, b),
                values.at(t, b), clip_rho, clip_c, vs + i, adv + i);
  }
}

}  // namespace

extern "C" {

// log_rhos, discounts, rewards, values: (T, B) f32 with strides (s0, s1)
// in elements; bootstrap (B,) with stride boot_s; vs and adv contiguous
// (T, B). Launches on `stream`, allocates nothing, returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for T or
// B < 1).
int vtrace_tb(const float* log_rhos, int64_t lr_s0, int64_t lr_s1,
              const float* discounts, int64_t d_s0, int64_t d_s1,
              const float* rewards, int64_t r_s0, int64_t r_s1,
              const float* values, int64_t v_s0, int64_t v_s1,
              const float* bootstrap, int64_t boot_s, float clip_rho,
              float clip_c, float* vs, float* adv, int T, int B,
              void* stream) {
  if (T < 1 || B < 1) return cudaErrorInvalidValue;
  vtrace_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      Mat{log_rhos, lr_s0, lr_s1}, Mat{discounts, d_s0, d_s1},
      Mat{rewards, r_s0, r_s1}, Mat{values, v_s0, v_s1}, bootstrap, boot_s,
      clip_rho, clip_c, vs, adv, T, B);
  return cudaGetLastError();
}

}  // extern "C"
