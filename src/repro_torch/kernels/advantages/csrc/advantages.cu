// Discounted-return reverse scan and its adjoint for Hopper (sm_90a),
// plain CUDA C++.
//
// Replaces the Pallas TPU kernel `discounted_return_tb` in
// src/repro/kernels/advantages/kernel.py:37 (pallas_call at :43): the
// first-order reverse recurrence
//
//     out_t = base_t + coef_t * out_{t+1},      out_T = init
//
// over (T, B) f32 time-major inputs, which carries PPO's GAE
// (base = delta, coef = gamma*lambda*(1-done), init = 0) and A3C's n-step
// return (base = r, coef = gamma*(1-done), init = V(s_T)). The A3C loss
// differentiates through the n-step return into the bootstrap value, so
// this source also holds the adjoint scan, which runs forward in time:
//
//     a_0 = g_0,  a_t = g_t + coef_{t-1} * a_{t-1}
//     dbase_t = a_t,  dcoef_t = a_t * out_{t+1} (out_T = init),
//     dinit = coef_{T-1} * a_{T-1}
//
// What bounds it on this card: bytes and one serial chain. The forward
// moves 4*(3TB + B) bytes and the adjoint 4*(5TB + 2B); each column is a
// chain of T dependent FMAs of ~4 cycles, T*4/1.98 GHz. At the training
// path's (T, B) = (32, 32) both are a few ns, so launch latency bounds the
// kernels. At large T a loop that waits on each step's global load would
// cost T load latencies (~1 ms at T = 2048); the design issues the loads
// of kUnroll timesteps into registers ahead of their FMAs, so the chain
// waits on one load latency per kUnroll steps.
//
// Design: one thread owns one batch column b, blocks of kThreads tile B
// and mask b < B (no padding copy). Row t of every input is contiguous in
// the usual layout, so each step's loads are coalesced along B; inputs are
// read through (row, column) strides, so the ops layer copies nothing and
// autograd's expanded (stride 0) gradients are taken as they come. The
// carry lives in a register. Outputs are contiguous (T, B). nvcc contracts
// `base + coef*acc` into one FMA, so results differ from an unfused plain
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

__global__ void discounted_return_fwd(Mat base, Mat coef, const float* init,
                                      int64_t init_s, float* out, int T,
                                      int B) {
  const int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  float acc = __ldg(init + b * init_s);
  int t = T - 1;
  for (; t >= kUnroll - 1; t -= kUnroll) {
    float bv[kUnroll], cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bv[u] = base.at(t - u, b);
      cv[u] = coef.at(t - u, b);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = bv[u] + cv[u] * acc;
      out[int64_t(t - u) * B + b] = acc;
    }
  }
  for (; t >= 0; --t) {
    acc = base.at(t, b) + coef.at(t, b) * acc;
    out[int64_t(t) * B + b] = acc;
  }
}

// dbase / dcoef / dinit may be null: the caller asks only for the
// gradients autograd needs. The chain over `a` runs either way.
__global__ void discounted_return_adj(Mat g, Mat coef, Mat out,
                                      const float* init, int64_t init_s,
                                      float* dbase, float* dcoef,
                                      float* dinit, int T, int B) {
  const int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  const float out_T = __ldg(init + b * init_s);
  float a = 0.f, c_prev = 0.f;  // a_{-1} = 0 makes a_0 = g_0
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float gv[kUnroll], cv[kUnroll], ov[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      gv[u] = g.at(t + u, b);
      cv[u] = coef.at(t + u, b);
      ov[u] = (dcoef && t + u + 1 < T) ? out.at(t + u + 1, b) : out_T;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a = gv[u] + c_prev * a;
      c_prev = cv[u];
      const int64_t i = int64_t(t + u) * B + b;
      if (dbase) dbase[i] = a;
      if (dcoef) dcoef[i] = a * ov[u];
    }
  }
  for (; t < T; ++t) {
    a = g.at(t, b) + c_prev * a;
    c_prev = coef.at(t, b);
    const int64_t i = int64_t(t) * B + b;
    if (dbase) dbase[i] = a;
    if (dcoef) dcoef[i] = a * (t + 1 < T ? out.at(t + 1, b) : out_T);
  }
  if (dinit) dinit[b] = c_prev * a;
}

inline dim3 grid_for(int B) { return dim3((B + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Inputs are (T, B) f32 with strides (s0, s1) in elements; init is (B,)
// with stride init_s; out is a contiguous (T, B) buffer. Launches on
// `stream`, allocates nothing, returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for T or B < 1).
int discounted_return_tb(const float* base, int64_t base_s0, int64_t base_s1,
                         const float* coef, int64_t coef_s0, int64_t coef_s1,
                         const float* init, int64_t init_s, float* out,
                         int T, int B, void* stream) {
  if (T < 1 || B < 1) return cudaErrorInvalidValue;
  discounted_return_fwd<<<grid_for(B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      Mat{base, base_s0, base_s1}, Mat{coef, coef_s0, coef_s1}, init, init_s,
      out, T, B);
  return cudaGetLastError();
}

// g, coef, out: (T, B) f32 with strides; init (B,) with stride init_s.
// dbase, dcoef: contiguous (T, B) or null; dinit: (B,) or null.
int discounted_return_adjoint_tb(const float* g, int64_t g_s0, int64_t g_s1,
                                 const float* coef, int64_t coef_s0,
                                 int64_t coef_s1, const float* out,
                                 int64_t out_s0, int64_t out_s1,
                                 const float* init, int64_t init_s,
                                 float* dbase, float* dcoef, float* dinit,
                                 int T, int B, void* stream) {
  if (T < 1 || B < 1) return cudaErrorInvalidValue;
  discounted_return_adj<<<grid_for(B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      Mat{g, g_s0, g_s1}, Mat{coef, coef_s0, coef_s1},
      Mat{out, out_s0, out_s1}, init, init_s, dbase, dcoef, dinit, T, B);
  return cudaGetLastError();
}

}  // extern "C"
