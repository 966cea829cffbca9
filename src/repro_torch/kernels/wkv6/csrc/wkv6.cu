// Chunked RWKV-6 WKV for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel `wkv6_btHN` in
// src/repro/kernels/wkv6/kernel.py:59 (pallas_call at :69), and computes
// the function of its oracle `wkv6_ref` (src/repro/kernels/wkv6/ref.py):
// for every (b, h), with S the (N, N) state,
//     y_t = r_t · (S_{t-1} + u ⊙ k_t v_tᵀ),   S_t = diag(e^{logw_t}) S_{t-1} + k_t v_tᵀ,
// blocked in chunks of L steps as the Pallas kernel blocks it. Within a
// chunk, with c the inclusive cumsum of logw (c_{-1} = 0) and c_L its
// last row:
//     score[t, j] = Σ_n r_t k_j e^{c_{t-1} − c_j}   (j < t),
//     score[t, t] = Σ_n r_t u k_t,
//     y_t = Σ_{j≤t} score[t, j] v_j + (r_t ⊙ e^{c_{t-1}}) · S,
//     S  ← e^{c_L} ⊙ S + Σ_j (k_j ⊙ e^{c_L − c_j}) v_jᵀ.
// The Pallas kernel starts from S = 0 and drops the final S; this one
// takes an optional initial S (which may alias the output S: each block
// reads its own (b, h) state before it writes it) and writes the final S.
// Inputs r, k, v, logw (B, T, H, N), u (H, N), S (B, H, N, N), y
// (B, T, H, N): f32, contiguous. N <= 64, 1 <= L <= 64.
//
// What bounds it on this card: at the serve prefill (B 4, T 32, H 32,
// N 64) the call moves ~9.4 MB (r, k, v, logw, y and S in and out), 2.8
// us at 3.35 TB/s, and the recurrence needs 5N² + 6N f32 operations per
// step and (b, h), 0.085 G (1.3 us at 67 TFLOP/s); at T = 512, 88 MB
// (26 us) against 1.37 G (20 us): bytes bound at every serve shape. At
// decode (T = 1) it is the 4.2 MB of S read and written, 1.3 us. The
// chunks of a row form a chain of T / L dependent state updates, but each
// is thousands of independent operations, so the chain is not the bound.
// A kernel of this design is bound by its own latency instead: one block
// per (b, h) (128 blocks at the serve shape for 132 SMs), and inside a
// chunk each of the L(L−1)/2 pairwise scores sums N terms that each take
// an `expf` of a difference.
//
// Design: one block of 256 threads per (b, h) walks the row's chunks in
// order, the state in shared memory for the whole row (16 KB at N = 64).
// Each chunk stages r, k, v and logw (turned into c in place) in shared
// memory, rows padded to N + 1 floats so that threads reading the same n
// of different rows hit different banks. The score is accumulated over n
// in registers, one (t, j) pair per thread: the (L, L, N) decay tensor of
// the Pallas kernel (1 MiB at L = N = 64) is never built. Every exponent
// is a difference c_{t−1} − c_j or c_L − c_j of one cumsum, <= 0 for
// logw <= 0, and is never split into e^{c_{t−1}}·e^{−c_j} (e^{−c_j}
// overflows once the decays accumulate); that split, which would make the
// score a tensor-core matmul, is later work with sub-chunking. Then r and
// k take their decays in place, y is written straight to device memory
// and S is updated. IEEE f32 throughout: no TF32, no fast math, no
// atomics, so a call repeats bitwise. A ragged last chunk is masked (the
// loops run to its length): no padded copy. Shared memory: (N² + 4L(N+1)
// + L²) floats, 97 KB at L = N = 64, above the 48 KB default, so the
// launcher raises the kernel's dynamic shared-memory limit first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 64;
constexpr int kMaxL = 64;

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* logw;
  const float* u;
  const float* s0;  // nullptr: zero initial state
  float* y;
  float* s_out;
  int T, H, N, L;
};

size_t smem_bytes(int N, int L) {
  return sizeof(float) * (static_cast<size_t>(N) * N +
                          4 * static_cast<size_t>(L) * (N + 1) +
                          static_cast<size_t>(L) * L);
}

__global__ void __launch_bounds__(kThreads) wkv6_chunk_kernel(Args a) {
  extern __shared__ float smem[];
  const int N = a.N, L = a.L, P = N + 1;  // P: padded row pitch
  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  float* S = smem;              // (N, N), S[n * N + m]
  float* rs = S + N * N;        // (L, P) r, then r ⊙ e^{c_{t-1}}
  float* ks = rs + L * P;       // (L, P) k, then k ⊙ e^{c_L − c_j}
  float* vs = ks + L * P;       // (L, P) v
  float* cs = vs + L * P;       // (L, P) logw, then its cumsum c
  float* sc = cs + L * P;       // (L, L) scores, sc[t * L + j]

  const size_t trow = static_cast<size_t>(a.H) * N;  // stride of t
  const size_t base = (static_cast<size_t>(b) * a.T * a.H + h) * N;
  const size_t sbase = (static_cast<size_t>(b) * a.H + h) * N * N;
  const float* u = a.u + static_cast<size_t>(h) * N;

  for (int i = tid; i < N * N; i += kThreads)
    S[i] = a.s0 ? a.s0[sbase + i] : 0.f;

  for (int t0 = 0; t0 < a.T; t0 += L) {
    const int Lc = min(L, a.T - t0);  // the last chunk may be ragged
    __syncthreads();  // the previous chunk is done with the buffers
    for (int i = tid; i < Lc * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const size_t g = base + static_cast<size_t>(t0 + t) * trow + n;
      rs[t * P + n] = a.r[g];
      ks[t * P + n] = a.k[g];
      vs[t * P + n] = a.v[g];
      cs[t * P + n] = a.logw[g];
    }
    __syncthreads();
    if (tid < N) {  // inclusive cumsum over t, one thread per column n
      float acc = 0.f;
      for (int t = 0; t < Lc; ++t) {
        acc += cs[t * P + tid];
        cs[t * P + tid] = acc;
      }
    }
    __syncthreads();
    // scores: one (t, j) pair per thread; a warp shares t (r_t and
    // c_{t-1} broadcast) and walks consecutive j (k_j, c_j on distinct
    // banks through the padded pitch)
    for (int p = tid; p < Lc * Lc; p += kThreads) {
      const int t = p / Lc, j = p - t * Lc;
      float s = 0.f;
      const float* rt = rs + t * P;
      if (j < t) {
        const float* cp = cs + (t - 1) * P;
        const float* kj = ks + j * P;
        const float* cj = cs + j * P;
        for (int n = 0; n < N; ++n)
          s = fmaf(rt[n] * kj[n], expf(cp[n] - cj[n]), s);
      } else if (j == t) {
        const float* kt = ks + t * P;
        for (int n = 0; n < N; ++n) s = fmaf(rt[n] * u[n], kt[n], s);
      }
      sc[t * L + j] = s;
    }
    __syncthreads();
    const float* cl = cs + (Lc - 1) * P;  // c_L
    for (int i = tid; i < Lc * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const float cprev = t ? cs[(t - 1) * P + n] : 0.f;
      rs[t * P + n] *= expf(cprev);
      ks[t * P + n] *= expf(cl[n] - cs[t * P + n]);
    }
    __syncthreads();
    // y_t[m] = Σ_{j<=t} score[t, j] v_j[m] + Σ_n (r_t e^{c_{t-1}})[n] S[n, m]
    for (int i = tid; i < Lc * N; i += kThreads) {
      const int t = i / N, m = i - t * N;
      float acc = 0.f;
      for (int j = 0; j <= t; ++j) acc = fmaf(sc[t * L + j], vs[j * P + m], acc);
      const float* rt = rs + t * P;
      for (int n = 0; n < N; ++n) acc = fmaf(rt[n], S[n * N + m], acc);
      a.y[base + static_cast<size_t>(t0 + t) * trow + m] = acc;
    }
    __syncthreads();  // every y has read S
    // S[n, m] = e^{c_L[n]} S[n, m] + Σ_j (k_j e^{c_L − c_j})[n] v_j[m]
    for (int i = tid; i < N * N; i += kThreads) {
      const int n = i / N, m = i - n * N;
      float acc = expf(cl[n]) * S[i];
      for (int j = 0; j < Lc; ++j) acc = fmaf(ks[j * P + n], vs[j * P + m], acc);
      S[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * N; i += kThreads) a.s_out[sbase + i] = S[i];
}

}  // namespace

extern "C" {

// r, k, v, logw, y (B, T, H, N); u (H, N); s0 and s_out (B, H, N, N), s0
// nullable and allowed to alias s_out; all f32 and contiguous; chunk L.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for a shape it does not
// take).
int wkv6_btHN(const float* r, const float* k, const float* v,
              const float* logw, const float* u, const float* s0, float* y,
              float* s_out, int B, int T, int H, int N, int L, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || N <= 0 || N > kMaxN ||
      L <= 0 || L > kMaxL)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, L);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  Args a{r, k, v, logw, u, s0, y, s_out, T, H, N, L};
  wkv6_chunk_kernel<<<dim3(H, B), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
