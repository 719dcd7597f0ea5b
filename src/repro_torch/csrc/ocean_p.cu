// K1 ocean_p_prefix and K2 ocean_p_topm: the per-round P3 solve of OCEAN.
//
// K1 replaces repro/kernels/ocean_p.py:48 ``_fused_kernel`` (pallas_call at
// :208): all K+1 prefix candidates of the rho-sorted order, each a
// safeguarded-Newton waterfilling (12 outer x 9 inner), keeping only the
// running argmax.  K2 replaces :232 ``_topm_kernel`` (pallas_call at :481):
// top_m rounds of (min, lowest index) extraction over client-order rho, the
// same sweep on the compact top_m row, and the scatter back to client order.
//
// What bounds them on the H100: neither moves more than a few KB per cell,
// so bytes never bound them.  The operations — per candidate m, about
// 12 * 10 * m evaluations of exp2f/division chains — form a sequential
// dependency chain per cell (each outer Newton step needs the block sum of
// the previous one), so they are bound by the latency of that chain, far
// above the card's f32 rate.  The design answers with parallelism across
// cells: one block per cell, every cell's row resident in shared memory,
// client-parallel inner work, two-value block sums to halve the barriers.
// At K = 10 a block uses 10 of its 32 lanes; that is the first thing to
// redesign (several cells per warp).
#include "ocean_common.cuh"

using namespace ocean;

namespace {

__global__ void ocean_p_prefix_kernel(const float* __restrict__ scal,
                                      const float* __restrict__ rho,
                                      float* __restrict__ b_out,
                                      float* __restrict__ wm, int K,
                                      int n_cands, int outer, int inner) {
  extern __shared__ float smem[];
  float* s_rho = smem;        // K
  float* s_b = s_rho + K;     // K
  float* s_best = s_b + K;    // K
  float* s_red = s_best + K;  // 64
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const float* sc = scal + (size_t)c * 8;
  SweepParams p;
  p.n0f = sc[0];
  p.delta = sc[1];
  p.v_eta = sc[2];
  p.beta = sc[3];
  p.b_min = sc[4];
  p.scale = sc[5];
  p.kf = (float)K;
  p.outer = outer;
  p.inner = inner;
  for (int i = tid; i < K; i += nt) s_rho[i] = rho[(size_t)c * K + i];
  __syncthreads();
  // Sorted rank r is in the positive region iff r >= n0.
  const int start = (int)fminf(fmaxf(ceilf(p.n0f), 0.f), (float)K);
  float w, m;
  prefix_sweep(s_rho, K, start, n_cands, p, false, s_b, s_best, s_red, w, m);
  for (int i = tid; i < K; i += nt) b_out[(size_t)c * K + i] = s_best[i];
  if (tid == 0) {
    wm[2 * c] = w;
    wm[2 * c + 1] = m;
  }
}

__global__ void ocean_p_topm_kernel(const float* __restrict__ scal,
                                    const float* __restrict__ rho,
                                    float* __restrict__ b_out,
                                    float* __restrict__ wm,
                                    float* __restrict__ work_global, int K,
                                    int K_pad, int top_m, int outer, int inner) {
  extern __shared__ float smem[];
  float* s_vals = smem;                                // top_m
  int* s_idx = reinterpret_cast<int*>(s_vals + top_m);  // top_m
  float* s_b = reinterpret_cast<float*>(s_idx + top_m);  // top_m
  float* s_best = s_b + top_m;                         // top_m
  float* s_red = s_best + top_m;                       // 64
  int* s_redi = reinterpret_cast<int*>(s_red + 64);    // 32
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  // The working copy lives in shared memory when it fits, else in a global
  // scratch row the wrapper allocated.
  float* work = work_global == nullptr
                    ? reinterpret_cast<float*>(s_redi + 32)
                    : work_global + (size_t)c * K_pad;
  for (int i = tid; i < K_pad; i += nt) work[i] = rho[(size_t)c * K_pad + i];
  __syncthreads();

  // Phase 1: top_m rounds of block-wide (min, lowest index) extraction.
  for (int j = 0; j < top_m; ++j) {
    float v = INFINITY;
    int idx = K_pad;
    for (int i = tid; i < K_pad; i += nt) argmin_op(v, idx, work[i], i);
    block_argmin(v, idx, s_red, s_redi);
    if (tid == 0) {
      s_vals[j] = v;
      s_idx[j] = idx < K_pad ? idx : 0;
      if (idx < K_pad) work[idx] = INFINITY;
    }
    __syncthreads();
  }

  // Phase 2: the K1 sweep on the compact row (candidate m owns slots [0, m)).
  const float* sc = scal + (size_t)c * 8;
  SweepParams p;
  p.n0f = sc[0];
  p.delta = sc[1];
  p.v_eta = sc[2];
  p.beta = sc[3];
  p.b_min = sc[4];
  p.scale = sc[5];
  p.kf = (float)K;
  p.outer = outer;
  p.inner = inner;
  float w, m;
  prefix_sweep(s_vals, top_m, 0, top_m, p, true, s_b, s_best, s_red, w, m);

  // Phase 3: winners straight to their unique client index in a zeroed row.
  float* row = b_out + (size_t)c * K_pad;
  for (int i = tid; i < K_pad; i += nt) row[i] = 0.f;
  __syncthreads();
  for (int j = tid; j < top_m; j += nt)
    if ((float)j < m && isfinite(s_vals[j])) row[s_idx[j]] = s_best[j];
  if (tid == 0) {
    wm[2 * c] = w;
    wm[2 * c + 1] = m;
  }
}

// Threads for n items: whole warps, at most ``cap`` and at most what the
// kernel's register use allows in one block (at 80 registers a thread, a
// block of 1024 would need more than the SM's 65,536).
int threads_for(const void* fn, int n, int cap) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fn) == cudaSuccess && attr.maxThreadsPerBlock < cap)
    cap = attr.maxThreadsPerBlock & ~31;
  int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > cap ? cap : t);
}

cudaError_t prepare(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int ocean_p_prefix_launch(const float* scal, const float* rho,
                                     float* b, float* wm, int C, int K,
                                     int n_cands, int outer, int inner,
                                     void* stream) {
  const size_t smem = (3 * (size_t)K + 64) * sizeof(float);
  cudaError_t err = prepare((const void*)ocean_p_prefix_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = threads_for((const void*)ocean_p_prefix_kernel, K, 1024);
  ocean_p_prefix_kernel<<<C, nt, smem, (cudaStream_t)stream>>>(
      scal, rho, b, wm, K, n_cands, outer, inner);
  return (int)cudaGetLastError();
}

// The current device's per-block shared-memory limit (with opt-in).
extern "C" int smem_optin_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

// Shared bytes K2 needs with the working copy resident (the wrapper falls
// back to a global scratch row above the card's per-block limit).
extern "C" long long ocean_p_topm_smem_bytes(int K_pad, int top_m, int resident) {
  return (long long)(4 * (size_t)top_m + 96 + (resident ? (size_t)K_pad : 0)) * 4;
}

extern "C" int ocean_p_topm_launch(const float* scal, const float* rho,
                                   float* b, float* wm, float* work_global,
                                   int C, int K, int K_pad, int top_m,
                                   int outer, int inner, void* stream) {
  const size_t smem =
      (size_t)ocean_p_topm_smem_bytes(K_pad, top_m, work_global == nullptr);
  cudaError_t err = prepare((const void*)ocean_p_topm_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n = K_pad > top_m ? K_pad : top_m;
  const int nt = threads_for((const void*)ocean_p_topm_kernel, n, 256);
  ocean_p_topm_kernel<<<C, nt, smem, (cudaStream_t)stream>>>(
      scal, rho, b, wm, work_global, K, K_pad, top_m, outer, inner);
  return (int)cudaGetLastError();
}
