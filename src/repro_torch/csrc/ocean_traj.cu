// K3 ocean_traj: the whole T-round OCEAN trajectory (paper Alg. 1) per cell.
//
// Replaces repro/kernels/ocean_traj.py:96 ``_traj_kernel`` (pallas_call at
// :532).  One persistent block per cell loops over all T rounds with the
// queues q and the spent energy resident in shared memory.  Each round:
//   1. frame reset at t > 0 && t % R == 0       (repro/core/ocean.py:453)
//   2. rho = q / max(h2, 1e-30)                  (repro/core/selection.py:84)
//   3. a stable ascending sort: bitonic on (rho, client index) pairs, K
//      padded to a power of two with (+inf, index >= K) sentinels
//   4. n0, delta and the K1 prefix sweep (ocean_common.cuh)
//   5. the S0 fix-up                             (selection.py:242-245)
//   6. unsort, energy (energy.py:159) and the queue update (ocean.py:500)
//   7. the a/b/e/q_pre/rho/obj/nsel rows of this round
// Scope: ranking="sort", solver="pallas", static radio; K <= 2048 (the sort
// and the per-client state live in shared memory).
//
// What bounds it on the H100: the bytes are tiny (per cell-round it reads
// 2K + 2 floats and writes 4K floats, K bytes and 2 scalars), so the bound
// is the operations of the sweep, and what the kernel actually meets is the
// latency of the sweep's sequential Newton chain (see ocean_p.cu), repeated
// T times per cell.  The design keeps every round on chip — no launch, no
// host round trip, no global-memory carry between rounds — and spreads the
// cells over the SMs, one block each.
#include <float.h>

#include "ocean_common.cuh"

using namespace ocean;

namespace {

__device__ __forceinline__ bool after(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

__global__ void ocean_traj_kernel(
    const float* __restrict__ h2, const float* __restrict__ v,
    const float* __restrict__ eta, const float* __restrict__ inc,
    uint8_t* __restrict__ a_out, float* __restrict__ b_out,
    float* __restrict__ e_out, float* __restrict__ qpre_out,
    float* __restrict__ rho_out, float* __restrict__ obj_out,
    int* __restrict__ nsel_out, float* __restrict__ q_final,
    float* __restrict__ es_final, int T, int K, int P, int R, float b_min,
    float beta, float scale, int outer, int inner) {
  extern __shared__ float smem[];
  float* s_key = smem;                                   // P
  int* s_idx = reinterpret_cast<int*>(s_key + P);        // P
  float* s_q = reinterpret_cast<float*>(s_idx + P);      // K
  float* s_es = s_q + K;                                 // K
  float* s_b = s_es + K;                                 // K
  float* s_best = s_b + K;                               // K
  float* s_red = s_best + K;                             // 64
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < K; i += nt) {
    s_q[i] = 0.f;
    s_es[i] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t ct = (size_t)c * T + t;
    const size_t row = ct * K;
    const float* h2_t = h2 + row;
    const bool reset = t > 0 && (t % R) == 0;

    // 1-2. frame reset, priorities, sort keys.
    for (int i = tid; i < P; i += nt) {
      if (i < K) {
        const float q = reset ? 0.f : s_q[i];
        s_q[i] = q;
        const float r = q / jmax(h2_t[i], kSafeDivFloor);
        s_key[i] = r;
        qpre_out[row + i] = q;
        rho_out[row + i] = r;
      } else {
        s_key[i] = INFINITY;
      }
      s_idx[i] = i;
    }
    __syncthreads();

    // 3. bitonic sort of (rho, index): ascending, ties by client index.
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < P; i += nt) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const float ki = s_key[i], kj = s_key[ixj];
            const int ii = s_idx[i], ij = s_idx[ixj];
            const bool up = (i & k) == 0;
            if (after(ki, ii, kj, ij) == up) {
              s_key[i] = kj;
              s_key[ixj] = ki;
              s_idx[i] = ij;
              s_idx[ixj] = ii;
            }
          }
        }
        __syncthreads();
      }
    }

    // 4. n0, delta, and the prefix sweep.
    float cnt = 0.f;
    for (int i = tid; i < K; i += nt) cnt += s_key[i] <= kRhoZeroTol ? 1.f : 0.f;
    const float n0f = block_all<Sum>(cnt, s_red);
    const int n0 = (int)n0f;
    SweepParams p;
    p.n0f = n0f;
    p.kf = (float)K;
    p.delta = 1.f - n0f * b_min;
    p.v_eta = v[ct] * eta[ct];
    p.beta = beta;
    p.b_min = b_min;
    p.scale = scale;
    p.outer = outer;
    p.inner = inner;
    float w, mf;
    prefix_sweep(s_key, K, n0, K, p, false, s_b, s_best, s_red, w, mf);
    const int m_star = (int)rintf(mf);

    // 5-6. S0 fix-up, unsort, energy, queue update.
    const float leftover = m_star == 0 ? p.delta : 0.f;
    const float b0_each = b_min + leftover / jmax(n0f, 1.f);
    const float* inc_t = inc + row;
    float ns = 0.f;
    for (int r = tid; r < K; r += nt) {
      const bool in_s0 = r < n0;
      const bool a = in_s0 || (r < n0 + m_star);
      const float b = a ? (in_s0 ? b0_each : s_best[r]) : 0.f;
      const int k = s_idx[r];
      // b >= FLT_MIN: a subnormal b counts as 0, as under the reference's
      // flush-to-zero platforms and the plain version
      float e = b >= FLT_MIN ? scale * f_shannon(b, beta) / h2_t[k] : 0.f;
      e = e * (a ? 1.f : 0.f);
      a_out[row + k] = a ? 1 : 0;
      b_out[row + k] = b;
      e_out[row + k] = e;
      s_q[k] = jmax(s_q[k] + e - inc_t[k], 0.f);
      s_es[k] = s_es[k] + e;
      ns += a ? 1.f : 0.f;
    }
    const float nsel = block_all<Sum>(ns, s_red);
    if (tid == 0) {
      obj_out[ct] = w;
      nsel_out[ct] = (int)nsel;
    }
    __syncthreads();  // this round's queue writes before the next round's reads
  }
  for (int i = tid; i < K; i += nt) {
    q_final[(size_t)c * K + i] = s_q[i];
    es_final[(size_t)c * K + i] = s_es[i];
  }
}

}  // namespace

extern "C" int ocean_traj_launch(
    const float* h2, const float* v, const float* eta, const float* inc,
    uint8_t* a, float* b, float* e, float* q_pre, float* rho, float* obj,
    int* nsel, float* q_final, float* es_final, int C, int T, int K, int R,
    float b_min, float beta, float scale, int outer, int inner, void* stream) {
  int P = 32;
  while (P < K) P <<= 1;
  // One thread per sort slot, within what the kernel's register use allows
  // in one block (fewer than 1024 at its register count); the loops
  // stride, so fewer threads than slots is fine.
  int nt = P < 1024 ? P : 1024;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, (const void*)ocean_traj_kernel) == cudaSuccess &&
      attr.maxThreadsPerBlock < nt)
    nt = attr.maxThreadsPerBlock & ~31;
  const size_t smem = (size_t)P * 8 + (4 * (size_t)K + 64) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)ocean_traj_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ocean_traj_kernel<<<C, nt, smem, (cudaStream_t)stream>>>(
      h2, v, eta, inc, a, b, e, q_pre, rho, obj, nsel, q_final, es_final, T, K,
      P, R, b_min, beta, scale, outer, inner);
  return (int)cudaGetLastError();
}
