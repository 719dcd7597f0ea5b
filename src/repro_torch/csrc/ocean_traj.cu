// K3 ocean_traj: the whole T-round OCEAN trajectory (paper Alg. 1) per cell.
//
// Replaces repro/kernels/ocean_traj.py:96 ``_traj_kernel`` (pallas_call at
// :532).  One persistent block per cell loops over all T rounds with the
// queues q and the spent energy resident in shared memory.  Each round:
//   1. frame reset at t > 0 && t % R == 0       (repro/core/ocean.py:453)
//   2. rho = q / max(h2, 1e-30)                  (repro/core/selection.py:84)
//   3. a stable ascending sort: bitonic on (rho, client index) pairs, K
//      padded to a power of two P with (+inf, index >= K) sentinels
//   4. n0, delta and K1's candidate-parallel prefix sweep (ocean_common.cuh)
//   5. the S0 fix-up                             (selection.py:242-245)
//   6. unsort, energy (energy.py:159) and the queue update (ocean.py:500)
//   7. the a/b/e/q_pre/rho/obj/nsel rows of this round
// Scope: ranking="sort", solver="pallas", static radio; K <= 2048 (the sort
// and the per-client state live in shared memory).
//
// What bounds it on the H100: the bytes are tiny (per cell-round it reads
// 2K + 2 floats and writes 4K floats, K bytes and 2 scalars), so the bound
// is the operations of the sweep, and what the kernel meets is the latency
// of the sweep's Newton chain (see ocean_p.cu), T times over per cell.
//
// The design keeps every round on chip (no launch, no host round trip, no
// global-memory carry between rounds) and puts the round's K candidates
// side by side: the block has one team of lanes per candidate, as K1 has
// one warp (prefix_sweep_parallel), so a round costs one candidate's
// chain, not the sum of K of them.  At K <= 16 a team is a half warp (two
// candidates to a warp, half the warp instructions, the FP64 exp2 among
// them): at K = 10, 192 cells are 192 blocks of 5 warps, one wave on 132
// SMs.  Past what a block holds a team walks m = u + 1, u + 1 + nteams,
// ...  Each warp counts n0 itself, and nsel is n0 + m*.  At K <= 32 every
// candidate's W and b come out bit for bit as from the sequential sweep
// of a 32-thread block (ocean_common.cuh, Teams and LaneTeam); above, a
// warp sums in another order than a block did.
#include <float.h>

#include "ocean_common.cuh"

using namespace ocean;

namespace {

// At K <= kHalfWarpMaxK a candidate has at most 16 members, and a team of
// 16 lanes evaluates it: two candidates to a warp, the same bits
// (ocean_common.cuh, LaneTeam).
constexpr int kHalfWarpMaxK = 16;
// Registers a thread with full-warp teams: at most 96 (124 uncapped), so
// that a block holds 20 warps at K = 100 (spilling 48 bytes).  Half-warp
// blocks (K <= 16, at most 8 warps) keep what the compiler takes.
constexpr int kMaxRegs = 96;

__device__ __forceinline__ bool after(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

template <int NT>
__global__ void __maxnreg__(NT == 32 ? kMaxRegs : 128) ocean_traj_kernel(
    const float* __restrict__ h2, const float* __restrict__ v,
    const float* __restrict__ eta, const float* __restrict__ inc,
    uint8_t* __restrict__ a_out, float* __restrict__ b_out,
    float* __restrict__ e_out, float* __restrict__ qpre_out,
    float* __restrict__ rho_out, float* __restrict__ obj_out,
    int* __restrict__ nsel_out, float* __restrict__ q_final,
    float* __restrict__ es_final, int T, int K, int P, int R, float b_min,
    float beta, float scale, int outer, int inner) {
  extern __shared__ float smem[];
  const int nteams = blockDim.x / NT;
  float* s_key = smem;                                   // P
  int* s_idx = reinterpret_cast<int*>(s_key + P);        // P
  float* s_q = reinterpret_cast<float*>(s_idx + P);      // K
  float* s_es = s_q + K;                                 // K
  float* s_rows = s_es + K;                              // 2 nteams K: each team's b and best rows
  float* s_red = s_rows + 2 * (size_t)nteams * K;        // 64
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31;

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

    // 4. n0 (each warp counts for itself: integers, exact in any order),
    // delta, and the prefix sweep.
    float cnt = 0.f;
    for (int i = lane; i < K; i += 32) cnt += s_key[i] <= kRhoZeroTol ? 1.f : 0.f;
    const float n0f = warp_all<Sum>(cnt);
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
    int winner;
    prefix_sweep_parallel<NT>(s_key, K, n0, K, p, s_rows, s_red, w, mf, winner);
    const int m_star = (int)rintf(mf);
    const float* best = s_rows + (2 * (size_t)winner + 1) * K;

    // 5-6. S0 fix-up, unsort, energy, queue update.
    const float leftover = m_star == 0 ? p.delta : 0.f;
    const float b0_each = b_min + leftover / jmax(n0f, 1.f);
    const float* inc_t = inc + row;
    for (int r = tid; r < K; r += nt) {
      const bool in_s0 = r < n0;
      const bool a = in_s0 || (r < n0 + m_star);
      const float b = a ? (in_s0 ? b0_each : best[r]) : 0.f;
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
    }
    if (tid == 0) {
      obj_out[ct] = w;
      // the slots r < n0 + m* are selected; a candidate never passes K
      nsel_out[ct] = n0 + m_star;
    }
    __syncthreads();  // this round's queue writes before the next round's reads
  }
  for (int i = tid; i < K; i += nt) {
    q_final[(size_t)c * K + i] = s_q[i];
    es_final[(size_t)c * K + i] = s_es[i];
  }
}

// Shared bytes with nteams teams: the sort's keys and indices, q and the
// spent energy, each team's two rows, the argmax scratch.
size_t traj_smem(int K, int P, int nteams) {
  return (size_t)P * 8 + ((2 + 2 * (size_t)nteams) * K + 64) * sizeof(float);
}

int sort_slots(int K) {
  int P = 32;
  while (P < K) P <<= 1;
  return P;
}

// Teams of NT lanes per block: one per candidate up to what a block holds
// (as K1: threads_for's register limit, then whole warps fewer until the
// shared rows fit the card's per-block limit).
template <int NT>
int traj_teams(int K, int P) {
  int nteams = threads_for((const void*)ocean_traj_kernel<NT>, NT * K, 1024) / NT;
  const size_t optin = (size_t)smem_optin();
  while (nteams > 32 / NT && traj_smem(K, P, nteams) > optin) nteams -= 32 / NT;
  return nteams;
}

template <int NT>
int launch(const float* h2, const float* v, const float* eta, const float* inc, uint8_t* a,
           float* b, float* e, float* q_pre, float* rho, float* obj, int* nsel, float* q_final,
           float* es_final, int C, int T, int K, int R, float b_min, float beta, float scale,
           int outer, int inner, cudaStream_t stream) {
  const int P = sort_slots(K);
  const int nteams = traj_teams<NT>(K, P);
  const size_t smem = traj_smem(K, P, nteams);
  cudaError_t err = prepare((const void*)ocean_traj_kernel<NT>, smem);
  if (err != cudaSuccess) return (int)err;
  ocean_traj_kernel<NT><<<C, NT * nteams, smem, stream>>>(
      h2, v, eta, inc, a, b, e, q_pre, rho, obj, nsel, q_final, es_final, T, K, P, R, b_min,
      beta, scale, outer, inner);
  return (int)cudaGetLastError();
}

}  // namespace

// The warps a K3 block runs at K clients.
extern "C" int ocean_traj_warps(int K) {
  const int P = sort_slots(K);
  return K <= kHalfWarpMaxK ? traj_teams<16>(K, P) / 2 : traj_teams<32>(K, P);
}

extern "C" int ocean_traj_launch(
    const float* h2, const float* v, const float* eta, const float* inc,
    uint8_t* a, float* b, float* e, float* q_pre, float* rho, float* obj,
    int* nsel, float* q_final, float* es_final, int C, int T, int K, int R,
    float b_min, float beta, float scale, int outer, int inner, void* stream) {
  auto run = K <= kHalfWarpMaxK ? launch<16> : launch<32>;
  return run(h2, v, eta, inc, a, b, e, q_pre, rho, obj, nsel, q_final, es_final, C, T, K, R,
             b_min, beta, scale, outer, inner, (cudaStream_t)stream);
}
