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
//   6. with a failure process, failure_mode      (ocean.py:339-405)
//   7. unsort, energy (energy.py:159) and the queue update (ocean.py:500)
//   8. the a/b/e/q_pre/rho/obj/nsel (and dlv/ral, fc/dm/fb) rows of this round
// Four compile-time branches (template parameters; the instance without
// any is the §VI grid's):
//   HasRadio    each round reads its cell's b_min, beta and energy_scale
//               from (C, T) streams (a TracedRadio's stored leaves)
//               instead of the launch's static radio;
//   HasFailure  each round reads its cell's (K,) delivery mask; the cell's
//               declared rates are read once.  ``plain`` commits the
//               decision; ``overprovision`` extends the ranked prefix until
//               the rates' prefix sum (added in ranked order) reaches the
//               plain count, capped by floor(1 / b_min), and re-solves the
//               extended set with the masked P4 (ocean_common.cuh) and its
//               P3 value, keeping the committed solve where the prefix did
//               not grow; ``reallocate`` re-solves the survivors when a
//               selected client failed and charges 0.5 e + 0.5 e2.
//   Bisect      the round's sweep is the ``bisect`` solver's
//               (prefix_sweep_bisect: 42 x 42 halvings a candidate) instead
//               of K1's Newton sweep (solver="pallas").
//   HasGuard    a GuardSpec (repro/core/ocean.py:266-336, 456-519; the
//               reference kernel's :122-123, :159-168, :230-236, :310-313):
//               quarantine (a K-float shared row of the round's gains with
//               non-finite or non-positive ones set to 1, counted; every
//               rho and energy of the round reads it), admission (the gain
//               floor, then E(b_min | h2) <= cap_k; a demoted client's rho
//               is 1e30), the sweep, a chaos backend's corruption (P3 value
//               + inf, or the winner's waterfilled row x scale), validation
//               (finite b, P3 value and rho; |sum b - 1| <= residual_tol
//               when anything is selected; b >= b_min (1 - 1e-6) on the
//               selected) and on a violation the bisect sweep of the same
//               ranked keys and its S0 fix-up (block-uniform: a block is a
//               cell); overprovision stops at the admitted count; a
//               non-finite queue increment becomes 0.  The guard's knobs and
//               the chaos kind are launch arguments.
// Scope: ranking="sort", solver="pallas" or "bisect" (and chaos backends
// of either); K <= 2048 (the sort and the per-client state live in shared
// memory).
//
// What bounds it on the H100: the bytes are tiny (per cell-round it reads
// 2K + 2 floats and writes 4K floats, K bytes and 2 scalars), so the bound
// is the operations of the sweep, and what the kernel meets is the latency
// of the sweep's Newton chain (see ocean_p.cu), T times over per cell.
//
// The bisect instance and the guard's fallback bound by operations too:
// 43 bisections of b(lam) a member, each 42 evaluations of f' through a
// double exp2, about 16 times the Newton sweep's chain.  On rounds that
// pass validation the guard adds a few block reductions and no sweep.
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
// Priority of a client the guard demotes (RHO_DEMOTED of
// repro_torch/core/selection.py): finite, so it sorts last.
constexpr float kRhoDemoted = 1e30f;

__device__ __forceinline__ bool after(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// Per-launch inputs and outputs.  The radio streams are read only by the
// HasRadio instances, the failure streams and outputs only by HasFailure,
// the guard's only by HasGuard.
struct TrajArgs {
  const float *h2, *v, *eta, *inc;
  const float *r_bmin, *r_beta, *r_scale;  // (C, T) radio streams
  const float *dlv, *rate;                 // (C, T, K) delivery mask, (C, K) rates
  const float* frac;                       // the masked P4's grid fractions
  uint8_t* a_out;
  float *b_out, *e_out, *qpre_out, *rho_out, *obj_out;
  int* nsel_out;
  float *q_final, *es_final;
  uint8_t* dlv_out;
  int* ral_out;
  int T, K, P, R;
  float b_min, beta, scale;  // the static radio (instances without HasRadio)
  int outer, inner;          // the sweep's Newton steps
  int mode;                  // failure mode: kPlain, kOverprovision, kReallocate
  int wf_outer, wf_inner, wf_grid;  // the masked P4's budgets
  int bis_outer, bis_inner;  // the bisect sweep's halvings
  const float* cap;          // (K,) energy_cap x H_k, or null: no energy test
  int *fc_out, *dm_out, *fb_out;    // (C, T) fault_count, demoted, fallback
  int guard;                 // kQuarantine | kFloor | kFallback
  float gain_floor, residual_tol;
  int chaos;                 // kChaosNone, kChaosObjective, kChaosBudget
  float chaos_scale;
};

enum { kPlain = 0, kOverprovision = 1, kReallocate = 2 };
enum { kQuarantine = 1, kFloor = 2, kFallback = 4 };
enum { kChaosNone = 0, kChaosObjective = 1, kChaosBudget = 2 };

// The block's sum of one float per thread, in a fixed order (warps, then
// warp 0 over the warps' sums); every thread gets it.
__device__ float block_sum(float x, float* red) {
  x = warp_all<Sum>(x);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// E(b | h) of one selected client (repro/core/energy.py:159), with the
// port's b >= FLT_MIN: a subnormal b counts as 0, as under the reference's
// flush-to-zero platforms and the plain version.
__device__ __forceinline__ float energy_of(float b, float h2, float beta, float scale) {
  return b >= FLT_MIN ? scale * f_shannon(b, beta) / h2 : 0.f;
}

template <int NT, bool HasRadio, bool HasFailure, bool HasGuard, bool Bisect>
__global__ void __maxnreg__(NT == 32 ? kMaxRegs : 128) ocean_traj_kernel(const TrajArgs args) {
  extern __shared__ float smem[];
  const int T = args.T, K = args.K, P = args.P, R = args.R;
  const int nteams = blockDim.x / NT;
  float* s_key = smem;                                   // P
  int* s_idx = reinterpret_cast<int*>(s_key + P);        // P
  float* s_q = reinterpret_cast<float*>(s_idx + P);      // K
  float* s_es = s_q + K;                                 // K
  float* s_rows = s_es + K;                              // 2 nteams K: each team's b and best rows
  float* s_red = s_rows + 2 * (size_t)nteams * K;        // 64
  // HasFailure: the round's delivery mask and the cell's rates (client
  // order), the masked P4's member flags and allocation (ranked order),
  // its grid scratch, and a few block-wide values.
  float* s_ok = s_red + 64;                              // K
  float* s_rate = s_ok + K;                              // K
  float* s_mem = s_rate + K;                             // K
  float* s_b2 = s_mem + K;                               // K
  float* s_wf = s_b2 + K;                                // 32
  int* s_int = reinterpret_cast<int*>(s_wf + 32);        // 4
  // HasGuard: the round's sanitized gains and the cell's caps (client order).
  float* s_h2 = HasFailure ? reinterpret_cast<float*>(s_int + 4) : s_ok;  // K
  float* s_cap = s_h2 + K;                                                // K
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31;
  const bool admits = (args.guard & (kQuarantine | kFloor)) != 0 || args.cap != nullptr;

  for (int i = tid; i < K; i += nt) {
    s_q[i] = 0.f;
    s_es[i] = 0.f;
    if constexpr (HasFailure) s_rate[i] = args.rate[(size_t)c * K + i];
    if constexpr (HasGuard) s_cap[i] = args.cap != nullptr ? args.cap[i] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t ct = (size_t)c * T + t;
    const size_t row = ct * K;
    const float* h2_t = args.h2 + row;
    const bool reset = t > 0 && (t % R) == 0;
    float b_min = args.b_min, beta = args.beta, scale = args.scale;
    if constexpr (HasRadio) {
      b_min = args.r_bmin[ct];
      beta = args.r_beta[ct];
      scale = args.r_scale[ct];
    }

    // 1-2. frame reset, (the guard's screens,) priorities, sort keys.
    int n_fault = 0, n_dem = 0, n_adm = 0, rho_bad = 0;
    for (int i = tid; i < P; i += nt) {
      if (i < K) {
        const float q = reset ? 0.f : s_q[i];
        s_q[i] = q;
        float r;
        if constexpr (HasGuard) {
          float h = h2_t[i];
          bool ok = true;
          if (args.guard & kQuarantine) {
            ok = isfinite(h) && h > 0.f;
            if (!ok) h = 1.f;
          }
          s_h2[i] = h;
          bool adm = ok;
          if (args.guard & kFloor) adm = adm && h >= args.gain_floor;
          if (args.cap != nullptr) adm = adm && energy_of(b_min, h, beta, scale) <= s_cap[i];
          n_fault += ok ? 0 : 1;
          n_dem += ok && !adm ? 1 : 0;
          n_adm += adm ? 1 : 0;
          r = q / jmax(h, kSafeDivFloor);
          if (admits && !adm) r = kRhoDemoted;
          rho_bad |= isfinite(r) ? 0 : 1;
        } else {
          r = q / jmax(h2_t[i], kSafeDivFloor);
        }
        s_key[i] = r;
        args.qpre_out[row + i] = q;
        args.rho_out[row + i] = r;
        if constexpr (HasFailure) s_ok[i] = args.dlv[row + i] > 0.f ? 1.f : 0.f;
      } else {
        s_key[i] = INFINITY;
      }
      s_idx[i] = i;
    }
    __syncthreads();
    if constexpr (HasGuard) {  // counts are integers: exact in any order
      n_fault = (int)block_sum((float)n_fault, s_red);
      n_dem = (int)block_sum((float)n_dem, s_red);
      n_adm = (int)block_sum((float)n_adm, s_red);
      rho_bad = __syncthreads_or(rho_bad);
    }

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
    p.v_eta = args.v[ct] * args.eta[ct];
    p.beta = beta;
    p.b_min = b_min;
    p.scale = scale;
    p.outer = args.outer;
    p.inner = args.inner;
    float w, mf;
    int winner;
    if constexpr (Bisect) {
      prefix_sweep_bisect<NT>(s_key, K, n0, K, p, args.bis_outer, args.bis_inner, s_rows, s_red,
                              w, mf, winner);
    } else {
      prefix_sweep_parallel<NT>(s_key, K, n0, K, p, s_rows, s_red, w, mf, winner);
    }
    int m_star = (int)rintf(mf);
    const float* best = s_rows + (2 * (size_t)winner + 1) * K;

    // 5. the S0 fix-up: the committed decision in ranked slots r < n_sel.
    float leftover = m_star == 0 ? p.delta : 0.f;
    float b0_each = b_min + leftover / jmax(n0f, 1.f);
    int n_sel = n0 + m_star;  // a candidate never passes K
    bool scaled = false;      // a budget chaos backend's row x chaos_scale is committed
    int fell = 0;             // the guard committed the bisect fallback
    if constexpr (HasGuard) {
      if (args.chaos == kChaosObjective) w = w + INFINITY;
      scaled = args.chaos == kChaosBudget;
      if (args.guard & kFallback) {
        int bad = rho_bad | (isfinite(w) ? 0 : 1);
        const float b_floor = b_min * (float)(1.0 - 1e-6);
        float rs = 0.f;
        for (int r = tid; r < n_sel; r += nt) {
          const float b = r < n0 ? b0_each : (scaled ? best[r] * args.chaos_scale : best[r]);
          const float bz = isfinite(b) ? b : 0.f;
          bad |= isfinite(b) && bz >= b_floor ? 0 : 1;
          rs += bz;
        }
        const float s = block_sum(rs, s_red);
        if (n_sel > 0 && !(fabsf(s - 1.f) <= args.residual_tol)) bad = 1;
        if (__syncthreads_or(bad)) {
          prefix_sweep_bisect<NT>(s_key, K, n0, K, p, args.bis_outer, args.bis_inner, s_rows,
                                  s_red, w, mf, winner);
          m_star = (int)rintf(mf);
          best = s_rows + (2 * (size_t)winner + 1) * K;
          leftover = m_star == 0 ? p.delta : 0.f;
          b0_each = b_min + leftover / jmax(n0f, 1.f);
          n_sel = n0 + m_star;
          scaled = false;
          fell = 1;
        }
      }
    }
    int n_act = n_sel;              // slots r < n_act are selected after failure_mode
    bool resolved = false;          // overprovision re-solved the extended prefix
    bool failed = false;            // reallocate: a selected client failed
    float obj = w;
    float n0_2 = 0.f, b0_2 = 0.f;   // the masked P4's S0 split
    if constexpr (HasFailure) {
      if (args.mode == kOverprovision) {
        if (tid == 0) {
          // the smallest prefix whose declared rates sum to the plain count:
          // prefix sums in ranked order, added left to right
          int n_exp = 1;
          float acc = 0.f;
          for (int r = 0; r < K; ++r) {
            acc = acc + s_rate[s_idx[r]];
            if (!(acc < (float)n_sel)) break;
            ++n_exp;
          }
          const float cap = floorf((float)(1.0 + 1e-9) / b_min);
          int n_max = cap >= (float)K ? K : (int)cap;
          if constexpr (HasGuard) {
            if (admits) n_max = min(n_max, n_adm);  // never into the demoted tail
          }
          int n_ext = min(max(max(n_exp, n_sel), 0), n_max);
          s_int[0] = n_sel > 0 ? n_ext : 0;
        }
        __syncthreads();
        n_act = s_int[0];
        resolved = n_act != n_sel;
      } else if (args.mode == kReallocate) {
        int lost = 0;
        for (int r = tid; r < n_sel; r += nt) lost |= s_ok[s_idx[r]] > 0.f ? 0 : 1;
        failed = __syncthreads_or(lost) != 0;
      }
      if (resolved || failed) {
        // member flags of the masked P4 (its positive-rho members) and the
        // size of its S0 part
        int zs = 0;
        for (int r = tid; r < K; r += nt) {
          const bool in = resolved ? r < n_act : (r < n_sel && s_ok[s_idx[r]] > 0.f);
          s_mem[r] = in && r >= n0 ? 1.f : 0.f;
          zs += in && r < n0 ? 1 : 0;
        }
        n0_2 = block_sum((float)zs, s_red);
        float npos = 0.f;
        for (int r = tid; r < K; r += nt) npos += s_mem[r];
        npos = block_sum(npos, s_red);
        const float delta2 = 1.f - n0_2 * b_min;
        masked_waterfill<NT>(s_key, s_mem, K, delta2, beta, b_min, args.wf_outer,
                             args.wf_inner, args.wf_grid, args.frac, s_b2, s_wf);
        const float left2 = npos == 0.f ? delta2 : 0.f;
        b0_2 = b_min + left2 / jmax(n0_2, 1.f);
      }
    }

    // 6. unsort, energy, the P3 value of a re-solved prefix, the queues.
    const float* inc_t = args.inc + row;
    const float* h_t = HasGuard ? s_h2 : h2_t;  // the guard's sanitized gains
    float cost = 0.f;
    for (int r = tid; r < K; r += nt) {
      const bool in_s0 = r < n0;
      const int k = s_idx[r];
      const bool a0 = r < n_sel;
      float b = a0 ? (in_s0 ? b0_each : best[r]) : 0.f;
      if constexpr (HasGuard) {
        if (scaled && a0 && !in_s0) b = best[r] * args.chaos_scale;
      }
      const bool a = r < n_act;
      float e = energy_of(b, h_t[k], beta, scale) * (a0 ? 1.f : 0.f);
      if constexpr (HasFailure) {
        const bool ok = s_ok[k] > 0.f;
        if (resolved) {
          // the extended prefix's allocation (repro/core/ocean.py:389-394)
          b = a ? (s_mem[r] > 0.f ? s_b2[r] : (in_s0 ? b0_2 : 0.f)) : 0.f;
          e = energy_of(b, h_t[k], beta, scale) * (a ? 1.f : 0.f);
          if (a) cost += s_key[r] * f_shannon(jmax(b, b_min), beta);
        } else if (failed) {
          // half the committed round, half the survivors' re-solved one
          const bool surv = a0 && ok;
          const float b2 = surv ? (s_mem[r] > 0.f ? s_b2[r] : (in_s0 ? b0_2 : 0.f)) : 0.f;
          const float e2 = energy_of(b2, h_t[k], beta, scale) * (surv ? 1.f : 0.f);
          e = 0.5f * e + 0.5f * e2;
        }
        args.dlv_out[row + k] = a && ok ? 1 : 0;
      }
      args.a_out[row + k] = a ? 1 : 0;
      args.b_out[row + k] = b;
      args.e_out[row + k] = e;
      float inc = inc_t[k];
      if constexpr (HasGuard) {
        if ((args.guard & kQuarantine) && !isfinite(inc)) inc = 0.f;
      }
      s_q[k] = jmax(s_q[k] + e - inc, 0.f);
      s_es[k] = s_es[k] + e;
    }
    if constexpr (HasFailure) {
      if (resolved) obj = p.v_eta * (float)n_act - scale * block_sum(cost, s_red);
    }
    if (tid == 0) {
      args.obj_out[ct] = obj;
      args.nsel_out[ct] = n_act;
      if constexpr (HasFailure) args.ral_out[ct] = failed ? 1 : 0;
      if constexpr (HasGuard) {
        args.fc_out[ct] = n_fault;
        args.dm_out[ct] = n_dem;
        args.fb_out[ct] = fell;
      }
    }
    __syncthreads();  // this round's queue writes before the next round's reads
  }
  for (int i = tid; i < K; i += nt) {
    args.q_final[(size_t)c * K + i] = s_q[i];
    args.es_final[(size_t)c * K + i] = s_es[i];
  }
}

// Shared bytes with nteams teams: the sort's keys and indices, q and the
// spent energy, each team's two rows, the argmax scratch; HasFailure adds
// four rows (mask, rates, member flags, the masked P4's allocation), its
// grid scratch and four ints; HasGuard two rows (gains, caps).
size_t traj_smem(int K, int P, int nteams, bool failure, bool guard) {
  size_t floats = (2 + 2 * (size_t)nteams) * K + 64;
  if (failure) floats += 4 * (size_t)K + 32 + 4;
  if (guard) floats += 2 * (size_t)K;
  return (size_t)P * 8 + floats * sizeof(float);
}

int sort_slots(int K) {
  int P = 32;
  while (P < K) P <<= 1;
  return P;
}

// Teams of NT lanes per block: one per candidate up to what a block holds
// (as K1: threads_for's register limit, then whole warps fewer until the
// shared rows fit the card's per-block limit).
template <int NT, bool HasRadio, bool HasFailure, bool HasGuard, bool Bisect>
int traj_teams(int K, int P) {
  const void* fn = (const void*)ocean_traj_kernel<NT, HasRadio, HasFailure, HasGuard, Bisect>;
  int nteams = threads_for(fn, NT * K, 1024) / NT;
  const size_t optin = (size_t)smem_optin();
  while (nteams > 32 / NT && traj_smem(K, P, nteams, HasFailure, HasGuard) > optin)
    nteams -= 32 / NT;
  return nteams;
}

template <int NT, bool HasRadio, bool HasFailure, bool HasGuard, bool Bisect>
int launch(const TrajArgs& args, int C, cudaStream_t stream) {
  const int nteams = traj_teams<NT, HasRadio, HasFailure, HasGuard, Bisect>(args.K, args.P);
  const size_t smem = traj_smem(args.K, args.P, nteams, HasFailure, HasGuard);
  const void* fn = (const void*)ocean_traj_kernel<NT, HasRadio, HasFailure, HasGuard, Bisect>;
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return (int)err;
  ocean_traj_kernel<NT, HasRadio, HasFailure, HasGuard, Bisect>
      <<<C, NT * nteams, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int NT, bool HasGuard, bool Bisect>
int launch_branches(const TrajArgs& args, int C, cudaStream_t stream) {
  const bool radio = args.r_bmin != nullptr, failure = args.dlv != nullptr;
  if (radio && failure) return launch<NT, true, true, HasGuard, Bisect>(args, C, stream);
  if (radio) return launch<NT, true, false, HasGuard, Bisect>(args, C, stream);
  if (failure) return launch<NT, false, true, HasGuard, Bisect>(args, C, stream);
  return launch<NT, false, false, HasGuard, Bisect>(args, C, stream);
}

template <int NT>
int launch_nt(const TrajArgs& args, int C, cudaStream_t stream, bool guard, bool bisect) {
  if (guard) {
    return bisect ? launch_branches<NT, true, true>(args, C, stream)
                  : launch_branches<NT, true, false>(args, C, stream);
  }
  return bisect ? launch_branches<NT, false, true>(args, C, stream)
                : launch_branches<NT, false, false>(args, C, stream);
}

}  // namespace

// The warps a K3 block runs at K clients (the instance without failures,
// or with them; no guard, K1's sweep).
extern "C" int ocean_traj_warps(int K, int failure) {
  const int P = sort_slots(K);
  if (K <= kHalfWarpMaxK)
    return (failure ? traj_teams<16, false, true, false, false>(K, P)
                    : traj_teams<16, false, false, false, false>(K, P)) / 2;
  return failure ? traj_teams<32, false, true, false, false>(K, P)
                 : traj_teams<32, false, false, false, false>(K, P);
}

// One launch: every cell's T rounds.  r_bmin/r_beta/r_scale (C, T) select
// the streamed-radio instance (null: the static radio of b_min/beta/scale);
// dlv (C, T, K) and rate (C, K) select the failure instance (null: none),
// which also writes dlv_out (C, T, K) and ral_out (C, T) and applies
// ``mode`` with the masked P4 budgets wf_outer/wf_inner/wf_grid over the
// grid fractions ``frac``.  ``bisect`` selects the bisect sweep
// (bis_outer x bis_inner halvings); ``guarded`` the HasGuard instance,
// which applies the ``guard`` bits, ``gain_floor``, the (K,) ``cap`` row
// (null: no energy test), ``residual_tol`` and the ``chaos`` corruption,
// and writes fc_out, dm_out and fb_out (C, T).
extern "C" int ocean_traj_launch(
    const float* h2, const float* v, const float* eta, const float* inc,
    uint8_t* a, float* b, float* e, float* q_pre, float* rho, float* obj,
    int* nsel, float* q_final, float* es_final, int C, int T, int K, int R,
    float b_min, float beta, float scale, int outer, int inner,
    const float* r_bmin, const float* r_beta, const float* r_scale,
    const float* dlv, const float* rate, uint8_t* dlv_out, int* ral_out, int mode,
    int wf_outer, int wf_inner, int wf_grid, const float* frac, int bisect, int bis_outer,
    int bis_inner, int guarded, const float* cap, int* fc_out, int* dm_out, int* fb_out,
    int guard, float gain_floor, float residual_tol, int chaos, float chaos_scale,
    void* stream) {
  TrajArgs args{h2, v, eta, inc, r_bmin, r_beta, r_scale, dlv, rate, frac,
                a, b, e, q_pre, rho, obj, nsel, q_final, es_final, dlv_out, ral_out,
                T, K, sort_slots(K), R, b_min, beta, scale, outer, inner, mode,
                wf_outer, wf_inner, wf_grid, bis_outer, bis_inner, cap, fc_out, dm_out,
                fb_out, guard, gain_floor, residual_tol, chaos, chaos_scale};
  auto run = K <= kHalfWarpMaxK ? launch_nt<16> : launch_nt<32>;
  return run(args, C, (cudaStream_t)stream, guarded != 0, bisect != 0);
}
