// K3 ocean_traj: the whole T-round OCEAN trajectory (paper Alg. 1) per cell.
//
// The kernel template and its launch helpers; ocean_traj.cu instantiates
// the instances without telemetry and ocean_traj_metrics.cu those with it
// (HasMetrics), so that nvcc builds the two halves in parallel.
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
// Five compile-time branches (template parameters; the instance without
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
//   HasMetrics  a MetricsSpec (repro_torch/obs/metrics.py; the reference
//               kernel's :134-145, :182-196, :240-255, :316-322, :508-531):
//               after each round's closing barrier one more pass in client
//               order reads the round's rows back (q_pre, a, b, e, the
//               delivered mask) with the updated q and spent energy, updates
//               each client's state (allowance, selection count, gap) and
//               accumulators (means, histogram bins by atomicAdd of 1), and
//               block-sums the scalar collectors' terms; the scalar entries
//               are spread over the threads, the running counters kept in
//               every thread's registers.  Traces go straight
//               to their (C, T, ...) and (C, slots, ...) outputs.  The state
//               and accumulators are one per-cell region, in shared memory
//               where it fits beside the round's own rows (the launch gives
//               up teams for it) and otherwise in a per-cell global scratch
//               that only the cell's block touches.  What to collect is a
//               launch descriptor (MetricsDesc), a __grid_constant__
//               parameter; the instances without it take an empty one.
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
#pragma once

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

// The collectors in repro_torch/kernels/ocean_traj.py's KERNEL_COLLECTORS
// order (the first five are per client) and the reductions in REDUCTIONS'.
enum {
  kQueue, kQueueNext, kEnergyHeadroom, kSelectionCount, kSelectionGap,
  kLyapunov, kLyapunovDrift, kDppPenalty, kDppDrift, kNumSelected, kSolverResidual,
  kBminActive, kDeliveryRate, kWastedEnergy, kReallocationCount, kFaultCount,
  kDemotedClients, kFallbackRounds, kTopmSaturated, kNumCollectors
};
enum { kLast = 0, kMean = 1, kHistogram = 2, kTrace = 3, kTraceDs = 4 };
constexpr int kMaxEntries = kNumCollectors * 5;
// The block sums of a round's scalar terms: sum q^2, sum q_next^2, sum q e,
// sum b, the b_min clamp count, the delivered count, the wasted energy.
constexpr int kMetricSums = 7;

// The instances without telemetry.
struct NoMetrics {
  static constexpr bool kOn = false;
};

// A MetricsSpec lowered to one launch (repro_torch/kernels/ocean_traj.py,
// _metrics_descriptor).  Offsets are floats into the cell's region: the
// state rows (cum: the allowance of energy_headroom; cnt: selection_count;
// last/gsum/gn: selection_gap's last round, gap sum and gap count; -1 where
// the spec needs none) and per entry its mean accumulator (K floats, or 1)
// or histogram (bins floats).  The per-client collectors' entries come
// first: every thread walks them for its clients, and the scalar ones are
// spread over the threads, one or a few each.
struct MetricsDesc {
  static constexpr bool kOn = true;
  int n;                       // entries
  int n_client;                // entries 0..n_client-1 have per-client collectors
  int cum, cnt, last, gsum, gn;
  int region;                  // floats of the per-cell region
  int in_smem;                 // the region lives in shared memory (set at launch)
  int stride;                  // full_trace_ds's stride
  int bins;                    // histogram bins
  float* scratch;              // (C, region) global region where it does not fit
  int col[kMaxEntries], red[kMaxEntries], off[kMaxEntries];
  float lo[kMaxEntries], width[kMaxEntries];  // histogram: lo and bin width
  float* out[kMaxEntries];     // the entry's output
};

// One entry of the descriptor as the kernel reads it every round: copied
// to shared memory at the start, since the round's walk over the entries
// misses the constant cache when it reads them from the parameter space
// (on the H100, 25 per-client entries cost ~10 µs a round that way).
struct alignas(16) MetricsEntry {
  float* out;
  int col, red, off;
  float lo, width;
};

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

// The block's sums of N floats per thread at once (each as block_sum adds
// one, in the same fixed order); every thread gets them.  ``red`` holds
// 32 N floats.
template <int N>
__device__ void block_sum_n(float (&x)[N], float* red) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = warp_all<Sum>(x[j]);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) red[warp * N + j] = x[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w * N + j];
    x[j] = s;
  }
  __syncthreads();
}

// The histogram bin of a value: floor((v - lo) / width) clipped to
// [0, bins - 1], a NaN in bin 0 (repro_torch.obs.metrics.hist_bin).
__device__ __forceinline__ int hist_bin(float v, float lo, float width, int bins) {
  const float f = floorf((v - lo) / width);
  return f >= (float)(bins - 1) ? bins - 1 : (f >= 0.f ? (int)f : 0);
}

// One reduction of entry j on a value of the cell's round t: ``elem`` is
// the client (per-client collectors, every thread for its own clients) or
// 0 with ``width`` 1 (scalar collectors, one thread an entry).
__device__ __forceinline__ void metrics_reduce(const MetricsDesc& md, const MetricsEntry& e,
                                               float* reg, float v, int c, int elem, int width,
                                               int T, int t) {
  switch (e.red) {
    case kLast:
      if (t == T - 1) e.out[(size_t)c * width + elem] = v;
      break;
    case kMean:
      reg[e.off + elem] += v;
      break;
    case kHistogram:
      atomicAdd(reg + e.off + hist_bin(v, e.lo, e.width, md.bins), 1.f);
      break;
    case kTrace:
      e.out[((size_t)c * T + t) * width + elem] = v;
      break;
    default:  // kTraceDs
      if (t % md.stride == 0) {
        const int slots = (T + md.stride - 1) / md.stride;
        e.out[((size_t)c * slots + t / md.stride) * width + elem] = v;
      }
  }
}

// A round's telemetry (HasMetrics), after the round's closing barrier: the
// round's rows as written, q_next and the spent energy from shared memory,
// the raw increments; ``n_act`` the committed count, ``v_eta`` V eta^t, the
// round's b_min, and the reallocation / quarantine / demotion / fallback
// counts of the round, which every thread adds to its copy of the running
// counters ``ctr`` (block-uniform, in registers).
template <bool HasFailure>
__device__ __forceinline__ void metrics_pass(const MetricsDesc& md, const TrajArgs& args,
                                             const MetricsEntry* s_ent, float* reg,
                                             float* s_msum, const float* s_q,
                                             const float* s_es, int c, int t, size_t row,
                                             int n_act, float v_eta, float b_min, float ral,
                                             float n_fault, float n_dem, float fell,
                                             float (&ctr)[4]) {
  const int T = args.T, K = args.K, tid = threadIdx.x, nt = blockDim.x;
  const float bmin_hi = b_min * (float)(1.0 + 1e-6);
  float part[kMetricSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = tid; k < K; k += nt) {
    const float q = args.qpre_out[row + k];
    const float qn = s_q[k];
    const bool a = args.a_out[row + k] != 0;
    const float b = args.b_out[row + k];
    const float e = args.e_out[row + k];
    part[0] += q * q;
    part[1] += qn * qn;
    part[2] += q * e;
    part[3] += b;
    part[4] += a && b <= bmin_hi ? 1.f : 0.f;
    if constexpr (HasFailure) {
      const bool d = args.dlv_out[row + k] != 0;
      part[5] += d ? 1.f : 0.f;
      part[6] += e * (a && !d ? 1.f : 0.f);
    }
    float cum = 0.f, cnt = 0.f, gap = 0.f;
    if (md.cum >= 0) {
      cum = reg[md.cum + k] + args.inc[row + k];
      reg[md.cum + k] = cum;
    }
    if (md.cnt >= 0) {
      cnt = reg[md.cnt + k] + (a ? 1.f : 0.f);
      reg[md.cnt + k] = cnt;
    }
    if (md.last >= 0) {
      const float lt = reg[md.last + k];
      const bool take = a && lt >= 0.f;
      const float gs = reg[md.gsum + k] + (take ? (float)(t - (int)lt) : 0.f);
      const float gn = reg[md.gn + k] + (take ? 1.f : 0.f);
      if (a) reg[md.last + k] = (float)t;
      reg[md.gsum + k] = gs;
      reg[md.gn + k] = gn;
      gap = gs / jmax(gn, 1.f);
    }
    for (int j = 0; j < md.n_client; ++j) {
      const MetricsEntry e = s_ent[j];
      float v;
      switch (e.col) {
        case kQueue: v = q; break;
        case kQueueNext: v = qn; break;
        case kEnergyHeadroom: v = cum - s_es[k]; break;
        case kSelectionCount: v = cnt; break;
        default: v = gap;  // kSelectionGap
      }
      metrics_reduce(md, e, reg, v, c, k, K, T, t);
    }
  }
  block_sum_n<kMetricSums>(part, s_msum);
  ctr[0] += ral;
  ctr[1] += n_fault;
  ctr[2] += n_dem;
  ctr[3] += fell;
  const float ns = (float)n_act;
  for (int j = md.n_client + tid; j < md.n; j += nt) {
    const MetricsEntry e = s_ent[j];
    float v;
    switch (e.col) {
      case kLyapunov: v = 0.5f * part[0]; break;
      case kLyapunovDrift: v = 0.5f * (part[1] - part[0]); break;
      case kDppPenalty: v = v_eta * ns; break;
      case kDppDrift: v = part[2]; break;
      case kNumSelected: v = ns; break;
      case kSolverResidual: v = fabsf(part[3] - 1.f) * (n_act > 0 ? 1.f : 0.f); break;
      case kBminActive: v = part[4]; break;
      case kDeliveryRate: v = (HasFailure ? part[5] : ns) / jmax(ns, 1.f); break;
      case kWastedEnergy: v = HasFailure ? part[6] : 0.f; break;
      case kReallocationCount: v = ctr[0]; break;
      case kFaultCount: v = ctr[1]; break;
      case kDemotedClients: v = ctr[2]; break;
      case kFallbackRounds: v = ctr[3]; break;
      default: v = 0.f;  // kTopmSaturated: ranking="sort", the only one K3 runs
    }
    metrics_reduce(md, e, reg, v, c, 0, 1, T, t);
  }
}

// E(b | h) of one selected client (repro/core/energy.py:159), with the
// port's b >= FLT_MIN: a subnormal b counts as 0, as under the reference's
// flush-to-zero platforms and the plain version.
__device__ __forceinline__ float energy_of(float b, float h2, float beta, float scale) {
  return b >= FLT_MIN ? scale * f_shannon(b, beta) / h2 : 0.f;
}

__host__ __device__ size_t traj_smem(int K, int P, int nteams, bool failure, bool guard);

template <int NT, bool HasRadio, bool HasFailure, bool HasGuard, bool Bisect, class M>
__global__ void __maxnreg__(NT == 32 ? kMaxRegs : 128)
    ocean_traj_kernel(const TrajArgs args, const __grid_constant__ M md) {
  constexpr bool HasMetrics = M::kOn;
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
  // HasMetrics: past the round's own layout (16-byte aligned) the entries,
  // the block-sum scratch, then the cell's region there or in the global
  // scratch.
  MetricsEntry* s_ent = nullptr;
  float* s_msum = nullptr;
  float* reg = nullptr;
  float mctr[4] = {0.f, 0.f, 0.f, 0.f};  // the running counters (block-uniform)
  if constexpr (HasMetrics) {
    const size_t base = (traj_smem(K, P, nteams, HasFailure, HasGuard) + 15) & ~(size_t)15;
    s_ent = reinterpret_cast<MetricsEntry*>(reinterpret_cast<char*>(smem) + base);
    s_msum = reinterpret_cast<float*>(s_ent + kMaxEntries);
    reg = md.in_smem ? s_msum + 32 * kMetricSums : md.scratch + (size_t)c * md.region;
    for (int j = tid; j < md.n; j += nt)
      s_ent[j] = MetricsEntry{md.out[j], md.col[j], md.red[j], md.off[j], md.lo[j], md.width[j]};
    for (int i = tid; i < md.region; i += nt)
      reg[i] = md.last >= 0 && i >= md.last && i < md.last + K ? -1.f : 0.f;
  }

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
    if constexpr (HasMetrics) {
      metrics_pass<HasFailure>(md, args, s_ent, reg, s_msum, s_q, s_es, c, t, row, n_act, p.v_eta,
                               b_min, failed ? 1.f : 0.f, (float)n_fault, (float)n_dem,
                               (float)fell, mctr);
    }
  }
  for (int i = tid; i < K; i += nt) {
    args.q_final[(size_t)c * K + i] = s_q[i];
    args.es_final[(size_t)c * K + i] = s_es[i];
  }
  if constexpr (HasMetrics) {
    __syncthreads();  // every histogram count and scalar accumulator is in
    for (int j = 0; j < md.n; ++j) {
      const MetricsEntry e = s_ent[j];
      const int width = j < md.n_client ? K : 1;
      if (e.red == kMean) {
        for (int i = tid; i < width; i += nt) e.out[(size_t)c * width + i] = reg[e.off + i];
      } else if (e.red == kHistogram) {
        for (int i = tid; i < md.bins; i += nt) e.out[(size_t)c * md.bins + i] = reg[e.off + i];
      }
    }
  }
}

// Shared bytes with nteams teams: the sort's keys and indices, q and the
// spent energy, each team's two rows, the argmax scratch; HasFailure adds
// four rows (mask, rates, member flags, the masked P4's allocation), its
// grid scratch and four ints; HasGuard two rows (gains, caps).  HasMetrics
// places its own after these (metrics_smem).
__host__ __device__ size_t traj_smem(int K, int P, int nteams, bool failure, bool guard) {
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

// HasMetrics' shared bytes: up to 15 of alignment, the entries, the
// block-sum scratch, and the region where it lives in shared memory.
inline size_t metrics_smem(const NoMetrics&) { return 0; }
inline size_t metrics_smem(const MetricsDesc& md) {
  return 15 + kMaxEntries * sizeof(MetricsEntry) +
         (32 * (size_t)kMetricSums + (md.in_smem ? (size_t)md.region : 0)) * sizeof(float);
}

// Teams of NT lanes per block: one per candidate up to what a block holds
// (as K1: threads_for's register limit, then whole warps fewer until the
// shared rows, with ``extra`` bytes of telemetry, fit the card's per-block
// limit).
template <int NT, bool HasRadio, bool HasFailure, bool HasGuard, bool Bisect, class M>
int traj_teams(int K, int P, size_t extra) {
  const void* fn = (const void*)ocean_traj_kernel<NT, HasRadio, HasFailure, HasGuard, Bisect, M>;
  int nteams = threads_for(fn, NT * K, 1024) / NT;
  const size_t optin = (size_t)smem_optin();
  while (nteams > 32 / NT && traj_smem(K, P, nteams, HasFailure, HasGuard) + extra > optin)
    nteams -= 32 / NT;
  return nteams;
}

// Where a descriptor's region lives: shared memory if it fits beside one
// warp of teams, else the global scratch.
inline void place_region(NoMetrics&, int, int, int, bool, bool) {}
inline void place_region(MetricsDesc& md, int K, int P, int NT, bool failure, bool guard) {
  md.in_smem = 1;
  md.in_smem = traj_smem(K, P, 32 / NT, failure, guard) + metrics_smem(md) <=
               (size_t)smem_optin();
}

template <int NT, bool HasRadio, bool HasFailure, bool HasGuard, bool Bisect, class M>
int launch(const TrajArgs& args, M md, int C, cudaStream_t stream) {
  place_region(md, args.K, args.P, NT, HasFailure, HasGuard);
  const size_t extra = metrics_smem(md);
  const int nteams =
      traj_teams<NT, HasRadio, HasFailure, HasGuard, Bisect, M>(args.K, args.P, extra);
  const size_t smem = traj_smem(args.K, args.P, nteams, HasFailure, HasGuard) + extra;
  const void* fn = (const void*)ocean_traj_kernel<NT, HasRadio, HasFailure, HasGuard, Bisect, M>;
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return (int)err;
  ocean_traj_kernel<NT, HasRadio, HasFailure, HasGuard, Bisect, M>
      <<<C, NT * nteams, smem, stream>>>(args, md);
  return (int)cudaGetLastError();
}

template <int NT, bool HasGuard, bool Bisect, class M>
int launch_branches(const TrajArgs& args, const M& md, int C, cudaStream_t stream) {
  const bool radio = args.r_bmin != nullptr, failure = args.dlv != nullptr;
  if (radio && failure) return launch<NT, true, true, HasGuard, Bisect>(args, md, C, stream);
  if (radio) return launch<NT, true, false, HasGuard, Bisect>(args, md, C, stream);
  if (failure) return launch<NT, false, true, HasGuard, Bisect>(args, md, C, stream);
  return launch<NT, false, false, HasGuard, Bisect>(args, md, C, stream);
}

template <int NT, class M>
int launch_nt(const TrajArgs& args, const M& md, int C, cudaStream_t stream, bool guard,
              bool bisect) {
  if (guard) {
    return bisect ? launch_branches<NT, true, true>(args, md, C, stream)
                  : launch_branches<NT, true, false>(args, md, C, stream);
  }
  return bisect ? launch_branches<NT, false, true>(args, md, C, stream)
                : launch_branches<NT, false, false>(args, md, C, stream);
}

// Every instance of one launch: K <= kHalfWarpMaxK takes half-warp teams.
template <class M>
int launch_any(const TrajArgs& args, const M& md, int C, cudaStream_t stream, bool guard,
               bool bisect) {
  return args.K <= kHalfWarpMaxK ? launch_nt<16>(args, md, C, stream, guard, bisect)
                                 : launch_nt<32>(args, md, C, stream, guard, bisect);
}

}  // namespace

// The launch functions' common parameters (ocean_traj_launch's, and the
// first ones of ocean_traj_metrics_launch) and the TrajArgs they make.
// r_bmin/r_beta/r_scale (C, T) select the streamed-radio instance (null:
// the static radio of b_min/beta/scale); dlv (C, T, K) and rate (C, K)
// select the failure instance (null: none), which also writes dlv_out
// (C, T, K) and ral_out (C, T) and applies ``mode`` with the masked P4
// budgets wf_outer/wf_inner/wf_grid over the grid fractions ``frac``.
// ``bisect`` selects the bisect sweep (bis_outer x bis_inner halvings);
// ``guarded`` the HasGuard instance, which applies the ``guard`` bits,
// ``gain_floor``, the (K,) ``cap`` row (null: no energy test),
// ``residual_tol`` and the ``chaos`` corruption, and writes fc_out, dm_out
// and fb_out (C, T).
#define OCEAN_TRAJ_PARAMS                                                                     \
  const float *h2, const float *v, const float *eta, const float *inc, uint8_t *a, float *b,  \
      float *e, float *q_pre, float *rho, float *obj, int *nsel, float *q_final,               \
      float *es_final, int C, int T, int K, int R, float b_min, float beta, float scale,       \
      int outer, int inner, const float *r_bmin, const float *r_beta, const float *r_scale,    \
      const float *dlv, const float *rate, uint8_t *dlv_out, int *ral_out, int mode,           \
      int wf_outer, int wf_inner, int wf_grid, const float *frac, int bisect, int bis_outer,   \
      int bis_inner, int guarded, const float *cap, int *fc_out, int *dm_out, int *fb_out,     \
      int guard, float gain_floor, float residual_tol, int chaos, float chaos_scale

#define OCEAN_TRAJ_ARGS                                                                       \
  TrajArgs {                                                                                  \
    h2, v, eta, inc, r_bmin, r_beta, r_scale, dlv, rate, frac, a, b, e, q_pre, rho, obj, nsel, \
        q_final, es_final, dlv_out, ral_out, T, K, sort_slots(K), R, b_min, beta, scale,       \
        outer, inner, mode, wf_outer, wf_inner, wf_grid, bis_outer, bis_inner, cap, fc_out,    \
        dm_out, fb_out, guard, gain_floor, residual_tol, chaos, chaos_scale                    \
  }
