// K3 ocean_traj's wide instances: ranking="topm" past the shared-memory
// sort's K <= 2048 (kernels/ocean_traj.py, MAX_CLIENTS), with no per-client
// row in shared memory.  The kernel template and its launch helpers; two
// sources instantiate it, so that nvcc builds them in parallel:
// ocean_traj_wide.cu (no telemetry) and ocean_traj_wide_metrics.cu
// (HasMetrics).
//
// Replaces the same TPU kernel as ocean_traj.cuh (repro/kernels/
// ocean_traj.py:96 ``_traj_kernel``, pallas_call at :532), which has no
// limit on K: it cuts its chunk of rounds down for large K
// (CHUNK_ELEM_BUDGET, :83-87, :398-400).  One block per cell runs all T
// rounds.  The carry (the queues and the spent energy) lives in the
// q_final / es_final outputs, which only the cell's block touches, seeded
// from q0 / es0 on a segment launch; each client is handled by the same
// thread in every pass, so no barrier guards the carry.  Each round:
//   1. a streaming pass over the cell's K clients: the frame reset, (the
//      guard's screens,) rho = q / max(h2, 1e-30), the q_pre and rho rows,
//      n0 (rho <= 1e-30, a block sum of integers: exact in any order), and
//      the top-m extraction of the positive rho: K2's phase 1 with one CTA
//      (ocean_p.cu): keys below the running top_m-th key are appended to a
//      buffer that bitonic_sort merges into the sorted running list.  With
//      one CTA the list positions are the ranks, so the list's first
//      min(top_m, K - n0) keys are the compact row, in topm_extract's order
//      ((rho, client index), ties to the lower index; a NaN rho ranks as
//      +inf, as the plain extraction ranks it).
//   2. the sweep on the compact row: rho = the row, L = n_cands =
//      min(top_m, K - n0), start = 0, with K1's candidate (and
//      pallas_tiled's non-finite mask), the bisect sweep, or the newton
//      sweep after its seed grid (whose largest rho is the whole row's,
//      reduced in pass 1).  Lanes map slots relative to ``start``, so each
//      candidate's members are summed in the order of the shared-memory
//      top-m instance (start = n0 over the sorted row): at K <= 2048 the
//      two give the same bits on every output.
//   3. the commit in client order: S0 clients take b0_each (the fix-up of
//      repro/core/selection.py:345-347), the winners (compact slots < m*,
//      found by a binary search of the client's key in the compact row's
//      keys) the winning team's allocation, every other client 0; then
//      the energy (energy.py, b >= FLT_MIN as ocean_traj.cuh), the queue
//      and spent-energy update, and the a, b and e rows.
// The branches of ocean_traj.cuh, with their per-client state recomputed
// or kept in global memory instead of shared rows:
//   HasGuard    pass 1 screens each gain (quarantine, the gain floor, the
//               (K,) cap row) and demotes before forming the key; the
//               commit recomputes the same sanitized gain.  The counts are
//               block sums of integers.  The validation walks the committed
//               slots r < n_sel of the sorted order (r < n0: b0_each, else
//               the winner's row at r - n0), thread r % nt as the shared
//               instance walks them, and on a violation the bisect sweep
//               runs on the same compact row.  The chaos corruption as in
//               ocean_traj.cuh.
//   HasFailure  ``plain`` and ``reallocate`` (``overprovision`` extends the
//               prefix in the full ranked order: refused).  Pass 1 counts
//               the delivered S0 clients; a pass over the compact slots
//               flags the delivered winners, and the masked P4 runs on the
//               compact row with a lane offset of n0 % 32 (its member and
//               allocation rows carry 32 leading slots), so that slot j sits
//               on the lane of sorted slot n0 + j and the survivors'
//               allocation has the shared instance's bits.
//   HasMetrics  metrics_pass (ocean_traj.cuh) after each round, on the
//               carry in q_final / es_final; the per-cell region always
//               lives in the global scratch.  Under stream_bf16 passes 1 and
//               3 write the (C, 3, K) float32 mirror.
// Shared memory is independent of K: the key list and its append buffer
// (aliased with each team's two sweep rows, which the sweep writes only
// after the list is copied out), the compact row's keys and priorities,
// the newton seed bits and levels, a few scalars, and with HasFailure the
// masked P4's two rows of 32 + top_m floats and its grid scratch.  The
// rows' element type (float32, or bfloat16 under stream_bf16) is a launch
// argument as in ocean_traj.cuh.  Instances: the static or the streamed
// radio (HasRadio) x failure x guard x K1's, the bisect or the newton
// sweep.
//
// What bounds it on the H100: per cell-round it reads h2, inc and the
// carry (twice each, the second pass mostly from L2) and writes five rows
// and the carry, ~33 bytes a client in float32 (25 in bf16), and sweeps
// min(top_m, K - n0) candidates.  At traj_bench's K = 10^4, 8 cells, the
// sweep's chain bounds a round as in the shared instances; at K = 10^5 the
// streaming passes of one block take most of it.  The guard adds block
// reductions and, on a failed validation, the bisect sweep; reallocate a
// masked P4 on the compact row; the telemetry one more pass over the
// clients.  A block per cell leaves most SMs idle at 1-8 cells: a cluster
// per cell (as K2's) is the redesign that answers it.
#pragma once

#include "ocean_traj.cuh"

namespace {

// The masked P4's rows (HasFailure) carry this many leading slots: the
// member flags' are 0, the allocation's are scratch.
constexpr int kLanePad = 32;

// The block's reduction of one float per thread under Op, in a fixed
// order (warps, then over the warps' results); every thread gets it.
template <class Op>
__device__ float block_all(float x, float* red) {
  x = warp_all<Op>(x);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < nwarps; ++w) s = Op::op(s, red[w]);
  __syncthreads();
  return s;
}

// Shared bytes of a wide block with nteams teams, a list of ``list`` keys
// (the clip, min(top_m, K)) and an append buffer of ``cap`` keys: region A
// (the list and its buffer while extracting, then each team's two sweep
// rows), the compact row's keys and priorities, the argmax scratch, the
// newton seed bits and levels, the append counter; HasFailure (``failure``)
// the masked P4's member and allocation rows and its grid scratch.
__host__ __device__ inline size_t wide_region_a(int list, int nteams, int cap) {
  const size_t keys = 8 * ((size_t)list + cap);
  const size_t rows = 4 * 2 * (size_t)nteams * list;
  return keys > rows ? keys : rows;
}
__host__ __device__ inline size_t wide_smem(int list, int nteams, int cap, bool failure) {
  size_t s =
      wide_region_a(list, nteams, cap) + 12 * (size_t)list + 4 * (64 + (size_t)list + 16 + 4);
  if (failure) s += 4 * (2 * ((size_t)kLanePad + list) + 32);
  return s;
}

// A client's gain and priority in a round: with HasGuard the quarantine
// (a non-finite or non-positive gain counts as a fault and reads as 1),
// admission (the gain floor, then E(b_min | h2) <= cap_k) and demotion
// (rho = kRhoDemoted), as ocean_traj.cuh's pass computes them.
struct Screened {
  float h, r;
  bool ok, adm;
};

template <bool HasGuard>
__device__ __forceinline__ Screened screen(const TrajArgs& args, float h, int i, float q,
                                           float b_min, float beta, float scale, bool admits) {
  Screened s{h, 0.f, true, true};
  if constexpr (HasGuard) {
    if (args.guard & kQuarantine) {
      s.ok = isfinite(h) && h > 0.f;
      if (!s.ok) s.h = 1.f;
    }
    s.adm = s.ok;
    if (args.guard & kFloor) s.adm = s.adm && s.h >= args.gain_floor;
    if (args.cap != nullptr) s.adm = s.adm && energy_of(b_min, s.h, beta, scale) <= args.cap[i];
  }
  s.r = q / jmax(s.h, kSafeDivFloor);
  if constexpr (HasGuard) {
    if (admits && !s.adm) s.r = kRhoDemoted;
  }
  return s;
}

template <bool HasRadio, bool HasFailure, bool HasGuard, int Solver, class M>
__global__ void __maxnreg__(kMaxRegs)
    ocean_traj_wide_kernel(const TrajArgs args, int cap, const __grid_constant__ M md) {
  constexpr bool HasMetrics = M::kOn;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = args.T, K = args.K, R = args.R, list = args.n_cands;
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, nteams = nt >> 5;
  uint64_t* s_keys = reinterpret_cast<uint64_t*>(smem_raw);  // list + cap, extracting
  float* s_rows = reinterpret_cast<float*>(smem_raw);        // 2 nteams list, sweeping
  uint64_t* s_ck =
      reinterpret_cast<uint64_t*>(smem_raw + wide_region_a(list, nteams, cap));  // list
  float* s_vals = reinterpret_cast<float*>(s_ck + list);        // list
  float* s_red = s_vals + list;                                  // 64
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_red + 64);    // list
  float* s_lamg = reinterpret_cast<float*>(s_bits + list);       // 16
  int* s_cnt = reinterpret_cast<int*>(s_lamg + 16);              // 1 (of 4)
  // HasFailure: the masked P4's member flags and allocation (slot j of the
  // compact row at kLanePad + j) and its grid scratch.
  float* s_mem = reinterpret_cast<float*>(s_cnt + 4);            // kLanePad + list
  float* s_b2 = s_mem + kLanePad + list;                         // kLanePad + list
  float* s_wf = s_b2 + kLanePad + list;                          // 32
  const int t0 = args.t0 != nullptr ? args.t0[c] : 0;  // the first global round
  const bool bf16 = args.bf16 != 0;
  const bool admits = (args.guard & (kQuarantine | kFloor)) != 0 || args.cap != nullptr;
  const bool realloc = HasFailure && args.mode == kReallocate;
  float* q_c = args.q_final + (size_t)c * K;  // the carry
  float* es_c = args.es_final + (size_t)c * K;
  float* mirror = HasMetrics && args.mirror != nullptr ? args.mirror + (size_t)c * 3 * K : nullptr;
  // HasMetrics: past the round's own layout (16-byte aligned) the entries
  // and the block-sum scratch; the cell's region in the global scratch.
  MetricsEntry* s_ent = nullptr;
  float* s_msum = nullptr;
  float* reg = nullptr;
  float mctr[kCounters] = {0.f, 0.f, 0.f, 0.f};  // the running counters (block-uniform)
  if constexpr (HasMetrics) {
    const size_t base = (wide_smem(list, nteams, cap, HasFailure) + 15) & ~(size_t)15;
    s_ent = reinterpret_cast<MetricsEntry*>(smem_raw + base);
    s_msum = reinterpret_cast<float*>(s_ent + kMaxEntries);
    reg = md.scratch + (size_t)c * md.region;
    for (int j = tid; j < md.n; j += nt)
      s_ent[j] = MetricsEntry{md.out[j], md.col[j], md.red[j], md.off[j], md.lo[j], md.width[j]};
    if (md.seed != nullptr) {
      const float* seed = md.seed + (size_t)c * (md.region + kCounters);
      for (int i = tid; i < md.region; i += nt) reg[i] = seed[i];
#pragma unroll
      for (int j = 0; j < kCounters; ++j) mctr[j] = seed[md.region + j];
    } else {
      for (int i = tid; i < md.region; i += nt)
        reg[i] = md.last >= 0 && i >= md.last && i < md.last + K ? -1.f : 0.f;
    }
  }
  if constexpr (HasFailure) {
    for (int i = tid; i < kLanePad; i += nt) s_mem[i] = 0.f;  // the member row's lead: no member
  }
  for (int i = tid; i < K; i += nt) {
    q_c[i] = args.q0 != nullptr ? args.q0[(size_t)c * K + i] : 0.f;
    es_c[i] = args.es0 != nullptr ? args.es0[(size_t)c * K + i] : 0.f;
  }

  for (int t = 0; t < T; ++t) {
    const size_t ct = (size_t)c * T + t;
    const size_t row = ct * K;
    const float* h2_t = args.h2 + row;
    const int tg = t0 + t;  // the global round: frame resets and telemetry
    const bool reset = tg > 0 && (tg % R) == 0;
    float b_min = args.b_min, beta = args.beta, scale = args.scale;
    if constexpr (HasRadio) {
      b_min = args.r_bmin[ct];
      beta = args.r_beta[ct];
      scale = args.r_scale[ct];
    }

    // 1. the streaming pass: reset, (the guard's screens,) priorities, the
    // q_pre and rho rows, n0, and the extraction (tiles of nt clients; a
    // merge when the next tile might not fit the buffer, and after the
    // last one).
    for (int i = tid; i < list; i += nt) s_keys[i] = kNoKey;
    if (tid == 0) *s_cnt = 0;
    __syncthreads();
    uint64_t tau = kNoKey;  // the running list's last key
    float cnt = 0.f, mx = -INFINITY;
    int n_fault = 0, n_dem = 0, rho_bad = 0;  // HasGuard
    int zs = 0, lost = 0;  // reallocate: delivered S0 clients, a lost S0 client
    for (int base = 0; base < K; base += nt) {
      const int i = base + tid;
      if (i < K) {
        const float q = reset ? 0.f : q_c[i];
        if (reset) q_c[i] = q;
        const Screened s = screen<HasGuard>(args, h2_t[i], i, q, b_min, beta, scale, admits);
        const float r = s.r;
        if constexpr (HasGuard) {
          n_fault += s.ok ? 0 : 1;
          n_dem += s.ok && !s.adm ? 1 : 0;
          rho_bad |= isfinite(r) ? 0 : 1;
        }
        put_row(args.qpre_out, row + i, q, bf16);
        put_row(args.rho_out, row + i, r, bf16);
        if constexpr (HasMetrics) {
          if (mirror != nullptr) mirror[i] = q;
        }
        if constexpr (Solver == kSolverGrid) mx = jmax(mx, r);
        if (r <= kRhoZeroTol) {
          cnt += 1.f;
          if (realloc) {
            const bool ok = args.dlv[row + i] > 0.f;
            zs += ok ? 1 : 0;
            lost |= ok ? 0 : 1;
          }
        } else {
          const uint64_t k = topm_key(r, i);
          if (k < tau) s_keys[list + atomicAdd(s_cnt, 1)] = k;
        }
      }
      __syncthreads();  // the tile's appends are in
      const int n = *s_cnt;
      __syncthreads();  // every thread has read n before the next append
      if (n > 0 && (base + nt >= K || n > cap - nt)) {
        if (tid == 0) *s_cnt = 0;
        bitonic_sort(s_keys, list + n);
        tau = s_keys[list - 1];
      }
    }
    const float n0f = block_sum(cnt, s_red);  // integers: exact in any order
    const int n0 = (int)n0f;
    const int L = min(list, K - n0);
    float row_max = 0.f;
    if constexpr (Solver == kSolverGrid) row_max = block_all<Max>(mx, s_red);
    if constexpr (HasGuard) {  // counts are integers: exact in any order
      n_fault = (int)block_sum((float)n_fault, s_red);
      n_dem = (int)block_sum((float)n_dem, s_red);
      rho_bad = __syncthreads_or(rho_bad);
    }
    for (int j = tid; j < L; j += nt) {  // the compact row, out of region A
      const uint64_t k = s_keys[j];
      s_ck[j] = k;
      s_vals[j] = key_value(k);
    }
    __syncthreads();

    // 2. the sweep on the compact row.
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
    if constexpr (Solver == kSolverBisect) {
      prefix_sweep_bisect<32>(s_vals, L, 0, L, p, args.bis_outer, args.bis_inner, s_rows, s_red,
                              w, mf, winner);
    } else if constexpr (Solver == kSolverGrid) {
      // the seed grid uses the teams' rows as scratch before the sweep
      newton_grid_seeds<true>(s_vals, L, 0, L, p, args.wf_grid, args.wf_inner, args.frac, s_rows,
                              2 * nteams * L, s_bits, s_lamg, s_red, row_max);
      prefix_sweep_parallel<32, false, GridCandidate>(
          s_vals, L, 0, L, p, s_rows, s_red, w, mf, winner, -1, 0,
          GridCandidate{s_bits, s_lamg, args.wf_grid, args.wf_outer, args.wf_inner},
          args.mask_nonfinite != 0);
    } else {
      prefix_sweep_parallel<32>(s_vals, L, 0, L, p, s_rows, s_red, w, mf, winner, -1, 0,
                                NewtonCandidate(), args.mask_nonfinite != 0);
    }
    int m_star = (int)rintf(mf);
    const float* best = s_rows + (2 * (size_t)winner + 1) * L;
    float leftover = m_star == 0 ? p.delta : 0.f;
    float b0_each = b_min + leftover / jmax(n0f, 1.f);
    bool scaled = false;  // a budget chaos backend's row x chaos_scale is committed
    int fell = 0;         // the guard committed the bisect fallback
    if constexpr (HasGuard) {
      if (args.chaos == kChaosObjective) w = w + INFINITY;
      scaled = args.chaos == kChaosBudget;
      if (args.guard & kFallback) {
        const int n_sel = n0 + m_star;
        int bad = rho_bad | (isfinite(w) ? 0 : 1);
        const float b_floor = b_min * (float)(1.0 - 1e-6);
        float rs = 0.f;
        for (int r = tid; r < n_sel; r += nt) {
          const float b = r < n0 ? b0_each
                                 : (scaled ? best[r - n0] * args.chaos_scale : best[r - n0]);
          const float bz = isfinite(b) ? b : 0.f;
          bad |= isfinite(b) && bz >= b_floor ? 0 : 1;
          rs += bz;
        }
        const float s = block_sum(rs, s_red);
        if (n_sel > 0 && !(fabsf(s - 1.f) <= args.residual_tol)) bad = 1;
        if (__syncthreads_or(bad)) {
          prefix_sweep_bisect<32>(s_vals, L, 0, L, p, args.bis_outer, args.bis_inner, s_rows,
                                  s_red, w, mf, winner);
          m_star = (int)rintf(mf);
          best = s_rows + (2 * (size_t)winner + 1) * L;
          leftover = m_star == 0 ? p.delta : 0.f;
          b0_each = b_min + leftover / jmax(n0f, 1.f);
          scaled = false;
          fell = 1;
        }
      }
    }
    // reallocate: when a selected client failed, the masked P4 of the
    // survivors (its positive-rho members are the delivered winners) and
    // its S0 split
    bool failed = false;
    float b0_2 = 0.f;
    if constexpr (HasFailure) {
      if (realloc) {
        float npos = 0.f;
        for (int j = tid; j < m_star; j += nt) {
          const bool ok = args.dlv[row + (unsigned)s_ck[j]] > 0.f;
          s_mem[kLanePad + j] = ok ? 1.f : 0.f;
          npos += ok ? 1.f : 0.f;
          lost |= ok ? 0 : 1;
        }
        failed = __syncthreads_or(lost) != 0;
        if (failed) {
          const float n0_2 = block_sum((float)zs, s_red);
          npos = block_sum(npos, s_red);
          const float delta2 = 1.f - n0_2 * b_min;
          // slot j at virtual slot o + j: lane (n0 + j) % 32, as on the
          // sorted row (the priorities are read only at member slots)
          const int o = n0 & 31;
          masked_waterfill<32>(s_vals - o, s_mem + kLanePad - o, o + m_star, delta2, beta, b_min,
                               args.wf_outer, args.wf_inner, args.wf_grid, args.frac,
                               s_b2 + kLanePad - o, s_wf);
          const float left2 = npos == 0.f ? delta2 : 0.f;
          b0_2 = b_min + left2 / jmax(n0_2, 1.f);
        }
      }
    }

    // 3. the commit in client order, then the queues.
    const float* inc_t = args.inc + row;
    for (int k = tid; k < K; k += nt) {
      const float q = q_c[k];
      // pass 1's gain and rho, bit for bit
      const Screened s = screen<HasGuard>(args, h2_t[k], k, q, b_min, beta, scale, admits);
      const bool in_s0 = s.r <= kRhoZeroTol;
      bool a = in_s0;
      float b = in_s0 ? b0_each : 0.f;
      int j = -1;  // the client's compact slot, if it won
      if (!a && m_star > 0) {
        const uint64_t key = topm_key(s.r, k);
        const int lb = lower_bound(s_ck, m_star, key);
        if (lb < m_star && s_ck[lb] == key) {
          a = true;
          j = lb;
          b = scaled ? best[j] * args.chaos_scale : best[j];
        }
      }
      float e = energy_of(b, s.h, beta, scale) * (a ? 1.f : 0.f);
      if constexpr (HasFailure) {
        const bool ok = args.dlv[row + k] > 0.f;
        if (failed) {
          // half the committed round, half the survivors' re-solved one
          const bool surv = a && ok;
          const float b2 = surv ? (j >= 0 ? s_b2[kLanePad + j] : (in_s0 ? b0_2 : 0.f)) : 0.f;
          const float e2 = energy_of(b2, s.h, beta, scale) * (surv ? 1.f : 0.f);
          e = 0.5f * e + 0.5f * e2;
        }
        args.dlv_out[row + k] = a && ok ? 1 : 0;
      }
      args.a_out[row + k] = a ? 1 : 0;
      put_row(args.b_out, row + k, b, bf16);
      put_row(args.e_out, row + k, e, bf16);
      if constexpr (HasMetrics) {
        if (mirror != nullptr) {
          mirror[K + k] = b;
          mirror[2 * K + k] = e;
        }
      }
      float inc = inc_t[k];
      if constexpr (HasGuard) {
        if ((args.guard & kQuarantine) && !isfinite(inc)) inc = 0.f;
      }
      q_c[k] = jmax(q + e - inc, 0.f);
      es_c[k] = es_c[k] + e;
    }
    const int n_act = n0 + m_star;  // a candidate never passes K - n0
    if (tid == 0) {
      args.obj_out[ct] = w;
      args.nsel_out[ct] = n_act;
      if constexpr (HasFailure) args.ral_out[ct] = failed ? 1 : 0;
      if constexpr (HasGuard) {
        args.fc_out[ct] = n_fault;
        args.dm_out[ct] = n_dem;
        args.fb_out[ct] = fell;
      }
    }
    __syncthreads();  // the winners' rows are read before the next list overwrites them
    if constexpr (HasMetrics) {
      const float sat = args.topm && (float)n_act - n0f >= (float)args.n_cands ? 1.f : 0.f;
      metrics_pass<HasFailure>(md, args, s_ent, reg, s_msum, q_c, es_c, c, t, tg, row, n_act,
                               p.v_eta, b_min, failed ? 1.f : 0.f, (float)n_fault, (float)n_dem,
                               (float)fell, sat, mctr);
    }
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
    if (md.raw != nullptr) {  // a segment's region and counters, for the next one
      float* raw = md.raw + (size_t)c * (md.region + kCounters);
      for (int i = tid; i < md.region; i += nt) raw[i] = reg[i];
      if (tid == 0) {
#pragma unroll
        for (int j = 0; j < kCounters; ++j) raw[md.region + j] = mctr[j];
      }
    }
  }
}

template <bool HasRadio, bool HasFailure, bool HasGuard, int Solver, class M>
const void* wide_fn() {
  return (const void*)ocean_traj_wide_kernel<HasRadio, HasFailure, HasGuard, Solver, M>;
}

// HasMetrics' shared bytes past the round's layout: up to 15 of alignment,
// the entries and the block-sum scratch (the region is global).
inline size_t wide_extra(const NoMetrics&) { return 0; }
inline size_t wide_extra(const MetricsDesc&) {
  return 15 + kMaxEntries * sizeof(MetricsEntry) + 32 * (size_t)kMetricSums * sizeof(float);
}

// Teams of a wide block: as many warps as the registers allow (every
// thread streams clients), fewer until the shared rows of a clip of
// ``list`` candidates (and ``extra`` bytes) fit the card's per-block
// limit; the append buffer holds two tiles.
inline int wide_teams(const void* fn, int list, bool failure, size_t extra) {
  int nteams = threads_for(fn, 1024, 1024) / 32;
  const size_t optin = (size_t)smem_optin();
  while (nteams > 1 && wide_smem(list, nteams, 64 * nteams, failure) + extra > optin) --nteams;
  return nteams;
}

template <bool HasRadio, bool HasFailure, bool HasGuard, int Solver, class M>
int launch_wide(const TrajArgs& args, const M& md, int C, cudaStream_t stream) {
  const void* fn = wide_fn<HasRadio, HasFailure, HasGuard, Solver, M>();
  const size_t extra = wide_extra(md);
  const int nteams = wide_teams(fn, args.n_cands, HasFailure, extra);
  const int cap = 64 * nteams;
  const size_t smem = wide_smem(args.n_cands, nteams, cap, HasFailure) + extra;
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return (int)err;
  ocean_traj_wide_kernel<HasRadio, HasFailure, HasGuard, Solver, M>
      <<<C, 32 * nteams, smem, stream>>>(args, cap, md);
  return (int)cudaGetLastError();
}

template <class M, bool HasRadio, bool HasFailure, bool HasGuard>
int wide_by_solver(int solver, const TrajArgs& args, const M& md, int C, cudaStream_t stream) {
  switch (solver) {
    case kSolverK1:
      return launch_wide<HasRadio, HasFailure, HasGuard, kSolverK1>(args, md, C, stream);
    case kSolverBisect:
      return launch_wide<HasRadio, HasFailure, HasGuard, kSolverBisect>(args, md, C, stream);
    case kSolverGrid:
      return launch_wide<HasRadio, HasFailure, HasGuard, kSolverGrid>(args, md, C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class M, bool HasRadio, bool HasFailure>
int wide_by_guard(int solver, const TrajArgs& args, const M& md, int C, cudaStream_t stream,
                  bool guard) {
  return guard ? wide_by_solver<M, HasRadio, HasFailure, true>(solver, args, md, C, stream)
               : wide_by_solver<M, HasRadio, HasFailure, false>(solver, args, md, C, stream);
}

// Every wide instance of one library: the radio, failure and guard
// branches as the launch's arguments select them (dlv and r_bmin non-null,
// ``guard``), the sweep by ``solver``.  Refuses ranking="sort", an empty
// clip and failure_mode overprovision.
template <class M>
int launch_wide_all(int solver, const TrajArgs& args, const M& md, int C, cudaStream_t stream,
                    bool guard) {
  const bool radio = args.r_bmin != nullptr, failure = args.dlv != nullptr;
  if (args.topm == 0 || args.n_cands < 1 || (failure && args.mode == kOverprovision))
    return (int)cudaErrorInvalidValue;
  if (radio && failure) return wide_by_guard<M, true, true>(solver, args, md, C, stream, guard);
  if (radio) return wide_by_guard<M, true, false>(solver, args, md, C, stream, guard);
  if (failure) return wide_by_guard<M, false, true>(solver, args, md, C, stream, guard);
  return wide_by_guard<M, false, false>(solver, args, md, C, stream, guard);
}

}  // namespace
