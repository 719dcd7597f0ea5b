// K3 ocean_traj's wide instances: K past the shared-memory sort's K <= 2048
// (kernels/ocean_traj.py, MAX_CLIENTS), with no per-client row in shared
// memory.  The kernel template and its launch helpers; four sources
// instantiate it, so that nvcc builds them in parallel: ocean_traj_wide.cu
// and ocean_traj_wide_metrics.cu (the compact row: ranking="topm" with a
// clip of at most 2048, without and with telemetry) and
// ocean_traj_wide_ranked.cu and ocean_traj_wide_ranked_metrics.cu (the
// ranked row: ranking="sort", a clip past 2048, failure_mode
// overprovision).
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
//      the ranking's keys (below);
//   2. the sweep: rho = the ranked candidates' priorities, L = n_cands =
//      min(clip, K - n0), start = 0, with K1's candidate (and
//      pallas_tiled's non-finite mask), the bisect sweep, or the newton
//      sweep after its seed grid (whose largest rho is the whole row's,
//      reduced in pass 1).  Lanes map slots relative to ``start``, so each
//      candidate's members are summed in the order of the shared-memory
//      instance (start = n0 over the sorted row): at K <= 2048 the two give
//      the same bits on every output;
//   3. the commit in client order: S0 clients take b0_each (the fix-up of
//      repro/core/selection.py:345-347), the winners the winning team's
//      allocation, every other client 0; then the energy (energy.py, b >=
//      FLT_MIN as ocean_traj.cuh), the queue and spent-energy update, and
//      the a, b and e rows.
// Two rankings (the template's ``Ranked``):
//   compact row  ranking="topm", a clip of at most 2048, no
//                overprovision.  Pass 1 runs the top-m extraction of the
//                positive rho: K2's phase 1 with one CTA (ocean_p.cu): keys
//                below the running top_m-th key are appended to a buffer
//                that bitonic_sort merges into the sorted running list.
//                With one CTA the list positions are the ranks, so the
//                list's first min(top_m, K - n0) keys are the compact row,
//                in topm_extract's order ((rho, client index), ties to the
//                lower index; a NaN rho ranks as +inf, as the plain
//                extraction ranks it).  The commit finds a winner (compact
//                slot < m*) by a binary search of the client's key in the
//                compact row's keys.
//   ranked row   everything else: ranking="sort" (n_cands = K), a clip past
//                2048, and failure_mode overprovision under either ranking
//                (its extension walks the full ranked order, so such an
//                instance ranks every client whatever the clip).  Pass 1
//                writes every client's key, S0 included (rank_key: a NaN
//                rho above +inf, as a stable argsort ranks it; the bisect
//                sweep there gives a candidate with a NaN member W = NaN,
//                which wins it, as in the plain version), to the
//                cell's (K,) uint64 row; bitonic_sort (ocean_common.cuh)
//                sorts it in place with the block, then one pass writes the
//                ranked priorities (key_value: the bits of rho) and each
//                client's rank.  The keys and priorities live in shared
//                memory where they fit (12 bytes a client: K <~ 19,000 on
//                the H100), else in the cell's global scratch; the sweep
//                runs on slots [n0, n0 + L) of that row, each team's two
//                rows, the newton seed bits and the masked P4's member and
//                allocation rows in the global scratch (the wrapper's
//                tensor of C x ranked_floats(K, teams, clip) floats, the
//                size the launch asks for).  The commit reads the client's
//                rank: slot r < n0 is S0, r < n_sel the sweep's, r < n_act
//                overprovision's extension.  Bitonic over one block is the
//                simplest correct sort: it needs no scratch beyond the row
//                and no second launch, and at K = 10^4 its 105 stages cost
//                less than a round's sweep of K - n0 candidates; a radix
//                sort or a cluster-wide merge is the faster alternative.
//   Why both: on the compact row's own traffic (traj_bench's K-scaling
//   cell, top-m 128, 8 cells x 8 rounds; chip_kernels.py's k3_wide and
//   k3_ranked_topm128 rows, the same bits) the ranked row took 13.15 ms
//   against the compact row's 12.15 at K = 10^4 and 37.93 against 13.99 at
//   K = 10^5, where its keys no longer fit shared memory (H100 80GB HBM3,
//   700 W, device time).
// The branches of ocean_traj.cuh, with their per-client state recomputed
// or kept in global memory instead of shared rows:
//   HasGuard    pass 1 screens each gain (quarantine, the gain floor, the
//               (K,) cap row) and demotes before forming the key; the
//               commit recomputes the same sanitized gain.  The counts are
//               block sums of integers.  The validation walks the committed
//               slots r < n_sel of the sorted order (r < n0: b0_each, else
//               the winner's row at r - n0), thread r % nt as the shared
//               instance walks them, and on a violation the bisect sweep
//               runs on the same row.  The chaos corruption as in
//               ocean_traj.cuh.  Overprovision stops at the admitted count.
//   HasFailure  ``plain``, ``reallocate`` and (ranked row) ``overprovision``.
//               Compact row: pass 1 counts the delivered S0 clients; a pass
//               over the compact slots flags the delivered winners, and the
//               masked P4 runs on the compact row with a lane offset of
//               n0 % 32 (its member and allocation rows carry 32 leading
//               slots), so that slot j sits on lane of sorted slot n0 + j
//               and the survivors' allocation has the shared instance's
//               bits.  Ranked row: as ocean_traj.cuh on the ranked slots:
//               warp 0 walks the declared rates in ranked order (32 loads
//               at a time, added left to right), the member flags sit at
//               their ranked slots and masked_waterfill starts at the
//               32-slot boundary below n0 (sorted slot r on lane r % 32),
//               and a resolved prefix's P3 cost is summed in ranked order,
//               thread r % nt.
//   HasMetrics  metrics_pass (ocean_traj.cuh) after each round, on the
//               carry in q_final / es_final; the per-cell region always
//               lives in the global scratch.  Under stream_bf16 passes 1 and
//               3 write the (C, 3, K) float32 mirror.
// The compact row's shared memory is independent of K: the key list and
// its append buffer (aliased with each team's two sweep rows, which the
// sweep writes only after the list is copied out), the compact row's keys
// and priorities, the newton seed bits and levels, a few scalars, and with
// HasFailure the masked P4's two rows of 32 + top_m floats and its grid
// scratch.  The rows' element type (float32, or bfloat16 under
// stream_bf16) is a launch argument as in ocean_traj.cuh.  Instances: the
// static or the streamed radio (HasRadio) x failure x guard x K1's, the
// bisect or the newton sweep, for each ranking.
//
// What bounds it on the H100: per cell-round it reads h2, inc and the
// carry (twice each, the second pass mostly from L2) and writes five rows
// and the carry, ~33 bytes a client in float32 (25 in bf16), and sweeps
// min(clip, K - n0) candidates.  At traj_bench's K = 10^4, 8 cells, the
// sweep's chain bounds a round as in the shared instances; at K = 10^5 the
// streaming passes of one block take most of it.  The ranked row adds its
// sort (K log2(K)^2 / 4 exchanges of 16 bytes) and under sort a sweep of
// all K - n0 candidates, O((K - n0)^2) member evaluations a round.  The
// guard adds block reductions and, on a failed validation, the bisect
// sweep; a failure mode a masked P4; the telemetry one more pass over the
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

// The ranked row.  A client's key: topm_key's, but a NaN rho (as one
// canonical NaN) above +inf, as a stable argsort ranks it; key_value gives
// the NaN back.
__device__ __forceinline__ uint64_t rank_key(float v, int i) {
  if (isnan(v)) return (0xffc00000ull << 32) | (unsigned)i;
  return topm_key(v, i);
}

// A block holds at most this many teams (1024 threads).
constexpr int kMaxTeams = 32;
// The compact row's largest clip (its key list, compact row and sweep
// rows live in shared memory; kernels/ocean_traj.py, MAX_WIDE_TOP_M).
constexpr int kMaxCompact = 2048;

// Floats of one cell's ranked-row global scratch at K clients, nteams
// teams and a sweep of at most ``list`` candidates: the keys (K uint64),
// the ranked priorities, each client's rank, the newton seed bits, the
// masked P4's member flags and allocation (K each), and each team's two
// sweep rows (2 nteams list); a multiple of 4 (16-byte cells).
__host__ __device__ inline size_t ranked_floats(int K, int nteams, int list) {
  return ((size_t)7 * K + 2 * (size_t)nteams * list + 3) & ~(size_t)3;
}

// The ranked row's global scratch: ``p`` holds ``*floats`` floats (C
// cells of ranked_floats); a launch with p null writes the floats it needs
// to *floats and launches nothing.
struct RankedScratch {
  float* p;
  long long* floats;
};

// Shared bytes of a ranked-row block: the keys and priorities where they
// live in shared memory (``in_smem``), then the argmax scratch, the newton
// grid's levels, the counters and the masked P4's grid scratch.
__host__ __device__ inline size_t ranked_smem(int K, bool in_smem) {
  return (in_smem ? 12 * (size_t)K : 0) + 4 * (64 + 16 + 4 + 32);
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

// ``cap``: the compact row's append buffer (keys); for the ranked row
// (Ranked), 1 where its keys and priorities live in shared memory.
// ``ranked``: the ranked row's global scratch, C cells of
// ranked_floats(K, nteams, n_cands).
template <bool HasRadio, bool HasFailure, bool HasGuard, int Solver, class M, bool Ranked = false>
__global__ void __maxnreg__(kMaxRegs)
    ocean_traj_wide_kernel(const TrajArgs args, int cap, const __grid_constant__ M md,
                           float* ranked) {
  constexpr bool HasMetrics = M::kOn;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = args.T, K = args.K, R = args.R, list = args.n_cands;
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, nteams = nt >> 5;
  uint64_t* s_keys;  // compact: list + cap keys, extracting; ranked: the K keys
  float* s_rows;     // 2 nteams list: each team's rows
  uint64_t* s_ck;    // compact: the list's keys
  float* s_vals;     // compact: the list's priorities; ranked: the K ranked ones
  float* s_red;      // 64
  unsigned* s_bits;  // the newton seed bits: list (compact) or K (ranked)
  float* s_lamg;     // 16
  int* s_cnt;        // 4
  // HasFailure: the masked P4's member flags and allocation (compact: slot
  // j of the compact row at kLanePad + j; ranked: slot r at r) and its grid
  // scratch.
  float *s_mem, *s_b2, *s_wf;
  int* g_rank = nullptr;  // ranked: each client's slot
  if constexpr (Ranked) {
    float* g = ranked + (size_t)c * ranked_floats(K, nteams, list);
    g_rank = reinterpret_cast<int*>(g + 3 * (size_t)K);
    s_bits = reinterpret_cast<unsigned*>(g + 4 * (size_t)K);
    s_mem = g + 5 * (size_t)K;
    s_b2 = g + 6 * (size_t)K;
    s_rows = g + 7 * (size_t)K;
    if (cap) {
      s_keys = reinterpret_cast<uint64_t*>(smem_raw);
      s_vals = reinterpret_cast<float*>(s_keys + K);
    } else {
      s_keys = reinterpret_cast<uint64_t*>(g);
      s_vals = g + 2 * (size_t)K;
    }
    s_ck = s_keys;
    s_red = reinterpret_cast<float*>(smem_raw + ranked_smem(K, cap != 0) - 4 * (64 + 16 + 4 + 32));
    s_lamg = s_red + 64;
    s_cnt = reinterpret_cast<int*>(s_lamg + 16);
    s_wf = reinterpret_cast<float*>(s_cnt + 4);
  } else {
    s_keys = reinterpret_cast<uint64_t*>(smem_raw);
    s_rows = reinterpret_cast<float*>(smem_raw);
    s_ck = reinterpret_cast<uint64_t*>(smem_raw + wide_region_a(list, nteams, cap));
    s_vals = reinterpret_cast<float*>(s_ck + list);
    s_red = s_vals + list;
    s_bits = reinterpret_cast<unsigned*>(s_red + 64);
    s_lamg = reinterpret_cast<float*>(s_bits + list);
    s_cnt = reinterpret_cast<int*>(s_lamg + 16);
    s_mem = reinterpret_cast<float*>(s_cnt + 4);
    s_b2 = s_mem + kLanePad + list;
    s_wf = s_b2 + kLanePad + list;
  }
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
    const size_t own = Ranked ? ranked_smem(K, cap != 0) : wide_smem(list, nteams, cap, HasFailure);
    const size_t base = (own + 15) & ~(size_t)15;
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
  if constexpr (HasFailure && !Ranked) {
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
    // q_pre and rho rows, n0, and the ranking's keys.  Compact row: the
    // extraction (tiles of nt clients; a merge when the next tile might not
    // fit the buffer, and after the last one).  Ranked row: every client's
    // key at its index, then the block's sort.
    if constexpr (!Ranked) {
      for (int i = tid; i < list; i += nt) s_keys[i] = kNoKey;
      if (tid == 0) *s_cnt = 0;
      __syncthreads();
    }
    uint64_t tau = kNoKey;  // the running list's last key
    float cnt = 0.f, mx = -INFINITY;
    int n_fault = 0, n_dem = 0, n_adm = 0, rho_bad = 0;  // HasGuard
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
          if constexpr (Ranked) n_adm += s.adm ? 1 : 0;
          rho_bad |= isfinite(r) ? 0 : 1;
        }
        put_row(args.qpre_out, row + i, q, bf16);
        put_row(args.rho_out, row + i, r, bf16);
        if constexpr (HasMetrics) {
          if (mirror != nullptr) mirror[i] = q;
        }
        if constexpr (Solver == kSolverGrid) mx = jmax(mx, r);
        if constexpr (Ranked) {
          cnt += r <= kRhoZeroTol ? 1.f : 0.f;
          s_keys[i] = rank_key(r, i);
        } else if (r <= kRhoZeroTol) {
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
      if constexpr (!Ranked) {
        __syncthreads();  // the tile's appends are in
        const int n = *s_cnt;
        __syncthreads();  // every thread has read n before the next append
        if (n > 0 && (base + nt >= K || n > cap - nt)) {
          if (tid == 0) *s_cnt = 0;
          bitonic_sort(s_keys, list + n);
          tau = s_keys[list - 1];
        }
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
      if constexpr (Ranked) n_adm = (int)block_sum((float)n_adm, s_red);
      rho_bad = __syncthreads_or(rho_bad);
    }
    const float* rv = s_vals;  // the sweep's priorities: slots [0, L) are its candidates
    if constexpr (Ranked) {
      // the keys are in (block_sum's barriers); the sort, then the ranked
      // priorities and each client's slot
      bitonic_sort(s_keys, K);
      for (int r = tid; r < K; r += nt) {
        const uint64_t k = s_keys[r];
        s_vals[r] = key_value(k);
        g_rank[(unsigned)k] = r;
      }
      rv = s_vals + n0;
    } else {
      for (int j = tid; j < L; j += nt) {  // the compact row, out of region A
        const uint64_t k = s_keys[j];
        s_ck[j] = k;
        s_vals[j] = key_value(k);
      }
    }
    __syncthreads();

    // 2. the sweep on the compact row, or on the ranked row's slots
    // [n0, n0 + L).
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
      prefix_sweep_bisect<32, Ranked>(rv, L, 0, L, p, args.bis_outer, args.bis_inner, s_rows,
                                      s_red, w, mf, winner);
    } else if constexpr (Solver == kSolverGrid) {
      // the seed grid uses the teams' rows as scratch before the sweep
      newton_grid_seeds<true>(rv, L, 0, L, p, args.wf_grid, args.wf_inner, args.frac, s_rows,
                              2 * nteams * L, s_bits, s_lamg, s_red, row_max);
      prefix_sweep_parallel<32, false, GridCandidate>(
          rv, L, 0, L, p, s_rows, s_red, w, mf, winner, -1, 0,
          GridCandidate{s_bits, s_lamg, args.wf_grid, args.wf_outer, args.wf_inner},
          args.mask_nonfinite != 0);
    } else {
      prefix_sweep_parallel<32>(rv, L, 0, L, p, s_rows, s_red, w, mf, winner, -1, 0,
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
          prefix_sweep_bisect<32, Ranked>(rv, L, 0, L, p, args.bis_outer, args.bis_inner,
                                          s_rows, s_red, w, mf, winner);
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
    // its S0 split; overprovision (ranked row): the extended prefix and,
    // where it grew, its masked P4
    const int n_sel = n0 + m_star;  // a candidate never passes K - n0
    int n_act = n_sel;              // ranked slots r < n_act are selected after failure_mode
    bool resolved = false;          // overprovision re-solved the extended prefix
    bool failed = false;
    float b0_2 = 0.f;
    if constexpr (HasFailure && Ranked) {
      if (args.mode == kOverprovision) {
        if (tid < 32) {
          // the smallest prefix whose declared rates sum to the plain count:
          // prefix sums in ranked order, added left to right (32 rates
          // loaded at a time, every lane adding them alike)
          const float* rate_c = args.rate + (size_t)c * K;
          const int lane = tid;
          int n_exp = 1;
          float acc = 0.f;
          bool done = false;
          for (int r0 = 0; r0 < K && !done; r0 += 32) {
            const float x = r0 + lane < K ? rate_c[(unsigned)s_keys[r0 + lane]] : 0.f;
            const int n = min(32, K - r0);
            for (int j = 0; j < n; ++j) {
              acc = acc + __shfl_sync(0xffffffffu, x, j);
              if (!(acc < (float)n_sel)) {
                done = true;
                break;
              }
              ++n_exp;
            }
          }
          if (lane == 0) {
            const float capf = floorf((float)(1.0 + 1e-9) / b_min);
            int n_max = capf >= (float)K ? K : (int)capf;
            if constexpr (HasGuard) {
              if (admits) n_max = min(n_max, n_adm);  // never into the demoted tail
            }
            const int n_ext = min(max(max(n_exp, n_sel), 0), n_max);
            s_cnt[1] = n_sel > 0 ? n_ext : 0;
          }
        }
        __syncthreads();
        n_act = s_cnt[1];
        resolved = n_act != n_sel;
      } else if (realloc) {
        int lost_r = 0;
        for (int r = tid; r < n_sel; r += nt)
          lost_r |= args.dlv[row + (unsigned)s_keys[r]] > 0.f ? 0 : 1;
        failed = __syncthreads_or(lost_r) != 0;
      }
      if (resolved || failed) {
        // member flags of the masked P4 (its positive-rho members) at their
        // ranked slots from the 32-slot boundary below n0, and the size of
        // its S0 part
        const int hi = resolved ? n_act : n_sel;  // the members lie below
        const int lo = min(n0, hi) & ~31;
        int zs_r = 0, npos = 0;
        for (int r = tid; r < hi; r += nt) {
          const bool in = resolved || args.dlv[row + (unsigned)s_keys[r]] > 0.f;
          if (r >= lo) s_mem[r] = in && r >= n0 ? 1.f : 0.f;
          zs_r += in && r < n0 ? 1 : 0;
          npos += in && r >= n0 ? 1 : 0;
        }
        const float n0_2 = block_sum((float)zs_r, s_red);  // integers: exact
        const float npf = block_sum((float)npos, s_red);
        const float delta2 = 1.f - n0_2 * b_min;
        masked_waterfill<32>(s_vals + lo, s_mem + lo, hi - lo, delta2, beta, b_min, args.wf_outer,
                             args.wf_inner, args.wf_grid, args.frac, s_b2 + lo, s_wf);
        const float left2 = npf == 0.f ? delta2 : 0.f;
        b0_2 = b_min + left2 / jmax(n0_2, 1.f);
      }
    } else if constexpr (HasFailure) {
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
      bool in_s0, a;
      float b;
      int j = -1;  // the client's compact slot, if it won
      int r = 0;   // ranked: the client's slot
      if constexpr (Ranked) {
        r = g_rank[k];
        in_s0 = r < n0;
        a = r < n_sel;
        b = a ? (in_s0 ? b0_each : (scaled ? best[r - n0] * args.chaos_scale : best[r - n0]))
              : 0.f;
      } else {
        in_s0 = s.r <= kRhoZeroTol;
        a = in_s0;
        b = in_s0 ? b0_each : 0.f;
        if (!a && m_star > 0) {
          const uint64_t key = topm_key(s.r, k);
          const int lb = lower_bound(s_ck, m_star, key);
          if (lb < m_star && s_ck[lb] == key) {
            a = true;
            j = lb;
            b = scaled ? best[j] * args.chaos_scale : best[j];
          }
        }
      }
      float e = energy_of(b, s.h, beta, scale) * (a ? 1.f : 0.f);
      if constexpr (HasFailure) {
        const bool ok = args.dlv[row + k] > 0.f;
        if constexpr (Ranked) {
          // the member flags are read at slots r >= n0 only (this round's,
          // below the members' bound)
          if (resolved) {
            // the extended prefix's allocation (repro/core/ocean.py:389-394)
            a = r < n_act;
            b = a ? (!in_s0 && s_mem[r] > 0.f ? s_b2[r] : (in_s0 ? b0_2 : 0.f)) : 0.f;
            e = energy_of(b, s.h, beta, scale) * (a ? 1.f : 0.f);
          } else if (failed) {
            // half the committed round, half the survivors' re-solved one
            const bool surv = a && ok;
            const float b2 =
                surv ? (!in_s0 && s_mem[r] > 0.f ? s_b2[r] : (in_s0 ? b0_2 : 0.f)) : 0.f;
            const float e2 = energy_of(b2, s.h, beta, scale) * (surv ? 1.f : 0.f);
            e = 0.5f * e + 0.5f * e2;
          }
        } else if (failed) {
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
    float obj = w;
    if constexpr (HasFailure && Ranked) {
      if (resolved) {
        // the extended prefix's P3 value (repro/core/ocean.py:395-397): its
        // cost summed in ranked order, slot r by thread r % nt, as the
        // shared instance sums it
        float cost = 0.f;
        for (int r = tid; r < n_act; r += nt) {
          const bool s0 = r < n0;
          const float b = !s0 && s_mem[r] > 0.f ? s_b2[r] : (s0 ? b0_2 : 0.f);
          cost += s_vals[r] * f_shannon(jmax(b, b_min), beta);
        }
        obj = p.v_eta * (float)n_act - scale * block_sum(cost, s_red);
      }
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

template <bool HasRadio, bool HasFailure, bool HasGuard, int Solver, class M, bool Ranked = false>
const void* wide_fn() {
  return (const void*)ocean_traj_wide_kernel<HasRadio, HasFailure, HasGuard, Solver, M, Ranked>;
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

// A ranked-row block: as many warps as the registers allow (its rows are
// global), and whether its K keys and priorities fit shared memory beside
// ``extra`` bytes.
inline int ranked_teams(const void* fn) { return threads_for(fn, 1024, 1024) / 32; }
inline bool ranked_in_smem(int K, size_t extra) {
  return ranked_smem(K, true) + extra <= (size_t)smem_optin();
}

template <bool HasRadio, bool HasFailure, bool HasGuard, int Solver, class M, bool Ranked>
int launch_wide(const TrajArgs& args, const M& md, int C, cudaStream_t stream,
                const RankedScratch* rs) {
  const void* fn = wide_fn<HasRadio, HasFailure, HasGuard, Solver, M, Ranked>();
  const size_t extra = wide_extra(md);
  int nteams, cap;
  size_t smem;
  float* ranked = nullptr;
  if constexpr (Ranked) {
    nteams = ranked_teams(fn);
    const long long need = (long long)C * (long long)ranked_floats(args.K, nteams, args.n_cands);
    if (rs->p == nullptr) {
      *rs->floats = need;
      return 0;
    }
    if (*rs->floats < need) return (int)cudaErrorInvalidValue;
    ranked = rs->p;
    cap = ranked_in_smem(args.K, extra) ? 1 : 0;
    smem = ranked_smem(args.K, cap != 0) + extra;
  } else {
    nteams = wide_teams(fn, args.n_cands, HasFailure, extra);
    cap = 64 * nteams;
    smem = wide_smem(args.n_cands, nteams, cap, HasFailure) + extra;
  }
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return (int)err;
  ocean_traj_wide_kernel<HasRadio, HasFailure, HasGuard, Solver, M, Ranked>
      <<<C, 32 * nteams, smem, stream>>>(args, cap, md, ranked);
  return (int)cudaGetLastError();
}

template <class M, bool Ranked, bool HasRadio, bool HasFailure, bool HasGuard>
int wide_by_solver(int solver, const TrajArgs& args, const M& md, int C, cudaStream_t stream,
                   const RankedScratch* rs) {
  switch (solver) {
    case kSolverK1:
      return launch_wide<HasRadio, HasFailure, HasGuard, kSolverK1, M, Ranked>(args, md, C,
                                                                              stream, rs);
    case kSolverBisect:
      return launch_wide<HasRadio, HasFailure, HasGuard, kSolverBisect, M, Ranked>(args, md, C,
                                                                                  stream, rs);
    case kSolverGrid:
      return launch_wide<HasRadio, HasFailure, HasGuard, kSolverGrid, M, Ranked>(args, md, C,
                                                                                stream, rs);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class M, bool Ranked, bool HasRadio, bool HasFailure>
int wide_by_guard(int solver, const TrajArgs& args, const M& md, int C, cudaStream_t stream,
                  bool guard, const RankedScratch* rs) {
  return guard
             ? wide_by_solver<M, Ranked, HasRadio, HasFailure, true>(solver, args, md, C, stream,
                                                                     rs)
             : wide_by_solver<M, Ranked, HasRadio, HasFailure, false>(solver, args, md, C, stream,
                                                                      rs);
}

// Every wide instance of one library (the compact row's, or with Ranked
// the ranked row's, whose global scratch is ``rs``): the radio,
// failure and guard branches as the launch's arguments select them (dlv
// and r_bmin non-null, ``guard``), the sweep by ``solver``.  Refuses an
// empty clip; the compact row refuses ranking="sort", a clip past 2048
// and failure_mode overprovision, the ranked row a scratch without a size.
template <class M, bool Ranked = false>
int launch_wide_all(int solver, const TrajArgs& args, const M& md, int C, cudaStream_t stream,
                    bool guard, const RankedScratch* rs = nullptr) {
  const bool radio = args.r_bmin != nullptr, failure = args.dlv != nullptr;
  if (args.n_cands < 1) return (int)cudaErrorInvalidValue;
  if (Ranked ? rs == nullptr || rs->floats == nullptr
             : (args.topm == 0 || args.n_cands > kMaxCompact ||
                (failure && args.mode == kOverprovision)))
    return (int)cudaErrorInvalidValue;
  if (radio && failure)
    return wide_by_guard<M, Ranked, true, true>(solver, args, md, C, stream, guard, rs);
  if (radio) return wide_by_guard<M, Ranked, true, false>(solver, args, md, C, stream, guard, rs);
  if (failure)
    return wide_by_guard<M, Ranked, false, true>(solver, args, md, C, stream, guard, rs);
  return wide_by_guard<M, Ranked, false, false>(solver, args, md, C, stream, guard, rs);
}

}  // namespace
