// K3 ocean_traj's wide instances: ranking="topm" past the shared-memory
// sort's K <= 2048 (kernels/ocean_traj.py, MAX_CLIENTS), with no per-client
// row in shared memory.
//
// Replaces the same TPU kernel as ocean_traj.cuh (repro/kernels/
// ocean_traj.py:96 ``_traj_kernel``, pallas_call at :532), which has no
// limit on K: it cuts its chunk of rounds down for large K
// (CHUNK_ELEM_BUDGET, :83-87, :398-400).  One block per cell runs all T
// rounds.  The carry (the queues and the spent energy) lives in the
// q_final / es_final outputs, which only the cell's block touches, seeded
// from q0 / es0 on a segment launch; each client is handled by the same
// thread in every pass, so no barrier guards the carry.  Each round:
//   1. a streaming pass over the cell's K clients: the frame reset, rho =
//      q / max(h2, 1e-30), the q_pre and rho rows, n0 (rho <= 1e-30, a
//      block sum of integers: exact in any order), and the top-m
//      extraction of the positive rho: K2's phase 1 with one CTA
//      (ocean_p.cu): keys below the running top_m-th key are appended to a
//      buffer that bitonic_sort merges into the sorted running list.  With
//      one CTA the list positions are the ranks, so the list's first
//      min(top_m, K - n0) keys are the compact row, in topm_extract's order
//      ((rho, client index), ties to the lower index).
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
// Shared memory is independent of K: the key list and its append buffer
// (aliased with each team's two sweep rows, which the sweep writes only
// after the list is copied out), the compact row's keys and priorities,
// the newton seed bits and levels, and a few scalars.  The rows' element
// type (float32, or bfloat16 under stream_bf16) is a launch argument as in
// ocean_traj.cuh.  Instances: the static or the streamed radio (HasRadio)
// x K1's, the bisect or the newton sweep.  No failure, guard or metrics
// branch: those need the full ranked row or per-client shared rows, and
// stay at K <= 2048.
//
// What bounds it on the H100: per cell-round it reads h2, inc and the
// carry (twice each, the second pass mostly from L2) and writes five rows
// and the carry, ~33 bytes a client in float32 (25 in bf16), and sweeps
// min(top_m, K - n0) candidates.  At traj_bench's K = 10^4, 8 cells, the
// sweep's chain bounds a round as in the shared instances; at K = 10^5 the
// streaming passes of one block take most of it.  A block per cell leaves
// most SMs idle at 1-8 cells: a cluster per cell (as K2's) is the redesign
// that answers it.
#include "ocean_traj.cuh"

namespace {

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
// newton seed bits and levels, and the append counter.
__host__ __device__ inline size_t wide_region_a(int list, int nteams, int cap) {
  const size_t keys = 8 * ((size_t)list + cap);
  const size_t rows = 4 * 2 * (size_t)nteams * list;
  return keys > rows ? keys : rows;
}
__host__ __device__ inline size_t wide_smem(int list, int nteams, int cap) {
  return wide_region_a(list, nteams, cap) + 12 * (size_t)list +
         4 * (64 + (size_t)list + 16 + 4);
}

template <bool HasRadio, int Solver>
__global__ void __maxnreg__(kMaxRegs) ocean_traj_wide_kernel(const TrajArgs args, int cap) {
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
  int* s_cnt = reinterpret_cast<int*>(s_lamg + 16);              // 1
  const int t0 = args.t0 != nullptr ? args.t0[c] : 0;  // the first global round
  const bool bf16 = args.bf16 != 0;
  float* q_c = args.q_final + (size_t)c * K;  // the carry
  float* es_c = args.es_final + (size_t)c * K;
  for (int i = tid; i < K; i += nt) {
    q_c[i] = args.q0 != nullptr ? args.q0[(size_t)c * K + i] : 0.f;
    es_c[i] = args.es0 != nullptr ? args.es0[(size_t)c * K + i] : 0.f;
  }

  for (int t = 0; t < T; ++t) {
    const size_t ct = (size_t)c * T + t;
    const size_t row = ct * K;
    const float* h2_t = args.h2 + row;
    const int tg = t0 + t;  // the global round: frame resets
    const bool reset = tg > 0 && (tg % R) == 0;
    float b_min = args.b_min, beta = args.beta, scale = args.scale;
    if constexpr (HasRadio) {
      b_min = args.r_bmin[ct];
      beta = args.r_beta[ct];
      scale = args.r_scale[ct];
    }

    // 1. the streaming pass: reset, priorities, the q_pre and rho rows,
    // n0, and the extraction (tiles of nt clients; a merge when the next
    // tile might not fit the buffer, and after the last one).
    for (int i = tid; i < list; i += nt) s_keys[i] = kNoKey;
    if (tid == 0) *s_cnt = 0;
    __syncthreads();
    uint64_t tau = kNoKey;  // the running list's last key
    float cnt = 0.f, mx = -INFINITY;
    for (int base = 0; base < K; base += nt) {
      const int i = base + tid;
      if (i < K) {
        const float q = reset ? 0.f : q_c[i];
        if (reset) q_c[i] = q;
        const float r = q / jmax(h2_t[i], kSafeDivFloor);
        put_row(args.qpre_out, row + i, q, bf16);
        put_row(args.rho_out, row + i, r, bf16);
        if constexpr (Solver == kSolverGrid) mx = jmax(mx, r);
        if (r <= kRhoZeroTol) {
          cnt += 1.f;
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
    const int m_star = (int)rintf(mf);
    const float* best = s_rows + (2 * (size_t)winner + 1) * L;
    const float leftover = m_star == 0 ? p.delta : 0.f;
    const float b0_each = b_min + leftover / jmax(n0f, 1.f);

    // 3. the commit in client order, then the queues.
    const float* inc_t = args.inc + row;
    for (int k = tid; k < K; k += nt) {
      const float q = q_c[k];
      const float h = h2_t[k];
      const float r = q / jmax(h, kSafeDivFloor);  // pass 1's rho, bit for bit
      bool a = r <= kRhoZeroTol;
      float b = a ? b0_each : 0.f;
      if (!a && m_star > 0) {
        const uint64_t key = topm_key(r, k);
        const int j = lower_bound(s_ck, m_star, key);
        if (j < m_star && s_ck[j] == key) {
          a = true;
          b = best[j];
        }
      }
      const float e = energy_of(b, h, beta, scale) * (a ? 1.f : 0.f);
      args.a_out[row + k] = a ? 1 : 0;
      put_row(args.b_out, row + k, b, bf16);
      put_row(args.e_out, row + k, e, bf16);
      q_c[k] = jmax(q + e - inc_t[k], 0.f);
      es_c[k] = es_c[k] + e;
    }
    if (tid == 0) {
      args.obj_out[ct] = w;
      args.nsel_out[ct] = n0 + m_star;  // a candidate never passes K - n0
    }
    __syncthreads();  // the winners' rows are read before the next list overwrites them
  }
}

template <bool HasRadio, int Solver>
const void* wide_fn() {
  return (const void*)ocean_traj_wide_kernel<HasRadio, Solver>;
}

// Teams of a wide block: as many warps as the registers allow (every
// thread streams clients), fewer until the shared rows of a clip of
// ``list`` candidates fit the card's per-block limit; the append buffer
// holds two tiles.
inline int wide_teams(const void* fn, int list) {
  int nteams = threads_for(fn, 1024, 1024) / 32;
  const size_t optin = (size_t)smem_optin();
  while (nteams > 1 && wide_smem(list, nteams, 64 * nteams) > optin) --nteams;
  return nteams;
}

template <bool HasRadio, int Solver>
int launch_wide(const TrajArgs& args, int C, cudaStream_t stream) {
  const void* fn = wide_fn<HasRadio, Solver>();
  const int nteams = wide_teams(fn, args.n_cands);
  const int cap = 64 * nteams;
  const size_t smem = wide_smem(args.n_cands, nteams, cap);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return (int)err;
  ocean_traj_wide_kernel<HasRadio, Solver><<<C, 32 * nteams, smem, stream>>>(args, cap);
  return (int)cudaGetLastError();
}

template <bool HasRadio>
int launch_wide_solver(int solver, const TrajArgs& args, int C, cudaStream_t stream) {
  switch (solver) {
    case kSolverK1: return launch_wide<HasRadio, kSolverK1>(args, C, stream);
    case kSolverBisect: return launch_wide<HasRadio, kSolverBisect>(args, C, stream);
    case kSolverGrid: return launch_wide<HasRadio, kSolverGrid>(args, C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The warps a wide block runs at a clip of n_cands candidates (the
// static radio; ``solver`` as the launch numbers it).
extern "C" int ocean_traj_wide_warps(int n_cands, int solver) {
  switch (solver) {
    case kSolverK1: return wide_teams(wide_fn<false, kSolverK1>(), n_cands);
    case kSolverBisect: return wide_teams(wide_fn<false, kSolverBisect>(), n_cands);
    case kSolverGrid: return wide_teams(wide_fn<false, kSolverGrid>(), n_cands);
    default: return 0;
  }
}

// One launch: every cell's T rounds under ranking="topm" at any K
// (OCEAN_TRAJ_PARAMS in ocean_traj.cuh; n_cands = min(top_m, K) is the
// list's length).  Refuses the failure, guard and metrics branches.
extern "C" int ocean_traj_wide_launch(OCEAN_TRAJ_PARAMS, void* stream) {
  if (dlv != nullptr || guarded != 0 || topm == 0 || n_cands < 1 || mirror != nullptr)
    return (int)cudaErrorInvalidValue;
  const TrajArgs args = OCEAN_TRAJ_ARGS;
  if (r_bmin != nullptr) return launch_wide_solver<true>(solver, args, C, (cudaStream_t)stream);
  return launch_wide_solver<false>(solver, args, C, (cudaStream_t)stream);
}
