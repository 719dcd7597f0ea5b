// Shared device code of the OCEAN kernels (K1 ocean_p_prefix, K2 ocean_p_topm,
// K3 ocean_traj): the Shannon-inversion math, the safeguarded Newton
// waterfilling of one P4 candidate, the double bisection of one P4
// candidate (the ``bisect`` solver, K3 only), the ``newton`` solver's
// grid-seeded candidate and masked P4 (K3 only), the candidate-parallel
// K+1-prefix sweep over any of them (a warp or half warp per candidate; K1,
// K2, K3), and the top-m extraction's keys, block sort and search (K2 and
// K3's wide instances).
//
// The math follows the reference line for line:
//   f, f', f''            repro/core/energy.py:128-151
//   b_of_lam_newton       repro/core/solvers.py:265
//   the outer Newton step repro/kernels/ocean_p.py:95-111
//   _budget_repair        repro/core/solvers.py:335
//   _outer_newton_polish  repro/core/solvers.py:351
//   _prefix_newton        repro/core/solvers.py:458 (its seed grid)
//   solve_p4 (bisection)  repro/core/bandwidth.py:53-130
// Elementwise, each kernel computes what its plain PyTorch version does op
// for op (no FMA contraction, exp2 rounded from double); the two differ
// only in the order of team sums.
//
// Layout: a team of NT lanes (a warp, or a half warp) evaluates one
// candidate; a block, or for K2 a cluster of blocks, holds a cell's teams.
// Every team-uniform scalar (lam, its bracket, the running argmax) is
// computed redundantly by all of the team's lanes from shuffle reductions
// whose results every lane reads, so all branches around the team's
// __syncwarp() are uniform.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ocean {

constexpr float kExp2Clip = 80.f;
constexpr float kSafeDivFloor = 1e-30f;
constexpr float kNegInf = -1e30f;        // NEG_INF of repro/kernels/ocean_p.py:41
constexpr float kRhoZeroTol = 1e-30f;    // _RHO_ZERO_TOL (S0 membership)
// ln 2 rounded once to float: the value of logf(2.f) on the host and of
// jnp.log(2.0), written out so no device logf rounding can enter.
constexpr float kLn2 = 0.69314718055994530942f;

// NaN-propagating max/min/clip, as jnp.maximum/minimum/clip behave.
__device__ __forceinline__ float jmax(float a, float b) {
  return isnan(a) ? a : (a > b ? a : b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return isnan(a) ? a : (a < b ? a : b);
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

// 2^y with y clipped to +-80, correctly rounded to float through double:
// the value the plain versions compute (repro_torch.core.energy.exp2), so
// that no ulp of exp2f can steer a Newton step onto another branch.
__device__ __forceinline__ float exp2_clipped(float y) {
  return (float)exp2((double)jclip(y, -kExp2Clip, kExp2Clip));
}

// f(b) = b (2^{beta/b} - 1)
__device__ __forceinline__ float f_shannon(float b, float beta) {
  const float sb = jmax(b, kSafeDivFloor);
  return sb * (exp2_clipped(beta / sb) - 1.f);
}

// f'(b) = 2^{beta/b} (1 - ln2 beta/b) - 1
__device__ __forceinline__ float f_prime(float b, float beta) {
  const float sb = jmax(b, kSafeDivFloor);
  const float y = beta / sb;
  return exp2_clipped(y) * (1.f - kLn2 * y) - 1.f;
}

// f''(b) = ln2^2 2^{beta/b} beta^2 / b^3, with b^3 written b*b*b
__device__ __forceinline__ float f_second(float b, float beta) {
  const float sb = jmax(b, kSafeDivFloor);
  const float p = exp2_clipped(beta / sb);
  return (kLn2 * kLn2) * p * (beta * beta) / (sb * sb * sb);
}

// Solve rho f'(b) = -lam, clamped to [b_min, b_max]: closed-form seed,
// bracketed Newton, boundary roots detected analytically.
__device__ float b_of_lam(float lam, float rho, float beta, float b_min,
                          float b_max, int iters) {
  const float rs = jmax(rho, 1e-30f);
  const float t = -lam / rs;
  const float u = lam / rs;
  const float y_small = sqrtf(2.f * u) / kLn2;
  const float y_log = log2f(1.f + u);
  const float y_big =
      log2f(jmax(u - 1.f, 1e-12f) / jmax(kLn2 * y_log - 1.f, 1e-12f));
  const float y0 = jmax(u > 2.f ? y_big : y_small, 1e-12f);
  float b = jclip(beta / y0, b_min, b_max);
  float lo = b_min, hi = b_max;
  const bool at_min = f_prime(lo, beta) >= t;
  const bool at_max = f_prime(hi, beta) <= t;
  for (int i = 0; i < iters; ++i) {
    // f'(b) and f''(b) of f_prime / f_second, op for op, sharing their one
    // 2^{beta/b}: the same pure function of the same argument.
    const float sb = jmax(b, kSafeDivFloor);
    const float y = beta / sb;
    const float p2 = exp2_clipped(y);
    const float g = (p2 * (1.f - kLn2 * y) - 1.f) - t;
    const float fs = (kLn2 * kLn2) * p2 * (beta * beta) / (sb * sb * sb);
    const bool below = g < 0.f;
    lo = below ? b : lo;
    hi = below ? hi : b;
    const float bn = b - g / jmax(fs, 1e-30f);
    const bool ok = (bn >= lo) && (bn <= hi) && isfinite(bn);
    b = ok ? bn : 0.5f * (lo + hi);
  }
  b = jclip(b, b_min, b_max);
  if (at_min) b = b_min;
  if (at_max) b = b_max;
  return b;
}

// ---------------------------------------------------------------------------
// The top-m extraction's keys (K2, and K3's wide instances): a client's
// sort key is the order-preserving bits of rho (NaN as +inf, as the
// extraction never picks a NaN; -0 as +0) above its index, so keys order
// as (rho, index) pairs do and ties go to the lower index.
// ---------------------------------------------------------------------------
constexpr uint64_t kNoKey = ~0ull;  // above every client's key

__device__ __forceinline__ uint64_t topm_key(float v, int i) {
  if (isnan(v)) v = INFINITY;
  if (v == 0.f) v = 0.f;
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | (unsigned)i;
}

__device__ __forceinline__ float key_value(uint64_t k) {
  const unsigned u = (unsigned)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Sorts keys[0, n) ascending in place with the block: a bitonic network
// over the next power of two, whose slots past n hold kNoKey implicitly
// (a compare-exchange with such a slot never moves anything, since every
// exchange puts the smaller key at the lower index).  Callers make
// keys[0, n) visible to the block first; it ends with a barrier.
__device__ void bitonic_sort(uint64_t* keys, int n) {
  int np = 1;
  while (np < n) np <<= 1;
  for (int k = 2; k <= np; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (np >> 1); t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // bit j clear
        const int pr = j == (k >> 1) ? (i ^ (k - 1)) : (i | j);
        if (pr < n) {
          const uint64_t a = keys[i], b = keys[pr];
          if (b < a) {
            keys[i] = b;
            keys[pr] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Keys of list[0, n) (ascending) below ``key``.
__device__ __forceinline__ int lower_bound(const uint64_t* list, int n, uint64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// Warp reductions: the butterfly leaves the identical value in every lane
// (float + is commutative).
// ---------------------------------------------------------------------------
struct Sum { __device__ static float op(float a, float b) { return a + b; } };
struct Max { __device__ static float op(float a, float b) { return jmax(a, b); } };
struct Min { __device__ static float op(float a, float b) { return jmin(a, b); } };

template <class Op>
__device__ __forceinline__ float warp_all(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = Op::op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Teams.  A team evaluates one candidate: its threads stride over the
// candidate's members from ``tid`` by ``nt`` and reduce with ``all`` /
// ``sum2``.
// ---------------------------------------------------------------------------
// A team of NT lanes of one warp (NT = 32: the warp; NT = 16: a half
// warp, two teams to a warp).  Its butterfly leaves out the xor steps of
// 16 and up; at K <= 16 a 32-lane butterfly's step 16 adds the identity
// to every lane of a member-holding half (0 to a sum, 0 to a max of
// rho >= 0, +inf to a min), so both give the same bits.
template <int NT>
struct LaneTeam {
  int tid, nt;
  unsigned mask;
  __device__ LaneTeam()
      : tid(threadIdx.x & (NT - 1)), nt(NT),
        mask((0xffffffffu >> (32 - NT)) << (threadIdx.x & 31 & ~(NT - 1))) {}
  template <class Op>
  __device__ float all(float v) const {
#pragma unroll
    for (int o = NT / 2; o > 0; o >>= 1) v = Op::op(v, __shfl_xor_sync(mask, v, o));
    return v;
  }
  __device__ float2 sum2(float a, float b) const {
    return make_float2(all<Sum>(a), all<Sum>(b));
  }
};

// ---------------------------------------------------------------------------
// One candidate m of P3 (Theorem 1): the safeguarded-Newton waterfilling of
// its members, the exact budget repair, and its objective W.
//
//   rho[0, L)      the ranked priorities (shared memory)
//   start          first slot of the positive-rho region: candidate m owns
//                  slots [start, start + m)
//   n0f, kf        |S0| and K: W = V eta (n0 + m) - scale cost; m <= K - n0
//   b              the team's row of L floats; ends as the allocation of
//                  slots [start, start + m), each written and read by the
//                  thread that owns it ((i - start) % nt == tid)
// Returns false, computing nothing, for a candidate whose W the reference
// would set to NEG_INF: an infeasible m, or a member with rho = +inf (whose
// cost is +inf or NaN).  Both conditions are monotone in m.
// ---------------------------------------------------------------------------
struct SweepParams {
  float n0f, kf, delta, v_eta, beta, b_min, scale;
  int outer, inner;
};

// The exact budget repair of a candidate's allocation b[lo_i, hi_i), whose
// team sum before it is ``sb`` (_budget_repair), and the candidate's cost
// sum rho f(max(b, b_min)).
template <class Team>
__device__ __forceinline__ float repair_cost(const Team& tm, const float* rho, int lo_i, int hi_i,
                                             float sb, float b_max, const SweepParams& p,
                                             float* b) {
  const float s = tm.template all<Sum>(sb);
  float hr = 0.f, sl = 0.f;
  for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) {
    hr += jmax(b_max - b[i], 0.f);
    sl += jmax(b[i] - p.b_min, 0.f);
  }
  const float2 hs = tm.sum2(hr, sl);
  const float residual = p.delta - s;
  const float hden = jmax(hs.x, 1e-30f), sden = jmax(hs.y, 1e-30f);
  float cs = 0.f;
  for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) {
    float bi = b[i];
    bi = residual >= 0.f ? bi + residual * (jmax(b_max - bi, 0.f) / hden)
                         : bi + residual * (jmax(bi - p.b_min, 0.f) / sden);
    bi = jclip(bi, p.b_min, b_max);
    b[i] = bi;
    cs += rho[i] * f_shannon(jmax(bi, p.b_min), p.beta);
  }
  return tm.template all<Sum>(cs);
}

template <class Team>
__device__ bool candidate_w(const Team& tm, const float* rho, int L, int start, int m,
                            const SweepParams& p, float fp_min, float* b, float& w_out) {
  const float mf = (float)m;
  if (!(mf <= p.kf - p.n0f) || start + m > L) return false;
  const int lo_i = start, hi_i = start + m;
  const float b_max = jmax(p.delta - jmax(mf - 1.f, 0.f) * p.b_min, p.b_min);

  float mx = 0.f, mn = INFINITY;
  for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) {
    mx = jmax(mx, rho[i]);
    mn = jmin(mn, rho[i]);
  }
  const float rho_max = tm.template all<Max>(mx);
  if (!isfinite(rho_max)) return false;
  float rho_min = tm.template all<Min>(mn);
  rho_min = isfinite(rho_min) ? rho_min : 0.f;

  const float lam_hi = rho_max * fp_min * 1.000001f + 1e-30f;
  const float b_eq = jclip(p.delta / jmax(mf, 1.f), p.b_min, b_max);
  float lam = jclip(sqrtf(jmax(rho_min * rho_max, 1e-30f)) *
                        jmax(-f_prime(b_eq, p.beta), 1e-30f),
                    0.f, lam_hi);
  float lo = 0.f, hi = lam_hi;

  for (int it = 0; it < p.outer; ++it) {
    float rs = 0.f, ds = 0.f;
    for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) {
      const float bi = b_of_lam(lam, rho[i], p.beta, p.b_min, b_max, p.inner);
      rs += bi;
      if (bi > p.b_min && bi < b_max)
        ds += -1.f / (jmax(rho[i], 1e-30f) * jmax(f_second(bi, p.beta), 1e-30f));
    }
    const float2 s = tm.sum2(rs, ds);
    const float r = s.x - p.delta;
    const bool too_big = r > 0.f;
    lo = too_big ? lam : lo;
    hi = too_big ? hi : lam;
    const float lam_n = lam - r / jmin(s.y, -1e-30f);
    const bool ok = (lam_n >= lo) && (lam_n <= hi) && isfinite(lam_n);
    lam = ok ? lam_n : sqrtf(jmax(lo, 1e-6f * hi) * jmax(hi, 1e-30f));
  }

  // Final allocation and the exact budget repair.
  float sb = 0.f;
  for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) {
    const float bi = b_of_lam(lam, rho[i], p.beta, p.b_min, b_max, p.inner);
    b[i] = bi;
    sb += bi;
  }
  w_out = p.v_eta * (p.n0f + mf) - p.scale * repair_cost(tm, rho, lo_i, hi_i, sb, b_max, p, b);
  return true;
}

// ---------------------------------------------------------------------------
// The ``bisect`` solver's candidate (the port's bandwidth.solve_p4 on one
// prefix mask, op for op): b(lam) by ``inner`` halvings of [b_min, b_max]
// on f', lam by ``outer`` halvings of [0, lam_hi] on the budget residual,
// then the same repair and cost as candidate_w.  Same contract as
// candidate_w; a member with rho = +inf masks the candidate (the plain
// version's W there is -inf).  A member with a NaN rho masks it too, but
// with ``NanRho`` (K3's ranked row, where a stable argsort puts a NaN
// last, as the plain version ranks it) the candidate is evaluated: its W
// is NaN, as the plain version's, and wins its sweep (BisectCandidate's
// kNanWins).
// ---------------------------------------------------------------------------
__device__ float b_of_lam_bisect(float lam, float rho, float beta, float b_min, float b_max,
                                 int iters) {
  const float target = -lam / jmax(rho, 1e-30f);
  float lo = b_min, hi = b_max;
  for (int i = 0; i < iters; ++i) {
    const float mid = 0.5f * (lo + hi);
    const bool below = f_prime(mid, beta) < target;
    lo = below ? mid : lo;
    hi = below ? hi : mid;
  }
  return 0.5f * (lo + hi);
}

template <class Team, bool NanRho = false>
__device__ bool candidate_w_bisect(const Team& tm, const float* rho, int L, int start, int m,
                                   const SweepParams& p, float fp_min, int outer, int inner,
                                   float* b, float& w_out) {
  const float mf = (float)m;
  if (!(mf <= p.kf - p.n0f) || start + m > L) return false;
  const int lo_i = start, hi_i = start + m;
  const float b_max = jmax(p.delta - (mf - 1.f) * p.b_min, p.b_min);
  float mx = 0.f;
  for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) mx = jmax(mx, rho[i]);
  const float rho_max = tm.template all<Max>(mx);
  if (NanRho ? rho_max == INFINITY : !isfinite(rho_max)) return false;
  const float lam_hi = rho_max * fp_min * 1.000001f + 1e-30f;
  float lo = 0.f, hi = lam_hi;
  for (int it = 0; it < outer; ++it) {
    const float mid = 0.5f * (lo + hi);
    float s = 0.f;
    for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt)
      s += b_of_lam_bisect(mid, rho[i], p.beta, p.b_min, b_max, inner);
    const bool too_big = tm.template all<Sum>(s) > p.delta;
    lo = too_big ? mid : lo;
    hi = too_big ? hi : mid;
  }
  const float lam = 0.5f * (lo + hi);
  float sb = 0.f;
  for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) {
    const float bi = b_of_lam_bisect(lam, rho[i], p.beta, p.b_min, b_max, inner);
    b[i] = bi;
    sb += bi;
  }
  w_out = p.v_eta * (p.n0f + mf) - p.scale * repair_cost(tm, rho, lo_i, hi_i, sb, b_max, p, b);
  return true;
}

// What a sweep evaluates per candidate: K1's safeguarded Newton (the
// default), or the bisect solver's double bisection.  ``kNanWins``: the
// solver's plain version picks its winner with torch.argmax (as the
// reference's jnp.argmax), where the first NaN W wins; K1's never picks one.
struct NewtonCandidate {
  static constexpr bool kNanWins = false;
  template <class Team>
  __device__ bool operator()(const Team& tm, const float* rho, int L, int start, int m,
                             const SweepParams& p, float fp_min, float* b, float& w) const {
    return candidate_w(tm, rho, L, start, m, p, fp_min, b, w);
  }
};

template <bool NanRho = false>
struct BisectCandidate {
  static constexpr bool kNanWins = true;
  int outer, inner;
  template <class Team>
  __device__ bool operator()(const Team& tm, const float* rho, int L, int start, int m,
                             const SweepParams& p, float fp_min, float* b, float& w) const {
    return candidate_w_bisect<Team, NanRho>(tm, rho, L, start, m, p, fp_min, outer, inner, b,
                                            w);
  }
};

// ---------------------------------------------------------------------------
// The ``newton`` solver's pieces (repro/core/solvers.py), shared by the masked
// P4 (waterfill_newton) and the newton solver's prefix candidates
// (_prefix_newton): the members of a solve are the slots i of [lo_i, hi_i)
// for which ``in(i)`` holds.
// ---------------------------------------------------------------------------
struct AllSlots {
  __device__ bool operator()(int) const { return true; }
};
struct Flagged {
  const float* member;
  __device__ bool operator()(int i) const { return member[i] > 0.f; }
};

// _outer_newton_polish: ``outer`` safeguarded Newton steps on the budget
// residual from (lam, lo, hi), then the members' final allocation b(lam)
// into b (0 at the other slots); returns the lane's part of its sum.
template <class Team, class In>
__device__ __forceinline__ float newton_polish(const Team& tm, const float* rho, int lo_i,
                                               int hi_i, In in, float delta, float beta,
                                               float b_min, float b_max, int outer, int inner,
                                               float lam, float lo, float hi, float* b) {
  for (int it = 0; it < outer; ++it) {
    float rs = 0.f, ds = 0.f;
    for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) {
      if (!in(i)) continue;
      const float bi = b_of_lam(lam, rho[i], beta, b_min, b_max, inner);
      rs += bi;
      if (bi > b_min && bi < b_max)
        ds += -1.f / (jmax(rho[i], 1e-30f) * jmax(f_second(bi, beta), 1e-30f));
    }
    const float2 sd = tm.sum2(rs, ds);
    const float r = sd.x - delta;
    const bool too_big = r > 0.f;
    lo = too_big ? lam : lo;
    hi = too_big ? hi : lam;
    const float lam_n = lam - r / jmin(sd.y, -1e-30f);
    const bool ok = (lam_n >= lo) && (lam_n <= hi) && isfinite(lam_n);
    lam = ok ? lam_n : sqrtf(jmax(lo, 1e-6f * hi) * jmax(hi, 1e-30f));
  }
  float sb = 0.f;
  for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) {
    const float bi = in(i) ? b_of_lam(lam, rho[i], beta, b_min, b_max, inner) : 0.f;
    b[i] = bi;
    sb += bi;
  }
  return sb;
}

// _budget_repair of the members' allocation b, whose team sum before it is
// ``sb`` (0 at the other slots); WithCost: returns the team's cost sum
// rho f(max(b, b_min)), as a candidate's W needs.
template <bool WithCost, class Team, class In>
__device__ __forceinline__ float budget_repair(const Team& tm, const float* rho, int lo_i,
                                               int hi_i, In in, float sb, float delta,
                                               float beta, float b_min, float b_max, float* b) {
  const float s = tm.template all<Sum>(sb);
  float hr = 0.f, sl = 0.f;
  for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) {
    if (!in(i)) continue;
    hr += jmax(b_max - b[i], 0.f);
    sl += jmax(b[i] - b_min, 0.f);
  }
  const float2 hs = tm.sum2(hr, sl);
  const float residual = delta - s;
  const float hden = jmax(hs.x, 1e-30f), sden = jmax(hs.y, 1e-30f);
  float cs = 0.f;
  for (int i = lo_i + tm.tid; i < hi_i; i += tm.nt) {
    float bi = 0.f;
    if (in(i)) {
      bi = b[i];
      bi = residual >= 0.f ? bi + residual * (jmax(b_max - bi, 0.f) / hden)
                           : bi + residual * (jmax(bi - b_min, 0.f) / sden);
      bi = jclip(bi, b_min, b_max);
      if (WithCost) cs += rho[i] * f_shannon(jmax(bi, b_min), beta);
    }
    b[i] = bi;
  }
  return WithCost ? tm.template all<Sum>(cs) : 0.f;
}

// A candidate of the ``newton`` solver (_prefix_newton): its bracket comes
// from the round's shared log grid (newton_grid_seeds): hi0, the least
// level whose prefix budget residual is <= 0 (capped at the candidate's
// lam_hi), the largest other level as the seed's low end, lam0 their
// geometric mean; then ``outer`` x ``inner`` polish steps from lo = 0, the
// repair and W.  Returns false for an infeasible m only: a member with
// rho = +inf gives W = -inf or NaN as in the plain version, where a NaN
// wins (kNanWins).
struct GridCandidate {
  static constexpr bool kNanWins = true;
  const unsigned* bits;  // per candidate m, at m - 1: bit g set where level g's residual <= 0
  const float* lam_g;    // the grid's levels
  int grid, outer, inner;
  template <class Team>
  __device__ bool operator()(const Team& tm, const float* rho, int L, int start, int m,
                             const SweepParams& p, float fp_min, float* b, float& w) const {
    const float mf = (float)m;
    if (!(mf <= p.kf - p.n0f) || start + m > L) return false;
    const int lo_i = start, hi_i = start + m;
    const float b_max = jmax(p.delta - jmax(mf - 1.f, 0.f) * p.b_min, p.b_min);
    const float lam_hi = rho[hi_i - 1] * fp_min * 1.000001f + 1e-30f;
    const unsigned mask = bits[m - 1];
    float hi_seed = INFINITY, lo_seed = 0.f;
    for (int g = 0; g < grid; ++g) {
      if ((mask >> g) & 1u) hi_seed = jmin(hi_seed, lam_g[g]);
      else lo_seed = jmax(lo_seed, lam_g[g]);
    }
    const float hi0 = jmin(isfinite(hi_seed) ? hi_seed : lam_hi, lam_hi);
    const float lam0 = jmin(jmax(sqrtf(jmax(lo_seed, 1e-30f) * jmax(hi0, 1e-30f)), 0.f), hi0);
    const float sb = newton_polish(tm, rho, lo_i, hi_i, AllSlots{}, p.delta, p.beta, p.b_min,
                                   b_max, outer, inner, lam0, 0.f, hi0, b);
    w = p.v_eta * (p.n0f + mf) -
        p.scale * budget_repair<true>(tm, rho, lo_i, hi_i, AllSlots{}, sb, p.delta, p.beta,
                                      p.b_min, b_max, b);
    return true;
  }
};

// Whether (W w2, m2) is ahead of (w, m) in the sweep's order: the larger W,
// ties to the smaller m, and NaN never ahead; with ``nan_wins`` (kNanWins)
// a NaN is ahead of every number, the smaller m first among NaNs.
__device__ __forceinline__ bool ahead(float w2, float m2, float w, float m, bool nan_wins) {
  if (nan_wins && (isnan(w2) || isnan(w))) return isnan(w2) && (!isnan(w) || m2 < m);
  return w2 > w || (w2 == w && m2 < m);
}

// W of m = 0: nothing selected beyond S0, cost 0.
__device__ __forceinline__ float w_of_none(const SweepParams& p, bool mask_nonfinite) {
  float w = p.v_eta * (p.n0f + 0.f) - p.scale * 0.f;
  if (mask_nonfinite && !isfinite(w)) w = kNegInf;
  return w;
}

// ---------------------------------------------------------------------------
// The candidate-parallel K+1-prefix sweep: teams of NT lanes evaluate
// m = g + 1, g + 1 + nteams, ... in increasing order, g being the team's
// index among all ``nteams`` (by default one block holds them all and g
// is the block's own team index; K2 spreads them over a cluster and
// passes g), each keeping its own running
// argmax; the block then takes the argmax over its teams, lexicographic
// in (W descending, m ascending).  Over all teams that is the sequential
// sweep's winner: the largest W over m = 0 and the unmasked candidates,
// ties to the smaller m, and NaN never wins (a team's best starts at W(0)
// and only a strictly greater W replaces it) -- unless the Candidate's
// kNanWins (the bisect and newton solvers, whose plain versions pick with
// torch.argmax): then the smallest m whose W is NaN wins.  A masked candidate is
// skipped, which a sequential sweep's early end equals because both masks
// are monotone in m.
//
//   MaskNonfinite  K2's rule: a non-finite W (W(0) included) is not an
//                  answer and counts as NEG_INF; K1 keeps W as it is, K3
//                  passes the rule at run time (``mask``: pallas_tiled)
//   Candidate      what evaluates one candidate: NewtonCandidate (K1's
//                  solve, the default), BisectCandidate (prefix_sweep_bisect)
//                  or GridCandidate (the newton solver, K3)
//   rows           shared scratch of 2 * (teams in the block) * L floats:
//                  team u's working row at rows + 2 u L, its best row (its
//                  winner's allocation, 0 outside it) at rows + (2 u + 1) L
//   scratch        at least 2 * 32 floats; a block holds at most 32 teams
// On return every thread holds the block's W*, m* and the (block-local)
// team whose best row is the winner's allocation.
// ---------------------------------------------------------------------------
template <int NT = 32, bool MaskNonfinite = false, class Candidate = NewtonCandidate>
__device__ void prefix_sweep_parallel(const float* rho, int L, int start, int n_cands,
                                      const SweepParams& p, float* rows, float* scratch,
                                      float& w_out, float& m_out, int& winner,
                                      int g = -1, int nteams = 0,
                                      const Candidate& cand = Candidate(),
                                      bool mask = MaskNonfinite) {
  const LaneTeam<NT> tm;
  const int team = threadIdx.x / NT, block_teams = blockDim.x / NT;
  if (g < 0) g = team;
  if (nteams == 0) nteams = block_teams;
  float* b = rows + 2 * (size_t)team * L;
  float* best = b + L;
  for (int i = tm.tid; i < L; i += tm.nt) best[i] = 0.f;
  __syncwarp(tm.mask);  // the winner copy below maps slots to lanes differently
  float best_w = w_of_none(p, mask);
  float best_m = 0.f;
  const float fp_min = -f_prime(p.b_min, p.beta);

  for (int m = g + 1; m <= n_cands; m += nteams) {
    float w;
    if (!cand(tm, rho, L, start, m, p, fp_min, b, w)) continue;
    if (mask && !isfinite(w)) w = kNegInf;
    // m grows along a team's walk: a later candidate is ahead only by a
    // larger W (or, kNanWins, as the team's first NaN)
    const bool take = Candidate::kNanWins && isnan(w) ? !isnan(best_w) : w > best_w;
    if (take) {  // team-uniform
      best_w = w;
      best_m = (float)m;
      for (int i = start + tm.tid; i < start + m; i += tm.nt) best[i] = b[i];
    }
  }
  __syncwarp(tm.mask);
  if (tm.tid == 0) {
    scratch[team] = best_w;
    scratch[32 + team] = best_m;
  }
  __syncthreads();  // also publishes every team's best row
  float bw = scratch[0], bm = scratch[32];
  int bi = 0;
  for (int i = 1; i < block_teams; ++i) {
    const float w2 = scratch[i], m2 = scratch[32 + i];
    if (ahead(w2, m2, bw, bm, Candidate::kNanWins)) {
      bw = w2;
      bm = m2;
      bi = i;
    }
  }
  w_out = bw;
  m_out = bm;
  winner = bi;
}

// The same sweep with the ``bisect`` solver's candidate (``outer`` x
// ``inner`` halvings, the port's 42 x 42): K3's solver="bisect" instance
// and its guard's fallback.  Each candidate's sums run in its team's fixed
// order whatever the block's team count, so every caller gets the same bits.
// ``NanRho``: candidate_w_bisect's (a NaN member gives W = NaN).
template <int NT, bool NanRho = false>
__device__ void prefix_sweep_bisect(const float* rho, int L, int start, int n_cands,
                                    const SweepParams& p, int outer, int inner, float* rows,
                                    float* scratch, float& w_out, float& m_out, int& winner) {
  prefix_sweep_parallel<NT, false, BisectCandidate<NanRho>>(rho, L, start, n_cands, p, rows,
                                                            scratch, w_out, m_out, winner, -1, 0,
                                                            BisectCandidate<NanRho>{outer, inner});
}

// ---------------------------------------------------------------------------
// The ``newton`` solver's per-round seed grid (_prefix_newton, before its
// polish), for the candidates m = 1 .. n_c of the ranked row rho[0, K)
// (members at slots [n0, n0 + m)).  Called by every thread of the block.
//   1. lam_hi_glob from the row's largest rho (order-free: the sort path's
//      largest candidate bound, the top-m path's rho_hi = max(rho)),
//      lam_lo_glob from the least positive rho among the candidates' slots
//      and b_cap = max(delta, b_min); ``grid`` levels evenly spaced in log
//      between them (frac[g]: torch.linspace(0, 1, grid)), into lam_g.
//   2. b(lam_g) of every candidate slot at every level (b_max = b_cap), in
//      passes of as many levels as the ``scr_n`` floats of ``scr`` hold,
//      then one warp per level adds its row's prefix sums in double: the
//      sums of these floats are exact in double, so rounding them once to
//      float gives the plain version's cumsum (on the CPU it accumulates in
//      double), whatever the order.
//   3. bit g of bits[m - 1] set where level g's residual (prefix sum -
//      delta) of candidate m is <= 0: GridCandidate reads the bracket from
//      these bits and lam_g (a min and a max, exact in any order).
//   red   at least 64 floats of shared scratch
// RowMax: rho is only the candidates' compact row (K3's wide instances:
// K = n_c, n0 = 0) and ``row_max`` the largest rho of the whole client
// row, which the caller reduced (a max: exact in any order).
// ---------------------------------------------------------------------------
template <bool RowMax = false>
__device__ void newton_grid_seeds(const float* rho, int K, int n0, int n_c, const SweepParams& p,
                                  int grid, int inner, const float* frac, float* scr, int scr_n,
                                  unsigned* bits, float* lam_g, float* red,
                                  float row_max = 0.f) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nwarps = nt >> 5;
  float mx = RowMax ? row_max : -INFINITY, mn = INFINITY;
  for (int i = tid; i < K; i += nt) {
    if (!RowMax) mx = jmax(mx, rho[i]);
    if (i >= n0 && i < n0 + n_c && rho[i] > 0.f) mn = jmin(mn, rho[i]);
  }
  mx = warp_all<Max>(mx);
  mn = warp_all<Min>(mn);
  if (lane == 0) {
    red[warp] = mx;
    red[32 + warp] = mn;
  }
  for (int j = tid; j < n_c; j += nt) bits[j] = 0u;
  __syncthreads();
  float rho_hi = red[0], rho_min = red[32];
  for (int w = 1; w < nwarps; ++w) {
    rho_hi = jmax(rho_hi, red[w]);
    rho_min = jmin(rho_min, red[32 + w]);
  }
  const float fp_min = -f_prime(p.b_min, p.beta);
  const float lam_hi = rho_hi * fp_min * 1.000001f + 1e-30f;
  const float b_cap = jmax(p.delta, p.b_min);
  float lam_lo = isfinite(rho_min) ? rho_min * jmax(-f_prime(b_cap, p.beta), 1e-30f) * 0.5f
                                   : 1e-30f;
  lam_lo = jmin(jmax(lam_lo, 1e-30f), lam_hi);
  if (tid < grid) {
    const float log_lo = logf(lam_lo), log_hi = logf(jmax(lam_hi, 1e-30f));
    lam_g[tid] = expf(log_lo * (1.f - frac[tid]) + log_hi * frac[tid]);
  }
  __syncthreads();  // lam_g written, red read
  if (n_c <= 0) return;
  const int per_pass = max(1, min(grid, scr_n / n_c));
  for (int g0 = 0; g0 < grid; g0 += per_pass) {
    const int gl = min(per_pass, grid - g0);
    for (int i = tid; i < gl * n_c; i += nt) {
      const int g = i / n_c, j = i - g * n_c;
      scr[i] = b_of_lam(lam_g[g0 + g], rho[n0 + j], p.beta, p.b_min, b_cap, inner);
    }
    __syncthreads();
    for (int g = warp; g < gl; g += nwarps) {
      const float* row = scr + (size_t)g * n_c;
      double carry = 0.0;
      for (int c = 0; c < n_c; c += 32) {
        const int j = c + lane;
        double x = j < n_c ? (double)row[j] : 0.0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        x += carry;
        if (j < n_c && (float)x - p.delta <= 0.f) atomicOr(bits + j, 1u << (g0 + g));
        carry = __shfl_sync(0xffffffffu, x, 31);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The masked P4: the optimal split of ``delta`` among an arbitrary member
// set of one cell, the device counterpart of the port's ``waterfill_newton``
// (repro_torch/core/solvers.py; reference repro/core/solvers.py), in its
// order: the budget's b_max, a log grid of ``grid`` multipliers seeding the
// bracket, ``outer`` safeguarded Newton steps on the budget residual (its
// ``_outer_newton_polish``), the final allocation and ``_budget_repair``.
// The grid levels are spread over the block's teams; team 0 then runs the
// polish (a chain, like one candidate's).  Called by every thread of the
// block (it synchronizes the block).
//
//   rho[0, L)    priorities in the cell's ranked order (shared)
//   member[0, L) 1 where a slot is in the set (positive-rho members only)
//   frac[g]      torch.linspace(0, 1, grid)'s values
//   b            out: the members' allocation, 0 elsewhere (shared, L)
//   scratch      at least 2 * grid floats of shared memory
// ---------------------------------------------------------------------------
template <int NT>
__device__ void masked_waterfill(const float* rho, const float* member, int L, float delta,
                                 float beta, float b_min, int outer, int inner, int grid,
                                 const float* frac, float* b, float* scratch) {
  const LaneTeam<NT> tm;
  const int team = threadIdx.x / NT, nteams = blockDim.x / NT;
  // Every team reduces the set's count, largest rho and least positive rho.
  float cnt = 0.f, mx = 0.f, mn = INFINITY;
  for (int i = tm.tid; i < L; i += tm.nt) {
    if (member[i] > 0.f) {
      cnt += 1.f;
      mx = jmax(mx, rho[i]);
      if (rho[i] > 0.f) mn = jmin(mn, rho[i]);
    }
  }
  const float n = tm.template all<Sum>(cnt);
  const float rho_max = tm.template all<Max>(mx);
  const float rho_min = tm.template all<Min>(mn);
  const float b_max = jmax(delta - (jmax(n, 1.f) - 1.f) * b_min, b_min);
  const float fp_min = -f_prime(b_min, beta);
  const float lam_hi = rho_max * fp_min * 1.000001f + 1e-30f;
  float lam_lo = isfinite(rho_min) ? rho_min * jmax(-f_prime(b_max, beta), 1e-30f) * 0.5f
                                   : 1e-30f;
  lam_lo = jmin(jmax(lam_lo, 1e-30f), lam_hi);
  const float log_lo = logf(lam_lo), log_hi = logf(jmax(lam_hi, 1e-30f));

  // The grid: each team evaluates its levels' budget residuals.
  for (int g = team; g < grid; g += nteams) {
    const float lam = expf(log_lo * (1.f - frac[g]) + log_hi * frac[g]);
    float s = 0.f;
    for (int i = tm.tid; i < L; i += tm.nt)
      if (member[i] > 0.f) s += b_of_lam(lam, rho[i], beta, b_min, b_max, inner);
    s = tm.template all<Sum>(s);
    if (tm.tid == 0) {
      scratch[g] = lam;
      scratch[grid + g] = s - delta;
    }
  }
  __syncthreads();
  if (team == 0) {
    float hi_seed = INFINITY, lo0 = 0.f;
    for (int g = 0; g < grid; ++g) {
      const float lam = scratch[g], rg = scratch[grid + g];
      if (rg <= 0.f) hi_seed = jmin(hi_seed, lam);
      if (rg > 0.f) lo0 = jmax(lo0, lam);
    }
    const float hi0 = jmin(isfinite(hi_seed) ? hi_seed : lam_hi, lam_hi);
    const float lam = jmin(jmax(sqrtf(jmax(lo0, 1e-30f) * jmax(hi0, 1e-30f)), 0.f), hi0);
    const Flagged in{member};
    const float sb = newton_polish(tm, rho, 0, L, in, delta, beta, b_min, b_max, outer, inner,
                                   lam, lo0, hi0, b);
    budget_repair<false>(tm, rho, 0, L, in, sb, delta, beta, b_min, b_max, b);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Launch helpers (host).
// ---------------------------------------------------------------------------
// Threads for n items: whole warps, at least one, at most ``cap`` and at most
// what the kernel's register use allows in one block (at 80 registers a
// thread, a block of 1024 would need more than the SM's 65,536).
inline int threads_for(const void* fn, int n, int cap) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fn) == cudaSuccess && attr.maxThreadsPerBlock < cap)
    cap = attr.maxThreadsPerBlock & ~31;
  int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > cap ? cap : t);
}

// Opt a kernel into ``smem`` bytes of dynamic shared memory past 48 KB.
inline cudaError_t prepare(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The current device's per-block shared-memory limit (with opt-in).
inline int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

}  // namespace ocean

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
