// Shared device code of the OCEAN kernels (K1 ocean_p_prefix, K2 ocean_p_topm,
// K3 ocean_traj): the Shannon-inversion math, the safeguarded Newton
// waterfilling of one P4 candidate, and the sequential K+1-prefix sweep.
//
// The math follows the reference line for line:
//   f, f', f''            repro/core/energy.py:128-151
//   b_of_lam_newton       repro/core/solvers.py:265
//   the outer Newton step repro/kernels/ocean_p.py:95-111
//   _budget_repair        repro/core/solvers.py:335
// Elementwise, each kernel computes what its plain PyTorch version does op
// for op (no FMA contraction, exp2 rounded from double); the two differ
// only in the order of block sums.
//
// Layout: one thread block owns one cell.  Every block-uniform scalar
// (lam, its bracket, the running argmax) is computed redundantly by all
// threads from block reductions whose results every thread reads, so all
// branches around __syncthreads() are uniform.
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
    const float g = f_prime(b, beta) - t;
    const bool below = g < 0.f;
    lo = below ? b : lo;
    hi = below ? hi : b;
    const float bn = b - g / jmax(f_second(b, beta), 1e-30f);
    const bool ok = (bn >= lo) && (bn <= hi) && isfinite(bn);
    b = ok ? bn : 0.5f * (lo + hi);
  }
  b = jclip(b, b_min, b_max);
  if (at_min) b = b_min;
  if (at_max) b = b_max;
  return b;
}

// ---------------------------------------------------------------------------
// Block reductions.  Warp butterflies leave the identical value in every
// lane (float + is commutative), then warp partials go through shared
// memory and every thread folds them in the same order.  ``scratch`` holds
// at least 2 * 32 floats.
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

template <class Op>
__device__ float block_all(float v, float* scratch) {
  v = warp_all<Op>(v);
  if (blockDim.x <= 32) return v;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  __syncthreads();  // the previous reduction's readers are done with scratch
  if (lane == 0) scratch[wid] = v;
  __syncthreads();
  float r = scratch[0];
  for (int i = 1; i < nw; ++i) r = Op::op(r, scratch[i]);
  return r;
}

// Two sums in one pass (halves the barriers of the Newton loop).
__device__ float2 block_sum2(float a, float b, float* scratch) {
  a = warp_all<Sum>(a);
  b = warp_all<Sum>(b);
  if (blockDim.x <= 32) return make_float2(a, b);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) {
    scratch[wid] = a;
    scratch[32 + wid] = b;
  }
  __syncthreads();
  float ra = scratch[0], rb = scratch[32];
  for (int i = 1; i < nw; ++i) {
    ra += scratch[i];
    rb += scratch[32 + i];
  }
  return make_float2(ra, rb);
}

// (value, index) lexicographic min: the first occurrence of the minimum.
__device__ __forceinline__ void argmin_op(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ void block_argmin(float& v, int& i, float* scratch_v, int* scratch_i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    argmin_op(v, i, v2, i2);
  }
  if (blockDim.x <= 32) return;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) {
    scratch_v[wid] = v;
    scratch_i[wid] = i;
  }
  __syncthreads();
  v = scratch_v[0];
  i = scratch_i[0];
  for (int w = 1; w < nw; ++w) argmin_op(v, i, scratch_v[w], scratch_i[w]);
}

// ---------------------------------------------------------------------------
// The K+1-prefix sweep of P3 (Theorem 1), candidates in order, keeping only
// the running argmax (strict >: ties keep the smaller m).
//
//   rho[0, L)      the ranked priorities (shared memory)
//   start          first slot of the positive-rho region: candidate m owns
//                  slots [start, start + m)
//   n_cands        candidates m = 1..n_cands are considered (m = 0 always is)
//   n0f, kf        |S0| and K: W = V eta (n0 + m) - scale cost; m <= K - n0
//   mask_nonfinite K2's rule: a non-finite W is not an answer
//   b, best        shared scratch of L floats; ``best`` ends as the winner's
//                  allocation (0 outside it)
// Candidates whose W the reference would set to NEG_INF (infeasible m, or a
// member with rho = +inf, whose cost is +inf or NaN) are skipped: they can
// never win the strict comparison, so the result is the same.
// ---------------------------------------------------------------------------
struct SweepParams {
  float n0f, kf, delta, v_eta, beta, b_min, scale;
  int outer, inner;
};

__device__ void prefix_sweep(const float* rho, int L, int start, int n_cands,
                             const SweepParams& p, bool mask_nonfinite,
                             float* b, float* best, float* scratch,
                             float& w_out, float& m_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < L; i += nt) best[i] = 0.f;
  __syncthreads();  // the winner copy below maps slots to threads differently
  // m = 0: nothing selected beyond S0, cost 0.
  float best_w = p.v_eta * (p.n0f + 0.f) - p.scale * 0.f;
  if (mask_nonfinite && !isfinite(best_w)) best_w = kNegInf;
  float best_m = 0.f;
  const float fp_min = -f_prime(p.b_min, p.beta);

  for (int m = 1; m <= n_cands; ++m) {
    const float mf = (float)m;
    if (!(mf <= p.kf - p.n0f) || start + m > L) break;  // infeasible from here on
    const int lo_i = start, hi_i = start + m;
    const float b_max = jmax(p.delta - jmax(mf - 1.f, 0.f) * p.b_min, p.b_min);

    float mx = 0.f, mn = INFINITY;
    for (int i = lo_i + tid; i < hi_i; i += nt) {
      mx = jmax(mx, rho[i]);
      mn = jmin(mn, rho[i]);
    }
    const float rho_max = block_all<Max>(mx, scratch);
    if (!isfinite(rho_max)) break;  // +inf member: this and every larger m lose
    float rho_min = block_all<Min>(mn, scratch);
    rho_min = isfinite(rho_min) ? rho_min : 0.f;

    const float lam_hi = rho_max * fp_min * 1.000001f + 1e-30f;
    const float b_eq = jclip(p.delta / jmax(mf, 1.f), p.b_min, b_max);
    float lam = jclip(sqrtf(jmax(rho_min * rho_max, 1e-30f)) *
                          jmax(-f_prime(b_eq, p.beta), 1e-30f),
                      0.f, lam_hi);
    float lo = 0.f, hi = lam_hi;

    for (int it = 0; it < p.outer; ++it) {
      float rs = 0.f, ds = 0.f;
      for (int i = lo_i + tid; i < hi_i; i += nt) {
        const float bi = b_of_lam(lam, rho[i], p.beta, p.b_min, b_max, p.inner);
        rs += bi;
        if (bi > p.b_min && bi < b_max)
          ds += -1.f / (jmax(rho[i], 1e-30f) * jmax(f_second(bi, p.beta), 1e-30f));
      }
      const float2 s = block_sum2(rs, ds, scratch);
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
    for (int i = lo_i + tid; i < hi_i; i += nt) {
      const float bi = b_of_lam(lam, rho[i], p.beta, p.b_min, b_max, p.inner);
      b[i] = bi;
      sb += bi;
    }
    const float s = block_all<Sum>(sb, scratch);
    float hr = 0.f, sl = 0.f;
    for (int i = lo_i + tid; i < hi_i; i += nt) {
      hr += jmax(b_max - b[i], 0.f);
      sl += jmax(b[i] - p.b_min, 0.f);
    }
    const float2 hs = block_sum2(hr, sl, scratch);
    const float residual = p.delta - s;
    const float hden = jmax(hs.x, 1e-30f), sden = jmax(hs.y, 1e-30f);
    float cs = 0.f;
    for (int i = lo_i + tid; i < hi_i; i += nt) {
      float bi = b[i];
      bi = residual >= 0.f ? bi + residual * (jmax(b_max - bi, 0.f) / hden)
                           : bi + residual * (jmax(bi - p.b_min, 0.f) / sden);
      bi = jclip(bi, p.b_min, b_max);
      b[i] = bi;
      cs += rho[i] * f_shannon(jmax(bi, p.b_min), p.beta);
    }
    const float cost = block_all<Sum>(cs, scratch);
    float w = p.v_eta * (p.n0f + mf) - p.scale * cost;
    if (mask_nonfinite && !isfinite(w)) w = kNegInf;
    if (w > best_w) {  // block-uniform
      best_w = w;
      best_m = mf;
      // Prefixes grow with m, so the old winner's slots lie inside this one.
      for (int i = lo_i + tid; i < hi_i; i += nt) best[i] = b[i];
    }
  }
  __syncthreads();
  w_out = best_w;
  m_out = best_m;
}

}  // namespace ocean

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
