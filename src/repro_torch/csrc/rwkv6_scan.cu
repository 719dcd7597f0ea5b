// K7 — the RWKV6 WKV scan (prefill, zero initial state) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::_wkv_kernel
// (pallas_call at :82; wrappers wkv_scan :58 and repro/kernels/ops.py
// ::wkv_scan :73).  Wrapper and plain PyTorch version:
// repro_torch/kernels/rwkv6_scan.py.
//
// Per (batch b, head h), with an (N, N) float32 state S starting at 0:
//     y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// What bounds it on the H100: bytes.  Each (b, t, h) reads 4 N-vectors
// and writes one, 20 N bytes, for 5 N^2 + 3 N flops (the state never
// leaves the chip): at N = 64, ~16 flops per byte against the card's
// 67 TFLOP/s / 3.35 TB/s = 20 for float32 outside the tensor cores, so
// the two bounds are close and the data movement is the larger one.
// The hard part is the sequential dependence through time: only B * H
// independent chains exist (256 at the rwkv6 prefill shape of 8 x 32),
// about two per SM, and each step's operands reach the threads through
// shared memory, which delivers 128 bytes a cycle to an SM.  A thread
// that owns a whole column of S (one block of N threads per (b, h), or N
// x 4 threads each a quarter column) needs every row's r, k and w each
// step: ~49 floats for 16 state elements, ~50 KB a step per (b, h), and
// that delivery, not the arithmetic, set the time of both layouts.  The
// design:
//   * thread (a, c) owns an RT x CT tile of S in registers: RT rows of row
//     tile a (float4 chunks at 4a + 4 R q, R = N / RT row tiles) and the
//     CT columns [c CT, (c+1) CT); per step it reads RT floats each of r,
//     k, w and CT of v for RT CT elements.  At N = 64 the tile is 8 x 8:
//     64 threads per (b, h), 32 floats a step for 64 elements;
//   * the y of a column is a sum over the R row tiles, which sit in the
//     adjacent lanes of one warp; a transposing butterfly halves the
//     columns a lane carries at each xor step, so log2 R shuffle steps sum
//     all CT columns, and the lanes that end with a column write it;
//   * the step loop is unrolled twice: one warp per scheduler then has two
//     steps' independent multiply-adds to issue while a butterfly waits on
//     its shuffles (without it a (b, h) alone on an SM takes as long as two
//     sharing one: the chain's latency, not the issue rate, sets the time);
//   * r, k, v, w of a chunk of CH steps are staged in shared memory by
//     cp.async, double-buffered, so the next chunk's loads are in flight
//     during this one; the (B, T, H, N) layout is read in place (each
//     step's row of a head is 4 N contiguous bytes), no transpose;
//   * the bonus scalar r_t . (u * k_t) of each step of a chunk is
//     computed once, by THREADS / CH threads a step, before the chunk's
//     steps run.
// Any T: the last chunk is zero-filled past T and its steps stop at T.
// Inputs: float32, contiguous; N in {32, 64}.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;  // time steps per shared-memory chunk

__device__ __forceinline__ void cp_async_16(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// One (b, h)'s threads: R = N / RT row tiles (the low bits of the thread
// index, so a column's row tiles are adjacent lanes of one warp) by N / CT
// column tiles.  Row tile a holds the RT / 4 float4 chunks of rows at
// 4a + 4 R q (q < RT / 4): a quarter warp's float4 reads of one chunk are
// 128 contiguous bytes.  BT threads a step compute the chunk's bonus, NB
// rows each.  The step loop is unrolled U times.
template <int N_, int RT_, int CT_, int U_>
struct Tiles {
  static constexpr int N = N_, RT = RT_, CT = CT_, U = U_, R = N / RT, THREADS = R * (N / CT);
  static constexpr int BT = THREADS / CH, NB = N / BT;
  static_assert(RT % 4 == 0 && R <= 32 && CT <= R && (CT & (CT - 1)) == 0,
                "a column's row tiles in one warp");
  static_assert(THREADS % 32 == 0 && THREADS >= CH && NB % 4 == 0, "whole warps, whole float4s");
};

// Steps [t0, t0 + CH) of r, k, v, w for one (b, h) into a stage of four
// (CH, N) tiles; steps at or past T are zero-filled.
template <class L>
__device__ __forceinline__ void load_chunk(float* stage, const float* __restrict__ r,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ w, size_t base,
                                           size_t row, int t0, int T, int tid) {
  constexpr int N = L::N, PIECES = N / 4;  // 16-byte pieces per step row
#pragma unroll
  for (int p = tid; p < CH * PIECES; p += L::THREADS) {
    const int tt = p / PIECES;
    const int col = (p % PIECES) * 4;
    const bool ok = t0 + tt < T;
    const size_t off = ok ? base + static_cast<size_t>(t0 + tt) * row + col : base;
    float* dst = stage + tt * N + col;
    cp_async_16(dst, r + off, ok);
    cp_async_16(dst + CH * N, k + off, ok);
    cp_async_16(dst + 2 * CH * N, v + off, ok);
    cp_async_16(dst + 3 * CH * N, w + off, ok);
  }
  cp_async_commit();
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

template <class L>
__global__ void __launch_bounds__(L::THREADS)
wkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ y, int T, int H) {
  constexpr int N = L::N, RT = L::RT, CT = L::CT, R = L::R, BT = L::BT, NB = L::NB;
  constexpr int TILE = CH * N;
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                    // 2 x (r, k, v, w) x (CH, N)
  float* su = smem + 2 * 4 * TILE;         // u of this head
  float* sbonus = su + N;                  // r_t . (u * k_t) per step of a chunk

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int a = tid % R;                   // row tile
  const int c0 = (tid / R) * CT;           // first column of the column tile
  const size_t row = static_cast<size_t>(H) * N;  // floats between consecutive steps
  const size_t base = (static_cast<size_t>(b) * T * H + h) * N;
  for (int i = tid; i < N; i += L::THREADS) su[i] = u[h * N + i];

  // The column this lane ends the butterfly with, and whether it writes it:
  // at xor step o = R/2, R/4, ... while more than one column is carried, a
  // lane with bit o set keeps the upper half of its columns.
  int col = c0, keep = CT;
#pragma unroll
  for (int o = R / 2; keep > 1; o >>= 1) {
    keep >>= 1;
    if (a & o) col += keep;
  }
  constexpr int WRITERS = R / CT;  // lanes of a column left with its sum
  const bool writer = (a & (WRITERS - 1)) == 0;

  float S[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) S[i][j] = 0.f;

  const int nchunk = (T + CH - 1) / CH;
  load_chunk<L>(stages, r, k, v, w, base, row, 0, T, tid);
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) {
      load_chunk<L>(stages + ((c + 1) & 1) * 4 * TILE, r, k, v, w, base, row, (c + 1) * CH, T, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sr = stages + (c & 1) * 4 * TILE;
    const float* sk = sr + TILE;
    const float* sv = sk + TILE;
    const float* sw = sv + TILE;
    const int t0 = c * CH;
    const int steps = min(CH, T - t0);
    {  // the bonus: BT adjacent threads a step, NB rows each, read in a
       // rotated order so a quarter warp's float4 reads spread over the banks
      const int s = tid / BT, g = tid % BT;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) {
        const int i = g * NB + ((q + g) % (NB / 4)) * 4;
        const float4 r4 = ld4(sr + s * N + i), k4 = ld4(sk + s * N + i), u4 = ld4(su + i);
        acc = fmaf(r4.x, u4.x * k4.x, acc);
        acc = fmaf(r4.y, u4.y * k4.y, acc);
        acc = fmaf(r4.z, u4.z * k4.z, acc);
        acc = fmaf(r4.w, u4.w * k4.w, acc);
      }
#pragma unroll
      for (int o = 1; o < BT; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (g == 0) sbonus[s] = acc;
    }
    __syncthreads();
#pragma unroll (L::U)
    for (int s = 0; s < steps; ++s) {
      float ri[RT], ki[RT], wi[RT], vj[CT];
#pragma unroll
      for (int q = 0; q < RT / 4; ++q) {
        const int i = s * N + 4 * a + 4 * R * q;
        const float4 r4 = ld4(sr + i), k4 = ld4(sk + i), w4 = ld4(sw + i);
        ri[4 * q] = r4.x, ri[4 * q + 1] = r4.y, ri[4 * q + 2] = r4.z, ri[4 * q + 3] = r4.w;
        ki[4 * q] = k4.x, ki[4 * q + 1] = k4.y, ki[4 * q + 2] = k4.z, ki[4 * q + 3] = k4.w;
        wi[4 * q] = w4.x, wi[4 * q + 1] = w4.y, wi[4 * q + 2] = w4.z, wi[4 * q + 3] = w4.w;
      }
#pragma unroll
      for (int j = 0; j < CT; j += 4) {
        const float4 v4 = ld4(sv + s * N + c0 + j);
        vj[j] = v4.x, vj[j + 1] = v4.y, vj[j + 2] = v4.z, vj[j + 3] = v4.w;
      }
      float yj[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        float y0 = 0.f, y1 = 0.f;
#pragma unroll
        for (int i = 0; i < RT; i += 2) {
          y0 = fmaf(ri[i], S[i][j], y0);
          y1 = fmaf(ri[i + 1], S[i + 1][j], y1);
        }
        yj[j] = y0 + y1;
#pragma unroll
        for (int i = 0; i < RT; ++i) S[i][j] = fmaf(wi[i], S[i][j], ki[i] * vj[j]);
      }
      // Sum over the row tiles: each xor step hands the partner the half
      // of the columns it does not keep.
      int n = CT;
#pragma unroll
      for (int o = R / 2; o > 0; o >>= 1) {
        if (n > 1) {
          n >>= 1;
          const bool upper = (a & o) != 0;
#pragma unroll
          for (int j = 0; j < CT / 2; ++j) {
            if (j < n) {
              const float give = upper ? yj[j] : yj[j + n];
              const float mine = upper ? yj[j + n] : yj[j];
              yj[j] = mine + __shfl_xor_sync(0xffffffffu, give, o);
            }
          }
        } else {
          yj[0] += __shfl_xor_sync(0xffffffffu, yj[0], o);
        }
      }
      if (writer)
        y[base + static_cast<size_t>(t0 + s) * row + col] =
            fmaf(sv[s * N + col], sbonus[s], yj[0]);
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
}

template <class L>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w, const float* u,
                   float* y, int B, int T, int H, cudaStream_t stream) {
  const size_t smem = (2 * 4 * CH * L::N + L::N + CH) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv_scan_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  wkv_scan_kernel<L><<<grid, L::THREADS, smem, stream>>>(r, k, v, w, u, y, T, H);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, y (B, T, H, N) and u (H, N): contiguous float32.  Returns a
// cudaError_t (0 on success); an unsupported N gives cudaErrorInvalidValue.
extern "C" int wkv_scan_launch(const void* r, const void* k, const void* v, const void* w,
                               const void* u, void* y, int B, int T, int H, int N, void* stream) {
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 32: err = launch<Tiles<32, 4, 4, 4>>(rp, kp, vp, wp, up, yp, B, T, H, st); break;
    case 64: err = launch<Tiles<64, 8, 8, 2>>(rp, kp, vp, wp, up, yp, B, T, H, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
