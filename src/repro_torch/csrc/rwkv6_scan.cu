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
// about two per SM.  The design therefore keeps the chain's critical
// path short and everything it touches on chip:
//   * one block of N threads per (b, h); thread j owns column j of S in
//     N registers, so the step needs no reduction across threads:
//       y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] * (sum_i r_t[i] u[i] k_t[i]),
//     four partial sums break the accumulation chain, and the update of
//     S is N independent fused multiply-adds;
//   * r, k, v, w of a chunk of CH steps are staged in shared memory by
//     cp.async, double-buffered, so the next chunk's loads are in flight
//     during this one; the (B, T, H, N) layout is read in place (each
//     step's row of a head is 4 N contiguous bytes), no transpose;
//   * the bonus scalar r_t . (u * k_t) of each step of a chunk is
//     computed once, one step per thread, before the chunk's steps run;
//   * r_t, k_t, w_t are read from shared memory as float4 broadcasts.
// Any T: the last chunk is zero-filled past T and its steps stop at T.
// Inputs: float32, contiguous; N in {32, 64}.
// Not yet: splitting a head's columns over several blocks to put more
// chains in flight (a later PR's work).

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

// Steps [t0, t0 + CH) of r, k, v, w for one (b, h) into a stage of four
// (CH, N) tiles; steps at or past T are zero-filled.
template <int N>
__device__ __forceinline__ void load_chunk(float* stage, const float* __restrict__ r,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ w, size_t base,
                                           size_t row, int t0, int T, int tid) {
  constexpr int PIECES = N / 4;  // 16-byte pieces per step row
#pragma unroll
  for (int p = tid; p < CH * PIECES; p += N) {
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

template <int N>
__global__ void __launch_bounds__(N)
wkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ y, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                    // 2 x (r, k, v, w) x (CH, N)
  float* su = smem + 2 * 4 * CH * N;       // u of this head
  float* sbonus = su + N;                  // r_t . (u * k_t) per step of a chunk

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const size_t row = static_cast<size_t>(H) * N;  // floats between consecutive steps
  const size_t base = (static_cast<size_t>(b) * T * H + h) * N;
  su[j] = u[h * N + j];

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = 0.f;

  const int nchunk = (T + CH - 1) / CH;
  load_chunk<N>(stages, r, k, v, w, base, row, 0, T, j);
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) {
      load_chunk<N>(stages + ((c + 1) & 1) * 4 * CH * N, r, k, v, w, base, row, (c + 1) * CH, T, j);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sr = stages + (c & 1) * 4 * CH * N;
    const float* sk = sr + CH * N;
    const float* sv = sk + CH * N;
    const float* sw = sv + CH * N;
    const int t0 = c * CH;
    const int steps = min(CH, T - t0);
    if (j < steps) {
      // Rotated start (i = j, j+1, ...): thread j's row is N floats from
      // its neighbour's, so the rotation keeps the 32 banks distinct.
      float acc = 0.f;
#pragma unroll 8
      for (int ii = 0; ii < N; ++ii) {
        const int i = (ii + j) & (N - 1);
        acc = fmaf(sr[j * N + i], su[i] * sk[j * N + i], acc);
      }
      sbonus[j] = acc;
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const float* rt = sr + s * N;
      const float* kt = sk + s * N;
      const float* wt = sw + s * N;
      const float vj = sv[s * N + j];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + i);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + i);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + i);
        y0 = fmaf(r4.x, S[i], y0);
        y1 = fmaf(r4.y, S[i + 1], y1);
        y2 = fmaf(r4.z, S[i + 2], y2);
        y3 = fmaf(r4.w, S[i + 3], y3);
        S[i] = fmaf(w4.x, S[i], k4.x * vj);
        S[i + 1] = fmaf(w4.y, S[i + 1], k4.y * vj);
        S[i + 2] = fmaf(w4.z, S[i + 2], k4.z * vj);
        S[i + 3] = fmaf(w4.w, S[i + 3], k4.w * vj);
      }
      y[base + static_cast<size_t>(t0 + s) * row + j] = fmaf(vj, sbonus[s], (y0 + y1) + (y2 + y3));
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w, const float* u,
                   float* y, int B, int T, int H, cudaStream_t stream) {
  const size_t smem = (2 * 4 * CH * N + N + CH) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv_scan_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  wkv_scan_kernel<N><<<grid, N, smem, stream>>>(r, k, v, w, u, y, T, H);
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
    case 32: err = launch<32>(rp, kp, vp, wp, up, yp, B, T, H, st); break;
    case 64: err = launch<64>(rp, kp, vp, wp, up, yp, B, T, H, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
