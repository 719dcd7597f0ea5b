// K6 — the Mamba selective scan (prefill, zero initial state) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py::_mamba_kernel
// (pallas_call at :71; wrappers mamba_scan :54 and repro/kernels/ops.py
// ::mamba_scan :81).  Wrapper and plain PyTorch version:
// repro_torch/kernels/mamba_scan.py.
//
// Per (batch b, channel di, state ds), from h = 0:
//     h_t[di][ds] = dA_t[di][ds] * h_{t-1}[di][ds] + dBu_t[di][ds]
//     y_t[di]     = sum_ds h_t[di][ds] * C_t[ds]
//
// What bounds it on the H100: bytes, by far.  Each state element reads
// 8 bytes (dA, dBu) per step for 4 flops; at the jamba mixer's block of
// 4096 channels x 16 states x 8192 steps that is 4.4 GB for 2e9 flops,
// ~0.5 flop per byte against a balance point of 20.  So the design is a
// streaming one whose only aim is to keep enough loads in flight:
//   * one thread per (b, di, ds) state element, h in a register; the
//     DS threads of a channel are adjacent lanes of one warp, so a warp
//     reads 32 consecutive floats of dA (and of dBu) per step, fully
//     coalesced, with streaming (evict-first) loads;
//   * the loads of U steps do not depend on the recurrence and are
//     issued together before the U steps of the chain run, so each
//     thread keeps 2 U loads in flight;
//   * y_t is a DS-lane shuffle reduction of h * C_t; C_t is the same for
//     every channel of a batch row and comes through the read-only cache.
// Any T and any Di: the last U-step group runs step by step, and the
// lanes of channels past Di load nothing and store nothing (they still
// take part in the shuffles).  Inputs: float32, contiguous; DS in
// {4, 8, 16, 32}.
// Not yet: discretising inside the kernel from (dt, B, u, A), which
// would read 4 bytes per (step, channel) instead of 8 per state element
// (a later PR's work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 16;  // steps whose loads are issued together

template <int DS>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = DS / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DS>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ da, const float* __restrict__ dbu,
                  const float* __restrict__ c, float* __restrict__ y, int T, int Di) {
  constexpr int CPB = THREADS / DS;  // channels per block
  const int ds = threadIdx.x % DS;
  const int di = blockIdx.x * CPB + threadIdx.x / DS;
  const int b = blockIdx.y;
  const bool active = di < Di;
  const size_t step = static_cast<size_t>(Di) * DS;  // floats between consecutive steps
  const size_t off0 = static_cast<size_t>(b) * T * step + static_cast<size_t>(active ? di : 0) * DS + ds;
  const float* pa = da + off0;
  const float* pb = dbu + off0;
  const float* pc = c + static_cast<size_t>(b) * T * DS + ds;
  float* py = y + static_cast<size_t>(b) * T * Di + di;
  const bool writer = active && ds == 0;

  float h = 0.f;
  int t = 0;
  for (; t + U <= T; t += U) {
    float a[U], bu[U], cc[U];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const size_t o = static_cast<size_t>(t + s) * step;
      a[s] = active ? __ldcs(pa + o) : 0.f;
      bu[s] = active ? __ldcs(pb + o) : 0.f;
      cc[s] = __ldg(pc + static_cast<size_t>(t + s) * DS);
    }
#pragma unroll
    for (int s = 0; s < U; ++s) {
      h = fmaf(a[s], h, bu[s]);
      const float ys = group_sum<DS>(h * cc[s]);
      if (writer) py[static_cast<size_t>(t + s) * Di] = ys;
    }
  }
  for (; t < T; ++t) {
    const size_t o = static_cast<size_t>(t) * step;
    const float a = active ? __ldcs(pa + o) : 0.f;
    const float bu = active ? __ldcs(pb + o) : 0.f;
    h = fmaf(a, h, bu);
    const float ys = group_sum<DS>(h * __ldg(pc + static_cast<size_t>(t) * DS));
    if (writer) py[static_cast<size_t>(t) * Di] = ys;
  }
}

template <int DS>
cudaError_t launch(const float* da, const float* dbu, const float* c, float* y, int B, int T,
                   int Di, cudaStream_t stream) {
  constexpr int CPB = THREADS / DS;
  const dim3 grid((Di + CPB - 1) / CPB, B);
  mamba_scan_kernel<DS><<<grid, THREADS, 0, stream>>>(da, dbu, c, y, T, Di);
  return cudaGetLastError();
}

}  // namespace

// da, dbu (B, T, Di, DS), c (B, T, DS), y (B, T, Di): contiguous float32.
// Returns a cudaError_t (0 on success); an unsupported DS gives
// cudaErrorInvalidValue.
extern "C" int mamba_scan_launch(const void* da, const void* dbu, const void* c, void* y, int B,
                                 int T, int Di, int DS, void* stream) {
  const float* ap = static_cast<const float*>(da);
  const float* bp = static_cast<const float*>(dbu);
  const float* cp = static_cast<const float*>(c);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (DS) {
    case 4: err = launch<4>(ap, bp, cp, yp, B, T, Di, st); break;
    case 8: err = launch<8>(ap, bp, cp, yp, B, T, Di, st); break;
    case 16: err = launch<16>(ap, bp, cp, yp, B, T, Di, st); break;
    case 32: err = launch<32>(ap, bp, cp, yp, B, T, Di, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
