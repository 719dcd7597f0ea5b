// K5 — flash decoding: one query token per batch row against a KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_decode_kernel
// (pallas_call at :122), reached through repro/kernels/ops.py::decode_attention.
// Wrapper and plain PyTorch version: repro_torch/kernels/decode_attention.py.
//
// What bounds it on the H100: bytes.  Every valid cache row of k and v is
// read once and used for G = H / KV query heads: 4 * G * Dh FLOP per
// 2 * Dh * sizeof(T) bytes, 2-4 FLOP per byte against the card's ~295.
// So the design is about keeping many loads in flight and reading each
// cache byte exactly once:
//   * split-K: one block per (split of 256 cache slots, kv head, batch
//     row) carries all G query heads of its kv head, so a cache row is
//     read once for the whole group; with a long cache there are
//     thousands of blocks to cover the card;
//   * each of the 4 warps walks 64 consecutive slots, its lanes splitting
//     the head dimension so that one row load is one coalesced 32-lane
//     transaction; rows are loaded 4 at a time before their dot products
//     so that the loads overlap;
//   * the online-softmax state (max, sum, f32 accumulator) of each head
//     stays in registers; the block merges its warps in shared memory and
//     writes one partial (m, l, acc) per head to a scratch tensor the
//     wrapper allocates; a second kernel merges the splits per head;
//   * the kernels read valid_len from device memory themselves (no host
//     round trip, no scalar prefetch); slots at or past it are never
//     loaded, and splits past it exit at once.
// Numerics follow the TPU kernel: f32 throughout, logits scaled then
// soft-capped, output acc / max(l, 1e-30) in the input type.  A split or
// warp without valid slots carries m = -1e30, l = 0, whose weight
// exp(-1e30 - m) in the merge is 0; with valid_len = 0 the output is 0,
// as in the JAX oracle (the TPU kernel would average the masked slots).
// Inputs: contiguous q (B, H, Dh), caches (B, S, KV, Dh), all bf16 or all
// f32; Dh in {32, 64, 128, 256}; G = H / KV in {1, 2, 4, 8}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KEYS_PER_WARP = 64;
constexpr int KEYS_PER_SPLIT = KEYS_PER_WARP * WARPS;
constexpr int UNROLL = 4;     // cache rows loaded ahead of their dot products
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, bf16* out) { *out = __float2bfloat16_rn(x); }

// N consecutive elements at p (aligned to their total size) as f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[N]) {
  constexpr int BYTES = static_cast<int>(sizeof(T)) * N;
  alignas(16) T tmp[N];
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(tmp)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(tmp) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<uint32_t*>(tmp) = *reinterpret_cast<const uint32_t*>(p);
  } else {
    *reinterpret_cast<unsigned short*>(tmp) = *reinterpret_cast<const unsigned short*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(tmp[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int clamp_valid(const int* valid_len, int S) {
  return min(max(*valid_len, 0), S);
}

// Partial of split `split`, kv head `kvh`, batch row `b`, head gi of the
// group: part[(((b * KV + kvh) * n_split + split) * G + gi) * (DH + 2) + ...]
// = [m, l, acc[0..DH)].
template <typename T, int DH, int G>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ valid_len, float* __restrict__ part, int S, int KV,
                    int n_split, float cap, float scale) {
  constexpr int EPL = DH / 32;  // head-dim elements per lane
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][DH];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int valid = clamp_valid(valid_len, S);
  const int split_begin = split * KEYS_PER_SPLIT;
  if (split_begin >= valid) return;  // the merge reads only splits below valid

  const int H = KV * G;
  float qf[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    load_f32<T, EPL>(q + (static_cast<size_t>(b) * H + kvh * G + gi) * DH + lane * EPL, qf[gi]);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
  }

  const int s_begin = split_begin + warp * KEYS_PER_WARP;
  const int s_end = min(s_begin + KEYS_PER_WARP, valid);
  const size_t row_stride = static_cast<size_t>(KV) * DH;
  const T* kbase = kc + (static_cast<size_t>(b) * S * KV + kvh) * DH + lane * EPL;
  const T* vbase = vc + (static_cast<size_t>(b) * S * KV + kvh) * DH + lane * EPL;

  for (int s0 = s_begin; s0 < s_end; s0 += UNROLL) {
    float kf[UNROLL][EPL], vf[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (s0 + u < s_end) {
        load_f32<T, EPL>(kbase + (s0 + u) * row_stride, kf[u]);
        load_f32<T, EPL>(vbase + (s0 + u) * row_stride, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (s0 + u >= s_end) break;  // warp-uniform
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d += qf[gi][e] * kf[u][e];
        float x = warp_sum(d) * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        const float mn = fmaxf(m[gi], x);
        const float c = exp2f((m[gi] - mn) * LOG2E);
        const float p = exp2f((x - mn) * LOG2E);
        m[gi] = mn;
        l[gi] = l[gi] * c + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[gi][e] = acc[gi][e] * c + p * vf[u][e];
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][gi][lane * EPL + e] = acc[gi][e];
  }
  __syncthreads();

  float* out = part + ((static_cast<size_t>(b) * KV + kvh) * n_split + split) * G * (DH + 2);
  for (int i = threadIdx.x; i < G * DH; i += THREADS) {
    const int gi = i / DH, d = i % DH;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float a = 0.f, lw = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = exp2f((sm_m[w][gi] - mx) * LOG2E);
      a += sm_acc[w][gi][d] * c;
      lw += sm_l[w][gi] * c;
    }
    float* o = out + gi * (DH + 2);
    o[2 + d] = a;
    if (d == 0) {
      o[0] = mx;
      o[1] = lw;
    }
  }
}

// One block per (head, batch row), one thread per head-dim element: merge
// the splits that hold valid slots and write the output in T.
template <typename T, int DH>
__global__ void decode_merge_kernel(const float* __restrict__ part,
                                    const int* __restrict__ valid_len, T* __restrict__ out,
                                    int S, int KV, int G, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kvh = h / G, gi = h % G;
  const int n_used = (clamp_valid(valid_len, S) + KEYS_PER_SPLIT - 1) / KEYS_PER_SPLIT;
  const size_t stride = static_cast<size_t>(G) * (DH + 2);
  const float* p = part + ((static_cast<size_t>(b) * KV + kvh) * n_split * G + gi) * (DH + 2);
  float mx = NEG_INF;
  for (int sp = 0; sp < n_used; ++sp) mx = fmaxf(mx, p[sp * stride]);
  float a = 0.f, lw = 0.f;
  for (int sp = 0; sp < n_used; ++sp) {
    const float* ps = p + sp * stride;
    const float c = exp2f((ps[0] - mx) * LOG2E);
    lw += ps[1] * c;
    a += ps[2 + d] * c;
  }
  from_f32(a / fmaxf(lw, 1e-30f), out + (static_cast<size_t>(b) * KV * G + h) * DH + d);
}

template <typename T, int DH, int G>
cudaError_t launch_split(const T* q, const T* k, const T* v, const int* valid_len, float* part,
                         int B, int S, int KV, int n_split, float cap, float scale,
                         cudaStream_t stream) {
  const dim3 grid(n_split, KV, B);
  decode_split_kernel<T, DH, G><<<grid, THREADS, 0, stream>>>(q, k, v, valid_len, part, S, KV,
                                                              n_split, cap, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const int* valid_len,
                      float* part, void* out, int B, int S, int H, int KV, float cap,
                      float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int G = H / KV;
  const int n_split = (S + KEYS_PER_SPLIT - 1) / KEYS_PER_SPLIT;
  cudaError_t err;
  switch (G) {
    case 1: err = launch_split<T, DH, 1>(qp, kp, vp, valid_len, part, B, S, KV, n_split, cap, scale, stream); break;
    case 2: err = launch_split<T, DH, 2>(qp, kp, vp, valid_len, part, B, S, KV, n_split, cap, scale, stream); break;
    case 4: err = launch_split<T, DH, 4>(qp, kp, vp, valid_len, part, B, S, KV, n_split, cap, scale, stream); break;
    case 8: err = launch_split<T, DH, 8>(qp, kp, vp, valid_len, part, B, S, KV, n_split, cap, scale, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, DH><<<dim3(H, B), DH, 0, stream>>>(part, valid_len, static_cast<T*>(out),
                                                             S, KV, G, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* valid_len,
                     float* part, void* out, int B, int S, int H, int KV, int DH, float cap,
                     float scale, cudaStream_t stream) {
  switch (DH) {
    case 32: return launch_dh<T, 32>(q, k, v, valid_len, part, out, B, S, H, KV, cap, scale, stream);
    case 64: return launch_dh<T, 64>(q, k, v, valid_len, part, out, B, S, H, KV, cap, scale, stream);
    case 128: return launch_dh<T, 128>(q, k, v, valid_len, part, out, B, S, H, KV, cap, scale, stream);
    case 256: return launch_dh<T, 256>(q, k, v, valid_len, part, out, B, S, H, KV, cap, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Cache slots one split covers; the wrapper sizes the scratch with it.
extern "C" int decode_attention_keys_per_split() { return KEYS_PER_SPLIT; }

// q (B, H, DH); k, v (B, S, KV, DH); out (B, H, DH): contiguous, all
// float32 (is_bf16 = 0) or all bfloat16 (is_bf16 = 1).  valid_len: one
// int32 on the card.  part: float32 scratch of
// B * KV * ceil(S / keys_per_split) * (H / KV) * (DH + 2) elements.
// cap <= 0 means no soft-cap.  Returns a cudaError_t (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* valid_len, float* part, void* out, int B,
                                       int S, int H, int KV, int DH, int is_bf16, float cap,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_t<bf16>(q, k, v, valid_len, part, out, B, S, H, KV, DH, cap, scale, st)
              : launch_t<float>(q, k, v, valid_len, part, out, B, S, H, KV, DH, cap, scale, st);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
