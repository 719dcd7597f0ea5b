// K4 — causal / sliding-window GQA flash attention (prefill) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at :126), which the JAX package reaches through
// repro/kernels/ops.py::flash_attention from models/attention.py::_mha.
// Wrapper and plain PyTorch version: repro_torch/kernels/flash_attention.py.
//
// What bounds it on the H100: operations.  A causal prefill at S = 8192,
// 32 heads of 128 does 4 * H * Dh * S(S+1)/2 = 5.5e11 FLOP of matrix
// products per layer but moves only q, k, v and o (~200 MB): ~2,700
// FLOP per byte, far above the card's ~295 bf16 FLOP/byte balance point.
// So the design keeps everything after the loads on chip and spends the
// FLOP on the tensor cores:
//   * one block per (64-row query tile, head, batch row); 4 warps, each
//     owning 16 query rows;
//   * key/value tiles of 64 rows stream through shared memory with
//     cp.async, double-buffered, so the next tile loads while this one
//     computes;
//   * S = Q K^T and O += P V run as mma.sync m16n8k16 bf16 products with
//     f32 accumulation; the softmax row max, row sum and the (16 x Dh)
//     output accumulator of each warp stay in registers, and P goes from
//     the S accumulator registers straight into the A operand of the
//     P V product (no shared-memory round trip);
//   * key tiles that the causal mask or the window empties for the whole
//     query tile are never loaded (the result is the same), and query
//     tiles are scheduled heaviest (latest) first.
// Numerics follow the TPU kernel: logits in f32, scaled, soft-capped with
// cap * tanh(x / cap), masked with -1e30 (not -inf: a row whose first
// tile is fully masked builds p = 1 garbage that the next real tile's
// correction exp(-1e30 - m) = 0 wipes), output acc / max(l, 1e-30) in
// the input type.  The one rounding the TPU kernel does not make: P
// enters the tensor cores as bf16 (the plain version, like the JAX
// oracle mha_reference, rounds its probabilities to bf16 as well).
// Inputs: bf16, contiguous (B, S, H, Dh) q and (B, S, KV, Dh) k, v;
// Dh in {32, 64, 128}; H a multiple of KV.
// Not yet: wgmma / TMA and warp specialisation (a later PR's work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 8;        // bf16 of padding per shared row: conflict-free fragment loads
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, `lo` in the low half (the smaller
// column index, as the mma fragments expect).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_u16(const bf16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async_16(bf16* smem, const bf16* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + 64) of one head of a (B, S, NH, DH) tensor into a
// (64, DH + PAD) shared tile; rows at or past S are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* __restrict__ g, int b, int row0,
                                          int S, int NH, int head, int tid) {
  constexpr int CPR = DH / 8;  // 16-byte chunks per row
  constexpr int LD = DH + PAD;
#pragma unroll
  for (int c = tid; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const int row = row0 + r;
    const bool ok = row < S;
    const bf16* src = g + ((static_cast<size_t>(b) * S + (ok ? row : 0)) * NH + head) * DH + col;
    cp_async_16(sm + r * LD + col, src, ok);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int KV,
                       int causal, int window, float cap, float scale) {
  constexpr int LD = DH + PAD;
  constexpr int KSTEPS = DH / 16;   // k-steps of the Q K^T product
  constexpr int NT_S = BK / 8;      // n-tiles of S (keys)
  constexpr int NT_O = DH / 8;      // n-tiles of O (head dim)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LD;          // two stages
  bf16* sV = sK + 2 * BK * LD;      // two stages

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest query tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  load_tile<DH>(sQ, q, b, q0, S, H, h, tid);
  load_tile<DH>(sK, k, b, t_begin * BK, S, KV, kvh, tid);
  load_tile<DH>(sV, v, b, t_begin * BK, S, KV, kvh, tid);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;
  uint32_t qf[KSTEPS][4];
  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int it = t_begin; it < t_end; ++it) {
    const int stage = (it - t_begin) & 1;
    if (it + 1 < t_end) {
      load_tile<DH>(sK + (stage ^ 1) * BK * LD, k, b, (it + 1) * BK, S, KV, kvh, tid);
      load_tile<DH>(sV + (stage ^ 1) * BK * LD, v, b, (it + 1) * BK, S, KV, kvh, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == t_begin) {
      const bf16* qa = sQ + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        qf[kk][0] = ld_u32(qa + kk * 16);
        qf[kk][1] = ld_u32(qa + 8 * LD + kk * 16);
        qf[kk][2] = ld_u32(qa + kk * 16 + 8);
        qf[kk][3] = ld_u32(qa + 8 * LD + kk * 16 + 8);
      }
    }
    const bf16* cK = sK + stage * BK * LD;
    const bf16* cV = sV + stage * BK * LD;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* kb = cK + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_16816(s[j], qf[kk], ld_u32(kb + kk * 16), ld_u32(kb + kk * 16 + 8));
    }

    // Scale, soft-cap, mask; row maxima over the quad that shares a row.
    const int k0 = it * BK;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        const bool ok = kp < S && (!causal || kp <= row) && (window <= 0 || row - kp < window);
        x = ok ? x : NEG_INF;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f((m0 - mn0) * LOG2E), c1 = exp2f((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      acc[i][0] *= c0; acc[i][1] *= c0;
      acc[i][2] *= c1; acc[i][3] *= c1;
    }

    // O += P V, 16 keys per k-step; P's A fragment is two S n-tiles.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f((s[2 * kk][e] - (e < 2 ? m0 : m1)) * LOG2E);
        p[4 + e] = exp2f((s[2 * kk + 1][e] - (e < 2 ? m0 : m1)) * LOG2E);
      }
      l0 += p[0] + p[1] + p[4] + p[5];
      l1 += p[2] + p[3] + p[6] + p[7];
      const uint32_t a[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                             pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
      const bf16* vb = cV + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int i = 0; i < NT_O; ++i) {
        const bf16* vc = vb + i * 8;
        const uint32_t b0 = ld_u16(vc) | (ld_u16(vc + LD) << 16);
        const uint32_t b1 = ld_u16(vc + 8 * LD) | (ld_u16(vc + 9 * LD) << 16);
        mma_16816(acc[i], a, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  if (r0 < S) {
    bf16* out = o + ((static_cast<size_t>(b) * S + r0) * H + h) * DH + 2 * t;
#pragma unroll
    for (int i = 0; i < NT_O; ++i)
      *reinterpret_cast<uint32_t*>(out + i * 8) = pack_bf16(acc[i][0] / l0, acc[i][1] / l0);
  }
  if (r1 < S) {
    bf16* out = o + ((static_cast<size_t>(b) * S + r1) * H + h) * DH + 2 * t;
#pragma unroll
    for (int i = 0; i < NT_O; ++i)
      *reinterpret_cast<uint32_t*>(out + i * 8) = pack_bf16(acc[i][2] / l1, acc[i][3] / l1);
  }
}

template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S, int H,
                   int KV, int causal, int window, float cap, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BQ + 4 * BK) * (DH + PAD) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<DH><<<grid, THREADS, smem, stream>>>(q, k, v, o, S, H, KV, causal,
                                                              window, cap, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, DH), k and v (B, S, KV, DH), o (B, S, H, DH): contiguous
// bf16.  window <= 0 means none; cap <= 0 means no soft-cap.  Returns a
// cudaError_t (0 on success); unsupported DH gives cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KV, int DH, int causal,
                                      int window, float cap, float scale, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (DH) {
    case 32: err = launch<32>(qp, kp, vp, op, B, S, H, KV, causal, window, cap, scale, st); break;
    case 64: err = launch<64>(qp, kp, vp, op, B, S, H, KV, causal, window, cap, scale, st); break;
    case 128: err = launch<128>(qp, kp, vp, op, B, S, H, KV, causal, window, cap, scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
