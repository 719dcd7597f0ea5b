// K5 — flash decoding: one query token per batch row against a KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_decode_kernel
// (pallas_call at :122), reached through repro/kernels/ops.py::decode_attention.
// Wrapper and plain PyTorch version: repro_torch/kernels/decode_attention.py.
//
// What bounds it on the H100: bytes.  Every valid cache row of k and v is
// read once and used for G = H / KV query heads: 4 * G * Dh FLOP per
// 2 * Dh * sizeof(T) bytes, 0.5-8 FLOP per byte against the card's ~295.
// So the design keeps the loads streaming and takes every per-slot
// dependency out of the loop:
//   * split-K: one block per (kv head, split, batch row) carries all G
//     query heads of its kv head, so a cache row is read once for the whole
//     group.  A split's length is set on the host from S, B, KV and the
//     card's SM count (never from valid_len) so that the grid is at least
//     two waves of resident blocks; splits at or past valid_len exit at once;
//   * each of the 4 warps streams its own contiguous run of the split in
//     tiles of WT slots (at most 8 KB of k and v per tile) through a private
//     3-stage ring of 16-byte cp.async copies in shared memory, so two
//     tiles are always in flight per warp and the warps never wait on each
//     other; slots at or past valid_len are zero-filled, never read;
//   * Q K^T of a tile: LPS = 32 / WT lanes per slot, each summing its part
//     of the head dimension for all G heads (q in shared memory as f32,
//     read by broadcast), then log2(LPS) shuffles; the chunk order is
//     rotated by part so that the padded rows are read without bank
//     conflicts;
//   * one max, one correction and one rescale of the accumulator per tile
//     and head (log2(WT) shuffles), the tile's probabilities through shared
//     memory, then P V with lanes over the head dimension;
//   * the block merges its warps in shared memory (reusing the ring) and
//     writes one partial (m, l, acc) per head to a scratch tensor the
//     wrapper allocates; the last block of a (batch row, kv head) to arrive
//     (an atomic counter per pair) merges its splits and writes the output,
//     so one kernel does the whole call;
//   * the kernel reads valid_len from device memory itself, as int32 or
//     int64 (no host round trip, no cast), or takes it as an argument.
// Numerics follow the TPU kernel: f32 throughout, logits scaled then
// soft-capped (tanh.approx.f32 on bf16 inputs, whose error is far below a
// bf16 rounding of the output; the precise tanhf on f32 inputs), output
// acc / max(l, 1e-30) in the input type.  A split or warp without valid
// slots carries m = -1e30, l = 0, whose weight exp(-1e30 - m) in the merge
// is 0; with valid_len = 0 the output is 0, as in the JAX oracle (the TPU
// kernel would average the masked slots).
// Inputs: contiguous q (B, H, Dh), caches (B, S, KV, Dh), all bf16 or all
// f32; Dh in {32, 64, 128, 256}; G = H / KV in {1, 2, 4, 8}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;               // tiles per warp ring: two in flight
constexpr int MAX_TILES_PER_WARP = 8;   // a split is at most 4 x 8 tiles
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Tile geometry for element type T and head dim DH.
template <typename T, int DH>
struct Geo {
  static constexpr int SZ = static_cast<int>(sizeof(T));
  static constexpr int CH = DH * SZ / 16;                  // 16-byte chunks per row
  static constexpr int WT = 256 / CH < 32 ? 256 / CH : 32;  // slots per warp tile
  static constexpr int LPS = 32 / WT;                      // lanes per slot in Q K^T
  static constexpr int CPL = CH / LPS;                     // chunks per lane in Q K^T
  static constexpr int EPC = 16 / SZ;                      // elements per chunk
  static constexpr int EPL = DH / 32;                      // elements per lane in P V
  static constexpr int PITCH = CH + 1;                     // row pitch in chunks
  static constexpr int STAGE = 2 * WT * PITCH;             // chunks of one warp stage
  static constexpr int RING_BYTES = STAGES * WARPS * STAGE * 16;
  static_assert(WT >= 4 && WT % 4 == 0 && (CPL & (CPL - 1)) == 0 && (2 * WT * CH) % 32 == 0,
                "tile geometry");
};

template <typename T, int DH, int G>
struct Smem {
  using g = Geo<T, DH>;
  static constexpr int BYTES = g::RING_BYTES + G * DH * 4 + WARPS * G * g::WT * 4;
  static_assert(WARPS * G * (DH + 2) * 4 <= g::RING_BYTES, "merge scratch fits the ring");
};

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

// One 16-byte chunk as f32: 8 bf16 or 4 f32.
__device__ __forceinline__ void unpack(const uint4& c, float (&out)[8]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& c, float (&out)[4]) {
  out[0] = __uint_as_float(c.x);
  out[1] = __uint_as_float(c.y);
  out[2] = __uint_as_float(c.z);
  out[3] = __uint_as_float(c.w);
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float softcap(float x, float cap, bf16*) {
  return cap * tanh_approx(x / cap);
}
__device__ __forceinline__ float softcap(float x, float cap, float*) {
  return cap * tanhf(x / cap);
}

// 16 bytes global -> shared; src_bytes = 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// valid_len: kind 0 = ``value``, 1 = int32 at ``ptr``, 2 = int64 at ``ptr``;
// clamped to [0, S].
__device__ __forceinline__ int read_valid(const void* ptr, int kind, int value, int S) {
  long long v = value;
  if (kind == 1) v = *static_cast<const int*>(ptr);
  else if (kind == 2) v = *static_cast<const long long*>(ptr);
  return static_cast<int>(v < 0 ? 0 : (v > S ? S : v));
}

// Partial of split `split`, kv head `kvh`, batch row `b`, head gi of the
// group: part[(((b * KV + kvh) * n_split + split) * G + gi) * (DH + 2) + ...]
// = [m, l, acc[0..DH)].
template <typename T, int DH, int G>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const void* valid_ptr, int valid_kind, int valid_value,
                    float* __restrict__ part, int* __restrict__ arrivals, T* __restrict__ out,
                    int S, int KV, int n_split, int keys_per_split, float cap, float scale) {
  using g = Geo<T, DH>;
  constexpr int WT = g::WT, CH = g::CH, PITCH = g::PITCH, CPL = g::CPL;
  constexpr int EPC = g::EPC, EPL = g::EPL;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float* s_q = reinterpret_cast<float*>(smem + g::RING_BYTES);  // [G][DH]
  float* s_p = s_q + G * DH;                                    // [WARPS][G][WT]

  const int kvh = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int valid = read_valid(valid_ptr, valid_kind, valid_value, S);
  const int split_begin = split * keys_per_split;
  const int H = KV * G;
  T* out_bh = out + (static_cast<size_t>(b) * H + kvh * G) * DH;  // [G][DH]
  if (split_begin >= valid) {  // the merge reads only splits below valid
    if (valid == 0 && split == 0)  // nothing valid: the output is 0
      for (int i = threadIdx.x; i < G * DH; i += THREADS) from_f32(0.f, out_bh + i);
    return;
  }

  const int warp_span = keys_per_split / WARPS;
  const int w_begin = split_begin + warp * warp_span;
  const int w_end = min(w_begin + warp_span, valid);
  const int n_tiles = w_end > w_begin ? (w_end - w_begin + WT - 1) / WT : 0;
  const size_t row_bytes = static_cast<size_t>(KV) * DH * sizeof(T);
  const size_t head0 = (static_cast<size_t>(b) * S * KV + kvh) * DH;
  const char* kb = reinterpret_cast<const char*>(kc + head0);
  const char* vb = reinterpret_cast<const char*>(vc + head0);

  // Tile t of this warp into its stage t % STAGES: K rows then V rows.
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      uint4* st = ring + ((t % STAGES) * WARPS + warp) * g::STAGE;
      const int s0 = w_begin + t * WT;
#pragma unroll
      for (int k = 0; k < 2 * WT * CH / 32; ++k) {
        const int i = lane + 32 * k;
        const int which = i / (WT * CH), rem = i % (WT * CH);
        const int r = rem / CH, c = rem % CH;
        const bool ok = s0 + r < w_end;
        const char* src = (which ? vb : kb) + (ok ? s0 + r : s0) * row_bytes + c * 16;
        cp_async16(st + which * WT * PITCH + r * PITCH + c, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  for (int i = threadIdx.x; i < G * DH; i += THREADS)
    s_q[i] = to_f32(q[(static_cast<size_t>(b) * H + kvh * G) * DH + i]);
  __syncthreads();

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
  }
  const int r = lane % WT, part_i = lane / WT;
  float* p_row = s_p + warp * G * WT;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();  // every lane's copies of tile t are visible; tile t - 1 is consumed
    load_tile(t + STAGES - 1);
    const uint4* ks = ring + ((t % STAGES) * WARPS + warp) * g::STAGE;
    const uint4* vs = ks + WT * PITCH;

    // Q K^T: slot r, part part_i of the head dimension, all G heads.
    float dot[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) dot[gi] = 0.f;
    const uint4* krow = ks + r * PITCH;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = part_i * CPL + ((j + part_i * WT) & (CPL - 1));
      float kf[EPC];
      unpack(krow[c], kf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float4* qp = reinterpret_cast<const float4*>(s_q + gi * DH + c * EPC);
#pragma unroll
        for (int h = 0; h < EPC / 4; ++h) {
          const float4 qv = qp[h];
          dot[gi] += qv.x * kf[4 * h] + qv.y * kf[4 * h + 1] + qv.z * kf[4 * h + 2] +
                     qv.w * kf[4 * h + 3];
        }
      }
    }
    const bool live = w_begin + t * WT + r < w_end;
    float corr[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int o = WT; o < 32; o <<= 1) dot[gi] += __shfl_xor_sync(0xffffffffu, dot[gi], o);
      float x = dot[gi] * scale;
      if (cap > 0.f) x = softcap(x, cap, static_cast<T*>(nullptr));
      x = live ? x : NEG_INF;
      float tmax = x;
#pragma unroll
      for (int o = 1; o < WT; o <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float mn = fmaxf(m[gi], tmax);
      corr[gi] = exp2f((m[gi] - mn) * LOG2E);
      const float p = exp2f((x - mn) * LOG2E);
      m[gi] = mn;
      l[gi] = l[gi] * corr[gi] + (part_i == 0 ? p : 0.f);
      if (part_i == 0) p_row[gi * WT + r] = p;
    }
    __syncwarp();

    // P V: lanes over the head dimension, the tile's slots in order.
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[gi][e] *= corr[gi];
#pragma unroll
    for (int s4 = 0; s4 < WT; s4 += 4) {
      float4 p4[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        p4[gi] = *reinterpret_cast<const float4*>(p_row + gi * WT + s4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vf[EPL];
        load_f32<T, EPL>(reinterpret_cast<const T*>(vs + (s4 + u) * PITCH) + lane * EPL, vf);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float pu = u == 0 ? p4[gi].x : u == 1 ? p4[gi].y : u == 2 ? p4[gi].z : p4[gi].w;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[gi][e] += pu * vf[e];
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], o);
  __syncthreads();  // every warp is done with the ring, which now holds the merge
  float* sm_m = reinterpret_cast<float*>(smem);  // [WARPS][G]
  float* sm_l = sm_m + WARPS * G;                // [WARPS][G]
  float* sm_acc = sm_l + WARPS * G;              // [WARPS][G][DH]
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      sm_m[warp * G + gi] = m[gi];
      sm_l[warp * G + gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[(warp * G + gi) * DH + lane * EPL + e] = acc[gi][e];
  }
  __syncthreads();

  float* mine = part + ((static_cast<size_t>(b) * KV + kvh) * n_split + split) * G * (DH + 2);
  for (int i = threadIdx.x; i < G * DH; i += THREADS) {
    const int gi = i / DH, d = i % DH;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * G + gi]);
    float a = 0.f, lw = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = exp2f((sm_m[w * G + gi] - mx) * LOG2E);
      a += sm_acc[(w * G + gi) * DH + d] * c;
      lw += sm_l[w * G + gi] * c;
    }
    float* o = mine + gi * (DH + 2);
    o[2 + d] = a;
    if (d == 0) {
      o[0] = mx;
      o[1] = lw;
    }
  }

  // Arrival: the last of the n_used splits of (b, kvh) to finish merges
  // them all.  Each thread's partial is visible device-wide before thread 0
  // counts the block in; the last block resets its counter for the next
  // call on the stream and reads the partials past L1 (__ldcg).
  __shared__ int s_last;
  const int n_used = (valid + keys_per_split - 1) / keys_per_split;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* arrived = arrivals + static_cast<size_t>(b) * KV + kvh;
    s_last = atomicAdd(arrived, 1) == n_used - 1;
    if (s_last) *arrived = 0;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* all = part + (static_cast<size_t>(b) * KV + kvh) * n_split * G * (DH + 2);
  const size_t stride = static_cast<size_t>(G) * (DH + 2);
  for (int i = threadIdx.x; i < G * DH; i += THREADS) {
    const int gi = i / DH, d = i % DH;
    const float* p = all + gi * (DH + 2);
    float mx = NEG_INF;
#pragma unroll 8
    for (int sp = 0; sp < n_used; ++sp) mx = fmaxf(mx, __ldcg(p + sp * stride));
    float a = 0.f, lw = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_used; ++sp) {
      const float* ps = p + sp * stride;
      const float c = exp2f((__ldcg(ps) - mx) * LOG2E);
      lw += __ldcg(ps + 1) * c;
      a += __ldcg(ps + 2 + d) * c;
    }
    from_f32(a / fmaxf(lw, 1e-30f), out_bh + i);
  }
}

// Resident blocks per SM of one instantiation (its dynamic shared memory
// above 48 KB opted in once); 0 on error.
template <typename T, int DH, int G>
int blocks_per_sm() {
  static int cached = 0;
  if (cached == 0) {
    const void* fn = reinterpret_cast<const void*>(decode_split_kernel<T, DH, G>);
    constexpr int bytes = Smem<T, DH, G>::BYTES;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
        cudaSuccess)
      return 0;
    int nb = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fn, THREADS, bytes) != cudaSuccess)
      return 0;
    cached = nb;
  }
  return cached;
}

// Slots per split: the longest split (WARPS x tiles x WT, tiles in
// {8, 4, 2, 1}) whose grid still makes two waves of resident blocks.
template <typename T, int DH, int G>
int keys_per_split(int B, int S, int KV) {
  const int nb = blocks_per_sm<T, DH, G>();
  int dev = 0, n_sm = 0;
  if (nb <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  constexpr int WT = Geo<T, DH>::WT;
  const long long target = 2LL * n_sm * nb;
  const long long tiles = (S + WT - 1) / WT;
  int tpw = MAX_TILES_PER_WARP;
  while (tpw > 1 && static_cast<long long>(B) * KV * ((tiles + WARPS * tpw - 1) / (WARPS * tpw)) < target)
    tpw >>= 1;
  return WARPS * tpw * WT;
}

template <typename T, int DH, int G>
cudaError_t launch_g(const void* q, const void* k, const void* v, const void* valid_ptr,
                     int valid_kind, int valid_value, float* part, int* arrivals, void* out,
                     int B, int S, int KV, float cap, float scale, cudaStream_t stream) {
  const int kps = keys_per_split<T, DH, G>(B, S, KV);
  if (kps <= 0) return cudaErrorInvalidConfiguration;
  const int n_split = S > kps ? (S + kps - 1) / kps : 1;
  decode_split_kernel<T, DH, G><<<dim3(KV, n_split, B), THREADS, Smem<T, DH, G>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid_ptr,
      valid_kind, valid_value, part, arrivals, static_cast<T*>(out), S, KV, n_split, kps, cap,
      scale);
  return cudaGetLastError();
}

// Calls F::template run<T, DH, G>() for the runtime (is_bf16, DH, G); -2 if
// the combination is not compiled.
template <class F>
auto dispatch(int is_bf16, int DH, int G, F f) -> decltype(f.template run<float, 32, 1>()) {
#define K5_G(T, D)                                  \
  switch (G) {                                      \
    case 1: return f.template run<T, D, 1>();       \
    case 2: return f.template run<T, D, 2>();       \
    case 4: return f.template run<T, D, 4>();       \
    case 8: return f.template run<T, D, 8>();       \
    default: return f.fail();                       \
  }
#define K5_D(T)                          \
  switch (DH) {                          \
    case 32: K5_G(T, 32)                 \
    case 64: K5_G(T, 64)                 \
    case 128: K5_G(T, 128)               \
    case 256: K5_G(T, 256)               \
    default: return f.fail();            \
  }
  if (is_bf16) {
    K5_D(bf16)
  } else {
    K5_D(float)
  }
  return f.fail();
#undef K5_D
#undef K5_G
}

struct SplitOf {
  int B, S, KV;
  template <typename T, int DH, int G>
  int run() const { return keys_per_split<T, DH, G>(B, S, KV); }
  int fail() const { return -2; }
};

struct Launch {
  const void *q, *k, *v, *valid_ptr;
  int valid_kind, valid_value;
  float* part;
  int* arrivals;
  void* out;
  int B, S, KV;
  float cap, scale;
  cudaStream_t stream;
  template <typename T, int DH, int G>
  cudaError_t run() const {
    return launch_g<T, DH, G>(q, k, v, valid_ptr, valid_kind, valid_value, part, arrivals, out,
                              B, S, KV, cap, scale, stream);
  }
  cudaError_t fail() const { return cudaErrorInvalidValue; }
};

}  // namespace

// Cache slots one split covers at this shape (the wrapper sizes the
// scratch with it): > 0, or < 0 for a shape the kernel does not take or a
// device query that failed.
extern "C" int decode_attention_keys_per_split(int B, int S, int H, int KV, int DH, int is_bf16) {
  if (KV <= 0 || H % KV) return -2;
  return dispatch(is_bf16, DH, H / KV, SplitOf{B, S, KV});
}

// q (B, H, DH); k, v (B, S, KV, DH); out (B, H, DH): contiguous, all
// float32 (is_bf16 = 0) or all bfloat16 (is_bf16 = 1).  valid_len:
// valid_kind 0 takes valid_value, 1 one int32 and 2 one int64 on the card
// at valid_ptr.  part: float32 scratch of
// B * KV * ceil(S / keys_per_split) * (H / KV) * (DH + 2) elements.
// arrivals: B * KV int32 counters, zero before the call and zero again
// after it (the merging block resets its own), so one set serves every call
// in order on one stream.  cap <= 0 means no soft-cap.  Returns a
// cudaError_t (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* valid_ptr, int valid_kind, int valid_value,
                                       float* part, int* arrivals, void* out, int B, int S,
                                       int H, int KV, int DH, int is_bf16, float cap,
                                       float scale, void* stream) {
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  const Launch l{q, k, v, valid_ptr, valid_kind, valid_value, part, arrivals, out, B, S, KV,
                 cap, scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(is_bf16, DH, H / KV, l));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
