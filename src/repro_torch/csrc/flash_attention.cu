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
// Two units set the pace: the tensor cores (989 TFLOP/s bf16, reachable
// only through wgmma) and the special-function unit (MUFU, 16 results per
// clock per SM).  At 128 x 128 tiles and Dh = 128 one tile's two products
// take 2048 SM clocks of tensor-core time, and one MUFU operation per
// logit takes 1024: the softmax's exp2 is one, gemma2's soft-cap a second.
// The design:
//   * warp roles: one block per (128-row query tile, head, batch row),
//     query tiles heaviest (latest) first, 3 warpgroups.  Warpgroup 0 is
//     the producer: one thread issues every TMA copy, and setmaxnreg drops
//     the warpgroup to 24 registers a thread.  Warpgroups 1 and 2 are
//     consumers with 240 registers a thread, 64 query rows each;
//   * stages: TMA brings Q once and K/V tiles of 128 keys into a ring of
//     3 stages in shared memory (with Q, 224 KB at Dh = 128).  Each stage
//     has a "full" mbarrier, completed by TMA's byte count, and an "empty" one,
//     on which the 256 consumer threads arrive after their last wgmma on
//     the stage.  The tensor maps are 4-D over (B, S, NH, Dh), with a box
//     of (Dh chunk, 1, 128 rows, 1) and the 128-byte swizzle (64-byte for
//     Dh = 32).  Rows past S in a batch row arrive as zeros.  At Dh = 128
//     a row is two 64-column swizzle atoms side by side;
//   * products: S = Q K^T is wgmma m64n128k16 with both operands in shared
//     memory (K-major descriptors, Dh/16 k-steps).  O += P V is wgmma
//     m64nDhk16 with A = P from registers, the S accumulator packed to bf16
//     in place (its layout is the register-A layout), and B = V in shared
//     memory through an MN-major (transposed) descriptor.  Both accumulate
//     in f32.  Tile i's P V runs on the tensor cores while the softmax of
//     tile i + 1 runs beside it (FlashAttention-3's intra-warpgroup
//     overlap, which needs the third stage); the two consumer warpgroups
//     are not made to alternate (ping-pong measured within noise);
//   * tile classes: each key tile is classified once per warpgroup.
//     Interior tiles run no mask arithmetic; only diagonal, window-edge and
//     ragged-end tiles mask.  Tiles that the causal mask or the window
//     empties for the whole query tile are never loaded;
//   * soft-cap: cap * tanh.approx.f32(x / cap), one MUFU operation, so a
//     capped tile costs 2 MUFU operations per logit.  tanh.approx's error
//     (about 2^-11 relative) stays under the bf16 rounding of P: on
//     gemma2-27b's global layer inputs the relative L2 error against the
//     plain version (precise tanh) is 2.770e-3 with the cap and 2.752e-3
//     without, with max |d| 0.03125 in both (chip_smoke.py, phase k4_flash,
//     NVIDIA H100 80GB HBM3 at 700 W).
// Numerics follow the TPU kernel: logits in f32, scaled, soft-capped,
// masked with -1e30 (not -inf: a row whose first tile is fully masked
// builds p = 1 garbage that the next real tile's correction
// exp(-1e30 - m) = 0 wipes), the softmax in base 2 (log2(e) folded into
// the scale), output acc / max(l, 1e-30) in the input type.  The one
// rounding the TPU kernel does not make: P enters the tensor cores as bf16
// (the plain version, like the JAX oracle mha_reference, rounds its
// probabilities to bf16 as well).
// Inputs: bf16, contiguous (B, S, H, Dh) q and (B, S, KV, Dh) k, v, each
// 16-byte aligned; Dh in {32, 64, 128}; H a multiple of KV.
// cuTensorMapEncodeTiled is a driver function: it is looked up through
// the runtime's driver entry point, so the library links no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // query rows per block: 2 consumer warpgroups of 64
constexpr int BK = 128;          // keys per tile
constexpr int STAGES = 3;        // K/V tiles in flight
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Shared-memory geometry for one head dimension.  A tile of R rows is
// NCHUNK boxes of (R rows x CHUNK columns), each row ROW_BYTES long and
// swizzled across 8-row atoms by TMA.
template <int DH>
struct Geo {
  static constexpr int CHUNK = DH < 64 ? DH : 64;
  static constexpr int ROW_BYTES = 2 * CHUNK;        // 64 or 128: the swizzle span
  static constexpr int NCHUNK = DH / CHUNK;
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;       // one K or one V tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;  // + alignment slack
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;      // descriptor: B128 / B64
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma operand registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one bf16x2 register, `lo` in the low half (the smaller
// column index, as the register-A fragment expects).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// wgmma.mma_async for the two products.  Accumulator layout (64 x N per
// warpgroup, N/2 floats per thread): warp w holds rows 16w..16w+15; for
// each 8-column slice j, d[4j], d[4j+1] sit at row 16w + lane/4, columns
// 8j + 2(lane%4) + {0, 1}, and d[4j+2], d[4j+3] eight rows below.
// S (64 x 128) = A B^T (+ S when scale_d): A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N) += A B: A (64 x 16 bf16) from registers, four per thread in
// the accumulator layout; B MN-major (transposed, trans-b = 1) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 128) {
    wgmma_rs_n128(o, a, db);
  } else if constexpr (DH == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n32(o, a, db);
  }
}

// One consumer warpgroup: query rows r_lo .. r_lo + 63 of the block's tile
// against key tiles t_begin .. t_begin + n_tiles - 1 of the ring.
template <int DH>
__device__ __forceinline__ void consume(uint32_t s_q, uint32_t s_kv, uint32_t bar_full,
                                        uint32_t bar_empty, uint32_t bar_q, int cw,
                                        bf16* __restrict__ o, int b, int h, int S, int H,
                                        int q0, int t_begin, int n_tiles, int causal, int window,
                                        float cap, float scale) {
  using G = Geo<DH>;
  constexpr int KSTEPS_CHUNK = G::CHUNK / 16;   // k-steps of Q K^T inside one swizzle atom
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + 64 * cw;
  const int row0 = r_lo + warp * 16 + g;  // this thread's two query rows
  const int row1 = row0 + 8;
  // Logits in base-2 units: post * tanh(pre * s) with a cap, pre * s without.
  const bool capped = cap > 0.f;
  const float pre = capped ? scale / cap : scale * LOG2E;
  const float post = cap * LOG2E;
  const uint32_t q_base = s_q + 64 * cw * G::ROW_BYTES;

  float acc[DH / 2];        // O, 64 x DH
  float sc[BK / 2];         // S, then P in f32, 64 x BK
  uint32_t pa[BK / 16][4];  // P in bf16, one register-A fragment per k-step
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, c0 = 1.f, c1 = 1.f;

  // S = Q K^T for the tile in `stage`.  BQ == BK, so Q and K chunks share
  // one stride; a k-step inside an atom moves the start by 32 bytes.
  auto issue_s = [&](int stage) {
    const uint32_t sk = s_kv + 2 * stage * G::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / KSTEPS_CHUNK) * BK * G::ROW_BYTES + (kk % KSTEPS_CHUNK) * 32;
      wgmma_ss_n128(sc, gmma_desc(q_base + off, 16, 8 * G::ROW_BYTES, G::LAYOUT),
                    gmma_desc(sk + off, 16, 8 * G::ROW_BYTES, G::LAYOUT), kk);
    }
    wgmma_commit();
  };
  // O += P V for the tile in `stage`: V's 16-key slices are 16 rows apart.
  auto issue_pv = [&](int stage) {
    const uint32_t sv = s_kv + (2 * stage + 1) * G::KV_BYTES;
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<DH>(acc, pa[kk], gmma_desc(sv + kk * 16 * G::ROW_BYTES, BK * G::ROW_BYTES,
                                          8 * G::ROW_BYTES, G::LAYOUT));
    wgmma_commit();
  };
  // Scale, soft-cap and mask S of the tile at key k0; new row maxima m, the
  // correction c = exp2(m_old - m) of l and O, and P = exp2(S - m) in place.
  auto softmax = [&](int k0) {
    if (capped) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = post * tanh_approx(pre * sc[e]);
    } else {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] *= pre;
    }
    // Only tiles on the diagonal, the window's edge or the ragged end mask.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > r_lo) ||
                      (window > 0 && r_lo + 63 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int row = (e & 2) ? row1 : row0;
        const int kp = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        const bool ok = kp < S && (!causal || kp <= row) && (window <= 0 || row - kp < window);
        if (!ok) sc[e] = NEG_INF;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    c0 = ex2(m0 - mx0);
    c1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      sc[e] = ex2(sc[e] - ((e & 2) ? m1 : m0));
      if (e & 2) s1 += sc[e]; else s0 += sc[e];
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
  };
  // O *= c, and P to bf16 in the register-A layout: k-step kk is S columns
  // 16kk .. 16kk + 15, i.e. accumulator slices 2kk and 2kk + 1.
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      acc[4 * j] *= c0;
      acc[4 * j + 1] *= c0;
      acc[4 * j + 2] *= c1;
      acc[4 * j + 3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };
  auto wait_full = [&](int i) { mbar_wait(bar_full + 8 * (i % STAGES), (i / STAGES) & 1); };

  // Tile i's P V product runs on the tensor cores while the softmax of tile
  // i + 1 runs beside it (FlashAttention-3's intra-warpgroup overlap).  The
  // loop body is branch-free -- the last tile's P V is peeled off -- so that
  // ptxas can see that wait_group 1 retires the S product, and does not
  // serialise the wgmmas.
  mbar_wait(bar_q, 0);
  wait_full(0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(t_begin * BK);
  rescale_and_pack();
  for (int i = 0; i + 1 < n_tiles; ++i) {
    wait_full(i + 1);
    issue_s((i + 1) % STAGES);
    issue_pv(i % STAGES);
    wgmma_wait<1>();  // S of tile i + 1 is in; P V of tile i still runs
    fence_regs(sc);
    softmax((t_begin + i + 1) * BK);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * (i % STAGES));  // done reading tile i's stage
    rescale_and_pack();
  }
  issue_pv((n_tiles - 1) % STAGES);
  wgmma_wait<0>();
  fence_regs(acc);

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  if (row0 < S) {
    bf16* out = o + ((static_cast<size_t>(b) * S + row0) * H + h) * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
  }
  if (row1 < S) {
    bf16* out = o + ((static_cast<size_t>(b) * S + row1) * H + h) * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int S,
                       int H, int KV, int causal, int window, float cap, float scale) {
  using G = Geo<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t s_kv = s_q + G::Q_BYTES;        // stage s: K at s_kv + 2s KV_BYTES, then V
  const uint32_t bar_full = s_q + G::BAR_OFF;    // full[s] at + 8s
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_q = bar_empty + 8 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest query tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int n_tiles = (k_end + BK - 1) / BK - t_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * 128);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = h / (H / KV);
      mbar_expect_tx(bar_q, G::Q_BYTES);
      for (int c = 0; c < G::NCHUNK; ++c)
        tma_load(s_q + c * BQ * G::ROW_BYTES, &tm_q, bar_q, c * G::CHUNK, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        // The (i / STAGES)-th refill of stage s waits for the consumers'
        // release of the one before it.
        if (i >= STAGES) mbar_wait(bar_empty + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t sk = s_kv + 2 * s * G::KV_BYTES;
        const int k0 = (t_begin + i) * BK;
        mbar_expect_tx(full, 2 * G::KV_BYTES);
        for (int c = 0; c < G::NCHUNK; ++c) {
          tma_load(sk + c * BK * G::ROW_BYTES, &tm_k, full, c * G::CHUNK, kvh, k0, b);
          tma_load(sk + G::KV_BYTES + c * BK * G::ROW_BYTES, &tm_v, full, c * G::CHUNK, kvh, k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<DH>(s_q, s_kv, bar_full, bar_empty, bar_q, threadIdx.x / 128 - 1, o, b, h, S, H, q0,
                t_begin, n_tiles, causal, window, cap, scale);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous (B, S, NH, DH) bf16 tensor, innermost first;
// one box is `chunk` columns of one head for 128 rows of one batch row.
cudaError_t tensor_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, int B, int S,
                       int NH, int DH, int chunk) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH), static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * DH;
  const cuuint64_t strides[3] = {row, row * NH, row * NH * S};  // bytes, dims 1..3
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(chunk), 1, 128, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            chunk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S, int H,
                   int KV, int causal, int window, float cap, float scale, cudaStream_t stream) {
  using G = Geo<DH>;
  static_assert(BQ == 128 && BK == 128, "tensor maps use 128-row boxes");
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  cudaError_t err = tensor_map(encode, &mq, q, B, S, H, DH, G::CHUNK);
  if (err == cudaSuccess) err = tensor_map(encode, &mk, k, B, S, KV, DH, G::CHUNK);
  if (err == cudaSuccess) err = tensor_map(encode, &mv, v, B, S, KV, DH, G::CHUNK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attention_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<DH><<<grid, THREADS, G::SMEM, stream>>>(mq, mk, mv, o, S, H, KV, causal,
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
