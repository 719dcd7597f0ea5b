// K4 — causal / sliding-window GQA flash attention (prefill) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at :126), which the JAX package reaches through
// repro/kernels/ops.py::flash_attention from models/attention.py::_mha.
// Wrapper and plain PyTorch version: repro_torch/kernels/flash_attention.py.
// The TPU kernel takes any head dim and any float type and computes in
// the inputs' type; two kernels here cover what the models run:
// flash_attention_kernel (bfloat16, wgmma) and flash_attention_f32_kernel
// (float32, plain FFMA), each at Dh in {32, 64, 128, 256}.
//
// bfloat16.  What bounds it on the H100: operations.  A causal prefill at
// S = 8192, 32 heads of 128 does 4 * H * Dh * S(S+1)/2 = 5.5e11 FLOP of
// matrix products per layer but moves only q, k, v and o (~200 MB): ~2,700
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
//   * stages: TMA brings Q once and K and V tiles of BK keys into two rings
//     of STAGES slots each in shared memory (Geo<DH>).  Every slot has a
//     "full" mbarrier, completed by TMA's byte count, and an "empty" one,
//     on which the 256 consumer threads arrive after their last wgmma on
//     it: a K slot is free once its S = Q K^T product retires, a V slot
//     once its P V product does, so the next K tile loads while P V still
//     reads V.  The tensor maps are 4-D over (B, S, NH, Dh), with boxes of
//     (Dh chunk, 1, rows, 1) -- 128 rows for Q, BK for K and V -- and the
//     128-byte swizzle (64-byte for Dh = 32).  Rows past S in a batch row
//     arrive as zeros.  From Dh = 128 on a row is Dh / 64 swizzle atoms of
//     64 columns side by side;
//   * geometry by head dim: BK = 128 keys and 3 stages up to Dh = 128 (Q
//     and 6 tiles: 224 KB at Dh = 128).  At Dh = 256 a 128-key tile is 64
//     KB and Q another 64 KB, so 3 stages would take 448 KB of the 227 KB a
//     block may have: there BK = 64 and 2 stages, Q 64 KB + 2 x (32 + 32)
//     KB = 192 KB.  The smaller tile also keeps the registers: a consumer
//     thread holds O (Dh / 2 = 128 floats), S (BK / 2 = 32) and P in bf16
//     (BK / 8 = 8 registers) under setmaxnreg's 240; with BK = 128 S alone
//     would take 64 more.  ptxas (CUDA 12.8, sm_90a) reports 168 registers
//     for the Dh = 256 instance -- the launch bound's cap; the consumers run
//     under setmaxnreg's 240 -- and no stack frame or spill (chip_smoke.py
//     phase card, `k4_dh256`).  On an NVIDIA H100 80GB HBM3 at 700 W it
//     takes 0.947 ms device at gemma3-1b's global shape (B = 4, S = 8192, 4
//     over 1 heads) against the 0.556 ms bound, 0.288 ms with the window of
//     1024 against 0.130 (phase k4_flash);
//   * products: S = Q K^T is wgmma m64nBKk16 with both operands in shared
//     memory (K-major descriptors, Dh/16 k-steps, a k-step inside a swizzle
//     atom 32 bytes on).  O += P V is wgmma m64nDhk16 with A = P from
//     registers, the S accumulator packed to bf16 in place (its layout is
//     the register-A layout), and B = V in shared memory through an
//     MN-major (transposed) descriptor whose leading offset steps from one
//     64-column atom to the next.  At Dh = 256 the product is two m64n128k16
//     over columns 0-127 and 128-255 (atoms 0-1 and 2-3), whose accumulator
//     halves side by side are the m64n256 layout.  Both accumulate in f32.
//     Tile i's P V runs on the tensor cores while the softmax of tile i + 1
//     runs beside it (FlashAttention-3's intra-warpgroup overlap); the two
//     consumer warpgroups are not made to alternate (ping-pong measured
//     within noise);
//   * tile classes: each key tile is classified once per warpgroup.
//     Interior tiles run no mask arithmetic; only diagonal, window-edge and
//     ragged-end tiles mask.  Tiles that the causal mask or the window
//     empties for the whole query tile are never loaded (at BK = 64 a
//     consumer warpgroup may still see a tile that is empty for its own 64
//     rows: every logit masks, and the correction exp2(m - m) = 1 with
//     p = exp2(-1e30 - m) = 0 leaves O and l as they were);
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
//
// float32.  The TPU kernel computes float32 inputs in float32; the tensor
// cores' TF32 keeps 10 mantissa bits, which would miss the float32
// tolerance (2e-5) by far, so this kernel runs on the FP32 pipes: bound by
// operations at 67 TFLOP/s (the same 4 * H * Dh FLOP per (query, key)
// pair), a tenth of what bf16 has.  It serves the float32 models (the
// smoke variants) and is right first, not fast.  The design: one block of
// 256 threads per (64-row query tile, head, batch row); Q, then each
// 64-key K and V tile, staged in shared memory with float4 loads (rows
// past S zero-filled), rows padded by 4 floats so that a quarter warp's
// 16-byte reads fall in distinct banks; 16 threads share 4 query rows, each
// thread 4 rows x 4 keys of S (float4 dot products over Dh) and 4 rows x
// Dh / 16 columns of O, so a row's maximum and sum are shuffles inside a
// half warp.  The softmax is the TPU kernel's: natural exp (expf), the
// precise tanhf for the soft-cap, -1e30 masking, output acc / max(l, 1e-30).
// No pipeline: the block loads a tile, synchronises, computes, and loads
// the next (at Dh = 256, 211 KB of shared memory and one block per SM;
// 164 registers, no spill).  At gemma3-1b's global shape it takes 18.56 ms
// device against the 8.21 ms bound, 44 % of the FP32 peak; at gemma2-27b's
// 21.58 ms (chip_smoke.py phase k4_flash, H100 80GB HBM3 at 700 W).
//
// Inputs: contiguous (B, S, H, Dh) q and (B, S, KV, Dh) k, v, each 16-byte
// aligned; Dh in {32, 64, 128, 256}; H a multiple of KV.
// cuTensorMapEncodeTiled is a driver function: it is looked up through
// the runtime's driver entry point, so the library links no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // query rows per block: 2 consumer warpgroups of 64
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Shared-memory geometry for one head dimension.  A tile of R rows is
// NCHUNK boxes of (R rows x CHUNK columns), each row ROW_BYTES long and
// swizzled across 8-row atoms by TMA.  Layout: Q, the K ring, the V ring,
// then the barriers full K[s], full V[s], empty K[s], empty V[s], Q.
template <int DH>
struct Geo {
  static constexpr int BK = DH == 256 ? 64 : 128;    // keys per tile
  static constexpr int STAGES = DH == 256 ? 2 : 3;   // K and V tiles in flight, each
  static constexpr int CHUNK = DH < 64 ? DH : 64;
  static constexpr int ROW_BYTES = 2 * CHUNK;        // 64 or 128: the swizzle span
  static constexpr int NCHUNK = DH / CHUNK;
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;       // one K or one V tile
  static constexpr int V_OFF = Q_BYTES + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (4 * STAGES + 1) + 1024;  // + alignment slack
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;      // descriptor: B128 / B64
  static_assert(SMEM <= 232448, "over the 227 KB a block may have");
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
// S (64 x N) = A B^T (+ S when scale_d): A and B K-major in shared memory.
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


__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128) += A B into d[OFF] .. d[OFF + 63]: A (64 x 16 bf16) from
// registers, four per thread in the accumulator layout; B MN-major
// (transposed, trans-b = 1) in shared memory.
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N], const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]),
        "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]),
        "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]),
        "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]),
        "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]),
        "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]),
        "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]),
        "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]),
        "+f"(d[OFF + 46]), "+f"(d[OFF + 47]), "+f"(d[OFF + 48]), "+f"(d[OFF + 49]),
        "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]),
        "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]),
        "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
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


template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BK == 128) {
    wgmma_ss_n128(d, da, db, scale_d);
  } else {
    wgmma_ss_n64(d, da, db, scale_d);
  }
}

// O += P V for one 16-key slice of V at shared address `sv`: its leading
// offset steps from one 64-column atom to the next.  At Dh = 256, two
// n128 products over atoms 0-1 and 2-3.
template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4], uint32_t sv) {
  using G = Geo<DH>;
  auto desc = [](uint32_t addr) {
    return gmma_desc(addr, G::BK * G::ROW_BYTES, 8 * G::ROW_BYTES, G::LAYOUT);
  };
  if constexpr (DH == 256) {
    wgmma_rs_n128<0>(o, a, desc(sv));
    wgmma_rs_n128<64>(o, a, desc(sv + 2 * G::BK * G::ROW_BYTES));
  } else if constexpr (DH == 128) {
    wgmma_rs_n128<0>(o, a, desc(sv));
  } else if constexpr (DH == 64) {
    wgmma_rs_n64(o, a, desc(sv));
  } else {
    wgmma_rs_n32(o, a, desc(sv));
  }
}

// One consumer warpgroup: query rows r_lo .. r_lo + 63 of the block's tile
// against key tiles t_begin .. t_begin + n_tiles - 1 of the rings.
template <int DH>
__device__ __forceinline__ void consume(uint32_t s_q, uint32_t bar, int cw,
                                        bf16* __restrict__ o, int b, int h, int S, int H,
                                        int q0, int t_begin, int n_tiles, int causal, int window,
                                        float cap, float scale) {
  using G = Geo<DH>;
  constexpr int BK = G::BK;
  constexpr int ST = G::STAGES;
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
  const uint32_t s_k = s_q + G::Q_BYTES, s_v = s_q + G::V_OFF;

  float acc[DH / 2];        // O, 64 x DH
  float sc[BK / 2];         // S, then P in f32, 64 x BK
  uint32_t pa[BK / 16][4];  // P in bf16, one register-A fragment per k-step
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, c0 = 1.f, c1 = 1.f;

  // S = Q K^T for the K tile in `stage`: chunk c of Q is BQ rows on, of K
  // BK rows on; a k-step inside an atom moves the start by 32 bytes.
  auto issue_s = [&](int stage) {
    const uint32_t sk = s_k + stage * G::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t c = kk / KSTEPS_CHUNK, w = (kk % KSTEPS_CHUNK) * 32;
      wgmma_qk<BK>(sc, gmma_desc(q_base + c * BQ * G::ROW_BYTES + w, 16, 8 * G::ROW_BYTES, G::LAYOUT),
                   gmma_desc(sk + c * BK * G::ROW_BYTES + w, 16, 8 * G::ROW_BYTES, G::LAYOUT), kk);
    }
    wgmma_commit();
  };
  // O += P V for the V tile in `stage`: V's 16-key slices are 16 rows apart.
  auto issue_pv = [&](int stage) {
    const uint32_t sv = s_v + stage * G::KV_BYTES;
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_pv<DH>(acc, pa[kk], sv + kk * 16 * G::ROW_BYTES);
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
  // Tile i's K and V slots: wait until full, release when read.
  auto wait_k = [&](int i) { mbar_wait(bar + 8 * (i % ST), (i / ST) & 1); };
  auto wait_v = [&](int i) { mbar_wait(bar + 8 * (ST + i % ST), (i / ST) & 1); };
  auto free_k = [&](int i) { mbar_arrive(bar + 8 * (2 * ST + i % ST)); };
  auto free_v = [&](int i) { mbar_arrive(bar + 8 * (3 * ST + i % ST)); };

  // Tile i's P V product runs on the tensor cores while the softmax of tile
  // i + 1 runs beside it (FlashAttention-3's intra-warpgroup overlap).  The
  // loop body is branch-free -- the last tile's P V is peeled off -- so that
  // ptxas can see that wait_group 1 retires the S product, and does not
  // serialise the wgmmas.
  mbar_wait(bar + 8 * 4 * ST, 0);  // Q
  wait_k(0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  free_k(0);
  softmax(t_begin * BK);
  rescale_and_pack();
  for (int i = 0; i + 1 < n_tiles; ++i) {
    wait_k(i + 1);
    wait_v(i);
    issue_s((i + 1) % ST);
    issue_pv(i % ST);
    wgmma_wait<1>();  // S of tile i + 1 is in; P V of tile i still runs
    fence_regs(sc);
    free_k(i + 1);
    softmax((t_begin + i + 1) * BK);
    wgmma_wait<0>();
    fence_regs(acc);
    free_v(i);
    rescale_and_pack();
  }
  wait_v(n_tiles - 1);
  issue_pv((n_tiles - 1) % ST);
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
  constexpr int BK = G::BK;
  constexpr int ST = G::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t s_k = s_q + G::Q_BYTES;    // K slot s at s_k + s KV_BYTES
  const uint32_t s_v = s_q + G::V_OFF;      // V slot s at s_v + s KV_BYTES
  const uint32_t bar = s_q + G::BAR_OFF;    // full K, full V, empty K, empty V: ST each; Q
  const uint32_t full_k = bar, full_v = bar + 8 * ST;
  const uint32_t empty_k = bar + 16 * ST, empty_v = bar + 24 * ST, bar_q = bar + 32 * ST;

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
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMERS * 128);
      mbar_init(empty_v + 8 * s, CONSUMERS * 128);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the rings full, K ahead of V.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = h / (H / KV);
      mbar_expect_tx(bar_q, G::Q_BYTES);
      for (int c = 0; c < G::NCHUNK; ++c)
        tma_load(s_q + c * BQ * G::ROW_BYTES, &tm_q, bar_q, c * G::CHUNK, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        // The (i / ST)-th refill of slot s waits for the consumers'
        // release of the one before it.
        const uint32_t parity = ((i / ST) - 1) & 1;
        const int k0 = (t_begin + i) * BK;
        if (i >= ST) mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, G::KV_BYTES);
        for (int c = 0; c < G::NCHUNK; ++c)
          tma_load(s_k + s * G::KV_BYTES + c * BK * G::ROW_BYTES, &tm_k, full_k + 8 * s,
                   c * G::CHUNK, kvh, k0, b);
        if (i >= ST) mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, G::KV_BYTES);
        for (int c = 0; c < G::NCHUNK; ++c)
          tma_load(s_v + s * G::KV_BYTES + c * BK * G::ROW_BYTES, &tm_v, full_v + 8 * s,
                   c * G::CHUNK, kvh, k0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<DH>(s_q, bar, threadIdx.x / 128 - 1, o, b, h, S, H, q0, t_begin, n_tiles, causal,
                window, cap, scale);
  }
}

// ---------------------------------------------------------------------------
// float32: plain FFMA, shared-memory tiles (see the head of this file).
namespace f32 {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 groups of 16 threads, 4 query rows a group
constexpr int PAD = 4;        // floats after each shared row of Q, K and P

template <int DH>
struct Geo {
  static constexpr int QS = DH + PAD;               // Q and K row stride (floats)
  static constexpr int PS = BK + PAD;               // P row stride
  static constexpr int VEC = DH / 16 < 4 ? DH / 16 : 4;   // O columns a thread loads at once
  static constexpr int NVEC = DH / 16 / VEC;        // ... and how many such runs
  static constexpr int SMEM = 4 * (BQ * QS + BK * QS + BK * DH + BQ * PS);
  static_assert(SMEM <= 232448, "over the 227 KB a block may have");
};

template <int N>
struct Vec;
template <>
struct Vec<2> {
  typedef float2 T;
  __device__ __forceinline__ static void fma(float* acc, float p, float2 v) {
    acc[0] = fmaf(p, v.x, acc[0]);
    acc[1] = fmaf(p, v.y, acc[1]);
  }
};
template <>
struct Vec<4> {
  typedef float4 T;
  __device__ __forceinline__ static void fma(float* acc, float p, float4 v) {
    acc[0] = fmaf(p, v.x, acc[0]);
    acc[1] = fmaf(p, v.y, acc[1]);
    acc[2] = fmaf(p, v.z, acc[2]);
    acc[3] = fmaf(p, v.w, acc[3]);
  }
};

// `rows` rows of DH floats from global memory (row r at src + r * stride,
// rows >= valid as zeros) into shared memory at row stride `ds`.
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, int ds, const float* __restrict__ src,
                                           size_t stride, int rows, int valid) {
  constexpr int V4 = DH / 4;
  for (int e = threadIdx.x; e < rows * V4; e += THREADS) {
    const int r = e / V4, c = 4 * (e % V4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * ds + c) = x;
  }
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int s = 1; s < 16; s <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int s = 1; s < 16; s <<= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int S, int H,
                           int KV, int causal, int window, float cap, float scale) {
  using G = Geo<DH>;
  typedef typename Vec<G::VEC>::T VT;
  extern __shared__ float4 smem_f4[];
  float* s_q = reinterpret_cast<float*>(smem_f4);
  float* s_k = s_q + BQ * G::QS;
  float* s_v = s_k + BK * G::QS;   // unpadded: a group reads 16 consecutive runs of a row
  float* s_p = s_v + BK * DH;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest query tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int grp = threadIdx.x / 16, j = threadIdx.x % 16;
  const int r0 = 4 * grp;  // this thread's rows r0 .. r0 + 3 of the tile
  const bool capped = cap > 0.f;
  const size_t q_stride = static_cast<size_t>(H) * DH, kv_stride = static_cast<size_t>(KV) * DH;

  stage_rows<DH>(s_q, G::QS, q + (static_cast<size_t>(b) * S + q0) * q_stride + h * DH, q_stride,
                 BQ, S - q0);

  float acc[4][DH / 16];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's P and V are read
    const size_t kv_off = (static_cast<size_t>(b) * S + k0) * kv_stride + kvh * DH;
    stage_rows<DH>(s_k, G::QS, k + kv_off, kv_stride, BK, S - k0);
    stage_rows<DH>(s_v, DH, v + kv_off, kv_stride, BK, S - k0);
    __syncthreads();

    // S: rows r0 + r, keys j + 16 i.
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = *reinterpret_cast<const float4*>(s_q + (r0 + r) * G::QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        kv[i] = *reinterpret_cast<const float4*>(s_k + (j + 16 * i) * G::QS + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[r][i] = fmaf(qv[r].x, kv[i].x, s[r][i]);
          s[r][i] = fmaf(qv[r].y, kv[i].y, s[r][i]);
          s[r][i] = fmaf(qv[r].z, kv[i].z, s[r][i]);
          s[r][i] = fmaf(qv[r].w, kv[i].w, s[r][i]);
        }
    }

    // Scale, soft-cap, mask; the online softmax; P to shared memory.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + r0 + r;
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + j + 16 * i;
        float x = s[r][i] * scale;
        if (capped) x = cap * tanhf(x / cap);
        const bool ok = key < S && (!causal || key <= row) && (window <= 0 || row - key < window);
        s[r][i] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[r][i]);
      }
      mx = group_max(mx);
      const float corr = expf(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[r][i] - mx);
        sum += p;
        s_p[(r0 + r) * G::PS + j + 16 * i] = p;
      }
      l[r] = l[r] * corr + sum;  // this thread's share of the row sum
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

    // O += P V: rows r0 + r, columns VEC j + 16 VEC n + (0 .. VEC - 1).
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = *reinterpret_cast<const float4*>(s_p + (r0 + r) * G::PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int n = 0; n < G::NVEC; ++n) {
          const VT vv = *reinterpret_cast<const VT*>(s_v + (kk + u) * DH + G::VEC * (j + 16 * n));
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pu = u == 0 ? p[r].x : u == 1 ? p[r].y : u == 2 ? p[r].z : p[r].w;
            Vec<G::VEC>::fma(&acc[r][G::VEC * n], pu, vv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float inv = 1.f / fmaxf(group_sum(l[r]), 1e-30f);
    const int row = q0 + r0 + r;
    if (row >= S) continue;
    float* out = o + (static_cast<size_t>(b) * S + row) * q_stride + h * DH;
#pragma unroll
    for (int n = 0; n < G::NVEC; ++n) {
      float* dst = out + G::VEC * (j + 16 * n);
#pragma unroll
      for (int x = 0; x < G::VEC; ++x) dst[x] = acc[r][G::VEC * n + x] * inv;
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, int B, int S, int H,
                   int KV, int causal, int window, float cap, float scale, cudaStream_t stream) {
  using G = Geo<DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_f32_kernel<DH><<<grid, THREADS, G::SMEM, stream>>>(q, k, v, o, S, H, KV, causal,
                                                                     window, cap, scale);
  return cudaGetLastError();
}

}  // namespace f32

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
// one box is `chunk` columns of one head for `rows` rows of one batch row.
cudaError_t tensor_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, int B, int S,
                       int NH, int DH, int chunk, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH), static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * DH;
  const cuuint64_t strides[3] = {row, row * NH, row * NH * S};  // bytes, dims 1..3
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(chunk), 1, static_cast<cuuint32_t>(rows), 1};
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
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  cudaError_t err = tensor_map(encode, &mq, q, B, S, H, DH, G::CHUNK, BQ);
  if (err == cudaSuccess) err = tensor_map(encode, &mk, k, B, S, KV, DH, G::CHUNK, G::BK);
  if (err == cudaSuccess) err = tensor_map(encode, &mv, v, B, S, KV, DH, G::CHUNK, G::BK);
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
    case 256: err = launch<256>(qp, kp, vp, op, B, S, H, KV, causal, window, cap, scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The same contract for float32 q, k, v and o.
extern "C" int flash_attention_f32_launch(const void* q, const void* k, const void* v, void* o,
                                          int B, int S, int H, int KV, int DH, int causal,
                                          int window, float cap, float scale, void* stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (DH) {
    case 32: err = f32::launch<32>(qp, kp, vp, op, B, S, H, KV, causal, window, cap, scale, st); break;
    case 64: err = f32::launch<64>(qp, kp, vp, op, B, S, H, KV, causal, window, cap, scale, st); break;
    case 128: err = f32::launch<128>(qp, kp, vp, op, B, S, H, KV, causal, window, cap, scale, st); break;
    case 256: err = f32::launch<256>(qp, kp, vp, op, B, S, H, KV, causal, window, cap, scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
