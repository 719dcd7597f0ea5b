// K1 ocean_p_prefix and K2 ocean_p_topm: the per-round P3 solve of OCEAN.
//
// K1 replaces repro/kernels/ocean_p.py:48 ``_fused_kernel`` (pallas_call at
// :208): all K+1 prefix candidates of the rho-sorted order, each a
// safeguarded-Newton waterfilling (12 outer x 9 inner), and their argmax.
// K2 replaces :232 ``_topm_kernel`` (pallas_call at :481): the top_m
// smallest (rho, client index) pairs of client-order rho, the same sweep on
// that compact row, and the scatter back to client order.
//
// What bounds them on the H100: neither moves more than a few KB per cell,
// so bytes never bound them.  The operations -- per candidate m, about
// 12 * 10 * m evaluations of exp2/division chains -- form a dependency
// chain per candidate (each outer Newton step needs the team sum of the
// previous one), so they are bound by the latency of that chain, far
// above the card's f32 rate.
//
// Both answer with parallelism across candidates as well as cells: one
// warp per candidate (ocean_common.cuh, prefix_sweep_parallel), the
// candidates being independent given the ranked row, so a cell's chain is
// its longest candidate's, not the sum over them.
//
// K1: one block per cell, its rho row in shared memory; at K = 10, 192
// cells x 10 warps fit the card in one wave.  Past the warps one block can
// hold (the register file and 32 warps cap it), a warp walks m = w,
// w + nw, ...
//
// K2 runs at large K with few cells (8 cells x K = 10^4 x top_m = 128 on
// its path), where a block per cell would leave most SMs idle.  So a cell
// is a thread-block cluster of R CTAs.  On that shape R = 8 CTAs of 16
// warps: 128 teams give every candidate its own warp, in one wave.  R = 16
// CTAs of 8 warps, the same 128 teams, read slower on the H100 (0.270
// against 0.232 ms, chip_smoke.py's phase_k2): the longest chain is the
// same, and a larger cluster pays more for its barriers and remote
// searches.  The steps:
//   1. CTA r keeps the top_m smallest keys (rho bits << 32 | index) of its
//      slice [r S, (r + 1) S) of the client row, S = ceil(K_pad / R), in
//      one streaming pass: tiles of keys below the running top_m-th key
//      are appended to a shared buffer that a bitonic sort merges into the
//      sorted running list (one sort per slice at the path's shape).
//   2. Each key's global rank is its own position plus a binary search in
//      every other CTA's list, read from that CTA's shared memory through
//      the cluster (R lanes a key, summed by a shuffle).  Keys of rank <
//      top_m are written to slot rank of every CTA's compact row: the
//      order the sequential (min, lowest index) extraction gives.
//   3. The cluster's R nw warps sweep the compact row's candidates with
//      K2's masking rule, each CTA publishes its best (W, m), and every CTA
//      takes the same lexicographic argmax after a cluster barrier.
//   4. Each CTA zeroed its slice of the output row first; the winning CTA
//      writes its winning warp's row to the winners' client indices.
// R, the warps a CTA and the buffer are chosen on the host
// (kernels/ocean_p.py, topm_launch_shape) from C, K_pad, top_m and the
// occupancy query; every R runs the same kernel.
#include <cooperative_groups.h>

#include "ocean_common.cuh"

using namespace ocean;
namespace cg = cooperative_groups;

namespace {

__global__ void ocean_p_prefix_kernel(const float* __restrict__ scal,
                                      const float* __restrict__ rho,
                                      float* __restrict__ b_out,
                                      float* __restrict__ wm, int K,
                                      int n_cands, int outer, int inner) {
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5;
  float* s_rho = smem;                  // K
  float* s_rows = s_rho + K;            // 2 * nw * K: each warp's b and best rows
  float* s_red = s_rows + 2 * nw * K;   // 64
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const float* sc = scal + (size_t)c * 8;
  SweepParams p;
  p.n0f = sc[0];
  p.delta = sc[1];
  p.v_eta = sc[2];
  p.beta = sc[3];
  p.b_min = sc[4];
  p.scale = sc[5];
  p.kf = (float)K;
  p.outer = outer;
  p.inner = inner;
  for (int i = tid; i < K; i += nt) s_rho[i] = rho[(size_t)c * K + i];
  __syncthreads();
  // Sorted rank r is in the positive region iff r >= n0.
  const int start = (int)fminf(fmaxf(ceilf(p.n0f), 0.f), (float)K);
  float w, m;
  int winner;
  prefix_sweep_parallel(s_rho, K, start, n_cands, p, s_rows, s_red, w, m, winner);
  const float* best = s_rows + (2 * (size_t)winner + 1) * K;
  for (int i = tid; i < K; i += nt) b_out[(size_t)c * K + i] = best[i];
  if (tid == 0) {
    wm[2 * c] = w;
    wm[2 * c + 1] = m;
  }
}

// The keys (topm_key, key_value), the block's bitonic_sort and lower_bound
// are ocean_common.cuh's, shared with K3's wide instances.

// Shared bytes of one K2 CTA: region A (the key list and its append buffer
// of ``cap`` keys while extracting, then each warp's two sweep rows and the
// argmax scratch), the compact row (values, indices), and the CTA's best
// (W, m) and append counter.  kernels/ocean_p.py::topm_smem_bytes mirrors it.
__host__ __device__ inline size_t topm_region_a(int top_m, int nw, int cap) {
  const size_t keys = 8 * ((size_t)top_m + cap);
  const size_t rows = 4 * (2 * (size_t)nw * top_m + 64);
  return keys > rows ? keys : rows;
}
__host__ __device__ inline size_t topm_smem(int top_m, int nw, int cap) {
  return topm_region_a(top_m, nw, cap) + 8 * (size_t)top_m + 16;
}

__global__ void ocean_p_topm_kernel(const float* __restrict__ scal,
                                    const float* __restrict__ rho,
                                    float* __restrict__ b_out,
                                    float* __restrict__ wm, int K, int K_pad,
                                    int top_m, int cap, int outer, int inner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int c = blockIdx.x / R, tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  uint64_t* s_keys = reinterpret_cast<uint64_t*>(smem_raw);  // top_m + cap
  float* s_rows = reinterpret_cast<float*>(smem_raw);        // 2 nw top_m, after phase 2
  float* s_red = s_rows + 2 * (size_t)nw * top_m;            // 64
  float* s_vals = reinterpret_cast<float*>(smem_raw + topm_region_a(top_m, nw, cap));
  int* s_idx = reinterpret_cast<int*>(s_vals + top_m);
  float* s_cta = reinterpret_cast<float*>(s_idx + top_m);    // [W, m]
  int* s_cnt = reinterpret_cast<int*>(s_cta + 2);

  // Phase 1: this slice's top_m smallest keys, in one pass over it.
  const int slice = (K_pad + R - 1) / R;
  const int lo = min(r * slice, K_pad), hi = min(lo + slice, K_pad);
  const float* row = rho + (size_t)c * K_pad;
  float* out = b_out + (size_t)c * K_pad;
  for (int i = lo + tid; i < hi; i += nt) out[i] = 0.f;
  for (int i = tid; i < top_m; i += nt) {
    s_keys[i] = kNoKey;
    s_vals[i] = INFINITY;  // every slot is filled in phase 2; this is a guard
    s_idx[i] = 0;
  }
  if (tid == 0) *s_cnt = 0;
  __syncthreads();
  uint64_t tau = kNoKey;  // the running list's last key
  for (int base = lo; base < hi; base += nt) {
    const int i = base + tid;
    if (i < hi) {
      const uint64_t k = topm_key(row[i], i);
      if (k < tau) s_keys[top_m + atomicAdd(s_cnt, 1)] = k;
    }
    __syncthreads();  // the tile's appends are in
    const int n = *s_cnt;
    __syncthreads();  // every thread has read n before the next append
    // Merge when the next tile might not fit, and after the last one.
    if (n > 0 && (base + nt >= hi || n > cap - nt)) {
      if (tid == 0) *s_cnt = 0;
      bitonic_sort(s_keys, top_m + n);
      tau = s_keys[top_m - 1];
    }
  }
  cluster.sync();  // every CTA's list is complete

  // Phase 2: global ranks.  R lanes a key (R divides 32): lane s counts the
  // keys of CTA s's list below it (its own position for s = r).
  for (int base = 0; base < top_m * R; base += nt) {
    const int t = base + tid, j = t / R, s = t % R;
    const uint64_t key = j < top_m ? s_keys[j] : kNoKey;
    int rank = 0;
    if (key != kNoKey)
      rank = s == r ? j : lower_bound(cluster.map_shared_rank(s_keys, s), top_m, key);
    for (int o = R >> 1; o > 0; o >>= 1) rank += __shfl_xor_sync(0xffffffffu, rank, o);
    if (key != kNoKey && rank < top_m) {  // lane s fills CTA s's compact row
      cluster.map_shared_rank(s_vals, s)[rank] = key_value(key);
      cluster.map_shared_rank(s_idx, s)[rank] = (int)(key & 0xffffffffu);
    }
  }
  cluster.sync();  // compact rows complete; the lists are no longer read

  // Phase 3: the cluster's R nw warps sweep the compact row (candidate m
  // owns slots [0, m)) under K2's rule.  Warp u of CTA r is team u R + r,
  // so each CTA holds candidates of every size and the long ones (m near
  // top_m) spread over all R SMs.
  const float* sc = scal + (size_t)c * 8;
  SweepParams p;
  p.n0f = sc[0];
  p.delta = sc[1];
  p.v_eta = sc[2];
  p.beta = sc[3];
  p.b_min = sc[4];
  p.scale = sc[5];
  p.kf = (float)K;
  p.outer = outer;
  p.inner = inner;
  float w, m;
  int winner;
  prefix_sweep_parallel<32, true>(s_vals, top_m, 0, top_m, p, s_rows, s_red, w, m, winner,
                                  (tid >> 5) * R + r, R * nw);
  if (tid == 0) {
    s_cta[0] = w;
    s_cta[1] = m;
  }
  cluster.sync();
  float bw = 0.f, bm = 0.f;
  int br = 0;
  for (int q = 0; q < R; ++q) {
    const float* o = cluster.map_shared_rank(s_cta, q);
    const float w2 = o[0], m2 = o[1];
    if (q == 0 || w2 > bw || (w2 == bw && m2 < bm)) {
      bw = w2;
      bm = m2;
      br = q;
    }
  }
  cluster.sync();  // no CTA leaves while a neighbour reads its shared memory

  // Phase 4: the winners straight to their client index in the zeroed row.
  if (r == br) {
    const float* best = s_rows + (2 * (size_t)winner + 1) * top_m;
    for (int j = tid; j < top_m; j += nt)
      if ((float)j < bm && isfinite(s_vals[j])) out[s_idx[j]] = best[j];
  }
  if (r == 0 && tid == 0) {
    wm[2 * c] = bw;
    wm[2 * c + 1] = bm;
  }
}

// Shared bytes of K1 with nw warps.
size_t prefix_smem(int K, int nw) { return ((size_t)K * (1 + 2 * (size_t)nw) + 64) * sizeof(float); }

}  // namespace

// K1: one block per cell, one warp per candidate up to what a block holds:
// at most 32 warps (the argmax scratch), the register file's limit
// (threads_for) and the shared rows' limit.
extern "C" int ocean_p_prefix_launch(const float* scal, const float* rho,
                                     float* b, float* wm, int C, int K,
                                     int n_cands, int outer, int inner,
                                     void* stream) {
  const void* fn = (const void*)ocean_p_prefix_kernel;
  int nw = threads_for(fn, 32 * (n_cands > 0 ? n_cands : 1), 1024) / 32;
  const size_t optin = (size_t)smem_optin();
  while (nw > 1 && prefix_smem(K, nw) > optin) --nw;
  const size_t smem = prefix_smem(K, nw);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return (int)err;
  ocean_p_prefix_kernel<<<C, 32 * nw, smem, (cudaStream_t)stream>>>(
      scal, rho, b, wm, K, n_cands, outer, inner);
  return (int)cudaGetLastError();
}

// The current device's per-block shared-memory limit (with opt-in).
extern "C" int smem_optin_bytes() { return smem_optin(); }

// K2's launch shape is chosen on the host (kernels/ocean_p.py): R CTAs a
// cluster (a power of two up to 16), nw warps a CTA, an append buffer of
// cap >= 32 nw keys.
extern "C" long long ocean_p_topm_smem_bytes(int top_m, int nw, int cap) {
  return (long long)topm_smem(top_m, nw, cap);
}

extern "C" int ocean_p_topm_max_threads() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, (const void*)ocean_p_topm_kernel) != cudaSuccess) return 0;
  return attr.maxThreadsPerBlock;
}

namespace {

cudaError_t topm_config(int C, int top_m, int R, int nw, int cap, void* stream,
                        cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (R < 1 || R > 16 || (R & (R - 1)) != 0 || nw < 1 || nw > 32 || cap < 32 * nw)
    return cudaErrorInvalidValue;
  const void* fn = (const void*)ocean_p_topm_kernel;
  const size_t smem = topm_smem(top_m, nw, cap);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  if (R > 8) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)C * R);
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = R;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Clusters of this shape the device holds at once (0 if none fits).
extern "C" int ocean_p_topm_clusters(int top_m, int R, int nw, int cap) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (topm_config(1, top_m, R, nw, cap, nullptr, cfg, attr) != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)ocean_p_topm_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

extern "C" int ocean_p_topm_launch(const float* scal, const float* rho, float* b,
                                   float* wm, int C, int K, int K_pad, int top_m,
                                   int R, int nw, int cap, int outer, int inner,
                                   void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = topm_config(C, top_m, R, nw, cap, stream, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, ocean_p_topm_kernel, scal, rho, b, wm, K, K_pad, top_m, cap,
                           outer, inner);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
