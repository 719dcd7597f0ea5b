// K3 ocean_traj's HasMetrics instances: the whole trajectory with a
// MetricsSpec's telemetry collected inside the kernel, round by round
// (ocean_traj.cuh, metrics_pass).  Built apart from ocean_traj.cu so that
// nvcc compiles the two halves' 32 instances each in parallel.
#include "ocean_traj.cuh"

namespace {

// The descriptor of one launch from its host arrays: ``layout`` holds n,
// n_client, cum, cnt, last, gsum, gn, region, stride, bins; per entry j
// ``ent[3j..3j+2]`` the collector, the reduction and the region offset,
// ``entf[2j..2j+1]`` the histogram's lo and bin width, ``outs[j]`` the
// output; ``seed``/``raw`` a segment launch's (C, region + 4) region and
// counters in and out (null for a whole launch).
MetricsDesc make_desc(const int* layout, const int* ent, const float* entf, float* const* outs,
                      float* scratch, const float* seed, float* raw) {
  MetricsDesc md{};
  md.n = layout[0];
  md.n_client = layout[1];
  md.cum = layout[2];
  md.cnt = layout[3];
  md.last = layout[4];
  md.gsum = layout[5];
  md.gn = layout[6];
  md.region = layout[7];
  md.stride = layout[8];
  md.bins = layout[9];
  md.scratch = scratch;
  md.seed = seed;
  md.raw = raw;
  for (int j = 0; j < md.n; ++j) {
    md.col[j] = ent[3 * j];
    md.red[j] = ent[3 * j + 1];
    md.off[j] = ent[3 * j + 2];
    md.lo[j] = entf[2 * j];
    md.width[j] = entf[2 * j + 1];
    md.out[j] = outs[j];
  }
  return md;
}

}  // namespace

// The warps a HasMetrics block runs at K clients for a region of
// ``region`` floats (no radio, K1's sweep), and in *in_smem whether the
// region is in shared memory.
extern "C" int ocean_traj_metrics_warps(int K, int failure, int guard, int region, int* in_smem) {
  const int P = sort_slots(K);
  MetricsDesc md{};
  md.region = region;
  const int NT = K <= kHalfWarpMaxK ? 16 : 32;
  place_region(md, K, P, NT, failure != 0, guard != 0);
  *in_smem = md.in_smem;
  const size_t x = metrics_smem(md);
  int teams;
  if (NT == 16) {
    teams = failure ? (guard ? traj_teams<16, false, true, true, false, MetricsDesc>(K, P, x)
                             : traj_teams<16, false, true, false, false, MetricsDesc>(K, P, x))
                    : (guard ? traj_teams<16, false, false, true, false, MetricsDesc>(K, P, x)
                             : traj_teams<16, false, false, false, false, MetricsDesc>(K, P, x));
    return teams / 2;
  }
  return failure ? (guard ? traj_teams<32, false, true, true, false, MetricsDesc>(K, P, x)
                          : traj_teams<32, false, true, false, false, MetricsDesc>(K, P, x))
                 : (guard ? traj_teams<32, false, false, true, false, MetricsDesc>(K, P, x)
                          : traj_teams<32, false, false, false, false, MetricsDesc>(K, P, x));
}

// One launch with telemetry: ocean_traj_launch's parameters, then the
// descriptor's host arrays (make_desc), the (C, region) global scratch and
// a segment launch's seed and raw regions (null for a whole launch).
extern "C" int ocean_traj_metrics_launch(OCEAN_TRAJ_PARAMS, const int* layout, const int* ent,
                                         const float* entf, float* const* outs, float* scratch,
                                         const float* seed, float* raw, void* stream) {
  if (layout[0] < 0 || layout[0] > kMaxEntries || layout[1] < 0 || layout[1] > layout[0])
    return (int)cudaErrorInvalidValue;
  return launch_any(OCEAN_TRAJ_ARGS, make_desc(layout, ent, entf, outs, scratch, seed, raw), C,
                    (cudaStream_t)stream, guarded != 0, bisect != 0);
}
