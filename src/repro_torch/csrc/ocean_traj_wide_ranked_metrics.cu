// K3 ocean_traj's wide ranked-row HasMetrics instances: past K = 2048
// ranking="sort", a top-m clip past 2048 and failure_mode overprovision
// with a MetricsSpec's telemetry collected inside the kernel, round by
// round (ocean_traj_wide.cuh; metrics_pass in ocean_traj.cuh), the
// per-cell region in the global scratch.  Built apart from
// ocean_traj_wide_ranked.cu so that nvcc compiles the instances in
// parallel.
#include "ocean_traj_wide.cuh"

// One launch with telemetry: ocean_traj_wide_ranked_launch's parameters
// but the stream, then the descriptor's host arrays (make_desc), the
// (C, region) global scratch, a segment launch's seed and raw regions
// (null for a whole launch), the ranked row's scratch and its size (as
// ocean_traj_wide_ranked_launch takes them: a null scratch asks for the
// size) and the stream.
extern "C" int ocean_traj_wide_ranked_metrics_launch(OCEAN_TRAJ_PARAMS, const int* layout,
                                                     const int* ent, const float* entf,
                                                     float* const* outs, float* scratch,
                                                     const float* seed, float* raw, float* ranked,
                                                     long long* floats, void* stream) {
  if (layout[0] < 0 || layout[0] > kMaxEntries || layout[1] < 0 || layout[1] > layout[0])
    return (int)cudaErrorInvalidValue;
  const RankedScratch rs{ranked, floats};
  return launch_wide_all<MetricsDesc, true>(
      solver, OCEAN_TRAJ_ARGS, make_desc(layout, ent, entf, outs, scratch, seed, raw), C,
      (cudaStream_t)stream, guarded != 0, &rs);
}
