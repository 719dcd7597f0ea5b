// K3 ocean_traj's wide HasMetrics instances: ranking="topm" past K = 2048
// with a MetricsSpec's telemetry collected inside the kernel, round by
// round (ocean_traj_wide.cuh; metrics_pass in ocean_traj.cuh), the
// per-cell region in the global scratch.  Built apart from
// ocean_traj_wide.cu so that nvcc compiles the instances in parallel.
#include "ocean_traj_wide.cuh"

// One launch with telemetry: ocean_traj_wide_launch's parameters, then the
// descriptor's host arrays (make_desc), the (C, region) global scratch and
// a segment launch's seed and raw regions (null for a whole launch).
extern "C" int ocean_traj_wide_metrics_launch(OCEAN_TRAJ_PARAMS, const int* layout,
                                              const int* ent, const float* entf,
                                              float* const* outs, float* scratch,
                                              const float* seed, float* raw, void* stream) {
  if (layout[0] < 0 || layout[0] > kMaxEntries || layout[1] < 0 || layout[1] > layout[0])
    return (int)cudaErrorInvalidValue;
  return launch_wide_all(solver, OCEAN_TRAJ_ARGS,
                         make_desc(layout, ent, entf, outs, scratch, seed, raw), C,
                         (cudaStream_t)stream, guarded != 0);
}
