// K3 ocean_traj's HasMetrics instances that run the newton solver's sweep
// (ocean_traj.cuh: kSolverGrid, metrics_pass).  Built apart from the other
// sources so that nvcc compiles the instances in parallel; the C interface
// of ocean_traj_metrics.cu.
#include "ocean_traj.cuh"

// The warps a HasMetrics block runs at K clients for a region of
// ``region`` floats (no radio, the newton sweep), and in *in_smem whether the
// region is in shared memory.
extern "C" int ocean_traj_metrics_warps(int K, int failure, int guard, int region, int* in_smem) {
  return traj_metrics_warps<kSolverGrid>(K, failure != 0, guard != 0, region, in_smem);
}

// One launch with telemetry: ocean_traj_launch's parameters, then the
// descriptor's host arrays (make_desc), the (C, region) global scratch and
// a segment launch's seed and raw regions (null for a whole launch).
extern "C" int ocean_traj_metrics_launch(OCEAN_TRAJ_PARAMS, const int* layout, const int* ent,
                                         const float* entf, float* const* outs, float* scratch,
                                         const float* seed, float* raw, void* stream) {
  if (layout[0] < 0 || layout[0] > kMaxEntries || layout[1] < 0 || layout[1] > layout[0])
    return (int)cudaErrorInvalidValue;
  return launch_library<MetricsDesc, kSolverGrid>(
      solver, OCEAN_TRAJ_ARGS, make_desc(layout, ent, entf, outs, scratch, seed, raw), C,
      (cudaStream_t)stream, guarded != 0);
}
