// K3 ocean_traj: the instances without telemetry that run K1's Newton sweep
// (solver "pallas", "pallas_tiled") or the bisect sweep (the kernel
// template and its description are in ocean_traj.cuh; ocean_traj_grid.cu
// holds the newton solver's instances, ocean_traj_metrics*.cu the
// HasMetrics ones).
#include "ocean_traj.cuh"

// The warps a K3 block runs at K clients (the instance without failures,
// or with them; no guard, K1's sweep).
extern "C" int ocean_traj_warps(int K, int failure) {
  return traj_warps<kSolverK1>(K, failure != 0);
}

// One launch: every cell's T rounds (OCEAN_TRAJ_PARAMS in ocean_traj.cuh).
extern "C" int ocean_traj_launch(OCEAN_TRAJ_PARAMS, void* stream) {
  return launch_library<NoMetrics, kSolverK1, kSolverBisect>(
      solver, OCEAN_TRAJ_ARGS, NoMetrics{}, C, (cudaStream_t)stream, guarded != 0);
}
