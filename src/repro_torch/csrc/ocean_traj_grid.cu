// K3 ocean_traj: the instances without telemetry that run the newton
// solver's sweep (kSolverGrid: the per-round seed grid, then GridCandidate;
// ocean_traj.cuh).  Built apart from ocean_traj.cu so that nvcc compiles
// the instances in parallel; the same C interface.
#include "ocean_traj.cuh"

// The warps a newton K3 block runs at K clients (no guard).
extern "C" int ocean_traj_warps(int K, int failure) {
  return traj_warps<kSolverGrid>(K, failure != 0);
}

// One launch: every cell's T rounds (OCEAN_TRAJ_PARAMS in ocean_traj.cuh).
extern "C" int ocean_traj_launch(OCEAN_TRAJ_PARAMS, void* stream) {
  return launch_library<NoMetrics, kSolverGrid>(solver, OCEAN_TRAJ_ARGS, NoMetrics{}, C,
                                                (cudaStream_t)stream, guarded != 0);
}
