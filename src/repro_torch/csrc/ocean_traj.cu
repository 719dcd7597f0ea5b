// K3 ocean_traj: the instances without telemetry (the kernel template and
// its description are in ocean_traj.cuh; ocean_traj_metrics.cu holds the
// HasMetrics instances).
#include "ocean_traj.cuh"

// The warps a K3 block runs at K clients (the instance without failures,
// or with them; no guard, K1's sweep).
extern "C" int ocean_traj_warps(int K, int failure) {
  const int P = sort_slots(K);
  if (K <= kHalfWarpMaxK)
    return (failure ? traj_teams<16, false, true, false, false, NoMetrics>(K, P, 0)
                    : traj_teams<16, false, false, false, false, NoMetrics>(K, P, 0)) / 2;
  return failure ? traj_teams<32, false, true, false, false, NoMetrics>(K, P, 0)
                 : traj_teams<32, false, false, false, false, NoMetrics>(K, P, 0);
}

// One launch: every cell's T rounds (OCEAN_TRAJ_PARAMS in ocean_traj.cuh).
extern "C" int ocean_traj_launch(OCEAN_TRAJ_PARAMS, void* stream) {
  return launch_any(OCEAN_TRAJ_ARGS, NoMetrics{}, C, (cudaStream_t)stream, guarded != 0,
                    bisect != 0);
}
