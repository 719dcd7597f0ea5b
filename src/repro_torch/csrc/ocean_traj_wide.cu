// K3 ocean_traj's wide instances without telemetry: ranking="topm" past
// K = 2048, every radio x failure x guard branch with K1's, the bisect or
// the newton sweep (the kernel template and its description are in
// ocean_traj_wide.cuh; ocean_traj_wide_metrics.cu holds the HasMetrics
// ones).
#include "ocean_traj_wide.cuh"

// The warps a wide block runs at a clip of n_cands candidates (the static
// radio, no failure or guard; ``solver`` as the launch numbers it).
extern "C" int ocean_traj_wide_warps(int n_cands, int solver) {
  switch (solver) {
    case kSolverK1:
      return wide_teams(wide_fn<false, false, false, kSolverK1, NoMetrics>(), n_cands, false, 0);
    case kSolverBisect:
      return wide_teams(wide_fn<false, false, false, kSolverBisect, NoMetrics>(), n_cands, false,
                        0);
    case kSolverGrid:
      return wide_teams(wide_fn<false, false, false, kSolverGrid, NoMetrics>(), n_cands, false, 0);
    default: return 0;
  }
}

// One launch: every cell's T rounds under ranking="topm" at any K
// (OCEAN_TRAJ_PARAMS in ocean_traj.cuh; n_cands = min(top_m, K) is the
// list's length).  Refuses failure_mode overprovision and a telemetry
// mirror.
extern "C" int ocean_traj_wide_launch(OCEAN_TRAJ_PARAMS, void* stream) {
  if (mirror != nullptr) return (int)cudaErrorInvalidValue;
  return launch_wide_all(solver, OCEAN_TRAJ_ARGS, NoMetrics{}, C, (cudaStream_t)stream,
                         guarded != 0);
}
