// K3 ocean_traj's wide ranked-row instances without telemetry: past
// K = 2048 ranking="sort", a top-m clip past 2048 and failure_mode
// overprovision, every radio x failure x guard branch with K1's, the
// bisect or the newton sweep, on a ranked row sorted inside the kernel
// (the kernel template and its description are in ocean_traj_wide.cuh;
// ocean_traj_wide_ranked_metrics.cu holds the HasMetrics ones).
#include "ocean_traj_wide.cuh"

// The warps a ranked-row block runs (the static radio, no failure or
// guard; ``solver`` as the launch numbers it), and in *in_smem whether its
// K keys and priorities live in shared memory.
extern "C" int ocean_traj_wide_ranked_warps(int K, int solver, int* in_smem) {
  *in_smem = ranked_in_smem(K, 0) ? 1 : 0;
  switch (solver) {
    case kSolverK1:
      return ranked_teams(wide_fn<false, false, false, kSolverK1, NoMetrics, true>());
    case kSolverBisect:
      return ranked_teams(wide_fn<false, false, false, kSolverBisect, NoMetrics, true>());
    case kSolverGrid:
      return ranked_teams(wide_fn<false, false, false, kSolverGrid, NoMetrics, true>());
    default: return 0;
  }
}

// One launch: every cell's T rounds at any K (OCEAN_TRAJ_PARAMS in
// ocean_traj.cuh; n_cands = K under ranking="sort", min(top_m, K) under
// top-m), with the global scratch ``ranked`` of *floats floats; with
// ``ranked`` null it writes the floats the launch needs (C cells of
// ranked_floats(K, the instance's teams, n_cands)) to *floats and launches
// nothing.  Refuses a telemetry mirror.
extern "C" int ocean_traj_wide_ranked_launch(OCEAN_TRAJ_PARAMS, float* ranked, long long* floats,
                                             void* stream) {
  if (mirror != nullptr) return (int)cudaErrorInvalidValue;
  const RankedScratch rs{ranked, floats};
  return launch_wide_all<NoMetrics, true>(solver, OCEAN_TRAJ_ARGS, NoMetrics{}, C,
                                          (cudaStream_t)stream, guarded != 0, &rs);
}
