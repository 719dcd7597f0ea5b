"""repro_torch.obs.metrics (the port's telemetry) against the JAX reference.

The reference runs its grids on ``traj="scan"`` with ``solver="bisect"``
(its own fused metrics are not a bitwise oracle of its scan path): a
clean and a dropout scenario x 2 seeds under ocean-u, ocean-a and SMO,
and a guarded drift scenario under ocean-a, with a spec that names every
collector with every reduction.  The port's ``simulate`` gets the
reference grids' own streams (gains, increments, delivery masks), once,
in module fixtures; each metric key is one test case.

* Decisions exact, b within 2e-4 (the seeds are tie-free).
* Integer-valued collectors (and the ratios of integers ``delivery_rate``
  and ``selection_gap``), their histograms and downsampled traces exact.
* Float collectors and every ``mean`` within rtol 2e-4 and atol 1e-6 x the
  collector's histogram span (ROADMAP.md's parity rule): the reference's
  jitted mean multiplies by 1/T, a rounding the port's division does not
  make; a float collector's histogram may move a count only for a value
  within that tolerance of a bin edge.  ``solver_residual`` is each
  package's rounding error of a K-term sum of b that adds to 1: the two
  agree within K 2^-23.
* Inside the port, bit for bit: metrics-on decisions equal metrics-off for
  every policy on scan and fused (the plain K3 on the CPU); fused metrics
  equal scan metrics; ``last`` is the trace's last round and
  ``full_trace_ds`` the trace at ``ds_indices``; a metrics-off grid keeps
  ``GridResult.metrics`` None; ``metrics_replay`` of a trajectory's rows
  gives its own metrics.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Scenario as JScenario  # noqa: E402
from repro.env import EnvSpec as JEnvSpec  # noqa: E402
from repro.guard import GuardSpec as JGuardSpec  # noqa: E402
from repro.obs import MetricsSpec as JMetricsSpec  # noqa: E402
from repro.obs import available_collectors as j_available_collectors  # noqa: E402
from repro.sim import run_grid as j_run_grid  # noqa: E402
from repro_torch.convert import scenario_from_reference  # noqa: E402
from repro_torch.core.ocean import simulate  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.policy import PolicyParams  # noqa: E402
from repro_torch.core.scenario import Scenario  # noqa: E402
from repro_torch.env import EnvSpec  # noqa: E402
from repro_torch.env.failure import TracedFailure  # noqa: E402
from repro_torch.guard import GuardSpec, inject_h2_faults  # noqa: E402
from repro_torch.kernels import ocean_traj as tt  # noqa: E402
from repro_torch.obs import REDUCTIONS, MetricsSpec, get_collector, metric_key  # noqa: E402
from repro_torch.obs.metrics import ds_indices  # noqa: E402
from repro_torch.sim import run_grid  # noqa: E402

T, K, SEEDS = 24, 5, (0, 1)
V = 1e-5
B_ATOL, RTOL = 2e-4, 2e-4
ENTRIES = tuple((n, r) for n in j_available_collectors() for r in REDUCTIONS)
J_SPEC = JMetricsSpec(collect=ENTRIES, hist_bins=8, ds_samples=7)
SPEC = MetricsSpec.from_dict(J_SPEC.to_dict())
KEYS = tuple(metric_key(n, r) for n, r in ENTRIES)
EXACT = {
    "num_selected", "selection_count", "selection_gap", "bmin_active", "delivery_rate",
    "reallocation_count", "fault_count", "demoted_clients", "fallback_rounds", "topm_saturated",
}
J_SCENARIOS = [
    JScenario(name="clean", num_rounds=T, num_clients=K),
    JScenario(name="drop", num_rounds=T, num_clients=K,
              env=JEnvSpec(failure="iid_dropout", failure_params={"p_deliver": 0.7})),
]
J_GUARDED = JScenario(name="drift", num_rounds=T, num_clients=K, pathloss_db=(38.0, 48.0))
GUARD = {"energy_cap": 0.2}
# (reference grid, policy index, the port's eta schedule)
RUNS = (("main", 0, "uniform"), ("main", 1, "ascend"), ("guarded", 0, "ascend"))
# The histogram supports depend only on (T, K) and the budget: one config
# for every run.
SPEC_CFG = JScenario(num_rounds=T, num_clients=K).ocean_config()


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def ref():
    """The reference's two scan grids, run once: numpy leaves."""
    main = j_run_grid(J_SCENARIOS, ["ocean-u", "ocean-a", "smo"], SEEDS, metrics=J_SPEC)
    guarded = j_run_grid([J_GUARDED], ["ocean-a"], SEEDS, metrics=J_SPEC,
                         guard=JGuardSpec(**GUARD))
    out = {}
    for name, res in (("main", main), ("guarded", guarded)):
        out[name] = dict(
            a=_np(res.a), b=_np(res.b), num_selected=_np(res.num_selected),
            h2=_np(res.h2), inc=_np(res.budget_inc),
            failure=None if res.failure_seq is None else (
                _np(res.failure_seq.delivered), _np(res.failure_seq.rate)),
            metrics=[None if m is None else {k: _np(v) for k, v in m.items()}
                     for m in res.metrics],
        )
    return out


def _cells(x):
    return torch.tensor(np.asarray(x, np.float32)).reshape((-1,) + x.shape[2:])


@pytest.fixture(scope="module")
def port(ref):
    """The port's ``simulate`` on each reference run's streams: (decisions,
    metrics) with (S, N, ...) leaves."""
    out = {}
    for grid, p, eta in RUNS:
        r = ref[grid]
        S, N = r["h2"].shape[:2]
        sc = scenario_from_reference((J_SCENARIOS[0] if grid == "main" else J_GUARDED).to_dict())
        cfg = dataclasses.replace(sc.ocean_config(), metrics=SPEC,
                                  guard=None if grid == "main" else GuardSpec(**GUARD))
        failure = None
        if r["failure"] is not None:
            failure = TracedFailure(delivered=_cells(r["failure"][0]),
                                    rate=_cells(r["failure"][1]))
        _, dec, mets = simulate(cfg, _cells(r["h2"]), eta_schedule(eta, T), V,
                                budget_seq=_cells(r["inc"]), failure_seq=failure, device="cpu")
        out[(grid, p)] = (dec, {k: v.reshape((S, N) + v.shape[1:]) for k, v in mets.items()})
    return out


def test_baseline_has_no_metrics_entry_in_either_grid(ref):
    assert ref["main"]["metrics"][2] is None
    res = run_grid([Scenario(name="clean", num_rounds=8, num_clients=4)],
                   ["ocean-u", "smo"], [0], solver="pallas", metrics=SPEC, device="cpu")
    assert res.metrics[1] is None and set(res.metrics[0]) == set(KEYS)


def test_decisions_match_the_reference_scan(ref, port):
    for grid, p, _ in RUNS:
        dec, _ = port[(grid, p)]
        r = ref[grid]
        shape = r["a"].shape[1:]
        assert np.array_equal(dec.a.numpy().reshape(shape), r["a"][p])
        assert np.array_equal(dec.num_selected.numpy().reshape(shape[:-1]),
                              r["num_selected"][p])
        np.testing.assert_allclose(dec.b.numpy().reshape(shape), r["b"][p], rtol=0, atol=B_ATOL)


def _near_edges(x, lo, width, tol):
    r = np.mod(x - lo, width)
    return (r <= tol) | (width - r <= tol)


@pytest.mark.parametrize("key", KEYS)
def test_metric_matches_the_reference_scan(ref, port, key):
    name, red = key.split("/")
    for grid, p, _ in RUNS:
        got = port[(grid, p)][1][key].numpy()
        want = ref[grid]["metrics"][p][key]
        assert got.shape == want.shape, (grid, p)
        lo, hi = get_collector(name).hist_range(SPEC_CFG)
        atol = 1e-6 * (hi - lo)
        if name == "solver_residual":
            # each package's value is the rounding error of its own K-term
            # sum of b (which adds to 1): at most K 2^-23 apart
            atol = K * 2.0 ** -23
        if name in EXACT and red != "mean":
            assert np.array_equal(got, want), (grid, p)
        elif red == "histogram":
            trace = ref[grid]["metrics"][p][metric_key(name, "full_trace")]
            tol = RTOL * np.abs(trace) + atol
            near = _near_edges(trace, lo, (hi - lo) / SPEC.hist_bins, tol)
            near = near.reshape(near.shape[:2] + (-1,)).sum(-1)
            assert np.array_equal(got.sum(-1), want.sum(-1)), (grid, p)
            assert (np.abs(got - want).sum(-1) <= 2 * near).all(), (grid, p)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=f"{grid} {p}")



# -- inside the port ----------------------------------------------------------
T_IN, K_IN = 10, 4
SPEC_IN = MetricsSpec(collect=ENTRIES, hist_bins=6, ds_samples=3)
POLICIES_IN = ["ocean", "ocean-u", "ocean-a", "ocean-d", "ocean-over", "ocean-realloc",
               "select_all", "smo", "amo",
               ("pattern", PolicyParams(counts=torch.full((T_IN,), 2, dtype=torch.int32)))]


def _scen_in():
    return [Scenario(name="clean", num_rounds=T_IN, num_clients=K_IN),
            Scenario(name="drop", num_rounds=T_IN, num_clients=K_IN,
                     env=EnvSpec(failure="iid_dropout", failure_params={"p_deliver": 0.6}))]


@pytest.fixture(scope="module")
def grids_in():
    out = {}
    for traj in ("scan", "fused"):
        for spec in (None, SPEC_IN):
            out[(traj, spec is not None)] = run_grid(
                _scen_in(), POLICIES_IN, [3, 4], solver="pallas", traj=traj, metrics=spec,
                device="cpu")
    return out


@pytest.mark.parametrize("traj", ["scan", "fused"])
def test_metrics_on_decisions_equal_metrics_off(grids_in, traj):
    on, off = grids_in[(traj, True)], grids_in[(traj, False)]
    assert off.metrics is None
    for f in ("a", "b", "e", "num_selected", "energy_spent", "delivered", "q"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert [m is None for m in on.metrics] == [p.startswith(("select_all", "smo", "amo",
                                                             "pattern")) for p in on.policies]


def test_fused_metrics_equal_scan_metrics(grids_in):
    scan, fused = grids_in[("scan", True)], grids_in[("fused", True)]
    for ms, mf in zip(scan.metrics, fused.metrics):
        assert (ms is None) == (mf is None)
        if ms is not None:
            for k in ms:
                assert torch.equal(ms[k], mf[k]), k


def test_last_and_downsampled_traces_agree_with_the_full_trace(grids_in):
    res = grids_in[("scan", True)]
    idx = torch.as_tensor(ds_indices(T_IN, SPEC_IN.ds_samples))
    for m in res.metrics:
        if m is None:
            continue
        for name in SPEC_IN.names:
            trace = m[metric_key(name, "full_trace")]
            assert torch.equal(m[metric_key(name, "last")], trace[:, :, -1])
            assert torch.equal(m[metric_key(name, "full_trace_ds")], trace[:, :, idx])
            assert torch.equal(m[metric_key(name, "histogram")].sum(-1),
                               torch.full(trace.shape[:2], float(trace[0, 0].numel())))


def test_grid_cell_slices_the_metrics(grids_in):
    res = grids_in[("scan", True)]
    cell = res.cell("ocean-a", "drop", 4)
    p = res.policies.index("ocean-a")
    assert set(cell.metrics) == set(KEYS)
    assert torch.equal(cell.metrics["queue/full_trace"], res.metrics[p]["queue/full_trace"][1, 1])
    assert res.cell("smo", "drop", 4).metrics is None
    assert grids_in[("scan", False)].cell("ocean-a", "drop", 4).metrics is None


@pytest.mark.parametrize("mode", ["plain", "overprovision", "reallocate", "guard"])
def test_metrics_replay_of_the_rows_gives_the_trajectory_metrics(mode):
    """``metrics_replay`` (the plain version chip_smoke holds the HasMetrics
    kernel to) rebuilds the telemetry from a trajectory's rows bit for bit."""
    C, t, k = 2, 9, 4
    rng = np.random.default_rng(5)
    h2 = rng.exponential(size=(C, t, k)).astype(np.float32) * 2.5e-4
    cfg = dataclasses.replace(Scenario(num_rounds=t, num_clients=k).ocean_config(),
                              solver="pallas", frame_len=4, metrics=SPEC_IN)
    failure = None
    if mode == "guard":
        cfg = dataclasses.replace(cfg, guard=GuardSpec(energy_cap=0.5))
        h2 = np.stack([inject_h2_faults(h, 7 + i, num_nan=1, num_zero=1)[0]
                       for i, h in enumerate(h2)])
    else:
        cfg = dataclasses.replace(cfg, failure_mode=mode)
        failure = TracedFailure(
            delivered=torch.tensor((rng.random((C, t, k)) < 0.6).astype(np.float32)),
            rate=torch.full((C, k), 0.6))
    h2 = torch.tensor(h2)
    v = torch.full((C, t), V)
    eta = eta_schedule("ascend", t).expand(C, t).contiguous()
    inc = torch.full_like(h2, 0.15 / t)
    out = tt.ocean_traj_plain(cfg, h2, v, eta, inc, failure=failure)
    rep = tt.metrics_replay(cfg, out, v, eta, inc)
    for key in rep:
        assert torch.equal(out.metrics[key], rep[key]), key
    tt.check_metrics_replay(cfg, out.metrics, out, v, eta, inc)
    planted = dict(out.metrics, **{"queue/histogram": out.metrics["queue/histogram"].roll(1, -1)})
    with pytest.raises(AssertionError, match="queue/histogram"):
        tt.check_metrics_replay(cfg, planted, out, v, eta, inc)
