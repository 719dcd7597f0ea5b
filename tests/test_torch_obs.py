"""repro_torch.obs (the spec, the registry, spans and run manifests) against
the JAX reference ``repro.obs``: the same registry, the same eager
validation, payloads that cross over both ways, and manifests the
reference reads."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import OceanConfig as JOceanConfig  # noqa: E402
from repro.core import RadioParams as JRadioParams  # noqa: E402
from repro.core import Scenario as JScenario  # noqa: E402
from repro.core.selection import _RHO_ZERO_TOL as J_SEL_TOL  # noqa: E402
from repro.obs import MetricsSpec as JMetricsSpec  # noqa: E402
from repro.obs import collector_table as j_collector_table  # noqa: E402
from repro.obs import get_collector as j_get_collector  # noqa: E402
from repro.obs import read_manifest as j_read_manifest  # noqa: E402
from repro.obs import runs_in_manifest as j_runs_in_manifest  # noqa: E402
from repro.obs import solver_effort as j_solver_effort  # noqa: E402
from repro.obs.manifest import MODULE_RECORD_KEYS as J_MODULE_KEYS  # noqa: E402
from repro.obs.manifest import RUN_RECORD_KEYS as J_RUN_KEYS  # noqa: E402
from repro.obs.manifest import SUMMARY_RECORD_KEYS as J_SUMMARY_KEYS  # noqa: E402
from repro_torch.convert import scenario_from_reference  # noqa: E402
from repro_torch.core.energy import RadioParams  # noqa: E402
from repro_torch.core.ocean import OceanConfig, simulate  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.scenario import Scenario  # noqa: E402
from repro_torch.core.selection import _RHO_ZERO_TOL as SEL_TOL  # noqa: E402
from repro_torch.core.selection import ocean_p  # noqa: E402
from repro_torch.kernels.ocean_p import INNER_ITERS, OUTER_ITERS  # noqa: E402
from repro_torch.kernels.ocean_traj import KERNEL_COLLECTORS, _metrics_descriptor  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    FULL_TRACE_ELEM_CAP,
    REDUCTIONS,
    SPANS,
    ManifestWriter,
    MetricsSpec,
    SpanRecorder,
    available_collectors,
    collector_table,
    get_collector,
    read_manifest,
    solver_effort,
    trace_span,
    wall_span,
)
from repro_torch.obs import manifest as port_manifest  # noqa: E402
from repro_torch.obs.metrics import _RHO_ZERO_TOL as OBS_TOL  # noqa: E402
from repro_torch.obs.spans import set_trace_spans  # noqa: E402
from repro_torch.sim import GridEngine  # noqa: E402

T, K = 12, 5
ALL = tuple((n, r) for n in available_collectors() for r in REDUCTIONS)


def _cfg(**kw):
    return OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(), **kw)


def test_registry_matches_the_reference():
    assert collector_table() == j_collector_table()
    assert len(available_collectors()) == 19
    assert sorted(KERNEL_COLLECTORS) == list(available_collectors())
    jcfg = JOceanConfig(num_clients=K, num_rounds=T, radio=JRadioParams(),
                        energy_budget_j=(0.1, 0.2, 0.3, 0.2, 0.1))
    cfg = _cfg(energy_budget_j=(0.1, 0.2, 0.3, 0.2, 0.1))
    for name in available_collectors():
        assert get_collector(name).shape(K) == j_get_collector(name).shape(K)
        assert get_collector(name).hist_range(cfg) == j_get_collector(name).hist_range(jcfg)


@pytest.mark.parametrize("bad,match", [
    ((("no_such", "last"),), "unknown metrics collector"),
    ((("queue", "median"),), "unknown metrics reduction"),
    ((("queue", "last"), ("queue", "last")), "duplicate metrics entry"),
])
def test_spec_rejects_bad_entries_eagerly(bad, match):
    with pytest.raises(ValueError, match=match):
        MetricsSpec(collect=bad)
    with pytest.raises(ValueError, match=match):
        JMetricsSpec(collect=bad)


def test_spec_parses_and_rejects_malformed_strings_and_knobs():
    assert MetricsSpec.of("queue:full_trace", "lyapunov:mean").collect == (
        ("queue", "full_trace"), ("lyapunov", "mean"))
    with pytest.raises(ValueError, match="collector:reduction"):
        MetricsSpec.of("queue")
    with pytest.raises(ValueError, match="hist_bins"):
        MetricsSpec.of("queue:histogram", hist_bins=1)
    with pytest.raises(ValueError, match="ds_samples"):
        MetricsSpec.of("queue:full_trace_ds", ds_samples=0)


def test_full_trace_cap_raises_at_config_and_scenario_time():
    k = 1 << 12
    t = FULL_TRACE_ELEM_CAP // k + 1
    spec = MetricsSpec.of("queue:full_trace")
    with pytest.raises(ValueError, match="FULL_TRACE_ELEM_CAP"):
        OceanConfig(num_clients=k, num_rounds=t, radio=RadioParams(b_min=1e-5), metrics=spec)
    with pytest.raises(ValueError, match="FULL_TRACE_ELEM_CAP"):
        Scenario(num_clients=k, num_rounds=t, radio=RadioParams(b_min=1e-5), metrics=spec)
    # bounded reductions and the downsampled trace stay under the cap
    MetricsSpec.of("queue:mean", "queue:full_trace_ds", "lyapunov:full_trace").validate(t, k)
    with pytest.raises(TypeError, match="MetricsSpec"):
        _cfg(metrics=object())


def test_spec_and_scenario_round_trip_from_the_reference_payload():
    jspec = JMetricsSpec.of("queue:full_trace", "lyapunov_drift:mean", "num_selected:histogram",
                            hist_bins=12, ds_samples=9)
    d = json.loads(json.dumps(jspec.to_dict()))
    assert MetricsSpec.from_dict(d).to_dict() == d
    jsc = JScenario(name="m", num_rounds=T, num_clients=K, metrics=jspec)
    payload = json.loads(json.dumps(jsc.to_dict()))
    sc = scenario_from_reference(payload)
    assert sc.metrics == MetricsSpec.from_dict(d)
    assert sc.to_dict() == payload
    assert JScenario.from_dict(sc.to_dict()).to_dict() == payload
    # metrics-free payloads carry no key, as before the field existed
    assert "metrics" not in Scenario().to_dict()
    assert Scenario.from_json(sc.to_json()) == sc
    assert hash(sc.metrics) == hash(MetricsSpec.from_dict(d))


def test_grid_rejects_heterogeneous_specs():
    a = Scenario(name="a", num_rounds=T, num_clients=K, metrics=MetricsSpec.of("queue:last"))
    b = Scenario(name="b", num_rounds=T, num_clients=K, metrics=MetricsSpec.of("queue:mean"))
    with pytest.raises(ValueError, match="grid-incompatible.*metrics"):
        GridEngine([a, b], ["ocean"], device="cpu")
    # the engine's override replaces the scenarios' (agreeing) spec
    eng = GridEngine([a, dataclasses.replace(b, metrics=a.metrics)], ["ocean"],
                     metrics=MetricsSpec.of("lyapunov:last"), device="cpu")
    assert eng.cfg.metrics == MetricsSpec.of("lyapunov:last")
    with pytest.raises(TypeError, match="MetricsSpec"):
        GridEngine([Scenario(name="c", num_rounds=T, num_clients=K)], ["ocean"],
                   metrics=object(), device="cpu")


def test_simulate_returns_the_metrics_as_a_third_element_only_with_a_spec():
    h2 = torch.full((2, T, K), 2.5e-4)
    eta = eta_schedule("uniform", T)
    for traj in ("scan", "fused"):
        cfg = _cfg(solver="pallas", traj=traj)
        assert len(simulate(cfg, h2, eta, 1e-5, device="cpu")) == 2
        st, dec, mets = simulate(dataclasses.replace(cfg, metrics=MetricsSpec(collect=ALL)),
                                 h2, eta, 1e-5, device="cpu")
        assert mets["queue/full_trace"].shape == (2, T, K)
        assert mets["lyapunov/histogram"].shape == (2, 32)
        assert mets["num_selected/full_trace_ds"].shape == (2, T)


def test_rho_zero_tol_mirrors_selection():
    assert OBS_TOL == SEL_TOL == J_SEL_TOL


@pytest.mark.parametrize("solver", ["bisect", "pallas"])
def test_solver_effort_matches_the_reference(solver):
    """The same keys as the reference; ``bisect``'s budgets are the
    reference's, ``pallas`` reports the port's K1/K3 sweep (12 x 9 Newton
    steps from the geometric-mean seed), where the reference reports its
    newton table."""
    jcfg = JOceanConfig(num_clients=K, num_rounds=T, radio=JRadioParams(), solver=solver)
    mine, ref = solver_effort(_cfg(solver=solver)), j_solver_effort(jcfg)
    assert set(mine) == set(ref)
    if solver == "bisect":
        assert mine == ref
    else:
        assert (mine["outer_iters"], mine["inner_iters"], mine["seed_grid"]) == (
            OUTER_ITERS, INNER_ITERS, 0)
        assert {k: mine[k] for k in ("solver", "ranking")} == {
            k: ref[k] for k in ("solver", "ranking")}


def test_spans_name_work_on_cpu_torch():
    """No NVTX call reaches a CPU-only torch; the spans name the port's
    phases in a profiler trace and never change numerics."""
    assert not torch.cuda.is_available()
    with trace_span("ocean/rank"):
        x = torch.ones(3) + 1
    assert torch.equal(x, torch.full((3,), 2.0))

    @trace_span("p4/test")
    def f(y):
        return y * 2

    assert torch.equal(f(x), torch.full((3,), 4.0))
    q = torch.tensor([[0.0, 0.05, 0.1, 0.02, 0.3]])
    h2 = torch.full((1, K), 2.5e-4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for solver in ("bisect", "newton"):
            ocean_p(q, h2, 1e-5, 1.0, RadioParams(), outer_iters=2, inner_iters=2,
                    solver=solver)
    names = {e.key for e in prof.key_averages()}
    assert {"ocean/rank", "ocean/p4_solve/bisect", "p4/bisect/candidate_sweep",
            "ocean/p4_solve/newton", "p4/newton/grid_seed", "p4/newton/polish"} <= names
    prev = set_trace_spans(False)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace_span("ocean/rank"):
                torch.ones(2)
        assert "ocean/rank" not in {e.key for e in prof.key_averages()}
    finally:
        set_trace_spans(prev)


def test_wall_span_records_even_on_exception():
    rec = SpanRecorder()
    with wall_span("phase", recorder=rec):
        pass
    with pytest.raises(RuntimeError):
        with wall_span("phase", recorder=rec):
            raise RuntimeError("boom")
    snap = rec.snapshot()
    assert len(snap["phase"]) == 2 and all(s >= 0 for s in snap["phase"])
    rows = rec.drain()
    assert rows[0]["name"] == "phase" and rows[0]["count"] == 2
    assert rec.drain() == []
    SPANS.drain()


def test_port_manifest_reads_in_the_reference(tmp_path):
    assert port_manifest.SCHEMA_VERSION == 1
    assert port_manifest.MODULE_RECORD_KEYS == J_MODULE_KEYS
    assert port_manifest.RUN_RECORD_KEYS == J_RUN_KEYS
    assert port_manifest.SUMMARY_RECORD_KEYS == J_SUMMARY_KEYS
    path = str(tmp_path / "m.jsonl")
    mw = ManifestWriter(path, argv=["--only", "grid"], config={"seeds": 2})
    mw.start(profile_dir=None)
    with wall_span("grid"):
        pass
    mw.module("grid", ok=True, runtime_s=1.5,
              rows=[{"metric": "CLAIM", "value": "PASS", "note": "rate"}], spans=SPANS.drain())
    mw.summary(ok=True)
    recs = j_read_manifest(path)
    assert recs == read_manifest(path)
    run, mod, summ = recs
    assert tuple(sorted(run)) == tuple(sorted(J_RUN_KEYS))
    assert tuple(sorted(mod)) == tuple(sorted(J_MODULE_KEYS))
    assert tuple(sorted(summ)) == tuple(sorted(J_SUMMARY_KEYS))
    assert run["backend"] == "cpu" and run["jax_version"] is None
    assert mod["claims"] == [{"description": "rate", "ok": True}]
    assert [s["name"] for s in mod["spans"]] == ["grid"]
    assert list(j_runs_in_manifest(recs)) == [run["run_id"]]


def test_kernel_descriptor_lays_out_disjoint_regions():
    """The launch descriptor of the richest spec: the per-client entries
    first; state rows and per-entry accumulators tile the cell's region
    without overlap."""
    spec = MetricsSpec(collect=ALL, hist_bins=7, ds_samples=4)
    cfg = _cfg(solver="pallas", traj="fused", metrics=spec)
    ml = _metrics_descriptor(cfg, 3, torch.device("cpu"))
    n, n_client, cum, cnt, last, gsum, gn, region, stride, bins = list(ml.layout)
    assert (n, n_client, stride, bins) == (len(ALL), 25, 3, 7)
    spans = [(cum, K), (cnt, K), (last, K), (gsum, K), (gn, K)]
    for j in range(n):
        name = KERNEL_COLLECTORS[ml.ent[3 * j]]
        red = REDUCTIONS[ml.ent[3 * j + 1]]
        assert (j < n_client) == bool(get_collector(name).shape(K))
        off = ml.ent[3 * j + 2]
        if red == "mean":
            spans.append((off, K if get_collector(name).shape(K) else 1))
        elif red == "histogram":
            spans.append((off, 7))
        else:
            assert off == -1
    cover = np.zeros(region, int)
    for o, w in spans:
        cover[o:o + w] += 1
    assert (cover == 1).all()
    assert ml.out["queue/full_trace"].shape == (3, T, K)
    assert ml.out["lyapunov/full_trace_ds"].shape == (3, 4)  # rounds 0, 3, 6, 9
