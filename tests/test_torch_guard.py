"""repro_torch.guard (guarded OCEAN) against the JAX reference ``repro.guard``.

Both packages get the same numpy inputs: the reference's sampled gains and
the same ``inject_h2_faults`` output (a numpy generator, so both corrupt
the same cells with the same values).  The reference runs on its scan path
with ``bisect``; the port on ``scan`` and on ``fused`` (on the CPU the
fused path is ``ocean_traj_plain``).

* Counters: ``fault_count``/``demoted``/``fallback`` exact.
* Decisions, teacher-forced on the reference's queues: exact outside near
  ties (the best and runner-up prefix W within 2e-4 |W*|), b within 2e-4.
* Inside the port: a guard that never fires and chaos plus the fallback
  hold bit for bit (scan against scan, fused against fused).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.ocean import _failure_adjust as j_failure_adjust  # noqa: E402
from repro.core.ocean import simulate as j_simulate  # noqa: E402
from repro.core.scenario import Scenario as JScenario  # noqa: E402
from repro.core.selection import ocean_p as j_ocean_p  # noqa: E402
from repro.guard import GuardSpec as JGuard  # noqa: E402
from repro.guard import inject_h2_faults as j_inject  # noqa: E402
from repro.guard import register_chaos_solver as j_register_chaos  # noqa: E402
from repro.guard import screen_streams as j_screen  # noqa: E402
from repro_torch.convert import scenario_from_reference, state_from_reference  # noqa: E402
from repro_torch.core.ocean import (  # noqa: E402
    _failure_adjust,
    _guard_admission,
    ocean_round,
    simulate,
)
from repro_torch.core.scenario import Scenario  # noqa: E402
from repro_torch.core.selection import RHO_DEMOTED, ocean_p, prefix_inputs, priorities  # noqa: E402
from repro_torch.guard import (  # noqa: E402
    DEFAULT_RESIDUAL_TOL,
    FAULT_KINDS,
    GuardSpec,
    inject_h2_faults,
    register_chaos_solver,
    screen_streams,
    starved_newton_budgets,
)
from repro_torch.kernels import ocean_p as tk  # noqa: E402
from repro_torch.sim import GridEngine  # noqa: E402

T, K = 24, 6
SC = Scenario(name="guard-base", num_rounds=T, num_clients=K)
JSC = JScenario(name="guard-base", num_rounds=T, num_clients=K)
H2 = np.asarray(JSC.sample_channel(3), np.float32)
ETA = np.asarray(JSC.eta_seq(), np.float32)
V = 1e-5
B_ATOL, W_RTOL = 2e-4, 2e-4
GUARD_FIELDS = ("fault_count", "demoted", "fallback")
FAULTS = dict(num_nan=2, num_inf=3, num_zero=2, num_negative=2, num_subnormal=3)

CHAOS_BISECT_OBJ = register_chaos_solver("bisect", kind="objective").name
CHAOS_PALLAS_OBJ = register_chaos_solver("pallas", kind="objective").name
CHAOS_BISECT_BUDGET = register_chaos_solver("bisect", kind="budget", scale=1.5).name
J_CHAOS_BUDGET = j_register_chaos("bisect", kind="budget", scale=1.5).name


def _port(h2=H2, traj="scan", solver="bisect", guard=None, **kw):
    cfg = dataclasses.replace(SC.ocean_config(), traj=traj, solver=solver, guard=guard)
    st, d = simulate(cfg, torch.tensor(np.asarray(h2))[None], torch.tensor(ETA), V,
                     device="cpu", **kw)
    return st, d


@functools.lru_cache(maxsize=None)
def _port_clean(traj, solver, guard=None):
    """``_port`` on the clean gains, run once per configuration."""
    return _port(traj=traj, solver=solver, guard=guard)


_REF = {}


def _ref(h2_key, guard_dict=None, solver="bisect", traj="scan", **kw):
    """The reference on its own path (cached per configuration)."""
    key = (h2_key, None if guard_dict is None else tuple(sorted(guard_dict.items())), solver,
           traj, tuple(sorted(kw)))
    if key not in _REF:
        h2 = {"clean": H2, "faults": _faults()[0]}[h2_key]
        cfg = dataclasses.replace(
            JSC.ocean_config(), solver=solver, traj=traj,
            guard=None if guard_dict is None else JGuard(**guard_dict))
        st, d = j_simulate(cfg, h2, ETA, V, **kw)
        _REF[key] = (np.asarray(st.q), {f: None if getattr(d, f) is None else np.asarray(getattr(d, f))
                                        for f in d._fields})
    return _REF[key]


def _faults(seed=11):
    return inject_h2_faults(H2, seed, **FAULTS)


def _np(x):
    return None if x is None else x.detach().cpu().numpy()[0]


def _equal(d0, d1, fields=("a", "b", "e", "q", "rho", "objective", "num_selected")):
    for f in fields:
        assert torch.equal(getattr(d0, f), getattr(d1, f)), f


def _near_ties(q_pre, h2, guard):
    """(T,) rounds whose best and runner-up prefix W (the plain K1 sweep on
    the guarded priorities) lie within 2e-4 |W*|."""
    cfg = dataclasses.replace(SC.ocean_config(), guard=guard)
    h2s, admit, _, _ = _guard_admission(cfg, torch.tensor(h2), None, cfg.radio)
    rho = priorities(torch.tensor(q_pre), h2s)
    rho = torch.where(admit, rho, torch.tensor(RHO_DEMOTED))
    _, rho_sorted, n0, delta = prefix_inputs(rho, cfg.radio)
    w = tk.prefix_objectives_plain(tk._scal(n0, delta, V * torch.tensor(ETA), cfg.radio,
                                            rho_sorted), rho_sorted)
    top2 = torch.topk(w, 2, dim=1).values
    return ((top2[:, 0] - top2[:, 1]) <= W_RTOL * top2[:, 0].abs()).numpy()


def _teacher_forced(ref_d, h2, guard, solver):
    """Every round of the reference's trajectory through the port's round
    on the reference's queues; returns the port's decisions and the rounds
    outside near ties."""
    cfg = dataclasses.replace(SC.ocean_config(), solver=solver, guard=guard)
    state = state_from_reference(ref_d["q"], np.arange(T), np.zeros((T, K)), device="cpu")
    _, dec = ocean_round(state, torch.tensor(h2), V, torch.tensor(ETA), cfg)
    ok = ~_near_ties(ref_d["q"], h2, guard)
    assert ok.sum() >= 0.9 * T
    np.testing.assert_array_equal(dec.a.numpy()[ok], ref_d["a"][ok])
    np.testing.assert_allclose(dec.b.numpy()[ok], ref_d["b"][ok], atol=B_ATOL, rtol=0)
    for f in GUARD_FIELDS:
        np.testing.assert_array_equal(getattr(dec, f).numpy(), ref_d[f])
    return dec, ok


@jax.jit
def _j_ocean_p(q, h2, admit):
    return j_ocean_p(q, h2, V, 1.0, JSC.radio, admit=admit)


# -- spec ------------------------------------------------------------------
def test_guardspec_validation():
    for kw, what in (({"energy_cap": 0.0}, "energy_cap"), ({"gain_floor": -1.0}, "gain_floor"),
                     ({"residual_tol": 0.0}, "residual_tol")):
        with pytest.raises(ValueError, match=what):
            GuardSpec(**kw)
        with pytest.raises(ValueError, match=what):
            JGuard(**kw)
    for kw in ({}, {"quarantine": False}, {"quarantine": False, "gain_floor": 1e-9},
               {"quarantine": False, "energy_cap": 2.0}):
        assert GuardSpec(**kw).admits == JGuard(**kw).admits
    assert not GuardSpec(quarantine=False).admits and GuardSpec().admits
    assert DEFAULT_RESIDUAL_TOL == 1e-3


def test_guardspec_serialization_round_trip():
    for kw in ({}, {"energy_cap": 2.0}, {"gain_floor": 1e-7, "fallback": False},
               {"energy_cap": 1.0, "quarantine": False, "residual_tol": 1e-2}):
        g = GuardSpec(**kw)
        assert GuardSpec.from_dict(g.to_dict()) == g
        assert g.to_dict() == JGuard(**kw).to_dict()  # the reference's payload
        assert GuardSpec.from_dict(JGuard(**kw).to_dict()) == g
    assert GuardSpec().to_dict() == {}


def test_scenario_guard_round_trip_and_omission():
    sc = dataclasses.replace(SC, guard=GuardSpec(energy_cap=2.0))
    assert Scenario.from_json(sc.to_json()) == sc
    assert "guard" not in SC.to_dict()
    assert sc.ocean_config().guard == sc.guard
    jsc = dataclasses.replace(JSC, guard=JGuard(energy_cap=2.0, fallback=False))
    assert scenario_from_reference(jsc.to_dict()).guard == GuardSpec(energy_cap=2.0, fallback=False)
    assert sc.to_dict()["guard"] == dataclasses.replace(JSC, guard=JGuard(energy_cap=2.0)).to_dict()["guard"]


def test_config_rejects_non_spec_guard():
    for bad in ({"energy_cap": 1.0}, JGuard()):  # a dict, or the reference's own spec
        with pytest.raises(TypeError, match="guard"):
            dataclasses.replace(SC.ocean_config(), guard=bad)
        with pytest.raises(TypeError, match="guard"):
            dataclasses.replace(SC, guard=bad)


# -- the unguarded path ----------------------------------------------------
@pytest.mark.parametrize("traj", ["scan", "fused"])
def test_guard_none_is_legacy(traj):
    _, d = _port(traj=traj, solver="pallas")
    assert d.fault_count is None and d.demoted is None and d.fallback is None


@pytest.mark.parametrize("traj", ["scan", "fused"])
@pytest.mark.parametrize("solver", ["bisect", "pallas"])
def test_never_firing_guard_is_bitwise_identical(traj, solver):
    st0, d0 = _port_clean(traj, solver)
    st1, d1 = _port_clean(traj, solver, GuardSpec(energy_cap=1e6))
    _equal(d0, d1)
    assert torch.equal(st0.q, st1.q)
    for f in GUARD_FIELDS:
        assert int(getattr(d1, f).sum()) == 0, f


# -- quarantine and admission ----------------------------------------------
@pytest.mark.parametrize("traj,solver", [("scan", "bisect"), ("fused", "pallas"),
                                         ("fused", "bisect")])
def test_fault_count_matches_injection_exactly(traj, solver):
    h2c, rep = _faults()
    _, jrep = j_inject(H2, 11, **FAULTS)
    assert rep.positions == jrep.positions and rep.counts == jrep.counts
    np.testing.assert_array_equal(h2c, j_inject(H2, 11, **FAULTS)[0])
    g = GuardSpec(energy_cap=1.0)
    st, d = _port(h2c, traj=traj, solver=solver, guard=g)
    fc = _np(d.fault_count)
    np.testing.assert_array_equal(fc, rep.per_round_quarantined(T))
    _, ref = _ref("faults", {"energy_cap": 1.0})
    np.testing.assert_array_equal(fc, ref["fault_count"])
    np.testing.assert_array_equal(_np(d.demoted), ref["demoted"])
    assert bool(torch.isfinite(st.q).all())
    a = _np(d.a)
    for kind in FAULT_KINDS:
        for t, k in rep.positions[kind]:
            assert not a[t, k], (kind, t, k)


def test_guarded_rounds_teacher_forced_match_reference():
    """Faults of every kind and the energy cap: each round of the
    reference's trajectory through the port's round (bisect and the K1
    sweep) on the reference's queues."""
    h2c, _ = _faults()
    g = GuardSpec(energy_cap=1.0)
    _, ref = _ref("faults", {"energy_cap": 1.0})
    assert ref["demoted"].sum() >= FAULTS["num_subnormal"]
    for solver in ("bisect", "pallas"):
        _teacher_forced(ref, h2c, g, solver)


def test_scan_and_fused_agree_under_faults():
    h2c, _ = inject_h2_faults(H2, 5, num_inf=2, num_zero=1, num_subnormal=2)
    g = GuardSpec(energy_cap=1.0)
    st_s, d_s = _port(h2c, solver="pallas", guard=g)
    st_f, d_f = _port(h2c, traj="fused", solver="pallas", guard=g)
    _equal(d_s, d_f, ("a", "b", "e") + GUARD_FIELDS)
    assert torch.equal(st_s.q, st_f.q)


def test_subnormal_gain_is_demoted_not_quarantined():
    h2c, rep = inject_h2_faults(H2, 9, num_subnormal=3)
    assert 0.0 < h2c[rep.positions["subnormal"][0]] < np.finfo(np.float32).tiny
    g = GuardSpec(energy_cap=1.0)
    _, jd = j_simulate(dataclasses.replace(JSC.ocean_config(), guard=JGuard(energy_cap=1.0)),
                       h2c, ETA, V)
    for traj in ("scan", "fused"):
        _, d = _port(h2c, traj=traj, solver="pallas", guard=g)
        assert int(d.fault_count.sum()) == 0
        assert int(d.demoted.sum()) >= rep.counts["subnormal"]
        np.testing.assert_array_equal(_np(d.demoted), np.asarray(jd.demoted))
        a = _np(d.a)
        for t, k in rep.positions["subnormal"]:
            assert not a[t, k]
        assert float(d.e.max()) <= 1.0 * 0.15 * (1 + 1e-6)


def test_gain_floor_demotes():
    h2c = np.array(H2, copy=True)
    h2c[4, 2] = 1e-9
    _, d = _port(h2c, solver="pallas", guard=GuardSpec(gain_floor=1e-8))
    jh2 = np.array(H2, copy=True)
    jh2[4, 2] = 1e-9
    _, jd = j_simulate(dataclasses.replace(JSC.ocean_config(), guard=JGuard(gain_floor=1e-8)),
                       jh2, ETA, V)
    np.testing.assert_array_equal(_np(d.demoted), np.asarray(jd.demoted))
    assert int(d.demoted.sum()) >= 1 and not _np(d.a)[4, 2]


def test_budget_increment_sanitized():
    inc = np.full((T, K), 0.15 / T, np.float32)
    inc[7, 3], inc[9, 1] = np.inf, np.nan
    for traj in ("scan", "fused"):
        st, _ = _port(traj=traj, solver="pallas", guard=GuardSpec(),
                      budget_seq=torch.tensor(inc)[None])
        assert bool(torch.isfinite(st.q).all()), traj
    st, _ = _port(solver="pallas", budget_seq=torch.tensor(inc)[None])
    assert not bool(torch.isfinite(st.q).all())  # unguarded, the NaN reaches the queue


def test_energy_cap_defuses_pinned_heavy_tail_cell():
    """seed 21 / scenario 2 / ocean-a, the cell benchmarks/scenarios.py pins
    (1.04 J at round 24 on this tree's key stream, against H = 0.15 J): the
    reference's trajectory, each round through the port's round on the
    reference's queues, unguarded and with energy_cap = 1."""
    from benchmarks.common import SCENARIO_DRIFT_TOWARD, V_DEFAULT
    from repro.core.patterns import eta_schedule as j_eta

    Tb, Kb = SCENARIO_DRIFT_TOWARD.num_rounds, SCENARIO_DRIFT_TOWARD.num_clients
    h2 = np.asarray(SCENARIO_DRIFT_TOWARD.sample_channel(21), np.float32)
    eta = np.asarray(j_eta("ascend", Tb), np.float32)
    _, jd = j_simulate(SCENARIO_DRIFT_TOWARD.ocean_config(), h2, eta, V_DEFAULT)
    assert float(np.asarray(jd.e).max()) > 3.0 * 0.15
    sc = scenario_from_reference(SCENARIO_DRIFT_TOWARD.to_dict())
    state = state_from_reference(np.asarray(jd.q), np.arange(Tb), np.zeros((Tb, Kb)), device="cpu")
    for guard in (None, GuardSpec(energy_cap=1.0)):
        cfg = dataclasses.replace(sc.ocean_config(), solver="pallas", guard=guard)
        _, dec = ocean_round(state, torch.tensor(h2), V_DEFAULT, torch.tensor(eta), cfg)
        if guard is None:
            assert float(dec.e.max()) > 3.0 * 0.15
        else:
            assert float(dec.e.max()) <= 1.0 * 0.15 * (1 + 1e-6)
            assert int(dec.demoted.sum()) > 0


# -- the solver fallback -----------------------------------------------------
@pytest.mark.parametrize("traj,chaos", [("scan", CHAOS_BISECT_OBJ), ("fused", CHAOS_BISECT_OBJ),
                                        ("fused", CHAOS_PALLAS_OBJ)])
def test_chaos_objective_fallback_fires_every_round(traj, chaos):
    """Every round commits the bisect solve: the unguarded bisect run's bits
    (its guard never fires on clean gains)."""
    st0, d0 = _port_clean(traj, "bisect")
    st_c, d_c = _port(traj=traj, solver=chaos, guard=GuardSpec())
    assert int(d_c.fallback.sum()) == T
    _equal(d0, d_c, ("a", "b", "e", "q"))
    assert torch.equal(st_c.q, st0.q)


def test_chaos_budget_violation_caught():
    """b x 1.5 breaks the budget exactly on rounds with m* > 0; the committed
    trajectory is the clean bisect one, and the reference flags the same
    rounds."""
    _, ref0 = _ref("clean")
    expected = (ref0["a"] & (ref0["q"] > 0.0)).any(axis=1).astype(np.int32)
    _, jref = _ref("clean", {}, solver=J_CHAOS_BUDGET)
    np.testing.assert_array_equal(jref["fallback"], expected)
    st0, d0 = _port_clean("fused", "bisect")
    st_c, d_c = _port(traj="fused", solver=CHAOS_BISECT_BUDGET, guard=GuardSpec())
    _equal(d0, d_c, ("a", "b", "e", "q"))
    np.testing.assert_array_equal(_np(d_c.fallback), expected)
    assert 0 < expected.sum() < T


@pytest.mark.parametrize("traj", ["scan", "fused"])
def test_fallback_off_keeps_counter_zero(traj):
    _, d = _port(traj=traj, solver=CHAOS_BISECT_OBJ, guard=GuardSpec(fallback=False))
    assert int(d.fallback.sum()) == 0
    assert bool(torch.isinf(d.objective).all())  # the corruption was committed


def test_starved_newton_budgets_are_restored_and_caught():
    from repro_torch.core.solvers import newton_iteration_budgets

    before = newton_iteration_budgets(torch.float32, K)
    with starved_newton_budgets(outer=1, inner=1, grid=2):
        assert newton_iteration_budgets(torch.float32, K) == (1, 1, 2)
        _, d = _port(solver="newton", guard=GuardSpec(residual_tol=1e-6))
    assert newton_iteration_budgets(torch.float32, K) == before
    b = d.b[0]
    sums = b.sum(-1)[d.num_selected[0] > 0]
    assert bool(((sums - 1.0).abs() <= 1e-6).all() | (d.fallback[0] > 0).any())


# -- admission internals -----------------------------------------------------
def test_demoted_rho_sorts_last_and_never_wins():
    q = np.linspace(0.0, 0.2, K).astype(np.float32)
    admit = np.array([True, True, False, True, False, True])
    sol = ocean_p(torch.tensor(q)[None], torch.tensor(H2[0])[None], V, 1.0, SC.radio,
                  admit=torch.tensor(admit)[None])
    jsol = _j_ocean_p(q, H2[0], admit)
    a, rho = sol.a.numpy()[0], sol.rho.numpy()[0]
    assert not a[2] and not a[4]
    assert rho[2] == RHO_DEMOTED and rho[4] == RHO_DEMOTED and np.isfinite(rho).all()
    np.testing.assert_array_equal(a, np.asarray(jsol.a))
    np.testing.assert_allclose(sol.b.numpy()[0], np.asarray(jsol.b), atol=B_ATOL, rtol=0)
    np.testing.assert_array_equal(rho, np.asarray(jsol.rho))


def test_overprovision_extension_stops_at_the_admitted_count():
    """The guard's cap on overprovision's extension (reference
    repro/core/ocean.py:380-386): with every declared rate 0.1 the plain
    prefix would extend to b_min's limit; with clients demoted it stops at
    the admitted count, in both packages."""
    import jax.numpy as jnp

    q = np.linspace(0.0, 0.1, K).astype(np.float32)
    admit = np.array([True, True, True, False, True, False])
    rate = np.full((K,), 0.1, np.float32)
    dlv = np.ones((K,), np.float32)
    jcfg = dataclasses.replace(JSC.ocean_config(), failure_mode="overprovision")
    jsol = _j_ocean_p(q, H2[0], admit)
    ja = jax.jit(lambda q, h2, sol, dlv, rate, admit: j_failure_adjust(
        jcfg, q, h2, V, 1.0, sol, jnp.zeros((K,), jnp.float32), JSC.radio, dlv, rate,
        admit=admit))(q, H2[0], jsol, dlv, rate, admit)
    cfg = dataclasses.replace(SC.ocean_config(), failure_mode="overprovision")
    sol = ocean_p(torch.tensor(q)[None], torch.tensor(H2[0])[None], V, 1.0, SC.radio,
                  admit=torch.tensor(admit)[None])
    out = _failure_adjust(cfg, torch.tensor(q)[None], torch.tensor(H2[0])[None], V, 1.0, sol,
                          torch.zeros((1, K)), SC.radio, torch.tensor(dlv)[None],
                          torch.tensor(rate)[None], admit=torch.tensor(admit)[None])
    a = out[0].numpy()[0]
    np.testing.assert_array_equal(a, np.asarray(ja[0]))
    assert a.sum() == admit.sum() and not (a & ~admit).any()
    np.testing.assert_allclose(out[1].numpy()[0], np.asarray(ja[1]), atol=B_ATOL, rtol=0)
    unguarded = _failure_adjust(cfg, torch.tensor(q)[None], torch.tensor(H2[0])[None], V, 1.0,
                                sol, torch.zeros((1, K)), SC.radio, torch.tensor(dlv)[None],
                                torch.tensor(rate)[None])
    assert int(unguarded[0].sum()) > admit.sum()


def test_scan_caps_at_the_grid_budgets_and_fused_at_the_config():
    """The reference's scan path caps at the budgets it is given, its fused
    kernel at ``cfg.budgets()`` (ROADMAP.md Queue 3); the port keeps both.
    ``demoted`` depends on the gains and the caps alone, so the port's
    solver does not matter here."""
    g = GuardSpec(energy_cap=1.0)
    budgets = np.full((K,), 0.004, np.float32)
    _, ref_scan = _ref("clean", {"energy_cap": 1.0}, budgets=budgets)
    _, ref_fused = _ref("clean", {"energy_cap": 1.0}, traj="fused", budgets=budgets)
    assert ref_scan["demoted"].sum() > ref_fused["demoted"].sum()
    for traj, ref in (("scan", ref_scan), ("fused", ref_fused)):
        _, d = _port(traj=traj, solver="pallas", guard=g, budgets=torch.tensor(budgets))
        np.testing.assert_array_equal(_np(d.demoted), ref["demoted"])


# -- grid engine -------------------------------------------------------------
def test_grid_guard_is_must_agree_static():
    with pytest.raises(ValueError, match="guard"):
        GridEngine([dataclasses.replace(SC, name="a"),
                    dataclasses.replace(SC, name="b", guard=GuardSpec())], ["ocean-u"],
                   device="cpu")


def test_grid_guard_override_runs_and_baselines_ignore_it():
    scenarios = [dataclasses.replace(SC, name="a"),
                 dataclasses.replace(SC, name="b", pathloss_db=(45.0, 32.0))]
    g = GuardSpec(energy_cap=1.0)
    eng = GridEngine(scenarios, ["ocean-u", "smo"], guard=g, solver="pallas", traj="fused",
                     device="cpu")
    assert eng.cfg.guard == g
    res = eng.run([0, 1])
    assert bool(torch.isfinite(res.e).all())
    assert float(res.e[0].max()) <= 1.0 * 0.15 * (1 + 1e-6)
    base = GridEngine(scenarios, ["smo"], solver="pallas", traj="fused", device="cpu").run([0, 1])
    for f in ("a", "b", "e"):
        assert torch.equal(getattr(res, f)[1], getattr(base, f)[0]), f


# -- eager screens -----------------------------------------------------------
def test_screen_streams_raises_and_counts():
    h2c, rep = inject_h2_faults(H2, 13, num_inf=2, num_zero=1)
    for x in (h2c, torch.tensor(h2c)):
        with pytest.raises(ValueError, match="h2_seq"):
            screen_streams(h2_seq=x)
        assert screen_streams(h2_seq=x, strict=False)["h2_seq"] == rep.quarantined
    inc = np.zeros((T, K), np.float32)
    inc[0, 0], inc[1, 1] = -1.0, np.nan
    counts = screen_streams(h2_seq=H2, budget_seq=torch.tensor(inc), strict=False)
    assert counts == j_screen(h2_seq=H2, budget_seq=inc, strict=False)
    assert counts == {"h2_seq": 0, "budget_seq": 2}


def test_lowering_rejects_non_finite_params():
    from repro_torch.env import EnvSpec

    sc = dataclasses.replace(SC, env=EnvSpec(
        channel="iid_rayleigh", channel_params={"pathloss_db": (float("nan"), 36.0)}))
    with pytest.raises(ValueError, match="non-finite"):
        sc.lower_env()
