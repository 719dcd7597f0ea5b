"""Property tests of repro_torch.guard (hypothesis), ported from
``tests/test_guard_properties.py``, with few examples each.

* cap monotonicity: raising ``energy_cap`` only grows the admitted set,
  and the port's admission equals the reference's on the same row; a cap
  that demotes nobody leaves the whole trajectory bit for bit unguarded;
* quarantine completeness: a corrupted draw's client is never selected,
  gets no bandwidth and no energy, and the queues stay finite;
* fallback feasibility: whatever a budget-corrupting solver emits, the
  committed allocation meets the P4 constraints on every round.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis (dev extra)")
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.core.ocean import _guard_admission as j_guard_admission  # noqa: E402
from repro.core.scenario import Scenario as JScenario  # noqa: E402
from repro.guard import GuardSpec as JGuard  # noqa: E402
from repro_torch.core.ocean import _guard_admission, simulate  # noqa: E402
from repro_torch.core.scenario import Scenario  # noqa: E402
from repro_torch.guard import GuardSpec, inject_h2_faults, register_chaos_solver  # noqa: E402

T, K = 16, 5
SC = Scenario(name="guard-prop", num_rounds=T, num_clients=K)
JSC = JScenario(name="guard-prop", num_rounds=T, num_clients=K)
CFG = SC.ocean_config()
H2 = np.asarray(JSC.sample_channel(7), np.float32)
ETA = torch.tensor(np.asarray(JSC.eta_seq(), np.float32))
V = 1e-5
_CHAOS_BUDGET = register_chaos_solver(base="bisect", kind="budget").name


def _admission(cap, h2_row):
    cfg = dataclasses.replace(CFG, guard=GuardSpec(energy_cap=float(cap)))
    _, admit, _, _ = _guard_admission(cfg, torch.tensor(h2_row)[None], None, cfg.radio)
    return admit.numpy()[0]


def _run(cfg, h2, v=V):
    return simulate(cfg, torch.tensor(h2)[None], ETA, v, device="cpu")


@settings(max_examples=30, deadline=None)
@given(cap_lo=st.floats(1e-2, 1e2), ratio=st.floats(1.0, 1e4), t=st.integers(0, T - 1))
def test_energy_cap_admission_monotone(cap_lo, ratio, t):
    lo = _admission(cap_lo, H2[t])
    hi = _admission(cap_lo * ratio, H2[t])
    assert np.all(~lo | hi)
    jcfg = dataclasses.replace(JSC.ocean_config(), guard=JGuard(energy_cap=float(cap_lo)))
    _, jadmit, _, _ = j_guard_admission(jcfg, jnp.asarray(H2[t]), None, jcfg.radio)
    np.testing.assert_array_equal(lo, np.asarray(jadmit))


@settings(max_examples=3, deadline=None)
@given(cap=st.floats(1e4, 1e8), seed=st.integers(0, 63))
def test_never_demoting_cap_is_bitwise_legacy(cap, seed):
    h2 = SC.sample_channel(seed, device="cpu").numpy()
    if not all(np.all(_admission(cap, h2[t])) for t in range(T)):
        return  # a tail even this cap demotes: vacuous
    cfg = dataclasses.replace(CFG, solver="pallas", traj="fused")
    _, d0 = _run(cfg, h2)
    _, dg = _run(dataclasses.replace(cfg, guard=GuardSpec(energy_cap=float(cap))), h2)
    for name in ("a", "b", "e", "q", "rho", "objective", "num_selected"):
        assert torch.equal(getattr(d0, name), getattr(dg, name)), name
    assert int(dg.demoted.sum()) == 0


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), num_inf=st.integers(0, 8), num_zero=st.integers(0, 8),
       num_negative=st.integers(0, 8))
def test_quarantined_clients_never_selected(seed, num_inf, num_zero, num_negative):
    h2_bad, report = inject_h2_faults(H2, seed, num_inf=num_inf, num_zero=num_zero,
                                      num_negative=num_negative)
    cfg = dataclasses.replace(CFG, solver="pallas", guard=GuardSpec(quarantine=True))
    state, d = _run(cfg, h2_bad)
    a, b, e = d.a.numpy()[0], d.b.numpy()[0], d.e.numpy()[0]
    for kind, cells in report.positions.items():
        for t, k in cells:
            assert not a[t, k] and b[t, k] == 0.0 and e[t, k] == 0.0, (kind, t, k)
    assert bool(torch.isfinite(d.q).all()) and bool(torch.isfinite(state.q).all())
    assert int(d.fault_count.sum()) == report.quarantined


@settings(max_examples=2, deadline=None)
@given(seed=st.integers(0, 63), v_exp=st.floats(-6.0, -3.0))
def test_fallback_commit_is_always_budget_feasible(seed, v_exp):
    h2 = SC.sample_channel(seed, device="cpu").numpy()
    guard = GuardSpec(quarantine=True, fallback=True)
    cfg = dataclasses.replace(CFG, solver=_CHAOS_BUDGET, guard=guard, traj="fused")
    _, d = _run(cfg, h2, 10.0 ** v_exp)
    a, b, n_sel = d.a.numpy()[0], d.b.numpy()[0], d.num_selected.numpy()[0]
    b_min = float(CFG.radio.b_min)
    assert np.all(np.isfinite(b))
    sums = b.sum(axis=1)
    assert np.all(np.abs(sums[n_sel > 0] - 1.0) <= guard.residual_tol)
    assert np.all(sums[n_sel == 0] == 0.0)
    assert np.all(b[a] >= b_min * (1.0 - 1e-6)) and np.all(b[~a] == 0.0)
