"""K3's branches past K = 2048 (failure ``plain``/``reallocate``, a guard or
chaos backend, a ``MetricsSpec``) on the CPU, against the JAX reference.

At K = 2100, 2 seeds x 3 rounds and top_m = 8 (the shape and the §VI
per-client load of ``tests/test_torch_fused_large_k.py``), the port's fused
trajectory (``simulate(traj="fused", device="cpu")``, which runs K3's plain
version) is held to the reference's ``simulate(traj="scan")`` on the same
numpy inputs: a delivery mask of p_deliver 0.7 handed to both packages as
their ``TracedFailure`` (failure modes plain and reallocate); gains with
NaN, inf, zero and negative draws planted by ``inject_h2_faults`` under a
guard with quarantine, energy cap 1 and the fallback; the objective chaos
backend of bisect; the 6-entry overhead spec of
benchmarks/traj_bench.py:304-311 on the reallocate run; overprovision (on
K3's ranked row past 2048) under the same mask.  Every round
is teacher-forced on the reference's own queues, and whole trajectories
are held on the seeds clear of near ties.  Selections, the delivered
mask, the reallocation flags and the guard's counters exact; b within
2e-4; the P3 value within 2e-4 relative; the final queues within 1e-6 +
1e-5 |q|.  The telemetry is held to the reference's scan telemetry as
``tests/test_torch_metrics.py`` holds it.
"""
import dataclasses
import importlib.util
import pathlib
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.energy import RadioParams as JRadio  # noqa: E402
from repro.core.ocean import OceanConfig as JConfig  # noqa: E402
from repro.core.ocean import simulate as j_simulate  # noqa: E402
from repro.core.patterns import eta_schedule as j_eta_schedule  # noqa: E402
from repro.env.failure import TracedFailure as JFailure  # noqa: E402
from repro.guard import GuardSpec as JGuard  # noqa: E402
from repro.guard import register_chaos_solver as j_register_chaos  # noqa: E402
from repro.obs import MetricsSpec as JMetricsSpec  # noqa: E402
from repro_torch.convert import decisions_to_numpy  # noqa: E402
from repro_torch.core.energy import RadioParams as TRadio  # noqa: E402
from repro_torch.core.ocean import OceanConfig as TConfig  # noqa: E402
from repro_torch.core.ocean import simulate  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.selection import prefix_inputs  # noqa: E402
from repro_torch.env.failure import TracedFailure  # noqa: E402
from repro_torch.guard import GuardSpec, inject_h2_faults, register_chaos_solver  # noqa: E402
from repro_torch.kernels import ocean_p as tk  # noqa: E402
from repro_torch.kernels import ocean_traj as tt  # noqa: E402
from repro_torch.obs import MetricsSpec, get_collector, metric_key  # noqa: E402

K, T, S, R = 2100, 3, 2, 13
TOP_M = 8
V = 1e-5
B_ATOL, W_RTOL = 2e-4, 2e-4
Q_ATOL, Q_RTOL = 1e-6, 1e-5
FLAT_W_RTOL = 1e-6
# per-round budget increments of seed 0 and seed 1
INC = (2e-3, 0.0375)
B_MIN = 0.5 / K
BITS = JRadio().model_bits * B_MIN / 0.02
P_DELIVER = 0.7  # benchmarks/reliability_sweep.py's drop_heavy
FAULTS = dict(num_nan=3, num_inf=2, num_zero=1, num_negative=1)
OVERHEAD = ("queue:last", "lyapunov:mean", "num_selected:full_trace", "energy_headroom:last",
            "queue:histogram", "solver_residual:mean")
J_SPEC = JMetricsSpec.of(*OVERHEAD)
SPEC = MetricsSpec.from_dict(J_SPEC.to_dict())
CHAOS = register_chaos_solver("bisect", kind="objective").name
J_CHAOS = j_register_chaos("bisect", kind="objective").name
EXACT = {"num_selected"}
# case: (solver, failure_mode or None: no failure process, guard fields,
# the faults planted in the gains (inject_h2_faults' counts) or None, the
# overhead spec)
CASES = {
    "plain": ("pallas", "plain", None, None, False),
    # with the telemetry
    "reallocate": ("newton", "reallocate", None, None, True),
    "guard": ("pallas", None, dict(quarantine=True, energy_cap=1.0, fallback=True), FAULTS, False),
    "chaos": (CHAOS, None, dict(quarantine=True, fallback=True), FAULTS, False),
}
# overprovision past 2048 runs on K3's ranked row (tests/test_torch_wide_sort.py
# holds it under sort and with the energy cap)
OVER_CASES = {"overprovision": ("pallas", "overprovision", None, None, False)}
ALL_CASES = {**CASES, **OVER_CASES}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_fused_large_k.py (K = 2100
    passes PyTorch's parallel grain; the other workers oversubscribe)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _h2(faulty):
    """(S, T, K) gains, one numpy draw per seed, with the faults planted."""
    h2 = np.stack([
        (np.random.default_rng(s).exponential(size=(T, K)) * 2.5e-4).astype(np.float32)
        for s in range(S)
    ])
    if faulty:
        h2 = np.stack([inject_h2_faults(h2[s], 30 + s, **faulty)[0] for s in range(S)])
    return h2


def _inc():
    return np.stack([np.full((T, K), x, np.float32) for x in INC])


def _delivered():
    rng = np.random.default_rng(17)
    return (rng.random((S, T, K)) < P_DELIVER).astype(np.float32)


def _cfg(case):
    solver, mode, guard, _, metrics = ALL_CASES[case]
    return TConfig(num_clients=K, num_rounds=T, radio=TRadio(b_min=B_MIN, model_bits=BITS),
                   frame_len=R, solver=solver, ranking="topm", top_m=TOP_M, traj="fused",
                   failure_mode=mode or "plain",
                   guard=None if guard is None else GuardSpec(**guard),
                   metrics=SPEC if metrics else None)


def _failure(case):
    if ALL_CASES[case][1] is None:
        return None
    return TracedFailure(delivered=torch.tensor(_delivered()),
                         rate=torch.full((S, K), P_DELIVER))


def _reference(case):
    """The reference's scan trajectory of every seed (vmapped, jitted once)."""
    solver, mode, guard, faulty, metrics = ALL_CASES[case]
    cfg = JConfig(num_clients=K, num_rounds=T, radio=JRadio(b_min=B_MIN, model_bits=BITS),
                  frame_len=R, solver=J_CHAOS if solver == CHAOS else solver, ranking="topm",
                  top_m=TOP_M, failure_mode=mode or "plain",
                  guard=None if guard is None else JGuard(**guard),
                  metrics=J_SPEC if metrics else None)
    eta = j_eta_schedule("ascend", T)

    def one(h, inc, d):
        fail = None if mode is None else JFailure(delivered=d, rate=jnp.full((K,), P_DELIVER))
        return j_simulate(cfg, h, eta, V, budget_seq=inc, traj="scan", failure_seq=fail)

    out = jax.jit(jax.vmap(one))(jnp.asarray(_h2(faulty)), jnp.asarray(_inc()),
                                 jnp.asarray(_delivered()))
    return jax.tree_util.tree_map(np.asarray, out)


def _near_ties(rho):
    """(S*T,) rounds whose two best prefix W among the clip's candidates
    (the plain K1 sweep on the priorities, a NaN ranked as +inf) lie within
    2e-4 |W*|."""
    radio = TRadio(b_min=B_MIN, model_bits=BITS)
    r = torch.tensor(rho.reshape(-1, K))
    _, rho_sorted, n0, delta = prefix_inputs(torch.where(r.isnan(), torch.inf, r), radio)
    v_eta = V * eta_schedule("ascend", T).repeat(S)
    w = tk.prefix_objectives_plain(tk._scal(n0, delta, v_eta, radio, rho_sorted), rho_sorted,
                                   n_cands=TOP_M)
    top2 = torch.topk(w, 2, dim=1).values
    return ((top2[:, 0] - top2[:, 1]) <= W_RTOL * top2[:, 0].abs()).numpy()


def _rows(x):
    """(S, T, ...) as (S * T, K), or (S * T,) for a per-round value."""
    x = np.asarray(x).reshape(S * T, -1)
    return x[:, 0] if x.shape[1] == 1 else x


ROUND_FIELDS = {"a": "a", "nsel": "num_selected", "dlv": "delivered", "ral": "realloc",
                "fc": "fault_count", "dm": "demoted", "fb": "fallback"}


def _chip_smoke():
    """chip_smoke.py as a module (it imports no JAX): its float64 witness."""
    mod = sys.modules.get("chip_smoke")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["chip_smoke"] = mod
    return mod


def _assert_rounds(cfg, got, ref, ok, h2):
    """The port's (S*T, ...) rounds against the reference's on the rounds
    ``ok`` marks: the integer rows exact, P3 within W_RTOL, b within B_ATOL
    but on flat rounds (P3 within 1e-6 relative, b apart by more: float32
    resolves b only to a few 1e-4 there, PERF.md §2), which are held to the
    float64 optimum as tests/test_torch_fused_large_k.py holds them (the
    witness solves the unguarded round: a guarded case has none)."""
    for f, g in ROUND_FIELDS.items():
        if got.get(f) is None:
            assert getattr(ref, g) is None, f
            continue
        want = np.asarray(getattr(ref, g)).reshape(got[f].shape)
        np.testing.assert_array_equal(got[f][ok], want[ok], err_msg=f)
    robj, rb = ref.objective.reshape(-1), ref.b.reshape(-1, K)
    np.testing.assert_allclose(got["obj"][ok], robj[ok], rtol=W_RTOL)
    db = np.abs(got["b"] - rb).max(1)
    flat = ok & (db > B_ATOL) & (np.abs(got["obj"] - robj) <= FLAT_W_RTOL * np.abs(robj))
    np.testing.assert_allclose(got["b"][ok & ~flat], rb[ok & ~flat], atol=B_ATOL, rtol=0)
    if flat.any():
        assert cfg.guard is None
        t = torch.tensor
        w = _chip_smoke()._flat_witness(
            torch, cfg, t(np.flatnonzero(flat)), SimpleNamespace(a=t(got["a"]), b=t(got["b"])),
            {"a": t(ref.a.reshape(-1, K)), "b": t(rb)}, t(ref.q), h2, torch.full((S, T), V),
            eta_schedule("ascend", T).expand(S, T))
        assert all(w["same_a"]) and max(w["kernel_sum_off"]) <= 1e-5, w
        assert max(w["kernel_p3_short_ulps"]) <= 1.0 and max(w["kernel_b_off"]) <= 10 * B_ATOL, w


def _assert_metrics(got, want, traces):
    """tests/test_torch_metrics.py's rule: integer collectors exact, float
    collectors within 2e-4 relative and 1e-6 of the histogram span
    (solver_residual within K 2^-23), a histogram's counts off only for
    values (``traces``, by collector) within that tolerance of a bin edge."""
    for name, red in SPEC.collect:
        key = metric_key(name, red)
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        lo, hi = get_collector(name).hist_range(_cfg("reallocate"))
        atol = K * 2.0 ** -23 if name == "solver_residual" else 1e-6 * (hi - lo)
        if name in EXACT and red != "mean":
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif red == "histogram":
            x, width = traces[name], (hi - lo) / SPEC.hist_bins
            r = np.mod(x - lo, width)
            tol = W_RTOL * np.abs(x) + atol
            near = ((r <= tol) | (width - r <= tol)).reshape(S, -1).sum(-1)
            assert np.array_equal(g.sum(-1), w.sum(-1)), key
            assert (np.abs(g - w).sum(-1) <= 2 * near).all(), key
        else:
            np.testing.assert_allclose(g, w, rtol=W_RTOL, atol=atol, err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_wide_branches_match_the_reference_scan(case):
    _hold_case(case)


def _hold_case(case):
    solver, mode, guard, faulty, metrics = ALL_CASES[case]
    ref_out = _reference(case)
    ref_state, ref = ref_out[:2]
    cfg = _cfg(case)
    h2 = torch.tensor(_h2(faulty))
    v = torch.full((S, T), V)
    eta = eta_schedule("ascend", T).expand(S, T)
    inc = torch.tensor(_inc())
    near = _near_ties(ref.rho)
    assert near.sum() <= 2
    ok = ~near
    # every round, teacher-forced on the reference's queues
    out = tt.rounds_alone(dataclasses.replace(cfg, metrics=None), torch.tensor(ref.q), h2, v, eta,
                          inc, failure=_failure(case))
    got = {f: None if getattr(out, f) is None else _rows(getattr(out, f).numpy())
           for f in ("a", "b", "obj", "nsel", "dlv", "ral", "fc", "dm", "fb")}
    _assert_rounds(cfg, got, ref, ok, h2)
    if mode == "reallocate":
        assert got["ral"].any()
    if mode == "overprovision":  # the extension grew some prefixes
        bare = tt.rounds_alone(dataclasses.replace(cfg, failure_mode="plain"),
                               torch.tensor(ref.q), h2, v, eta, inc, failure=_failure(case))
        grown = got["nsel"] - _rows(bare.nsel.numpy())
        assert (grown >= 0).all() and (grown > 0).any()
    if solver == CHAOS:
        assert got["fb"].all()
    if case == "guard":
        assert got["dm"].any()
    if faulty and guard["quarantine"]:
        assert (got["fc"].reshape(S, T).sum(1) == sum(faulty.values())).all()
        bad = _h2(faulty).reshape(S * T, K)
        assert not got["a"][~np.isfinite(bad) | (bad <= 0)].any()
    # whole trajectories, on the seeds clear of near ties
    res = simulate(cfg, h2, eta_schedule("ascend", T), V, budget_seq=inc,
                   failure_seq=_failure(case), traj="fused", device="cpu")
    state, decs = res[:2]
    d = decisions_to_numpy(decs)
    clean = ~near.reshape(S, T).any(1)
    assert clean.sum() >= 1
    rows = np.repeat(clean, T)
    whole = {f: _rows(d[g]) if g in d else None
             for f, g in (("a", "a"), ("b", "b"), ("obj", "objective"), ("nsel", "num_selected"),
                          ("dlv", "delivered"), ("ral", "realloc"), ("fc", "fault_count"),
                          ("dm", "demoted"), ("fb", "fallback"))}
    _assert_rounds(cfg, whole, ref, rows, h2)
    np.testing.assert_allclose(state.q.numpy()[clean], ref_state.q[clean], rtol=Q_RTOL,
                               atol=Q_ATOL)
    if metrics:
        assert clean.all()
        _assert_metrics(res[2], ref_out[2], {"queue": ref.q})


def test_overprovision_past_2048_still_raises():
    """Overprovision past 2048 (top-m 8, pallas) no longer raises: it runs on
    K3's ranked row and is held to the reference's scan like the other
    branches."""
    assert tt.ranked_row(_cfg("overprovision"), failure=True)
    _hold_case("overprovision")
