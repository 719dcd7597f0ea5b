"""K3 past K = 2048 on the ranked row (``ranking="sort"``, a top-m clip past
2048, ``failure_mode="overprovision"``) on the CPU, against the JAX
reference.

At K = 2100, 2 seeds x 3 rounds and the §VI per-client load of
``tests/test_torch_wide_branches.py`` (b_min = 0.5 / K with the model's
bits cut with it; seed 0 drains its queues slowly, seed 1 fast), the port's
fused trajectory (``simulate(traj="fused", device="cpu")``, which runs K3's
plain version) is held to the reference's ``simulate(traj="scan")`` on the
same numpy inputs, with the newton solver (the reference's pallas backend
runs in interpret mode, its bisect sweep of every prefix takes minutes at
this K): ``ranking="sort"``; overprovision under a delivery mask of
p_deliver 0.7 (benchmarks/reliability_sweep.py's drop_heavy, handed to both
packages as their ``TracedFailure``) with the guard's energy cap 1 (whose
admitted count stops the extension), under top-m 8 and under sort (without
the cap, top-m 8 is ``tests/test_torch_wide_branches.py``'s case, and sort
is held on the card); ``ranking="topm"`` with top_m = 2050, a clip past
2048.  The reference runs its top-m path with a clip of 256 for the
sort-ranked cases and the clip of 2050 (``REF_CLIP``: its sort answer on
every round here; ``tests/test_torch_wide_sort_oracle.py`` runs the
reference's sort path itself on seed 0 and holds it equal to that run bit
for bit).  Every round is teacher-forced on the reference's own queues, and whole
trajectories are held on the seeds that select alike on every round; a
round or seed may select unlike the reference only at a near tie.  On
every round that selects alike: selections, the
delivered mask, the reallocation flags and the guard's counters exact; b
within 2e-4 (flat rounds held to the float64 optimum, as
``tests/test_torch_wide_branches.py`` holds them); the P3 value within 2e-4
relative; the final queues within 1e-6 + 1e-5 |q|.
"""
import dataclasses
import functools
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
from repro_torch.convert import decisions_to_numpy  # noqa: E402
from repro_torch.core.energy import RadioParams as TRadio  # noqa: E402
from repro_torch.core.ocean import OceanConfig as TConfig  # noqa: E402
from repro_torch.core.ocean import simulate  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.selection import prefix_inputs  # noqa: E402
from repro_torch.core.solvers import sweep_cands  # noqa: E402
from repro_torch.env.failure import TracedFailure  # noqa: E402
from repro_torch.guard import GuardSpec  # noqa: E402
from repro_torch.kernels import ocean_p as tk  # noqa: E402
from repro_torch.kernels import ocean_traj as tt  # noqa: E402

K, T, S, R = 2100, 3, 2, 13
V = 1e-5
B_ATOL, W_RTOL = 2e-4, 2e-4
Q_ATOL, Q_RTOL = 1e-6, 1e-5
FLAT_W_RTOL = 1e-6
# per-round budget increments of seed 0 and seed 1
INC = (2e-3, 0.0375)
B_MIN = 0.5 / K
BITS = JRadio().model_bits * B_MIN / 0.02
P_DELIVER = 0.7  # benchmarks/reliability_sweep.py's drop_heavy
CLIP = 2050      # a top-m clip past the compact row's 2048
# The reference's sort path sweeps all K + 1 prefixes (~15 s a run here, a
# quarter of this file's time); its top-m path with a clip of REF_CLIP
# gives its sort answer wherever the sort optimum's m* fits the clip
# (tests/test_ranking.py), which every round here does (at most 148
# positive clients that are not demoted; asserted): the sort-ranked cases
# and the clip of 2050 are held to it.
REF_CLIP = 256
# case: (ranking, top_m, failure_mode or None: no failure process, the
# guard (energy cap 1) or None).  Under sort the guard runs without its
# fallback: the reference's guarded round computes the bisect sweep of all
# K + 1 prefixes whether it falls back or not, minutes at this K.
# Overprovision under top-m without the cap is tests/test_torch_wide_branches.py's.
CASES = {
    "sort": ("sort", None, None, None),
    "clip": ("topm", CLIP, None, None),
    "over_topm_cap": ("topm", 8, "overprovision", dict(energy_cap=1.0)),
    "over_sort_cap": ("sort", None, "overprovision", dict(energy_cap=1.0, fallback=False)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_fused_large_k.py (K = 2100
    passes PyTorch's parallel grain; the other workers oversubscribe)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _h2():
    """(S, T, K) gains, one numpy draw per seed."""
    return np.stack([
        (np.random.default_rng(s).exponential(size=(T, K)) * 2.5e-4).astype(np.float32)
        for s in range(S)
    ])


def _inc():
    return np.stack([np.full((T, K), x, np.float32) for x in INC])


def _delivered():
    rng = np.random.default_rng(17)
    return (rng.random((S, T, K)) < P_DELIVER).astype(np.float32)


def _cfg(case):
    ranking, top_m, mode, cap = CASES[case]
    return TConfig(num_clients=K, num_rounds=T, radio=TRadio(b_min=B_MIN, model_bits=BITS),
                   frame_len=R, solver="newton", ranking=ranking, top_m=top_m or 128,
                   traj="fused", failure_mode=mode or "plain",
                   guard=None if cap is None else GuardSpec(**cap))


def _failure(case):
    if CASES[case][2] is None:
        return None
    return TracedFailure(delivered=torch.tensor(_delivered()),
                         rate=torch.full((S, K), P_DELIVER))


@functools.lru_cache(maxsize=1)
def _reference(case):
    """The reference's scan trajectory of every seed (vmapped, jitted once),
    under top-m with a clip of at most REF_CLIP: ``clip`` shares
    ``sort``'s run."""
    if case == "clip":
        return _reference("sort")
    ranking, top_m, mode, cap = CASES[case]
    cfg = JConfig(num_clients=K, num_rounds=T, radio=JRadio(b_min=B_MIN, model_bits=BITS),
                  frame_len=R, solver="newton", ranking="topm", top_m=min(top_m or K, REF_CLIP),
                  failure_mode=mode or "plain",
                  guard=None if cap is None else JGuard(**cap))
    eta = j_eta_schedule("ascend", T)

    def one(h, inc, d):
        fail = None if mode is None else JFailure(delivered=d, rate=jnp.full((K,), P_DELIVER))
        return j_simulate(cfg, h, eta, V, budget_seq=inc, traj="scan", failure_seq=fail)

    out = jax.jit(jax.vmap(one))(jnp.asarray(_h2()), jnp.asarray(_inc()),
                                 jnp.asarray(_delivered()))
    return jax.tree_util.tree_map(np.asarray, out)


def _near_ties(rho, n_cands):
    """(S*T,) rounds whose two best prefix W among the sweep's candidates
    (the plain K1 sweep on the priorities, on the sorted rows' columns from
    the least n0 on: no candidate has a member before it) lie within 2e-4
    |W*|."""
    radio = TRadio(b_min=B_MIN, model_bits=BITS)
    r = torch.tensor(rho.reshape(-1, K))
    _, rho_sorted, n0, delta = prefix_inputs(r, radio)
    v_eta = V * eta_schedule("ascend", T).repeat(S)
    lo = int(n0.min())
    w, _ = tk._sweep_plain(rho_sorted[:, lo:], (n0 - lo)[:, None].to(torch.float32),
                           sweep_cands(n0, K, n_cands),
                           tk._scal(n0, delta, v_eta, radio, rho_sorted), float(K),
                           tk.OUTER_ITERS, tk.INNER_ITERS, False)
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


def _rounds_alone(cfg, q, h2, v, eta, inc, failure):
    """``rounds_alone`` seed by seed, (S * T, ...) rows: the plain sweep's
    candidate axis is each launch's (few positive clients on seed 1)."""
    outs = [tt.rounds_alone(cfg, q[s:s + 1], h2[s:s + 1], v[s:s + 1], eta[s:s + 1],
                            inc[s:s + 1], failure=None if failure is None else failure._replace(
                                delivered=failure.delivered[s:s + 1], rate=failure.rate[s:s + 1]))
            for s in range(S)]
    return {f: None if getattr(outs[0], f) is None
            else _rows(np.concatenate([getattr(o, f).numpy() for o in outs]))
            for f in ("a", "b", "obj", "nsel", "dlv", "ral", "fc", "dm", "fb")}


def _alike(got, ref):
    """(S*T,) rounds whose selection and count equal the reference's."""
    return ((got["a"] == ref.a.reshape(-1, K)).all(1)
            & (got["nsel"] == ref.num_selected.reshape(-1)))


def _assert_rounds(cfg, got, ref, ok, h2):
    """The port's (S*T, ...) rounds against the reference's on the rounds
    ``ok`` marks: the integer rows exact, P3 within W_RTOL, b within B_ATOL
    but on flat rounds (P3 within 1e-6 relative, b apart by more), which
    are held to the float64 optimum of the unextended round (no flat round
    may be an extended or guarded one)."""
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
        assert cfg.guard is None and cfg.failure_mode != "overprovision"
        t = torch.tensor
        w = _chip_smoke()._flat_witness(
            torch, cfg, t(np.flatnonzero(flat)), SimpleNamespace(a=t(got["a"]), b=t(got["b"])),
            {"a": t(ref.a.reshape(-1, K)), "b": t(rb)}, t(ref.q), h2, torch.full((S, T), V),
            eta_schedule("ascend", T).expand(S, T))
        assert all(w["same_a"]) and max(w["kernel_sum_off"]) <= 1e-5, w
        assert max(w["kernel_p3_short_ulps"]) <= 1.0 and max(w["kernel_b_off"]) <= 10 * B_ATOL, w


@pytest.mark.parametrize("case", list(CASES))
def test_ranked_row_matches_the_reference_scan(case):
    ranking, top_m, mode, cap = CASES[case]
    ref_state, ref = _reference(case)[:2]
    cfg = _cfg(case)
    if top_m is None or top_m > REF_CLIP:  # no round's optimum can pass REF_CLIP
        rho = np.asarray(ref.rho)
        assert (((rho > 1e-30) & (rho < 1e29)).sum(-1) < REF_CLIP).all()
    assert tt.ranked_row(cfg, failure=mode is not None)
    h2 = torch.tensor(_h2())
    v = torch.full((S, T), V)
    eta = eta_schedule("ascend", T).expand(S, T)
    inc = torch.tensor(_inc())
    near = _near_ties(ref.rho, top_m)
    assert near.sum() <= 2
    # every round, teacher-forced on the reference's queues: a round may
    # select unlike the reference only at a near tie (with ~2000 S0 clients
    # 2e-4 |W*| passes a candidate's margin); every round that selects
    # alike is held
    got = _rounds_alone(cfg, torch.tensor(ref.q), h2, v, eta, inc, _failure(case))
    ok = _alike(got, ref)
    assert (ok | near).all()
    _assert_rounds(cfg, got, ref, ok, h2)
    if mode == "overprovision":
        assert (got["dlv"] <= got["a"]).all()
    if mode == "overprovision" and ranking == "topm":
        # the extension grew the plain prefix on some rounds (the admitted
        # count stopping it), never shrank it
        plain = _rounds_alone(dataclasses.replace(cfg, failure_mode="plain"),
                              torch.tensor(ref.q), h2, v, eta, inc, _failure(case))
        grown = got["nsel"] - plain["nsel"]
        assert (grown >= 0).all() and (grown > 0).any()
    if cap is not None:
        assert got["dm"].any()
    # whole trajectories, on the seeds that select alike on every round (a
    # seed that does not has a near tie)
    res = simulate(cfg, h2, eta_schedule("ascend", T), V, budget_seq=inc,
                   failure_seq=_failure(case), traj="fused", device="cpu")
    state, decs = res[:2]
    d = decisions_to_numpy(decs)
    whole = {f: _rows(d[g]) if g in d else None
             for f, g in (("a", "a"), ("b", "b"), ("obj", "objective"), ("nsel", "num_selected"),
                          ("dlv", "delivered"), ("ral", "realloc"), ("fc", "fault_count"),
                          ("dm", "demoted"), ("fb", "fallback"))}
    clean = _alike(whole, ref).reshape(S, T).all(1)
    assert (clean | near.reshape(S, T).any(1)).all()
    assert clean.sum() >= 1
    rows = np.repeat(clean, T)
    _assert_rounds(cfg, whole, ref, rows, h2)
    np.testing.assert_allclose(state.q.numpy()[clean], ref_state.q[clean], rtol=Q_RTOL,
                               atol=Q_ATOL)
