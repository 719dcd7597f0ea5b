"""K3 past K = 2048 under ``ranking="topm"``, and ``stream_bf16``, on the CPU,
against the JAX reference.

At K = 2100, 2 seeds x 3 rounds and top_m = 8, the port's fused trajectory
(``simulate(traj="fused", device="cpu")``, which runs K3's plain version)
is held to the reference's ``simulate(traj="scan")`` for the pallas, newton
and bisect solvers: every round teacher-forced on the reference's own
queues, and whole trajectories on the seeds clear of near ties.  Seed 0
drains its queues slowly (most clients have a positive queue and the clip
binds), seed 1 fast (a few positive queues: the clip passes K - n0).
Rounds whose P3 value agrees within 1e-6 relative but whose allocations
differ beyond 2e-4 are flat: there float32 resolves b only to a few 1e-4
(PERF.md §2), so they are held to the float64 optimum instead
(``chip_smoke._flat_witness``: the same selection, sum(b) within 1e-5, P3
at most one float32 ulp short of the optimum's, b within 2e-3 of it).
``pallas_tiled`` is held per round to the reference's oracle
``repro.kernels.ref.ocean_p_topm_ref`` (the reference's own pallas_tiled
path fails on this tree) on each round's S0 clients and its top_m best
positive ones: past the clip no client is a candidate, so the sort path's
optimum of that row is the clipped optimum (the oracle sweeps every prefix
of its row: over the whole K = 2100 row that takes minutes a round on a
CPU).  Selections
exact, b within 2e-4, the P3 value within 2e-4 relative.

``stream_bf16`` is held to the reference's ``simulate(traj="fused",
stream_bf16=True)`` at its own test's shape (tests/test_ranking.py:311-341):
bfloat16 rows, exact selections and counts, the float rows within 2^-8
relative; the port's bf16 rows are its float32 rows cast, whole, as
checkpointed segments and resumed.
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
from repro.kernels.ref import ocean_p_topm_ref  # noqa: E402
from repro_torch.checkpoint import CheckpointSpec  # noqa: E402
from repro_torch.convert import decisions_to_numpy  # noqa: E402
from repro_torch.core.energy import RadioParams as TRadio  # noqa: E402
from repro_torch.core.ocean import OceanConfig as TConfig  # noqa: E402
from repro_torch.core.ocean import simulate  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.selection import prefix_inputs  # noqa: E402
from repro_torch.kernels import ocean_p as tk  # noqa: E402
from repro_torch.kernels import ocean_traj as tt  # noqa: E402

K, T, S, R = 2100, 3, 2, 13
TOP_M = 8
V = 1e-5
B_ATOL, W_RTOL = 2e-4, 2e-4
Q_ATOL = 1e-6
FLAT_W_RTOL = 1e-6
# per-round budget increments of seed 0 and seed 1
INC = (2e-3, 0.0375)
# the §VI per-client load at K clients: b_min = 0.5 / K and the model's
# bits cut with it (chip_smoke._k3_ranked_inputs)
B_MIN = 0.5 / K
BITS = JRadio().model_bits * B_MIN / 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work: at K = 2100 the
    plain versions' (C, M, K) operations pass PyTorch's parallel grain, and
    a thread pool oversubscribed by the other test workers' processes
    slows them many times over (PyTorch's CPU sums may split differently by
    thread count; every check here is a tolerance against the reference or
    bit for bit within the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _h2():
    """(S, T, K) channel gains, one numpy draw per seed."""
    return np.stack([
        (np.random.default_rng(s).exponential(size=(T, K)) * 2.5e-4).astype(np.float32)
        for s in range(S)
    ])


def _inc():
    return np.stack([np.full((T, K), x, np.float32) for x in INC])


def _cfg(solver, **kw):
    return TConfig(num_clients=K, num_rounds=T, radio=TRadio(b_min=B_MIN, model_bits=BITS),
                   frame_len=R, solver=solver, ranking="topm", top_m=TOP_M, traj="fused", **kw)


def _reference(solver):
    """The reference's scan trajectory of every seed (vmapped, jitted once)."""
    cfg = JConfig(num_clients=K, num_rounds=T, radio=JRadio(b_min=B_MIN, model_bits=BITS),
                  frame_len=R, solver=solver, ranking="topm", top_m=TOP_M)
    eta = j_eta_schedule("ascend", T)
    run = jax.jit(jax.vmap(lambda h, inc: j_simulate(cfg, h, eta, V, budget_seq=inc,
                                                     traj="scan")))
    state, decs = run(jnp.asarray(_h2()), jnp.asarray(_inc()))
    return jax.tree_util.tree_map(np.asarray, state), jax.tree_util.tree_map(np.asarray, decs)


def _v_eta():
    return V * eta_schedule("ascend", T).repeat(S)


def _near_ties(rho, n_cands):
    """(S*T,) rounds whose two best prefix W among the clip's candidates
    (the plain K1 sweep on the (S, T, K) priorities ``rho``) lie within
    2e-4 |W*|: a float32 flip there is no fault."""
    radio = TRadio(b_min=B_MIN, model_bits=BITS)
    _, rho_sorted, n0, delta = prefix_inputs(torch.tensor(rho.reshape(-1, rho.shape[-1])), radio)
    w = tk.prefix_objectives_plain(tk._scal(n0, delta, _v_eta(), radio, rho_sorted), rho_sorted,
                                   n_cands=n_cands)
    top2 = torch.topk(w, 2, dim=1).values
    return ((top2[:, 0] - top2[:, 1]) <= W_RTOL * top2[:, 0].abs()).numpy()


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


def _assert_rounds(cfg, a, b, obj, nsel, ref, ok):
    """The port's (S*T, ...) rounds against the reference's on the rounds
    ``ok`` marks: a and nsel exact, P3 within W_RTOL, b within B_ATOL but on
    flat rounds, which go to the float64 optimum (``_flat_witness``)."""
    ra, rb = ref.a.reshape(-1, K), ref.b.reshape(-1, K)
    robj = ref.objective.reshape(-1)
    np.testing.assert_array_equal(a[ok], ra[ok])
    np.testing.assert_array_equal(nsel[ok], ref.num_selected.reshape(-1)[ok])
    np.testing.assert_allclose(obj[ok], robj[ok], rtol=W_RTOL)
    db = np.abs(b - rb).max(1)
    flat = ok & (db > B_ATOL) & (np.abs(obj - robj) <= FLAT_W_RTOL * np.abs(robj))
    np.testing.assert_allclose(b[ok & ~flat], rb[ok & ~flat], atol=B_ATOL, rtol=0)
    if flat.any():
        t = torch.tensor
        w = _chip_smoke()._flat_witness(
            torch, cfg, t(np.flatnonzero(flat)), SimpleNamespace(a=t(a), b=t(b)),
            {"a": t(ra), "b": t(rb)}, t(ref.q), t(_h2()), torch.full((S, T), V),
            eta_schedule("ascend", T).expand(S, T))
        assert all(w["same_a"]) and max(w["kernel_sum_off"]) <= 1e-5, w
        assert max(w["kernel_p3_short_ulps"]) <= 1.0 and max(w["kernel_b_off"]) <= 10 * B_ATOL, w
    return int(flat.sum())


def _rounds_alone(cfg, q_pre):
    """K3's plain version on every (seed, round) of the given (S, T, K)
    queues (``ocean_traj.rounds_alone``), as (S*T, ...) numpy rows."""
    out = tt.rounds_alone(cfg, torch.tensor(q_pre), torch.tensor(_h2()), torch.full((S, T), V),
                          eta_schedule("ascend", T).expand(S, T), torch.tensor(_inc()))
    return {f: getattr(out, f).reshape(S * T, -1).squeeze(-1).numpy()
            for f in ("a", "b", "obj", "nsel", "rho")}


@pytest.mark.parametrize("solver", ["pallas", "newton", "bisect"])
def test_fused_past_2048_matches_the_reference_scan(solver):
    ref_state, ref = _reference(solver)
    cfg = _cfg(solver)
    near = _near_ties(ref.rho, TOP_M)
    ok = ~near
    assert near.sum() <= 2
    # every round, teacher-forced
    got = _rounds_alone(cfg, ref.q)
    _assert_rounds(cfg, got["a"], got["b"], got["obj"], got["nsel"], ref, ok)
    # the clip binds on seed 0's rounds past the first, and seed 1's
    # positive clients fit under it
    m_star = tt.m_star(torch.tensor(ref.num_selected), torch.tensor(ref.rho)).numpy()
    n_pos = (ref.rho > 1e-30).sum(-1)
    assert (m_star[0, 1:] == TOP_M).all() and (n_pos[0, 1:] > TOP_M).all()
    assert (n_pos[1] < TOP_M).all() and (m_star[1] > 0).any()
    # whole trajectories, on the seeds clear of near ties
    state, decs = simulate(cfg, torch.tensor(_h2()), eta_schedule("ascend", T), V,
                           budget_seq=torch.tensor(_inc()), traj="fused", device="cpu")
    d = decisions_to_numpy(decs)
    clean = ~near.reshape(S, T).any(1)
    assert clean.sum() >= 1
    rows = np.repeat(clean, T)
    _assert_rounds(cfg, d["a"].reshape(-1, K), d["b"].reshape(-1, K), d["objective"].reshape(-1),
                   d["num_selected"].reshape(-1), ref, rows)
    np.testing.assert_allclose(state.q.numpy()[clean], ref_state.q[clean], rtol=1e-4,
                               atol=Q_ATOL)


def test_pallas_tiled_past_2048_rounds_match_the_oracle():
    """pallas_tiled per round on seeded queues with 4 S0 clients a round:
    its allocation is the oracle's on the round's S0 clients and top_m best
    positive ones (by (rho, client index), in client order), and 0 beyond."""
    rng = np.random.default_rng(7)
    q = rng.uniform(0.01, 0.2, (S, T, K)).astype(np.float32)
    for s in range(S):
        for t in range(T):
            q[s, t, rng.choice(K, 4, replace=False)] = 0.0
    h2 = _h2()
    cfg = _cfg("pallas_tiled")
    got = _rounds_alone(cfg, q)
    rho = (q / np.maximum(h2, np.float32(1e-30))).reshape(-1, K)
    np.testing.assert_array_equal(got["rho"], rho)
    keep = np.zeros_like(rho, bool)
    for i, r in enumerate(rho):
        pos = np.flatnonzero(r > 1e-30)
        keep[i, pos[np.lexsort((pos, r[pos]))[:TOP_M]]] = True
        keep[i, r <= 1e-30] = True
    assert (keep.sum(1) == TOP_M + 4).all()
    rows = lambda x: x.reshape(-1, K)[keep].reshape(S * T, TOP_M + 4)  # noqa: E731
    radio = JRadio(b_min=B_MIN, model_bits=BITS)
    oracle = jax.jit(jax.vmap(lambda q, h, e: ocean_p_topm_ref(q, h, V, e, radio)))
    ref = oracle(jnp.asarray(rows(q)), jnp.asarray(rows(h2)),
                 jnp.asarray(np.tile(np.asarray(eta_schedule("ascend", T)), S)))
    ok = ~_near_ties(q / np.maximum(h2, np.float32(1e-30)), TOP_M)
    assert ok.sum() >= S * T - 2
    m_got = tt.m_star(torch.tensor(got["nsel"]), torch.tensor(rho)).numpy()
    assert (m_got == TOP_M).any()
    assert not got["a"][~keep].any() and not got["b"][~keep].any()
    a_got = got["a"][keep].reshape(S * T, -1)
    b_got = got["b"][keep].reshape(S * T, -1)
    np.testing.assert_array_equal(a_got[ok], np.asarray(ref.a)[ok])
    np.testing.assert_array_equal(got["nsel"][ok], np.asarray(ref.num_selected)[ok])
    np.testing.assert_allclose(b_got[ok], np.asarray(ref.b)[ok], atol=B_ATOL, rtol=0)
    np.testing.assert_allclose(got["obj"][ok], np.asarray(ref.objective)[ok], rtol=W_RTOL)


# ---------------------------------------------------------------------------
# stream_bf16
# ---------------------------------------------------------------------------
T6, K6, R6 = 20, 6, 8  # tests/test_ranking.py::test_stream_bf16_roundtrip


def _bf16_inputs():
    h2 = np.asarray(jax.random.exponential(jax.random.PRNGKey(2), (T6, K6)) * 2.5e-4,
                    np.float32)
    return h2, TConfig(num_clients=K6, num_rounds=T6, radio=TRadio(), frame_len=R6,
                       traj="fused")


def test_stream_bf16_matches_the_reference():
    h2, cfg = _bf16_inputs()
    jcfg = JConfig(num_clients=K6, num_rounds=T6, radio=JRadio(), frame_len=R6)
    ref_state, ref = j_simulate(jcfg, jnp.asarray(h2), j_eta_schedule("uniform", T6), V,
                                traj="fused", stream_bf16=True)
    state, decs = simulate(cfg, torch.tensor(h2)[None], eta_schedule("uniform", T6), V,
                           traj="fused", stream_bf16=True, device="cpu")
    np.testing.assert_array_equal(decs.a[0].numpy(), np.asarray(ref.a))
    np.testing.assert_array_equal(decs.num_selected[0].numpy(), np.asarray(ref.num_selected))
    for f in ("b", "e", "q", "rho"):
        got = getattr(decs, f)
        assert got.dtype == torch.bfloat16 and getattr(ref, f).dtype == jnp.bfloat16, f
        np.testing.assert_allclose(got[0].float().numpy(), np.asarray(getattr(ref, f), np.float32),
                                   rtol=2.0 ** -8, atol=1e-9, err_msg=f)
    np.testing.assert_allclose(state.q[0].numpy(), np.asarray(ref_state.q), rtol=1e-5,
                               atol=Q_ATOL)


def _assert_bits(x, y):
    for a, b in zip(x, y):
        assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b))


@pytest.mark.parametrize("shape", ["small", "past_2048"])
def test_stream_bf16_rows_are_the_float32_rows_cast(shape, tmp_path):
    """The bf16 rows are the float32 run's cast with ``.to(torch.bfloat16)``
    bit for bit, every other decision and the final state its bits; a run
    checkpointed every 5 rounds (2 past 2048), and one resumed from its
    middle snapshot, equal the whole bf16 run bit for bit; the scan path
    refuses bf16."""
    if shape == "small":
        h2, cfg = _bf16_inputs()
        cfg = dataclasses.replace(cfg, solver="pallas")
        h2, eta, every, args = torch.tensor(h2)[None], eta_schedule("uniform", T6), 5, {}
    else:
        cfg, h2, eta, every = _cfg("pallas_tiled"), torch.tensor(_h2()), eta_schedule(
            "ascend", T), 2
        args = dict(budget_seq=torch.tensor(_inc()))
    s32, d32 = simulate(cfg, h2, eta, V, device="cpu", **args)
    s16, d16 = simulate(cfg, h2, eta, V, device="cpu", stream_bf16=True, **args)
    for f in ("b", "e", "q", "rho"):
        assert getattr(d16, f).dtype == torch.bfloat16
        assert torch.equal(getattr(d16, f), getattr(d32, f).to(torch.bfloat16)), f
    _assert_bits([d16.a, d16.objective, d16.num_selected, s16.q, s16.energy_spent],
                 [d32.a, d32.objective, d32.num_selected, s32.q, s32.energy_spent])
    ck = CheckpointSpec(directory=str(tmp_path / "ck"), every_rounds=every)
    seg = simulate(cfg, h2, eta, V, device="cpu", stream_bf16=True, checkpoint=ck, **args)
    _assert_bits(jax.tree_util.tree_leaves((s16, d16)), jax.tree_util.tree_leaves(seg))
    snaps = sorted((tmp_path / "ck").glob("step_*"))
    assert len(snaps) >= 2
    for p in snaps[len(snaps) // 2:]:
        p.unlink()
    resumed = simulate(cfg, h2, eta, V, device="cpu", stream_bf16=True, checkpoint=ck,
                       resume_from=True, **args)
    _assert_bits(jax.tree_util.tree_leaves((s16, d16)), jax.tree_util.tree_leaves(resumed))
    with pytest.raises(ValueError, match="fused"):
        simulate(cfg, h2, eta, V, device="cpu", stream_bf16=True, traj="scan", **args)


# ---------------------------------------------------------------------------
# the scope past 2048
# ---------------------------------------------------------------------------
def test_scope_past_2048_runs_topm_and_refuses_the_rest():
    """Past 2048 every ranking runs (the plain version on the CPU): under
    top-m the failure modes plain and reallocate, a guard, a chaos backend
    and a MetricsSpec; and on the ranked row (``ranked_row``) sort, a clip
    past 2048 and overprovision.  What K3 still refuses (a solver it does
    not run) raises, naming the hook."""
    from repro_torch.env.failure import TracedFailure
    from repro_torch.guard import GuardSpec, register_chaos_solver
    from repro_torch.obs import MetricsSpec

    k, t = 2049, 2
    cfg = TConfig(num_clients=k, num_rounds=t, radio=TRadio(b_min=0.5 / k), solver="newton",
                  ranking="topm", top_m=TOP_M, traj="fused")
    # the ranked-row runs on the §VI per-client load with a budget that
    # drains most queues: the plain sort sweep runs the few positive
    # clients' candidates
    ranked_load = dict(radio=TRadio(b_min=0.5 / k, model_bits=TRadio().model_bits * (0.5 / k)
                                    / 0.02))
    h2 = torch.tensor(np.random.default_rng(0).exponential(size=(1, t, k)).astype(np.float32)
                      * 2.5e-4)
    eta = eta_schedule("uniform", t)
    drain = dict(budget_seq=torch.full((1, t, k), INC[1]))
    _, decs = simulate(cfg, h2, eta, V, device="cpu")
    assert decs.a.shape == (1, t, k)
    tt.check_fused_scope(dataclasses.replace(cfg, top_m=2048))
    failure = dict(failure_seq=TracedFailure(delivered=torch.ones(1, t, k), rate=torch.ones(1, k)))
    runs = [
        (dataclasses.replace(cfg, failure_mode="plain"), failure),
        (dataclasses.replace(cfg, failure_mode="reallocate"), failure),
        (dataclasses.replace(cfg, guard=GuardSpec(energy_cap=1.0)), {}),
        (dataclasses.replace(cfg, solver=register_chaos_solver("pallas", kind="budget").name), {}),
        (dataclasses.replace(cfg, metrics=MetricsSpec.of("queue:mean")), {}),
        (dataclasses.replace(cfg, ranking="sort", **ranked_load), {}),
        (dataclasses.replace(cfg, top_m=2049, **ranked_load), {}),
        (dataclasses.replace(cfg, failure_mode="overprovision", **ranked_load), failure),
    ]
    for c, kw in runs:
        assert tt.ranked_row(c, failure=bool(kw)) == (
            c.ranking == "sort" or c.top_m > 2048 or c.failure_mode == "overprovision")
        out = simulate(c, h2, eta, V, device="cpu", **kw,
                       **(drain if tt.ranked_row(c, failure=bool(kw)) else {}))
        assert out[1].a.shape == (1, t, k)
        if c.metrics is not None:
            assert out[2]["queue/mean"].shape == (1, k)
    with pytest.raises(NotImplementedError, match="chaos backends of pallas or bisect"):
        simulate(dataclasses.replace(cfg, solver=register_chaos_solver(
            "newton", kind="objective").name), h2, eta, V, device="cpu")


def test_grid_past_2048_fused_equals_scan():
    """``run_grid`` takes K > 2048 on traj="fused" under top-m: on the CPU
    its cells are the scan grid's bits (both run the plain round)."""
    from repro_torch.core.scenario import Scenario
    from repro_torch.sim import run_grid

    scn = [Scenario(name="wide", num_clients=K, num_rounds=3,
                    radio=TRadio(b_min=B_MIN, model_bits=BITS), energy_budget_j=0.15 / 100)]
    kw = dict(solver="pallas_tiled", ranking="topm", top_m=TOP_M, device="cpu")
    fused = run_grid(scn, ["ocean-u"], range(2), traj="fused", **kw)
    scan = run_grid(scn, ["ocean-u"], range(2), traj="scan", **kw)
    assert fused.a.shape[-1] == K and bool(fused.a.any())
    for f in ("a", "b", "e", "q", "num_selected"):
        assert torch.equal(getattr(fused, f), getattr(scan, f)), f
