"""K3 under ``ranking="topm"`` and with the ``newton`` and ``pallas_tiled``
solvers, on the CPU, against the JAX reference.

At K = 8, T = 12 and frame_len = 5 the port's fused trajectory
(``simulate(traj="fused", device="cpu")``, which runs K3's plain version
``ocean_traj_plain``) is held to the reference's ``simulate(traj="scan")``,
which the reference holds to its fused path bit for bit: every round
teacher-forced (the port's round, as a one-round K3 segment, on the
reference's own queues) and whole trajectories on seeds whose rounds are
clear of near ties.  top_m = 3 lies below the optimum on some rounds (the
clip saturates) and above it on others.  ``pallas_tiled`` is held per
round to the reference's oracle ``repro.kernels.ref.ocean_p_topm_ref`` (the
reference's own Pallas path fails on this tree), on the rounds whose
optimum fits the clip.  The top-m newton case runs with a guard and
failure_mode="overprovision" on both sides (the same GuardSpec and
TracedFailure).  Selections exact, b within 2e-4, the P3 value within
2e-4 relative, as the reference's tests.
"""
import dataclasses

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
from repro.kernels.ref import ocean_p_topm_ref  # noqa: E402
from repro_torch.checkpoint import CheckpointSpec  # noqa: E402
from repro_torch.convert import decisions_to_numpy, failure_from_reference  # noqa: E402
from repro_torch.core.energy import RadioParams as TRadio  # noqa: E402
from repro_torch.core.ocean import OceanConfig as TConfig  # noqa: E402
from repro_torch.core.ocean import simulate  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.selection import prefix_inputs  # noqa: E402
from repro_torch.guard import GuardSpec, register_chaos_solver  # noqa: E402
from repro_torch.kernels import ocean_p as tk  # noqa: E402
from repro_torch.kernels import ocean_traj as tt  # noqa: E402

T, K, R, TOP_M = 12, 8, 5, 3
SEEDS = (0, 1, 2, 3)
S = len(SEEDS)
V = 1e-5
B_ATOL, W_RTOL = 2e-4, 2e-4
Q_ATOL = 1e-6


def _h2():
    """(S, T, K) channel gains, one numpy draw per seed."""
    return np.stack([
        (np.random.default_rng(s).exponential(size=(T, K)) * 2.5e-4).astype(np.float32)
        for s in SEEDS
    ])


def _failure():
    """(S, T, K) delivery masks at rate ~0.7 and (S, K) declared rates."""
    rng = np.random.default_rng(5)
    dlv = (rng.random((S, T, K)) < 0.7).astype(np.float32)
    return dlv, np.full((S, K), 0.7, np.float32)


def _reference(solver, ranking, guard=None, failure_mode="plain", failure=None):
    """The reference's scan trajectory of every seed (vmapped, jitted once),
    with ``guard`` (a ``repro.guard.GuardSpec``) and ``failure`` (the (S, T,
    K) delivery masks and (S, K) rates of ``_failure``) where given."""
    cfg = JConfig(num_clients=K, num_rounds=T, radio=JRadio(), frame_len=R, solver=solver,
                  ranking=ranking, top_m=TOP_M, guard=guard, failure_mode=failure_mode)
    eta = j_eta_schedule("ascend", T)

    def one(h2, fl):
        return j_simulate(cfg, h2, eta, V, failure_seq=fl, traj="scan")

    fl = None if failure is None else JFailure(*(jnp.asarray(x) for x in failure))
    state, decs = jax.jit(jax.vmap(one))(jnp.asarray(_h2()), fl)
    return (jax.tree_util.tree_map(np.asarray, state), jax.tree_util.tree_map(np.asarray, decs))


def _cfg(solver, ranking, **kw):
    return TConfig(num_clients=K, num_rounds=T, radio=TRadio(), frame_len=R, solver=solver,
                   ranking=ranking, top_m=TOP_M, traj="fused", **kw)


def _near_ties(rho, n_cands):
    """(S*T,) rounds whose two best prefix W among the candidates the clip
    admits (the plain K1 sweep on the (S, T, K) priorities ``rho``) lie
    within 2e-4 |W*|: a float32 flip there is no fault."""
    radio = TRadio()
    _, rho_sorted, n0, delta = prefix_inputs(torch.tensor(rho.reshape(-1, K)), radio)
    v_eta = V * eta_schedule("ascend", T).repeat(S)
    w = tk.prefix_objectives_plain(tk._scal(n0, delta, v_eta, radio, rho_sorted), rho_sorted,
                                   n_cands=n_cands)
    top2 = torch.topk(w, 2, dim=1).values
    return ((top2[:, 0] - top2[:, 1]) <= W_RTOL * top2[:, 0].abs()).numpy()


def _rounds_alone(cfg, q_pre, failure=None):
    """K3's plain version on every (seed, round) of the given (S, T, K)
    queues (``ocean_traj.rounds_alone``), as (S*T, ...) numpy rows."""
    eta = eta_schedule("ascend", T).expand(S, T)
    out = tt.rounds_alone(cfg, torch.tensor(q_pre), torch.tensor(_h2()), torch.full((S, T), V),
                          eta, torch.full((S, T, K), 0.15 / T), failure=failure)
    return {f: getattr(out, f).reshape(S * T, -1).squeeze(-1).numpy()
            for f in ("a", "b", "obj", "nsel", "dlv", "dm") if getattr(out, f) is not None}


def _m_star(nsel, rho):
    return tt.m_star(torch.tensor(np.asarray(nsel)), torch.tensor(np.asarray(rho))).numpy()


@pytest.mark.parametrize("solver,ranking,composed", [
    ("newton", "sort", False), ("newton", "topm", True), ("pallas", "topm", False),
    ("bisect", "topm", False)])
def test_fused_matches_the_reference_scan(solver, ranking, composed, tmp_path):
    """``composed``: a guard (cap 1) and failure_mode="overprovision" on
    both sides, the same GuardSpec and TracedFailure; the deliveries and
    the guard's demotions must then agree too, and the trajectory run as
    5-round segments equals the whole fused launch bit for bit."""
    kw, fail = {}, None
    if composed:
        dlv, rate = _failure()
        ref_state, ref = _reference(solver, ranking, guard=JGuard(energy_cap=1.0),
                                    failure_mode="overprovision", failure=(dlv, rate))
        kw = dict(failure_mode="overprovision", guard=GuardSpec(energy_cap=1.0))
        fail = failure_from_reference(JFailure(delivered=dlv, rate=rate), "cpu")
    else:
        ref_state, ref = _reference(solver, ranking)
    cfg = _cfg(solver, ranking, **kw)
    n_cands = TOP_M if ranking == "topm" else K
    near = _near_ties(ref.rho, n_cands)
    ok = ~near
    assert near.sum() <= 4
    # every round, teacher-forced
    got = _rounds_alone(cfg, ref.q, fail)
    np.testing.assert_array_equal(got["a"][ok], ref.a.reshape(-1, K)[ok])
    np.testing.assert_array_equal(got["nsel"][ok], ref.num_selected.reshape(-1)[ok])
    np.testing.assert_allclose(got["b"][ok], ref.b.reshape(-1, K)[ok], atol=B_ATOL, rtol=0)
    np.testing.assert_allclose(got["obj"][ok], ref.objective.reshape(-1)[ok], rtol=W_RTOL)
    if composed:
        np.testing.assert_array_equal(got["dlv"][ok], ref.delivered.reshape(-1, K)[ok])
        np.testing.assert_array_equal(got["dm"][ok], ref.demoted.reshape(-1)[ok])
        assert ref.demoted.sum() > 0 and (ref.delivered < ref.a).any()
    if ranking == "topm":  # the clip saturates on some rounds, not on others
        m_star = _m_star(ref.num_selected, ref.rho).reshape(-1)
        assert (m_star >= TOP_M).any() and ((m_star < TOP_M) & (m_star > 0)).any()
        if not composed:  # overprovision selects past the clip
            assert (_m_star(got["nsel"], ref.rho.reshape(-1, K)) <= TOP_M).all()
    # whole trajectories, on the seeds clear of near ties
    state, decs = simulate(cfg, torch.tensor(_h2()), eta_schedule("ascend", T), V,
                           failure_seq=fail, traj="fused", device="cpu")
    d = decisions_to_numpy(decs)
    clean = ~near.reshape(S, T).any(1)
    assert clean.sum() >= 2
    fields = ("a", "num_selected") + (("delivered", "fault_count", "demoted", "fallback")
                                      if composed else ())
    for f in fields:
        np.testing.assert_array_equal(d[f][clean], getattr(ref, f)[clean], err_msg=f)
    np.testing.assert_allclose(d["b"][clean], ref.b[clean], atol=B_ATOL, rtol=0)
    np.testing.assert_allclose(state.q.numpy()[clean], ref_state.q[clean], rtol=1e-4,
                               atol=Q_ATOL)
    if composed:  # as 5-round segments, bit for bit the whole launch
        _assert_segments_equal(cfg, fail, (state, decs), tmp_path)


def _assert_segments_equal(cfg, fail, whole, tmp_path):
    seg = simulate(cfg, torch.tensor(_h2()), eta_schedule("ascend", T), V, failure_seq=fail,
                   device="cpu", checkpoint=CheckpointSpec(directory=str(tmp_path),
                                                           every_rounds=5))
    for x, y in zip(jax.tree_util.tree_leaves(whole), jax.tree_util.tree_leaves(seg)):
        assert torch.equal(x, y)


def test_pallas_tiled_rounds_match_the_oracle():
    """pallas_tiled (K2's semantics in K3's round) per round against the
    reference's oracle on the trajectory's own queues, where its optimum
    fits the clip: at top_m = K on every round, at top_m = 3 on the rounds
    that fit (the others hold the clip)."""
    oracle = jax.jit(jax.vmap(lambda q, h, e: ocean_p_topm_ref(q, h, V, e, JRadio())))
    eta = eta_schedule("ascend", T)
    h2 = _h2()
    for top_m in (K, TOP_M):
        cfg = dataclasses.replace(_cfg("pallas_tiled", "topm"), top_m=top_m)
        _, decs = simulate(cfg, torch.tensor(h2), eta, V, traj="fused", device="cpu")
        d = decisions_to_numpy(decs)
        ref = oracle(jnp.asarray(d["q"].reshape(-1, K)), jnp.asarray(h2.reshape(-1, K)),
                     jnp.asarray(np.tile(np.asarray(eta), S)))
        m_ref = _m_star(np.asarray(ref.num_selected), np.asarray(ref.rho))
        m_got = _m_star(d["num_selected"].reshape(-1), d["rho"].reshape(-1, K))
        assert (m_got <= top_m).all()
        ok = (m_ref <= top_m) & ~_near_ties(d["rho"], K)
        assert ok.sum() >= S * T // 2
        if top_m < K:
            assert (m_got == top_m).any()
        np.testing.assert_array_equal(d["a"].reshape(-1, K)[ok], np.asarray(ref.a)[ok])
        np.testing.assert_array_equal(m_got[ok], m_ref[ok])
        np.testing.assert_allclose(d["b"].reshape(-1, K)[ok], np.asarray(ref.b)[ok],
                                   atol=B_ATOL, rtol=0)
        np.testing.assert_allclose(d["objective"].reshape(-1)[ok],
                                   np.asarray(ref.objective)[ok], rtol=W_RTOL)


def test_fused_scope_takes_the_new_branches_and_refuses_the_rest():
    for solver, ranking in (("pallas", "sort"), ("bisect", "sort"), ("newton", "sort"),
                            ("pallas", "topm"), ("bisect", "topm"), ("newton", "topm"),
                            ("pallas_tiled", "topm")):
        tt.check_fused_scope(_cfg(solver, ranking))
    tt.check_fused_scope(_cfg(register_chaos_solver("bisect", kind="budget").name, "topm"))
    with pytest.raises(NotImplementedError, match="chaos"):
        tt.check_fused_scope(_cfg(register_chaos_solver("newton", kind="objective").name, "sort"))
    # past the shared-memory sort the wide instances take every ranking:
    # top-m with a clip of at most 2048 on the compact row, sort, a clip past
    # it and overprovision on the ranked row
    big = TConfig(num_clients=2049, num_rounds=T, radio=TRadio(b_min=1e-4), solver="newton",
                  ranking="topm", traj="fused")
    tt.check_fused_scope(big)
    assert not tt.ranked_row(big) and not tt.ranked_row(big, failure=True)
    for c, failure in ((dataclasses.replace(big, ranking="sort"), False),
                       (dataclasses.replace(big, top_m=2049), False),
                       (dataclasses.replace(big, failure_mode="overprovision"), True)):
        tt.check_fused_scope(c)
        assert tt.ranked_row(c, failure=failure)
    assert not tt.ranked_row(dataclasses.replace(big, failure_mode="overprovision"))
    # pallas_tiled is sort-free: the config refuses sort, and so does K3
    # with the scan path's ValueError where a config slips past it
    with pytest.raises(ValueError, match="sort-free"):
        _cfg("pallas_tiled", "sort")
    tiled = _cfg("pallas_tiled", "topm")
    object.__setattr__(tiled, "ranking", "sort")
    with pytest.raises(ValueError, match="sort-free: it fuses top-m extraction"):
        tt.check_fused_scope(tiled)
    # stream_bf16 runs: the float rows come back as the float32 run's, cast
    h2 = torch.tensor(_h2()[:1])
    runs = [simulate(_cfg("newton", "topm"), h2, eta_schedule("ascend", T), V, traj="fused",
                     device="cpu", stream_bf16=bf) for bf in (False, True)]
    (s32, d32), (s16, d16) = runs
    for f in ("b", "e", "q", "rho"):
        assert getattr(d16, f).dtype == torch.bfloat16
        assert torch.equal(getattr(d16, f), getattr(d32, f).to(torch.bfloat16)), f
    assert torch.equal(d16.a, d32.a) and torch.equal(s16.q, s32.q)


def test_pallas_tiled_composes_with_a_guard_a_failure_mode_and_segments(tmp_path):
    """A guard (cap 1) and failure_mode="overprovision" on a top-m
    pallas_tiled trajectory: run as 5-round segments it equals the whole
    fused launch bit for bit (the reference's own pallas_tiled path fails
    on this tree; ``test_pallas_tiled_rounds_match_the_oracle`` holds
    pallas_tiled per round to ``ocean_p_topm_ref``)."""
    dlv, rate = _failure()
    fail = failure_from_reference(JFailure(delivered=dlv, rate=rate), "cpu")
    cfg = _cfg("pallas_tiled", "topm", failure_mode="overprovision",
               guard=GuardSpec(energy_cap=1.0))
    whole = simulate(cfg, torch.tensor(_h2()), eta_schedule("ascend", T), V, failure_seq=fail,
                     device="cpu")
    _assert_segments_equal(cfg, fail, whole, tmp_path)
    d = decisions_to_numpy(whole[1])
    assert d["demoted"].sum() > 0 and (d["num_selected"] > 0).any()
    assert (d["delivered"] <= d["a"]).all()
