"""repro_torch's OCEAN trajectory (Alg. 1) against the JAX reference.

At K = 6, T = 40 and frame_len = 13 (three frame resets) the port's
``simulate`` is held to the reference's on the scan path (bisect and
pallas solvers): whole trajectories on seeds whose every round is clear
of near ties, and every round of every seed teacher-forced (the port's
round run on the reference's own queues).  This file checks the bisect
solver; tests/test_torch_ocean_pallas.py uses its helpers for the pallas
solver on the scan and the fused path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.energy import RadioParams as JRadio  # noqa: E402
from repro.core.ocean import OceanConfig as JConfig  # noqa: E402
from repro.core.ocean import simulate as j_simulate  # noqa: E402
from repro.core.ocean import v_schedule as j_v_schedule  # noqa: E402
from repro.core.patterns import eta_schedule as j_eta_schedule  # noqa: E402
from repro_torch.convert import decisions_to_numpy, state_from_reference  # noqa: E402
from repro_torch.core.energy import RadioParams as TRadio  # noqa: E402
from repro_torch.core.ocean import OceanConfig as TConfig  # noqa: E402
from repro_torch.core.ocean import ocean_round, simulate, v_schedule  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.selection import prefix_inputs, priorities  # noqa: E402
from repro_torch.kernels import ocean_p as tk  # noqa: E402

T, K, R = 40, 6, 13
SEEDS = (0, 1, 2, 3)
V = 1e-5
B_ATOL, W_RTOL = 2e-4, 2e-4
Q_ATOL, Q_RTOL = 1e-6, 1e-5


def _h2():
    """(S, T, K) channel gains, one numpy draw per seed."""
    return np.stack(
        [
            (np.random.default_rng(s).exponential(size=(T, K)) * 2.5e-4).astype(np.float32)
            for s in SEEDS
        ]
    )


_REF_CACHE = {}


def _reference(solver, traj):
    """The reference trajectory of every seed (vmapped, jitted once)."""
    key = (solver, traj)
    if key not in _REF_CACHE:
        cfg = JConfig(num_clients=K, num_rounds=T, radio=JRadio(), frame_len=R, solver=solver)
        eta = j_eta_schedule("ascend", T)
        fn = jax.jit(jax.vmap(lambda h: j_simulate(cfg, h, eta, V, traj=traj)))
        state, decs = fn(jnp.asarray(_h2()))
        _REF_CACHE[key] = (
            jax.tree_util.tree_map(np.asarray, state),
            jax.tree_util.tree_map(np.asarray, decs),
        )
    return _REF_CACHE[key]


_PORT_CACHE = {}


def _port(solver, traj):
    key = (solver, traj)
    if key not in _PORT_CACHE:
        cfg = TConfig(num_clients=K, num_rounds=T, radio=TRadio(), frame_len=R, solver=solver)
        _PORT_CACHE[key] = simulate(
            cfg, torch.tensor(_h2()), eta_schedule("ascend", T), V, traj=traj, device="cpu"
        )
    return _PORT_CACHE[key]


def _near_tie_rounds(q_pre, h2, eta):
    """(S, T) rounds whose best and runner-up prefix W (K1 sweep) differ by
    at most 2e-4 |W*| — a float32 flip there is not a fault."""
    radio = TRadio()
    qq = torch.tensor(q_pre.reshape(-1, K))
    rho = priorities(qq, torch.tensor(h2.reshape(-1, K)))
    _, rho_sorted, n0, delta = prefix_inputs(rho, radio)
    v_eta = V * torch.tensor(np.tile(eta, len(SEEDS)))
    w = tk.prefix_objectives_plain(tk._scal(n0, delta, v_eta, radio, rho_sorted), rho_sorted)
    top2 = torch.topk(w, 2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) <= W_RTOL * top2[:, 0].abs()
    return near.reshape(len(SEEDS), T).numpy()


def _teacher_forced(solver, ref_decs):
    """Every (seed, round) through the port's ocean_round on the
    reference's own pre-update queues, as one batch of S*T cells."""
    cfg = TConfig(num_clients=K, num_rounds=T, radio=TRadio(), frame_len=R, solver=solver)
    state = state_from_reference(
        ref_decs.q.reshape(-1, K), np.tile(np.arange(T), len(SEEDS)),
        np.zeros((len(SEEDS) * T, K)), device="cpu",
    )
    eta = eta_schedule("ascend", T).repeat(len(SEEDS))
    nxt, dec = ocean_round(state, torch.tensor(_h2().reshape(-1, K)), V, eta, cfg)
    return nxt, decisions_to_numpy(dec)


def check_teacher_forced(solver):
    _, ref = _reference(solver, "scan")
    nxt, got = _teacher_forced(solver, ref)
    S = len(SEEDS)
    near = _near_tie_rounds(ref.q, _h2(), np.asarray(j_eta_schedule("ascend", T)))
    ok = ~near.reshape(-1)
    a_ref = ref.a.reshape(-1, K)
    np.testing.assert_array_equal(got["a"][ok], a_ref[ok])
    np.testing.assert_array_equal(got["num_selected"][ok], ref.num_selected.reshape(-1)[ok])
    np.testing.assert_allclose(got["b"][ok], ref.b.reshape(-1, K)[ok], atol=B_ATOL)
    np.testing.assert_allclose(got["objective"][ok], ref.objective.reshape(-1)[ok], rtol=W_RTOL)
    # the next round's queues, wherever no frame reset intervenes
    q_next = nxt.q.numpy().reshape(S, T, K)[:, :-1]
    q_ref = ref.q[:, 1:]
    keep = ok.reshape(S, T)[:, :-1] & ((np.arange(1, T) % R) != 0)[None, :]
    np.testing.assert_allclose(q_next[keep], q_ref[keep], rtol=Q_RTOL, atol=Q_ATOL)
    assert near.sum() <= 2  # near ties are rare; most rounds are compared


def check_whole_trajectory(solver, traj):
    """The port's own trajectory, compared whole on the seeds none of whose
    rounds is a near tie (a flip there legitimately changes every later
    queue)."""
    ref_state, ref = _reference(solver, traj)
    state, decs = _port(solver, traj)
    got = decisions_to_numpy(decs)
    clean = ~_near_tie_rounds(ref.q, _h2(), np.asarray(j_eta_schedule("ascend", T))).any(1)
    assert clean.sum() >= 2
    np.testing.assert_array_equal(got["a"][clean], ref.a[clean])
    np.testing.assert_array_equal(got["num_selected"][clean], ref.num_selected[clean])
    np.testing.assert_allclose(got["b"][clean], ref.b[clean], atol=B_ATOL)
    np.testing.assert_allclose(got["q"][clean], ref.q[clean], rtol=1e-4, atol=Q_ATOL)
    np.testing.assert_allclose(
        state.energy_spent.numpy()[clean], ref_state.energy_spent[clean], rtol=1e-4
    )
    assert state.t.dtype == torch.int32 and int(state.t[0]) == T


def test_scan_rounds_teacher_forced_match_reference():
    check_teacher_forced("bisect")


def test_whole_trajectory_matches_reference():
    check_whole_trajectory("bisect", "scan")


def test_schedules_match_reference():
    for name in ("uniform", "ascend", "descend"):
        np.testing.assert_allclose(
            eta_schedule(name, T).numpy(), np.asarray(j_eta_schedule(name, T)), rtol=1e-6
        )
    jc = JConfig(num_clients=K, num_rounds=T, radio=JRadio(), frame_len=R)
    tc = TConfig(num_clients=K, num_rounds=T, radio=TRadio(), frame_len=R)
    vs = np.array([1e-5, 2e-5, 3e-5, 4e-5], np.float32)
    np.testing.assert_array_equal(v_schedule(tc, vs).numpy(), np.asarray(j_v_schedule(jc, vs)))
    with pytest.raises(ValueError, match="frames"):
        v_schedule(tc, vs[:3])


def test_fused_scope_and_config_validation():
    cfg = TConfig(num_clients=K, num_rounds=T, radio=TRadio(), solver="bisect")
    with pytest.raises(NotImplementedError, match="fused"):
        simulate(cfg, torch.tensor(_h2()), eta_schedule("uniform", T), V, traj="fused", device="cpu")
    with pytest.raises(ValueError, match="frame_len"):
        TConfig(num_clients=K, num_rounds=T, radio=TRadio(), frame_len=0)
    with pytest.raises(ValueError, match="sort-free"):
        TConfig(num_clients=K, num_rounds=T, radio=TRadio(), solver="pallas_tiled")
    with pytest.raises(ValueError, match="infeasible"):
        TConfig(num_clients=100, num_rounds=T, radio=TRadio())
