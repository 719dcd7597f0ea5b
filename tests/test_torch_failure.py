"""repro_torch's failure-aware OCEAN and per-round radio against the JAX
reference, and the port's own invariants for them.

* ``ocean_round`` under a traced radio and under each ``failure_mode``,
  teacher-forced: every (seed, round) of the reference's trajectory runs
  through the port's round on the reference's own queues and its own
  sampled streams (carried over by ``repro_torch.convert``).  Decisions
  and delivery masks exact outside near ties (the best and runner-up
  prefix W within 2e-4 |W*|), b within 2e-4, the P3 value within 2e-4
  relative, the next queues within 1e-6 + 1e-5 |q|.
* Inside the port: a static radio passed as (C, T) leaves and an all-ones
  failure mask give the pre-failure path's bits; ``ocean-over`` and
  ``ocean-realloc`` equal ``ocean-u`` without failures; K3's plain version
  equals the scan path for every new branch.
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
from repro.core.scenario import Scenario as JScenario  # noqa: E402
from repro.env.spec import EnvSpec as JEnvSpec  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    decisions_to_numpy,
    failure_from_reference,
    radio_from_reference,
    state_from_reference,
)
from repro_torch.core.energy import RadioParams as TRadio  # noqa: E402
from repro_torch.core.ocean import OceanConfig as TConfig  # noqa: E402
from repro_torch.core.ocean import ocean_round, simulate  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.scenario import Scenario, paper_scenarios  # noqa: E402
from repro_torch.core.selection import prefix_inputs, priorities  # noqa: E402
from repro_torch.env import EnvSpec, TracedFailure, traced_radio  # noqa: E402
from repro_torch.kernels import ocean_p as tk  # noqa: E402
from repro_torch.kernels.ocean_traj import ocean_traj_plain  # noqa: E402
from repro_torch.sim import run_grid  # noqa: E402

T, K, R = 40, 6, 13
SEEDS = (0, 1, 2, 3)
V = 1e-5
B_ATOL, W_RTOL = 2e-4, 2e-4
Q_ATOL, Q_RTOL = 1e-6, 1e-5

ENV = dict(
    radio="spectrum_sharing", radio_params={"share_min": 0.5, "share_max": 1.0},
    failure="iid_dropout", failure_params={"p_deliver": [0.9, 0.8, 0.7, 0.6, 0.8, 0.9]},
)


def _h2():
    return np.stack([
        (np.random.default_rng(s).exponential(size=(T, K)) * 2.5e-4).astype(np.float32)
        for s in SEEDS
    ])


def _ref_streams():
    """The reference's per-seed radio and failure streams, sampled here."""
    sc = JScenario(num_rounds=T, num_clients=K, env=JEnvSpec(**ENV))

    def stack(xs):
        return jax.tree_util.tree_map(lambda *v: np.stack([np.asarray(a) for a in v]), *xs)

    return stack([sc.sample_radio(s) for s in SEEDS]), stack([sc.sample_failure(s) for s in SEEDS])


_REF = {}


def _reference(mode, solver, radio_on, failure_on):
    key = (mode, solver, radio_on, failure_on)
    if key not in _REF:
        cfg = JConfig(num_clients=K, num_rounds=T, radio=JRadio(), frame_len=R, solver=solver,
                      failure_mode=mode)
        radio, fail = _ref_streams()
        eta = j_eta_schedule("ascend", T)

        def one(h2, rad, fl):
            return j_simulate(cfg, h2, eta, V, radio_seq=rad if radio_on else None,
                              failure_seq=fl if failure_on else None)

        radio_j = jax.tree_util.tree_map(jnp.asarray, radio)
        fail_j = jax.tree_util.tree_map(jnp.asarray, fail)
        _, decs = jax.jit(jax.vmap(one))(jnp.asarray(_h2()), radio_j, fail_j)
        _REF[key] = (jax.tree_util.tree_map(np.asarray, decs), radio, fail)
    return _REF[key]


def _near_ties(q_pre, radio, solver):
    """(S*T,) rounds whose two best prefix W (the plain K1 sweep under each
    round's own radio) lie within 2e-4 |W*|: a float32 flip there is no fault."""
    qq = torch.tensor(q_pre.reshape(-1, K))
    rho = priorities(qq, torch.tensor(_h2().reshape(-1, K)))
    _, rho_sorted, n0, delta = prefix_inputs(rho, radio)
    v_eta = V * eta_schedule("ascend", T).repeat(len(SEEDS))
    w = tk.prefix_objectives_plain(tk._scal(n0, delta, v_eta, radio, rho_sorted), rho_sorted)
    top2 = torch.topk(w, 2, dim=1).values
    return ((top2[:, 0] - top2[:, 1]) <= W_RTOL * top2[:, 0].abs()).numpy()


def _check_teacher_forced(mode, solver, radio_on, failure_on):
    ref, radio, fail = _reference(mode, solver, radio_on, failure_on)
    S = len(SEEDS)
    cfg = TConfig(num_clients=K, num_rounds=T, radio=TRadio(), frame_len=R, solver=solver,
                  failure_mode=mode)
    t_radio = radio_from_reference(radio, "cpu").map(lambda x: x.reshape(-1))
    t_fail = failure_from_reference(fail, "cpu")
    state = state_from_reference(ref.q.reshape(-1, K), np.tile(np.arange(T), S),
                                 np.zeros((S * T, K)), device="cpu")
    eta = eta_schedule("ascend", T).repeat(S)
    kw = {}
    if radio_on:
        kw["radio"] = t_radio
    if failure_on:
        kw["delivered"] = t_fail.delivered.reshape(-1, K)
        kw["fail_rate"] = t_fail.rate[:, None, :].expand(S, T, K).reshape(-1, K)
    h2 = torch.tensor(_h2().reshape(-1, K))
    nxt, dec = ocean_round(state, h2, V, eta, cfg, **kw)
    got = decisions_to_numpy(dec)
    # the plain mode's count on the same queues: what overprovision extends
    got["committed"] = ocean_round(state, h2, V, eta, dataclasses.replace(
        cfg, failure_mode="plain"), **kw)[1].num_selected.numpy()
    ok = ~_near_ties(ref.q, t_radio if radio_on else TRadio(), solver)
    assert ok.sum() >= 0.9 * ok.size
    flat = {f: getattr(ref, f).reshape((S * T,) + getattr(ref, f).shape[2:])
            for f in ("a", "b", "e", "num_selected", "objective", "delivered", "realloc")
            if getattr(ref, f) is not None}
    np.testing.assert_array_equal(got["a"][ok], flat["a"][ok])
    np.testing.assert_array_equal(got["num_selected"][ok], flat["num_selected"][ok])
    np.testing.assert_allclose(got["b"][ok], flat["b"][ok], atol=B_ATOL)
    np.testing.assert_allclose(got["objective"][ok], flat["objective"][ok], rtol=W_RTOL)
    np.testing.assert_allclose(got["e"][ok], flat["e"][ok], rtol=1e-3, atol=1e-8)
    if failure_on:
        np.testing.assert_array_equal(got["delivered"][ok], flat["delivered"][ok])
        np.testing.assert_array_equal(got["realloc"][ok], flat["realloc"][ok])
    else:
        assert "delivered" not in got
    q_next = nxt.q.numpy().reshape(S, T, K)[:, :-1]
    keep = ok.reshape(S, T)[:, :-1] & ((np.arange(1, T) % R) != 0)[None, :]
    np.testing.assert_allclose(q_next[keep], ref.q[:, 1:][keep], rtol=Q_RTOL, atol=Q_ATOL)
    return got, flat, ok


@pytest.mark.parametrize("mode", ["plain", "overprovision", "reallocate"])
def test_failure_modes_teacher_forced_match_reference(mode):
    got, flat, ok = _check_teacher_forced(mode, "bisect", False, True)
    if mode == "overprovision":  # compared rounds where the prefix was extended
        assert (flat["num_selected"][ok] > got["committed"][ok]).any()
    if mode == "reallocate":
        assert flat["realloc"].sum() > 0


def test_overprovision_with_the_newton_waterfiller_matches_reference():
    """solver="pallas": the sweep is K1's plain version and the extended
    prefix's P4 the Newton waterfiller, K3's masked P4's plain counterpart."""
    got, flat, ok = _check_teacher_forced("overprovision", "pallas", False, True)
    assert (flat["num_selected"][ok] > got["committed"][ok]).any()


def test_traced_radio_teacher_forced_matches_reference():
    _check_teacher_forced("plain", "bisect", True, False)
    _check_teacher_forced("reallocate", "bisect", True, True)


def _port_streams(S, dev="cpu"):
    radio = traced_radio(TRadio(), T).map(lambda x: x.expand(S, T))
    rng = np.random.default_rng(5)
    fail = TracedFailure(
        delivered=torch.tensor((rng.random((S, T, K)) < 0.75).astype(np.float32)),
        rate=torch.tensor(rng.uniform(0.6, 0.9, (S, K)).astype(np.float32)),
    )
    return radio, fail


def test_static_radio_and_no_failure_keep_the_pre_failure_bits():
    S = len(SEEDS)
    cfg = TConfig(num_clients=K, num_rounds=T, radio=TRadio(), frame_len=R, solver="pallas")
    h2, eta = torch.tensor(_h2()), eta_schedule("ascend", T)
    radio, _ = _port_streams(S)
    ones = TracedFailure(delivered=torch.ones((S, T, K)), rate=torch.ones((S, K)))
    for traj in ("scan", "fused"):
        s0, base = simulate(cfg, h2, eta, V, traj=traj, device="cpu")
        runs = [simulate(cfg, h2, eta, V, radio_seq=radio, traj=traj, device="cpu")]
        for mode in ("plain", "reallocate", "overprovision"):
            runs.append(simulate(dataclasses.replace(cfg, failure_mode=mode), h2, eta, V,
                                 failure_seq=ones, traj=traj, device="cpu"))
        for s1, decs in runs:
            for f in ("a", "b", "e", "q", "rho", "objective", "num_selected"):
                assert torch.equal(getattr(base, f), getattr(decs, f)), (traj, f)
            assert torch.equal(s0.q, s1.q) and torch.equal(s0.energy_spent, s1.energy_spent)
        assert base.delivered is None and base.realloc is None
        assert torch.equal(runs[-1][1].delivered, base.a)


def test_failure_aware_policies_equal_ocean_u_without_failures():
    res = run_grid(paper_scenarios(T, K), ["ocean-u", "ocean-over", "ocean-realloc"], (0, 1),
                   solver="pallas", traj="fused", device="cpu")
    for p in (1, 2):
        for f in ("a", "b", "e", "q", "num_selected"):
            assert torch.equal(getattr(res, f)[0], getattr(res, f)[p]), (p, f)


@pytest.mark.parametrize("mode", ["plain", "overprovision", "reallocate"])
def test_plain_k3_equals_the_scan_path_for_every_branch(mode):
    S = len(SEEDS)
    cfg = TConfig(num_clients=K, num_rounds=T, radio=TRadio(), frame_len=R, solver="pallas",
                  failure_mode=mode)
    h2, eta = torch.tensor(_h2()), eta_schedule("ascend", T)
    radio, fail = _port_streams(S)
    # a spectrum-sharing-like radio: the bandwidth of every round a random share
    share = torch.tensor(np.random.default_rng(6).uniform(0.5, 1.0, (S, T)), dtype=torch.float32)
    bw = radio.bandwidth_hz * share
    radio = radio._replace(bandwidth_hz=bw, beta=radio.model_bits / (radio.deadline_s * bw),
                           energy_scale=radio.deadline_s * radio.noise_w * bw)
    v = torch.full((S, T), V)
    inc = (cfg.budgets() / T).expand(S, T, K).contiguous()  # simulate's H_k / T
    etas = eta.expand(S, T).contiguous()
    for kw in ({"radio_seq": radio}, {"failure_seq": fail},
               {"radio_seq": radio, "failure_seq": fail}):
        st, decs = simulate(cfg, h2, eta, V, device="cpu", **kw)
        out = ocean_traj_plain(cfg, h2, v, etas, inc, radio=kw.get("radio_seq"),
                               failure=kw.get("failure_seq"))
        fused_st, fused = simulate(cfg, h2, eta, V, traj="fused", device="cpu", **kw)
        for a, b in (("a", "a"), ("b", "b"), ("e", "e"), ("q", "q_pre"), ("num_selected", "nsel"),
                     ("objective", "obj")):
            assert torch.equal(getattr(decs, a), getattr(out, b)), (kw.keys(), a)
            assert torch.equal(getattr(decs, a), getattr(fused, a)), (kw.keys(), a)
        if "failure_seq" in kw:
            assert torch.equal(decs.delivered, out.dlv) and torch.equal(decs.realloc, out.ral)
            assert bool((decs.delivered <= decs.a).all())
        assert torch.equal(st.q, out.q_final) and torch.equal(fused_st.q, st.q)


def test_reliability_grid_delivery_rates_and_clean_cell():
    """The reliability grid's shape at small size: delivered is a submask of
    the selections everywhere and equals them in the clean cell; each
    process's realized rate within 3 standard errors of its declared rate."""
    cells = [Scenario(name="clean", num_rounds=T, num_clients=K)] + [
        Scenario(name=n, num_rounds=T, num_clients=K, env=EnvSpec(failure=p, failure_params=pp))
        for n, p, pp in (("drop", "iid_dropout", {"p_deliver": 0.7}),
                         ("burst", "markov_availability", {"p_fail": 0.3, "p_recover": 0.3}),
                         ("strag", "straggler_slowdown", {"sigma": 0.8, "compute_frac": 0.6}))
    ]
    seeds = range(8)
    res = run_grid(cells, ["ocean-u", "ocean-over", "ocean-realloc", "smo", "amo"], seeds,
                   solver="pallas", traj="fused", device="cpu")
    assert bool((res.delivered <= res.a).all())
    assert torch.equal(res.delivered[:, 0], res.a[:, 0])
    for p in (1, 2):  # the clean cell's all-ones mask: ocean-u's bits
        for f in ("a", "b", "e", "q"):
            assert torch.equal(getattr(res, f)[0, 0], getattr(res, f)[p, 0]), (p, f)
    for s in (1, 2, 3):
        cell_means = res.failure_seq.delivered[s].double().mean((1, 2))
        se = float(cell_means.std()) / len(seeds) ** 0.5
        declared = float(res.failure_seq.rate[s].double().mean())
        assert abs(float(cell_means.mean()) - declared) <= 3.0 * se + 1e-9, s
    assert bool((res.num_selected[1, 1:] >= 0).all())
