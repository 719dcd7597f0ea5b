"""repro_torch's baselines (select_all, SMO, AMO, the dual oracle) and the
pattern policy against the JAX reference.

Both packages get the same numpy inputs (seeded exponential gains, K = 6,
T = 30, three seeds); reference-sampled radio and failure streams cross
over through ``repro_torch.convert``.  Tolerances: decisions exact, b
within 2e-4, utilities within 2e-4 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import baselines as jb  # noqa: E402
from repro.core.energy import RadioParams as JRadio  # noqa: E402
from repro.core.ocean import OceanConfig as JConfig  # noqa: E402
from repro.core.patterns import eta_schedule as j_eta_schedule  # noqa: E402
from repro.core.policy import pattern_trace as j_pattern_trace  # noqa: E402
from repro.core.scenario import Scenario as JScenario  # noqa: E402
from repro.env.spec import EnvSpec as JEnvSpec  # noqa: E402
from repro_torch.convert import failure_from_reference, radio_from_reference  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core.energy import RadioParams as TRadio  # noqa: E402
from repro_torch.core.ocean import OceanConfig as TConfig  # noqa: E402
from repro_torch.core.ocean import simulate  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.policy import (  # noqa: E402
    PolicyParams,
    pattern_trace_scores,
    run_policy,
)
from repro_torch.sim import run_grid  # noqa: E402

T, K = 30, 6
SEEDS = (0, 1, 2)
B_ATOL, U_RTOL = 2e-4, 2e-4


def _h2():
    return np.stack([
        (np.random.default_rng(s).exponential(size=(T, K)) * 2.5e-4).astype(np.float32)
        for s in SEEDS
    ])


def _cfgs(solver="bisect", **kw):
    return (JConfig(num_clients=K, num_rounds=T, radio=JRadio(), solver=solver, **kw),
            TConfig(num_clients=K, num_rounds=T, radio=TRadio(), solver=solver, **kw))


def _ref_streams():
    """Per-seed reference radio (spectrum sharing) and failure (dropout)
    streams, sampled in this process."""
    sc = JScenario(num_rounds=T, num_clients=K, env=JEnvSpec(
        radio="spectrum_sharing", radio_params={"share_min": 0.5, "share_max": 1.0},
        failure="iid_dropout", failure_params={"p_deliver": 0.8}))
    radios = [sc.sample_radio(s) for s in SEEDS]
    fails = [sc.sample_failure(s) for s in SEEDS]
    radio = jax.tree_util.tree_map(lambda *x: np.stack([np.asarray(v) for v in x]), *radios)
    fail = jax.tree_util.tree_map(lambda *x: np.stack([np.asarray(v) for v in x]), *fails)
    return radio, fail


def _stack_ref(fn):
    outs = [fn(i) for i in range(len(SEEDS))]
    return jax.tree_util.tree_map(lambda *x: np.stack([np.asarray(v) for v in x]), *outs)


def _check_trace(got, want, delivered=False):
    np.testing.assert_array_equal(got.a.numpy(), want.a)
    np.testing.assert_array_equal(got.num_selected.numpy(), want.num_selected)
    np.testing.assert_allclose(got.b.numpy(), want.b, atol=B_ATOL)
    np.testing.assert_allclose(got.e.numpy(), want.e, rtol=1e-4, atol=1e-9)
    if delivered:
        np.testing.assert_array_equal(got.delivered.numpy(), want.delivered)


@pytest.mark.parametrize("solver", ["bisect", "pallas"])
def test_select_all_matches_reference(solver):
    jc, tc = _cfgs(solver)
    h2 = _h2()
    want = _stack_ref(lambda i: jb.select_all(jc, jnp.asarray(h2[i])))
    got = tb.select_all(tc, torch.tensor(h2))
    _check_trace(got, want)
    assert bool(got.a.all()) and got.delivered is None


@pytest.mark.parametrize("with_seq", [False, True])
def test_smo_matches_reference(with_seq):
    jc, tc = _cfgs()
    h2 = _h2()
    seq = None
    if with_seq:  # a time-varying per-round cap
        seq = (np.random.default_rng(9).uniform(0.2, 2.0, (len(SEEDS), T, K)) * 0.15 / T)
        seq = seq.astype(np.float32)
    want = _stack_ref(lambda i: jb.smo(
        jc, jnp.asarray(h2[i]), budget_seq=None if seq is None else jnp.asarray(seq[i])))
    got = tb.smo(tc, torch.tensor(h2), budget_seq=None if seq is None else torch.tensor(seq))
    _check_trace(got, want)
    assert bool((got.num_selected > 0).any()) and bool((got.num_selected < K).any())


def test_amo_and_its_segments_match_reference():
    jc, tc = _cfgs()
    h2 = _h2()
    want = _stack_ref(lambda i: jb.amo(jc, jnp.asarray(h2[i])))
    got = tb.amo(tc, torch.tensor(h2))
    _check_trace(got, want)
    # split at round 11: the carried spend continues the same trajectory
    t0 = 11
    th2 = torch.tensor(h2)
    spent, first = tb.amo_segment(tc, torch.zeros((len(SEEDS), K)), th2[:, :t0], range(t0))
    _, second = tb.amo_segment(tc, spent, th2[:, t0:], range(t0, T))
    for f in ("a", "b", "e"):
        assert torch.equal(torch.cat([getattr(first, f), getattr(second, f)], 1), getattr(got, f))
    ref_parts = [
        jb.amo_segment(jc, jnp.zeros((K,)), jnp.asarray(h2[i, :t0]), jnp.arange(t0))
        for i in range(len(SEEDS))
    ]
    np.testing.assert_allclose(
        spent.numpy(), np.stack([np.asarray(p[0]) for p in ref_parts]), rtol=1e-5, atol=1e-9
    )


def test_baselines_with_radio_and_failure_streams_match_reference():
    jc, tc = _cfgs()
    h2 = _h2()
    radio, fail = _ref_streams()
    t_radio, t_fail = radio_from_reference(radio, "cpu"), failure_from_reference(fail, "cpu")
    th2 = torch.tensor(h2)
    cases = (
        ("select_all", lambda i, r, f: jb.select_all(jc, jnp.asarray(h2[i]), r, f),
         lambda: tb.select_all(tc, th2, t_radio, t_fail)),
        ("smo", lambda i, r, f: jb.smo(jc, jnp.asarray(h2[i]), radio_seq=r, failure_seq=f),
         lambda: tb.smo(tc, th2, radio_seq=t_radio, failure_seq=t_fail)),
        ("amo", lambda i, r, f: jb.amo(jc, jnp.asarray(h2[i]), radio_seq=r, failure_seq=f),
         lambda: tb.amo(tc, th2, radio_seq=t_radio, failure_seq=t_fail)),
    )
    for name, ref, port in cases:
        want = _stack_ref(lambda i: ref(
            i, jax.tree_util.tree_map(lambda x: jnp.asarray(x[i]), radio),
            jax.tree_util.tree_map(lambda x: jnp.asarray(x[i]), fail)))
        _check_trace(port(), want, delivered=True)
        eta = j_eta_schedule("uniform", T)
        got_u = tb.delivered_utility(port(), eta_schedule("uniform", T)).numpy()
        want_u = np.array([float(jb.delivered_utility(
            jb.PolicyTrace(*(jnp.asarray(getattr(want, f)[i]) if getattr(want, f) is not None
                             else None for f in jb.PolicyTrace._fields)), eta))
            for i in range(len(SEEDS))])
        np.testing.assert_allclose(got_u, want_u, rtol=U_RTOL, err_msg=name)


def test_lookahead_dual_matches_reference_and_bounds_ocean():
    """The dual oracle at 20 iterations; OCEAN reaches 0.6 x its utility
    (tests/test_ocean.py's practical Theorem-2 check)."""
    jc, tc = _cfgs()
    h2 = _h2()
    eta = j_eta_schedule("uniform", T)
    refs = [jb.lookahead_dual(jc, jnp.asarray(h2[i]), eta, num_iters=20) for i in range(3)]
    got, dual = tb.lookahead_dual(tc, torch.tensor(h2), eta_schedule("uniform", T), num_iters=20)
    want = _stack_ref(lambda i: refs[i][0])
    _check_trace(got, want)
    np.testing.assert_allclose(dual.numpy(), [float(r[1]) for r in refs], rtol=U_RTOL)
    u_oracle = tb.utility(got, eta_schedule("uniform", T))
    np.testing.assert_allclose(
        u_oracle.numpy(), [float(jb.utility(r[0], eta)) for r in refs], rtol=U_RTOL
    )
    _, decs = simulate(dataclasses.replace(tc, solver="pallas"), torch.tensor(h2),
                       eta_schedule("uniform", T), 1e-4, device="cpu")
    ours = (eta_schedule("uniform", T) * decs.num_selected.float()).sum(1)
    assert bool((ours >= 0.6 * u_oracle).all())


def test_pattern_matches_reference_on_its_scores():
    counts = jnp.asarray(np.random.default_rng(4).integers(0, K + 2, T), jnp.int32)
    key = jax.random.PRNGKey(11)
    want = j_pattern_trace(key, counts, K)
    keys = jax.random.split(key, T)
    scores = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (K,)))(keys))
    got = pattern_trace_scores(torch.tensor(scores), torch.tensor(np.asarray(counts)))
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_array_equal(got.num_selected.numpy(), np.asarray(want.num_selected))
    # through run_policy with a torch.Generator: counts[t] clients a round
    gen = torch.Generator().manual_seed(3)
    tc = TConfig(num_clients=K, num_rounds=T, radio=TRadio())
    tr = run_policy("pattern", tc, torch.tensor(_h2()),
                    PolicyParams(key=gen, counts=torch.tensor(np.asarray(counts))), device="cpu")
    want_n = np.minimum(np.asarray(counts), K)
    assert (tr.num_selected.numpy() == want_n[None]).all()
    with pytest.raises(ValueError, match="requires PolicyParams.key"):
        run_policy("pattern", tc, torch.tensor(_h2()), PolicyParams(counts=counts), device="cpu")


def test_baseline_policies_run_on_the_grid():
    """Every ported policy through run_grid: baselines report their
    selections as delivered, OCEAN variants agree with plain OCEAN without
    failures, and the engine's cells equal direct calls."""
    from repro_torch.core.scenario import paper_scenarios

    scen = paper_scenarios(T, K)
    pols = ["ocean-u", "ocean-over", "ocean-realloc", "smo", "amo", "select_all"]
    res = run_grid(scen, pols, SEEDS, solver="pallas", device="cpu")
    assert res.delivered is None and res.failure_seq is None and res.radio_seq is None
    for f in ("a", "b", "e", "q"):
        assert torch.equal(getattr(res, f)[0], getattr(res, f)[1])
        assert torch.equal(getattr(res, f)[0], getattr(res, f)[2])
    tc = dataclasses.replace(scen["scenario1"].ocean_config(), solver="pallas")
    direct = tb.smo(tc, res.h2[1])
    assert torch.equal(direct.a, res.a[3, 1]) and torch.equal(direct.b, res.b[3, 1])
    assert bool((res.q[3:] == 0).all())
