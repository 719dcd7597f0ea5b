"""repro_torch.env — the environment processes — against the JAX reference.

* Deterministic parts of every lowering match the reference exactly: the
  content salt, the path-loss schedule, static budget increments, the
  declared delivery rates, the static radio's stored leaves.
* The port's samplers draw from ``torch.Generator`` streams, which cannot
  reproduce JAX's keys: each process is held to its declared mean, bounds
  and correlation (within 3 standard errors where it is a mean).
* Adding, removing or reordering scenarios never changes another cell's
  draws (the salt is the spec's content, never a grid index).
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.energy import RadioParams as JRadio  # noqa: E402
from repro.core.scenario import Scenario as JScenario  # noqa: E402
from repro.env import channel as jch  # noqa: E402
from repro.env import failure as jfa  # noqa: E402
from repro.env import radio as jra  # noqa: E402
from repro.env.spec import EnvSpec as JEnvSpec  # noqa: E402
from repro.env.spec import env_key_salt as j_salt  # noqa: E402
from repro_torch.convert import env_spec_from_reference, scenario_from_reference  # noqa: E402
from repro_torch.core.energy import RadioParams as TRadio  # noqa: E402
from repro_torch.core.scenario import Scenario, environment_zoo  # noqa: E402
from repro_torch.env import channel as tch  # noqa: E402
from repro_torch.env import energy as ten  # noqa: E402
from repro_torch.env import failure as tfa  # noqa: E402
from repro_torch.env import radio as tra  # noqa: E402
from repro_torch.env.spec import EnvSpec, cell_generator, env_key_salt  # noqa: E402
from repro_torch.sim import GridEngine, run_grid  # noqa: E402

T, K = 24, 5

SPECS = [
    {},
    {"channel": "gauss_markov", "channel_params": {"rho": 0.9}},
    {"channel": "markov_shadowing", "channel_params": {"p_enter": 0.15, "p_exit": 0.5,
                                                       "extra_db": 10.0}},
    {"channel": "mobility", "channel_params": {"area_m": 60.0, "speed_mps": [2.0, 5.0]}},
    {"budget": "harvesting", "budget_params": {"p_active": 0.5}},
    {"budget": "depleting", "budget_params": {"end_frac": 0.2}},
    {"radio": "spectrum_sharing", "radio_params": {"share_min": 0.5, "share_max": 1.0}},
    {"radio": "deadline_jitter", "radio_params": {"amp": 0.3, "rho": 0.5}},
    {"failure": "iid_dropout", "failure_params": {"p_deliver": [0.9, 0.8, 0.7, 0.6, 0.5]}},
    {"failure": "markov_availability", "failure_params": {"p_fail": 0.1, "p_recover": 0.4}},
    {"failure": "straggler_slowdown", "failure_params": {"sigma": 0.5, "compute_frac": 0.8}},
]


def _ctxs(spec_kw, radio_kw=None):
    radio_kw = radio_kw or {}
    kw = dict(num_rounds=T, num_clients=K, pathloss_db=(32.0, 45.0), fading=True,
              budgets_j=(0.1, 0.15, 0.2, 0.15, 0.15))
    return (jch.LowerCtx(radio=JRadio(**radio_kw), **kw),
            tch.LowerCtx(radio=TRadio(**radio_kw), **kw))


@pytest.mark.parametrize("idx", range(len(SPECS)))
def test_lowering_deterministic_parts_match_reference(idx):
    d = SPECS[idx]
    jspec = JEnvSpec(**d)
    tspec = env_spec_from_reference(json.loads(json.dumps(jspec.to_dict())))
    assert tspec.to_dict() == jspec.to_dict()
    jctx, tctx = _ctxs(d)
    assert env_key_salt(tspec, tctx) == j_salt(jspec, jctx)
    from repro.env.spec import lower_env as j_lower
    from repro_torch.env.spec import lower_env as t_lower

    jl, tl = j_lower(jspec, jctx), t_lower(tspec, tctx)
    assert tl.key_salt == jl.key_salt
    np.testing.assert_array_equal(tl.channel.sched_pl_db.numpy(), np.asarray(jl.channel.sched_pl_db))
    np.testing.assert_allclose(tl.channel.sched_gain.numpy(), np.asarray(jl.channel.sched_gain),
                               rtol=2e-7)
    for f in tch.ChannelParams._fields[2:]:
        np.testing.assert_array_equal(getattr(tl.channel, f).numpy(),
                                      np.asarray(getattr(jl.channel, f)), err_msg=f)
    for f in ten.BudgetParams._fields:
        want = np.asarray(getattr(jl.budget, f))
        if f == "det_inc" and d.get("budget") == "depleting":  # a float32 sum of the ramp
            np.testing.assert_allclose(getattr(tl.budget, f).numpy(), want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(getattr(tl.budget, f).numpy(), want, err_msg=f)
    for f in tra.RadioProcessParams._fields[1:]:
        np.testing.assert_array_equal(getattr(tl.radio, f).numpy(), np.asarray(getattr(jl.radio, f)))
    for f in tra.TracedRadio._fields:
        np.testing.assert_array_equal(getattr(tl.radio.base, f).numpy(),
                                      np.asarray(getattr(jl.radio.base, f)), err_msg=f)
    for f in tfa.FailureParams._fields:
        np.testing.assert_array_equal(getattr(tl.failure, f).numpy(),
                                      np.asarray(getattr(jl.failure, f)), err_msg=f)
    if "failure" in d:
        proc, jproc = tfa.get_failure_process(d["failure"]), jfa.get_failure_process(d["failure"])
        assert proc.delivery_rate(d["failure_params"], tctx) == \
            jproc.delivery_rate(d["failure_params"], jctx)


@pytest.mark.parametrize("kw", [{}, {"bandwidth_hz": 5e6, "deadline_s": 0.6},
                                {"b_min": 0.01, "model_bits": 2e5, "noise_w": 3e-13}])
def test_traced_radio_leaves_match_reference(kw):
    j, t = jra.traced_radio(JRadio(**kw), T), tra.traced_radio(TRadio(**kw), T)
    for f in tra.TracedRadio._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    # the stored leaves are the scalar path's float32 roundings
    r = TRadio(**kw)
    assert float(t.beta[0]) == float(np.float32(r.beta))
    assert float(t.energy_scale[0]) == float(np.float32(r.energy_scale))


def test_pathloss_schedule_and_scenario_payloads_match_reference():
    for start, end, n in ((36.0, 36.0, T), (32.0, 45.0, T), (45.0, 32.0, 7), (40.0, 30.0, 1)):
        np.testing.assert_array_equal(tch.pathloss_schedule(start, end, n).numpy(),
                                      np.asarray(jch.pathloss_schedule(start, end, n)))
    for d in SPECS:
        payload = JScenario(name="e", num_rounds=T, num_clients=K, env=JEnvSpec(**d),
                            failure_mode="reallocate").to_dict()
        sc = scenario_from_reference(json.loads(json.dumps(payload)))
        assert sc.to_dict() == payload and sc.env_spec().to_dict() == JEnvSpec(**d).to_dict()
        assert Scenario.from_json(sc.to_json()) == sc


def _cells(spec, n=64, T_=60, K_=K, radio=None):
    """n cells of one scenario through the engine's sampler (CPU)."""
    sc = Scenario(name="x", num_rounds=T_, num_clients=K_, env=spec,
                  radio=radio or TRadio())
    return GridEngine([sc], ["ocean"], device="cpu").sample_env(range(n))


def test_channel_samplers_hold_their_declared_statistics():
    # i.i.d. Rayleigh: the mean gain of every round within 3 sigma of g
    h2, *_ = _cells(EnvSpec(), n=200)
    g = tch.pathloss_to_gain(tch.pathloss_schedule(36.0, 36.0, 60)).double()
    mean = h2[0].double().mean((0, 2))
    assert bool((torch.abs(mean - g) <= 3.0 * g / math.sqrt(200 * K)).all())
    # Gauss-Markov: Exp(1) marginal, lag-1 correlation of the fades near
    # rho's copula value (0.9 -> ~0.8); i.i.d. ~0
    for rho, lo, hi in ((0.9, 0.7, 0.9), (0.0, -0.05, 0.05)):
        h2, *_ = _cells(EnvSpec(channel="gauss_markov", channel_params={"rho": rho}), n=100)
        x = (h2[0] / g[None, :, None]).double()
        assert abs(float(x.mean()) - 1.0) <= 3.0 / math.sqrt(x.numel() / 20)
        c = np.corrcoef(x[:, :-1].flatten().numpy(), x[:, 1:].flatten().numpy())[0, 1]
        assert lo <= c <= hi, (rho, c)
    # LOS/NLOS shadowing: the declared mean gain within 3 sigma
    spec = EnvSpec(channel="markov_shadowing",
                   channel_params={"p_enter": 0.2, "p_exit": 0.3, "extra_db": 10.0})
    h2, *_ = _cells(spec, n=300)
    sc = Scenario(num_rounds=60, num_clients=K, env=spec)
    want = sc.mean_gain_seq().double().mean()
    got = h2.double().mean()
    assert abs(float(got - want)) <= 3.0 * float(h2.double().std()) / math.sqrt(300 * K * 6)
    # mobility: path loss never below the reference distance's
    spec = EnvSpec(channel="mobility", channel_params={"area_m": 60.0, "fading": False})
    h2, *_ = _cells(spec, n=20)
    assert bool(torch.isfinite(h2).all()) and bool((h2 > 0).all())
    assert float(h2.max()) <= float(tch.pathloss_to_gain(32.0)) * (1 + 1e-6)
    assert float(h2.std()) > 0


def test_budget_radio_and_failure_samplers_hold_their_declared_statistics():
    n = 200
    _, dh, tot, _, _ = _cells(EnvSpec(budget="harvesting", budget_params={"p_active": 0.5}), n=n)
    per = 0.15 / 60
    # Exp packets of mean per/0.5 with probability 0.5: sd per*sqrt(3)
    assert abs(float(dh.double().mean()) - per) <= 3.0 * per * math.sqrt(3) / math.sqrt(dh.numel())
    torch.testing.assert_close(tot, dh.sum(2))
    _, dh, tot, _, _ = _cells(EnvSpec(budget="depleting"), n=2)
    torch.testing.assert_close(dh.sum(2).double(), tot.double(), rtol=1e-5, atol=0)
    assert bool((dh[..., 1:, :] <= dh[..., :-1, :]).all())

    eng = GridEngine([Scenario(name="s", num_rounds=60, num_clients=K, env=EnvSpec(
        radio="spectrum_sharing", radio_params={"share_min": 0.5, "share_max": 1.0,
                                                "num_levels": 5}))], ["ocean"], device="cpu")
    r = eng.sample_env(range(n))[3]
    share = r.bandwidth_hz / 10e6
    assert bool(((share >= 0.5 - 1e-6) & (share <= 1.0 + 1e-6)).all())
    levels = torch.unique(torch.round(share * 8) / 8)
    assert len(levels) == 5
    assert abs(float(share.double().mean()) - 0.75) <= 0.02
    torch.testing.assert_close(r.beta, r.model_bits / (r.deadline_s * r.bandwidth_hz))
    eng = GridEngine([Scenario(name="j", num_rounds=60, num_clients=K, env=EnvSpec(
        radio="deadline_jitter", radio_params={"amp": 0.3, "rho": 0.5}))], ["ocean"], device="cpu")
    tau = eng.sample_env(range(n))[3].deadline_s
    assert bool(((tau >= 0.3 * 0.7 - 1e-7) & (tau <= 0.3 * 1.3 + 1e-7)).all())
    assert abs(float(tau.double().mean()) - 0.3) <= 0.01

    for spec in SPECS[8:]:
        f = _cells(EnvSpec(**spec), n=n)[4]
        sc = Scenario(num_rounds=60, num_clients=K, env=EnvSpec(**spec))
        rate = torch.tensor(tfa.get_failure_process(spec["failure"]).delivery_rate(
            spec["failure_params"], sc.lower_ctx()))
        torch.testing.assert_close(f.rate[0, 0], rate.float())
        assert bool(((f.delivered == 0) | (f.delivered == 1)).all())
        # the process's realized rate within 3 standard errors of its
        # declared one: a Markov chain's draws correlate over rounds, so the
        # error is that of the cells' independent means
        cell_means = f.delivered[0].double().mean((1, 2))
        se = float(cell_means.std()) / math.sqrt(n)
        assert abs(float(cell_means.mean()) - float(rate.double().mean())) <= 3.0 * se, spec
    ones = _cells(EnvSpec(failure="none", failure_params={}), n=3)[4]
    assert ones is None  # no failure process in the grid: no streams


def test_salt_keeps_every_cells_draws_under_grid_reordering():
    a = Scenario(name="a", num_rounds=T, num_clients=K, env=EnvSpec(**SPECS[2]))
    b = Scenario(name="b", num_rounds=T, num_clients=K, env=EnvSpec(**SPECS[9]))
    c = Scenario(name="c", num_rounds=T, num_clients=K, env=EnvSpec(
        radio="deadline_jitter", budget="harvesting", failure="iid_dropout"))
    seeds = (0, 5)
    full = GridEngine([a, b, c], ["ocean"], device="cpu").sample_env(seeds)
    part = GridEngine([c, a], ["ocean"], device="cpu").sample_env(seeds)
    for i_full, i_part in ((0, 1), (2, 0)):
        for k in range(3):
            assert torch.equal(full[k][i_full], part[k][i_part])
        for x, y in zip(full[3], part[3]):
            assert torch.equal(x[i_full], y[i_part])
        assert torch.equal(full[4].delivered[i_full], part[4].delivered[i_part])
    # a scenario's own streams equal its single-cell samplers
    assert torch.equal(full[0][0, 1], a.sample_channel(5, device="cpu"))
    assert torch.equal(full[1][2, 1], c.sample_budget(5)[0])
    assert torch.equal(full[3].deadline_s[2, 1], c.sample_radio(5).deadline_s)
    assert torch.equal(full[4].delivered[2, 0], c.sample_failure(0).delivered)
    # a generator stream is a function of (seed, salt, stream) alone
    g1, g2 = cell_generator(123), cell_generator(123)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


def test_every_registered_process_runs_through_the_grid():
    zoo = environment_zoo(T, K)
    res = run_grid(zoo, ["ocean-u", "ocean-over", "ocean-realloc", "smo", "amo"], (0, 1),
                   solver="pallas", device="cpu")
    assert res.a.shape == (5, len(zoo), 2, T, K)
    for f in ("b", "e", "q", "h2"):
        assert bool(torch.isfinite(getattr(res, f)).all()), f
    assert res.radio_seq is not None and res.failure_seq is not None
    assert bool((res.delivered <= res.a).all())
    assert bool((res.b.sum(-1) <= 1.0 + 1e-4).all())
    names = list(res.scenarios)
    for fam in ("stationary", "markov_fading", "harvesting", "deadline_jitter"):
        s = names.index(fam)
        assert bool((res.failure_seq.delivered[s] == 1).all())
        assert torch.equal(res.delivered[:, s], res.a[:, s])
