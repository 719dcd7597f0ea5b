"""repro_torch's grid engine, scenarios and channel, and guards on the package.

* ``run_grid`` flattens (scenario, seed) cells into one cell axis: every
  cell must equal a ``simulate`` call on that cell alone, bit for bit.
* ``scenario_from_reference`` takes the reference's ``Scenario.to_dict()``
  and gives back the same payload; fields this slice does not port raise.
* The i.i.d. Rayleigh sampler draws from a ``torch.Generator``, so it is
  held to the reference in distribution: the mean gain of every round is
  within 3 sigma of ``pathloss_to_gain``.
* The port imports neither ``jax``, ``repro`` nor ``benchmarks``; its
  entry points refuse to fall back to the CPU; unported hooks raise.
"""
import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.channel import pathloss_schedule as j_pathloss_schedule  # noqa: E402
from repro.core.channel import pathloss_to_gain as j_pathloss_to_gain  # noqa: E402
from repro.core.energy import RadioParams as JRadio  # noqa: E402
from repro.core.scenario import Scenario as JScenario  # noqa: E402
from repro.core.scenario import paper_scenarios as j_paper_scenarios  # noqa: E402
from repro_torch.checkpoint import CheckpointSpec  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    decisions_to_numpy,
    scenario_from_reference,
    state_from_reference,
)
from repro_torch.core import OceanConfig, RadioParams, Scenario, paper_scenarios, simulate  # noqa: E402
from repro_torch.core.channel import pathloss_schedule, pathloss_to_gain  # noqa: E402
from repro_torch.core.ocean import init_state, ocean_round  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.policy import PolicyParams  # noqa: E402
from repro_torch.guard import GuardSpec  # noqa: E402
from repro_torch.sim import GridEngine, run_grid  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
T, K = 12, 5


def test_run_grid_equals_per_cell_simulate_bitwise():
    scen = paper_scenarios(T, K)
    pols = ["ocean-u", ("ocean-a", PolicyParams(v=2e-5))]
    seeds = (0, 3)
    res = run_grid(scen, pols, seeds, solver="pallas", device="cpu")
    assert res.a.shape == (2, 3, 2, T, K) and res.h2.shape == (3, 2, T, K)
    assert res.num_selected.dtype == torch.int32
    cfg = scen["stationary"].ocean_config()
    cfg = OceanConfig(**{**cfg.__dict__, "solver": "pallas"})
    cells = [(p, s, 1) for p in range(2) for s in range(3)] + [(0, 0, 0)]
    for p, s, n in cells:  # every policy x scenario, and both seeds
        eta_name, v = (("uniform", 1e-5), ("ascend", 2e-5))[p]
        state, decs = simulate(cfg, res.h2[s, n][None], eta_schedule(eta_name, T), v, device="cpu")
        cell = res.cell(res.policies[p], res.scenarios[s], seeds[n])
        for f in ("a", "b", "e", "num_selected", "q"):
            assert torch.equal(getattr(cell, f), getattr(decs, f)[0]), (p, s, n, f)
        assert torch.equal(res.energy_spent[p, s, n], decs.e[0].sum(0))
        torch.testing.assert_close(
            res.energy_spent[p, s, n], state.energy_spent[0], rtol=1e-6, atol=0
        )
    # seeds share fading across scenarios, scaled by each scenario's mean gain
    g = torch.stack([sc.mean_gain_seq() for sc in scen.values()])
    fade = res.h2 / g[:, None, :, None]
    torch.testing.assert_close(fade[0], fade[1], rtol=1e-6, atol=0)


def test_grid_checks_compatibility_and_unported_hooks():
    a = Scenario(name="a", num_clients=K, num_rounds=T)
    with pytest.raises(ValueError, match="grid-incompatible"):
        GridEngine([a, Scenario(name="b", num_clients=K, num_rounds=T + 1)], ["ocean"], device="cpu")
    for kw in ({"experiment": object()}, {"shard": True}):
        with pytest.raises(NotImplementedError):
            GridEngine([a], ["ocean"], device="cpu", **kw)
    # checkpointing is ported: a CheckpointSpec runs, anything else is refused
    with pytest.raises(TypeError, match="checkpoint"):
        GridEngine([a], ["ocean"], device="cpu", checkpoint=object())
    ck = CheckpointSpec(directory="unused", every_rounds=5)
    assert GridEngine([a], ["ocean"], device="cpu", checkpoint=ck).cfg.checkpoint == ck
    # the metrics are ported: a MetricsSpec runs, anything else is refused
    with pytest.raises(TypeError, match="metrics"):
        GridEngine([a], ["ocean"], device="cpu", metrics=object())
    # the guard is ported: a GuardSpec runs, anything else is refused
    with pytest.raises(TypeError, match="guard"):
        GridEngine([a], ["ocean"], device="cpu", guard=object())
    assert GridEngine([a], ["ocean"], device="cpu", guard=GuardSpec()).cfg.guard == GuardSpec()
    with pytest.raises(ValueError, match="grid-incompatible"):
        GridEngine([a, Scenario(name="b", num_clients=K, num_rounds=T, guard=GuardSpec())],
                   ["ocean"], device="cpu")
    # the baselines and failure-aware variants are ported: they run
    for name in ("smo", "amo", "select_all", "ocean-over", "ocean-realloc"):
        assert GridEngine([a], [name], device="cpu").policies == (name,)
    with pytest.raises(ValueError, match="counts"):
        run_grid([a], ["pattern"], [0], device="cpu")
    with pytest.raises(ValueError, match="grid-incompatible"):
        GridEngine([a, Scenario(name="b", num_clients=K, num_rounds=T,
                                failure_mode="reallocate")], ["ocean"], device="cpu")
    with pytest.raises(ValueError, match="unknown OCEAN variant"):
        GridEngine([a], ["ocean-x"], device="cpu")
    res = run_grid([a], ["ocean"], [1], solver="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown seed"):
        res.cell("ocean", "a", 2)


def _reference_payloads():
    yield from (sc.to_dict() for sc in j_paper_scenarios(T, K).values())
    yield JScenario(
        name="custom", num_clients=4, num_rounds=9, pathloss_db=(33.0, 40.0),
        fading=False, radio=JRadio(b_min=0.01, model_bits=2e5),
        energy_budget_j=(0.1, 0.2, 0.3, 0.4), eta="descend", frame_len=3,
        solver="pallas_tiled", ranking="topm", top_m=3, block_k=8, traj="fused",
    ).to_dict()


def test_scenario_round_trips_through_the_reference_payload():
    for d in _reference_payloads():
        d = json.loads(json.dumps(d))  # plain JSON data, as shipped
        sc = scenario_from_reference(d)
        assert sc.to_dict() == d
        assert JScenario.from_dict(sc.to_dict()).to_dict() == d
        assert Scenario.from_json(sc.to_json()) == sc


@pytest.mark.parametrize(
    "field,value",
    [("env", {"channel": "gauss_markov"}), ("metrics", {"collectors": []}),
     ("guard", {"energy_cap": 1.0}), ("checkpoint", {"directory": "x", "every_rounds": 5}),
     ("failure_mode", "reallocate"), ("no_such_field", 1)],
)
def test_scenario_refuses_fields_it_does_not_take(field, value):
    """Fields not ported raise; ``env``, ``failure_mode``, ``guard``,
    ``metrics`` and ``checkpoint``, ported since, load and give the payload
    back."""
    d = Scenario().to_dict()
    d[field] = value
    if field in ("env", "failure_mode", "guard", "metrics", "checkpoint"):
        assert scenario_from_reference(d).to_dict() == JScenario.from_dict(d).to_dict()
        return
    with pytest.raises(NotImplementedError, match=field):
        scenario_from_reference(d)
    d[field] = None  # the "off" value is accepted
    if field != "no_such_field":
        assert scenario_from_reference(d) == Scenario()


def test_pathloss_matches_reference():
    for start, end in ((36.0, 36.0), (32.0, 45.0), (45.0, 32.0)):
        pl = pathloss_schedule(start, end, T)
        np.testing.assert_allclose(pl.numpy(), np.asarray(j_pathloss_schedule(start, end, T)), rtol=1e-6)
        np.testing.assert_allclose(
            pathloss_to_gain(pl).numpy(),
            np.asarray(j_pathloss_to_gain(jnp.asarray(pl.numpy()))), rtol=2e-6,
        )


def test_rayleigh_sampler_mean_gain_within_3_sigma():
    """Exp(1) fading: per round the mean of N draws has sigma g / sqrt(N)."""
    sc = Scenario(num_clients=50, num_rounds=30, pathloss_db=(32.0, 45.0))
    draws = torch.stack([sc.sample_channel(s, device="cpu") for s in range(40)])
    n = draws.shape[0] * draws.shape[2]
    mean = draws.mean(dim=(0, 2)).double()
    g = pathloss_to_gain(pathloss_schedule(32.0, 45.0, 30)).double()
    assert (torch.abs(mean - g) <= 3.0 * g / np.sqrt(n)).all()
    assert torch.equal(sc.sample_channel(7, device="cpu"), sc.sample_channel(7, device="cpu"))
    assert (draws > 0).all()


def test_convert_round_trips_state_and_decisions():
    cfg = OceanConfig(num_clients=3, num_rounds=4, radio=RadioParams())
    st = state_from_reference(np.ones(3), 2, np.zeros(3), device="cpu")
    assert st.q.shape == (1, 3) and st.t.dtype == torch.int32 and int(st.t[0]) == 2
    h2 = torch.full((1, 3), 2.5e-4)
    nxt, dec = ocean_round(st, h2, 1e-5, 1.0, cfg)
    out = decisions_to_numpy(dec)
    assert set(out) == {"a", "b", "e", "q", "rho", "objective", "num_selected"}
    np.testing.assert_array_equal(out["q"], np.ones((1, 3), np.float32))
    assert int(nxt.t[0]) == 3


def _package_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_kernels.py"]
    assert len(files) > 10
    for f in files:
        for mod in _package_imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), f"{f}: {mod}"


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(), solver="pallas")
    h2 = torch.full((1, T, K), 2.5e-4)
    eta = eta_schedule("uniform", T)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(cfg, h2, eta, 1e-5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_grid(paper_scenarios(T, K), ["ocean-u"], [0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scenario().sample_channel(0)
    simulate(cfg, h2, eta, 1e-5, device="cpu")  # asked for explicitly: runs


def test_unported_hooks_raise_not_implemented():
    """Hooks not ported raise; the radio, failure and bf16 hooks, ported since, run
    (a static radio and an all-ones mask give the plain round's bits); the
    guard, the metrics and the checkpoint, ported since, take a GuardSpec, a
    MetricsSpec and a CheckpointSpec and refuse anything else (resuming from
    a directory without snapshots is an error)."""
    cfg = OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams())
    h2 = torch.full((1, T, K), 2.5e-4)
    eta = eta_schedule("uniform", T)
    # bf16 streaming, ported since, runs on the fused path and refuses scan
    _, d16 = simulate(cfg, h2, eta, 1e-5, device="cpu", stream_bf16=True, traj="fused")
    assert d16.b.dtype == torch.bfloat16 and d16.num_selected.dtype == torch.int32
    with pytest.raises(ValueError, match="fused"):
        simulate(cfg, h2, eta, 1e-5, device="cpu", stream_bf16=True, traj="scan")
    with pytest.raises(TypeError, match="checkpoint"):
        simulate(cfg, h2, eta, 1e-5, device="cpu", checkpoint=object())
    with pytest.raises(FileNotFoundError, match="no committed snapshots"):
        simulate(cfg, h2, eta, 1e-5, device="cpu", resume_from="no-such-snapshot-directory")
    with pytest.raises(TypeError, match="checkpoint"):
        OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(), checkpoint=object())
    with pytest.raises(TypeError, match="metrics"):
        OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(), metrics=object())
    with pytest.raises(TypeError, match="guard"):
        OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(), guard=object())
    OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(), failure_mode="overprovision")
    st = init_state(cfg, device="cpu")
    _, plain = ocean_round(st, h2[:, 0], 1e-5, 1.0, cfg)
    _, dec = ocean_round(st, h2[:, 0], 1e-5, 1.0, cfg, radio=RadioParams(),
                         delivered=torch.ones(1, K))
    assert torch.equal(dec.a, plain.a) and torch.equal(dec.delivered, plain.a)
    assert plain.delivered is None and int(dec.realloc[0]) == 0
