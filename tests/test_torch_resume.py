"""Segmented execution of the port: checkpoint/resume bit identity.

Mirrors tests/test_resume.py for ``repro_torch``.  With a
``CheckpointSpec`` ``simulate`` and ``GridEngine`` run the trajectory as
segments and snapshot every boundary, and BOTH

* the segmented run equals the single-program run bit for bit (decisions
  and telemetry), on ``traj="scan"`` and ``"fused"`` (K3's plain version
  here; its segment launches are held to the whole launch on the card in
  tests/test_torch_kernels_cuda.py), with metrics on and off, a guard and
  every failure mode;
* a run killed mid-sweep (SIGKILL, no cleanup) and resumed from the latest
  committed snapshot equals the uninterrupted run bit for bit.

One test holds the port's resumed ``simulate`` to the reference's resumed
``simulate`` on the same numpy inputs, within the parity tolerances.
"""
import dataclasses
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.trajectory import CheckpointSpec as JCheckpointSpec  # noqa: E402
from repro.core import OceanConfig as JOceanConfig  # noqa: E402
from repro.core import RadioParams as JRadio  # noqa: E402
from repro.core.ocean import simulate as j_simulate  # noqa: E402
from repro_torch.checkpoint import CheckpointSpec, drain_events  # noqa: E402
from repro_torch.core import EnvSpec, OceanConfig, PolicyParams, RadioParams, Scenario  # noqa: E402
from repro_torch.core.ocean import simulate  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.policy import Policy  # noqa: E402
from repro_torch.env.failure import TracedFailure  # noqa: E402
from repro_torch.guard import GuardSpec, inject_h2_faults  # noqa: E402
from repro_torch.obs import MetricsSpec  # noqa: E402
from repro_torch.sim import GridEngine, run_grid  # noqa: E402

T, K, C = 25, 6, 2
EVERY = 7
# every reduction, with full_trace_ds slots (stride 5) that segments cross
SPEC = MetricsSpec.of(
    "queue:full_trace", "num_selected:mean", "energy_headroom:last",
    "selection_gap:histogram", "queue_next:full_trace_ds", "selection_count:mean",
    "fault_count:last", "reallocation_count:last", "demoted_clients:mean", ds_samples=5,
)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _assert_bitwise(name, ref, got):
    lr, lg = _leaves(ref), _leaves(got)
    assert len(lr) == len(lg), name
    for i, (r, g) in enumerate(zip(lr, lg)):
        assert r.dtype == g.dtype and r.shape == g.shape, f"{name}: leaf {i}"
        assert r.contiguous().view(torch.uint8).numpy().tobytes() == \
            g.contiguous().view(torch.uint8).numpy().tobytes(), f"{name}: leaf {i} differs"


def _steps(directory):
    return sorted(int(f.split("_")[1].split(".")[0]) for f in os.listdir(directory))


def _drop_after(directory, r):
    for s in _steps(directory):
        if s > r:
            os.remove(os.path.join(directory, f"step_{s:08d}.npz"))


def _inputs(variant):
    """(cfg keywords, h2 (C, T, K), simulate keywords) of one variant."""
    rng = np.random.default_rng(3)
    h2 = rng.exponential(size=(C, T, K)).astype(np.float32) * 2.5e-4
    kw, sim = {}, {}
    if variant != "plain":
        kw["metrics"] = SPEC
    if variant == "guard":
        rows = [inject_h2_faults(h2[c], 40 + c, num_inf=2, num_nan=1, num_zero=1)[0]
                for c in range(C)]
        h2 = np.stack(rows).astype(np.float32)
        h2[0] *= 1e-2  # the cap demotes clients of cell 0
        kw["guard"] = GuardSpec(energy_cap=1.0)
    if variant.startswith("failure"):
        kw["failure_mode"] = variant.split("-")[1]
        sim["failure_seq"] = TracedFailure(
            delivered=torch.tensor((rng.random((C, T, K)) < 0.7).astype(np.float32)),
            rate=torch.full((C, K), 0.7))
    return kw, torch.tensor(h2), sim


@pytest.mark.parametrize("traj", ("scan", "fused"))
@pytest.mark.parametrize("variant", ("plain", "metrics", "guard", "failure-plain",
                                     "failure-overprovision", "failure-reallocate"))
def test_simulate_checkpointed_bit_identical(tmp_path, traj, variant):
    kw, h2, sim = _inputs(variant)
    cfg = OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(), frame_len=10,
                      solver="pallas", traj=traj, **kw)
    eta = eta_schedule("uniform", T)
    ref = simulate(cfg, h2, eta, 1e-5, device="cpu", **sim)
    spec = CheckpointSpec(directory=str(tmp_path), every_rounds=EVERY)
    got = simulate(cfg, h2, eta, 1e-5, checkpoint=spec, device="cpu", **sim)
    _assert_bitwise(f"{traj} {variant} segmented", ref, got)
    assert _steps(tmp_path) == [7, 14, 21, 25]  # every boundary, T included
    _drop_after(tmp_path, 14)
    res = simulate(cfg, h2, eta, 1e-5, checkpoint=spec, resume_from=True, device="cpu", **sim)
    _assert_bitwise(f"{traj} {variant} resumed", ref, res)
    if variant == "plain":
        # checkpoint=False with a directory: resume, one segment, no snapshot
        _drop_after(tmp_path, 14)
        res = simulate(dataclasses.replace(cfg, checkpoint=spec), h2, eta, 1e-5,
                       checkpoint=False, resume_from=str(tmp_path), device="cpu", **sim)
        _assert_bitwise(f"{traj} resumed without a spec", ref, res)
        assert _steps(tmp_path) == [7, 14]


def _scenarios(**kw):
    base = dict(num_clients=K, num_rounds=T, frame_len=10, **kw)
    return [
        Scenario(name="static", **base),
        Scenario(name="shared+drop", env=EnvSpec(
            radio="spectrum_sharing", failure="iid_dropout",
            failure_params={"p_deliver": 0.8}), **base),
    ]


POLICIES = [
    ("ocean-a", PolicyParams(v=1e-5)),
    ("ocean-u", PolicyParams(v=1e-5)),
    ("smo", PolicyParams()),
    ("amo", PolicyParams()),
    ("select_all", PolicyParams()),
    ("pattern", PolicyParams(counts=torch.tensor([1, 2, 3, 4, 5] * 5))),
]
SEEDS = (0, 7)


def _grid_tree(res):
    return {"a": res.a, "b": res.b, "e": res.e, "num_selected": res.num_selected,
            "energy_spent": res.energy_spent, "h2": res.h2, "delivered": res.delivered,
            "q": res.q, "metrics": res.metrics}


@pytest.mark.parametrize("traj,with_metrics", [("scan", False), ("fused", True)])
def test_grid_checkpointed_bit_identical(tmp_path, traj, with_metrics):
    """Every policy kind in one grid (OCEAN, the baselines, the stochastic
    pattern), with a radio and a failure stream; the other (traj,
    metrics) pairs are test_simulate_checkpointed_bit_identical's."""
    mets = SPEC if with_metrics else None
    kw = dict(traj=traj, metrics=mets, solver="pallas", device="cpu")
    ref = run_grid(_scenarios(), POLICIES, SEEDS, **kw)
    ck = CheckpointSpec(directory=str(tmp_path), every_rounds=EVERY)
    got = run_grid(_scenarios(), POLICIES, SEEDS, checkpoint=ck, **kw)
    _assert_bitwise(f"grid {traj} segmented", _grid_tree(ref), _grid_tree(got))
    assert _steps(tmp_path) == [7, 14, 21, 25]
    _drop_after(tmp_path, 14)  # the sweep's tail is lost
    res = run_grid(_scenarios(), POLICIES, SEEDS, checkpoint=ck, resume_from=True, **kw)
    _assert_bitwise(f"grid {traj} resumed", _grid_tree(ref), _grid_tree(res))


def test_grid_checkpoint_records_manifest_events(tmp_path):
    drain_events()
    ck = CheckpointSpec(directory=str(tmp_path), every_rounds=10)
    run_grid(_scenarios()[:1], POLICIES[:2], (0,), checkpoint=ck, solver="pallas",
             device="cpu")
    assert [(e["kind"], e["round"]) for e in drain_events()] == [
        ("save", 10), ("save", 20), ("save", 25)]
    _drop_after(tmp_path, 10)
    run_grid(_scenarios()[:1], POLICIES[:2], (0,), checkpoint=ck, resume_from=True,
             solver="pallas", device="cpu")
    assert [(e["kind"], e["round"]) for e in drain_events()] == [
        ("restore", 10), ("save", 20), ("save", 25)]


def test_grid_checkpoint_must_agree_and_hooks_are_required(tmp_path):
    ck = CheckpointSpec(directory=str(tmp_path), every_rounds=5)
    s1, s2 = _scenarios()
    with pytest.raises(ValueError, match="checkpoint"):
        GridEngine([dataclasses.replace(s1, checkpoint=ck), s2], ["ocean-u"], device="cpu")
    # both carrying it, or the engine's override: the grid takes it
    eng = GridEngine([dataclasses.replace(s, checkpoint=ck) for s in (s1, s2)], ["ocean-u"],
                     device="cpu")
    assert eng.cfg.checkpoint == ck
    # a scenario payload carrying the spec round-trips
    d = dataclasses.replace(s1, checkpoint=ck).to_dict()
    assert d["checkpoint"] == {"directory": str(tmp_path), "every_rounds": 5}
    assert Scenario.from_dict(d).checkpoint == ck
    assert "checkpoint" not in s1.to_dict()
    no_hooks = Policy("no-hooks", lambda cfg, h2, params, device=None: None)
    with pytest.raises(ValueError, match="seg_init/seg_fn"):
        GridEngine([s1], [(no_hooks, PolicyParams())], checkpoint=ck, device="cpu")


def test_resume_without_snapshots_is_an_error(tmp_path):
    ck = CheckpointSpec(directory=str(tmp_path), every_rounds=5)
    with pytest.raises(FileNotFoundError, match="no committed snapshots"):
        run_grid(_scenarios()[:1], POLICIES[2:3], (0,), checkpoint=ck, resume_from=True,
                 device="cpu")
    cfg = OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams())
    with pytest.raises(ValueError, match="needs a CheckpointSpec"):
        simulate(cfg, torch.ones(1, T, K), eta_schedule("uniform", T), 1e-5, resume_from=True,
                 device="cpu")
    # a snapshot of another grid (more seeds) does not fit the template
    run_grid(_scenarios()[:1], POLICIES[2:3], (0, 1), checkpoint=ck, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        run_grid(_scenarios()[:1], POLICIES[2:3], (0,), checkpoint=ck, resume_from=True,
                 device="cpu")


# --------------------------------------------------------------------------
# fault injection: SIGKILL mid-sweep, resume, compare bitwise
# --------------------------------------------------------------------------
_CHILD_SCRIPT = """
import os, signal, sys
import numpy as np
mode, ckdir, outpath = sys.argv[1], sys.argv[2], sys.argv[3]
import torch
from repro_torch.checkpoint import CheckpointSpec
sys.path.insert(0, os.path.dirname(outpath))
from repro_torch.sim import run_grid
assert "jax" not in sys.modules
exec(open(os.path.join(os.path.dirname(outpath), "grid.py")).read())
ck = CheckpointSpec(directory=ckdir, every_rounds=7)
if mode == "kill":
    # commit the first snapshot, then die with no cleanup whatsoever
    from repro_torch.checkpoint import trajectory
    orig = trajectory.save_snapshot
    def killing_save(spec, snapshot, round_idx):
        orig(spec, snapshot, round_idx)
        os.kill(os.getpid(), signal.SIGKILL)
    trajectory.save_snapshot = killing_save
res = run_grid(scenarios, policies, (0, 7), checkpoint=ck, resume_from=(mode == "resume"), **kw)
np.savez(outpath, **{str(i): x.numpy() for i, x in enumerate(leaves(res))})
print("DONE", mode)
"""

# The grid of the drill: the children and the uninterrupted run in the
# test's own process execute this same source.
_GRID = """
from repro_torch.core import EnvSpec, PolicyParams, Scenario
from repro_torch.obs import MetricsSpec
base = dict(num_clients=6, num_rounds=25, frame_len=10)
scenarios = [
    Scenario(name="static", **base),
    Scenario(name="spectrum", env=EnvSpec(radio="spectrum_sharing"), **base),
]
policies = [("ocean-u", PolicyParams(v=1e-5)), ("amo", PolicyParams()), ("smo", PolicyParams())]
kw = dict(metrics=MetricsSpec.of("queue:full_trace", "num_selected:mean"), traj="fused",
          solver="pallas", device="cpu")
def leaves(res):
    return [res.a, res.b, res.e, res.num_selected] + [
        m[k] for m in res.metrics if m is not None for k in sorted(m)]
"""


def _run_child(mode, ckdir, outpath, tmp_path):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-c", _CHILD_SCRIPT, mode, ckdir, outpath],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
    )


def test_sigkill_mid_sweep_resume_bit_identical(tmp_path):
    """A child killed by SIGKILL right after its first committed snapshot
    leaves that snapshot and nothing else; a resumed child's results equal
    the uninterrupted run's bit for bit.  The children import torch only."""
    (tmp_path / "grid.py").write_text(_GRID)
    ckdir, res_out = str(tmp_path / "snaps"), str(tmp_path / "res.npz")
    killed = _run_child("kill", ckdir, str(tmp_path / "never.npz"), tmp_path)
    assert killed.returncode == -signal.SIGKILL, (killed.returncode, killed.stderr[-2000:])
    assert sorted(os.listdir(ckdir)) == ["step_00000007.npz"]
    assert not os.path.exists(str(tmp_path / "never.npz"))
    resumed = _run_child("resume", ckdir, res_out, tmp_path)
    assert resumed.returncode == 0 and "DONE resume" in resumed.stdout, resumed.stderr[-2000:]
    grid = {}
    exec(_GRID, grid)
    ref = grid["leaves"](run_grid(grid["scenarios"], grid["policies"], (0, 7), **grid["kw"]))
    with np.load(res_out) as res:
        assert sorted(res.files, key=int) == [str(i) for i in range(len(ref))]
        for i, r in enumerate(ref):
            got = res[str(i)]
            assert got.dtype == r.numpy().dtype, i
            assert got.tobytes() == r.numpy().tobytes(), f"leaf {i} differs"


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------
def test_resumed_simulate_matches_the_reference(tmp_path):
    """Both packages' segmented simulate, killed after round 14 and resumed,
    on the same numpy draws (seed 11, tie-free: every round's decision
    agrees): selections and counts exact, b within 2e-4, P3 values within
    2e-4 relative, the final queues within 1e-6 + 1e-5 |q|.  (The port's
    fused path equals its scan path bit for bit in the tests above.)"""
    rng = np.random.default_rng(11)
    h2 = rng.exponential(size=(T, K)).astype(np.float32) * 2.5e-4
    eta = np.asarray(eta_schedule("ascend", T))
    j_cfg = JOceanConfig(num_clients=K, num_rounds=T, radio=JRadio(), frame_len=10)
    j_spec = JCheckpointSpec(directory=str(tmp_path / "j"), every_rounds=EVERY)
    j_simulate(j_cfg, jnp.asarray(h2), jnp.asarray(eta), 1e-5, checkpoint=j_spec)
    _drop_after(j_spec.directory, 14)
    j_state, j_dec = j_simulate(j_cfg, jnp.asarray(h2), jnp.asarray(eta), 1e-5,
                                checkpoint=j_spec, resume_from=True)
    cfg = OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(), frame_len=10)
    spec = CheckpointSpec(directory=str(tmp_path / "p"), every_rounds=EVERY)
    h2_t, eta_t = torch.tensor(h2)[None], torch.tensor(eta)
    simulate(cfg, h2_t, eta_t, 1e-5, checkpoint=spec, device="cpu")
    _drop_after(spec.directory, 14)
    state, dec = simulate(cfg, h2_t, eta_t, 1e-5, checkpoint=spec, resume_from=True,
                          device="cpu")
    assert np.array_equal(dec.a[0].numpy(), np.asarray(j_dec.a))
    assert np.array_equal(dec.num_selected[0].numpy(), np.asarray(j_dec.num_selected))
    assert 0 < int(dec.num_selected.sum()) < T * K
    np.testing.assert_allclose(dec.b[0].numpy(), np.asarray(j_dec.b), atol=2e-4, rtol=0)
    np.testing.assert_allclose(dec.objective[0].numpy(), np.asarray(j_dec.objective),
                               rtol=2e-4, atol=0)
    np.testing.assert_allclose(state.q[0].numpy(), np.asarray(j_state.q), atol=1e-6,
                               rtol=1e-5)
    assert int(state.t[0]) == int(j_state.t) == T
