"""The port's checkpoint IO (``repro_torch.checkpoint``) against its
contract and against the reference's ``repro.checkpoint``.

Mirrors tests/test_checkpoint.py: every leaf dtype round-trips bit for bit
(``torch.bfloat16`` as raw bytes, with no ``ml_dtypes``); a killed writer
leaves only ``.tmp`` litter that ``latest_step`` ignores and the next save
sweeps; a dtype mismatch is an error, never a cast; transient write errors
are retried a bounded number of times; every error names what to do.  Plus
``CheckpointSpec`` / ``segment_bounds`` equal to the reference's, and files
that either package writes load bit for bit in the other.
"""
import ast
import os
import zipfile
from collections import namedtuple
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import load_pytree as j_load_pytree  # noqa: E402
from repro.checkpoint import save_pytree as j_save_pytree  # noqa: E402
from repro.checkpoint.trajectory import CheckpointSpec as JCheckpointSpec  # noqa: E402
from repro.checkpoint.trajectory import record_event as j_record_event  # noqa: E402
from repro.checkpoint.trajectory import drain_events as j_drain_events  # noqa: E402
from repro.checkpoint.trajectory import segment_bounds as j_segment_bounds  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointSpec,
    TensorSpec,
    drain_events,
    latest_round,
    latest_step,
    load_pytree,
    load_snapshot,
    save_pytree,
    save_snapshot,
    segment_bounds,
)
from repro_torch.obs import ManifestWriter, read_manifest  # noqa: E402

Carry = namedtuple("Carry", ("q", "flags"))
_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.bool)
PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "checkpoint"


def _values(rng, shape):
    return rng.standard_normal(shape) * 10


def _leaf(rng, dtype, shape):
    x = _values(rng, shape)
    if dtype == torch.bool:
        return torch.tensor(x > 0)
    return torch.tensor(x, dtype=torch.float32).to(dtype)


def mixed_tree(rng, d0, d1, d2, n: int):
    """A nested dict/list/NamedTuple tree with mixed-dtype leaves and an
    empty (None) subtree."""
    return {
        "state": Carry(q=_leaf(rng, d0, (n, 3)), flags=_leaf(rng, d1, (n,))),
        "parts": [_leaf(rng, d2, (2, n)), _leaf(rng, d0, ())],
        "nested": {"deep": {"x": _leaf(rng, d1, (1, 1, n))}, "none": None},
    }


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bytes(x):
    """A leaf's dtype name and bytes, a torch tensor or a (jax) array."""
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
        name = {torch.bfloat16: "bfloat16", torch.bool: "bool"}.get(
            t.dtype, str(t.dtype).replace("torch.", ""))
        return name, tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _trees_bitwise_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bytes(x) == _bytes(y)


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_mixed_dtype_pytree_roundtrips_bitwise(tmp_path, seed):
    rng = np.random.default_rng(seed)
    dts = [_DTYPES[(seed + i) % len(_DTYPES)] for i in range(3)]
    tree = mixed_tree(rng, *dts, n=seed + 2)
    save_pytree(str(tmp_path), tree, step=seed)
    restored, step = load_pytree(str(tmp_path), tree)
    assert step == seed
    assert restored["nested"]["none"] is None and isinstance(restored["state"], Carry)
    _trees_bitwise_equal(tree, restored)


def test_bfloat16_extremes_roundtrip_bitwise(tmp_path):
    """bf16 specials (inf, nan, subnormals, -0.0) travel as raw bytes and
    come back through ``torch.frombuffer``; the package never needs
    ``ml_dtypes`` (the card's machine has none) and imports no JAX."""
    vals = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-40, -1e-40,
                         3.14159, 65504.0]).to(torch.bfloat16)
    save_pytree(str(tmp_path), {"x": vals}, step=0)
    restored, _ = load_pytree(str(tmp_path), {"x": TensorSpec((9,), torch.bfloat16)})
    assert restored["x"].dtype == torch.bfloat16
    assert _bytes(restored["x"]) == _bytes(vals)
    for f in PKG.glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro", "ml_dtypes"), (f.name, n)


def test_dtype_mismatch_is_an_error_not_a_cast(tmp_path):
    save_pytree(str(tmp_path), {"x": torch.ones(3)}, step=1)
    with pytest.raises(ValueError, match="dtype mismatch"):
        load_pytree(str(tmp_path), {"x": torch.ones(3, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(str(tmp_path), {"x": TensorSpec((4,), torch.float32)})
    with pytest.raises(KeyError, match="missing keys"):
        load_pytree(str(tmp_path), {"y": torch.ones(3)})


def test_tensor_spec_template(tmp_path):
    """(shape, dtype) templates work as the restore template (the segmented
    resume builds its template this way), and ``device`` places the leaves."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "t": torch.tensor(7, dtype=torch.int32)}
    save_pytree(str(tmp_path), tree, step=4)
    like = {"a": TensorSpec((2, 3), torch.float32), "t": TensorSpec((), "int32")}
    restored, step = load_pytree(str(tmp_path), like, device="cpu")
    assert step == 4 and restored["t"].device.type == "cpu"
    _trees_bitwise_equal(tree, restored)


# --------------------------------------------------------------------------
# preemption safety: tmp litter and atomic replace
# --------------------------------------------------------------------------
def test_latest_step_ignores_tmp_litter(tmp_path):
    save_pytree(str(tmp_path), {"x": torch.zeros(2)}, step=3)
    # a killed writer's torn tmp for a LATER step must not win
    (tmp_path / "step_00000009.npz.tmp.99999999").write_bytes(b"torn")
    assert latest_step(str(tmp_path)) == 3
    _, step = load_pytree(str(tmp_path), {"x": torch.zeros(2)})
    assert step == 3


def test_save_sweeps_dead_writer_tmps(tmp_path):
    stale = tmp_path / "step_00000005.npz.tmp.99999999"  # pid surely dead
    stale.write_bytes(b"torn")
    live = tmp_path / f"step_00000005.npz.tmp.{os.getppid()}"  # a live writer's
    live.write_bytes(b"in flight")
    save_pytree(str(tmp_path), {"x": torch.zeros(2)}, step=6)
    assert not stale.exists() and live.exists()
    assert latest_step(str(tmp_path)) == 6


def test_save_is_atomic_via_replace(tmp_path, monkeypatch):
    """A crash between write and replace leaves no committed step, and no tmp."""
    import repro_torch.checkpoint.ckpt as ck

    def boom(src, dst):
        raise RuntimeError("killed before rename")

    monkeypatch.setattr(ck.os, "replace", boom)
    with pytest.raises(RuntimeError):
        save_pytree(str(tmp_path), {"x": torch.zeros(2)}, step=1)
    assert latest_step(str(tmp_path)) is None
    assert os.listdir(tmp_path) == []


def test_save_retries_transient_oserror(tmp_path, monkeypatch):
    """Two spurious EIOs on the rename are retried with exponential backoff
    and the snapshot still commits, bit-exact."""
    import repro_torch.checkpoint.ckpt as ck

    real_replace = os.replace
    failures = {"left": 2}
    sleeps = []

    def flaky_replace(src, dst):
        if failures["left"] > 0:
            failures["left"] -= 1
            raise OSError("flaky filesystem: EIO")
        return real_replace(src, dst)

    monkeypatch.setattr(ck.os, "replace", flaky_replace)
    monkeypatch.setattr(ck.time, "sleep", sleeps.append)
    tree = {"x": torch.arange(5, dtype=torch.float32)}
    save_pytree(str(tmp_path), tree, step=1, backoff_s=0.01)
    assert failures["left"] == 0 and sleeps == [0.01, 0.02]
    restored, step = load_pytree(str(tmp_path), tree)
    assert step == 1
    _trees_bitwise_equal(tree, restored)


def test_save_gives_up_after_bounded_retries(tmp_path, monkeypatch):
    import repro_torch.checkpoint.ckpt as ck

    attempts = []

    def broken_replace(src, dst):
        attempts.append(src)
        raise OSError("disk on fire")

    monkeypatch.setattr(ck.os, "replace", broken_replace)
    monkeypatch.setattr(ck.time, "sleep", lambda s: None)
    with pytest.raises(OSError, match=r"save_pytree: writing .* failed 3"):
        save_pytree(str(tmp_path), {"x": torch.zeros(2)}, step=1, retries=2, backoff_s=0.0)
    assert len(attempts) == 3  # the first try and 2 retries
    assert latest_step(str(tmp_path)) is None


@pytest.mark.parametrize("case", ["missing_directory", "empty_directory", "missing_step",
                                  "corrupt"])
def test_load_errors_are_actionable(tmp_path, case):
    like = {"x": torch.zeros(2)}
    if case == "missing_directory":
        with pytest.raises(FileNotFoundError, match="directory does not exist"):
            load_pytree(str(tmp_path / "never_written"), like)
    elif case == "empty_directory":
        with pytest.raises(FileNotFoundError, match="no committed step"):
            load_pytree(str(tmp_path), like)
    elif case == "missing_step":
        save_pytree(str(tmp_path), like, step=3)
        with pytest.raises(FileNotFoundError, match="latest committed step .* 3"):
            load_pytree(str(tmp_path), like, step=7)
    else:  # a file torn after the rename
        save_pytree(str(tmp_path), like, step=2)
        (tmp_path / "step_00000002.npz").write_bytes(b"PK\x03\x04 torn!")
        with pytest.raises(ValueError, match="corrupt or torn"):
            load_pytree(str(tmp_path), like)


# --------------------------------------------------------------------------
# the reference: file interchange, CheckpointSpec, segment_bounds, events
# --------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshots_interchange_with_the_reference_bitwise(tmp_path, writer):
    """A tree one package saves loads bit for bit in the other (bf16
    included), and both write the same bytes for the same tree."""
    rng = np.random.default_rng(5)
    tree = mixed_tree(rng, torch.float32, torch.bfloat16, torch.int32, n=4)
    tree["parts"].append(_leaf(rng, torch.bool, (3,)))
    j_tree = {
        "state": Carry(q=jnp.asarray(tree["state"].q.numpy()),
                       flags=jnp.asarray(tree["state"].flags.float().numpy(), jnp.bfloat16)),
        "parts": [jnp.asarray(tree["parts"][0].numpy()), jnp.asarray(tree["parts"][1].numpy()),
                  jnp.asarray(tree["parts"][2].numpy())],
        "nested": {"deep": {"x": jnp.asarray(tree["nested"]["deep"]["x"].float().numpy(),
                                             jnp.bfloat16)}, "none": None},
    }
    _trees_bitwise_equal(tree, j_tree)  # the same values on both sides
    if writer == "reference":
        j_save_pytree(str(tmp_path / "j"), j_tree, step=9)
        got, step = load_pytree(str(tmp_path / "j"), tree)
    else:
        save_pytree(str(tmp_path / "p"), tree, step=9)
        got, step = j_load_pytree(str(tmp_path / "p"), j_tree)
    assert step == 9
    _trees_bitwise_equal(tree, got)
    save_pytree(str(tmp_path / "p"), tree, step=9)
    j_save_pytree(str(tmp_path / "j"), j_tree, step=9)
    with zipfile.ZipFile(tmp_path / "p" / "step_00000009.npz") as zp, \
            zipfile.ZipFile(tmp_path / "j" / "step_00000009.npz") as zj:
        assert zp.namelist() == zj.namelist()
        assert all(zp.read(n) == zj.read(n) for n in zp.namelist())


def test_checkpoint_spec_validation_and_its_dict():
    with pytest.raises(ValueError, match="non-empty"):
        CheckpointSpec(directory="", every_rounds=5)
    with pytest.raises(ValueError, match="every_rounds"):
        CheckpointSpec(directory="/tmp/x", every_rounds=0)
    spec = CheckpointSpec(directory="/tmp/x", every_rounds=5.0)
    assert spec.every_rounds == 5 and isinstance(spec.every_rounds, int)
    assert CheckpointSpec.from_dict(spec.to_dict()) == spec
    assert hash(spec)  # it rides OceanConfig and the must-agree check
    ref = JCheckpointSpec(directory="/tmp/x", every_rounds=5)
    assert spec.to_dict() == ref.to_dict()
    assert CheckpointSpec.from_dict(ref.to_dict()) == spec


@pytest.mark.parametrize("T", [1, 7, 25, 300])
def test_segment_bounds_equal_the_reference(T):
    for every in (1, 2, 7, 64, T, T + 3):
        for start in range(0, T + 1, max(1, T // 10)):
            assert segment_bounds(T, every, start) == j_segment_bounds(T, every, start)
    assert segment_bounds(300, 64) == [(0, 64), (64, 128), (128, 192), (192, 256), (256, 300)]
    assert segment_bounds(10, 4, start=5) == [(5, 8), (8, 10)]
    assert segment_bounds(10, 4, start=10) == []
    with pytest.raises(ValueError):
        segment_bounds(10, 4, start=11)


def test_segment_bounds_property():
    """Any (T, every, start): contiguous half-open segments that cover
    [start, T), end on multiples of ``every`` (or at T), no longer than
    ``every``; the reference's bounds exactly."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=60, deadline=None)
    @hypothesis.given(T=st.integers(0, 400), every=st.integers(1, 90), frac=st.floats(0, 1))
    def check(T, every, frac):
        start = int(frac * T)
        b = segment_bounds(T, every, start)
        assert b == j_segment_bounds(T, every, start)
        assert (b == []) == (start == T)
        assert [t0 for t0, _ in b] == ([start] + [t1 for _, t1 in b[:-1]])[:len(b)]
        assert (b[-1][1] if b else start) == T
        for t0, t1 in b:
            assert 0 < t1 - t0 <= every and (t1 % every == 0 or t1 == T)

    check()


def test_snapshot_io_records_events_in_the_reference_schema(tmp_path):
    """save/load_snapshot record the reference's manifest rows, which land
    in a run manifest's ``checkpoints`` field."""
    spec = CheckpointSpec(directory=str(tmp_path / "snaps"), every_rounds=2)
    snap = {"q": torch.arange(4, dtype=torch.float32), "t": torch.tensor(2, dtype=torch.int32)}
    drain_events()
    save_snapshot(spec, snap, 2)
    save_snapshot(spec, {k: v + 1 for k, v in snap.items()}, 4)
    assert latest_round(spec.directory) == 4
    restored, r = load_snapshot(spec.directory, snap)
    assert r == 4
    _trees_bitwise_equal({k: v + 1 for k, v in snap.items()}, restored)
    events = drain_events()
    assert [(e["kind"], e["round"]) for e in events] == [("save", 2), ("save", 4), ("restore", 4)]
    assert all(e["directory"] == spec.directory for e in events)
    assert drain_events() == []
    j_drain_events()
    j_record_event("save", directory=spec.directory, round=2, path=events[0]["path"])
    assert sorted(j_drain_events()[0]) == sorted(events[0])
    path = str(tmp_path / "run.jsonl")
    w = ManifestWriter(path, argv=["test"])
    w.module("resume", ok=True, runtime_s=0.1, checkpoints=events)
    rec = [r for r in read_manifest(path) if r["record"] == "module"][0]
    assert rec["checkpoints"] == events
