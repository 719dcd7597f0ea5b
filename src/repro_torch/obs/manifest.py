"""Structured JSONL run manifests — port of ``repro.obs.manifest``.

The schema is the reference's, key for key (``SCHEMA_VERSION`` and the
three ``*_RECORD_KEYS`` tuples), so that the reference's ``read_manifest``
and ``benchmarks/report.py`` read the port's manifests.  The run record's
device fields come from torch: ``backend`` is ``"cuda"`` or ``"cpu"``,
``device_kind`` the card's name, and ``jax_version`` is None (the port
runs no JAX).

Every invocation appends one *run* to a JSONL manifest file: a header
record (config hash, device info, argv, profiler trace dir), one record
per executed module (runtime, claim outcomes, baseline comparison
results, emitted BENCH file, drained wall-clock spans), and a summary
footer.  Successive invocations append to one file, and readers group
records by ``run_id``.

Schema (``"schema": 1`` on every record):

* ``{"record": "run", "run_id", "schema", "argv", "config_hash",
   "jax_version", "backend", "device_count", "device_kind",
   "profile_dir", "started_unix"}``
* ``{"record": "module", "run_id", "schema", "name", "ok", "runtime_s",
   "claims": [{"description", "ok"}], "baseline": [{"metric", "status",
   "note"}], "bench_json", "spans": [{"name", "count", "total_s",
   "mean_s"}], "checkpoints": [{"kind", "directory", "round", ...}],
   "num_rows"}``
* ``{"record": "summary", "run_id", "schema", "ok", "modules",
   "failed", "total_runtime_s"}``

``read_manifest`` round-trips the file; ``runs_in_manifest`` groups by
run.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

SCHEMA_VERSION = 1

# run_id = "<ms-hex>-<pid>-<n>": the counter disambiguates writers created
# within the same millisecond of one process (e.g. back-to-back test runs).
_RUN_COUNTER = itertools.count()

MODULE_RECORD_KEYS = (
    "record", "run_id", "schema", "name", "ok", "runtime_s",
    "claims", "baseline", "bench_json", "spans", "checkpoints", "num_rows",
)
RUN_RECORD_KEYS = (
    "record", "run_id", "schema", "argv", "config_hash", "jax_version",
    "backend", "device_count", "device_kind", "profile_dir", "started_unix",
)
SUMMARY_RECORD_KEYS = (
    "record", "run_id", "schema", "ok", "modules", "failed",
    "total_runtime_s",
)


def config_hash(config: Dict[str, Any]) -> str:
    """Stable short hash of a JSON-serializable config mapping."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _device_info() -> Dict[str, Any]:
    import torch

    on_card = torch.cuda.is_available()
    return {
        "jax_version": None,
        "backend": "cuda" if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
        "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu",
    }


class ManifestWriter:
    """Appends one run's records to a JSONL manifest file.

    Usage::

        mw = ManifestWriter(path, argv=sys.argv[1:], config=vars(args))
        mw.start(profile_dir=args.profile)
        mw.module("fig16_tradeoff", ok=True, runtime_s=3.2, rows=rows, ...)
        mw.summary(ok=True, failed=[])
    """

    def __init__(
        self,
        path: str,
        *,
        argv: Sequence[str] = (),
        config: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.path = path
        self.argv = list(argv)
        self.config = dict(config or {})
        self.run_id = (
            f"{int(time.time() * 1000):x}-{os.getpid()}-{next(_RUN_COUNTER)}"
        )
        self._t0 = time.time()
        self._modules: List[str] = []

    def _write(self, record: Dict[str, Any]) -> None:
        record = dict(record, run_id=self.run_id, schema=SCHEMA_VERSION)
        directory = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(directory, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(record, sort_keys=True, default=str) + "\n")

    def start(self, profile_dir: Optional[str] = None) -> None:
        self._write(
            {
                "record": "run",
                "argv": self.argv,
                "config_hash": config_hash(self.config),
                "profile_dir": profile_dir,
                "started_unix": self._t0,
                **_device_info(),
            }
        )

    def module(
        self,
        name: str,
        *,
        ok: bool,
        runtime_s: float,
        rows: Sequence[Dict[str, Any]] = (),
        baseline: Sequence[Dict[str, Any]] = (),
        bench_json: Optional[str] = None,
        spans: Sequence[Dict[str, Any]] = (),
        checkpoints: Sequence[Dict[str, Any]] = (),
    ) -> None:
        # CLAIM rows (benchmarks.common.claim) carry PASS/FAIL in ``value``
        # and the human-readable description in ``note``.
        claims = [
            {
                "description": str(r.get("note", "")),
                "ok": str(r.get("value")) == "PASS",
            }
            for r in rows
            if r.get("metric") == "CLAIM"
        ]
        self._modules.append(name)
        self._write(
            {
                "record": "module",
                "name": name,
                "ok": bool(ok),
                "runtime_s": float(runtime_s),
                "claims": claims,
                "baseline": list(baseline),
                "bench_json": bench_json,
                "spans": list(spans),
                # snapshot save/restore events of a checkpointed module
                "checkpoints": list(checkpoints),
                "num_rows": len(rows),
            }
        )

    def summary(self, *, ok: bool, failed: Sequence[str] = ()) -> None:
        self._write(
            {
                "record": "summary",
                "ok": bool(ok),
                "modules": list(self._modules),
                "failed": list(failed),
                "total_runtime_s": time.time() - self._t0,
            }
        )


def read_manifest(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL manifest back into its records (all runs)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def runs_in_manifest(
    records: Sequence[Dict[str, Any]],
) -> Dict[str, List[Dict[str, Any]]]:
    """Group manifest records by ``run_id`` (insertion-ordered)."""
    runs: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        runs.setdefault(rec.get("run_id", "?"), []).append(rec)
    return runs
