"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v [per-source flags] \
         -o build/repro_torch_kernels/<name>-<hash>.so csrc/<name>.cu

``--use_fast_math`` is deliberately absent: it turns ``exp2f`` into
``ex2.approx`` with flush-to-zero, which breaks parity with the plain
PyTorch versions near the +-80 exponent clip.  The OCEAN sources
(``ocean_p``, ``ocean_traj``, ``ocean_traj_metrics``) add ``-fmad=false``, which keeps
``a * b + c`` as two rounded operations, as PyTorch's one-op-per-kernel
plain versions compute it: with contraction, last-bit differences steer
the Newton iterations onto other safeguard branches and those kernels
drift from their plain versions by far more than an ulp.  The attention
kernels (``flash_attention``, ``decode_attention``) and the scans
(``mamba_scan``, ``rwkv6_scan``) have no such branch points: a softmax
or a linear recurrence is continuous in its inputs, so an ulp of
contraction moves the output by an ulp, and they compile with
contraction on.  The
output name carries a hash of the sources and flags, so an edited source
is rebuilt, never reused stale.  The build directory is ``build/repro_torch_kernels/`` at
the root of the checkout, or ``$REPRO_TORCH_BUILD_DIR``.  Building happens
at first use, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (
    "ocean_p", "ocean_traj", "ocean_traj_metrics", "flash_attention", "decode_attention",
    "mamba_scan", "rwkv6_scan",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # report registers and shared memory per kernel
)
SOURCE_FLAGS = {"ocean_p": ("-fmad=false",), "ocean_traj": ("-fmad=false",),
                "ocean_traj_metrics": ("-fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# Wall seconds and nvcc/ptxas output of the builds this process ran.
BUILD_LOG: Dict[str, dict] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the port's CUDA "
        "kernels are built from source at first use"
    )


def nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES):
    """Compile every named source that has no current library, all at once.

    One ``nvcc`` process per source, started together; each one's output
    (with ptxas's register and shared-memory report) goes to ``BUILD_LOG``.
    Raises ``RuntimeError`` carrying nvcc's output when any build fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            target,
            time.perf_counter(),
        )
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "output": out}
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target = _lib_path(name)
            if not target.exists():
                build([name])
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
        return lib


def check(err: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        fn = lib.error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err}: {fn(err).decode()}")


def launch_target(*tensors) -> str:
    """``"cpu"`` or ``"cuda"``: the one device all ``tensors`` share.

    Raises for tensors on different devices or on any other device type.
    """
    devs = {t.device.type for t in tensors}
    if len(devs) != 1 or len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs must share one device; got {devs}")
    dev = devs.pop()
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev!r}")
    return dev


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for a launch function's last argument."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
