"""The whole OCEAN trajectory on the card: kernel K3 ``ocean_traj``.

K3 replaces ``repro/kernels/ocean_traj.py::_traj_kernel`` (:96,
``pallas_call`` at :532).  The CUDA source is ``csrc/ocean_traj.cu``: one
persistent block per cell runs all T rounds of Alg. 1 with the queues and
the spent energy resident in shared memory; its header states what bounds
it on the H100 and what the design does about it.

* ``ocean_traj`` — the wrapper: launches K3 for CUDA tensors (counting
  launches in ``ocean_traj.launches``, raising on CUDA errors) and runs
  the plain version for CPU tensors.
* ``ocean_traj_plain`` — the plain PyTorch version: the port's scan loop
  through ``ocean_round`` with the plain K1 sweep.
* ``ocean_trajectory_fused`` — the ``traj="fused"`` backend of
  ``repro_torch.core.ocean.simulate``.

Scope of this slice: ``ranking="sort"``, ``solver="pallas"``, static radio,
K <= 2048 (K3's shared-memory sort).  Anything else raises
``NotImplementedError``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels.ocean_p import (
    INNER_ITERS,
    OUTER_ITERS,
    _check_f32,
    _launch_target,
    _ptr,
    _stream,
)

MAX_CLIENTS = 2048


class TrajOut(NamedTuple):
    a: torch.Tensor         # (C, T, K) bool
    b: torch.Tensor         # (C, T, K)
    e: torch.Tensor         # (C, T, K)
    q_pre: torch.Tensor     # (C, T, K) queues used by each round's P3
    rho: torch.Tensor       # (C, T, K)
    obj: torch.Tensor       # (C, T)
    nsel: torch.Tensor      # (C, T) int32
    q_final: torch.Tensor   # (C, K)
    es_final: torch.Tensor  # (C, K)


def check_fused_scope(cfg) -> None:
    """Raise for configurations K3 does not run yet."""
    from repro_torch.core.ocean import not_ported
    from repro_torch.core.solvers import get_solver

    name = get_solver(cfg.solver).name
    if cfg.ranking != "sort" or name != "pallas":
        raise not_ported(
            f"traj='fused' with ranking={cfg.ranking!r} and solver={name!r} "
            f"(the fused kernel runs ranking='sort' with solver='pallas')"
        )
    if cfg.num_clients > MAX_CLIENTS:
        raise not_ported(
            f"traj='fused' at K={cfg.num_clients} (the fused kernel's "
            f"shared-memory sort holds K <= {MAX_CLIENTS})"
        )


def ocean_traj_plain(cfg, h2, v, eta, inc) -> TrajOut:
    """Plain PyTorch K3: the scan loop through ``ocean_round`` with plain K1."""
    from repro_torch.core.ocean import init_state, ocean_round, stack_decisions
    from repro_torch.core.solvers import PALLAS_PLAIN

    cfg_plain = dataclasses.replace(cfg, solver=PALLAS_PLAIN, traj="scan")
    C, T, _ = h2.shape
    state = init_state(cfg_plain, C, device=h2.device)
    decs = []
    for t in range(T):
        state, dec = ocean_round(
            state, h2[:, t], v[:, t], eta[:, t], cfg_plain, budget_inc=inc[:, t]
        )
        decs.append(dec)
    d = stack_decisions(decs)
    return TrajOut(
        a=d.a, b=d.b, e=d.e, q_pre=d.q, rho=d.rho, obj=d.objective,
        nsel=d.num_selected, q_final=state.q, es_final=state.energy_spent,
    )


def ocean_traj(cfg, h2, v, eta, inc) -> TrajOut:
    """K3: every cell's T rounds in one launch.

    ``h2``/``inc`` (C, T, K) and ``v``/``eta`` (C, T), contiguous float32
    on one device; ``cfg`` supplies K, T, R and the radio.
    """
    check_fused_scope(cfg)
    for name, x, nd in (("h2", h2, 3), ("v", v, 2), ("eta", eta, 2), ("inc", inc, 3)):
        _check_f32(name, x, nd)
    C, T, K = h2.shape
    if (T, K) != (cfg.num_rounds, cfg.num_clients) or inc.shape != h2.shape:
        raise ValueError(
            f"h2/inc must be (C, {cfg.num_rounds}, {cfg.num_clients}); got "
            f"{tuple(h2.shape)} and {tuple(inc.shape)}"
        )
    if v.shape != (C, T) or eta.shape != (C, T):
        raise ValueError(f"v and eta must be ({C}, {T})")
    if _launch_target(h2, v, eta, inc) == "cpu":
        return ocean_traj_plain(cfg, h2, v, eta, inc)
    from repro_torch.kernels import _build

    lib = _build.load("ocean_traj")
    fn = lib.ocean_traj_launch
    fn.restype = ctypes.c_int
    f32 = dict(dtype=torch.float32, device=h2.device)
    out = TrajOut(
        a=torch.empty((C, T, K), dtype=torch.bool, device=h2.device),
        b=torch.empty((C, T, K), **f32),
        e=torch.empty((C, T, K), **f32),
        q_pre=torch.empty((C, T, K), **f32),
        rho=torch.empty((C, T, K), **f32),
        obj=torch.empty((C, T), **f32),
        nsel=torch.empty((C, T), dtype=torch.int32, device=h2.device),
        q_final=torch.empty((C, K), **f32),
        es_final=torch.empty((C, K), **f32),
    )
    if C == 0:
        return out
    radio = cfg.radio
    err = fn(
        _ptr(h2), _ptr(v), _ptr(eta), _ptr(inc), *(_ptr(x) for x in out),
        ctypes.c_int(C), ctypes.c_int(T), ctypes.c_int(K), ctypes.c_int(cfg.R),
        ctypes.c_float(radio.b_min), ctypes.c_float(radio.beta),
        ctypes.c_float(radio.energy_scale), ctypes.c_int(OUTER_ITERS),
        ctypes.c_int(INNER_ITERS), _stream(),
    )
    _build.check(err, lib, "ocean_traj")
    ocean_traj.launches += 1
    return out


ocean_traj.launches = 0


def ocean_trajectory_fused(
    cfg,
    h2_seq,
    v_seq,
    eta_seq,
    budget_seq,
    radio_seq=None,
    failure_seq=None,
    *,
    chunk=None,
    stream_bf16: bool = False,
    init_state=None,
    init_mstate=None,
    raw_metrics: bool = False,
):
    """The ``fused`` trajectory backend: (OceanState, stacked RoundDecision).

    Inputs carry the cell axis: ``h2_seq``/``budget_seq`` (C, T, K),
    ``v_seq``/``eta_seq`` (C, T).  ``chunk`` is accepted for signature
    parity and has no role: K3 keeps every round on chip.
    """
    from repro_torch.core.ocean import OceanState, RoundDecision, not_ported

    del chunk
    if radio_seq is not None:
        raise not_ported("radio_seq")
    if failure_seq is not None:
        raise not_ported("failure_seq")
    if stream_bf16:
        raise not_ported("stream_bf16")
    if init_state is not None or init_mstate is not None or raw_metrics:
        raise not_ported("segment launches (checkpoint/resume, metrics)")
    out = ocean_traj(cfg, h2_seq, v_seq, eta_seq, budget_seq)
    C = h2_seq.shape[0]
    state = OceanState(
        q=out.q_final,
        t=torch.full((C,), cfg.num_rounds, dtype=torch.int32, device=h2_seq.device),
        energy_spent=out.es_final,
    )
    decs = RoundDecision(
        a=out.a, b=out.b, e=out.e, q=out.q_pre, rho=out.rho,
        objective=out.obj, num_selected=out.nsel,
    )
    return state, decs
