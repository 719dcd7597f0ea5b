"""The whole OCEAN trajectory on the card: kernel K3 ``ocean_traj``.

K3 replaces ``repro/kernels/ocean_traj.py::_traj_kernel`` (:96,
``pallas_call`` at :532).  The CUDA source is ``csrc/ocean_traj.cu``: one
persistent block per cell runs all T rounds of Alg. 1 with the queues and
the spent energy resident in shared memory, each round's prefix
candidates side by side (a warp, or at K <= 16 a half warp, per
candidate: K1's sweep); its header states what bounds it on the H100 and
what the design does about it.  Compile-time branches stream per-round
radio physics (``radio``) and per-client delivery failures (``failure``,
with ``cfg.failure_mode``), run the ``bisect`` solver's sweep instead of
K1's, and guard the round (``cfg.guard``, a ``repro_torch.guard.GuardSpec``:
quarantine, energy admission, the bisect fallback).  A chaos backend
(``repro_torch.guard.chaos``) of ``pallas`` or ``bisect`` runs on the
guarded instance, which applies its corruption inside the round.

* ``ocean_traj`` — the wrapper: launches K3 for CUDA tensors (counting
  launches in ``ocean_traj.launches``, raising on CUDA errors) and runs
  the plain version for CPU tensors.
* ``ocean_traj_plain`` — the plain PyTorch version: the port's scan loop
  through ``ocean_round`` with the plain K1 sweep (or ``bisect``).
* ``ocean_trajectory_fused`` — the ``traj="fused"`` backend of
  ``repro_torch.core.ocean.simulate``.

Scope: ``ranking="sort"``, ``solver`` ``pallas`` or ``bisect`` (or a chaos
backend of either), K <= 2048 (K3's shared-memory sort).  Anything else
raises ``NotImplementedError``.  Like the reference's kernel, K3 caps a
guard's energy at ``energy_cap x cfg.budgets()``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

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
FUSED_SOLVERS = ("pallas", "bisect")
# The bisect sweep's outer and inner halvings: ``ocean_p``'s defaults.
BISECT_ITERS = 42
# The guard's bits and the chaos kinds, as csrc/ocean_traj.cu numbers them.
_QUARANTINE, _FLOOR, _FALLBACK = 1, 2, 4
_CHAOS = {None: 0, "objective": 1, "budget": 2}


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
    dlv: Optional[torch.Tensor] = None  # (C, T, K) bool, with a failure process
    ral: Optional[torch.Tensor] = None  # (C, T) int32, with a failure process
    fc: Optional[torch.Tensor] = None   # (C, T) int32 fault_count, with a guard
    dm: Optional[torch.Tensor] = None   # (C, T) int32 demoted, with a guard
    fb: Optional[torch.Tensor] = None   # (C, T) int32 fallback, with a guard


def _base_solver(backend) -> str:
    """The solver a backend's sweep is: a chaos backend's base, else its name."""
    return backend.chaos[0] if backend.chaos is not None else backend.name


def check_fused_scope(cfg) -> None:
    """Raise for configurations K3 does not run yet.  Within them every
    instance fits a block's shared memory: at K = 2048 a guarded failure
    instance needs 98,704 bytes with one warp of teams, and the launch
    takes as many teams as fit (``csrc/ocean_traj.cu::traj_smem``)."""
    from repro_torch.core.ocean import not_ported
    from repro_torch.core.solvers import get_solver

    backend = get_solver(cfg.solver)
    if cfg.ranking != "sort" or _base_solver(backend) not in FUSED_SOLVERS:
        raise not_ported(
            f"traj='fused' with ranking={cfg.ranking!r} and solver={backend.name!r} "
            f"(the fused kernel runs ranking='sort' with solver 'pallas' or "
            f"'bisect', or a chaos backend of either)"
        )
    if cfg.num_clients > MAX_CLIENTS:
        raise not_ported(
            f"traj='fused' at K={cfg.num_clients} (the fused kernel's "
            f"shared-memory sort holds K <= {MAX_CLIENTS})"
        )


def _wf_budgets(K: int):
    """The masked P4's (outer, inner, grid) and grid fractions at K clients:
    ``waterfill_newton``'s float32 budgets and ``torch.linspace``."""
    from repro_torch.core.solvers import newton_iteration_budgets

    outer, inner, grid = newton_iteration_budgets(torch.float32, K)
    return outer, inner, grid, torch.linspace(0.0, 1.0, grid, dtype=torch.float32)


def _plain_solver(backend):
    """The backend K3's plain version runs: the plain K1 sweep for
    ``pallas``, ``bisect`` as it is, and a chaos backend's corruption on
    its base's plain solve."""
    from repro_torch.core.solvers import PALLAS_PLAIN
    from repro_torch.guard.chaos import chaos_backend

    if _base_solver(backend) == "bisect":
        return backend
    if backend.chaos is None:
        return PALLAS_PLAIN
    _, kind, scale = backend.chaos
    return chaos_backend(PALLAS_PLAIN, backend.name, kind=kind, scale=scale)


def ocean_traj_plain(cfg, h2, v, eta, inc, radio=None, failure=None) -> TrajOut:
    """Plain PyTorch K3: the scan loop through ``ocean_round`` with plain K1
    (or bisect), guarded by ``cfg.guard`` with caps at ``cfg.budgets()``.

    ``radio`` is a ``TracedRadio`` of (C, T) leaves; ``failure`` a
    ``TracedFailure`` with a (C, T, K) ``delivered`` mask and (C, K) ``rate``.
    """
    from repro_torch.core.ocean import init_state, ocean_round, stack_decisions
    from repro_torch.core.solvers import get_solver

    cfg_plain = dataclasses.replace(
        cfg, solver=_plain_solver(get_solver(cfg.solver)), traj="scan")
    C, T, _ = h2.shape
    state = init_state(cfg_plain, C, device=h2.device)
    decs = []
    for t in range(T):
        state, dec = ocean_round(
            state, h2[:, t], v[:, t], eta[:, t], cfg_plain, budget_inc=inc[:, t],
            radio=None if radio is None else radio.at(t),
            delivered=None if failure is None else failure.delivered[:, t],
            fail_rate=None if failure is None else failure.rate,
        )
        decs.append(dec)
    d = stack_decisions(decs)
    return TrajOut(
        a=d.a, b=d.b, e=d.e, q_pre=d.q, rho=d.rho, obj=d.objective,
        nsel=d.num_selected, q_final=state.q, es_final=state.energy_spent,
        dlv=d.delivered, ral=d.realloc, fc=d.fault_count, dm=d.demoted, fb=d.fallback,
    )


def ocean_traj(cfg, h2, v, eta, inc, radio=None, failure=None) -> TrajOut:
    """K3: every cell's T rounds in one launch.

    ``h2``/``inc`` (C, T, K) and ``v``/``eta`` (C, T), contiguous float32
    on one device; ``cfg`` supplies K, T, R, the static radio, the failure
    mode, the solver and the guard.  ``radio`` (optional) streams (C, T)
    ``b_min``, ``beta`` and ``energy_scale`` leaves in place of
    ``cfg.radio``; ``failure`` (optional) a (C, T, K) ``delivered`` mask and
    (C, K) ``rate``.  Gains and increments may be non-finite under a
    guard's quarantine: the kernel screens them.
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
    streams = [h2, v, eta, inc]
    if radio is not None:
        for f in ("b_min", "beta", "energy_scale"):
            _check_f32(f"radio.{f}", getattr(radio, f), 2)
            if getattr(radio, f).shape != (C, T):
                raise ValueError(f"radio.{f} must be ({C}, {T})")
            streams.append(getattr(radio, f))
    if failure is not None:
        _check_f32("failure.delivered", failure.delivered, 3)
        _check_f32("failure.rate", failure.rate, 2)
        if failure.delivered.shape != h2.shape or failure.rate.shape != (C, K):
            raise ValueError(f"failure.delivered must be {tuple(h2.shape)} and rate ({C}, {K})")
        streams += [failure.delivered, failure.rate]
    if _launch_target(*streams) == "cpu":
        return ocean_traj_plain(cfg, h2, v, eta, inc, radio, failure)
    from repro_torch.kernels import _build

    from repro_torch.core.ocean import guard_caps
    from repro_torch.core.solvers import get_solver

    lib = _build.load("ocean_traj")
    fn = lib.ocean_traj_launch
    fn.restype = ctypes.c_int
    dev = h2.device
    f32 = dict(dtype=torch.float32, device=dev)
    guard = cfg.guard
    backend = get_solver(cfg.solver)
    bisect = _base_solver(backend) == "bisect"
    chaos = backend.chaos
    # a chaos backend without a guard runs on the guarded instance with
    # every defence off: the unguarded round's bits, corrupted
    guarded = guard is not None or chaos is not None
    i32 = dict(dtype=torch.int32, device=dev)
    gout = [torch.empty((C, T), **i32) for _ in range(3)] if guarded else [None] * 3
    out = TrajOut(
        a=torch.empty((C, T, K), dtype=torch.bool, device=dev),
        b=torch.empty((C, T, K), **f32),
        e=torch.empty((C, T, K), **f32),
        q_pre=torch.empty((C, T, K), **f32),
        rho=torch.empty((C, T, K), **f32),
        obj=torch.empty((C, T), **f32),
        nsel=torch.empty((C, T), dtype=torch.int32, device=dev),
        q_final=torch.empty((C, K), **f32),
        es_final=torch.empty((C, K), **f32),
        dlv=None if failure is None else torch.empty((C, T, K), dtype=torch.bool, device=dev),
        ral=None if failure is None else torch.empty((C, T), dtype=torch.int32, device=dev),
        **dict(zip(("fc", "dm", "fb"), gout if guard is not None else [None] * 3)),
    )
    if C == 0:
        return out
    # the kernel's kPlain, kOverprovision, kReallocate are this tuple's order
    from repro_torch.core.ocean import FAILURE_MODES

    wf_outer, wf_inner, wf_grid, frac = _wf_budgets(K)
    frac = frac.to(dev)
    rad = cfg.radio
    r_ptrs = [None] * 3 if radio is None else [radio.b_min, radio.beta, radio.energy_scale]
    cap, bits, floor, tol = None, 0, 0.0, 0.0
    if guard is not None:
        if guard.energy_cap is not None:
            cap = guard_caps(guard, cfg.budgets(device=dev)).contiguous()
        bits = ((_QUARANTINE if guard.quarantine else 0) | (_FALLBACK if guard.fallback else 0)
                | (_FLOOR if guard.gain_floor is not None else 0))
        floor = guard.gain_floor or 0.0
        tol = guard.residual_tol
    kind, scale = (None, 1.0) if chaos is None else chaos[1:]
    err = fn(
        _ptr(h2), _ptr(v), _ptr(eta), _ptr(inc), *(_ptr(x) for x in out[:9]),
        ctypes.c_int(C), ctypes.c_int(T), ctypes.c_int(K), ctypes.c_int(cfg.R),
        ctypes.c_float(rad.b_min), ctypes.c_float(rad.beta),
        ctypes.c_float(rad.energy_scale), ctypes.c_int(OUTER_ITERS),
        ctypes.c_int(INNER_ITERS), *(_ptr(x) for x in r_ptrs),
        _ptr(None if failure is None else failure.delivered),
        _ptr(None if failure is None else failure.rate),
        _ptr(out.dlv), _ptr(out.ral), ctypes.c_int(FAILURE_MODES.index(cfg.failure_mode)),
        ctypes.c_int(wf_outer), ctypes.c_int(wf_inner), ctypes.c_int(wf_grid), _ptr(frac),
        ctypes.c_int(int(bisect)), ctypes.c_int(BISECT_ITERS), ctypes.c_int(BISECT_ITERS),
        ctypes.c_int(int(guarded)), _ptr(cap), *(_ptr(x) for x in gout), ctypes.c_int(bits),
        ctypes.c_float(floor), ctypes.c_float(tol), ctypes.c_int(_CHAOS[kind]),
        ctypes.c_float(scale), _stream(),
    )
    _build.check(err, lib, "ocean_traj")
    ocean_traj.launches += 1
    parts = (("radio", radio is not None), ("bisect", bisect), ("guard", guard is not None),
             ("chaos", chaos is not None), ("failure", failure is not None))
    inst = "+".join(n for n, on in parts if on) or "static"
    if failure is not None:
        inst += f"/{cfg.failure_mode}"
    ocean_traj.instances[inst] = ocean_traj.instances.get(inst, 0) + 1
    return out


ocean_traj.launches = 0
# launches by instance: "static", or the "+"-joined branches it ran of
# "radio", "bisect", "guard", "chaos" and "failure" (then "/<mode>"), e.g.
# "bisect+guard" or "radio+failure/plain"
ocean_traj.instances = {}


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
    ``v_seq``/``eta_seq`` (C, T); ``radio_seq`` a ``TracedRadio`` of (C, T)
    leaves and ``failure_seq`` a ``TracedFailure`` ((C, T, K), (C, K)).
    ``chunk`` is accepted for signature parity and has no role: K3 keeps
    every round on chip.
    """
    from repro_torch.core.ocean import OceanState, RoundDecision, not_ported

    del chunk
    if stream_bf16:
        raise not_ported("stream_bf16")
    if init_state is not None or init_mstate is not None or raw_metrics:
        raise not_ported("segment launches (checkpoint/resume, metrics)")
    out = ocean_traj(cfg, h2_seq, v_seq, eta_seq, budget_seq, radio_seq, failure_seq)
    C = h2_seq.shape[0]
    state = OceanState(
        q=out.q_final,
        t=torch.full((C,), cfg.num_rounds, dtype=torch.int32, device=h2_seq.device),
        energy_spent=out.es_final,
    )
    decs = RoundDecision(
        a=out.a, b=out.b, e=out.e, q=out.q_pre, rho=out.rho,
        objective=out.obj, num_selected=out.nsel, delivered=out.dlv, realloc=out.ral,
        fault_count=out.fc, demoted=out.dm, fallback=out.fb,
    )
    return state, decs
