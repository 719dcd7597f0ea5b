"""OCEAN-P on the card: the K1 prefix sweep and the K2 sort-free top-m solve.

K1 ``ocean_p_prefix`` replaces ``repro/kernels/ocean_p.py::_fused_kernel``
(:48, ``pallas_call`` at :208); K2 ``ocean_p_topm`` replaces
``::_topm_kernel`` (:232, ``pallas_call`` at :481).  The CUDA sources are
``csrc/ocean_p.cu`` and ``csrc/ocean_common.cuh``, whose header states
what bounds each kernel on the H100 and what the design does about it.

Each kernel has three pieces here:

* the wrapper (``ocean_p_prefix`` / ``ocean_p_topm``): checks its inputs,
  launches the kernel for CUDA tensors — counting the launch in its
  ``launches`` attribute and raising on any CUDA error — and runs the
  plain version for CPU tensors; there is no fallback from one to the
  other;
* the plain PyTorch version (``*_plain``): the same function on a
  (C, K+1, L) candidate lattice, used by the CPU tests and by the chip
  checks that hold the kernel against it;
* the backend-level function (``ocean_p_prefixes_fused`` /
  ``ocean_p_topm_fused``) that ``repro_torch.core.solvers`` routes to.

Inputs carry the cell axis: ``scal`` is (C, 8) float32 =
[n0, delta, V*eta, beta, b_min, energy_scale, 0, 0].
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.energy import (
    f_shannon,
    f_shannon_prime,
    f_shannon_second,
)
from repro_torch.kernels._build import launch_target as _launch_target
from repro_torch.kernels._build import ptr as _ptr
from repro_torch.kernels._build import stream as _stream

NEG_INF = -1e30
_RHO_ZERO_TOL = 1e-30
OUTER_ITERS = 12
INNER_ITERS = 9


def _check_f32(name, x, ndim):
    if x.dtype != torch.float32 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous float32 tensor of rank {ndim}; got "
            f"{x.dtype} of shape {tuple(x.shape)}"
        )


# --------------------------------------------------------------------------
# the candidate sweep, plain PyTorch (shared by the K1 and K2 plain versions)
# --------------------------------------------------------------------------
def _sweep_plain(rho, start, n_cands, scal, kf, outer, inner, mask_nonfinite):
    """W of every candidate m in [0, n_cands] and its allocation.

    ``rho`` (C, L) ranked priorities; candidate m owns slots
    [start, start + m).  Returns ``w`` (C, M) with the reference's NEG_INF
    masking and ``b`` (C, M, L).  Mirrors ``_fused_kernel``'s candidate
    body op for op, vectorized over the candidate axis.
    """
    from repro_torch.core.solvers import _budget_repair, _geo_mid, b_of_lam_newton

    C, L = rho.shape
    dev = rho.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    n0, delta, v_eta, beta, b_min, scale = (scal[:, i : i + 1] for i in range(6))
    mf = torch.arange(n_cands + 1, dtype=torch.float32, device=dev)[None, :]
    cols = torch.arange(L, dtype=torch.float32, device=dev)
    s3 = start[:, :, None]
    mask = (cols >= s3) & (cols < s3 + mf[:, :, None])          # (C, M, L)
    b_max = torch.maximum(delta - torch.clamp(mf - 1.0, min=0.0) * b_min, b_min)
    rho3 = rho[:, None, :]
    fp_min = -f_shannon_prime(b_min, beta)
    rho_max = torch.where(mask, rho3, zero).amax(-1)
    lam_hi = rho_max * fp_min * (1.0 + 1e-6) + 1e-30
    rho_min = torch.where(mask, rho3, torch.inf).amin(-1)
    rho_min = torch.where(torch.isfinite(rho_min), rho_min, zero)
    b_eq = torch.minimum(
        torch.maximum(delta / torch.clamp(mf, min=1.0), b_min), b_max
    )
    lam0 = torch.sqrt(torch.clamp(rho_min * rho_max, min=1e-30)) * torch.clamp(
        -f_shannon_prime(b_eq, beta), min=1e-30
    )
    lam = torch.minimum(torch.clamp(lam0, min=0.0), lam_hi)
    lo, hi = torch.zeros_like(lam_hi), lam_hi

    beta3, bmin3, bmax3 = beta[:, :, None], b_min[:, :, None], b_max[:, :, None]
    for _ in range(outer):
        b = b_of_lam_newton(lam[..., None], rho3, beta3, bmin3, bmax3, inner)
        r = torch.where(mask, b, zero).sum(-1) - delta
        too_big = r > 0
        lo = torch.where(too_big, lam, lo)
        hi = torch.where(too_big, hi, lam)
        interior = mask & (b > bmin3) & (b < bmax3)
        dbdlam = -1.0 / (
            torch.clamp(rho3, min=1e-30)
            * torch.clamp(f_shannon_second(b, beta3), min=1e-30)
        )
        drdlam = torch.where(interior, dbdlam, zero).sum(-1)
        lam_n = lam - r / torch.clamp(drdlam, max=-1e-30)
        ok = (lam_n >= lo) & (lam_n <= hi) & torch.isfinite(lam_n)
        lam = torch.where(ok, lam_n, _geo_mid(lo, hi))
    b = b_of_lam_newton(lam[..., None], rho3, beta3, bmin3, bmax3, inner)
    b = torch.where(mask, b, zero)
    b = _budget_repair(b, mask, delta[:, :, None], bmin3, bmax3)
    cost = torch.where(
        mask, rho3 * f_shannon(torch.maximum(b, bmin3), beta3), zero
    ).sum(-1)
    has_any = mf > 0
    b = torch.where(has_any[:, :, None], b, zero)
    cost = torch.where(has_any, cost, zero)

    w = v_eta * (n0 + mf) - scale * cost
    valid = mf <= kf - n0
    if mask_nonfinite:
        valid = valid & torch.isfinite(w)
    w = torch.where(valid, w, torch.full_like(w, NEG_INF))
    return w, b


def _argmax_strict(w):
    """The sequential sweep's winner: strict >, so NaN never wins and ties
    keep the smaller m (the first maximum)."""
    return torch.argmax(torch.where(torch.isnan(w), -torch.inf, w), dim=1)


def prefix_objectives_plain(scal, rho, *, n_cands=None, outer=OUTER_ITERS, inner=INNER_ITERS):
    """(C, M) W of every K1 candidate — for near-tie margins in checks."""
    K = rho.shape[1]
    n_cands = K if n_cands is None else n_cands
    w, _ = _sweep_plain(rho, scal[:, :1], n_cands, scal, float(K), outer, inner, False)
    return w


# --------------------------------------------------------------------------
# K1 — ocean_p_prefix
# --------------------------------------------------------------------------
def ocean_p_prefix_plain(scal, rho, *, n_cands=None, outer=OUTER_ITERS, inner=INNER_ITERS):
    """Plain PyTorch K1: (C, 8) scal, (C, K) sorted rho -> b (C, K), wm (C, 2)."""
    C, K = rho.shape
    n_cands = K if n_cands is None else n_cands
    w, b_all = _sweep_plain(
        rho, scal[:, :1], n_cands, scal, float(K), outer, inner, False
    )
    best = _argmax_strict(w)
    rows = torch.arange(C, device=rho.device)
    wm = torch.stack([w[rows, best], best.to(torch.float32)], dim=1)
    return b_all[rows, best].contiguous(), wm


def ocean_p_prefix(scal, rho, *, n_cands=None, outer=OUTER_ITERS, inner=INNER_ITERS):
    """K1: all K+1 prefix candidates per cell, the winner's b and [W*, m*].

    ``scal`` (C, 8) and ``rho`` (C, K) sorted ascending, both contiguous
    float32 on one device.  ``n_cands`` clips the sweep to m in
    [0, n_cands] (the top-m ranking path).
    """
    _check_f32("scal", scal, 2)
    _check_f32("rho", rho, 2)
    C, K = rho.shape
    if scal.shape != (C, 8):
        raise ValueError(f"scal must be ({C}, 8); got {tuple(scal.shape)}")
    n_cands = K if n_cands is None else int(n_cands)
    if not 0 <= n_cands <= K:
        raise ValueError(f"n_cands={n_cands} must lie in [0, K={K}]")
    if _launch_target(scal, rho) == "cpu":
        return ocean_p_prefix_plain(scal, rho, n_cands=n_cands, outer=outer, inner=inner)
    from repro_torch.kernels import _build

    lib = _build.load("ocean_p")
    fn = lib.ocean_p_prefix_launch
    fn.restype = ctypes.c_int
    b = torch.empty_like(rho)
    wm = torch.empty((C, 2), dtype=torch.float32, device=rho.device)
    if C == 0:
        return b, wm
    err = fn(
        _ptr(scal), _ptr(rho), _ptr(b), _ptr(wm), ctypes.c_int(C),
        ctypes.c_int(K), ctypes.c_int(n_cands), ctypes.c_int(outer),
        ctypes.c_int(inner), _stream(),
    )
    _build.check(err, lib, "ocean_p_prefix")
    ocean_p_prefix.launches += 1
    return b, wm


ocean_p_prefix.launches = 0


def _scal(n0, delta, v_eta, radio, like):
    C = like.shape[0]
    f32 = dict(dtype=torch.float32, device=like.device)
    col = lambda x: torch.as_tensor(x, **f32).expand(C)  # noqa: E731
    z = torch.zeros(C, **f32)
    return torch.stack(
        [
            col(n0), col(delta), col(v_eta), col(radio.beta), col(radio.b_min),
            col(radio.energy_scale), z, z,
        ],
        dim=1,
    ).contiguous()


def ocean_p_prefixes_fused(
    rho_sorted: torch.Tensor,
    n0: torch.Tensor,
    delta: torch.Tensor,
    v_eta: torch.Tensor,
    radio,
    *,
    outer_iters: int = OUTER_ITERS,
    inner_iters: int = INNER_ITERS,
    n_cands: Optional[int] = None,
    plain: bool = False,
):
    """Backend contract of ``solver="pallas"``: the winning prefix per cell.

    ``rho_sorted`` (C, K); ``n0``/``delta``/``v_eta`` (C,).  ``plain=True``
    runs the plain version on any device.  Returns a ``PrefixSolution``.
    """
    from repro_torch.core.solvers import PrefixSolution

    C, K = rho_sorted.shape
    dtype = rho_sorted.dtype
    scal = _scal(n0, delta, v_eta, radio, rho_sorted)
    rho = rho_sorted.to(torch.float32).contiguous()
    fn = ocean_p_prefix_plain if plain else ocean_p_prefix
    b, wm = fn(scal, rho, n_cands=n_cands, outer=outer_iters, inner=inner_iters)
    m_star = torch.round(wm[:, 1]).to(torch.int32)
    ranks = torch.arange(K, device=rho.device)
    n0c = n0.to(torch.int64)[:, None]
    sel = (ranks >= n0c) & (ranks < n0c + m_star[:, None])
    return PrefixSolution(
        m_star=m_star,
        w_star=wm[:, 0].to(dtype),
        b_pos_sorted=b.to(dtype),
        sel_pos_sorted=sel,
    )


# --------------------------------------------------------------------------
# K2 — ocean_p_topm
# --------------------------------------------------------------------------
def extract_min_plain(work: torch.Tensor, top_m: int):
    """``top_m`` rounds of (min, first argmin, mask to +inf) per row.

    Exhausted rows give +inf values and index 0, as the reference does.
    """
    work = work.clone()
    rows = torch.arange(work.shape[0], device=work.device)
    vals, idxs = [], []
    for _ in range(top_m):
        i = torch.argmin(work, dim=1)
        vals.append(work[rows, i])
        idxs.append(i)
        work[rows, i] = torch.inf
    return torch.stack(vals, 1), torch.stack(idxs, 1)


def ocean_p_topm_plain(scal, rho, *, K, top_m, outer=OUTER_ITERS, inner=INNER_ITERS):
    """Plain PyTorch K2: extraction, compact sweep, scatter to client order."""
    C, K_pad = rho.shape
    vals, idx = extract_min_plain(rho, top_m)
    start = torch.zeros((C, 1), dtype=torch.float32, device=rho.device)
    w, b_all = _sweep_plain(vals, start, top_m, scal, float(K), outer, inner, True)
    best = _argmax_strict(w)
    rows = torch.arange(C, device=rho.device)
    best_m = best.to(torch.float32)
    jcol = torch.arange(top_m, dtype=torch.float32, device=rho.device)
    sel = (jcol[None, :] < best_m[:, None]) & torch.isfinite(vals)
    b_sel = torch.where(sel, b_all[rows, best], torch.zeros((), device=rho.device))
    b = torch.zeros((C, K_pad), dtype=torch.float32, device=rho.device)
    b.scatter_add_(1, idx, b_sel)
    wm = torch.stack([w[rows, best], best_m], dim=1)
    return b, wm


def ocean_p_topm(scal, rho, *, K, top_m, outer=OUTER_ITERS, inner=INNER_ITERS):
    """K2: the sort-free P3 solve on client-order rho.

    ``rho`` (C, K_pad) holds rho where rho > 1e-30 and +inf elsewhere
    (S0 clients and padding).  Returns ``b`` (C, K_pad) in client order
    and ``wm`` (C, 2) = [W*, m*].
    """
    _check_f32("scal", scal, 2)
    _check_f32("rho", rho, 2)
    C, K_pad = rho.shape
    if scal.shape != (C, 8):
        raise ValueError(f"scal must be ({C}, 8); got {tuple(scal.shape)}")
    if not 1 <= top_m <= K_pad:
        raise ValueError(f"top_m={top_m} must lie in [1, K_pad={K_pad}]")
    if _launch_target(scal, rho) == "cpu":
        return ocean_p_topm_plain(scal, rho, K=K, top_m=top_m, outer=outer, inner=inner)
    from repro_torch.kernels import _build

    lib = _build.load("ocean_p")
    smem_of = lib.ocean_p_topm_smem_bytes
    smem_of.restype = ctypes.c_longlong
    optin = lib.smem_optin_bytes()
    resident = smem_of(ctypes.c_int(K_pad), ctypes.c_int(top_m), ctypes.c_int(1)) <= optin
    work = None if resident else torch.empty_like(rho)
    fn = lib.ocean_p_topm_launch
    fn.restype = ctypes.c_int
    b = torch.empty_like(rho)
    wm = torch.empty((C, 2), dtype=torch.float32, device=rho.device)
    if C == 0:
        return b, wm
    err = fn(
        _ptr(scal), _ptr(rho), _ptr(b), _ptr(wm), _ptr(work), ctypes.c_int(C),
        ctypes.c_int(K), ctypes.c_int(K_pad), ctypes.c_int(top_m),
        ctypes.c_int(outer), ctypes.c_int(inner), _stream(),
    )
    _build.check(err, lib, "ocean_p_topm")
    ocean_p_topm.launches += 1
    return b, wm


ocean_p_topm.launches = 0


def ocean_p_topm_fused(
    rho: torch.Tensor,
    n0: torch.Tensor,
    delta: torch.Tensor,
    v_eta: torch.Tensor,
    radio,
    *,
    top_m: int,
    block_k: int = 128,
    outer_iters: int = OUTER_ITERS,
    inner_iters: int = INNER_ITERS,
):
    """Backend contract of ``solver="pallas_tiled"`` on client-order rho.

    Pads the client axis to a ``block_k`` multiple with +inf sentinels
    (the reference's padding; the kernel itself does not tile by it) and
    returns ``(m_star, w_star, b_pos, sel_pos)`` in client order.
    """
    C, K = rho.shape
    dtype = rho.dtype
    if top_m < 1:
        raise ValueError(f"top_m={top_m} must be >= 1")
    K_pad = -(-K // block_k) * block_k
    if K_pad >= 1 << 24:
        raise ValueError(
            f"K={K} (padded {K_pad}) exceeds the f32-exact index range "
            f"(2^24) of the tiled kernel's on-chip client indices"
        )
    work = torch.where(
        rho > _RHO_ZERO_TOL, rho.to(torch.float32), torch.inf
    )
    work = torch.nn.functional.pad(work, (0, K_pad - K), value=torch.inf).contiguous()
    scal = _scal(n0, delta, v_eta, radio, rho)
    b, wm = ocean_p_topm(
        scal, work, K=K, top_m=top_m, outer=outer_iters, inner=inner_iters
    )
    b_pos = b[:, :K].to(dtype)
    m_star = torch.round(wm[:, 1]).to(torch.int32)
    return m_star, wm[:, 0].to(dtype), b_pos, b_pos > 0
