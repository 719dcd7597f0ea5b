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
import functools
from typing import Callable, NamedTuple, Optional

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
    """Plain PyTorch K1: (C, 8) scal, (C, K) sorted rho -> b (C, K), wm (C, 2).
    It sweeps ``sweep_cands``' candidates of m <= n_cands (K without it):
    the outputs of the whole axis."""
    from repro_torch.core.solvers import sweep_cands

    C, K = rho.shape
    n_cands = sweep_cands(scal[:, 0], K, n_cands)
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


class TopmShape(NamedTuple):
    """K2's launch shape: ``R`` CTAs a cell's cluster, ``nw`` warps a CTA,
    an append buffer of ``cap`` keys a CTA."""

    R: int
    nw: int
    cap: int


# The most keys a CTA appends between two merges: one merge covers a
# slice of up to this many clients (K = 10^4 over 8 CTAs is 1264).
TOPM_CAP_MAX = 4096
# Cluster sizes in order of preference where the estimates tie.  On the
# H100 at 8 cells x K = 10^4 x top_m = 128, where 16 and 8 tie (128 teams
# either way), 8 CTAs of 16 warps read 0.232 ms and 16 of 8 warps 0.270
# (chip_smoke.py, phase_k2).
TOPM_CLUSTERS = (8, 16, 4, 2)


def topm_smem_bytes(top_m: int, nw: int, cap: int) -> int:
    """Shared bytes of one K2 CTA (``csrc/ocean_p.cu::topm_smem``): the key
    list and append buffer, later each warp's two sweep rows and the argmax
    scratch; the compact row; the CTA's best (W, m) and counter."""
    region_a = max(8 * (top_m + cap), 4 * (2 * nw * top_m + 64))
    return region_a + 8 * top_m + 16


def topm_team_chain(top_m: int, teams: int) -> int:
    """The longest team's work in member steps: team g sweeps
    m = g + 1, g + 1 + teams, ..., and a candidate of m members costs each
    of its 32 lanes ceil(m / 32) of them."""
    return max(
        sum(-(-m // 32) for m in range(g + 1, top_m + 1, teams))
        for g in range(min(teams, top_m))
    )


def _topm_fit(K_pad, top_m, R, optin, max_threads):
    """(nw, cap) for clusters of R, or None where no CTA fits.

    Warps: enough that the cluster's teams give every candidate its own
    (at least 4, for the extraction's pass), at most 32 (the sweep's
    argmax scratch) and what the registers allow, then fewer while the
    sweep rows overflow shared memory.  Buffer: the slice rounded up to
    whole tiles of the block's threads, so one merge covers it, cut to
    TOPM_CAP_MAX and to what shared memory leaves, never below one tile.
    """
    nw = min(max(4, -(-top_m // R)), 32, max_threads // 32)
    while nw >= 1 and topm_smem_bytes(top_m, nw, 32 * nw) > optin:
        nw -= 1
    if nw < 1:
        return None
    nt = 32 * nw
    slice_ = -(-K_pad // R)
    want = min(-(-slice_ // nt) * nt, TOPM_CAP_MAX)
    room = (optin - 16) // 8 - 2 * top_m  # cap where the key region sets the size
    return nw, max(nt, min(want, room))


def topm_launch_shape(
    C: int,
    K_pad: int,
    top_m: int,
    *,
    optin: int,
    max_threads: int,
    clusters_of: Callable[[int, int, int], int],
    cluster: Optional[int] = None,
) -> TopmShape:
    """Choose K2's launch shape from the cells, the row and the card.

    For each cluster size R (``cluster`` alone if given, else those of
    TOPM_CLUSTERS) that ``clusters_of(R, nw, cap)`` -- the clusters the
    card holds at once, from the occupancy query -- can place, the
    estimated time is the waves of clusters times the longest team's
    chain; the least wins, ties to the earlier R of TOPM_CLUSTERS.
    Raises ValueError where no shape fits the card.
    """
    if cluster is not None and cluster not in (1, 2, 4, 8, 16):
        raise ValueError(f"cluster={cluster} must be a power of two in [1, 16]")
    best = None
    for R in (cluster,) if cluster is not None else TOPM_CLUSTERS:
        fit = _topm_fit(K_pad, top_m, R, optin, max_threads)
        if fit is None:
            continue
        nw, cap = fit
        active = clusters_of(R, nw, cap)
        if active < 1:
            continue
        cost = -(-max(C, 1) // active) * topm_team_chain(top_m, R * nw)
        if best is None or cost < best[0]:
            best = (cost, TopmShape(R, nw, cap))
    if best is None:
        raise ValueError(
            f"ocean_p_topm: no cluster shape fits top_m={top_m} on this card "
            f"({optin} shared bytes a block, {max_threads} threads)"
        )
    return best[1]


@functools.lru_cache(maxsize=None)
def topm_shape(C: int, K_pad: int, top_m: int, cluster: Optional[int] = None) -> TopmShape:
    """K2's launch shape on the current card (``topm_launch_shape``)."""
    from repro_torch.kernels import _build

    lib = _build.load("ocean_p")
    clusters = lib.ocean_p_topm_clusters
    clusters.restype = ctypes.c_int
    return topm_launch_shape(
        C, K_pad, top_m,
        optin=lib.smem_optin_bytes(),
        max_threads=lib.ocean_p_topm_max_threads(),
        clusters_of=lambda R, nw, cap: clusters(
            ctypes.c_int(top_m), ctypes.c_int(R), ctypes.c_int(nw), ctypes.c_int(cap)
        ),
        cluster=cluster,
    )


def ocean_p_topm(scal, rho, *, K, top_m, outer=OUTER_ITERS, inner=INNER_ITERS, cluster=None):
    """K2: the sort-free P3 solve on client-order rho.

    ``rho`` (C, K_pad) holds rho where rho > 1e-30 and +inf elsewhere
    (S0 clients and padding).  Returns ``b`` (C, K_pad) in client order
    and ``wm`` (C, 2) = [W*, m*].  ``cluster`` fixes the CTAs a cell's
    cluster on the card (a power of two up to 16; default: chosen by
    ``topm_launch_shape``).
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
    fn = lib.ocean_p_topm_launch
    fn.restype = ctypes.c_int
    b = torch.empty_like(rho)
    wm = torch.empty((C, 2), dtype=torch.float32, device=rho.device)
    if C == 0:
        return b, wm
    shape = topm_shape(C, K_pad, top_m, cluster)
    err = fn(
        _ptr(scal), _ptr(rho), _ptr(b), _ptr(wm), ctypes.c_int(C),
        ctypes.c_int(K), ctypes.c_int(K_pad), ctypes.c_int(top_m),
        ctypes.c_int(shape.R), ctypes.c_int(shape.nw), ctypes.c_int(shape.cap),
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
    plain: bool = False,
):
    """Backend contract of ``solver="pallas_tiled"`` on client-order rho.

    Pads the client axis to a ``block_k`` multiple with +inf sentinels
    (the reference's padding; the kernel itself does not tile by it) and
    returns ``(m_star, w_star, b_pos, sel_pos)`` in client order.
    ``plain=True`` runs the plain version on any device.
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
    fn = ocean_p_topm_plain if plain else ocean_p_topm
    b, wm = fn(scal, work, K=K, top_m=top_m, outer=outer_iters, inner=inner_iters)
    b_pos = b[:, :K].to(dtype)
    m_star = torch.round(wm[:, 1]).to(torch.int32)
    return m_star, wm[:, 0].to(dtype), b_pos, b_pos > 0
