"""K7 — the RWKV6 WKV scan (prefill) on the card, and its plain version.

``wkv_scan`` replaces ``repro/kernels/rwkv6_scan.py::_wkv_kernel`` (:29,
``pallas_call`` at :82) together with its wrappers ``wkv_scan`` (:58)
and ``repro/kernels/ops.py::wkv_scan`` (:73).  The CUDA source is
``csrc/rwkv6_scan.cu``, whose head states what bounds the kernel on the
H100 and what its design does about it.

Per (batch, head), with an (N, N) float32 state S from S = 0:

    y_t = r_t (S + diag(u) k_t^T v_t);   S <- diag(w_t) S + k_t^T v_t

* ``wkv_scan`` (the wrapper): checks its inputs, launches the kernel for
  CUDA tensors (counting the launch in its ``launches`` attribute,
  raising on any CUDA error) and runs the plain version for CPU tensors;
  there is no fallback from one to the other.  On the card it takes
  float32 and N in {32, 64}; anything else raises.
* ``wkv_scan_plain``: the sequential recurrence of the JAX package's
  oracle ``kernels/ref.py::wkv_scan_ref`` in PyTorch.
* ``wkv_recurrence``: the same recurrence from a given state, returning
  the final state too (the decode path's step, ``models/rwkv.py``).

Layout is the JAX package's: r, k, v, w (B, T, H, N), w the decay
multiplier in (0, 1), u (H, N); y is (B, T, H, N) float32.  Like the JAX
wrapper the kernel starts from the zero state and returns y only; unlike
the TPU kernel it takes any T.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

HEAD_SIZES = (32, 64)


def wkv_recurrence(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV from state ``s0`` (B, H, N, N); returns (y, s_final),
    both float32."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    ub = u.float()[None, :, :, None]
    s = s0.float()
    y = torch.empty(rf.shape, dtype=torch.float32, device=rf.device)
    for t in range(rf.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], s + ub * kv)
        s = wf[:, t, :, :, None] * s + kv
    return y, s


def wkv_scan_plain(r, k, v, w, u) -> torch.Tensor:
    """Plain PyTorch K7: ``ref.wkv_scan_ref``'s recurrence from S = 0."""
    b, _, h, n = r.shape
    s0 = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    return wkv_recurrence(r, k, v, w, u, s0)[0]


def _check(r, k, v, w, u):
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(
            f"r, k, v, w must share one (B, T, H, N) shape; got {tuple(r.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}"
        )
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"u must be (H, N) = {tuple(r.shape[2:])}; got {tuple(u.shape)}")


def wkv_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """K7: WKV of (B, T, H, N) r, k, v, w and (H, N) u from the zero state
    -> y (B, T, H, N) float32.  Any T."""
    _check(r, k, v, w, u)
    if _build.launch_target(r, k, v, w, u) == "cpu":
        return wkv_scan_plain(r, k, v, w, u)
    b, t, h, n = r.shape
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if x.dtype != torch.float32:
            raise ValueError(f"the K7 kernel takes float32 on the card; {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if n not in HEAD_SIZES:
        raise ValueError(f"the K7 kernel takes head size N in {HEAD_SIZES}; got {n}")
    y = torch.empty_like(r)
    if r.numel() == 0:
        return y
    lib = _build.load("rwkv6_scan")
    fn = lib.wkv_scan_launch
    fn.restype = ctypes.c_int
    err = fn(
        _build.ptr(r), _build.ptr(k), _build.ptr(v), _build.ptr(w), _build.ptr(u),
        _build.ptr(y), ctypes.c_int(b), ctypes.c_int(t), ctypes.c_int(h), ctypes.c_int(n),
        _build.stream(),
    )
    _build.check(err, lib, "wkv_scan")
    wkv_scan.launches += 1
    return y


wkv_scan.launches = 0
