"""K6 — the Mamba selective scan (prefill) on the card, and its plain version.

``mamba_scan`` replaces ``repro/kernels/mamba_scan.py::_mamba_kernel``
(:27, ``pallas_call`` at :71) together with its wrappers ``mamba_scan``
(:54) and ``repro/kernels/ops.py::mamba_scan`` (:81).  The CUDA source is
``csrc/mamba_scan.cu``, whose head states what bounds the kernel on the
H100 and what its design does about it.

From h_0 = 0:  h_t = dA_t * h_{t-1} + dBu_t;  y[b, t, di] = <h_t[di, :], C_t>.

* ``mamba_scan`` (the wrapper): checks its inputs, launches the kernel
  for CUDA tensors (counting the launch in its ``launches`` attribute,
  raising on any CUDA error) and runs the plain version for CPU tensors;
  there is no fallback from one to the other.  On the card it takes
  float32 and d_state in {4, 8, 16, 32}; anything else raises.
* ``mamba_scan_plain``: the sequential scan of the JAX package's oracle
  ``kernels/ref.py::mamba_scan_ref`` in PyTorch.
* ``selective_recurrence``: the same scan from a given state, returning
  the final state too (the decode path's step, ``models/mamba.py``).

Layout is the JAX package's: dA, dBu (B, T, Di, Ds), C (B, T, Ds); y is
(B, T, Di) float32.  Like the JAX wrapper the kernel starts from the zero
state and returns y only; unlike the TPU kernel it takes any T and Di.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

STATE_SIZES = (4, 8, 16, 32)


def selective_recurrence(
    da: torch.Tensor, dbu: torch.Tensor, c: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential selective scan from state ``h0`` (B, Di, Ds); returns
    (y (B, T, Di), h_final), both float32."""
    b, t, di, _ = da.shape
    h = h0.float()
    y = torch.empty((b, t, di), dtype=torch.float32, device=da.device)
    for i in range(t):
        h = da[:, i].float() * h + dbu[:, i].float()
        y[:, i] = torch.einsum("bds,bs->bd", h, c[:, i].float())
    return y, h


def mamba_scan_plain(da, dbu, c) -> torch.Tensor:
    """Plain PyTorch K6: ``ref.mamba_scan_ref``'s scan from h = 0."""
    b, _, di, ds = da.shape
    h0 = torch.zeros((b, di, ds), dtype=torch.float32, device=da.device)
    return selective_recurrence(da, dbu, c, h0)[0]


def _check(da, dbu, c):
    if da.dim() != 4 or da.shape != dbu.shape:
        raise ValueError(
            f"dA and dBu must share one (B, T, Di, Ds) shape; got {tuple(da.shape)}, "
            f"{tuple(dbu.shape)}"
        )
    b, t, _, ds = da.shape
    if tuple(c.shape) != (b, t, ds):
        raise ValueError(f"C must be (B, T, Ds) = {(b, t, ds)}; got {tuple(c.shape)}")


def mamba_scan(da: torch.Tensor, dbu: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """K6: selective scan of (B, T, Di, Ds) dA, dBu and (B, T, Ds) C from
    the zero state -> y (B, T, Di) float32.  Any T and Di."""
    _check(da, dbu, c)
    if _build.launch_target(da, dbu, c) == "cpu":
        return mamba_scan_plain(da, dbu, c)
    b, t, di, ds = da.shape
    for name, x in (("dA", da), ("dBu", dbu), ("C", c)):
        if x.dtype != torch.float32:
            raise ValueError(f"the K6 kernel takes float32 on the card; {name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ds not in STATE_SIZES:
        raise ValueError(f"the K6 kernel takes d_state in {STATE_SIZES}; got {ds}")
    y = torch.empty((b, t, di), dtype=torch.float32, device=da.device)
    if y.numel() == 0:
        return y
    lib = _build.load("mamba_scan")
    fn = lib.mamba_scan_launch
    fn.restype = ctypes.c_int
    err = fn(
        _build.ptr(da), _build.ptr(dbu), _build.ptr(c), _build.ptr(y),
        ctypes.c_int(b), ctypes.c_int(t), ctypes.c_int(di), ctypes.c_int(ds), _build.stream(),
    )
    _build.check(err, lib, "mamba_scan")
    mamba_scan.launches += 1
    return y


mamba_scan.launches = 0
