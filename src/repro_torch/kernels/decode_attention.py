"""K5 — flash decoding on the card, and its plain version.

``decode_attention`` replaces ``repro/kernels/decode_attention.py::_decode_kernel``
(:27, ``pallas_call`` at :122) together with its wrapper
``repro/kernels/ops.py::decode_attention``.  The CUDA source is
``csrc/decode_attention.cu``, whose head states what bounds the kernel on
the H100 and what its design does about it.

* ``decode_attention`` (the wrapper): checks its inputs, launches the
  split-K kernel, which also merges the splits, for CUDA tensors (one
  count in its ``launches`` attribute per call, raising on any CUDA
  error) and runs the plain version for CPU tensors; there is no
  fallback from one to the other.  The library's functions are looked up
  and typed once.
* ``decode_attention_plain``: the JAX package's oracle
  ``kernels/ref.py::decode_attention_ref`` — ``mha_reference`` of one
  query row against the cache, slots at or past ``valid_len`` masked.

As in the JAX package, no model calls this entry point: the decode step
(``models/attention.py::attention_decode``) computes its ring-cache
attention in plain PyTorch, with ``decode_attention_plain`` at
``valid_len = min(pos + 1, C)`` (the valid slots of a ring of C slots are
that prefix).  On every layer's cache it therefore equals
``decode_attention`` with that valid length.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import mha_reference

HEAD_DIMS = (32, 64, 128, 256)
GROUPS = (1, 2, 4, 8)


def decode_attention_plain(q, k_cache, v_cache, valid_len, *, logit_cap=None):
    """Plain PyTorch K5: (B, H, Dh) queries against (B, S, KV, Dh) caches."""
    out = mha_reference(
        q[:, None], k_cache, v_cache, causal=False, logit_cap=logit_cap,
        kv_valid_len=valid_len,
    )
    return out[:, 0]


# valid_len as the kernel takes it: kind 0 = a value, 1 = one int32 and
# 2 = one int64 on the card.
_VALID_KIND = {torch.int32: 1, torch.int64: 2}
_LAUNCH: dict = {}
# The kernel's arrival counters, one zeroed int32 per (batch row, kv head),
# kept per (device, stream): the block that merges a pair resets its
# counter, so calls in order on one stream share one set.
_ARRIVALS: dict = {}


def _valid_arg(valid_len, device, s):
    """``(kind, value, tensor)`` of ``valid_len`` for the launch: a one-element
    int32 or int64 tensor on q's device is read by the kernel where it lies
    (any other integer dtype is cast to int32 first; the caller holds the
    returned tensor until the launch is queued); an int is passed by value,
    clamped to [0, S], with no tensor."""
    if isinstance(valid_len, torch.Tensor):
        if valid_len.numel() != 1 or valid_len.device != device:
            raise ValueError("valid_len must be one element on q's device")
        if valid_len.dtype.is_floating_point or valid_len.dtype.is_complex:
            raise ValueError(f"valid_len must be an integer tensor; got {valid_len.dtype}")
        vl = valid_len.reshape(1)
        if vl.dtype not in _VALID_KIND:
            vl = vl.to(torch.int32)
        return _VALID_KIND[vl.dtype], 0, vl
    return 0, min(max(int(valid_len), 0), s), None


def _arrivals(device, stream, n):
    key = (device, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _ARRIVALS[key] = buf
    return buf


def _launchers():
    """The library's launch and split-length functions, typed once."""
    if not _LAUNCH:
        lib = _build.load("decode_attention")
        launch = lib.decode_attention_launch
        launch.restype = ctypes.c_int
        launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        split = lib.decode_attention_keys_per_split
        split.restype = ctypes.c_int
        split.argtypes = [ctypes.c_int] * 6
        _LAUNCH.update(lib=lib, launch=launch, split=split)
    return _LAUNCH


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: Union[int, torch.Tensor],
    *,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """K5: one query token per batch row; slots >= ``valid_len`` masked.

    ``q`` (B, H, Dh), caches (B, S, KV, Dh), all float32 or all bfloat16;
    ``valid_len`` an int or a one-element integer tensor (on the card the
    kernel reads an int32 or int64 one from device memory, with no cast
    and no copy to the host).  Returns (B, H, Dh) in q's dtype.
    """
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"q must be (B, H, Dh) and the caches one (B, S, KV, Dh) shape; got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    b, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % kvh:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q {tuple(q.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError("q and the caches must share a dtype")
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap={logit_cap} must be > 0 or None")
    if _build.launch_target(q, k_cache, v_cache) == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, valid_len, logit_cap=logit_cap)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the K5 kernel takes float32 or bfloat16; got {q.dtype}")
    if d not in HEAD_DIMS or h // kvh not in GROUPS:
        raise ValueError(
            f"the K5 kernel takes head_dim in {HEAD_DIMS} and H/KV in {GROUPS}; "
            f"got {d} and {h // kvh}"
        )
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    kind, value, vl = _valid_arg(valid_len, q.device, s)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fns = _launchers()
    is_bf16 = int(q.dtype == torch.bfloat16)
    per_split = fns["split"](b, s, h, kvh, d, is_bf16)
    if per_split <= 0:
        raise RuntimeError(f"decode_attention: no split length for this shape ({per_split})")
    n_split = max(1, -(-s // per_split))
    part = torch.empty(
        (b, kvh, n_split, h // kvh, d + 2), dtype=torch.float32, device=q.device
    )
    stream = torch.cuda.current_stream().cuda_stream
    arrivals = _arrivals(q.device, stream, b * kvh)
    err = fns["launch"](
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if vl is None else vl.data_ptr(), kind, value,
        part.data_ptr(), arrivals.data_ptr(), out.data_ptr(), b, s, h, kvh, d, is_bf16,
        0.0 if logit_cap is None else float(logit_cap), d ** -0.5, stream,
    )
    _build.check(err, fns["lib"], "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
