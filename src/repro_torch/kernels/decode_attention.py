"""K5 — flash decoding on the card, and its plain version.

``decode_attention`` replaces ``repro/kernels/decode_attention.py::_decode_kernel``
(:27, ``pallas_call`` at :122) together with its wrapper
``repro/kernels/ops.py::decode_attention``.  The CUDA source is
``csrc/decode_attention.cu``, whose head states what bounds the kernel on
the H100 and what its design does about it.

* ``decode_attention`` (the wrapper): checks its inputs, launches the
  split-K kernel and its merge for CUDA tensors (one count in its
  ``launches`` attribute per call, raising on any CUDA error) and runs
  the plain version for CPU tensors; there is no fallback from one to
  the other.
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
    ``valid_len`` an int or a one-element int tensor (on the card the
    kernel reads it from device memory).  Returns (B, H, Dh) in q's dtype.
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
    if isinstance(valid_len, torch.Tensor):
        if valid_len.numel() != 1 or valid_len.device != q.device:
            raise ValueError("valid_len must be one element on q's device")
        vl = valid_len.reshape(1).to(torch.int32)
    else:
        vl = torch.tensor([int(valid_len)], dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _build.load("decode_attention")
    per_split = lib.decode_attention_keys_per_split()
    n_split = max(1, -(-s // per_split))
    part = torch.empty(
        (b, kvh, n_split, h // kvh, d + 2), dtype=torch.float32, device=q.device
    )
    fn = lib.decode_attention_launch
    fn.restype = ctypes.c_int
    err = fn(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache), _build.ptr(vl),
        _build.ptr(part), _build.ptr(out), ctypes.c_int(b), ctypes.c_int(s),
        ctypes.c_int(h), ctypes.c_int(kvh), ctypes.c_int(d),
        ctypes.c_int(int(q.dtype == torch.bfloat16)),
        ctypes.c_float(0.0 if logit_cap is None else float(logit_cap)),
        ctypes.c_float(d ** -0.5), _build.stream(),
    )
    _build.check(err, lib, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
