"""K4 — flash attention (prefill) on the card, and its plain version.

``flash_attention`` replaces ``repro/kernels/flash_attention.py::_flash_kernel``
(:32, ``pallas_call`` at :126) together with its wrapper
``repro/kernels/ops.py::flash_attention``.  The CUDA source is
``csrc/flash_attention.cu``, whose head states what bounds the kernel on
the H100 and what its design does about it.

* ``flash_attention`` (the wrapper): checks its inputs, launches a
  kernel for CUDA tensors (counting the launch in its ``launches``
  attribute, raising on any CUDA error) and runs the plain version for
  CPU tensors; there is no fallback from one to the other.  On the card
  it picks the kernel by dtype: bfloat16 goes to the ``wgmma`` kernel
  (``flash_attention_launch``: TMA rings and tensor cores, bound by the
  tensor cores' 989 TFLOP/s), float32 to the FFMA kernel
  (``flash_attention_f32_launch``: shared-memory tiles, float32
  throughout as the TPU kernel computes float32 inputs, bound by the
  FP32 pipes' 67 TFLOP/s; TF32 tensor cores would miss the float32
  tolerance).  Both take head_dim in ``HEAD_DIMS``; any other dtype or
  head_dim raises.
* ``flash_attention_plain``: the JAX package's oracle
  ``models/attention.py::mha_reference`` on the same arguments, in query
  chunks so that the (H, S, S) float32 logits never exist whole.
* ``mha_reference``: that oracle itself, with query/key offsets and a
  valid length (``kernels/decode_attention.py`` builds its plain version
  on it).

Layout is the JAX package's: q (B, S, H, Dh), k and v (B, S, KV, Dh),
query head h reading kv head h // (H // KV).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
# The card's kernel for each dtype (csrc/flash_attention.cu).
_LAUNCH = {torch.bfloat16: "flash_attention_launch", torch.float32: "flash_attention_f32_launch"}
# Query rows per chunk of the plain version: at most ~2^26 float32 logits.
_PLAIN_LOGITS = 1 << 26


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_offset: Union[int, torch.Tensor] = 0,
    kv_valid_len: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Naive O(S^2) GQA attention — the oracle for kernels and tests.

    q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh).  Positions of query i are
    ``q_offset + i`` and of key j ``kv_offset + j`` for masking purposes.
    Logits and both products accumulate in float32 from the inputs'
    values; the probabilities are rounded to v's dtype before the second
    product, and fully masked rows give 0.
    """
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qr = q.reshape(b, sq, kvh, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), k.float()) * hd ** -0.5
    if logit_cap is not None:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = kv_offset + torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    if kv_valid_len is not None:
        mask &= (kpos < kv_valid_len)[None, :]
    logits = logits.masked_fill(~mask, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)  # fully-masked rows
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=True, window=None, logit_cap=None):
    """Plain PyTorch K4: ``mha_reference`` over chunks of query rows."""
    b, s, h, _ = q.shape
    chunk = max(1, _PLAIN_LOGITS // max(1, b * h * k.shape[1]))
    if chunk >= s:
        return mha_reference(q, k, v, causal=causal, window=window, logit_cap=logit_cap)
    return torch.cat(
        [
            mha_reference(
                q[:, i : i + chunk], k, v, causal=causal, window=window,
                logit_cap=logit_cap, q_offset=i,
            )
            for i in range(0, s, chunk)
        ],
        dim=1,
    )


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"q must be (B, S, H, Dh) and k, v one (B, S, KV, Dh) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must share a dtype; got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """K4: (B, S, H, Dh) x (B, S, KV, Dh) -> (B, S, H, Dh) in q's dtype.

    Any S (the ragged last tile is masked), ``causal``, a sliding
    ``window`` (query i sees keys j with i - j < window) and a tanh logit
    soft-cap ``logit_cap``.
    """
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1 or None")
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap={logit_cap} must be > 0 or None")
    if _build.launch_target(q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, logit_cap=logit_cap)
    b, s, h, d = q.shape
    if q.dtype not in _LAUNCH:
        raise ValueError(f"the K4 kernels take bfloat16 or float32 on the card; got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the K4 kernels take head_dim in {HEAD_DIMS}; got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _build.load("flash_attention")
    fn = getattr(lib, _LAUNCH[q.dtype])
    fn.restype = ctypes.c_int
    err = fn(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        ctypes.c_int(b), ctypes.c_int(s), ctypes.c_int(h), ctypes.c_int(k.shape[2]),
        ctypes.c_int(d), ctypes.c_int(int(bool(causal))),
        ctypes.c_int(0 if window is None else int(window)),
        ctypes.c_float(0.0 if logit_cap is None else float(logit_cap)),
        ctypes.c_float(d ** -0.5), _build.stream(),
    )
    _build.check(err, lib, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
