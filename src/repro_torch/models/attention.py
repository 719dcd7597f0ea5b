"""Grouped-query attention: the prefill forward through K4 and the cached decode.

The port's ``repro.models.attention``:

  * GQA (n_kv_heads <= n_heads), MQA (n_kv_heads == 1),
  * causal and sliding-window ("local") masking,
  * gemma2-style attention logit soft-capping,
  * optional qk-norm (gemma3).

``attention_forward`` computes its attention with ``kernels.flash_attention``
(K4), which launches the Hopper kernel for CUDA tensors and runs the
plain version for CPU tensors; the JAX package's global backend switch
(``models/backend.py``) has no counterpart, since the tensor's device
picks the path.  ``plain=True`` runs the plain version on any device,
for checks that hold the kernel path against it.

Decode attends one query to a KV cache; local layers keep a ring buffer of
``min(sliding_window, max_len)`` slots.  The port writes the new key and
value into the cache in place (the reference returns a new cache);
``attention_decode`` still returns the cache, so callers read alike.
Like the reference, decode computes its attention in plain PyTorch, with
K5's plain version (``kernels.decode_attention.decode_attention_plain``,
valid length ``min(pos + 1, C)``); K5 itself is an entry point of its own.

``encoder_attention`` and ``cross_attention`` (whisper) are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.models.layers import (
    Initialised,
    apply_norm,
    apply_rope,
    empty_param,
    init_norm,
)


class Attention(Initialised):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = empty_param((d, h, hd), dtype, device)
        self.wk = empty_param((d, kv, hd), dtype, device)
        self.wv = empty_param((d, kv, hd), dtype, device)
        self.wo = empty_param((h, hd, d), dtype, device)
        if cfg.use_qk_norm:
            self.q_norm = init_norm(hd, "rmsnorm", device)
            self.k_norm = init_norm(hd, "rmsnorm", device)
        s = d ** -0.5
        self.init_std = {"wq": s, "wk": s, "wv": s, "wo": (h * hd) ** -0.5}


def init_attention(cfg: ModelConfig, dtype, device=None) -> Attention:
    return Attention(cfg, dtype, device)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, N, Dh) -> (B, S, N, Dh), float32 accumulation."""
    d, n, hd = w.shape
    return torch.matmul(x, w.reshape(d, n * hd)).view(*x.shape[:-1], n, hd)


def _project_qkv(p: Attention, x: torch.Tensor):
    q, k, v = _heads(x, p.wq), _heads(x, p.wk), _heads(x, p.wv)
    if hasattr(p, "q_norm"):
        q = apply_norm(p.q_norm, q)
        k = apply_norm(p.k_norm, k)
    return q, k, v


def _out_proj(p: Attention, out: torch.Tensor, dtype) -> torch.Tensor:
    b, s, h, hd = out.shape
    return torch.matmul(out.to(dtype).reshape(b, s, h * hd), p.wo.reshape(h * hd, -1))


# ---------------------------------------------------------------------------
# prefill forward
# ---------------------------------------------------------------------------
def attention_forward(
    p: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str = "global",
    positions: Optional[torch.Tensor] = None,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """Causal self-attention over the full sequence (prefill)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x)
    if cfg.use_rope:
        pos = torch.arange(s, device=x.device) if positions is None else positions
        pos = torch.broadcast_to(pos, (b, s))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    window = cfg.sliding_window if kind == "local" else None
    attend = flash_attention_plain if plain else flash_attention
    out = attend(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True, window=window,
        logit_cap=cfg.attn_logit_softcap,
    )
    return _out_proj(p, out, x.dtype)


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor  # (B, C, KV, Dh) — C = min(max_len, window) for local layers
    v: torch.Tensor  # (B, C, KV, Dh)


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, kind: str, dtype, device=None
) -> KVCache:
    c = max_len if kind != "local" else min(cfg.sliding_window, max_len)
    shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def attention_decode(
    p: Attention,
    x: torch.Tensor,     # (B, 1, D) — the new token's hidden state
    cache: KVCache,
    pos: int,            # index of the new token
    cfg: ModelConfig,
    kind: str = "global",
) -> Tuple[torch.Tensor, KVCache]:
    """One token's attention against its layer's cache."""
    b = x.shape[0]
    pos = int(pos)
    q, k_new, v_new = _project_qkv(p, x)
    if cfg.use_rope:
        posb = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
        q = apply_rope(q, posb, cfg.rope_theta)
        k_new = apply_rope(k_new, posb, cfg.rope_theta)

    c = cache.k.shape[1]
    slot = pos % c  # ring write; global caches have C = max_len so slot == pos
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)

    # Ring semantics: slot s holds absolute position pos - ((pos - s) mod C)
    # and is valid iff that is >= 0, which makes the valid slots the prefix
    # s < min(pos + 1, C); the sliding-window constraint holds by itself
    # for local caches (C <= window).
    out = decode_attention_plain(
        q[:, 0], cache.k, cache.v, min(pos + 1, c), logit_cap=cfg.attn_logit_softcap
    )
    return _out_proj(p, out[:, None], x.dtype), cache


__all__ = [
    "Attention",
    "KVCache",
    "attention_decode",
    "attention_forward",
    "init_attention",
    "init_kv_cache",
]
