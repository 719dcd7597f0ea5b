"""The decoder LM of the port: dense (global/local attention, dense FFN) layers.

The port's ``repro.models.transformer.DecoderModel``.  The reference stacks
the parameters of each position of the repeating layer pattern and
``lax.scan``s over superblocks to keep its HLO small; PyTorch runs
eagerly, so the port keeps one ``nn.Module`` per layer in a ``ModuleList``
and walks it (``convert.decoder_params_from_reference`` unstacks the
reference's parameters into it).

The reference's sharding constraints (``sharding/constraints.py``) have no
counterpart: they are the identity without a device mesh, and the port
runs on one card.  Layer kinds ``mamba`` and ``rwkv``, the ``moe`` FFN,
the VLM patch front end and the audio encoder-decoder are not ported
yet: building a model that has them raises ``NotImplementedError``.
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    EMBED_STD,
    MLP,
    Initialised,
    apply_mlp,
    apply_norm,
    embed,
    empty_param,
    init_norm,
    softcap,
    unembed,
)

_NOT_PORTED = {
    "mamba": "Mamba layers (K6's path) are not ported yet",
    "rwkv": "RWKV6 layers (K7's path) are not ported yet",
    "moe": "the MoE FFN is not ported yet",
}


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# per-layer init / apply / cache
# ---------------------------------------------------------------------------
class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, lk: str, fk: str, dtype, device=None):
        super().__init__()
        for kind in (lk, fk):
            if kind in _NOT_PORTED:
                raise NotImplementedError(_NOT_PORTED[kind])
        if lk not in ("global", "local"):
            raise ValueError(f"unknown layer kind {lk!r}")
        if fk != "dense":
            raise ValueError(f"unknown ffn kind {fk!r}")
        self.kind = lk
        self.ln1 = init_norm(cfg.d_model, cfg.norm, device)
        self.attn = attn.init_attention(cfg, dtype, device)
        self.ln2 = init_norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype, device)


def _apply_layer(
    p: DecoderLayer,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[attn.KVCache],
    pos: Optional[int],
    *,
    plain: bool = False,
):
    """Prefill (``state`` None) or one decode step; returns (x, new_state)."""
    h = apply_norm(p.ln1, x, cfg.norm)
    if state is not None:
        h, state = attn.attention_decode(p.attn, h, state, pos, cfg, p.kind)
    else:
        h = attn.attention_forward(p.attn, h, cfg, p.kind, plain=plain)
    x = x + h
    h = apply_mlp(p.mlp, apply_norm(p.ln2, x, cfg.norm), cfg.act)
    return x + h, state


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class DecoderModel(Initialised):
    """config -> parameters (allocated on ``device``), forward, decode.

    Built uninitialised on the card (``device=None``) or wherever
    ``device`` says; ``init(seed)`` draws the weights, or
    ``load_state_dict`` takes converted ones.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.arch_type == "audio" or cfg.encoder_layers:
            raise NotImplementedError("the audio encoder-decoder is not ported yet")
        if cfg.num_patches:
            raise NotImplementedError("the VLM patch front end is not ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        self.kinds = cfg.layer_kinds()
        self.fkinds = cfg.ffn_kinds()
        self.dtype = _dtype(cfg.dtype)
        self.embed = empty_param((cfg.vocab, cfg.d_model), self.dtype, dev)
        self.final_norm = init_norm(cfg.d_model, cfg.norm, dev)
        if not cfg.tie_embeddings:
            self.lm_head = empty_param((cfg.vocab, cfg.d_model), self.dtype, dev)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, lk, fk, self.dtype, dev)
            for lk, fk in zip(self.kinds, self.fkinds)
        )
        self.init_std = {"embed": EMBED_STD, "lm_head": EMBED_STD}

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---- init -------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0) -> "DecoderModel":
        """Random weights, one tensor at a time, in place on the device.

        Each tensor is drawn by a generator seeded from ``seed`` and the
        tensor's name, so a model with fewer layers gets the same weights
        for the layers it has; norms start at zero (scale ``1 + 0``).
        """
        gen = torch.Generator(device=self.device)
        for mod_name, mod in self.named_modules():
            stds = getattr(mod, "init_std", {})
            for name, p in mod.named_parameters(recurse=False):
                full = f"{mod_name}.{name}" if mod_name else name
                if name not in stds:
                    p.zero_()
                    continue
                gen.manual_seed(seed * 1_000_003 + zlib.crc32(full.encode()))
                p.normal_(0.0, stds[name], generator=gen)
        return self

    # ---- prefill forward ----------------------------------------------------
    def forward(
        self,
        tokens: torch.Tensor,
        patches: Optional[torch.Tensor] = None,
        *,
        plain_attention: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden (B, S, D), aux_loss).  Logits via ``logits()``.

        ``plain_attention=True`` runs K4's plain version in every layer,
        on any device.  The auxiliary loss is the MoE router's in the
        reference; with dense FFNs only it is 0.
        """
        if patches is not None:
            raise NotImplementedError("the VLM patch front end is not ported yet")
        cfg = self.cfg
        x = embed(tokens, self.embed, scale=cfg.norm == "rmsnorm")
        for layer in self.layers:
            x, _ = _apply_layer(layer, x, cfg, None, None, plain=plain_attention)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return apply_norm(self.final_norm, x, cfg.norm), aux

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        table = self.lm_head if hasattr(self, "lm_head") else self.embed
        return softcap(unembed(hidden, table), self.cfg.final_logit_softcap)

    # ---- decode -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> List[attn.KVCache]:
        """One KV cache per layer; local layers get a ring of
        ``min(sliding_window, max_len)`` slots."""
        return [
            attn.init_kv_cache(self.cfg, batch, max_len, lk, self.dtype, self.device)
            for lk in self.kinds
        ]

    def decode_step(
        self,
        cache: List[attn.KVCache],
        token: torch.Tensor,   # (B, 1) integer
        pos: int,              # position of this token
    ) -> Tuple[torch.Tensor, List[attn.KVCache]]:
        """Logits (B, 1, V) float32 of the next token; the caches are
        updated in place and returned."""
        cfg = self.cfg
        x = embed(token, self.embed, scale=cfg.norm == "rmsnorm")
        new_cache = []
        for layer, st in zip(self.layers, cache):
            x, st = _apply_layer(layer, x, cfg, st, pos)
            new_cache.append(st)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return self.logits(x), new_cache
