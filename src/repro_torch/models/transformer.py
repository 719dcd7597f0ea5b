"""The decoder LM of the port: attention, Mamba and RWKV6 layers, dense and MoE FFNs.

The port's ``repro.models.transformer.DecoderModel``.  The reference stacks
the parameters of each position of the repeating layer pattern and
``lax.scan``s over superblocks to keep its HLO small; PyTorch runs
eagerly, so the port keeps one ``nn.Module`` per layer in a ``ModuleList``
and walks it (``convert.decoder_params_from_reference`` unstacks the
reference's parameters into it).

Layer kinds: ``global`` / ``local`` attention (prefill through K4),
``mamba`` (prefill through K6) and ``rwkv`` (prefill through K7, which
owns its channel-mix FFN); FFN kinds ``dense`` and ``moe``.  The prefill
forward starts every recurrent layer from the zero state and keeps no
final state, as the reference's does; decode carries one state per
layer: a ``KVCache``, a ``MambaState`` or an ``RwkvState``.

The reference's sharding constraints (``sharding/constraints.py``) have no
counterpart: they are the identity without a device mesh, and the port
runs on one card.  The VLM patch front end and the audio
encoder-decoder are not ported yet: building a model that has them
raises ``NotImplementedError``.
"""
from __future__ import annotations

import zlib
from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
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


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# per-layer init / apply / state
# ---------------------------------------------------------------------------
class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, lk: str, fk: str, dtype, device=None):
        super().__init__()
        self.kind, self.ffn = lk, fk
        self.ln1 = init_norm(cfg.d_model, cfg.norm, device)
        if lk == "rwkv":
            self.rwkv = rwkv_mod.init_rwkv(cfg, dtype, device)
            self.ln2 = init_norm(cfg.d_model, cfg.norm, device)
            return  # rwkv owns its channel-mix FFN
        if lk in ("global", "local"):
            self.attn = attn.init_attention(cfg, dtype, device)
        elif lk == "mamba":
            self.mamba = mamba_mod.init_mamba(cfg, dtype, device)
        else:
            raise ValueError(f"unknown layer kind {lk!r}")
        self.ln2 = init_norm(cfg.d_model, cfg.norm, device)
        if fk == "dense":
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype, device)
        elif fk == "moe":
            self.moe = moe_mod.init_moe(cfg, dtype, device)
        else:
            raise ValueError(f"unknown ffn kind {fk!r}")


def _init_layer_state(cfg: ModelConfig, lk: str, batch: int, max_len: int, dtype, device):
    """Decode-time KV cache or recurrent state of one layer."""
    if lk == "mamba":
        return mamba_mod.init_mamba_state(cfg, batch, dtype, device)
    if lk == "rwkv":
        return rwkv_mod.init_rwkv_state(cfg, batch, dtype, device)
    return attn.init_kv_cache(cfg, batch, max_len, lk, dtype, device)


def _apply_layer(
    p: DecoderLayer,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Any,
    pos: Optional[int],
    *,
    plain: bool = False,
):
    """Prefill (``state`` None) or one decode step; returns (x, new_state,
    aux) with aux the MoE loss (None without MoE)."""
    if p.kind == "rwkv":
        x, state = rwkv_mod.rwkv_block(p.rwkv, p.ln1, p.ln2, x, state, cfg, plain=plain)
        return x, state, None
    h = apply_norm(p.ln1, x, cfg.norm)
    if p.kind == "mamba":
        h, state = mamba_mod.mamba_mixer(p.mamba, h, state, cfg, plain=plain)
    elif state is not None:
        h, state = attn.attention_decode(p.attn, h, state, pos, cfg, p.kind)
    else:
        h = attn.attention_forward(p.attn, h, cfg, p.kind, plain=plain)
    x = x + h
    h = apply_norm(p.ln2, x, cfg.norm)
    aux = None
    if p.ffn == "moe":
        h, aux = moe_mod.apply_moe(p.moe, h, cfg)
    else:
        h = apply_mlp(p.mlp, h, cfg.act)
    return x + h, state, aux


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
        for the layers it has.  A module's ``init_rule`` fills the tensors
        it names (constants, uniform draws), its ``init_std`` draws
        N(0, std^2) for the ones it names, and every other tensor starts
        at zero (rmsnorm scales ``1 + 0``, biases, RWKV6's ``wb``).
        """
        gen = torch.Generator(device=self.device)
        for mod_name, mod in self.named_modules():
            stds = getattr(mod, "init_std", {})
            rules = getattr(mod, "init_rule", {})
            for name, p in mod.named_parameters(recurse=False):
                full = f"{mod_name}.{name}" if mod_name else name
                if name not in stds and name not in rules:
                    p.zero_()
                    continue
                gen.manual_seed(seed * 1_000_003 + zlib.crc32(full.encode()))
                if name in rules:
                    rules[name](p, gen)
                else:
                    p.normal_(0.0, stds[name], generator=gen)
        return self

    # ---- prefill forward ----------------------------------------------------
    def forward(
        self,
        tokens: torch.Tensor,
        patches: Optional[torch.Tensor] = None,
        *,
        plain: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden (B, S, D), aux_loss).  Logits via ``logits()``.

        ``plain=True`` runs the plain version of every kernel (K4, K6,
        K7) in every layer, on any device.  The auxiliary loss is the sum
        of the MoE layers' load-balance losses (0 without MoE layers).
        """
        if patches is not None:
            raise NotImplementedError("the VLM patch front end is not ported yet")
        cfg = self.cfg
        x = embed(tokens, self.embed, scale=cfg.norm == "rmsnorm")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            x, _, a = _apply_layer(layer, x, cfg, None, None, plain=plain)
            if a is not None:
                aux = aux + a
        return apply_norm(self.final_norm, x, cfg.norm), aux

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        table = self.lm_head if hasattr(self, "lm_head") else self.embed
        return softcap(unembed(hidden, table), self.cfg.final_logit_softcap)

    # ---- decode -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> List[Any]:
        """One state per layer: a KV cache for attention (local layers get
        a ring of ``min(sliding_window, max_len)`` slots), a ``MambaState``
        or an ``RwkvState`` (zeros) for the recurrent layers."""
        return [
            _init_layer_state(self.cfg, lk, batch, max_len, self.dtype, self.device)
            for lk in self.kinds
        ]

    def decode_step(
        self,
        cache: List[Any],
        token: torch.Tensor,   # (B, 1) integer
        pos: int,              # position of this token
    ) -> Tuple[torch.Tensor, List[Any]]:
        """Logits (B, 1, V) float32 of the next token and the new states
        (KV caches are updated in place; recurrent states are new tensors)."""
        cfg = self.cfg
        x = embed(token, self.embed, scale=cfg.norm == "rmsnorm")
        new_cache = []
        for layer, st in zip(self.layers, cache):
            x, st, _ = _apply_layer(layer, x, cfg, st, pos)
            new_cache.append(st)
        x = apply_norm(self.final_norm, x, cfg.norm)
        return self.logits(x), new_cache
