"""Architecture configs of the port and their smoke variants.

The port's copy of ``repro.configs``: ``ARCH_CONFIGS`` / ``get_config``
hold the configurations whose every layer the port runs (the dense
decoders, rwkv6 and jamba); ``smoke_variant`` gives what
``repro.configs.shapes.smoke_variant`` gives.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    command_r_35b,
    gemma2_27b,
    gemma3_1b,
    granite_20b,
    jamba_1_5_large_398b,
    rwkv6_1_6b,
)
from repro_torch.configs.base import ModelConfig

_MODULES = (
    rwkv6_1_6b, granite_20b, command_r_35b, jamba_1_5_large_398b, gemma2_27b, gemma3_1b,
)

ARCH_CONFIGS = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCH_CONFIGS[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(ARCH_CONFIGS)}"
        ) from None


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests.

    2 superblocks' worth of layers (preserving the pattern), d_model <= 256,
    <= 4 experts, tiny vocab.
    """
    bl = cfg.block_len
    layers = min(2 * bl, max(cfg.num_layers, 2)) if bl > 1 else 2
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, n_heads)
    # keep GQA ratio valid
    while n_heads % n_kv:
        n_kv -= 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=128,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=32 if cfg.ssm_kind != "rwkv6" else None,
        d_ff=256,
        vocab=256,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        source_len=16 if cfg.encoder_layers else cfg.source_len,
        num_patches=8 if cfg.num_patches else 0,
        frontend_dim=64 if cfg.num_patches else None,
        sliding_window=min(cfg.sliding_window, 16),
        max_seq_len=128,
        expand=2,
        d_state=8,
        rwkv_decay_lora=16,
        dtype="float32",
    )


__all__ = ["ARCH_CONFIGS", "ModelConfig", "get_config", "smoke_variant"]
