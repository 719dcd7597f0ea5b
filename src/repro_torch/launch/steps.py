"""Step builders of the port: ``prefill_step`` and ``serve_step``.

The port's ``repro.launch.steps``.  The model holds its parameters (an
``nn.Module``), so the steps take the batch (and the cache) only.  Both
run without autograd.  ``make_train_step`` (the federated train step) is
not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig


def _text_only(cfg: ModelConfig) -> None:
    if cfg.arch_type in ("audio", "vlm"):
        raise NotImplementedError(f"{cfg.arch_type} front ends are not ported yet")


def make_train_step(model, cfg: ModelConfig, optimizer) -> Callable:
    raise NotImplementedError("the federated train step is not ported yet")


def make_prefill_step(model, cfg: ModelConfig) -> Callable:
    _text_only(cfg)

    @torch.no_grad()
    def prefill_step(batch: Dict[str, Any]) -> torch.Tensor:
        hidden, _ = model(batch["tokens"])
        # last-position logits: what a serving stack samples from
        return model.logits(hidden[:, -1:])

    return prefill_step


def make_serve_step(model, cfg: ModelConfig) -> Callable:
    _text_only(cfg)

    @torch.no_grad()
    def serve_step(cache, token, pos):
        return model.decode_step(cache, token, pos)

    return serve_step
