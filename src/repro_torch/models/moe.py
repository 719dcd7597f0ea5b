"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

The port's ``repro.models.moe``.  Dispatch is batch-local, as in the
reference: each batch row packs its tokens into per-expert buffers of
``capacity = int(max(1, round(S * k / E * capacity_factor)))`` slots
(Python's ``round``, halves to even), a token's k-th choice taking the
next free slot of its expert in (token, choice) order; a choice past
the capacity is dropped and its gate weight zeroed.  The top-k is taken
as ``jax.lax.top_k`` takes it: sorted, the lower expert index first on
ties; the k gates are renormalised to sum to one.  A Switch-style
load-balance auxiliary loss comes back beside the output.

``moe_route`` is the routing alone, so that callers can read which
choices were dropped.  The expert products go to ``torch.einsum``
(cuBLAS on the card), as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ACTS, Initialised, empty_param


class MoE(Initialised):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = empty_param((d, e), torch.float32, device)
        self.wi = empty_param((e, d, f), dtype, device)
        self.wo = empty_param((e, f, d), dtype, device)
        if cfg.mlp_gated:
            self.wg = empty_param((e, d, f), dtype, device)
        else:
            self.register_parameter("wg", None)
        self.init_std = {"router": d ** -0.5, "wi": d ** -0.5, "wg": d ** -0.5, "wo": f ** -0.5}


def init_moe(cfg: ModelConfig, dtype, device=None) -> MoE:
    return MoE(cfg, dtype, device)


class Routing(NamedTuple):
    gates: torch.Tensor      # (B, S, k) float32 renormalised top-k probabilities
    experts: torch.Tensor    # (B, S, k) chosen experts, best first
    keep: torch.Tensor       # (B, S * k) bool: the choice fits its expert's capacity
    slot: torch.Tensor       # (B, S * k) buffer row expert * capacity + position
    capacity: int
    aux: torch.Tensor        # scalar float32 load-balance loss


def moe_route(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax(torch.matmul(x.float(), p.router), dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = ranked.values[..., :k], ranked.indices[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # Switch load-balance aux: E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(experts, e).float().sum(2).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce / k)

    capacity = int(max(1, round(s * k / e * cfg.capacity_factor)))
    flat = experts.reshape(b, s * k)
    oh = F.one_hot(flat, e)
    pos = ((oh.cumsum(dim=1) - 1) * oh).sum(-1)      # position within its expert
    keep = pos < capacity
    slot = flat * capacity + torch.clamp(pos, max=capacity - 1)
    return Routing(gates, experts, keep, slot, capacity, aux)


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    rt = moe_route(p, x, cfg)
    rows = torch.arange(b, device=x.device)[:, None]

    src = torch.repeat_interleave(x, k, dim=1).masked_fill(~rt.keep[..., None], 0)
    buffers = x.new_zeros(b, e * rt.capacity, d).index_put_((rows, rt.slot), src, accumulate=True)
    buffers = buffers.view(b, e, rt.capacity, d)

    h = torch.einsum("becd,edf->becf", buffers, p.wi)
    if p.wg is not None:
        h = ACTS[cfg.act](torch.einsum("becd,edf->becf", buffers, p.wg)) * h
    else:
        h = ACTS[cfg.act](h)
    y = torch.einsum("becf,efd->becd", h.to(x.dtype), p.wo).to(x.dtype)

    y_tok = y.reshape(b, e * rt.capacity, d)[rows, rt.slot]       # (B, S*k, D)
    w = (rt.gates.reshape(b, s * k) * rt.keep).to(x.dtype)
    out = (y_tok * w[..., None]).reshape(b, s, k, d).sum(dim=2)
    return out, rt.aux


__all__ = ["MoE", "Routing", "apply_moe", "init_moe", "moe_route"]
