"""Shared building blocks: rmsnorm / layernorm, gated MLP, embeddings, RoPE, soft-cap.

The port's ``repro.models.layers``.  Parameters live in small
``nn.Module``s whose attribute names are the JAX package's dictionary
keys (``scale``/``bias``; ``wi``/``wg``/``wo``), in the JAX layouts, so
that ``repro_torch.convert`` carries weights across by name.  The modules
allocate their tensors uninitialised on the given device;
``models.transformer.DecoderModel.init`` fills them from a seed by each
module's ``init_std`` / ``init_rule`` (rmsnorm scales start at zero,
layernorm scales at one).

Numerics follow the reference: matrix products accumulate in float32 and
are cast back to the activation dtype (what a bfloat16 ``torch.matmul``
does on the card), norm statistics accumulate in float32, and RoPE runs
in float32 on the cast values.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


InitRule = Callable[[torch.Tensor, torch.Generator], object]


class Initialised(nn.Module):
    """A module whose parameters ``DecoderModel.init`` draws from a seed.

    ``init_std`` maps a parameter's name to the standard deviation of an
    N(0, std^2) draw; ``init_rule`` maps a name to a function
    ``(tensor, generator)`` that fills the tensor in place (constants,
    uniform draws).  Parameters that neither names start at zero.
    """

    init_std: Dict[str, float] = {}
    init_rule: Dict[str, InitRule] = {}


def fill(value: float) -> InitRule:
    return lambda t, gen: t.fill_(value)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with float32 accumulation, cast to x.dtype."""
    return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
class Norm(Initialised):
    """float32 norm parameters: rmsnorm's gemma-style ``1 + scale``
    (``scale`` starts at zero), or layernorm's ``scale`` (starts at one)
    and ``bias`` (starts at zero)."""

    def __init__(self, d: int, kind: str = "rmsnorm", device=None):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm kind {kind!r}")
        one = 1.0 if kind == "layernorm" else 0.0
        self.scale = nn.Parameter(
            torch.full((d,), one, dtype=torch.float32, device=device), requires_grad=False
        )
        if kind == "layernorm":
            self.bias = nn.Parameter(
                torch.zeros(d, dtype=torch.float32, device=device), requires_grad=False
            )
            self.init_rule = {"scale": fill(1.0)}


def init_norm(d: int, kind: str = "rmsnorm", device=None) -> Norm:
    return Norm(d, kind, device)


def apply_norm(p: Norm, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    """Statistics in float32, as in the reference.  rmsnorm casts
    ``inv * (1 + scale)`` to x's dtype before it multiplies x; layernorm
    normalises the float32 values, ``(x - mean) * inv * scale + bias``
    (variance clipped at 0), and casts the result to x's dtype."""
    d = x.shape[-1]
    if kind == "rmsnorm":
        ms = x.float().square().sum(-1) / d
        inv = torch.rsqrt(ms + eps)[..., None]
        scale = 1.0 + p.scale.float()
        return x * (inv * scale).to(x.dtype)
    if kind != "layernorm":
        raise ValueError(f"unknown norm kind {kind!r}")
    xf = x.float()
    mu = xf.sum(-1, keepdim=True) / d
    ms = xf.square().sum(-1, keepdim=True) / d
    inv = torch.rsqrt(torch.clamp(ms - mu.square(), min=0.0) + eps)
    return ((xf - mu) * inv * p.scale + p.bias).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
class MLP(Initialised):
    def __init__(self, d_model: int, d_ff: int, gated: bool, dtype, device=None):
        super().__init__()
        self.wi = empty_param((d_model, d_ff), dtype, device)
        self.wo = empty_param((d_ff, d_model), dtype, device)
        if gated:
            self.wg = empty_param((d_model, d_ff), dtype, device)
        else:
            self.register_parameter("wg", None)
        self.init_std = {"wi": d_model ** -0.5, "wg": d_model ** -0.5, "wo": d_ff ** -0.5}


def apply_mlp(p: MLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = dense(x, p.wi)
    if p.wg is not None:
        h = ACTS[act](dense(x, p.wg)) * h
    else:
        h = ACTS[act](h)
    return dense(h, p.wo)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------
EMBED_STD = 0.02


def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool = False) -> torch.Tensor:
    x = F.embedding(tokens, table)
    if scale:  # gemma-style sqrt(d) scaling, computed in the table's dtype
        x = x * torch.tensor(table.shape[-1], dtype=x.dtype, device=x.device).sqrt()
    return x


_UNEMBED_ROWS = 32768


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Float32 logits x @ table.T; table is (V, D).

    A low-precision table is upcast 32768 vocabulary rows at a time, so
    that the logits carry float32 sums without a float32 copy of the table.
    """
    xf = x.float()
    if table.dtype == torch.float32:
        return torch.matmul(xf, table.T)
    return torch.cat(
        [torch.matmul(xf, t.float().T) for t in table.split(_UNEMBED_ROWS)], dim=-1
    )


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  Rotate-half."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs      # (..., S, Dh/2)
    angles = angles[..., None, :]                                # (..., S, 1, Dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
