"""RWKV6 "Finch" block: attention-free token mixing with data-dependent
decay (arXiv:2404.05892).  The port's ``repro.models.rwkv``.

Time-mix (per head, head size N):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t           (state: N x N per head)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the data-dependent decay w_t = exp(-exp(w0 + lora(x_t))).
Channel-mix is the squared-ReLU token-shifted FFN.

The prefill (``state`` None: every recurrence starts from zero and the
final state is not needed, as in the reference's forward) runs the WKV
recurrence through K7 (``kernels.rwkv6_scan.wkv_scan``), which launches
the Hopper kernel for CUDA tensors and runs its plain version for CPU
tensors; ``plain=True`` runs the plain version on any device.  The
reference computes the same function with its chunked matrix form
(``_wkv_chunk_matrix``) or its sequential ``_wkv_scan``.  Decode
(``state`` given) carries an ``RwkvState`` and runs the sequential
recurrence on it in plain PyTorch, as the reference does.

Numerics follow the reference: r, k, v and the log-decay in float32, the
gate ``g`` and the output in the model dtype, ``y`` cast to the model
dtype before its layernorm ``ln_x``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import wkv_recurrence, wkv_scan, wkv_scan_plain
from repro_torch.models.layers import (
    Initialised,
    Norm,
    apply_norm,
    dense,
    empty_param,
    fill,
    init_norm,
)


class RwkvState(NamedTuple):
    wkv: torch.Tensor       # (B, H, N, N) float32 recurrent state
    shift_tm: torch.Tensor  # (B, D) last token seen by the time-mix
    shift_cm: torch.Tensor  # (B, D) last token seen by the channel-mix


class Rwkv(Initialised):
    """Time-mix and channel-mix parameters under the reference's names."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        h, n, lora = cfg.rwkv_heads, cfg.rwkv_head_size, cfg.rwkv_decay_lora
        f32 = torch.float32
        self.mu = empty_param((5, d), f32, device)   # token-shift mixes of r/k/v/w/g
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, empty_param((d, d), dtype, device))
        self.w0 = empty_param((d,), f32, device)
        self.wa = empty_param((d, lora), dtype, device)
        self.wb = empty_param((lora, d), dtype, device)  # zero at init
        self.u = empty_param((h, n), f32, device)
        self.ln_x = init_norm(d, "layernorm", device)
        self.cm_mu = empty_param((2, d), f32, device)
        self.cm_k = empty_param((d, f), dtype, device)
        self.cm_v = empty_param((f, d), dtype, device)
        self.cm_r = empty_param((d, d), dtype, device)
        s = d ** -0.5
        self.init_std = {
            "wr": s, "wk": s, "wv": s, "wg": s, "wo": s, "wa": s, "u": 0.5,
            "cm_k": s, "cm_v": f ** -0.5, "cm_r": s,
        }
        self.init_rule = {
            "mu": fill(0.5), "cm_mu": fill(0.5),
            "w0": lambda t, gen: t.uniform_(-6.0, -5.0, generator=gen),  # -6 + U(0, 1)
        }


def init_rwkv(cfg: ModelConfig, dtype, device=None) -> Rwkv:
    return Rwkv(cfg, dtype, device)


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype, device=None) -> RwkvState:
    h, n, d = cfg.rwkv_heads, cfg.rwkv_head_size, cfg.d_model
    return RwkvState(
        wkv=torch.zeros((batch, h, n, n), dtype=torch.float32, device=device),
        shift_tm=torch.zeros((batch, d), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, d), dtype=dtype, device=device),
    )


def _shifted(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """x shifted one step later in time, ``last`` (or zeros) in front."""
    first = x.new_zeros(x.shape[0], 1, x.shape[2]) if last is None else last[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix(
    p: Rwkv, x: torch.Tensor, state: Optional[RwkvState], cfg: ModelConfig, *, plain: bool = False
) -> Tuple[torch.Tensor, Optional[RwkvState]]:
    """x (B, T, D) -> (out, new state); prefill when ``state`` is None."""
    b, t, d = x.shape
    h, n = cfg.rwkv_heads, cfg.rwkv_head_size
    sx = _shifted(x, None if state is None else state.shift_tm) - x
    mu = p.mu.to(x.dtype)
    xr, xk, xv, xw, xg = (x + sx * mu[i] for i in range(5))

    r = dense(xr, p.wr).view(b, t, h, n).float()
    k = dense(xk, p.wk).view(b, t, h, n).float()
    v = dense(xv, p.wv).view(b, t, h, n).float()
    g = F.silu(dense(xg, p.wg))
    # data-dependent decay, log-domain: log w = -exp(w0 + lora) <= 0
    dd = torch.tanh(torch.matmul(xw.float(), p.wa.float()))
    w = torch.exp(-torch.exp(p.w0 + torch.matmul(dd, p.wb.float()))).view(b, t, h, n)

    if state is None:
        y = (wkv_scan_plain if plain else wkv_scan)(r, k, v, w, p.u)
        new_state = None
    else:
        y, s_fin = wkv_recurrence(r, k, v, w, p.u, state.wkv)
        new_state = RwkvState(wkv=s_fin, shift_tm=x[:, -1], shift_cm=state.shift_cm)
    y = apply_norm(p.ln_x, y.reshape(b, t, d).to(x.dtype), "layernorm")
    return dense(y * g.to(x.dtype), p.wo), new_state


def channel_mix(
    p: Rwkv, x: torch.Tensor, state: Optional[RwkvState], cfg: ModelConfig
) -> Tuple[torch.Tensor, Optional[RwkvState]]:
    sx = _shifted(x, None if state is None else state.shift_cm) - x
    mu = p.cm_mu.to(x.dtype)
    xk = x + sx * mu[0]
    xr = x + sx * mu[1]
    k = torch.square(F.relu(dense(xk, p.cm_k)))
    r = torch.sigmoid(dense(xr, p.cm_r))
    out = r * dense(k, p.cm_v)
    return out, None if state is None else state._replace(shift_cm=x[:, -1])


def rwkv_block(
    p: Rwkv, ln1: Norm, ln2: Norm, x: torch.Tensor, state: Optional[RwkvState],
    cfg: ModelConfig, *, plain: bool = False,
) -> Tuple[torch.Tensor, Optional[RwkvState]]:
    """Full RWKV layer: x + TimeMix(LN(x)); x + ChannelMix(LN(x))."""
    h1, state = time_mix(p, apply_norm(ln1, x, cfg.norm), state, cfg, plain=plain)
    x = x + h1
    h2, state = channel_mix(p, apply_norm(ln2, x, cfg.norm), state, cfg)
    return x + h2, state


__all__ = [
    "Rwkv",
    "RwkvState",
    "channel_mix",
    "init_rwkv",
    "init_rwkv_state",
    "rwkv_block",
    "time_mix",
]
