"""Mamba selective-SSM block (Jamba's mixer).  The port's ``repro.models.mamba``.

    x -> in_proj -> (z, u);  u -> causal depthwise conv -> silu
    (dt, B, C) = x_proj(u);  dt = softplus(dt_proj(dt) + bias)
    dA = exp(dt * A)  (A = -exp(A_log));  dBu = dt * B * u
    h_t = dA_t h_{t-1} + dBu_t ;  y = <h_t, C_t> + D*u ;  out = out_proj(y * silu(z))

The prefill (``state`` None: the scan starts from zero and its final
state is not needed, as in the reference's forward) discretises
``DISCRETIZE_BLOCK`` channels of d_inner at a time (the reference's
``discretize``) and runs each block's scan through K6
(``kernels.mamba_scan.mamba_scan``), which launches the Hopper kernel
for CUDA tensors and runs its plain version for CPU tensors;
``plain=True`` runs the plain version on any device.  The channels are
independent, so the blocks give the same y as one whole scan; a block
keeps dA and dBu at 2 x B x T x 4096 x Ds float32 (4.3 GB for jamba at
B = 1, T = 8192, instead of 17.2 GB for all 16384 channels), and jamba's
d_inner of 16384 takes 4 launches per layer.  The reference computes the
same function with a chunked associative scan.  Decode (``state`` given)
carries a ``MambaState`` (conv window, ssm state) and runs the
sequential scan on it in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain, selective_recurrence
from repro_torch.models.layers import Initialised, dense, empty_param, fill

DISCRETIZE_BLOCK = 4096


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, d_inner) trailing inputs for the conv
    ssm: torch.Tensor   # (B, d_inner, d_state) float32


def _dt_bias(t: torch.Tensor, gen: torch.Generator) -> None:
    """Inverse softplus of a log-uniform [1e-3, 0.1] draw."""
    lo, hi = math.log(0.001), math.log(0.1)
    unif = torch.rand(t.shape, generator=gen, dtype=torch.float32, device=t.device)
    dt = torch.exp(unif * (hi - lo) + lo)
    t.copy_(torch.log(torch.expm1(dt) + 1e-9))


def _a_log(t: torch.Tensor, gen: torch.Generator) -> None:
    """S4D-real: A_log[:, s] = log(s + 1)."""
    ds = t.shape[-1]
    t.copy_(torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=t.device)).expand_as(t))


class Mamba(Initialised):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, di, ds, dr, kc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
        f32 = torch.float32
        self.in_proj = empty_param((d, 2 * di), dtype, device)
        self.conv_w = empty_param((kc, di), dtype, device)
        self.conv_b = empty_param((di,), dtype, device)       # zero at init
        self.x_proj = empty_param((di, dr + 2 * ds), dtype, device)
        self.dt_proj = empty_param((dr, di), dtype, device)
        self.dt_bias = empty_param((di,), f32, device)
        self.a_log = empty_param((di, ds), f32, device)
        self.d_skip = empty_param((di,), f32, device)
        self.out_proj = empty_param((di, d), dtype, device)
        self.init_std = {
            "in_proj": d ** -0.5, "conv_w": kc ** -0.5, "x_proj": di ** -0.5,
            "dt_proj": dr ** -0.5, "out_proj": di ** -0.5,
        }
        self.init_rule = {"dt_bias": _dt_bias, "a_log": _a_log, "d_skip": fill(1.0)}


def init_mamba(cfg: ModelConfig, dtype, device=None) -> Mamba:
    return Mamba(cfg, dtype, device)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device=None) -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=device),
    )


def _causal_conv(
    u: torch.Tensor, w: torch.Tensor, b: torch.Tensor, prefix: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  u: (B, T, Di), w: (Kc, Di)."""
    kc, t = w.shape[0], u.shape[1]
    full = torch.cat([prefix.to(u.dtype), u], dim=1)  # (B, T + kc - 1, Di)
    out = sum(full[:, i : i + t] * w[i] for i in range(kc))
    return out + b, full[:, full.shape[1] - (kc - 1) :].contiguous()


def discretize(
    dt: torch.Tensor, bmat: torch.Tensor, u: torch.Tensor, a: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, Di) dt and u, (B, T, Ds) B, (Di, Ds) A -> dA, dBu (B, T, Di, Ds)."""
    da = (dt[..., None] * a).exp_()
    dbu = (dt[..., None] * bmat[:, :, None, :]).mul_(u[..., None])
    return da, dbu


def mamba_mixer(
    p: Mamba, x: torch.Tensor, state: Optional[MambaState], cfg: ModelConfig, *, plain: bool = False
) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """x (B, T, D) -> (y (B, T, D), new state); prefill when ``state`` is None."""
    b, t, _ = x.shape
    di, ds, dr = cfg.d_inner, cfg.d_state, cfg.dt_rank

    z, u = dense(x, p.in_proj).chunk(2, dim=-1)
    if state is None:
        prefix = x.new_zeros(b, cfg.d_conv - 1, di)
    else:
        prefix = state.conv
    u, new_conv = _causal_conv(u, p.conv_w, p.conv_b, prefix)
    u = F.silu(u)

    dbc = dense(u, p.x_proj).float()
    dt, bmat, cmat = torch.split(dbc, [dr, ds, ds], dim=-1)
    dt = F.softplus(torch.matmul(dt, p.dt_proj.float()) + p.dt_bias)
    a = -torch.exp(p.a_log)                                   # (Di, Ds)
    uf = u.float()

    if state is None:
        scan = mamba_scan_plain if plain else mamba_scan
        cmat = cmat.contiguous()
        y = torch.empty((b, t, di), dtype=torch.float32, device=x.device)
        for lo in range(0, di, DISCRETIZE_BLOCK):
            hi = min(lo + DISCRETIZE_BLOCK, di)
            da, dbu = discretize(dt[..., lo:hi], bmat, uf[..., lo:hi], a[lo:hi])
            y[..., lo:hi] = scan(da, dbu, cmat)
            del da, dbu
        new_state = None
    else:
        da, dbu = discretize(dt, bmat, uf, a)
        y, h_fin = selective_recurrence(da, dbu, cmat, state.ssm)
        new_state = MambaState(conv=new_conv, ssm=h_fin)

    y = y + uf * p.d_skip
    gated = (y * F.silu(z.float())).to(x.dtype)
    return dense(gated, p.out_proj), new_state


__all__ = [
    "DISCRETIZE_BLOCK",
    "Mamba",
    "MambaState",
    "discretize",
    "init_mamba",
    "init_mamba_state",
    "mamba_mixer",
]
