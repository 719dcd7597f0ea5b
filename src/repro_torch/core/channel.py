"""Wireless channel of the WFLN (paper §VI) — port of ``repro.core.channel``.

The channel power gain is h^2 = g * X with g = 10^{-PL_dB/10} the mean
gain of the round's scheduled path loss and X ~ Exp(1) (Rayleigh
envelope), redrawn i.i.d. every round.  Draws come from an explicit
``torch.Generator``: they cannot reproduce JAX's threefry bits, so the
port's channel is held to the reference in distribution, not bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.env.channel import pathloss_schedule, pathloss_to_gain, uniform_fade

__all__ = [
    "ChannelModel", "constant_pathloss", "linear_pathloss", "pathloss_schedule",
    "pathloss_to_gain", "rayleigh_power",
]


def constant_pathloss(pl_db: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda t: torch.full(t.shape, pl_db, dtype=torch.float32, device=t.device)


def linear_pathloss(start_db: float, end_db: float, num_rounds: int):
    """Linear drift over the run — scenarios 1 (32->45) and 2 (45->32)."""

    def sched(t):
        frac = t.to(torch.float32) / max(num_rounds - 1, 1)
        return start_db + (end_db - start_db) * frac

    return sched


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Block-fading channel with a per-round path-loss schedule."""

    num_clients: int
    pathloss_db: Callable[[torch.Tensor], torch.Tensor]
    fading: bool = True

    def sample(self, generator: torch.Generator, num_rounds: int) -> torch.Tensor:
        """Draw the (T, K) matrix of channel power gains h^2 on the
        generator's device."""
        dev = generator.device
        t = torch.arange(num_rounds, device=dev)
        g = pathloss_to_gain(self.pathloss_db(t)).to(dev)[:, None]
        if not self.fading:
            return g.expand(num_rounds, self.num_clients).contiguous()
        return g * rayleigh_power(generator, (num_rounds, self.num_clients))


def rayleigh_power(generator: torch.Generator, shape) -> torch.Tensor:
    """Exp(1) power fading: -log(u) with u uniform on [1e-6, 1)."""
    return -torch.log(uniform_fade(generator, shape))

