"""Temporal weight schedules eta^t and client-count patterns (paper §III/§VI).

Port of ``repro.core.patterns``: ``eta_*`` are the per-round significance
weights of U^t(a) = eta^t * sum_k a_k (OCEAN-a / -d / -u use ascending /
descending / uniform, normalized to mean 1); ``count_*`` are the explicit
numbers-of-selected-clients schedules of the §III experiments.
"""
from __future__ import annotations

import torch


def eta_uniform(num_rounds: int, device=None) -> torch.Tensor:
    return torch.ones((num_rounds,), dtype=torch.float32, device=device)


def eta_ascend(
    num_rounds: int, lo: float = 0.2, hi: float = 1.8, device=None
) -> torch.Tensor:
    e = torch.linspace(lo, hi, num_rounds, dtype=torch.float32, device=device)
    return e / e.mean()


def eta_descend(
    num_rounds: int, lo: float = 0.2, hi: float = 1.8, device=None
) -> torch.Tensor:
    return torch.flip(eta_ascend(num_rounds, lo, hi, device=device), (0,))


ETA_SCHEDULES = {
    "ascend": eta_ascend,
    "descend": eta_descend,
    "uniform": eta_uniform,
}


def eta_schedule(name: str, num_rounds: int, device=None) -> torch.Tensor:
    try:
        fn = ETA_SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown eta schedule {name!r}; choose from {sorted(ETA_SCHEDULES)}"
        ) from None
    return fn(num_rounds, device=device)


def count_uniform(num_rounds: int, num_clients: int, avg: int) -> torch.Tensor:
    return torch.full((num_rounds,), avg, dtype=torch.int32)


def count_ascend(num_rounds: int, num_clients: int, avg=None) -> torch.Tensor:
    """1 -> K linearly; average (K+1)/2."""
    c = torch.linspace(1.0, num_clients, num_rounds, dtype=torch.float32)
    return torch.round(c).to(torch.int32)


def count_descend(num_rounds: int, num_clients: int, avg=None) -> torch.Tensor:
    return torch.flip(count_ascend(num_rounds, num_clients), (0,))


COUNT_PATTERNS = {
    "ascend": count_ascend,
    "descend": count_descend,
    "uniform": lambda t, k, avg=5: count_uniform(t, k, avg),
}
