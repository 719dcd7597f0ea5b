"""Scenario-grid engine — port of ``repro.sim.engine`` for OCEAN policies.

The grid is (policy, scenario, seed).  The JAX engine vmaps over the
scenario and seed axes; here the (scenario, seed) cells are flattened into
one leading cell axis C = S * N (scenario-major) and every policy runs as
ONE ``simulate`` call over all cells — under ``traj="fused"`` that is one
launch of kernel K3 per policy.  Scenario statics that shape the program
(T, K, frame length, solver, ranking, top_m, block_k, traj) must agree
across the grid, as ``_check_compatible`` demands in the reference.

Channels: each seed's Exp(1) fading draw comes from a ``torch.Generator``
seeded with the seed and is shared by every scenario (the reference shares
its fading key the same way); each scenario scales it by its own scheduled
mean gain.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core.channel import rayleigh_power
from repro_torch.core.ocean import OceanConfig, not_ported
from repro_torch.core.policy import (
    Policy,
    PolicyParams,
    PolicyTrace,
    get_policy,
    resolve_params,
)
from repro_torch.core.scenario import Scenario

PolicySpec = Union[str, Policy, Tuple[Union[str, Policy], PolicyParams]]


class GridResult(NamedTuple):
    """Stacked outputs of one grid sweep; leading axes (P, S, N)."""

    a: torch.Tensor             # (P, S, N, T, K) bool selections
    b: torch.Tensor             # (P, S, N, T, K) bandwidth ratios
    e: torch.Tensor             # (P, S, N, T, K) per-round energy
    num_selected: torch.Tensor  # (P, S, N, T) int32
    energy_spent: torch.Tensor  # (P, S, N, K) per-client totals over T
    h2: torch.Tensor            # (S, N, T, K) sampled channel power gains
    history: None
    policies: Tuple[str, ...]
    scenarios: Tuple[str, ...]
    seeds: Tuple[int, ...]
    budget_inc: Optional[torch.Tensor] = None    # (S, N, T, K)
    budget_total: Optional[torch.Tensor] = None  # (S, N, K)
    # The queues each round's P3 saw, (P, S, N, T, K): not in the
    # reference's result; lets a run be replayed against the plain path.
    q: Optional[torch.Tensor] = None

    def cell(self, policy: str, scenario: str, seed: int) -> PolicyTrace:
        """Extract one (policy, scenario, seed) cell as a PolicyTrace."""
        for label, name, axis in (
            ("policy", policy, self.policies),
            ("scenario", scenario, self.scenarios),
        ):
            if axis.count(name) > 1:
                raise ValueError(
                    f"{label} name {name!r} appears {axis.count(name)} times on "
                    f"the {label} axis; index the result arrays positionally"
                )
            if name not in axis:
                raise ValueError(
                    f"unknown {label} {name!r}; this grid's {label} axis: "
                    f"{', '.join(axis)}"
                )
        if seed not in self.seeds:
            raise ValueError(
                f"unknown seed {seed!r}; this grid ran seeds "
                f"{', '.join(str(s) for s in self.seeds)}"
            )
        p = self.policies.index(policy)
        s = self.scenarios.index(scenario)
        n = self.seeds.index(seed)
        return PolicyTrace(
            a=self.a[p, s, n],
            b=self.b[p, s, n],
            e=self.e[p, s, n],
            num_selected=self.num_selected[p, s, n],
            q=None if self.q is None else self.q[p, s, n],
        )


def _resolve_policy_specs(policies: Sequence[PolicySpec]):
    resolved = []
    for spec in policies:
        if isinstance(spec, tuple):
            name_or_pol, params = spec
        else:
            name_or_pol, params = spec, PolicyParams()
        resolved.append((get_policy(name_or_pol), params))
    return resolved


def _check_compatible(scenarios: Sequence[Scenario]) -> Scenario:
    # radio, channel, budgets and eta may vary per scenario: they are data.
    base = scenarios[0]
    for sc in scenarios[1:]:
        mismatches = [
            f"{field}: {getattr(base, field)!r} != {getattr(sc, field)!r}"
            for field in (
                "num_rounds", "num_clients", "frame_len", "solver",
                "ranking", "top_m", "block_k", "traj",
            )
            if getattr(base, field) != getattr(sc, field)
        ]
        if mismatches:
            raise ValueError(
                f"scenario {sc.name!r} is grid-incompatible with "
                f"{base.name!r}: these fields shape the program and must "
                f"agree ({'; '.join(mismatches)}); run separate grids"
            )
    return base


class GridEngine:
    """Sweep (policy, scenario, seed) grids of OCEAN policies on one device.

    ``solver``/``ranking``/``top_m``/``block_k``/``traj`` override the
    scenarios' fields.  ``experiment``, ``metrics``, ``checkpoint``,
    ``guard`` and ``shard=True`` are hooks of later slices and raise
    ``NotImplementedError``.  Radio physics may differ across scenarios in
    the reference; this slice's kernels take one static radio, so here all
    scenarios must share it.
    """

    def __init__(
        self,
        scenarios: Union[Sequence[Scenario], Mapping[str, Scenario]],
        policies: Sequence[PolicySpec],
        *,
        experiment=None,
        solver: Optional[str] = None,
        shard: Optional[bool] = None,
        ranking: Optional[str] = None,
        top_m: Optional[int] = None,
        block_k: Optional[int] = None,
        traj: Optional[str] = None,
        metrics=None,
        checkpoint=None,
        guard=None,
        device=None,
    ):
        for hook, val in (
            ("experiment", experiment), ("metrics", metrics),
            ("checkpoint", checkpoint), ("guard", guard),
        ):
            if val is not None:
                raise not_ported(f"GridEngine({hook}=...)")
        if shard:
            raise not_ported("GridEngine(shard=True)")
        if isinstance(scenarios, Mapping):
            scenarios = list(scenarios.values())
        if not scenarios or not policies:
            raise ValueError("need at least one scenario and one policy")
        self.device = resolve_device(device)
        self.scenarios = tuple(scenarios)
        base = _check_compatible(self.scenarios)
        radios = {sc.radio for sc in self.scenarios}
        if len(radios) > 1:
            raise not_ported("per-scenario radio physics in one grid")
        self.cfg: OceanConfig = base.ocean_config()
        overrides = {
            k: v
            for k, v in (
                ("solver", solver), ("ranking", ranking), ("top_m", top_m),
                ("block_k", block_k), ("traj", traj),
            )
            if v is not None
        }
        if overrides:
            self.cfg = dataclasses.replace(self.cfg, **overrides)
        self._resolved = _resolve_policy_specs(policies)
        self.policies = tuple(pol.name for pol, _ in self._resolved)

    def sample_channels(self, seeds: Sequence[int]) -> torch.Tensor:
        """(S, N, T, K) gains: per-seed fading times per-scenario mean gain."""
        T, K = self.cfg.num_rounds, self.cfg.num_clients
        dev = self.device
        fades = []
        for seed in seeds:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            fades.append(rayleigh_power(gen, (T, K)))
        fade = torch.stack(fades)                                  # (N, T, K)
        rows = []
        for sc in self.scenarios:
            g = sc.mean_gain_seq(device=dev).to(dev)               # (T,)
            rows.append(g[None, :, None] * fade if sc.fading else
                        g[None, :, None].expand(len(seeds), T, K))
        return torch.stack(rows).contiguous()

    def run(self, seeds: Sequence[int]) -> GridResult:
        """Sweep the grid over ``seeds``: one ``simulate`` call per policy."""
        seeds = tuple(int(s) for s in seeds)
        cfg, dev = self.cfg, self.device
        S, N, T, K = len(self.scenarios), len(seeds), cfg.num_rounds, cfg.num_clients
        C = S * N
        h2 = self.sample_channels(seeds)
        totals = torch.stack([sc.budgets(device=dev) for sc in self.scenarios])
        budget_total = totals[:, None, :].expand(S, N, K)
        budget_inc = (budget_total / T)[:, :, None, :].expand(S, N, T, K)
        etas = torch.stack([sc.eta_seq(device=dev) for sc in self.scenarios])
        eta_cells = etas[:, None, :].expand(S, N, T).reshape(C, T)
        h2_cells = h2.reshape(C, T, K)
        inc_cells = budget_inc.reshape(C, T, K).contiguous()

        traces = []
        for pol, pp in self._resolved:
            params = resolve_params(
                pol, cfg, pp,
                scenario_eta=eta_cells,
                scenario_budgets=budget_total.reshape(C, K),
                scenario_budget_seq=inc_cells,
                device=dev,
            )
            traces.append(pol.trace_fn(cfg, h2_cells, params, device=dev))

        def grid(x):
            return torch.stack([getattr(t, x) for t in traces]).reshape(
                (len(traces), S, N) + getattr(traces[0], x).shape[1:]
            )

        e = grid("e")
        return GridResult(
            a=grid("a"),
            b=grid("b"),
            e=e,
            num_selected=grid("num_selected"),
            energy_spent=e.sum(dim=-2),
            h2=h2,
            history=None,
            policies=self.policies,
            scenarios=tuple(sc.name for sc in self.scenarios),
            seeds=seeds,
            budget_inc=budget_inc,
            budget_total=budget_total,
            q=grid("q"),
        )


def run_grid(
    scenarios,
    policies: Sequence[PolicySpec],
    seeds: Sequence[int],
    *,
    experiment=None,
    solver: Optional[str] = None,
    shard: Optional[bool] = None,
    ranking: Optional[str] = None,
    top_m: Optional[int] = None,
    block_k: Optional[int] = None,
    traj: Optional[str] = None,
    metrics=None,
    checkpoint=None,
    guard=None,
    device=None,
) -> GridResult:
    """One-shot convenience wrapper around ``GridEngine``; on the card by default."""
    return GridEngine(
        scenarios, policies, experiment=experiment, solver=solver, shard=shard,
        ranking=ranking, top_m=top_m, block_k=block_k, traj=traj,
        metrics=metrics, checkpoint=checkpoint, guard=guard, device=device,
    ).run(seeds)
