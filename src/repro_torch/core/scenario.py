"""Serializable Scenario spec — port of ``repro.core.scenario``.

Only the fields this slice runs are taken: the channel (a path-loss drift
with optional i.i.d. Rayleigh fading), radio physics, budgets, the eta
schedule, (T, K), the frame length, and the solver / ranking / trajectory
knobs.  A dict that sets any other field of the reference (``env``,
``metrics``, ``checkpoint``, ``failure_mode``, ``guard``) raises
``NotImplementedError`` naming it; it is never silently dropped.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core.channel import ChannelModel, constant_pathloss, linear_pathloss
from repro_torch.core.energy import RadioParams
from repro_torch.core.ocean import OceanConfig, check_traj_backend, not_ported
from repro_torch.core.patterns import eta_schedule
from repro_torch.core.selection import DEFAULT_BLOCK_K, DEFAULT_TOP_M, check_ranking
from repro_torch.core.solvers import get_solver

# Fields of the reference Scenario that this slice does not take, with the
# value that means "off" (a payload may carry them only at that value).
_UNPORTED_FIELDS = {
    "env": None,
    "metrics": None,
    "checkpoint": None,
    "failure_mode": "plain",
    "guard": None,
}


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One point on the scenario axis of a (policy, scenario, seed) grid."""

    name: str = "stationary"
    num_clients: int = 10
    num_rounds: int = 300
    pathloss_db: Tuple[float, float] = (36.0, 36.0)
    fading: bool = True
    radio: RadioParams = RadioParams()
    energy_budget_j: Union[float, Tuple[float, ...]] = 0.15
    eta: str = "uniform"
    frame_len: Optional[int] = None
    solver: str = "bisect"
    ranking: str = "sort"
    top_m: int = DEFAULT_TOP_M
    block_k: int = DEFAULT_BLOCK_K
    traj: str = "scan"

    def __post_init__(self):
        backend = get_solver(self.solver)
        check_ranking(self.ranking)
        check_traj_backend(self.traj)
        if backend.topm is not None and self.ranking != "topm":
            raise ValueError(
                f"solver {self.solver!r} is sort-free and only runs under "
                f"ranking='topm' (got ranking={self.ranking!r})"
            )
        if len(self.pathloss_db) != 2:
            raise ValueError(
                f"pathloss_db must be a (start_db, end_db) pair, got "
                f"{self.pathloss_db!r}"
            )
        if not isinstance(self.energy_budget_j, (int, float)):
            if len(self.energy_budget_j) != self.num_clients:
                raise ValueError(
                    f"heterogeneous energy_budget_j needs {self.num_clients} "
                    f"entries, got {len(self.energy_budget_j)}"
                )
        eta_schedule(self.eta, 1)

    def ocean_config(self) -> OceanConfig:
        return OceanConfig(
            num_clients=self.num_clients,
            num_rounds=self.num_rounds,
            radio=self.radio,
            energy_budget_j=self.energy_budget_j,
            frame_len=self.frame_len,
            solver=self.solver,
            ranking=self.ranking,
            top_m=self.top_m,
            block_k=self.block_k,
            traj=self.traj,
        )

    def channel_model(self) -> ChannelModel:
        start, end = self.pathloss_db
        if start == end:
            sched = constant_pathloss(start)
        else:
            sched = linear_pathloss(start, end, self.num_rounds)
        return ChannelModel(self.num_clients, sched, fading=self.fading)

    def mean_gain_seq(self, device=None) -> torch.Tensor:
        """(T,) closed-form mean power gain E[h^2]_t."""
        from repro_torch.core.channel import pathloss_to_gain

        t = torch.arange(self.num_rounds, device=device)
        return pathloss_to_gain(self.channel_model().pathloss_db(t))

    def sample_channel(self, seed: int, device=None) -> torch.Tensor:
        """(T, K) channel power gains h^2 for one seed, on ``device``.

        The fading draws depend on the seed only (not on the scenario), as
        in the reference, so scenarios of one grid share fading per seed.
        """
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return self.channel_model().sample(gen, self.num_rounds)

    def eta_seq(self, device=None) -> torch.Tensor:
        return eta_schedule(self.eta, self.num_rounds, device=device)

    def budgets(self, device=None) -> torch.Tensor:
        h = torch.as_tensor(self.energy_budget_j, dtype=torch.float32, device=device)
        return torch.broadcast_to(h, (self.num_clients,))

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """The reference's payload: default knobs are omitted."""
        d = dataclasses.asdict(self)
        d["pathloss_db"] = list(self.pathloss_db)
        if not isinstance(self.energy_budget_j, (int, float)):
            d["energy_budget_j"] = list(self.energy_budget_j)
        for key, default in (
            ("solver", "bisect"),
            ("ranking", "sort"),
            ("top_m", DEFAULT_TOP_M),
            ("block_k", DEFAULT_BLOCK_K),
            ("traj", "scan"),
        ):
            if d[key] == default:
                d.pop(key)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Scenario":
        """Build from a dict; raises on any field this slice does not take."""
        known = {f.name for f in dataclasses.fields(cls)}
        d = dict(d)
        for key in list(d):
            if key in known:
                continue
            if key in _UNPORTED_FIELDS and d[key] == _UNPORTED_FIELDS[key]:
                d.pop(key)
                continue
            raise not_ported(f"Scenario field {key!r}={d[key]!r}")
        d["pathloss_db"] = tuple(d.get("pathloss_db", (36.0, 36.0)))
        if isinstance(d.get("radio"), dict):
            radio_known = {f.name for f in dataclasses.fields(RadioParams)}
            extra = set(d["radio"]) - radio_known
            if extra:
                raise not_ported(f"radio fields {sorted(extra)}")
            d["radio"] = RadioParams(**d["radio"])
        if isinstance(d.get("energy_budget_j"), list):
            d["energy_budget_j"] = tuple(d["energy_budget_j"])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))


def paper_scenarios(num_rounds: int = 300, num_clients: int = 10):
    """The paper's §VI channel settings as a named scenario dict."""
    base = dict(num_rounds=num_rounds, num_clients=num_clients)
    return {
        "stationary": Scenario(name="stationary", **base),
        "scenario1": Scenario(name="scenario1", pathloss_db=(32.0, 45.0), **base),
        "scenario2": Scenario(name="scenario2", pathloss_db=(45.0, 32.0), **base),
    }
