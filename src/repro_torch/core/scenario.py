"""Serializable Scenario spec — port of ``repro.core.scenario``.

A scenario is the channel (a path-loss drift with optional i.i.d.
Rayleigh fading, or any registered process through ``env``), radio
physics, budgets, the eta schedule, (T, K), the frame length, the
failure mode, the guard, the telemetry spec, the checkpoint spec and the
solver / ranking / trajectory knobs.
``env`` (an ``EnvSpec``) picks the channel, budget, radio and failure
processes of ``repro_torch.env``; without it the legacy fields lower to
``iid_rayleigh`` / ``static`` / ``static`` / ``none``.  A dict that sets
a field the port does not know raises ``NotImplementedError`` naming it;
it is never silently dropped.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.trajectory import CheckpointSpec
from repro_torch.core.channel import ChannelModel, constant_pathloss, linear_pathloss
from repro_torch.core.energy import RadioParams
from repro_torch.core.ocean import (
    OceanConfig,
    check_checkpoint_spec,
    check_failure_mode,
    check_traj_backend,
    not_ported,
)
from repro_torch.core.patterns import eta_schedule
from repro_torch.core.selection import DEFAULT_BLOCK_K, DEFAULT_TOP_M, check_ranking
from repro_torch.core.solvers import get_solver
from repro_torch.env.channel import LowerCtx, get_channel_process, sample_channel_process
from repro_torch.env.energy import sample_budget_process
from repro_torch.env.failure import TracedFailure, traced_failure
from repro_torch.env.radio import TracedRadio, sample_radio_process
from repro_torch.env.spec import (
    EnvSpec,
    LoweredEnv,
    cell_generator,
    env_cell_keys,
    failure_cell_key,
    lower_env,
    radio_cell_key,
)
from repro_torch.guard.spec import GuardSpec
from repro_torch.obs.metrics import MetricsSpec

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
    env: Optional[EnvSpec] = None
    solver: str = "bisect"
    ranking: str = "sort"
    top_m: int = DEFAULT_TOP_M
    block_k: int = DEFAULT_BLOCK_K
    traj: str = "scan"
    metrics: Optional[MetricsSpec] = None
    checkpoint: Optional[CheckpointSpec] = None
    failure_mode: str = "plain"
    guard: Optional[GuardSpec] = None

    def __post_init__(self):
        backend = get_solver(self.solver)
        check_ranking(self.ranking)
        check_traj_backend(self.traj)
        check_failure_mode(self.failure_mode)
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
        if self.env is not None:
            self.env.validate()
        if self.metrics is not None:
            if not isinstance(self.metrics, MetricsSpec):
                raise TypeError(
                    f"metrics must be a repro_torch.obs.MetricsSpec or None, got "
                    f"{type(self.metrics).__name__}"
                )
            # the full-trace memory cap needs this scenario's (T, K)
            self.metrics.validate(self.num_rounds, self.num_clients)
        if self.guard is not None and not isinstance(self.guard, GuardSpec):
            raise TypeError(
                f"guard must be a repro_torch.guard.GuardSpec or None, got "
                f"{type(self.guard).__name__}"
            )
        check_checkpoint_spec(self.checkpoint)

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
            metrics=self.metrics,
            checkpoint=self.checkpoint,
            failure_mode=self.failure_mode,
            guard=self.guard,
        )

    def channel_model(self) -> ChannelModel:
        start, end = self.pathloss_db
        if start == end:
            sched = constant_pathloss(start)
        else:
            sched = linear_pathloss(start, end, self.num_rounds)
        return ChannelModel(self.num_clients, sched, fading=self.fading)

    # -- environment (repro_torch.env) ---------------------------------------
    def env_spec(self) -> EnvSpec:
        """The embedded EnvSpec, or the legacy fields' lowering."""
        return self.env if self.env is not None else EnvSpec()

    def lower_ctx(self) -> LowerCtx:
        return LowerCtx(
            num_rounds=self.num_rounds,
            num_clients=self.num_clients,
            pathloss_db=tuple(self.pathloss_db),
            fading=self.fading,
            budgets_j=tuple(
                (self.energy_budget_j,) * self.num_clients
                if isinstance(self.energy_budget_j, (int, float))
                else self.energy_budget_j
            ),
            radio=self.radio,
        )

    def lower_env(self) -> LoweredEnv:
        """Lowered process parameters and the content salt of this scenario."""
        return lower_env(self.env_spec(), self.lower_ctx())

    def mean_gain_seq(self, device=None) -> torch.Tensor:
        """(T,) closed-form mean power gain E[h^2]_t, where one exists."""
        spec = self.env_spec()
        proc = get_channel_process(spec.channel)
        if proc.mean_gain is None:
            raise ValueError(
                f"channel process {spec.channel!r} has no closed-form mean gain; "
                f"sample and average instead"
            )
        return proc.mean_gain(spec.channel_params, self.lower_ctx()).to(device)

    def sample_channel(self, seed: int, device=None) -> torch.Tensor:
        """(T, K) channel power gains h^2 for one seed, on ``device``.

        The fading draws depend on the seed only (not on the scenario), as
        in the reference, so scenarios of one grid share fading per seed;
        an ``env`` scenario draws its environment stream from the seed and
        its content salt, as the grid engine does.
        """
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if self.env is None:
            return self.channel_model().sample(gen, self.num_rounds)
        lowered = self.lower_env()
        k_chan, _ = env_cell_keys(seed, lowered.key_salt)
        return sample_channel_process(
            lowered.channel, gen, cell_generator(k_chan), self.num_rounds, self.num_clients
        )

    def sample_budget(self, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """((T, K) per-round increments, (K,) totals) for one seed (CPU)."""
        lowered = self.lower_env()
        _, k_budget = env_cell_keys(seed, lowered.key_salt)
        return sample_budget_process(
            lowered.budget, cell_generator(k_budget), self.num_rounds, self.num_clients
        )

    def sample_radio(self, seed: int) -> TracedRadio:
        """(T,)-leaf radio sequences for one seed (CPU)."""
        lowered = self.lower_env()
        k = radio_cell_key(seed, lowered.key_salt)
        return sample_radio_process(lowered.radio, cell_generator(k), self.num_rounds)

    def sample_failure(self, seed: int) -> TracedFailure:
        """Realized reliability for one seed (CPU)."""
        lowered = self.lower_env()
        k = failure_cell_key(seed, lowered.key_salt)
        return traced_failure(
            lowered.failure, cell_generator(k), self.num_rounds, self.num_clients
        )

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
        if self.env is None:
            d.pop("env")
        else:
            d["env"] = self.env.to_dict()
        for key, default in (
            ("solver", "bisect"),
            ("ranking", "sort"),
            ("top_m", DEFAULT_TOP_M),
            ("block_k", DEFAULT_BLOCK_K),
            ("traj", "scan"),
            ("failure_mode", "plain"),
        ):
            if d[key] == default:
                d.pop(key)
        if self.metrics is None:
            d.pop("metrics")
        else:
            d["metrics"] = self.metrics.to_dict()
        if self.checkpoint is None:
            d.pop("checkpoint")  # keep pre-checkpoint payloads byte-stable
        else:
            d["checkpoint"] = self.checkpoint.to_dict()
        if self.guard is None:
            d.pop("guard")
        else:
            d["guard"] = self.guard.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Scenario":
        """Build from a dict; raises on any field this slice does not take."""
        known = {f.name for f in dataclasses.fields(cls)}
        d = dict(d)
        for key in d:
            if key not in known:
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
        if isinstance(d.get("env"), dict):
            d["env"] = EnvSpec.from_dict(d["env"])
        if isinstance(d.get("metrics"), dict):
            d["metrics"] = MetricsSpec.from_dict(d["metrics"])
        if isinstance(d.get("checkpoint"), dict):
            d["checkpoint"] = CheckpointSpec.from_dict(d["checkpoint"])
        if isinstance(d.get("guard"), dict):
            d["guard"] = GuardSpec.from_dict(d["guard"])
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


def environment_zoo(num_rounds: int = 300, num_clients: int = 10, **overrides):
    """One grid-compatible scenario per registered environment family (the
    reference's ``environment_zoo``)."""
    base = dict(num_rounds=num_rounds, num_clients=num_clients, **overrides)
    envs = {
        "stationary": None,
        "markov_fading": EnvSpec(channel="gauss_markov", channel_params={"rho": 0.9}),
        "blockage": EnvSpec(
            channel="markov_shadowing",
            channel_params={"p_enter": 0.15, "p_exit": 0.5, "extra_db": 10.0},
        ),
        "mobile": EnvSpec(channel="mobility", channel_params={"area_m": 60.0}),
        "harvesting": EnvSpec(budget="harvesting", budget_params={"p_active": 0.5}),
        "depleting": EnvSpec(budget="depleting"),
        "spectrum_sharing": EnvSpec(
            radio="spectrum_sharing", radio_params={"share_min": 0.5, "share_max": 1.0}
        ),
        "deadline_jitter": EnvSpec(radio="deadline_jitter", radio_params={"amp": 0.3}),
        "dropout": EnvSpec(failure="iid_dropout", failure_params={"p_deliver": 0.85}),
        "bursty_outage": EnvSpec(
            failure="markov_availability", failure_params={"p_fail": 0.1, "p_recover": 0.4}
        ),
        "stragglers": EnvSpec(
            failure="straggler_slowdown", failure_params={"sigma": 0.5, "compute_frac": 0.8}
        ),
    }
    return {name: Scenario(name=name, env=env, **base) for name, env in envs.items()}
