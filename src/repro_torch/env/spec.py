"""EnvSpec — port of ``repro.env.spec``: one wireless environment.

An :class:`EnvSpec` names a registered channel, budget, radio and failure
process with their JSON-able parameters; ``to_dict`` gives the
reference's payload (non-default radio and failure keys only), and
``env_key_salt`` its exact content hash.

Key discipline
--------------
A (scenario, seed) cell draws its fading from a generator seeded by the
seed alone (shared across scenarios, as the reference shares
``PRNGKey(seed)``), and its environment streams from generators seeded
by ``(seed, salt, stream)``, the salt a content hash of the spec — never
a grid index — so adding, removing or reordering scenarios never changes
another cell's draws.  The reference's ``fold_in`` streams cannot be
reproduced with ``torch.Generator``; this invariant is what is kept.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import zlib
from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.env.channel import ChannelParams, LowerCtx, get_channel_process
from repro_torch.env.energy import BudgetParams, get_budget_process
from repro_torch.env.failure import FailureParams, get_failure_process
from repro_torch.env.radio import RadioProcessParams, get_radio_process


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """One wireless environment: channel + budget + radio + failure processes."""

    channel: str = "iid_rayleigh"
    channel_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    budget: str = "static"
    budget_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    radio: str = "static"
    radio_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    failure: str = "none"
    failure_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        get_channel_process(self.channel)
        get_budget_process(self.budget)
        get_radio_process(self.radio)
        get_failure_process(self.failure)

    def to_dict(self) -> Dict[str, Any]:
        """The reference's payload: the radio and failure keys appear only
        when they are not the defaults (the salt hashes this dict)."""
        d = {
            "channel": self.channel,
            "channel_params": dict(self.channel_params),
            "budget": self.budget,
            "budget_params": dict(self.budget_params),
        }
        if self.radio != "static" or self.radio_params:
            d["radio"] = self.radio
            d["radio_params"] = dict(self.radio_params)
        if self.failure != "none" or self.failure_params:
            d["failure"] = self.failure
            d["failure_params"] = dict(self.failure_params)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "EnvSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "EnvSpec":
        return cls.from_dict(json.loads(s))


# dict fields defeat the generated hash: hash the canonical JSON instead
EnvSpec.__hash__ = lambda self: hash(self.to_json())  # type: ignore[method-assign]


class LoweredEnv(NamedTuple):
    """An EnvSpec lowered against one scenario's statics."""

    channel: ChannelParams
    budget: BudgetParams
    radio: RadioProcessParams
    failure: FailureParams
    key_salt: int  # uint32 content hash


def env_key_salt(spec: EnvSpec, ctx: LowerCtx) -> int:
    """Stable uint32 salt from the spec's content (the reference's value)."""
    payload = json.dumps(
        {"env": spec.to_dict(), "num_rounds": ctx.num_rounds, "num_clients": ctx.num_clients},
        sort_keys=True,
        default=list,
    )
    return zlib.crc32(payload.encode()) & 0xFFFFFFFF


def _screen_lowered(name: str, params) -> None:
    """Refuse non-finite lowered parameters before they reach a sampler."""
    leaves = params if isinstance(params, tuple) else (params,)
    for leaf in leaves:
        if isinstance(leaf, tuple):
            _screen_lowered(name, leaf)
            continue
        if torch.is_floating_point(leaf) and not bool(torch.isfinite(leaf).all()):
            bad = int((~torch.isfinite(leaf)).sum())
            raise ValueError(
                f"lowered {name} params contain non-finite values ({bad} of "
                f"{leaf.numel()} entries); refusing to sample a stream from "
                f"corrupt parameters"
            )


def lower_env(spec: EnvSpec, ctx: LowerCtx) -> LoweredEnv:
    """Resolve the registry entries and lower to the unified parameters."""
    lowered = LoweredEnv(
        channel=get_channel_process(spec.channel).lower(spec.channel_params, ctx),
        budget=get_budget_process(spec.budget).lower(spec.budget_params, ctx),
        radio=get_radio_process(spec.radio).lower(spec.radio_params, ctx),
        failure=get_failure_process(spec.failure).lower(spec.failure_params, ctx),
        key_salt=env_key_salt(spec, ctx),
    )
    for name in ("channel", "budget", "radio", "failure"):
        _screen_lowered(name, getattr(lowered, name))
    return lowered


# Stream ids: the environment's channel and budget streams, the radio's,
# the failure's.
_CHANNEL_STREAM, _BUDGET_STREAM = 0, 1
_RADIO_STREAM = 0x7261_6449  # "radI"
_FAILURE_STREAM = 0x6661_694C  # "faiL"


def stream_seed(seed: int, key_salt: int, stream: int) -> int:
    """A 63-bit generator seed from (seed, salt, stream id) alone."""
    h = hashlib.blake2b(f"{int(seed)}:{int(key_salt)}:{int(stream)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def cell_generator(stream: int) -> torch.Generator:
    """A CPU generator seeded with a ``stream_seed``."""
    g = torch.Generator()
    g.manual_seed(stream)
    return g


def env_cell_keys(seed: int, key_salt: int) -> Tuple[int, int]:
    """(channel, budget) environment-stream seeds of one (scenario, seed) cell."""
    return (
        stream_seed(seed, key_salt, _CHANNEL_STREAM),
        stream_seed(seed, key_salt, _BUDGET_STREAM),
    )


def radio_cell_key(seed: int, key_salt: int) -> int:
    """The radio-stream seed of one (scenario, seed) cell."""
    return stream_seed(seed, key_salt, _RADIO_STREAM)


def failure_cell_key(seed: int, key_salt: int) -> int:
    """The failure-stream seed of one (scenario, seed) cell."""
    return stream_seed(seed, key_salt, _FAILURE_STREAM)
