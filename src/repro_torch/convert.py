"""Carry configuration, state and weights between the JAX reference and the port.

For OCEAN what crosses over is a scenario or an environment (plain JSON
data from the reference's ``Scenario.to_dict()`` / ``EnvSpec.to_dict()``),
realized environment streams (a reference ``TracedRadio`` or
``TracedFailure`` with numpy leaves: the port's samplers cannot reproduce
JAX's keys, so identical streams cross over), and OCEAN state or
decisions as numpy arrays; for the decoder LM it is the reference's
parameter tree, as numpy arrays.  The tests feed both packages the same
inputs through these functions.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.ocean import OceanState, RoundDecision
from repro_torch.core.scenario import Scenario
from repro_torch.env.failure import TracedFailure
from repro_torch.env.radio import TracedRadio
from repro_torch.env.spec import EnvSpec


def scenario_from_reference(d: Dict[str, Any]) -> Scenario:
    """The port's ``Scenario`` from a reference ``Scenario.to_dict()`` payload.

    Raises ``NotImplementedError`` for fields this slice does not take.
    """
    return Scenario.from_dict(d)


def env_spec_from_reference(d: Dict[str, Any]) -> EnvSpec:
    """The port's ``EnvSpec`` from a reference ``EnvSpec.to_dict()`` payload."""
    return EnvSpec.from_dict(d)


def _f32_leaf(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def radio_from_reference(radio, device=None) -> TracedRadio:
    """A reference ``TracedRadio`` (numpy leaves of any shape) as the port's."""
    dev = resolve_device(device)
    return TracedRadio(*(_f32_leaf(getattr(radio, f), dev) for f in TracedRadio._fields))


def failure_from_reference(failure, device=None) -> TracedFailure:
    """A reference ``TracedFailure`` ((..., T, K) mask, (..., K) rates) as the port's."""
    dev = resolve_device(device)
    return TracedFailure(
        delivered=_f32_leaf(failure.delivered, dev), rate=_f32_leaf(failure.rate, dev)
    )


def state_from_reference(q, t, energy_spent, device=None) -> OceanState:
    """An ``OceanState`` from numpy arrays: q, energy_spent (C, K) or (K,),
    t a scalar or (C,)."""
    dev = resolve_device(device)
    q = np.atleast_2d(np.array(q, np.float32))
    es = np.atleast_2d(np.array(energy_spent, np.float32))
    t = np.array(np.broadcast_to(np.asarray(t, np.int32), (q.shape[0],)))
    return OceanState(
        q=torch.as_tensor(q, device=dev),
        t=torch.as_tensor(t, device=dev),
        energy_spent=torch.as_tensor(es, device=dev),
    )


def decisions_to_numpy(decs: RoundDecision) -> Dict[str, np.ndarray]:
    """A ``RoundDecision`` (or any NamedTuple of tensors) as numpy arrays;
    absent (None) fields are left out."""
    return {
        f: getattr(decs, f).detach().cpu().numpy()
        for f in decs._fields
        if getattr(decs, f) is not None
    }


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _flatten(tree: Dict[str, Any], prefix: str) -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def decoder_params_from_reference(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A ``DecoderModel`` state dict from the reference's parameters.

    ``params`` is ``repro.models.DecoderModel.init``'s tree with numpy
    leaves.  Layer i of the reference lives at ``params["blocks"][j]``,
    index ``sb`` of every leaf's leading (superblock) axis, where
    ``sb, j = divmod(i, cfg.block_len)``, or, past the last whole
    superblock, at ``params["rem"][i - num_superblocks * block_len]``.
    Names follow the reference's keys (``layers.<i>.attn.wq``,
    ``layers.<i>.rwkv.ln_x.scale``, ``layers.<i>.moe.wi`` ...), for every
    layer kind the port runs (attention, ``mamba``, ``rwkv``; ``dense``
    and ``moe`` FFNs).
    """
    bl, nsb = cfg.block_len, cfg.num_superblocks
    out = {"embed": _tensor(params["embed"])}
    out.update((k, _tensor(v)) for k, v in _flatten(params["final_norm"], "final_norm."))
    if "lm_head" in params:
        out["lm_head"] = _tensor(params["lm_head"])
    for i in range(cfg.num_layers):
        prefix = f"layers.{i}."
        if i < nsb * bl:
            sb, j = divmod(i, bl)
            leaves = ((k, v[sb]) for k, v in _flatten(params["blocks"][j], prefix))
        else:
            leaves = _flatten(params["rem"][i - nsb * bl], prefix)
        out.update((k, _tensor(v)) for k, v in leaves)
    return out
