"""Carry configuration and state between the JAX reference and the port.

This system has no weights: what crosses over is a scenario (plain JSON
data from the reference's ``Scenario.to_dict()``) and OCEAN state or
decisions as numpy arrays.  The tests feed both packages the same inputs
through these functions.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.ocean import OceanState, RoundDecision
from repro_torch.core.scenario import Scenario


def scenario_from_reference(d: Dict[str, Any]) -> Scenario:
    """The port's ``Scenario`` from a reference ``Scenario.to_dict()`` payload.

    Raises ``NotImplementedError`` for fields this slice does not take.
    """
    return Scenario.from_dict(d)


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
