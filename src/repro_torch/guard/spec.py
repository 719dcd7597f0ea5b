"""Static guarded-execution spec for OCEAN trajectories — port of
``repro.guard.spec``.

Eq. (2) energy is unbounded as h^2 -> 0, and the drift-plus-penalty
objective prices energy only through the virtual queue, so a zero-queue
client is selected at any cost.  A scheduler also must not ship a
non-converged solve or let a non-finite draw reach the queue carry.
``GuardSpec`` turns those into bounded, counted degradation with three
defences:

1. **Bounded-energy admission** (``energy_cap`` / ``gain_floor``): a client
   whose minimum-allocation energy ``E(b_min | h^2)`` exceeds
   ``energy_cap x H_k``, or whose gain lies below ``gain_floor``, is
   demoted out of the round's ranking.  Eq. (2) energy decreases in b
   (Lemma 1), so every selected client then spends at most
   ``energy_cap x H_k`` in the round.
2. **Solver fallback** (``fallback``): the solve is validated (all
   finite, ``|sum b - 1| <= residual_tol`` when anything is selected,
   ``b >= b_min`` on selected clients); on a violation the round commits
   the bisect solve of the same guarded inputs and counts it.
3. **Stream quarantine** (``quarantine``): a non-finite or non-positive
   gain makes its client unavailable for the round (counted), and a
   non-finite budget increment is zeroed.

``guard=None`` leaves every unguarded path as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

DEFAULT_RESIDUAL_TOL = 1e-3


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """Knobs of the guarded-execution layer (every defence optional).

    Attributes:
      energy_cap:   admit a client only if ``E(b_min | h^2) <= energy_cap x
                    H_k``; None disables the test.
      gain_floor:   demote clients with ``h^2 < gain_floor``; None disables it.
      fallback:     validate the solve and fall back to bisect on a violation.
      quarantine:   non-finite/non-positive gains make their client
                    unavailable; non-finite budget increments become 0.
      residual_tol: the ``|sum b - 1|`` beyond which the fallback fires.
    """

    energy_cap: Optional[float] = None
    gain_floor: Optional[float] = None
    fallback: bool = True
    quarantine: bool = True
    residual_tol: float = DEFAULT_RESIDUAL_TOL

    def __post_init__(self):
        if self.energy_cap is not None:
            object.__setattr__(self, "energy_cap", float(self.energy_cap))
            if not self.energy_cap > 0.0:
                raise ValueError(
                    f"energy_cap={self.energy_cap} must be positive: it scales "
                    f"the per-client budget H_k into the per-round admission ceiling"
                )
        if self.gain_floor is not None:
            object.__setattr__(self, "gain_floor", float(self.gain_floor))
            if not self.gain_floor > 0.0:
                raise ValueError(
                    f"gain_floor={self.gain_floor} must be positive (it is a "
                    f"channel power-gain threshold)"
                )
        object.__setattr__(self, "fallback", bool(self.fallback))
        object.__setattr__(self, "quarantine", bool(self.quarantine))
        object.__setattr__(self, "residual_tol", float(self.residual_tol))
        if not self.residual_tol > 0.0:
            raise ValueError(
                f"residual_tol={self.residual_tol} must be positive (the P4 "
                f"repair leaves residuals ~1e-7; a zero tolerance would fire "
                f"the fallback every round)"
            )

    @property
    def admits(self) -> bool:
        """True when the spec demotes anyone (admission or quarantine)."""
        return self.energy_cap is not None or self.gain_floor is not None or self.quarantine

    def to_dict(self) -> Dict[str, Any]:
        """The reference's payload: default knobs are omitted."""
        d: Dict[str, Any] = {}
        if self.energy_cap is not None:
            d["energy_cap"] = self.energy_cap
        if self.gain_floor is not None:
            d["gain_floor"] = self.gain_floor
        if not self.fallback:
            d["fallback"] = False
        if not self.quarantine:
            d["quarantine"] = False
        if self.residual_tol != DEFAULT_RESIDUAL_TOL:
            d["residual_tol"] = self.residual_tol
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GuardSpec":
        return cls(
            energy_cap=d.get("energy_cap"),
            gain_floor=d.get("gain_floor"),
            fallback=bool(d.get("fallback", True)),
            quarantine=bool(d.get("quarantine", True)),
            residual_tol=float(d.get("residual_tol", DEFAULT_RESIDUAL_TOL)),
        )
