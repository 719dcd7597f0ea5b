"""Guarded OCEAN execution (port of ``repro.guard``): bounded-energy
admission, the solver fallback and stream quarantine (``GuardSpec``, on
``OceanConfig.guard`` / ``Scenario.guard`` / ``GridEngine(guard=)``), the
eager stream screen, and the fault-injection harness that exercises them."""
from repro_torch.guard.chaos import (
    FAULT_KINDS,
    QUARANTINE_KINDS,
    FaultReport,
    inject_h2_faults,
    register_chaos_solver,
    starved_newton_budgets,
)
from repro_torch.guard.screen import screen_streams
from repro_torch.guard.spec import DEFAULT_RESIDUAL_TOL, GuardSpec

__all__ = [
    "DEFAULT_RESIDUAL_TOL",
    "FAULT_KINDS",
    "QUARANTINE_KINDS",
    "FaultReport",
    "GuardSpec",
    "inject_h2_faults",
    "register_chaos_solver",
    "screen_streams",
    "starved_newton_budgets",
]
