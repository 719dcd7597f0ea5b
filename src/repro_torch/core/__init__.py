"""OCEAN's core (port of ``repro.core``): physics, P4/P3 solvers, Alg. 1."""
from repro_torch.core.energy import RadioParams, energy
from repro_torch.core.ocean import (
    OceanConfig,
    OceanState,
    RoundDecision,
    init_state,
    ocean_round,
    simulate,
    v_schedule,
)
from repro_torch.core.policy import PolicyParams, PolicyTrace, run_policy
from repro_torch.core.scenario import Scenario, paper_scenarios
from repro_torch.core.selection import ocean_p

__all__ = [
    "OceanConfig",
    "OceanState",
    "PolicyParams",
    "PolicyTrace",
    "RadioParams",
    "RoundDecision",
    "Scenario",
    "energy",
    "init_state",
    "ocean_p",
    "ocean_round",
    "paper_scenarios",
    "run_policy",
    "simulate",
    "v_schedule",
]
