"""OCEAN's core (port of ``repro.core``): physics, P4/P3 solvers, Alg. 1,
the paper's baselines, policies and scenarios."""
from repro_torch.core.baselines import (
    PolicyTrace,
    amo,
    amo_segment,
    delivered_utility,
    lookahead_dual,
    select_all,
    smo,
    utility,
)
from repro_torch.core.energy import RadioParams, energy
from repro_torch.core.ocean import (
    FAILURE_MODES,
    OceanConfig,
    OceanState,
    RoundDecision,
    init_state,
    ocean_round,
    simulate,
    v_schedule,
)
from repro_torch.core.policy import (
    Policy,
    PolicyParams,
    available_policies,
    get_policy,
    pattern_trace,
    register_policy,
    run_policy,
)
from repro_torch.core.scenario import Scenario, environment_zoo, paper_scenarios
from repro_torch.core.selection import ocean_p
from repro_torch.env.radio import TracedRadio, traced_radio
from repro_torch.env.spec import EnvSpec

__all__ = [
    "EnvSpec",
    "FAILURE_MODES",
    "OceanConfig",
    "OceanState",
    "Policy",
    "PolicyParams",
    "PolicyTrace",
    "RadioParams",
    "RoundDecision",
    "Scenario",
    "TracedRadio",
    "amo",
    "amo_segment",
    "available_policies",
    "delivered_utility",
    "energy",
    "environment_zoo",
    "get_policy",
    "init_state",
    "lookahead_dual",
    "ocean_p",
    "ocean_round",
    "paper_scenarios",
    "pattern_trace",
    "register_policy",
    "run_policy",
    "select_all",
    "simulate",
    "smo",
    "traced_radio",
    "utility",
    "v_schedule",
]
