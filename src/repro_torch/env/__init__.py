"""Wireless-environment processes (port of ``repro.env``): channel gains,
budget increments, radio physics and delivery failures, each lowered to
one parameter record per process family and sampled from
``torch.Generator`` streams keyed by seed and content salt."""
from repro_torch.env.channel import (
    ChannelParams,
    ChannelProcess,
    LowerCtx,
    available_channel_processes,
    get_channel_process,
    register_channel_process,
    sample_channel_process,
)
from repro_torch.env.energy import (
    BudgetParams,
    BudgetProcess,
    available_budget_processes,
    get_budget_process,
    register_budget_process,
    sample_budget_process,
)
from repro_torch.env.failure import (
    FailureParams,
    FailureProcess,
    TracedFailure,
    available_failure_processes,
    get_failure_process,
    register_failure_process,
    sample_failure_process,
    traced_failure,
)
from repro_torch.env.radio import (
    RadioProcess,
    RadioProcessParams,
    TracedRadio,
    available_radio_processes,
    get_radio_process,
    register_radio_process,
    sample_radio_process,
    traced_radio,
)
from repro_torch.env.spec import (
    EnvSpec,
    LoweredEnv,
    cell_generator,
    env_cell_keys,
    env_key_salt,
    failure_cell_key,
    lower_env,
    radio_cell_key,
)

__all__ = [
    "BudgetParams", "BudgetProcess", "ChannelParams", "ChannelProcess", "EnvSpec",
    "FailureParams", "FailureProcess", "LowerCtx", "LoweredEnv", "RadioProcess",
    "RadioProcessParams", "TracedFailure", "TracedRadio", "available_budget_processes",
    "available_channel_processes", "available_failure_processes",
    "available_radio_processes", "cell_generator", "env_cell_keys", "env_key_salt",
    "failure_cell_key", "get_budget_process", "get_channel_process",
    "get_failure_process", "get_radio_process", "lower_env", "radio_cell_key",
    "register_budget_process", "register_channel_process", "register_failure_process",
    "register_radio_process", "sample_budget_process", "sample_channel_process",
    "sample_failure_process", "sample_radio_process", "traced_failure", "traced_radio",
]
