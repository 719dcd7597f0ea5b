"""Channel processes — port of ``repro.env.channel``.

Every registered :class:`ChannelProcess` lowers a JSON-able parameter dict
to one shared :class:`ChannelParams` record of float32 tensors, and one
interpreter (:func:`sample_channel_cells`) turns stacked parameters into
(C, T, K) channel power gains for C cells at once, so a grid may mix
processes freely.

Processes
---------
``iid_rayleigh``
    The paper's block fading: ``h^2 = g * X`` with ``X ~ Exp(1)`` redrawn
    every round around the scheduled mean path loss.
``gauss_markov``
    AR(1)-correlated fading with per-client coherence ``rho`` through a
    Gaussian copula (the marginal stays Exp(1)); ``rho = 0`` uses the
    i.i.d. stream as it is.
``markov_shadowing``
    A LOS/NLOS blockage chain (extra NLOS loss in dB) on top of the
    fading, started from its stationary distribution.
``mobility``
    Random-waypoint clients; distance-based log path loss.

Randomness comes in two streams, as in the reference: the *fading*
stream (the Exp(1) draw, one ``torch.Generator`` per seed shared by every
scenario, as ``repro_torch.core.channel.rayleigh_power`` draws it) and
the *environment* stream (chain, waypoints, initial states), from a
generator seeded by the seed and the scenario's content salt
(``repro_torch.env.spec``).  ``torch.Generator`` cannot reproduce JAX's
threefry bits, so the draws match the reference in distribution; every
deterministic part (the schedule, the lowered parameters) matches it
exactly.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def pathloss_to_gain(pl_db) -> torch.Tensor:
    """Mean channel power gain g = 10^{-PL_dB/10} (float32)."""
    pl = torch.as_tensor(pl_db, dtype=torch.float32)
    # float64 then one rounding: float32 pow differs in the last bit with
    # an element's position in the tensor on the CPU.
    return torch.pow(10.0, (-pl / 10.0).double()).to(torch.float32)


def pathloss_schedule(start_db: float, end_db: float, num_rounds: int, device=None) -> torch.Tensor:
    """(T,) scheduled mean path loss; equal endpoints => constant."""
    if start_db == end_db:
        return torch.full((num_rounds,), start_db, dtype=torch.float32, device=device)
    frac = torch.arange(num_rounds, dtype=torch.float32, device=device) / max(
        num_rounds - 1, 1
    )
    return start_db + (end_db - start_db) * frac


def uniform_fade(generator: torch.Generator, shape) -> torch.Tensor:
    """The fading stream's uniforms on [1e-6, 1), on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return 1e-6 + u * (1.0 - 1e-6)


class LowerCtx(NamedTuple):
    """Static scenario facts a lowering may fall back on (as in the
    reference); ``radio`` is any object with the ``RadioParams``
    attributes, ``None`` meaning the paper's §VI physics."""

    num_rounds: int
    num_clients: int
    pathloss_db: Tuple[float, float] = (36.0, 36.0)
    fading: bool = True
    budgets_j: Tuple[float, ...] = (0.15,)
    radio: Any = None


class ChannelParams(NamedTuple):
    """Unified parameterization of every channel process (float32 tensors;
    "off" features are zeros, never other structures)."""

    sched_pl_db: torch.Tensor     # (T,) scheduled mean path loss
    sched_gain: torch.Tensor      # (T,) 10^{-pl/10}, computed at lowering
    fading_on: torch.Tensor       # ()  1.0 => Exp(1) power fading
    rho: torch.Tensor             # (K,) AR(1) fading coherence; 0 => i.i.d.
    shadow_on: torch.Tensor       # ()  1.0 => LOS/NLOS chain
    shadow_p_enter: torch.Tensor  # ()  P(LOS -> NLOS) per round
    shadow_p_exit: torch.Tensor   # ()  P(NLOS -> LOS) per round
    shadow_db: torch.Tensor       # ()  extra path loss while blocked (dB)
    mobility_on: torch.Tensor     # ()  1.0 => distance-based path loss
    area_m: torch.Tensor          # ()  clients roam [-area, area]^2
    speed_min: torch.Tensor       # ()  m/s
    speed_max: torch.Tensor       # ()
    round_s: torch.Tensor         # ()  seconds per round
    pl_exp: torch.Tensor          # ()  path-loss exponent
    pl_ref_db: torch.Tensor       # ()  path loss at the reference distance
    d_ref_m: torch.Tensor         # ()  reference (and minimum) distance


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _validate_rho(rho) -> None:
    """|rho| < 1, else sqrt(1 - rho^2) silently NaNs every gain."""
    vals = np.atleast_1d(np.asarray(rho, np.float64))
    if not np.all(np.isfinite(vals)) or np.any(np.abs(vals) >= 1.0):
        raise ValueError(f"fading coherence rho must satisfy |rho| < 1, got {rho!r}")


def _validate_prob(name: str, p: float) -> None:
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"{name} must be a probability in [0, 1], got {p}")


def check_spec_keys(process: str, spec: Mapping[str, Any], allowed) -> None:
    """Reject unknown parameter keys so typos fail fast."""
    unknown = sorted(set(spec) - set(allowed))
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {unknown} for process {process!r}; "
            f"allowed: {', '.join(sorted(allowed))}"
        )


_BASE_KEYS = ("pathloss_db", "fading")

_OFF = dict(
    fading_on=1.0, shadow_on=0.0, shadow_p_enter=0.0, shadow_p_exit=1.0,
    shadow_db=0.0, mobility_on=0.0, area_m=60.0, speed_min=1.0, speed_max=10.0,
    round_s=1.0, pl_exp=2.0, pl_ref_db=32.0, d_ref_m=10.0,
)


def _base_params(ctx: LowerCtx, spec: Mapping[str, Any], **overrides) -> ChannelParams:
    """Everything-off defaults with the scenario's scheduled path loss."""
    start, end = tuple(spec.get("pathloss_db", ctx.pathloss_db))
    fields: Dict[str, Any] = dict(_OFF)
    fields["fading_on"] = 1.0 if spec.get("fading", ctx.fading) else 0.0
    fields.update(overrides)
    rho = fields.pop("rho", 0.0)
    _validate_rho(rho)
    sched = pathloss_schedule(start, end, ctx.num_rounds)
    return ChannelParams(
        sched_pl_db=sched,
        sched_gain=pathloss_to_gain(sched),
        rho=torch.broadcast_to(_f32(rho), (ctx.num_clients,)).clone(),
        **{k: _f32(v) for k, v in fields.items()},
    )


# --------------------------------------------------------------------------
# the interpreter, batched over a leading cell axis
# --------------------------------------------------------------------------
class ChannelDraws(NamedTuple):
    """One cell's environment-stream draws (leading cell axis when stacked)."""

    u_shadow: torch.Tensor  # (T, K)
    u_wp: torch.Tensor      # (T, K, 3)
    pos0: torch.Tensor      # (K, 2) uniform
    wp0: torch.Tensor       # (K, 2) uniform
    speed0: torch.Tensor    # (K,) uniform
    z0: torch.Tensor        # (K,) standard normal
    s0: torch.Tensor        # (K,) uniform


def needs_env_stream(params: ChannelParams) -> bool:
    """Whether these (host) parameters read the environment stream."""
    return bool(
        (params.rho != 0).any() or (params.shadow_on > 0).any() or (params.mobility_on > 0).any()
    )


def channel_draws(generator: torch.Generator, num_rounds: int, num_clients: int) -> ChannelDraws:
    """Draw one cell's environment stream from ``generator``."""
    T, K = num_rounds, num_clients
    g = generator
    return ChannelDraws(
        u_shadow=torch.rand((T, K), generator=g),
        u_wp=torch.rand((T, K, 3), generator=g),
        pos0=torch.rand((K, 2), generator=g),
        wp0=torch.rand((K, 2), generator=g),
        speed0=torch.rand((K,), generator=g),
        z0=torch.randn((K,), generator=g),
        s0=torch.rand((K,), generator=g),
    )


def sample_channel_cells(
    params: ChannelParams, u_fade: torch.Tensor, draws: Optional[ChannelDraws]
) -> torch.Tensor:
    """(C, T, K) channel power gains of C cells.

    ``params`` leaves carry a leading cell axis C; ``u_fade`` (C, T, K)
    is the fading stream (``uniform_fade``), ``draws`` the stacked
    environment streams, which may be ``None`` where no cell reads them
    (``needs_env_stream``).  Cells whose path loss is the schedule alone
    take the lowered ``sched_gain`` bits, so the i.i.d. Rayleigh process
    gives ``sched_gain * -log(u)``, the port's legacy channel.
    """
    dev = u_fade.device
    p = ChannelParams(*(x.to(dev) for x in params))
    C, T, K = u_fade.shape
    x_iid = -torch.log(u_fade)
    fading = p.fading_on[:, None, None] > 0.0
    if draws is None:
        x = torch.where(fading, x_iid, torch.ones((), device=dev))
        return p.sched_gain[:, :, None] * x
    d = ChannelDraws(*(x.to(dev) for x in draws))
    w_fade = torch.special.ndtri(u_fade)

    def c1(x):  # a per-cell scalar against (C, K)
        return x[:, None]

    area, smin, smax = c1(p.area_m), c1(p.speed_min), c1(p.speed_max)
    pos = (d.pos0 * 2.0 - 1.0) * area[..., None]
    wp = (d.wp0 * 2.0 - 1.0) * area[..., None]
    speed = smin + (smax - smin) * d.speed0
    z = d.z0
    pi_nlos = p.shadow_p_enter / torch.clamp(p.shadow_p_enter + p.shadow_p_exit, min=1e-12)
    s = (d.s0 < c1(pi_nlos)).to(torch.float32)
    rho = p.rho
    exact_sched = c1((p.mobility_on == 0.0) & (p.shadow_on == 0.0))
    out = []
    for t in range(T):
        z = rho * z + torch.sqrt(1.0 - rho**2) * w_fade[:, t]
        u_corr = torch.clamp(torch.special.ndtr(z), 1e-6, 1.0 - 1e-7)
        x = torch.where(rho == 0.0, x_iid[:, t], -torch.log(u_corr))
        x = torch.where(c1(p.fading_on) > 0.0, x, torch.ones((), device=dev))

        p_flip = torch.where(s > 0.0, c1(p.shadow_p_exit), c1(p.shadow_p_enter))
        s = torch.where(d.u_shadow[:, t] < p_flip, 1.0 - s, s)
        extra_db = torch.where(c1(p.shadow_on) > 0.0, s * c1(p.shadow_db), 0.0)

        delta = wp - pos
        dist = torch.sqrt((delta**2).sum(-1))
        step_m = speed * c1(p.round_s)
        arrive = dist <= step_m
        unit = delta / torch.clamp(dist, min=1e-9)[..., None]
        pos = torch.where(arrive[..., None], wp, pos + unit * step_m[..., None])
        u_w = d.u_wp[:, t]
        wp = torch.where(arrive[..., None], (u_w[..., :2] * 2.0 - 1.0) * area[..., None], wp)
        speed = torch.where(arrive, smin + (smax - smin) * u_w[..., 2], speed)
        dd = torch.maximum(torch.sqrt((pos**2).sum(-1)), c1(p.d_ref_m))
        pl_mob = c1(p.pl_ref_db) + 10.0 * c1(p.pl_exp) * torch.log10(dd / c1(p.d_ref_m))

        pl = torch.where(c1(p.mobility_on) > 0.0, pl_mob, c1(p.sched_pl_db[:, t])) + extra_db
        g = torch.where(exact_sched, c1(p.sched_gain[:, t]), pathloss_to_gain(pl).to(dev))
        out.append(g * x)
    return torch.stack(out, dim=1)


def sample_channel_process(
    params: ChannelParams,
    fade_gen: torch.Generator,
    env_gen: torch.Generator,
    num_rounds: int,
    num_clients: int,
) -> torch.Tensor:
    """(T, K) channel power gains of one cell, on ``fade_gen``'s device."""
    u = uniform_fade(fade_gen, (num_rounds, num_clients))[None]
    draws = None
    if needs_env_stream(params):
        draws = ChannelDraws(
            *(x[None] for x in channel_draws(env_gen, num_rounds, num_clients))
        )
    stacked = ChannelParams(*(x[None] for x in params))
    return sample_channel_cells(stacked, u, draws)[0]


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
LowerFn = Callable[[Mapping[str, Any], LowerCtx], ChannelParams]
MeanGainFn = Callable[[Mapping[str, Any], LowerCtx], Optional[torch.Tensor]]


class ChannelProcess(NamedTuple):
    name: str
    lower: LowerFn
    mean_gain: Optional[MeanGainFn] = None
    doc: str = ""


_CHANNEL_REGISTRY: Dict[str, ChannelProcess] = {}


def register_channel_process(
    name: str, lower: LowerFn, *, mean_gain: Optional[MeanGainFn] = None, doc: str = ""
) -> ChannelProcess:
    proc = ChannelProcess(name, lower, mean_gain, doc)
    _CHANNEL_REGISTRY[name] = proc
    return proc


def available_channel_processes() -> Tuple[str, ...]:
    return tuple(sorted(_CHANNEL_REGISTRY))


def get_channel_process(name: str) -> ChannelProcess:
    if name not in _CHANNEL_REGISTRY:
        raise ValueError(
            f"unknown channel process {name!r}; available: "
            f"{', '.join(available_channel_processes())}"
        )
    return _CHANNEL_REGISTRY[name]


def _sched_mean_gain(spec: Mapping[str, Any], ctx: LowerCtx) -> torch.Tensor:
    start, end = tuple(spec.get("pathloss_db", ctx.pathloss_db))
    return pathloss_to_gain(pathloss_schedule(start, end, ctx.num_rounds))


def _iid_lower(spec, ctx):
    check_spec_keys("iid_rayleigh", spec, _BASE_KEYS)
    return _base_params(ctx, spec)


def _gauss_markov_lower(spec, ctx):
    check_spec_keys("gauss_markov", spec, _BASE_KEYS + ("rho",))
    rho = spec.get("rho", 0.9)
    if isinstance(rho, Sequence) and len(rho) != ctx.num_clients:
        raise ValueError(
            f"gauss_markov per-client rho needs {ctx.num_clients} entries, got {len(rho)}"
        )
    return _base_params(ctx, spec, rho=rho)


def _shadowing_lower(spec, ctx):
    check_spec_keys(
        "markov_shadowing", spec, _BASE_KEYS + ("rho", "p_enter", "p_exit", "extra_db")
    )
    p_enter = float(spec.get("p_enter", 0.1))
    p_exit = float(spec.get("p_exit", 0.4))
    _validate_prob("markov_shadowing p_enter", p_enter)
    _validate_prob("markov_shadowing p_exit", p_exit)
    return _base_params(
        ctx, spec, rho=spec.get("rho", 0.0), shadow_on=1.0, shadow_p_enter=p_enter,
        shadow_p_exit=p_exit, shadow_db=float(spec.get("extra_db", 8.0)),
    )


def _shadowing_mean_gain(spec, ctx):
    g = _sched_mean_gain(spec, ctx)
    p_enter = float(spec.get("p_enter", 0.1))
    p_exit = float(spec.get("p_exit", 0.4))
    pi_nlos = p_enter / max(p_enter + p_exit, 1e-12)
    block = float(pathloss_to_gain(float(spec.get("extra_db", 8.0))))
    return g * ((1.0 - pi_nlos) + pi_nlos * block)


def _mobility_lower(spec, ctx):
    check_spec_keys(
        "mobility", spec,
        ("fading", "rho", "area_m", "speed_mps", "round_s", "pl_exp", "pl_ref_db", "d_ref_m"),
    )
    speed = spec.get("speed_mps", (1.0, 10.0))
    if isinstance(speed, (int, float)):
        speed = (float(speed), float(speed))
    if not 0.0 <= float(speed[0]) <= float(speed[1]):
        raise ValueError(f"mobility speed_mps must be 0 <= min <= max, got {speed!r}")
    if float(spec.get("area_m", 60.0)) <= 0 or float(spec.get("d_ref_m", 10.0)) <= 0:
        raise ValueError("mobility area_m and d_ref_m must be positive")
    return _base_params(
        ctx, spec, rho=spec.get("rho", 0.0), mobility_on=1.0,
        area_m=float(spec.get("area_m", 60.0)), speed_min=float(speed[0]),
        speed_max=float(speed[1]), round_s=float(spec.get("round_s", 1.0)),
        pl_exp=float(spec.get("pl_exp", 2.0)), pl_ref_db=float(spec.get("pl_ref_db", 32.0)),
        d_ref_m=float(spec.get("d_ref_m", 10.0)),
    )


register_channel_process(
    "iid_rayleigh", _iid_lower, mean_gain=_sched_mean_gain,
    doc="paper block fading: h^2 = g * Exp(1), i.i.d. per round",
)
register_channel_process(
    "gauss_markov", _gauss_markov_lower, mean_gain=_sched_mean_gain,
    doc="AR(1)-correlated fading, per-client coherence rho (0 => i.i.d.)",
)
register_channel_process(
    "markov_shadowing", _shadowing_lower, mean_gain=_shadowing_mean_gain,
    doc="2-state LOS/NLOS blockage chain layered on the fading",
)
register_channel_process(
    "mobility", _mobility_lower, mean_gain=None,
    doc="random-waypoint trajectories -> distance-based path loss",
)
