"""Radio processes — port of ``repro.env.radio``.

Every registered :class:`RadioProcess` lowers a JSON-able parameter dict
to one :class:`RadioProcessParams` record, and one interpreter
(:func:`sample_radio_cells`) realizes per-round radio physics — a
:class:`TracedRadio` of (T,) leaves per cell — so a grid may mix static
cells with spectrum-sharing and deadline-jitter cells.

``static``
    The scenario's ``RadioParams`` as constant sequences.
``spectrum_sharing``
    A reflecting symmetric Markov walk over ``num_levels`` equispaced
    shares of B in ``[share_min, share_max]`` (stationary uniform).
``deadline_jitter``
    tau_t = tau (1 + amp y_t), y_t = rho y_{t-1} + (1 - |rho|) u_t,
    u_t ~ U[-1, 1], inside [tau (1 - amp), tau (1 + amp)].

``beta = L / (tau B)`` and ``energy_scale = tau N0 B`` are *stored*
leaves: a static radio's are computed in Python float and rounded once
to float32 (``traced_radio``), the values the scalar ``RadioParams``
path rounds its Python floats to, so a static ``TracedRadio`` gives that
path's bits; modulated cells derive them in float32 from B_t and tau_t.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.env.channel import LowerCtx, check_spec_keys

# Paper §VI base physics (the defaults of repro_torch.core.energy.RadioParams).
_PAPER_RADIO: Dict[str, float] = dict(
    bandwidth_hz=10e6, noise_w=1e-12, deadline_s=0.3, model_bits=3.4e5, b_min=0.02,
)


class TracedRadio(NamedTuple):
    """Radio physics as float32 tensors: scalars, (T,) sequences, or with
    leading cell axes ((C, T) in a grid; (C,) for one round).

    Duck-type compatible with ``RadioParams``: every consumer reads only
    these attributes (``repro_torch.core.energy.lead`` aligns the leaves
    with the operands).
    """

    bandwidth_hz: torch.Tensor
    noise_w: torch.Tensor
    deadline_s: torch.Tensor
    model_bits: torch.Tensor
    b_min: torch.Tensor
    beta: torch.Tensor          # L / (tau B)
    energy_scale: torch.Tensor  # tau N0 B

    def at(self, t: int) -> "TracedRadio":
        """Round ``t`` of (..., T) leaves."""
        return TracedRadio(*(x[..., t] for x in self))

    def map(self, fn) -> "TracedRadio":
        return TracedRadio(*(fn(x) for x in self))


def _radio_fields(radio: Any) -> Dict[str, float]:
    """Base radio leaves as Python floats (duck-typed; None => paper)."""
    if radio is None:
        return dict(_PAPER_RADIO)
    return {k: float(getattr(radio, k)) for k in _PAPER_RADIO}


def traced_radio(radio: Any = None, num_rounds: Optional[int] = None) -> TracedRadio:
    """A static radio as a ``TracedRadio``: ``beta``/``energy_scale``
    computed in Python float and rounded once to float32; with
    ``num_rounds`` every leaf is a (T,) sequence."""
    f = _radio_fields(radio)
    beta = f["model_bits"] / (f["deadline_s"] * f["bandwidth_hz"])
    energy_scale = f["deadline_s"] * f["noise_w"] * f["bandwidth_hz"]
    vals = (
        f["bandwidth_hz"], f["noise_w"], f["deadline_s"], f["model_bits"], f["b_min"],
        beta, energy_scale,
    )
    shape = () if num_rounds is None else (num_rounds,)
    return TracedRadio(*(torch.full(shape, v, dtype=torch.float32) for v in vals))


class RadioProcessParams(NamedTuple):
    """Unified parameterization of every radio process (float32 tensors)."""

    base: TracedRadio          # (T,) leaves: the static physics
    bw_mod_on: torch.Tensor    # ()  1.0 => Markov bandwidth modulator
    bw_share_min: torch.Tensor
    bw_share_max: torch.Tensor
    bw_p_change: torch.Tensor  # ()  per-round probability of a level move
    bw_levels: torch.Tensor    # ()  number of levels (>= 2)
    tau_mod_on: torch.Tensor   # ()  1.0 => deadline jitter
    tau_amp: torch.Tensor
    tau_rho: torch.Tensor      # ()  AR(1) coherence (0 => i.i.d.)


def _off_mods(base: TracedRadio) -> Dict[str, Any]:
    t = torch.tensor
    return dict(
        base=base, bw_mod_on=t(0.0), bw_share_min=t(1.0), bw_share_max=t(1.0),
        bw_p_change=t(0.0), bw_levels=t(2.0), tau_mod_on=t(0.0), tau_amp=t(0.0),
        tau_rho=t(0.0),
    )


def is_modulated(params: RadioProcessParams) -> bool:
    """Whether these (host) parameters read the radio stream."""
    return bool((params.bw_mod_on > 0).any() or (params.tau_mod_on > 0).any())


def radio_draws(generator: torch.Generator, num_rounds: int) -> torch.Tensor:
    """One cell's radio stream: (2 T + 2,) uniforms — the bandwidth walk's
    and the jitter's per-round draws, then their initial states'."""
    return torch.rand((2 * num_rounds + 2,), generator=generator)


def sample_radio_cells(
    params: RadioProcessParams, draws: Optional[torch.Tensor], num_rounds: int
) -> TracedRadio:
    """(C, T) radio leaves of C cells from stacked parameters (leading cell
    axis) and stacked ``radio_draws``; static cells return ``base`` as it
    is, and ``draws`` may be ``None`` where no cell is modulated."""
    base = params.base
    if draws is None:
        return base
    T = num_rounds
    p = params
    u_bw, u_tau = draws[:, :T], draws[:, T : 2 * T]
    levels = torch.clamp(p.bw_levels, min=2.0)
    level = torch.floor(draws[:, 2 * T] * levels)
    level = torch.clamp(level, torch.zeros_like(levels), levels - 1.0)
    y = 2.0 * draws[:, 2 * T + 1] - 1.0
    shares, scales = [], []
    for t in range(T):
        pc = p.bw_p_change
        move = torch.where(u_bw[:, t] < 0.5 * pc, 1.0, torch.where(u_bw[:, t] < pc, -1.0, 0.0))
        level = torch.minimum(torch.clamp(level + move, min=0.0), levels - 1.0)
        shares.append(p.bw_share_min + (p.bw_share_max - p.bw_share_min) * level / (levels - 1.0))
        y = p.tau_rho * y + (1.0 - torch.abs(p.tau_rho)) * (2.0 * u_tau[:, t] - 1.0)
        scales.append(1.0 + p.tau_amp * y)
    share, scale = torch.stack(shares, 1), torch.stack(scales, 1)

    def c1(x):
        return x[:, None]

    bw = torch.where(c1(p.bw_mod_on) > 0.0, base.bandwidth_hz * share, base.bandwidth_hz)
    tau = torch.where(c1(p.tau_mod_on) > 0.0, base.deadline_s * scale, base.deadline_s)
    modulated = c1((p.bw_mod_on > 0.0) | (p.tau_mod_on > 0.0))
    beta = torch.where(modulated, base.model_bits / (tau * bw), base.beta)
    energy_scale = torch.where(modulated, tau * base.noise_w * bw, base.energy_scale)
    return TracedRadio(
        bandwidth_hz=bw, noise_w=base.noise_w, deadline_s=tau, model_bits=base.model_bits,
        b_min=base.b_min, beta=beta, energy_scale=energy_scale,
    )


def sample_radio_process(
    params: RadioProcessParams, generator: torch.Generator, num_rounds: int
) -> TracedRadio:
    """(T,) radio sequences of one cell."""
    stacked = RadioProcessParams(
        base=params.base.map(lambda x: x[None]), **{
            f: getattr(params, f)[None] for f in RadioProcessParams._fields[1:]
        }
    )
    draws = radio_draws(generator, num_rounds)[None] if is_modulated(params) else None
    return sample_radio_cells(stacked, draws, num_rounds).map(lambda x: x[0])


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
RadioLowerFn = Callable[[Mapping[str, Any], LowerCtx], RadioProcessParams]
MeanFn = Callable[[Mapping[str, Any], LowerCtx], float]


class RadioProcess(NamedTuple):
    name: str
    lower: RadioLowerFn
    mean_bandwidth: Optional[MeanFn] = None
    mean_deadline: Optional[MeanFn] = None
    doc: str = ""


_RADIO_REGISTRY: Dict[str, RadioProcess] = {}


def register_radio_process(
    name: str, lower: RadioLowerFn, *, mean_bandwidth: Optional[MeanFn] = None,
    mean_deadline: Optional[MeanFn] = None, doc: str = "",
) -> RadioProcess:
    proc = RadioProcess(name, lower, mean_bandwidth, mean_deadline, doc)
    _RADIO_REGISTRY[name] = proc
    return proc


def available_radio_processes() -> Tuple[str, ...]:
    return tuple(sorted(_RADIO_REGISTRY))


def get_radio_process(name: str) -> RadioProcess:
    if name not in _RADIO_REGISTRY:
        raise ValueError(
            f"unknown radio process {name!r}; available: "
            f"{', '.join(available_radio_processes())}"
        )
    return _RADIO_REGISTRY[name]


def _validate_base(name: str, ctx: LowerCtx) -> Dict[str, float]:
    """The base radio's validation (``RadioParams.validate``, duck-typed)."""
    f = _radio_fields(ctx.radio)
    validate = getattr(ctx.radio, "validate", None)
    if validate is not None:
        try:
            validate(ctx.num_clients)
        except ValueError as e:
            raise ValueError(f"radio process {name!r}: {e}") from None
    return f


def _base_seq(ctx: LowerCtx) -> TracedRadio:
    return traced_radio(ctx.radio, num_rounds=ctx.num_rounds)


def _static_lower(spec, ctx):
    check_spec_keys("static", spec, ())
    _validate_base("static", ctx)
    return RadioProcessParams(**_off_mods(_base_seq(ctx)))


def _spectrum_lower(spec, ctx):
    check_spec_keys("spectrum_sharing", spec, ("share_min", "share_max", "p_change", "num_levels"))
    f = _validate_base("spectrum_sharing", ctx)
    share_min = float(spec.get("share_min", 0.5))
    share_max = float(spec.get("share_max", 1.0))
    p_change = float(spec.get("p_change", 0.5))
    num_levels = int(spec.get("num_levels", 5))
    if not 0.0 < share_min <= share_max:
        raise ValueError(
            f"spectrum_sharing needs 0 < share_min <= share_max, got "
            f"share_min={share_min}, share_max={share_max}"
        )
    if not 0.0 <= p_change <= 1.0:
        raise ValueError(
            f"spectrum_sharing p_change must be a probability in [0, 1], got {p_change}"
        )
    if num_levels < 2:
        raise ValueError(f"spectrum_sharing num_levels must be >= 2, got {num_levels}")
    if share_min * f["bandwidth_hz"] <= 0.0:
        raise ValueError("spectrum_sharing: share_min * bandwidth_hz must be > 0")
    fields = _off_mods(_base_seq(ctx))
    fields.update(
        bw_mod_on=torch.tensor(1.0), bw_share_min=torch.tensor(share_min),
        bw_share_max=torch.tensor(share_max), bw_p_change=torch.tensor(p_change),
        bw_levels=torch.tensor(float(num_levels)),
    )
    return RadioProcessParams(**fields)


def _spectrum_mean_bandwidth(spec, ctx):
    f = _radio_fields(ctx.radio)
    share_min = float(spec.get("share_min", 0.5))
    share_max = float(spec.get("share_max", 1.0))
    return f["bandwidth_hz"] * 0.5 * (share_min + share_max)


def _jitter_lower(spec, ctx):
    check_spec_keys("deadline_jitter", spec, ("amp", "rho"))
    _validate_base("deadline_jitter", ctx)
    amp = float(spec.get("amp", 0.3))
    rho = float(spec.get("rho", 0.0))
    if not 0.0 <= amp < 1.0:
        raise ValueError(f"deadline_jitter amp must be in [0, 1) so tau stays positive, got {amp}")
    if not abs(rho) < 1.0:
        raise ValueError(f"deadline_jitter AR(1) coherence rho must satisfy |rho| < 1, got {rho}")
    fields = _off_mods(_base_seq(ctx))
    fields.update(
        tau_mod_on=torch.tensor(1.0), tau_amp=torch.tensor(amp), tau_rho=torch.tensor(rho)
    )
    return RadioProcessParams(**fields)


def _base_mean_bandwidth(spec, ctx):
    return _radio_fields(ctx.radio)["bandwidth_hz"]


def _base_mean_deadline(spec, ctx):
    return _radio_fields(ctx.radio)["deadline_s"]


register_radio_process(
    "static", _static_lower, mean_bandwidth=_base_mean_bandwidth,
    mean_deadline=_base_mean_deadline,
    doc="constant B/tau/N0 (the paper; the scalar RadioParams path's bits)",
)
register_radio_process(
    "spectrum_sharing", _spectrum_lower, mean_bandwidth=_spectrum_mean_bandwidth,
    mean_deadline=_base_mean_deadline,
    doc="bounded Markov modulator on total bandwidth (reflecting level walk)",
)
register_radio_process(
    "deadline_jitter", _jitter_lower, mean_bandwidth=_base_mean_bandwidth,
    mean_deadline=_base_mean_deadline,
    doc="i.i.d./AR(1) per-round deadline tau_t in [tau(1-amp), tau(1+amp)]",
)
