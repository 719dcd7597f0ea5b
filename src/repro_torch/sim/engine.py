"""Scenario-grid engine — port of ``repro.sim.engine``.

The grid is (policy, scenario, seed).  The JAX engine vmaps over the
scenario and seed axes; here the (scenario, seed) cells are flattened into
one leading cell axis C = S * N (scenario-major) and every policy runs as
ONE call over all cells — under ``traj="fused"`` an OCEAN policy is one
launch of kernel K3.  Scenario statics that shape the program (T, K, frame
length, solver, ranking, top_m, block_k, traj, failure_mode, guard) must
agree across the grid, as ``_check_compatible`` demands in the reference;
so must the telemetry spec (``metrics``), which shapes the outputs, and the
checkpoint spec (``checkpoint``).

Preemption safety (``checkpoint=``, a ``repro_torch.checkpoint.
CheckpointSpec``): ``run`` then executes the grid as segments of
``every_rounds`` rounds — each policy's ``seg_fn`` once per segment over
all cells, on ``traj="fused"`` one K3 segment launch per OCEAN policy —
and snapshots every policy's carry and the trace prefix at each boundary.
``run(resume_from=...)`` restores the latest snapshot and continues; the
environment is sampled again from the seeds, never snapshotted.  Both the
segmented and the resumed run equal the single-call run bit for bit;
``checkpoint=None`` keeps the single-call path.

Environments: every scenario's ``EnvSpec`` is lowered once
(``repro_torch.env``).  Each seed's fading uniforms come from a
``torch.Generator`` seeded with the seed and shared by every scenario (the
reference shares its fading key the same way); the environment, budget,
radio and failure streams come from CPU generators seeded by (seed,
content salt, stream), so adding, removing or reordering scenarios never
changes another cell's draws.  A grid whose scenarios all share one static
radio passes it as scalars (the paper's §VI grid keeps K3's scalar-radio
instance); any other grid passes per-cell (C, T) radio leaves.  A grid with
a failure process in any scenario passes every cell's (T, K) delivery mask
and (K,) declared rates (all ones in failure-free cells).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core.ocean import (
    OceanConfig,
    concat_rounds,
    latest_snapshot_round,
    not_ported,
    resume_directory,
    traces_like,
)
from repro_torch.core.policy import (
    Policy,
    PolicyParams,
    PolicyTrace,
    get_policy,
    resolve_params,
)
from repro_torch.core.scenario import Scenario
from repro_torch.obs.metrics import MetricsSpec, MetricsState, finalize_metrics
from repro_torch.obs.spans import trace_span
from repro_torch.env.channel import (
    ChannelDraws,
    channel_draws,
    needs_env_stream,
    sample_channel_cells,
    uniform_fade,
)
from repro_torch.env.energy import (
    budget_draws,
    needs_budget_stream,
    sample_budget_cells,
)
from repro_torch.env.failure import (
    FailureDraws,
    TracedFailure,
    failure_draws,
    is_active,
    sample_failure_cells,
)
from repro_torch.env.radio import (
    TracedRadio,
    is_modulated,
    radio_draws,
    sample_radio_cells,
)
from repro_torch.env.spec import (
    cell_generator,
    env_cell_keys,
    failure_cell_key,
    radio_cell_key,
)

PolicySpec = Union[str, Policy, Tuple[Union[str, Policy], PolicyParams]]


class GridResult(NamedTuple):
    """Stacked outputs of one grid sweep; leading axes (P, S, N)."""

    a: torch.Tensor             # (P, S, N, T, K) bool selections
    b: torch.Tensor             # (P, S, N, T, K) bandwidth ratios
    e: torch.Tensor             # (P, S, N, T, K) per-round energy
    num_selected: torch.Tensor  # (P, S, N, T) int32
    energy_spent: torch.Tensor  # (P, S, N, K) per-client totals over T
    h2: torch.Tensor            # (S, N, T, K) sampled channel power gains
    history: None
    policies: Tuple[str, ...]
    scenarios: Tuple[str, ...]
    seeds: Tuple[int, ...]
    budget_inc: Optional[torch.Tensor] = None    # (S, N, T, K)
    budget_total: Optional[torch.Tensor] = None  # (S, N, K)
    radio_seq: Optional[TracedRadio] = None      # (S, N, T) leaves
    # With a failure process in the grid: (P, S, N, T, K) selected and
    # delivered (a policy without failure semantics reports its
    # selections), and the realized streams, (S, N, T, K) masks and
    # (S, N, K) declared rates; None otherwise.
    delivered: Optional[torch.Tensor] = None
    failure_seq: Optional[TracedFailure] = None
    # The queues each round's P3 saw, (P, S, N, T, K) (zeros for policies
    # without queues): not in the reference's result; lets a run be
    # replayed against the plain path.
    q: Optional[torch.Tensor] = None
    # Telemetry with a MetricsSpec: one entry per policy-axis index (None for
    # a policy without queues), each a dict of "<collector>/<reduction>" ->
    # (S, N, ...) tensors; a tuple, since a policy name may repeat.  None
    # when the grid ran without a spec.
    metrics: Optional[Tuple[Optional[Dict[str, torch.Tensor]], ...]] = None

    def cell(self, policy: str, scenario: str, seed: int) -> PolicyTrace:
        """Extract one (policy, scenario, seed) cell as a PolicyTrace."""
        for label, name, axis in (
            ("policy", policy, self.policies),
            ("scenario", scenario, self.scenarios),
        ):
            if axis.count(name) > 1:
                raise ValueError(
                    f"{label} name {name!r} appears {axis.count(name)} times on "
                    f"the {label} axis; index the result arrays positionally"
                )
            if name not in axis:
                raise ValueError(
                    f"unknown {label} {name!r}; this grid's {label} axis: "
                    f"{', '.join(axis)}"
                )
        if seed not in self.seeds:
            raise ValueError(
                f"unknown seed {seed!r}; this grid ran seeds "
                f"{', '.join(str(s) for s in self.seeds)}"
            )
        p = self.policies.index(policy)
        s = self.scenarios.index(scenario)
        n = self.seeds.index(seed)
        mets = None
        if self.metrics is not None and self.metrics[p] is not None:
            mets = {k: v[s, n] for k, v in self.metrics[p].items()}
        return PolicyTrace(
            a=self.a[p, s, n],
            b=self.b[p, s, n],
            e=self.e[p, s, n],
            num_selected=self.num_selected[p, s, n],
            metrics=mets,
            delivered=None if self.delivered is None else self.delivered[p, s, n],
            q=None if self.q is None else self.q[p, s, n],
        )


def _resolve_policy_specs(policies: Sequence[PolicySpec]):
    resolved = []
    for spec in policies:
        if isinstance(spec, tuple):
            name_or_pol, params = spec
        else:
            name_or_pol, params = spec, PolicyParams()
        resolved.append((get_policy(name_or_pol), params))
    return resolved


def _check_compatible(scenarios: Sequence[Scenario]) -> Scenario:
    # radio, environment, budgets and eta may vary per scenario: they are data.
    base = scenarios[0]
    for sc in scenarios[1:]:
        mismatches = [
            f"{field}: {getattr(base, field)!r} != {getattr(sc, field)!r}"
            for field in (
                "num_rounds", "num_clients", "frame_len", "solver",
                "ranking", "top_m", "block_k", "traj", "metrics", "checkpoint",
                "failure_mode", "guard",
            )
            if getattr(base, field) != getattr(sc, field)
        ]
        if mismatches:
            raise ValueError(
                f"scenario {sc.name!r} is grid-incompatible with "
                f"{base.name!r}: these fields shape the program and must "
                f"agree ({'; '.join(mismatches)}); run separate grids"
            )
    return base


def _to(record, device):
    """A parameter record with every leaf on ``device``."""
    return type(record)(*(
        _to(x, device) if isinstance(x, tuple) else x.to(device) for x in record
    ))


@functools.lru_cache(maxsize=64)
def _lowered_on(scenario: Scenario, device: torch.device):
    """A scenario's lowered environment, and its four parameter records with
    a unit cell axis on ``device`` (lowered and moved once, not per grid)."""
    low = scenario.lower_env()
    fields = ("channel", "budget", "radio", "failure")
    return low, tuple(_to(_repeat(getattr(low, f), 1), device) for f in fields)


def _repeat(record, n: int):
    """A parameter record with every leaf repeated for n cells (a new
    leading axis)."""
    return type(record)(*(
        _repeat(x, n) if isinstance(x, tuple) else x.expand((n,) + tuple(x.shape))
        for x in record
    ))


class GridEngine:
    """Sweep (policy, scenario, seed) grids on one device.

    ``solver``/``ranking``/``top_m``/``block_k``/``traj``/``metrics``/
    ``checkpoint``/``guard`` override the scenarios' fields (a
    ``repro_torch.guard.GuardSpec`` guards the OCEAN policies; the baselines
    ignore it, as in the reference).  With a ``repro_torch.obs.MetricsSpec``,
    ``GridResult.metrics`` carries each OCEAN policy's telemetry, recorded
    in its one call over all cells (on ``traj="fused"`` inside K3's one
    launch).  With a ``repro_torch.checkpoint.CheckpointSpec`` the grid runs
    segmented (module docstring); every policy then needs its
    ``seg_init``/``seg_fn`` hooks.  ``experiment`` and ``shard=True`` are
    hooks not ported yet and raise ``NotImplementedError``.
    """

    def __init__(
        self,
        scenarios: Union[Sequence[Scenario], Mapping[str, Scenario]],
        policies: Sequence[PolicySpec],
        *,
        experiment=None,
        solver: Optional[str] = None,
        shard: Optional[bool] = None,
        ranking: Optional[str] = None,
        top_m: Optional[int] = None,
        block_k: Optional[int] = None,
        traj: Optional[str] = None,
        metrics: Optional[MetricsSpec] = None,
        checkpoint=None,
        guard=None,
        device=None,
    ):
        if experiment is not None:
            raise not_ported("GridEngine(experiment=...)")
        if shard:
            raise not_ported("GridEngine(shard=True)")
        if isinstance(scenarios, Mapping):
            scenarios = list(scenarios.values())
        if not scenarios or not policies:
            raise ValueError("need at least one scenario and one policy")
        self.device = resolve_device(device)
        self.scenarios = tuple(scenarios)
        base = _check_compatible(self.scenarios)
        self.cfg: OceanConfig = base.ocean_config()
        overrides = {
            k: v
            for k, v in (
                ("solver", solver), ("ranking", ranking), ("top_m", top_m),
                ("block_k", block_k), ("traj", traj), ("metrics", metrics),
                ("checkpoint", checkpoint), ("guard", guard),
            )
            if v is not None
        }
        if overrides:
            self.cfg = dataclasses.replace(self.cfg, **overrides)
        self._resolved = _resolve_policy_specs(policies)
        self.policies = tuple(pol.name for pol, _ in self._resolved)
        if self.cfg.checkpoint is not None:
            self._check_segment_hooks()
        self._lowered = [_lowered_on(sc, self.device)[0] for sc in self.scenarios]
        specs = [sc.env_spec() for sc in self.scenarios]
        # one static radio everywhere: the scalar path (K3's scalar-radio
        # instance); otherwise every cell carries (T,) radio leaves
        self.scalar_radio = (
            all(sp.radio == "static" for sp in specs)
            and len({sc.radio for sc in self.scenarios}) == 1
        )
        self.has_failure = any(sp.failure != "none" for sp in specs)

    # -- environment sampling ---------------------------------------------
    def sample_env(self, seeds: Sequence[int]):
        """Every (scenario, seed) cell's streams, scenario-major on the device:
        h2 (S, N, T, K), budget increments (S, N, T, K) and totals (S, N, K),
        radio (``TracedRadio`` of (S, N, T) leaves, or None on the scalar
        path) and failure (``TracedFailure``, or None without failures).
        Streams that draw are sampled on the CPU from their cells'
        generators and moved; the rest are the lowered constants, expanded
        on the device."""
        seeds = tuple(int(s) for s in seeds)
        T, K = self.cfg.num_rounds, self.cfg.num_clients
        N, dev = len(seeds), self.device
        fades = []
        for seed in seeds:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            fades.append(uniform_fade(gen, (T, K)))
        fade = torch.stack(fades)                                  # (N, T, K)
        h2, inc, total, radios, fails, rates = [], [], [], [], [], []
        for i, low in enumerate(self._lowered):
            chan, budget, radio, failure = _lowered_on(self.scenarios[i], dev)[1]
            salt = low.key_salt
            keys = [env_cell_keys(seed, salt) for seed in seeds]
            draws = None
            if needs_env_stream(low.channel):
                per = [channel_draws(cell_generator(k[0]), T, K) for k in keys]
                draws = ChannelDraws(*(torch.stack(x) for x in zip(*per)))
            h2.append(sample_channel_cells(chan, fade, draws))
            if needs_budget_stream(low.budget):
                per = [budget_draws(cell_generator(k[1]), T, K) for k in keys]
                bdraws = tuple(torch.stack(x) for x in zip(*per))
                dh, tot = (x.to(dev) for x in sample_budget_cells(_repeat(low.budget, 1), bdraws))
            else:
                dh, tot = sample_budget_cells(budget, None)
            inc.append(dh.expand(N, T, K))
            total.append(tot.expand(N, K))
            if not self.scalar_radio:
                if is_modulated(low.radio):
                    rdraws = torch.stack([
                        radio_draws(cell_generator(radio_cell_key(seed, salt)), T)
                        for seed in seeds
                    ])
                    r = _to(sample_radio_cells(_repeat(low.radio, 1), rdraws, T), dev)
                else:
                    r = sample_radio_cells(radio, None, T)
                radios.append(r.map(lambda x: x.expand(N, T)))
            if self.has_failure:
                if is_active(low.failure):
                    per = [failure_draws(cell_generator(failure_cell_key(seed, salt)), T, K)
                           for seed in seeds]
                    fdraws = FailureDraws(*(torch.stack(x) for x in zip(*per)))
                    mask = sample_failure_cells(_repeat(low.failure, 1), fdraws, T, K).to(dev)
                else:
                    mask = torch.ones((1, T, K), device=dev)
                fails.append(mask.expand(N, T, K))
                rates.append(failure.rate.expand(N, K))

        radio = None
        if radios:
            radio = TracedRadio(*(torch.stack(list(x)) for x in zip(*radios)))
        failure = None
        if self.has_failure:
            failure = TracedFailure(delivered=torch.stack(fails), rate=torch.stack(rates))
        return torch.stack(h2), torch.stack(inc), torch.stack(total), radio, failure

    def _check_segment_hooks(self) -> None:
        missing = [pol.name for pol, _ in self._resolved if pol.seg_fn is None]
        if missing:
            raise ValueError(
                f"checkpointed (segmented) execution needs seg_init/seg_fn hooks, "
                f"missing for: {', '.join(missing)}; register them or run without "
                f"checkpoint="
            )

    def run(self, seeds: Sequence[int], *, base_key: int = 0,
            resume_from: Union[str, bool, None] = None) -> GridResult:
        """Sweep the grid over ``seeds``: one call per policy over all cells
        (with a checkpoint spec, or when resuming: one per policy and
        segment).

        ``base_key`` seeds the generator of stochastic policies (``pattern``)
        that were given no ``PolicyParams.key``.  ``resume_from`` restores
        the latest committed snapshot before running: ``True`` resumes from
        the ``CheckpointSpec``'s directory, a string names one.  The resumed
        sweep must use the same grid, seeds and keys as the interrupted one
        (a snapshot holds the policies' carries and the trace prefix; the
        environment is sampled again from the seeds).
        """
        seeds = tuple(int(s) for s in seeds)
        cfg, dev = self.cfg, self.device
        S, N, T, K = len(self.scenarios), len(seeds), cfg.num_rounds, cfg.num_clients
        C = S * N
        with trace_span("grid/sample_env"):
            h2, budget_inc, budget_total, radio, failure = self.sample_env(seeds)
        etas = torch.stack([sc.eta_seq(device=dev) for sc in self.scenarios])
        eta_cells = etas[:, None, :].expand(S, N, T).reshape(C, T)
        h2_cells = h2.reshape(C, T, K)
        radio_cells = None if radio is None else radio.map(lambda x: x.reshape(C, T))
        failure_cells = None
        if failure is not None:
            failure_cells = TracedFailure(
                delivered=failure.delivered.reshape(C, T, K), rate=failure.rate.reshape(C, K)
            )

        params = []
        for pol, pp in self._resolved:
            if pol.needs_key and pp.key is None:
                gen = torch.Generator(device=dev)
                gen.manual_seed(int(base_key))
                pp = pp._replace(key=gen)
            params.append(resolve_params(
                pol, cfg, pp,
                scenario_eta=eta_cells,
                scenario_budgets=budget_total.reshape(C, K),
                scenario_budget_seq=budget_inc.reshape(C, T, K),
                scenario_radio_seq=radio_cells,
                scenario_failure_seq=failure_cells,
                device=dev,
            ))
        if resume_from is False:
            resume_from = None
        if cfg.checkpoint is not None or resume_from is not None:
            traces = self._run_segmented(h2_cells, params, resume_from, failure is not None)
        else:
            traces = []
            for (pol, _), pp in zip(self._resolved, params):
                with trace_span(f"grid/policy/{pol.name}"):
                    traces.append(pol.trace_fn(cfg, h2_cells, pp, device=dev))

        def grid(x):
            return torch.stack(x).reshape((len(traces), S, N) + x[0].shape[1:])

        metrics = None
        if any(t.metrics is not None for t in traces):
            metrics = tuple(
                None if t.metrics is None
                else {k: v.reshape((S, N) + v.shape[1:]) for k, v in t.metrics.items()}
                for t in traces
            )

        e = grid([t.e for t in traces])
        delivered = None
        if failure is not None:
            delivered = grid([t.a if t.delivered is None else t.delivered for t in traces])
        return GridResult(
            a=grid([t.a for t in traces]),
            b=grid([t.b for t in traces]),
            e=e,
            num_selected=grid([t.num_selected for t in traces]),
            energy_spent=e.sum(dim=-2),
            h2=h2,
            history=None,
            policies=self.policies,
            scenarios=tuple(sc.name for sc in self.scenarios),
            seeds=seeds,
            budget_inc=budget_inc,
            budget_total=budget_total,
            radio_seq=radio,
            delivered=delivered,
            failure_seq=failure,
            q=grid([torch.zeros_like(t.e) if t.q is None else t.q for t in traces]),
            metrics=metrics,
        )

    # -- segmented (checkpointed) execution -----------------------------------
    def _trace_like(self, carry, C: int, r: int, has_failure: bool) -> PolicyTrace:
        """The template of r rounds of a policy's normalized segment traces
        (``_normalized``); an OCEAN carry with a MetricsState adds its raw
        full traces."""
        from repro_torch.checkpoint import TensorSpec

        K = self.cfg.num_clients
        rows = TensorSpec((C, r, K), torch.float32)
        mask = TensorSpec((C, r, K), torch.bool)
        with_metrics = (isinstance(carry, tuple) and len(carry) == 2
                        and isinstance(carry[1], MetricsState))
        return PolicyTrace(
            a=mask, b=rows, e=rows, num_selected=TensorSpec((C, r), torch.int32),
            metrics=traces_like(self.cfg, C, r) if with_metrics else None,
            delivered=mask if has_failure else None, q=rows,
        )

    @staticmethod
    def _normalized(tr: PolicyTrace, has_failure: bool) -> PolicyTrace:
        """A segment's trace with the fields ``run`` fills anyway: the
        selections as the delivered mask of a policy without one (in a grid
        with failures) and zero queues for a policy without queues."""
        return tr._replace(
            delivered=(tr.a if tr.delivered is None else tr.delivered) if has_failure else None,
            q=torch.zeros_like(tr.e) if tr.q is None else tr.q,
        )

    def _run_segmented(self, h2_cells, params, resume_from, has_failure):
        """Every policy's trace over all cells, run as segments: each
        policy's ``seg_fn`` once per segment, a snapshot of the carries and
        the trace prefix at every boundary, the telemetry finalized once
        from the last carry."""
        from repro_torch.checkpoint import trajectory as ckpt_io

        cfg, dev = self.cfg, self.device
        ckpt_spec = cfg.checkpoint
        C, T = h2_cells.shape[:2]
        every = ckpt_spec.every_rounds if ckpt_spec is not None else T
        self._check_segment_hooks()
        carries = tuple(pol.seg_init(cfg, C, dev) for pol, _ in self._resolved)
        traces = None
        start = 0
        if resume_from is not None:
            directory = resume_directory(ckpt_spec, resume_from)
            r = latest_snapshot_round(directory)
            like = {"carries": carries,
                    "traces": tuple(self._trace_like(c, C, r, has_failure) for c in carries)}
            snap, start = ckpt_io.load_snapshot(directory, like, r, device=dev)
            carries, traces = snap["carries"], snap["traces"]
        for t0, t1 in ckpt_io.segment_bounds(T, every, start):
            new_carries, seg = [], []
            for (pol, _), pp, carry in zip(self._resolved, params, carries):
                with trace_span(f"grid/policy/{pol.name}"):
                    carry, tr = pol.seg_fn(cfg, carry, h2_cells, pp, t0, t1 - t0, device=dev)
                new_carries.append(carry)
                seg.append(self._normalized(tr, has_failure))
            carries = tuple(new_carries)
            traces = tuple(seg) if traces is None else tuple(
                concat_rounds([a, b]) for a, b in zip(traces, seg))
            if ckpt_spec is not None:
                ckpt_io.save_snapshot(ckpt_spec, {"carries": carries, "traces": traces}, t1)
        # the OCEAN traces carry raw full traces: finalize each from its
        # last carried MetricsState, once, as the single call does
        return [tr if tr.metrics is None
                else tr._replace(metrics=finalize_metrics(cfg.metrics, cfg, carry[1], tr.metrics))
                for carry, tr in zip(carries, traces)]


def run_grid(
    scenarios,
    policies: Sequence[PolicySpec],
    seeds: Sequence[int],
    *,
    experiment=None,
    solver: Optional[str] = None,
    shard: Optional[bool] = None,
    ranking: Optional[str] = None,
    top_m: Optional[int] = None,
    block_k: Optional[int] = None,
    traj: Optional[str] = None,
    metrics: Optional[MetricsSpec] = None,
    checkpoint=None,
    guard=None,
    base_key: int = 0,
    resume_from: Union[str, bool, None] = None,
    device=None,
) -> GridResult:
    """One-shot convenience wrapper around ``GridEngine``; on the card by default."""
    return GridEngine(
        scenarios, policies, experiment=experiment, solver=solver, shard=shard,
        ranking=ranking, top_m=top_m, block_k=block_k, traj=traj,
        metrics=metrics, checkpoint=checkpoint, guard=guard, device=device,
    ).run(seeds, base_key=base_key, resume_from=resume_from)
