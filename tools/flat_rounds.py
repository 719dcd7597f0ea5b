"""The flat rounds of ``chip_smoke.py``'s ``k3_ranking`` phase, and how far
float32 solvers land from the float64 optimum there.

A flat round (``chip_smoke.FLAT_W_RTOL``) is one where K3 and its plain
round agree on P3 to float32 but their allocations differ by more than
2e-4.  This script finds them on the phase's K = 2048 inputs and reads, per
round, the max |b - b64| of every float32 answer it can get against the
float64 optimum b64 (the plain bisect solver, 60 halvings):

    python3 tools/flat_rounds.py probe [--out FILE]

on one card: K3 (each top-m instance), its plain round, and K1 (the CUDA
kernel and its plain version) at 12 x 9, 20 x 15 and 40 x 40 Newton steps;
it writes the rounds' inputs and answers to FILE (default
``chiprun_out/flat_rounds.npz``).  Then, on the CPU, beside the JAX
reference:

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/flat_rounds.py reference FILE

reads the reference's own float32 solvers (``pallas``, ``newton``,
``bisect`` under top-m, and its top-m oracle ``ocean_p_topm_ref``) on the
same rounds.  Each prints one JSON line per solver.
"""
import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOLVERS = ("pallas", "newton", "pallas_tiled")
BUDGETS = ((12, 9), (20, 15), (40, 40))
TOP_M = 128
SHAPE = (2048, 16, 40)  # K, cells, rounds: the phase's
DEVICE = "cuda"


def probe(out_path):
    import numpy as np
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core.selection import ocean_p, prefix_inputs, priorities
    from repro_torch.kernels import _build
    from repro_torch.kernels.ocean_p import ocean_p_prefixes_fused
    from repro_torch.kernels.ocean_traj import ocean_traj, rounds_alone

    dev = torch.device(DEVICE)
    if dev.type == "cuda":
        _build.build(["ocean_p", "ocean_traj", "ocean_traj_grid"])
    K, C, T = SHAPE
    cfg, h2, v, eta, inc = cs._k3_ranked_inputs(torch, np, dev, C, T, K, seed=K)
    s = ocean_traj(cfg, h2, v, eta, inc)
    saved = {"model_bits": cfg.radio.model_bits, "b_min": cfg.radio.b_min}
    for solver in SOLVERS:
        rc = dataclasses.replace(cfg, solver=solver, ranking="topm", top_m=TOP_M)
        got = rounds_alone(rc, s.q_pre, h2, v, eta, inc)
        pl = cs._plain_rounds(torch, rc, s.q_pre, h2, v, eta, inc)
        v_eta = (v * eta).reshape(-1)
        near = cs._near_rounds(torch, got.rho.reshape(-1, K), v_eta, rc.radio, n_cands=TOP_M)
        rel = (got.obj.reshape(-1) - pl["objective"]).abs() / (pl["objective"].abs() + v_eta)
        db = (got.b.reshape(-1, K) - pl["b"]).abs().amax(1)
        rows = (~near & (db > cs.B_ATOL) & (rel <= cs.FLAT_W_RTOL)).nonzero().reshape(-1)
        line = {"solver": solver, "rounds": rows.tolist()}
        if len(rows):
            line.update(cs._flat_witness(torch, rc, rows, got, pl, s.q_pre, h2, v, eta))
            t = rows % T
            q = s.q_pre.reshape(-1, K)[rows]
            q = torch.where(((t > 0) & (t % rc.R == 0))[:, None], torch.zeros_like(q), q)
            hh, vv, ee = h2.reshape(-1, K)[rows], v.reshape(-1)[rows], eta.reshape(-1)[rows]
            b64 = ocean_p(q.double(), hh.double(), vv.double(), ee.double(), rc.radio,
                          solver="bisect", ranking="topm", top_m=TOP_M,
                          outer_iters=cs.FLAT_ITERS, inner_iters=cs.FLAT_ITERS).b
            order, rho_sorted, n0, delta = prefix_inputs(priorities(q, hh), rc.radio)
            for outer, inner in BUDGETS:
                for plain in (False, True):
                    sol = ocean_p_prefixes_fused(rho_sorted, n0, delta, vv * ee, rc.radio,
                                                 outer_iters=outer, inner_iters=inner,
                                                 n_cands=TOP_M, plain=plain)
                    b0 = rc.radio.b_min + torch.where(sol.m_star == 0, delta, 0.0) / n0.clamp(min=1)
                    b = torch.where(rho_sorted <= 1e-30, b0[:, None], sol.b_pos_sorted)
                    b = torch.zeros_like(b).scatter_(1, order, b)
                    key = f"k1{'_plain' if plain else ''}_{outer}x{inner}_b_off"
                    line[key] = (b.double() - b64).abs().amax(1).tolist()
            for name, x in (("q", q), ("h2", hh), ("v", vv), ("eta", ee), ("b64", b64),
                            ("b_kernel", got.b.reshape(-1, K)[rows]), ("b_plain", pl["b"][rows])):
                saved[f"{solver}_{name}"] = x.cpu().numpy()
        print(json.dumps(line), flush=True)
    pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, **saved)


def reference(path):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core.energy import RadioParams
    from repro.core.selection import ocean_p
    from repro.kernels.ref import ocean_p_topm_ref

    d = np.load(path)
    radio = RadioParams(b_min=float(d["b_min"]), model_bits=float(d["model_bits"]))
    for solver in SOLVERS:
        if f"{solver}_q" not in d:
            continue
        args = [jnp.asarray(d[f"{solver}_{k}"]) for k in ("q", "h2", "v", "eta")]
        b64 = d[f"{solver}_b64"]
        line = {"solver": solver}
        runs = {f"ref_{name}": jax.vmap(lambda q, h, v, e, name=name: ocean_p(
            q, h, v, e, radio, solver=name, ranking="topm", top_m=TOP_M))(*args)
            for name in ("pallas", "newton", "bisect")}
        runs["ref_topm_oracle"] = jax.vmap(
            lambda q, h, v, e: ocean_p_topm_ref(q, h, v, e, radio))(*args)
        for name, sol in runs.items():
            b = np.asarray(sol.b, np.float64)
            line[f"{name}_b_off"] = np.abs(b - b64).max(1).tolist()
            for side in ("kernel", "plain"):
                line[f"{name}_vs_{side}"] = np.abs(b - d[f"{solver}_b_{side}"]).max(1).tolist()
        print(json.dumps(line), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("probe")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "flat_rounds.npz"))
    r = sub.add_parser("reference")
    r.add_argument("path")
    a = ap.parse_args(argv)
    probe(a.out) if a.mode == "probe" else reference(a.path)


if __name__ == "__main__":
    main()
