"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one; this module imports
no JAX, so it also runs where only PyTorch and the CUDA toolkit are
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances are those of ``chip_smoke.py``: selections exact, b within
2e-4, W within 2e-4 relative, queues within 1e-6 + 1e-5 |q|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.energy import RadioParams  # noqa: E402
from repro_torch.core.ocean import OceanConfig  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402
from repro_torch.core.selection import ocean_p, prefix_inputs, priorities  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ocean_p as tk  # noqa: E402
from repro_torch.kernels import ocean_traj as tt  # noqa: E402

pytestmark = pytest.mark.cuda
B_ATOL, W_RTOL = 2e-4, 2e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _draws(seed, c, k):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.01, 0.2, (c, k)).astype(np.float32)
    q[rng.random((c, k)) < 0.2] = 0.0
    h2 = (rng.uniform(0.5, 2.0, (c, k)) * 2.5e-4).astype(np.float32)
    return torch.tensor(q), torch.tensor(h2)


@pytest.mark.parametrize("k", [10, 100])
def test_k1_matches_plain(dev, k):
    q, h2 = _draws(k, 64, k)
    radio = RadioParams(b_min=min(0.02, 0.5 / k))
    _, rho, n0, delta = prefix_inputs(priorities(q, h2).to(dev), radio)
    scal = tk._scal(n0, delta, torch.full((64,), 1e-5 * k, device=dev), radio, rho)
    before = tk.ocean_p_prefix.launches
    b, wm = tk.ocean_p_prefix(scal, rho)
    b_p, wm_p = tk.ocean_p_prefix_plain(scal, rho)
    torch.cuda.synchronize()
    assert tk.ocean_p_prefix.launches == before + 1
    assert torch.equal(wm[:, 1], wm_p[:, 1]) and (wm[:, 1] > 0).any()
    torch.testing.assert_close(b, b_p, atol=B_ATOL, rtol=0)
    torch.testing.assert_close(wm[:, 0], wm_p[:, 0], rtol=W_RTOL, atol=0)


def _k1_case(dev, seed, c, k, case):
    """Seeded sorted rho and scal for K1, chip_smoke.py's draws: queues and
    gains, a fifth of the queues 0; ``twins`` pairs clients into near-identical
    twins (chip_smoke.draws' tie_eps = 1e-4), ``inf_member`` gives every
    cell one client of rho = +inf (its gain 0), ``no_positive`` zeroes every
    queue (n0 = K)."""
    rng = np.random.default_rng(seed)
    if case == "twins":
        half = (k + 1) // 2
        q = np.repeat(rng.uniform(0.01, 0.2, (c, half)), 2, 1)[:, :k]
        q = q * (1.0 + rng.uniform(-1e-4, 1e-4, (c, k)))
        h2 = np.repeat(rng.uniform(0.5, 2.0, (c, half)), 2, 1)[:, :k] * 2.5e-4
        h2 = h2 * (1.0 + rng.uniform(-1e-4, 1e-4, (c, k)))
    else:
        q = rng.uniform(0.01, 0.2, (c, k))
        h2 = rng.uniform(0.5, 2.0, (c, k)) * 2.5e-4
    q[rng.random((c, k)) < 0.2] = 0.0
    if case == "no_positive":
        q[:] = 0.0
    rho = priorities(torch.tensor(q, dtype=torch.float32), torch.tensor(h2, dtype=torch.float32))
    if case == "inf_member":
        rho[np.arange(c), rng.integers(0, k, c)] = torch.inf
    radio = RadioParams(b_min=min(0.02, 0.5 / k))
    _, rho_s, n0, delta = prefix_inputs(rho.to(dev), radio)
    v_eta = torch.tensor(rng.uniform(0.2, 1.8, c) * 1e-5 * k, dtype=torch.float32, device=dev)
    return tk._scal(n0, delta, v_eta, radio, rho_s), rho_s.contiguous(), n0


@pytest.mark.parametrize("case", ["draws", "twins", "inf_member", "no_positive"])
@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 100])
def test_k1_candidate_edges_match_plain(dev, k, case):
    """K1's warp-per-candidate sweep around a warp's width (K = 31, 32, 33),
    past the warps a block holds (K = 100), and at K = 1, 2; with twin
    clients, a member of rho = +inf (no candidate holding it may win) and
    no positive-rho client (m* = 0): m* exactly the plain version's."""
    scal, rho, n0 = _k1_case(dev, 100 * k + len(case), 48, k, case)
    before = tk.ocean_p_prefix.launches
    b, wm = tk.ocean_p_prefix(scal, rho)
    b_p, wm_p = tk.ocean_p_prefix_plain(scal, rho)
    torch.cuda.synchronize()
    assert tk.ocean_p_prefix.launches == before + 1
    assert torch.equal(wm[:, 1], wm_p[:, 1])
    torch.testing.assert_close(b, b_p, atol=B_ATOL, rtol=0)
    torch.testing.assert_close(wm[:, 0], wm_p[:, 0], rtol=W_RTOL, atol=0)
    if case == "no_positive":
        assert (wm[:, 1] == 0).all() and (b == 0).all()
    if case == "inf_member":  # the +inf client sorts last: m* stops before it
        assert (wm[:, 1] < k - n0.to(torch.float32)).all()


def test_k2_matches_plain_and_the_sorted_sweep(dev):
    """K2 on the ocean_p path against the K1 ranking="topm" path, which
    runs each candidate through the same warp body on the same extracted
    values: equal bits."""
    K = 3000
    q, h2 = (x.to(dev) for x in _draws(5, 2, K))
    radio = RadioParams(b_min=0.1 / K)
    got = ocean_p(q, h2, 1e-5, 1.0, radio, solver="pallas_tiled", ranking="topm", top_m=64)
    ref = ocean_p(q, h2, 1e-5, 1.0, radio, solver="pallas", ranking="topm", top_m=64)
    torch.cuda.synchronize()
    for f in ("a", "num_selected", "b", "objective"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert bool((got.num_selected > (q == 0).sum(1)).all())


def _k2_case(seed, C, K_pad, case, K=None):
    """Client-order K2 inputs (CPU tensors): chip_smoke.py's draws, a fifth
    of the queues 0 (rho = +inf in the row), V*eta log-uniform in [1e-5,
    1e-2] a cell so m* spans 0 to top_m, b_min = 0.1 / K.  Clients past K
    are padding (+inf).  Cases: ``dead_slices`` makes the first 60 % of
    each row +inf (whole CTAs' slices without a finite client);
    ``few_finite`` keeps 20 finite clients a row; ``none_finite`` leaves
    row 0 without any; ``duplicates`` draws rho from 40 values (exact ties
    within and across slices); ``huge_rho`` keeps 40 clients a row and
    gives 5 more rho = 1e30, so candidates holding them cost +inf and W is
    not finite; ``nonfinite_v`` gives cell 0 V*eta = +inf and cell 1 NaN,
    so W(0) itself is not finite."""
    K = K_pad if K is None else K
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.01, 0.2, (C, K_pad))
    q[rng.random((C, K_pad)) < 0.2] = 0.0
    rho = q / (rng.uniform(0.5, 2.0, (C, K_pad)) * 2.5e-4)
    if case == "duplicates":
        rho = np.where(q > 0, rng.uniform(40.0, 800.0, 40)[rng.integers(0, 40, (C, K_pad))], 0.0)
    if case == "dead_slices":
        rho[:, : int(0.6 * K_pad)] = 0.0
    if case in ("few_finite", "huge_rho"):
        keep = np.zeros_like(rho, dtype=bool)
        for row in keep:
            row[rng.choice(K, 45 if case == "huge_rho" else 20, replace=False)] = True
        rho = np.where(keep, np.maximum(rho, 40.0), 0.0)
        if case == "huge_rho":
            for c in range(C):
                rho[c, np.flatnonzero(keep[c])[:5]] = 1e30
    if case == "none_finite":
        rho[0] = 0.0
    rho[:, K:] = 0.0
    rho = torch.tensor(rho, dtype=torch.float32)
    n0 = (rho[:, :K] <= 1e-30).sum(1)
    radio = RadioParams(b_min=0.1 / K)
    v_eta = 10.0 ** rng.uniform(-5.0, -2.0, C)
    if case == "nonfinite_v":
        v_eta[0], v_eta[1] = np.inf, np.nan
    work = torch.where(rho > 1e-30, rho, torch.inf).contiguous()
    delta = 1.0 - n0.to(torch.float32) * radio.b_min
    scal = tk._scal(n0, delta, torch.tensor(v_eta, dtype=torch.float32), radio, work)
    return scal, work, K


def _k1_topm(scal, work, K, top_m):
    """K1 on the extracted row, as ``core.selection``'s ``solver="pallas",
    ranking="topm"`` path runs it: the extracted values at sorted slots
    [n0, n0 + top_m), K1's sweep clipped to top_m candidates, its winner
    scattered back to client order."""
    C, K_pad = work.shape
    vals, idx = tk.extract_min_plain(work, top_m)
    n0 = scal[:, 0].long()
    slots = n0[:, None] + torch.arange(top_m, device=work.device)[None, :]
    buf = torch.full((C, K + top_m), torch.inf, device=work.device)
    buf.scatter_(1, slots, vals)
    b_s, wm = tk.ocean_p_prefix(scal, buf[:, :K].contiguous(), n_cands=min(top_m, K))
    b_c = torch.gather(torch.cat([b_s, torch.zeros_like(vals)], 1), 1, slots)
    sel = torch.arange(top_m, device=work.device)[None, :] < wm[:, 1:]
    zero = torch.zeros((), device=work.device)
    b = torch.zeros_like(work).scatter_add_(1, idx, torch.where(sel, b_c, zero))
    return b, wm


K2_CASES = [
    # C, K_pad, top_m, case, K
    (4, 3000, 1, "draws", None),
    (4, 3000, 31, "draws", None),
    (4, 3000, 32, "draws", None),
    (4, 3000, 33, "draws", None),
    (4, 3000, 128, "draws", None),
    (4, 3000, 129, "draws", None),
    (6, 1001, 64, "draws", None),           # K_pad not a multiple of any R
    (4, 3072, 96, "draws", 3000),           # the fused path's +inf padding
    (6, 2000, 64, "dead_slices", None),
    (6, 2000, 128, "few_finite", None),     # fewer finite clients than top_m
    (3, 500, 64, "none_finite", None),
    (6, 2000, 128, "duplicates", None),
    (4, 300, 300, "draws", None),           # top_m = K_pad
    (2, 200_000, 128, "draws", None),       # slices past one merge buffer
    (1, 10_000, 128, "draws", None),
    (200, 2000, 128, "draws", None),        # more clusters than one wave
    (6, 2000, 128, "huge_rho", None),
    (4, 2000, 64, "nonfinite_v", None),
]


@pytest.mark.parametrize("C,K_pad,top_m,case,K", K2_CASES)
def test_k2_cluster_matches_plain_and_k1(dev, C, K_pad, top_m, case, K):
    """K2's cluster kernel: m* and the selections exactly the plain
    version's, b within B_ATOL, W within W_RTOL; where every candidate's W
    is finite and K1 holds the row (K <= 10^4), b and [W*, m*] equal the
    K1 path's bit for bit.  Where W is not finite (huge_rho, nonfinite_v)
    K2's rule, a non-finite W never wins, is held to the plain version's."""
    scal, work, K = _k2_case(K_pad + top_m + len(case), C, K_pad, case, K)
    scal, work = scal.to(dev), work.to(dev)
    before = tk.ocean_p_topm.launches
    b, wm = tk.ocean_p_topm(scal, work, K=K, top_m=top_m)
    b_p, wm_p = tk.ocean_p_topm_plain(scal, work, K=K, top_m=top_m)
    torch.cuda.synchronize()
    assert tk.ocean_p_topm.launches == before + 1
    assert torch.equal(wm[:, 1], wm_p[:, 1])
    assert torch.equal(b > 0, b_p > 0)
    torch.testing.assert_close(b, b_p, atol=B_ATOL, rtol=0)
    torch.testing.assert_close(wm[:, 0], wm_p[:, 0], rtol=W_RTOL, atol=0)
    if case not in ("huge_rho", "nonfinite_v") and K <= 10_000:
        b1, wm1 = _k1_topm(scal, work, K, top_m)
        torch.cuda.synchronize()
        assert torch.equal(wm, wm1) and torch.equal(b, b1)
    if case == "none_finite":
        assert wm[0, 1] == 0 and not bool(b[0].any())
    if case == "nonfinite_v":
        neg_inf = torch.tensor(tk.NEG_INF, dtype=torch.float32).item()
        assert wm[:2].tolist() == [[neg_inf, 0.0]] * 2
        assert not bool(b[:2].any())
    if case == "huge_rho":  # no candidate holding a client of rho = 1e30 wins
        assert bool((wm[:, 1] <= 40).all()) and not bool(b[work > 1e29].any())
    if case == "draws":
        assert bool((wm[:, 1] > 0).any())


@pytest.mark.parametrize("top_m", [33, 128])
def test_k2_every_cluster_size_gives_the_same_bits(dev, top_m):
    """R = 1 to 16 CTAs a cell: the extraction is exact and each candidate
    is one warp's work wherever it runs, so b and [W*, m*] do not move."""
    scal, work, K = _k2_case(7, 5, 4000, "draws")
    scal, work = scal.to(dev), work.to(dev)
    outs = [tk.ocean_p_topm(scal, work, K=K, top_m=top_m, cluster=R) for R in (1, 2, 4, 8, 16)]
    torch.cuda.synchronize()
    for b, wm in outs[1:]:
        assert torch.equal(b, outs[0][0]) and torch.equal(wm, outs[0][1])


def test_k2_launch_shape_and_shared_bytes(dev):
    """The host's mirror of the kernel's shared bytes, the shape chosen at
    the K = 10^4 path's 8 cells (R = 8, 16 warps: a warp per candidate),
    and a top_m past shared memory refused with a clear error."""
    import ctypes

    lib = _build.load("ocean_p")
    smem = lib.ocean_p_topm_smem_bytes
    smem.restype = ctypes.c_longlong
    for top_m, nw, cap in [(1, 4, 128), (128, 8, 768), (129, 16, 4096), (14504, 1, 46)]:
        assert smem(top_m, nw, cap) == tk.topm_smem_bytes(top_m, nw, cap)
    assert tk.topm_shape(8, 10_112, 128) == tk.TopmShape(8, 16, 1536)
    work = torch.ones((1, 20_000), device=dev)
    scal = torch.zeros((1, 8), device=dev)
    with pytest.raises(ValueError, match="no cluster shape fits"):
        tk.ocean_p_topm(scal, work, K=20_000, top_m=20_000)


def _k3_inputs(dev, seed, C, T, K):
    """chip_smoke.py's K3 draws: exponential gains, the per-round budget
    share, V = 1e-5 and the ascending eta schedule."""
    cfg = OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(b_min=min(0.02, 0.5 / K)),
                      frame_len=13, solver="pallas", traj="fused")
    h2 = torch.tensor(
        np.random.default_rng(seed).exponential(size=(C, T, K)).astype(np.float32) * 2.5e-4,
        device=dev,
    )
    v = torch.full((C, T), 1e-5, device=dev)
    eta = eta_schedule("ascend", T, device=dev).expand(C, T).contiguous()
    inc = torch.full_like(h2, 0.15 / T)
    return cfg, h2, v, eta, inc


@pytest.mark.parametrize("T,K,C", [(40, 6, 8), (3, 700, 2)])
def test_k3_matches_plain(dev, T, K, C):
    """K = 700 sorts 1024 slots, more than one block's threads at K3's
    register count: the loops must stride."""
    cfg, h2, v, eta, inc = _k3_inputs(dev, 3, C, T, K)
    out = tt.ocean_traj(cfg, h2, v, eta, inc)
    plain = tt.ocean_traj_plain(cfg, h2, v, eta, inc)
    torch.cuda.synchronize()
    assert torch.equal(out.a, plain.a) and torch.equal(out.nsel, plain.nsel)
    torch.testing.assert_close(out.b, plain.b, atol=B_ATOL, rtol=0)
    torch.testing.assert_close(out.q_final, plain.q_final, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("T,K,C", [(20, 1, 8), (20, 2, 8), (20, 16, 8), (20, 17, 8), (20, 31, 8),
                                   (20, 32, 8), (20, 33, 8), (20, 100, 8), (2, 2048, 2)])
def test_k3_candidate_parallel_edges_match_plain(dev, T, K, C):
    """K3's teams per candidate around a half warp's width (K = 16: half
    warps, K = 17: whole warps) and a warp's (K = 31, 32, 33: the sort's 32
    slots and past them), past the warps a block holds
    (K = 100), and at K = 2048, where the shared rows cut the block's
    warps below the register file's limit."""
    lib = _build.load("ocean_traj")
    if K == 2048:
        assert lib.ocean_traj_warps(K, 0) < lib.ocean_traj_warps(64, 0)
    cfg, h2, v, eta, inc = _k3_inputs(dev, K, C, T, K)
    before = tt.ocean_traj.launches
    out = tt.ocean_traj(cfg, h2, v, eta, inc)
    plain = tt.ocean_traj_plain(cfg, h2, v, eta, inc)
    torch.cuda.synchronize()
    assert tt.ocean_traj.launches == before + 1
    assert torch.equal(out.a, plain.a) and torch.equal(out.nsel, plain.nsel)
    assert bool((out.nsel > 0).any())
    torch.testing.assert_close(out.b, plain.b, atol=B_ATOL, rtol=0)
    torch.testing.assert_close(out.q_final, plain.q_final, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("K", [10, 17, 32])
def test_k3_rounds_equal_k1_scan_rounds_bitwise(dev, K):
    """Every round of K3, teacher-forced: its own q_pre through one
    traj="scan" round with solver="pallas" (K1).  Both run one warp per
    candidate through the same candidate body, and the ranking, S0 fix-up
    and unsort are the same float operations, so a, nsel and b are equal
    bit for bit."""
    import dataclasses

    from repro_torch.core.ocean import OceanState, ocean_round

    C, T = 12, 30
    cfg, h2, v, eta, inc = _k3_inputs(dev, 7 * K, C, T, K)
    out = tt.ocean_traj(cfg, h2, v, eta, inc)
    CT = C * T
    state = OceanState(q=out.q_pre.reshape(CT, K),
                       t=torch.arange(T, dtype=torch.int32, device=dev).repeat(C),
                       energy_spent=torch.zeros((CT, K), device=dev))
    before = tk.ocean_p_prefix.launches
    _, dec = ocean_round(state, h2.reshape(CT, K), 1e-5, eta.reshape(CT),
                         dataclasses.replace(cfg, traj="scan"), budget_inc=inc.reshape(CT, K))
    torch.cuda.synchronize()
    assert tk.ocean_p_prefix.launches == before + 1
    assert torch.equal(dec.a, out.a.reshape(CT, K))
    assert torch.equal(dec.num_selected, out.nsel.reshape(CT))
    assert torch.equal(dec.b, out.b.reshape(CT, K))


# ---------------------------------------------------------------------------
# K3's streamed-radio and failure instances
# ---------------------------------------------------------------------------
def _k3_radio(dev, seed, C, T, cfg, modulated=True):
    """(C, T) radio leaves: the static radio, or every round's bandwidth a
    random share in [0.5, 1] of it and the deadline jittered by 30 %."""
    from repro_torch.env.radio import traced_radio

    base = traced_radio(cfg.radio, T).map(lambda x: x.to(dev).expand(C, T).contiguous())
    if not modulated:
        return base
    rng = np.random.default_rng(seed)
    bw = base.bandwidth_hz * torch.tensor(rng.uniform(0.5, 1.0, (C, T)), dtype=torch.float32,
                                          device=dev)
    tau = base.deadline_s * torch.tensor(rng.uniform(0.7, 1.3, (C, T)), dtype=torch.float32,
                                         device=dev)
    return base._replace(bandwidth_hz=bw, deadline_s=tau, beta=base.model_bits / (tau * bw),
                         energy_scale=tau * base.noise_w * bw)


def _k3_failure(dev, seed, C, T, K, p=0.7, dead_rounds=()):
    """A (C, T, K) delivery mask at rate p (every client lost in
    ``dead_rounds``) and per-client declared rates around p."""
    from repro_torch.env.failure import TracedFailure

    rng = np.random.default_rng(seed)
    dlv = (rng.random((C, T, K)) < p).astype(np.float32)
    dlv[:, list(dead_rounds)] = 0.0
    rate = np.clip(rng.uniform(p - 0.1, p + 0.1, (C, K)), 0.0, 1.0).astype(np.float32)
    return TracedFailure(delivered=torch.tensor(dlv, device=dev), rate=torch.tensor(rate, device=dev))


def _assert_k3_close(out, plain, failure=False):
    assert torch.equal(out.a, plain.a) and torch.equal(out.nsel, plain.nsel)
    torch.testing.assert_close(out.q_final, plain.q_final, atol=1e-6, rtol=1e-5)
    if not failure:
        torch.testing.assert_close(out.b, plain.b, atol=B_ATOL, rtol=0)
        return
    assert torch.equal(out.dlv, plain.dlv) and torch.equal(out.ral, plain.ral)
    assert bool((out.dlv <= out.a).all())


def _replay_rounds(cfg, out, h2, v, eta, inc, radio=None, failure=None):
    """Every (cell, round) of a K3 run through the plain round on the
    kernel's own q_pre: a re-solved P4 answers its inputs to float32
    rounding, so over a whole trajectory the queues' last bits can move b
    by more than it moves per round; per round the tolerances hold.  The
    P3 value (re-computed where overprovision re-solves) lies within
    W_RTOL x (|P3| + v eta) of the plain round's: relative, with one
    client's utility as the floor near 0."""
    import dataclasses

    from repro_torch.core.ocean import OceanState, ocean_round
    from repro_torch.core.solvers import get_solver

    C, T, K = h2.shape
    CT = C * T
    state = OceanState(q=out.q_pre.reshape(CT, K),
                       t=torch.arange(T, dtype=torch.int32, device=h2.device).repeat(C),
                       energy_spent=torch.zeros((CT, K), device=h2.device))
    kw = {}
    if radio is not None:
        kw["radio"] = radio.map(lambda x: x.reshape(CT))
    if failure is not None:
        kw["delivered"] = failure.delivered.reshape(CT, K)
        kw["fail_rate"] = failure.rate[:, None, :].expand(C, T, K).reshape(CT, K)
    plain = tt._plain_solver(get_solver(cfg.solver))
    _, dec = ocean_round(state, h2.reshape(CT, K), v.reshape(CT), eta.reshape(CT),
                         dataclasses.replace(cfg, solver=plain, traj="scan"),
                         budget_inc=inc.reshape(CT, K), **kw)
    assert torch.equal(dec.a, out.a.reshape(CT, K))
    torch.testing.assert_close(out.b.reshape(CT, K), dec.b, atol=B_ATOL, rtol=0)
    torch.testing.assert_close(out.e.reshape(CT, K), dec.e, atol=1e-6, rtol=1e-4)
    floor = (v * eta).reshape(CT)
    rel = (out.obj.reshape(CT) - dec.objective).abs() / (dec.objective.abs() + floor)
    assert rel.max().item() <= W_RTOL, rel.max().item()
    if failure is not None:
        assert torch.equal(dec.delivered, out.dlv.reshape(CT, K))
        assert torch.equal(dec.realloc, out.ral.reshape(CT))
    if cfg.guard is not None:
        for f, g in (("fault_count", "fc"), ("demoted", "dm"), ("fallback", "fb")):
            assert torch.equal(getattr(dec, f), getattr(out, g).reshape(CT)), f


@pytest.mark.parametrize("T,K,C", [(40, 6, 8), (20, 33, 4)])
def test_k3_radio_stream_matches_plain(dev, T, K, C):
    """HasRadio: every round reads its cell's b_min, beta and energy_scale."""
    cfg, h2, v, eta, inc = _k3_inputs(dev, 5, C, T, K)
    radio = _k3_radio(dev, 5, C, T, cfg)
    before = tt.ocean_traj.launches
    out = tt.ocean_traj(cfg, h2, v, eta, inc, radio=radio)
    plain = tt.ocean_traj_plain(cfg, h2, v, eta, inc, radio=radio)
    torch.cuda.synchronize()
    assert tt.ocean_traj.launches == before + 1
    _assert_k3_close(out, plain)
    assert out.dlv is None and out.ral is None


@pytest.mark.parametrize("K", [10, 33])
def test_k3_static_radio_stream_equals_scalar_radio_bitwise(dev, K):
    """A static radio streamed as (C, T) leaves gives the scalar instance's
    bits: the stored float32 leaves are the launch arguments' values."""
    cfg, h2, v, eta, inc = _k3_inputs(dev, 6, 8, 30, K)
    scalar = tt.ocean_traj(cfg, h2, v, eta, inc)
    streamed = tt.ocean_traj(cfg, h2, v, eta, inc, radio=_k3_radio(dev, 6, 8, 30, cfg, False))
    torch.cuda.synchronize()
    for f in ("a", "b", "e", "q_pre", "obj", "nsel", "q_final", "es_final"):
        assert torch.equal(getattr(scalar, f), getattr(streamed, f)), f


@pytest.mark.parametrize("mode", ["plain", "overprovision", "reallocate"])
@pytest.mark.parametrize("T,K,C", [(40, 6, 8), (20, 10, 8), (20, 33, 4), (2, 2048, 2)])
def test_k3_failure_matches_plain(dev, mode, T, K, C):
    """HasFailure under each mode, with rounds where every client fails
    (t = 1, 3, 7) and a cell whose gains are 1000 times worse: after round 0
    its queues hold it at no client selected."""
    import dataclasses

    cfg, h2, v, eta, inc = _k3_inputs(dev, 7, C, T, K)
    cfg = dataclasses.replace(cfg, failure_mode=mode)
    h2[0] *= 1e-3
    failure = _k3_failure(dev, 7, C, T, K, dead_rounds=[t for t in (1, 3, 7) if t < T])
    before = tt.ocean_traj.launches
    out = tt.ocean_traj(cfg, h2, v, eta, inc, failure=failure)
    plain = tt.ocean_traj_plain(cfg, h2, v, eta, inc, failure=failure)
    torch.cuda.synchronize()
    assert tt.ocean_traj.launches == before + 1
    _assert_k3_close(out, plain, failure=True)
    _replay_rounds(cfg, out, h2, v, eta, inc, failure=failure)
    if T > 3:
        assert bool((out.nsel[0, 1:13] == 0).all())  # poor gains, before the reset at 13
        assert bool(((out.a & ~out.dlv).any(-1) | (out.nsel == 0))[:, 3].all())
        if mode == "reallocate":
            assert bool((out.ral[:, 3] == (out.nsel[:, 3] > 0).int()).all())


def test_k3_radio_and_failure_together_match_plain(dev):
    import dataclasses

    C, T, K = 8, 30, 10
    cfg, h2, v, eta, inc = _k3_inputs(dev, 8, C, T, K)
    cfg = dataclasses.replace(cfg, failure_mode="overprovision")
    radio = _k3_radio(dev, 8, C, T, cfg)
    failure = _k3_failure(dev, 8, C, T, K)
    out = tt.ocean_traj(cfg, h2, v, eta, inc, radio=radio, failure=failure)
    plain = tt.ocean_traj_plain(cfg, h2, v, eta, inc, radio=radio, failure=failure)
    torch.cuda.synchronize()
    _assert_k3_close(out, plain, failure=True)
    _replay_rounds(cfg, out, h2, v, eta, inc, radio=radio, failure=failure)


def test_k3_failure_with_all_ones_equals_no_failure_bitwise(dev):
    """An all-ones mask: plain and reallocate give the failure-free bits, and
    so does overprovision with every declared rate 1 (its prefix never grows)."""
    import dataclasses

    from repro_torch.env.failure import TracedFailure

    C, T, K = 8, 30, 10
    cfg, h2, v, eta, inc = _k3_inputs(dev, 9, C, T, K)
    ref = tt.ocean_traj(cfg, h2, v, eta, inc)
    ones = TracedFailure(delivered=torch.ones_like(h2), rate=torch.ones((C, K), device=dev))
    for mode in ("plain", "overprovision", "reallocate"):
        out = tt.ocean_traj(dataclasses.replace(cfg, failure_mode=mode), h2, v, eta, inc,
                            failure=ones)
        for f in ("a", "b", "e", "q_pre", "nsel", "q_final"):
            assert torch.equal(getattr(ref, f), getattr(out, f)), (mode, f)
        assert torch.equal(out.dlv, out.a) and not bool(out.ral.any())


# ---------------------------------------------------------------------------
# K4 / K5: the attention kernels against their plain versions (bfloat16
# kernels vs plain versions that round their probabilities to bfloat16:
# atol = rtol = 2e-2, tests/test_kernels.py's bfloat16 tolerance; float32
# K5 2e-5)
# ---------------------------------------------------------------------------
from repro_torch.kernels import decode_attention as kd  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402

ATT_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def _qkv(seed, b, s, h, kv, d, dtype, dev, q_scale=4.0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g, device=dev) * q_scale
    k = torch.randn((b, s, kv, d), generator=g, device=dev)
    v = torch.randn((b, s, kv, d), generator=g, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize(
    "b,s,h,kv,d,causal,window,cap",
    [
        (1, 1000, 32, 16, 128, True, 300, 50.0),    # gemma2 heads, ragged S, window
        (2, 256, 4, 1, 64, True, None, None),        # MQA
        (1, 190, 6, 2, 128, True, 64, 30.0),
        (2, 128, 8, 8, 32, False, None, 50.0),       # non-causal
        (1, 64, 4, 2, 64, True, 1, None),            # window 1: the diagonal only
        (1, 300, 64, 8, 128, True, None, None),      # jamba heads, no soft-cap
        (2, 1, 4, 2, 64, True, None, 50.0),          # S = 1
        (1, 129, 4, 2, 128, True, None, 50.0),       # one past a 128-key tile
        (1, 700, 4, 2, 128, True, 128, 50.0),        # window = one key tile
        (1, 200, 4, 2, 64, True, 500, None),         # window longer than S
        (2, 333, 4, 2, 128, False, None, 50.0),      # non-causal, ragged S
    ],
)
def test_k4_matches_plain(dev, b, s, h, kv, d, causal, window, cap):
    q, k, v = _qkv(s + h, b, s, h, kv, d, torch.bfloat16, dev)
    before = kf.flash_attention.launches
    out = kf.flash_attention(q, k, v, causal=causal, window=window, logit_cap=cap)
    plain = kf.flash_attention_plain(q, k, v, causal=causal, window=window, logit_cap=cap)
    torch.cuda.synchronize()
    assert kf.flash_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), plain.float(), atol=ATT_TOL[torch.bfloat16],
                               rtol=ATT_TOL[torch.bfloat16])


def test_k4_refuses_float32_on_the_card(dev):
    q, k, v = _qkv(0, 1, 16, 2, 2, 32, torch.float32, dev)
    with pytest.raises(ValueError, match="bfloat16"):
        kf.flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,h,kv,d,s,valid",
    [
        (4, 32, 16, 128, 8192, 8000),
        (2, 8, 4, 64, 512, 300),
        (1, 16, 2, 128, 2048, 999),
        (2, 8, 8, 32, 256, 17),
        (1, 4, 1, 256, 700, 700),
        (1, 8, 2, 128, 300, 0),
    ],
)
def test_k5_matches_plain(dev, dtype, b, h, kv, d, s, valid):
    g = torch.Generator(device=dev)
    g.manual_seed(valid + d)
    q = (torch.randn((b, h, d), generator=g, device=dev) * 4.0).to(dtype)
    kc = torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype)
    vc = torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype)
    vl = torch.tensor(valid, device=dev)
    before = kd.decode_attention.launches
    out = kd.decode_attention(q, kc, vc, vl, logit_cap=50.0)
    plain = kd.decode_attention_plain(q, kc, vc, vl, logit_cap=50.0)
    torch.cuda.synchronize()
    assert kd.decode_attention.launches == before + 1
    torch.testing.assert_close(out.float(), plain.float(), atol=ATT_TOL[dtype], rtol=ATT_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,h,kv,d,s",
    [
        (2, 16, 8, 128, 1000),    # G = 2 at gemma2's head dim
        (1, 64, 8, 128, 2100),    # jamba's heads: G = 8
        (2, 8, 8, 64, 777),       # G = 1
        (1, 8, 2, 256, 600),
        (3, 4, 1, 32, 300),       # MQA, G = 4
    ],
)
def test_k5_valid_len_edges_and_types(dev, dtype, b, h, kv, d, s):
    """valid_len at 1, 255, 256, 257, S and around a tile (WT slots), a
    warp's run (a quarter of a split) and a split of the shape's grid, each
    given as an int32 tensor, an int64 tensor and a Python int: the three
    give the same output, within the dtype's tolerance of the plain one."""
    g = torch.Generator(device=dev)
    g.manual_seed(s + d)
    q = (torch.randn((b, h, d), generator=g, device=dev) * 4.0).to(dtype)
    kc = torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype)
    vc = torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype)
    per_split = kd._launchers()["split"](b, s, h, kv, d, int(dtype == torch.bfloat16))
    assert per_split > 0 and per_split % 4 == 0
    tile = min(32, 256 // (d * q.element_size() // 16))
    edges = {1, 255, 256, 257, s - 1, s}
    for n in (tile, per_split // 4, per_split, 2 * per_split):
        edges |= {n - 1, n, n + 1}
    tol = ATT_TOL[dtype]
    for valid in sorted(v for v in edges if 0 < v <= s):
        plain = kd.decode_attention_plain(q, kc, vc, valid, logit_cap=50.0).float()
        outs = [
            kd.decode_attention(q, kc, vc, vl, logit_cap=50.0)
            for vl in (
                torch.tensor(valid, dtype=torch.int32, device=dev),
                torch.tensor([valid], dtype=torch.int64, device=dev),
                valid,
            )
        ]
        torch.cuda.synchronize()
        for out in outs:
            assert torch.equal(out, outs[0]), valid
        torch.testing.assert_close(outs[0].float(), plain, atol=tol, rtol=tol,
                                   msg=lambda m, valid=valid: f"valid_len={valid}: {m}")
    # the merging blocks reset their arrival counters for the next call
    assert all(int(c.count_nonzero()) == 0 for c in kd._ARRIVALS.values())


def test_decoder_forward_through_k4(dev, monkeypatch):
    """A bfloat16 gemma2 at small width on the card: one K4 launch per
    layer; each layer's attention output within bfloat16 noise of the plain
    version on the same q/k/v (element-wise, and 1e-2 in relative L2, which
    the window dropped from a local layer exceeds); the plain path within
    bfloat16 noise of it end to end."""
    import dataclasses

    from repro_torch.configs import ARCH_CONFIGS, smoke_variant
    from repro_torch.models import attention as model_attention
    from repro_torch.models import build_model

    cfg = dataclasses.replace(smoke_variant(ARCH_CONFIGS["gemma2-27b"]), dtype="bfloat16")
    model = build_model(cfg, dev).init(0)
    toks = torch.randint(0, cfg.vocab, (2, 100), device=dev)
    calls = []

    def recording(q, k, v, **kw):
        out = kf.flash_attention(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    monkeypatch.setattr(model_attention, "flash_attention", recording)
    before = kf.flash_attention.launches
    h, _ = model(toks)
    assert kf.flash_attention.launches == before + cfg.num_layers
    assert [c[3]["window"] for c in calls] == [
        cfg.sliding_window if kind == "local" else None for kind in cfg.layer_kinds()
    ]
    tol = ATT_TOL[torch.bfloat16]
    for q, k, v, kw, out in calls:
        plain = kf.flash_attention_plain(q, k, v, **kw).float()
        torch.testing.assert_close(out.float(), plain, atol=tol, rtol=tol)
        assert ((out.float() - plain).norm() / plain.norm()).item() < 1e-2
        if kw["window"] is not None:
            dropped = kf.flash_attention_plain(q, k, v, **{**kw, "window": None}).float()
            assert ((dropped - plain).norm() / plain.norm()).item() > 1e-2
    h_plain, _ = model(toks, plain=True)
    torch.cuda.synchronize()
    rel = ((h.float() - h_plain.float()).norm() / h_plain.float().norm()).item()
    assert rel < 2e-2, rel


# ---------------------------------------------------------------------------
# K6 / K7: the scans against their plain versions (float32 on both sides,
# sums in another order).  K6: atol = rtol = 2e-4, tests/test_kernels.py's.
# K7: |d| <= 5e-4 (|plain| + rms(plain)): the WKV state at the model's
# decays (w ~ 0.995) sums ~200 steps, so an output that cancels to near 0
# still carries rounding of the size of the typical output.
# ---------------------------------------------------------------------------
from repro_torch.kernels import mamba_scan as km  # noqa: E402
from repro_torch.kernels import rwkv6_scan as kr  # noqa: E402

WKV_TOL, MAMBA_TOL = 5e-4, 2e-4


def _wkv_inputs(dev, seed, b, t, h, n, decay):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    r, k, v, x = (torch.randn((b, t, h, n), generator=g, device=dev) for _ in range(4))
    if decay == "model":  # exp(-exp(w0)), w0 = -6 + U(0, 1): rwkv6's range at init
        w = torch.exp(-torch.exp(-6.0 + torch.rand((b, t, h, n), generator=g, device=dev)))
    else:  # tests/test_kernels.py's sigmoid range
        w = torch.sigmoid(x)
    u = 0.5 * torch.randn((h, n), generator=g, device=dev)
    return r, k, v, w, u


def _assert_wkv_close(out, plain):
    scale = plain.square().mean().sqrt()
    excess = (out - plain).abs() - WKV_TOL * (plain.abs() + scale)
    assert float(excess.max()) <= 0.0, float((out - plain).abs().max())


@pytest.mark.parametrize(
    "b,t,h,n,decay",
    [
        (2, 128, 4, 64, "sigmoid"),
        (1, 192, 3, 64, "model"),
        (1, 77, 3, 64, "model"),      # ragged T: a partial last chunk
        (2, 33, 2, 32, "sigmoid"),    # N = 32
        (3, 1, 2, 64, "model"),       # one step
        (1, 2000, 2, 64, "model"),
    ],
)
def test_k7_matches_plain(dev, b, t, h, n, decay):
    r, k, v, w, u = _wkv_inputs(dev, t + n, b, t, h, n, decay)
    before = kr.wkv_scan.launches
    out = kr.wkv_scan(r, k, v, w, u)
    plain = kr.wkv_scan_plain(r, k, v, w, u)
    torch.cuda.synchronize()
    assert kr.wkv_scan.launches == before + 1
    assert out.shape == (b, t, h, n) and bool(torch.isfinite(out).all())
    _assert_wkv_close(out, plain)


@pytest.mark.parametrize("b,h", [(1, 3), (5, 32)])
@pytest.mark.parametrize("t", [1, 31, 33, 8192])
@pytest.mark.parametrize("n", [32, 64])
def test_k7_row_groups_match_plain(dev, n, t, b, h):
    """K7's state tiles (a column's row tiles in adjacent lanes, their
    partial sums joined by a shuffle butterfly) at both head sizes, around
    a chunk of 32 steps and at the prefill's 8192, with fewer (b, h) chains
    than SMs and more."""
    r, k, v, w, u = _wkv_inputs(dev, n + t + b, b, t, h, n, "model")
    before = kr.wkv_scan.launches
    out = kr.wkv_scan(r, k, v, w, u)
    plain = kr.wkv_scan_plain(r, k, v, w, u)
    torch.cuda.synchronize()
    assert kr.wkv_scan.launches == before + 1
    assert bool(torch.isfinite(out).all())
    _assert_wkv_close(out, plain)
    rel = ((out - plain).norm() / plain.norm()).item()
    assert rel <= 1e-4, rel


def test_k7_refuses_what_it_does_not_take(dev):
    r, k, v, w, u = _wkv_inputs(dev, 0, 1, 8, 2, 64, "sigmoid")
    with pytest.raises(ValueError, match="float32"):
        kr.wkv_scan(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="head size"):
        kr.wkv_scan(*(x[..., :48].contiguous() for x in (r, k, v, w, u)))
    with pytest.raises(ValueError, match="contiguous"):
        kr.wkv_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        kr.wkv_scan(r, k, v, w, u[:1])


def _mamba_inputs(dev, seed, b, t, di, ds, model_range):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if model_range:  # dA = exp(dt A), dt in [1e-3, 0.1], A = -(1..ds); dBu = dt B u
        dt = torch.exp(torch.empty((b, t, di), device=dev).uniform_(-6.9, -2.3, generator=g))
        a = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
        da = torch.exp(dt[..., None] * a)
        bm = torch.randn((b, t, ds), generator=g, device=dev)
        uu = torch.randn((b, t, di), generator=g, device=dev)
        dbu = dt[..., None] * bm[:, :, None, :] * uu[..., None]
    else:  # tests/test_kernels.py's draws
        da = torch.sigmoid(torch.randn((b, t, di, ds), generator=g, device=dev))
        dbu = 0.1 * torch.randn((b, t, di, ds), generator=g, device=dev)
    c = torch.randn((b, t, ds), generator=g, device=dev)
    return da.contiguous(), dbu.contiguous(), c


@pytest.mark.parametrize(
    "b,t,di,ds,model_range",
    [
        (2, 128, 256, 16, False),
        (1, 300, 4096, 16, True),     # a block of jamba's mixer, ragged T
        (2, 45, 100, 16, True),       # ragged T and Di
        (1, 257, 40, 8, False),       # d_state 8 (the smoke configs)
        (1, 20, 16, 32, False),
        (1, 7, 33, 4, True),          # fewer steps than one load group
    ],
)
def test_k6_matches_plain(dev, b, t, di, ds, model_range):
    da, dbu, c = _mamba_inputs(dev, t + di, b, t, di, ds, model_range)
    before = km.mamba_scan.launches
    out = km.mamba_scan(da, dbu, c)
    plain = km.mamba_scan_plain(da, dbu, c)
    torch.cuda.synchronize()
    assert km.mamba_scan.launches == before + 1
    assert out.shape == (b, t, di) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, plain, atol=MAMBA_TOL, rtol=MAMBA_TOL)


def test_k6_refuses_what_it_does_not_take(dev):
    da, dbu, c = _mamba_inputs(dev, 0, 1, 8, 16, 16, False)
    with pytest.raises(ValueError, match="float32"):
        km.mamba_scan(da.to(torch.bfloat16), dbu.to(torch.bfloat16), c)
    with pytest.raises(ValueError, match="d_state"):
        km.mamba_scan(da[..., :12].contiguous(), dbu[..., :12].contiguous(), c[..., :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        km.mamba_scan(da.transpose(1, 2).contiguous().transpose(1, 2), dbu, c)
    with pytest.raises(ValueError, match="C must be"):
        km.mamba_scan(da, dbu, c[:, :4])


@pytest.mark.parametrize(
    "arch, over, kernel, dtype, tol",
    [
        ("rwkv6-1.6b", {}, "wkv_scan", "float32", 1e-4),
        ("jamba-1.5-large-398b", {"num_layers": 4}, "mamba_scan", "float32", 1e-4),
    ],
)
def test_ssm_forward_through_the_kernels(dev, arch, over, kernel, dtype, tol):
    """float32 smoke models on the card: K7 once per RWKV6 layer, K6 once
    per Mamba layer (d_inner 256 is one block); the plain path within
    float32 noise.  Jamba's first 4 layers (Mamba with dense and MoE FFNs)
    leave out its attention layer, whose K4 takes bfloat16 only."""
    import dataclasses

    from repro_torch.configs import ARCH_CONFIGS, smoke_variant
    from repro_torch.models import build_model

    cfg = dataclasses.replace(smoke_variant(ARCH_CONFIGS[arch]), dtype=dtype, **over)
    model = build_model(cfg, dev).init(0)
    toks = torch.randint(0, cfg.vocab, (2, 100), device=dev)
    fn = {"wkv_scan": kr.wkv_scan, "mamba_scan": km.mamba_scan}[kernel]
    n_mixer = sum(k in ("rwkv", "mamba") for k in cfg.layer_kinds())
    before, before_k4 = fn.launches, kf.flash_attention.launches
    h, aux = model(toks)
    assert fn.launches == before + n_mixer
    n_attn = sum(k in ("global", "local") for k in cfg.layer_kinds())
    assert kf.flash_attention.launches == before_k4 + n_attn
    h_plain, aux_plain = model(toks, plain=True)
    torch.cuda.synchronize()
    rel = ((h.float() - h_plain.float()).norm() / h_plain.float().norm()).item()
    assert rel < tol, rel
    torch.testing.assert_close(aux, aux_plain, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# K3's guarded and bisect instances
# ---------------------------------------------------------------------------
def _k3_faulty(dev, seed, C, T, K, scale_cells=1e-2):
    """K3 inputs with quarantined faults (inf, zero, negative, NaN) and
    subnormal gains injected per cell, and the first half of the cells'
    gains scaled down so that the energy cap demotes clients."""
    from repro_torch.guard import inject_h2_faults

    cfg, h2, v, eta, inc = _k3_inputs(dev, seed, C, T, K)
    rows, reps = [], []
    for c in range(C):
        x, rep = inject_h2_faults(h2[c].cpu(), seed + c, num_inf=2, num_zero=1, num_negative=1,
                                  num_nan=1, num_subnormal=2)
        rows.append(torch.tensor(x))
        reps.append(rep)
    h2 = torch.stack(rows).to(dev)
    h2[: C // 2] *= scale_cells
    return cfg, h2.contiguous(), v, eta, inc, reps


def _assert_guard_counts(out, reps, T):
    for c, rep in enumerate(reps):
        fc = torch.tensor(rep.per_round_quarantined(T), dtype=torch.int32)
        assert torch.equal(out.fc[c].cpu(), fc), c
        a = out.a[c].cpu()
        for kind in ("nan", "inf", "zero", "negative", "subnormal"):
            for t, k in rep.positions[kind]:
                assert not bool(a[t, k]), (c, kind, t, k)


@pytest.mark.parametrize("mode", [None, "plain", "overprovision", "reallocate"])
@pytest.mark.parametrize("radio_on", [False, True])
def test_k3_guard_matches_plain(dev, mode, radio_on):
    """HasGuard under each failure mode and the streamed radio: the counters
    exact per round, the queues finite, every round replayed against the
    plain guarded round."""
    import dataclasses

    from repro_torch.guard import GuardSpec

    C, T, K = 8, 30, 10
    cfg, h2, v, eta, inc, reps = _k3_faulty(dev, 11, C, T, K)
    cfg = dataclasses.replace(cfg, guard=GuardSpec(energy_cap=1.0, gain_floor=1e-9),
                              failure_mode=mode or "plain")
    radio = _k3_radio(dev, 11, C, T, cfg) if radio_on else None
    failure = None if mode is None else _k3_failure(dev, 11, C, T, K)
    before = dict(tt.ocean_traj.instances)
    out = tt.ocean_traj(cfg, h2, v, eta, inc, radio=radio, failure=failure)
    plain = tt.ocean_traj_plain(cfg, h2, v, eta, inc, radio=radio, failure=failure)
    torch.cuda.synchronize()
    label = "+".join(n for n, on in (("radio", radio_on), ("guard", True),
                                     ("failure", mode is not None)) if on)
    label += f"/{mode}" if mode else ""
    assert tt.ocean_traj.instances.get(label, 0) == before.get(label, 0) + 1
    _assert_guard_counts(out, reps, T)
    for f in ("fc", "dm", "fb"):
        assert torch.equal(getattr(out, f), getattr(plain, f)), f
    assert int(out.dm.sum()) > 0 and bool(torch.isfinite(out.q_final).all())
    _assert_k3_close(out, plain, failure=failure is not None)
    _replay_rounds(cfg, out, h2, v, eta, inc, radio=radio, failure=failure)


@pytest.mark.parametrize("T,K,C", [(12, 6, 8), (12, 10, 8), (6, 33, 4), (2, 300, 2)])
def test_k3_bisect_matches_plain(dev, T, K, C):
    """The bisect instance against the plain version, whose sweep is
    ``_prefix_bisect``: whole trajectories and every round replayed."""
    import dataclasses

    cfg, h2, v, eta, inc = _k3_inputs(dev, 13, C, T, K)
    cfg = dataclasses.replace(cfg, solver="bisect")
    before = tt.ocean_traj.instances.get("bisect", 0)
    out = tt.ocean_traj(cfg, h2, v, eta, inc)
    plain = tt.ocean_traj_plain(cfg, h2, v, eta, inc)
    torch.cuda.synchronize()
    assert tt.ocean_traj.instances["bisect"] == before + 1
    assert out.fc is None
    _assert_k3_close(out, plain)
    _replay_rounds(cfg, out, h2, v, eta, inc)


@pytest.mark.parametrize("solver", ["pallas", "bisect"])
def test_k3_never_firing_guard_equals_unguarded_bitwise(dev, solver):
    import dataclasses

    from repro_torch.guard import GuardSpec

    cfg, h2, v, eta, inc = _k3_inputs(dev, 14, 8, 30, 10)
    cfg = dataclasses.replace(cfg, solver=solver)
    ref = tt.ocean_traj(cfg, h2, v, eta, inc)
    out = tt.ocean_traj(dataclasses.replace(cfg, guard=GuardSpec(energy_cap=1e6)), h2, v, eta, inc)
    torch.cuda.synchronize()
    for f in ("a", "b", "e", "q_pre", "rho", "obj", "nsel", "q_final", "es_final"):
        assert torch.equal(getattr(ref, f), getattr(out, f)), f
    assert not bool(out.fc.any() or out.dm.any() or out.fb.any())


def test_k3_chaos_and_fallback_equal_the_bisect_instance_bitwise(dev):
    """objective chaos on base pallas and bisect: the fallback fires every
    round and commits the guarded bisect run's bits; budget chaos fires on
    exactly the rounds with m* > 0; objective chaos without a guard (the
    guarded instance with every defence off) keeps the base's decisions."""
    import dataclasses

    from repro_torch.guard import GuardSpec, register_chaos_solver

    C, T, K = 8, 30, 10
    cfg, h2, v, eta, inc = _k3_inputs(dev, 15, C, T, K)
    g = dataclasses.replace(cfg, guard=GuardSpec())
    ref = tt.ocean_traj(dataclasses.replace(g, solver="bisect"), h2, v, eta, inc)
    for base in ("pallas", "bisect"):
        chaos = register_chaos_solver(base, kind="objective").name
        out = tt.ocean_traj(dataclasses.replace(g, solver=chaos), h2, v, eta, inc)
        assert bool((out.fb == 1).all()), base
        for f in ("a", "b", "e", "q_pre", "nsel", "q_final"):
            assert torch.equal(getattr(ref, f), getattr(out, f)), (base, f)
    budget = dataclasses.replace(g, solver=register_chaos_solver("bisect", kind="budget",
                                                                 scale=1.5).name)
    out = tt.ocean_traj(budget, h2, v, eta, inc)
    m_pos = (ref.a & (ref.rho > 1e-30)).any(-1).int()
    assert torch.equal(out.fb, m_pos) and bool(m_pos.any()) and not bool(m_pos.all())
    for f in ("a", "b", "e", "q_pre", "q_final"):
        assert torch.equal(getattr(ref, f), getattr(out, f)), f
    assert torch.equal(tt.ocean_traj_plain(budget, h2[:, :6], v[:, :6], eta[:, :6],
                                           inc[:, :6]).fb, out.fb[:, :6])
    unguarded = register_chaos_solver("pallas", kind="objective").name
    base_run = tt.ocean_traj(cfg, h2, v, eta, inc)
    out = tt.ocean_traj(dataclasses.replace(cfg, solver=unguarded), h2, v, eta, inc)
    torch.cuda.synchronize()
    assert out.fc is None and bool(torch.isinf(out.obj).all())
    for f in ("a", "b", "e", "q_pre", "q_final"):
        assert torch.equal(getattr(base_run, f), getattr(out, f)), f


def test_k3_subnormal_gain_is_demoted_not_quarantined(dev):
    """K3 is built without flush-to-zero: a subnormal gain is a legal
    positive float that the quarantine passes and the cap demotes."""
    import dataclasses

    from repro_torch.guard import GuardSpec, inject_h2_faults

    C, T, K = 4, 20, 6
    cfg, h2, v, eta, inc = _k3_inputs(dev, 16, C, T, K)
    rows, reps = [], []
    for c in range(C):
        x, rep = inject_h2_faults(h2[c].cpu(), 40 + c, num_subnormal=3)
        rows.append(torch.tensor(x))
        reps.append(rep)
    h2 = torch.stack(rows).to(dev).contiguous()
    cfg = dataclasses.replace(cfg, guard=GuardSpec(energy_cap=1.0))
    out = tt.ocean_traj(cfg, h2, v, eta, inc)
    plain = tt.ocean_traj_plain(cfg, h2, v, eta, inc)
    torch.cuda.synchronize()
    assert not bool(out.fc.any()) and int(out.dm.sum()) >= 3 * C
    assert torch.equal(out.dm, plain.dm)
    for c, rep in enumerate(reps):
        for t, k in rep.positions["subnormal"]:
            assert not bool(out.a[c, t, k])
            assert float(out.rho[c, t, k]) == float(torch.tensor(1e30, dtype=torch.float32))
    assert float(out.e.max()) <= 0.15 * (1 + 1e-6)


# ---------------------------------------------------------------------------
# K3's HasMetrics instances: the telemetry inside the kernel
# ---------------------------------------------------------------------------
def _metrics_spec(hist_bins=8, ds_samples=7, names=None, reductions=None):
    from repro_torch.obs import REDUCTIONS, MetricsSpec, available_collectors

    names = available_collectors() if names is None else names
    reductions = REDUCTIONS if reductions is None else reductions
    return MetricsSpec(collect=tuple((n, r) for n in names for r in reductions),
                       hist_bins=hist_bins, ds_samples=ds_samples)


def _metrics_run(cfg, h2, v, eta, inc, radio=None, failure=None, label=None):
    """K3 with cfg.metrics: its decisions equal the metrics-off launch's bit
    for bit, its telemetry holds to the replay of its own rows."""
    import dataclasses

    off = tt.ocean_traj(dataclasses.replace(cfg, metrics=None), h2, v, eta, inc, radio=radio,
                        failure=failure)
    before = dict(tt.ocean_traj.instances)
    out = tt.ocean_traj(cfg, h2, v, eta, inc, radio=radio, failure=failure)
    torch.cuda.synchronize()
    if label is not None:
        assert tt.ocean_traj.instances.get(label, 0) == before.get(label, 0) + 1
    for f in ("a", "b", "e", "q_pre", "rho", "obj", "nsel", "q_final", "es_final", "dlv", "ral",
              "fc", "dm", "fb"):
        x, y = getattr(off, f), getattr(out, f)
        assert (x is None and y is None) or torch.equal(x, y), f
    tt.check_metrics_replay(cfg, out.metrics, out, v, eta, inc, radio)
    return out


@pytest.mark.parametrize("T,K,C", [(40, 6, 8), (30, 10, 16), (12, 33, 4)])
def test_k3_metrics_static_matches_the_replay(dev, T, K, C):
    import dataclasses

    cfg, h2, v, eta, inc = _k3_inputs(dev, 21, C, T, K)
    cfg = dataclasses.replace(cfg, metrics=_metrics_spec())
    out = _metrics_run(cfg, h2, v, eta, inc, label="metrics")
    assert torch.equal(out.metrics["num_selected/full_trace"], out.nsel.float())


def test_k3_metrics_radio_matches_the_replay(dev):
    import dataclasses

    C, T, K = 8, 30, 10
    cfg, h2, v, eta, inc = _k3_inputs(dev, 22, C, T, K)
    cfg = dataclasses.replace(cfg, metrics=_metrics_spec())
    _metrics_run(cfg, h2, v, eta, inc, radio=_k3_radio(dev, 22, C, T, cfg),
                 label="radio+metrics")


@pytest.mark.parametrize("mode", ["plain", "overprovision", "reallocate"])
def test_k3_metrics_failure_matches_the_replay(dev, mode):
    import dataclasses

    C, T, K = 8, 30, 10
    cfg, h2, v, eta, inc = _k3_inputs(dev, 23, C, T, K)
    cfg = dataclasses.replace(cfg, failure_mode=mode, metrics=_metrics_spec())
    out = _metrics_run(cfg, h2, v, eta, inc, failure=_k3_failure(dev, 23, C, T, K, p=0.6),
                       label=f"failure+metrics/{mode}")
    assert float(out.metrics["delivery_rate/mean"].mean()) < 1.0
    if mode == "reallocate":
        assert torch.equal(out.metrics["reallocation_count/last"], out.ral.sum(1).float())


@pytest.mark.parametrize("solver", ["pallas", "bisect"])
def test_k3_metrics_guard_and_bisect_match_the_replay(dev, solver):
    import dataclasses

    from repro_torch.guard import GuardSpec, register_chaos_solver

    C, T, K = 8, 20, 10
    cfg, h2, v, eta, inc, _ = _k3_faulty(dev, 24, C, T, K)
    spec = _metrics_spec()
    g = dataclasses.replace(cfg, solver=solver, guard=GuardSpec(energy_cap=1.0), metrics=spec)
    out = _metrics_run(g, h2, v, eta, inc,
                       label="guard+metrics" if solver == "pallas" else "bisect+guard+metrics")
    assert torch.equal(out.metrics["fault_count/last"], out.fc.sum(1).float())
    assert torch.equal(out.metrics["demoted_clients/last"], out.dm.sum(1).float())
    assert int(out.dm.sum()) > 0
    chaos = dataclasses.replace(g, solver=register_chaos_solver(solver, kind="objective").name)
    out = _metrics_run(chaos, h2, v, eta, inc)
    assert torch.equal(out.metrics["fallback_rounds/last"], torch.full((C,), float(T), device=dev))
    b = dataclasses.replace(cfg, solver="bisect", metrics=spec)
    _metrics_run(b, *_k3_inputs(dev, 25, C, T, K)[1:], label="bisect+metrics")


def test_k3_metrics_off_keeps_the_digest_of_the_static_instance(dev):
    """On chip_kernels.py's §VI inputs (192 cells x 300 rounds x K = 10)
    the instance without telemetry keeps its digest ``c27a0410…``, and the
    HasMetrics launch gives the same decision outputs."""
    import dataclasses
    import hashlib

    from repro_torch.core.scenario import paper_scenarios
    from repro_torch.sim import GridEngine

    C, T, K = 192, 300, 10
    cfg = GridEngine(paper_scenarios(T, K), ["ocean-u", "ocean-a"], solver="pallas",
                     traj="fused", device=dev).cfg
    h2 = torch.tensor(np.random.default_rng(3).exponential(size=(C, T, K)).astype(np.float32)
                      * 2.5e-4, device=dev)
    inc = torch.full_like(h2, 0.15 / T)
    eta = eta_schedule("uniform", T, device=dev).expand(C, T).contiguous()
    v = torch.full((C, T), 1e-5, device=dev)

    def digest(out):
        h = hashlib.sha256()
        for t in out[:9]:
            h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
        return h.hexdigest()[:16]

    off = tt.ocean_traj(cfg, h2, v, eta, inc)
    on = tt.ocean_traj(dataclasses.replace(cfg, metrics=_metrics_spec()), h2, v, eta, inc)
    torch.cuda.synchronize()
    assert digest(off) == digest(on) and digest(off).startswith("c27a0410")


@pytest.mark.parametrize("hist_bins", [32, 16384])
def test_k3_metrics_at_K_2048_per_client_collectors(dev, hist_bins):
    """K = 2048 with every per-client collector in mean and histogram (and
    full_trace_ds): the region sits beside K3's rows in shared memory with
    fewer teams, or with 16,384 bins a histogram in the global scratch."""
    import dataclasses

    lib = _build.load("ocean_traj_metrics")
    C, T, K = 2, 3, 2048
    cfg, h2, v, eta, inc = _k3_inputs(dev, 26, C, T, K)
    names = ("queue", "queue_next", "energy_headroom", "selection_count", "selection_gap")
    spec = _metrics_spec(hist_bins=hist_bins, names=names,
                         reductions=("mean", "histogram", "full_trace_ds"))
    cfg = dataclasses.replace(cfg, metrics=spec)
    region = tt._metrics_descriptor(cfg, C, dev).region
    import ctypes

    in_smem = ctypes.c_int(0)
    warps = lib.ocean_traj_metrics_warps(K, 0, 0, region, ctypes.byref(in_smem))
    assert warps >= 1 and in_smem.value == (1 if hist_bins == 32 else 0)
    _metrics_run(cfg, h2, v, eta, inc, label="metrics")


def test_k3_metrics_planted_fault_fails_the_check(dev):
    """A histogram edge moved by one bin in the launch descriptor must fail
    the replay check."""
    import dataclasses

    cfg, h2, v, eta, inc = _k3_inputs(dev, 27, 8, 30, 10)
    cfg = dataclasses.replace(cfg, metrics=_metrics_spec())
    out = tt.ocean_traj(cfg, h2, v, eta, inc, hist_shift={"queue": 1})
    torch.cuda.synchronize()
    with pytest.raises(AssertionError, match="queue/histogram"):
        tt.check_metrics_replay(cfg, out.metrics, out, v, eta, inc)
