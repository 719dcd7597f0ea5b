"""K2's launch shape, chosen on the host (``kernels/ocean_p.py``), on the CPU.

``topm_launch_shape`` takes the card's limits as arguments, so a fake card
stands in for the H100: 227 KB of shared memory a block, the kernel's
register count allowing 736 threads a block, and an occupancy query that
places one 512-thread CTA (two smaller ones) on each of 132 SMs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.energy import RadioParams  # noqa: E402
from repro_torch.kernels import ocean_p as tk  # noqa: E402

OPTIN = 232_448
MAX_THREADS = 736


def clusters_of(R, nw, cap):
    return (132 * (2 if nw <= 8 else 1)) // R


def shape(C, K_pad, top_m, **kw):
    kw.setdefault("clusters_of", clusters_of)
    return tk.topm_launch_shape(C, K_pad, top_m, optin=OPTIN, max_threads=MAX_THREADS, **kw)


def test_the_k2_path_shape_gives_every_candidate_a_warp():
    """8 cells x K = 10^4 (padded to 10,112) x top_m = 128: 8 CTAs of 16
    warps, 128 teams, one merge buffer covering the 1,264-client slice."""
    s = shape(8, 10_112, 128)
    assert s == tk.TopmShape(R=8, nw=16, cap=1536)
    assert s.R * s.nw >= 128 and s.cap >= -(-10_112 // s.R)


@pytest.mark.parametrize("top_m", [1, 32, 64])
def test_tied_estimates_take_the_preferred_cluster_size(top_m):
    assert shape(8, 10_112, top_m).R == tk.TOPM_CLUSTERS[0]


def test_many_cells_take_smaller_clusters():
    """200 cells are many waves of 8-CTA clusters; pairs of 23-warp CTAs
    run more cells at once for a longer chain, and win the estimate."""
    s = shape(200, 2048, 128)
    assert s.R < 8 and s.R > 1
    cost = lambda sh: -(-200 // clusters_of(sh.R, sh.nw, sh.cap)) * tk.topm_team_chain(  # noqa: E731
        128, sh.R * sh.nw)
    assert cost(s) < cost(shape(200, 2048, 128, cluster=8))


def test_cluster_sizes_the_card_cannot_place_are_skipped():
    s = shape(8, 10_112, 128, clusters_of=lambda R, nw, cap: 0 if R >= 8 else clusters_of(R, nw, cap))
    assert s.R == 4


@pytest.mark.parametrize("top_m", [1, 128, 4096, 14_504])
def test_every_top_m_the_parent_accepted_fits(top_m):
    """The parent kernel took top_m up to 14,504 (its shared row at 227 KB);
    the cluster kernel's CTA fits too, with a buffer of at least a tile."""
    for C in (1, 8):
        s = shape(C, max(top_m, 10_112), top_m)
        assert tk.topm_smem_bytes(top_m, s.nw, s.cap) <= OPTIN
        assert s.cap >= 32 * s.nw and 1 <= s.nw <= MAX_THREADS // 32


def test_a_top_m_past_shared_memory_is_refused():
    with pytest.raises(ValueError, match="no cluster shape fits"):
        shape(1, 20_000, 20_000)


def test_the_merge_buffer_is_capped_past_one_slice():
    s = shape(2, 200_064, 128)
    assert s.cap == tk.TOPM_CAP_MAX and -(-200_064 // s.R) > s.cap


def test_shared_bytes_follow_the_layout():
    # key region 8 (128 + 768) > rows 4 (2 4 128 + 64); compact row 8 x 128
    assert tk.topm_smem_bytes(128, 4, 768) == 8 * (128 + 768) + 8 * 128 + 16
    # rows 4 (2 16 128 + 64) > keys 8 (128 + 256)
    assert tk.topm_smem_bytes(128, 16, 256) == 4 * (2 * 16 * 128 + 64) + 8 * 128 + 16


@pytest.mark.parametrize("top_m,teams,chain", [(128, 128, 4), (128, 64, 6), (1, 128, 1), (33, 32, 3)])
def test_team_chain(top_m, teams, chain):
    """The longest team's member steps: with 64 teams, team 63 sweeps
    m = 64 and 128 (2 + 4); with 32 teams, team 0 sweeps 1 and 33 (1 + 2)."""
    assert tk.topm_team_chain(top_m, teams) == chain


@pytest.mark.parametrize("cluster", [0, 3, 32])
def test_cluster_must_be_a_power_of_two_up_to_16(cluster):
    with pytest.raises(ValueError, match="power of two"):
        shape(8, 10_112, 128, cluster=cluster)


def test_the_wrapper_runs_the_plain_version_on_cpu_tensors():
    """On CPU tensors ``ocean_p_topm`` is the plain version whatever
    ``cluster`` says; it launches nothing."""
    rng = np.random.default_rng(0)
    K = 300
    rho = torch.tensor(rng.uniform(40.0, 800.0, (3, K)), dtype=torch.float32)
    rho[:, ::5] = torch.inf
    radio = RadioParams(b_min=0.1 / K)
    n0 = torch.full((3,), 60)
    scal = tk._scal(n0, 1.0 - n0 * radio.b_min, torch.tensor([1e-5, 1e-4, 1e-3]), radio, rho)
    before = tk.ocean_p_topm.launches
    b, wm = tk.ocean_p_topm(scal, rho, K=K, top_m=64, cluster=8)
    b_p, wm_p = tk.ocean_p_topm_plain(scal, rho, K=K, top_m=64)
    assert tk.ocean_p_topm.launches == before
    assert torch.equal(b, b_p) and torch.equal(wm, wm_p)
    assert bool((wm[:, 1] > 0).all())
