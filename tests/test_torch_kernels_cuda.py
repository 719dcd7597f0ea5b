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


def test_k2_matches_plain_and_the_sorted_sweep(dev):
    K = 3000
    q, h2 = (x.to(dev) for x in _draws(5, 2, K))
    radio = RadioParams(b_min=0.1 / K)
    got = ocean_p(q, h2, 1e-5, 1.0, radio, solver="pallas_tiled", ranking="topm", top_m=64)
    ref = ocean_p(q, h2, 1e-5, 1.0, radio, solver="pallas", ranking="topm", top_m=64)
    torch.cuda.synchronize()
    assert torch.equal(got.a, ref.a) and torch.equal(got.num_selected, ref.num_selected)
    torch.testing.assert_close(got.b, ref.b, atol=B_ATOL, rtol=0)
    torch.testing.assert_close(got.objective, ref.objective, rtol=W_RTOL, atol=0)


@pytest.mark.parametrize("T,K,C", [(40, 6, 8), (3, 700, 2)])
def test_k3_matches_plain(dev, T, K, C):
    """K = 700 sorts 1024 slots, more than one block's threads at K3's
    register count: the loops must stride."""
    cfg = OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(b_min=min(0.02, 0.5 / K)),
                      frame_len=13, solver="pallas")
    h2 = torch.tensor(
        np.random.default_rng(3).exponential(size=(C, T, K)).astype(np.float32) * 2.5e-4,
        device=dev,
    )
    v = torch.full((C, T), 1e-5, device=dev)
    eta = eta_schedule("ascend", T, device=dev).expand(C, T).contiguous()
    inc = torch.full_like(h2, 0.15 / T)
    out = tt.ocean_traj(cfg, h2, v, eta, inc)
    plain = tt.ocean_traj_plain(cfg, h2, v, eta, inc)
    torch.cuda.synchronize()
    assert torch.equal(out.a, plain.a) and torch.equal(out.nsel, plain.nsel)
    torch.testing.assert_close(out.b, plain.b, atol=B_ATOL, rtol=0)
    torch.testing.assert_close(out.q_final, plain.q_final, atol=1e-6, rtol=1e-5)
