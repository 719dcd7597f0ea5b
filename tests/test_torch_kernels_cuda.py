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
    h_plain, _ = model(toks, plain_attention=True)
    torch.cuda.synchronize()
    rel = ((h.float() - h_plain.float()).norm() / h_plain.float().norm()).item()
    assert rel < 2e-2, rel
