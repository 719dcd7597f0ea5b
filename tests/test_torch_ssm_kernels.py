"""K6 and K7's plain versions against the JAX package's Pallas kernels, on the CPU.

The JAX side runs ``repro.kernels.ops.wkv_scan`` / ``ops.mamba_scan`` in
interpret mode, as ``tests/test_kernels.py`` does, at that file's shapes
and tolerances (atol = rtol = 5e-4 for the WKV scan, 2e-4 for the
selective scan: float32 on both sides, sums taken in another order);
the port's wrappers get CPU tensors and so run their plain versions.
A ragged T (and Di) that the Pallas kernels' chunking cannot take is
held to the oracles ``ref.wkv_scan_ref`` / ``ref.mamba_scan_ref``, and
the decode recurrences that start from a carried state to the JAX
models' own scans.  Inputs come from a numpy seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro.models.mamba import _ssm_chunk  # noqa: E402
from repro.models.rwkv import _wkv_scan  # noqa: E402
from repro_torch.kernels import mamba_scan as km  # noqa: E402
from repro_torch.kernels import rwkv6_scan as kr  # noqa: E402

WKV_TOL = 5e-4
MAMBA_TOL = 2e-4


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def _wkv_inputs(seed, b, t, h, n):
    rng = np.random.default_rng(seed)
    r, k, v, w = (rng.standard_normal((b, t, h, n)).astype(np.float32) for _ in range(4))
    u = rng.standard_normal((h, n)).astype(np.float32)
    return r, k, v, _sigmoid(w), u


def _mamba_inputs(seed, b, t, di, ds):
    rng = np.random.default_rng(seed)
    da = _sigmoid(rng.standard_normal((b, t, di, ds)).astype(np.float32))
    dbu = (0.1 * rng.standard_normal((b, t, di, ds))).astype(np.float32)
    c = rng.standard_normal((b, t, ds)).astype(np.float32)
    return da, dbu, c


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("b,t,h,n", [(2, 128, 4, 64), (1, 64, 2, 32), (1, 192, 3, 64)])
def test_k7_plain_matches_pallas_interpret(b, t, h, n):
    arrs = _wkv_inputs(t + h, b, t, h, n)
    expected = ops.wkv_scan(*map(jnp.asarray, arrs), interpret=True)
    before = kr.wkv_scan.launches
    out = kr.wkv_scan(*_torch(arrs))
    assert kr.wkv_scan.launches == before  # CPU tensors: the plain version
    assert out.dtype == torch.float32 and out.shape == (b, t, h, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=WKV_TOL, rtol=WKV_TOL)


def test_k7_plain_ragged_t_matches_oracle():
    arrs = _wkv_inputs(7, 2, 77, 3, 64)
    expected = ref.wkv_scan_ref(*map(jnp.asarray, arrs))
    out = kr.wkv_scan(*_torch(arrs))
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=WKV_TOL, rtol=WKV_TOL)


def test_k7_recurrence_from_a_state_matches_the_model_scan():
    """The decode path's recurrence (carried state in, final state out)
    against ``repro.models.rwkv._wkv_scan``."""
    r, k, v, w, u = _wkv_inputs(11, 2, 9, 2, 32)
    s0 = np.random.default_rng(12).standard_normal((2, 2, 32, 32)).astype(np.float32)
    y_ref, s_ref = _wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    y, s = kr.wkv_recurrence(*_torch((r, k, v, w, u, s0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=WKV_TOL, rtol=WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=WKV_TOL, rtol=WKV_TOL)


@pytest.mark.parametrize("b,t,di,ds", [(2, 128, 256, 16), (1, 64, 128, 8), (1, 128, 512, 16)])
def test_k6_plain_matches_pallas_interpret(b, t, di, ds):
    arrs = _mamba_inputs(t + di, b, t, di, ds)
    expected = ops.mamba_scan(*map(jnp.asarray, arrs), interpret=True)
    before = km.mamba_scan.launches
    out = km.mamba_scan(*_torch(arrs))
    assert km.mamba_scan.launches == before  # CPU tensors: the plain version
    assert out.dtype == torch.float32 and out.shape == (b, t, di)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=MAMBA_TOL, rtol=MAMBA_TOL)


def test_k6_plain_ragged_t_and_di_match_oracle():
    arrs = _mamba_inputs(5, 2, 45, 100, 16)
    expected = ref.mamba_scan_ref(*map(jnp.asarray, arrs))
    out = km.mamba_scan(*_torch(arrs))
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=MAMBA_TOL, rtol=MAMBA_TOL)


def test_k6_recurrence_from_a_state_matches_the_model_scan():
    """The decode path's recurrence against ``repro.models.mamba._ssm_chunk``."""
    da, dbu, c = _mamba_inputs(13, 2, 7, 24, 8)
    h0 = np.random.default_rng(14).standard_normal((2, 24, 8)).astype(np.float32)
    y_ref, h_ref = _ssm_chunk(*map(jnp.asarray, (da, dbu, c, h0)))
    y, h = km.selective_recurrence(*_torch((da, dbu, c, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=MAMBA_TOL, rtol=MAMBA_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=MAMBA_TOL, rtol=MAMBA_TOL)


def test_wrappers_refuse_mismatched_shapes():
    r, k, v, w, u = _torch(_wkv_inputs(0, 1, 8, 2, 32))
    with pytest.raises(ValueError, match="u must be"):
        kr.wkv_scan(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="share one"):
        kr.wkv_scan(r, k, v[:, :4], w, u)
    da, dbu, c = _torch(_mamba_inputs(0, 1, 8, 16, 8))
    with pytest.raises(ValueError, match="C must be"):
        km.mamba_scan(da, dbu, c[..., :4])
    with pytest.raises(ValueError, match="share one"):
        km.mamba_scan(da, dbu[:, :4], c)
