"""K3's ranked row under ``ranking="sort"`` past K = 2048 on the CPU, held to
the reference's own sort path.

``tests/test_torch_wide_sort.py`` holds its sort-ranked cases to the
reference's top-m path with a clip of 256 (its sort path sweeps all K + 1
prefixes, seconds a run).  Here, on that file's inputs (K = 2100, 3
rounds, newton) for seed 0, whose rounds 1 and 2 have 45 and 148
positive clients (seed 1 has at most 5), the reference's
``simulate(traj="scan", ranking="sort")`` is run itself: it equals that
top-m run bit for bit on every output, and the port's fused sort
trajectory (``simulate(traj="fused", device="cpu")``, K3's plain
version) is held to it at the ROADMAP parity rule's tolerances
(selections exact, b and P3 within 2e-4, queues within 1e-6 + 1e-5 |q|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_wide_sort as ws  # noqa: E402
from repro_torch.convert import decisions_to_numpy  # noqa: E402
from repro_torch.core.ocean import simulate  # noqa: E402
from repro_torch.core.patterns import eta_schedule  # noqa: E402


def test_sort_matches_the_reference_sort_path():
    cfg = ws.JConfig(num_clients=ws.K, num_rounds=ws.T,
                     radio=ws.JRadio(b_min=ws.B_MIN, model_bits=ws.BITS), frame_len=ws.R,
                     solver="newton", ranking="sort")
    h2, inc = ws._h2()[0], ws._inc()[0]
    state, ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda h, i: ws.j_simulate(cfg, h, ws.j_eta_schedule("ascend", ws.T), ws.V,
                                   budget_seq=i, traj="scan"))(jnp.asarray(h2), jnp.asarray(inc)))[:2]
    rho = np.asarray(ref.rho)
    assert ((rho > 1e-30) & (rho < 1e29)).sum(-1).tolist() == [0, 45, 148]
    # the oracle of tests/test_torch_wide_sort.py, bit for bit
    topm_state, topm = ws._reference("sort")[:2]
    for f in ("a", "b", "e", "q", "rho", "objective", "num_selected"):
        np.testing.assert_array_equal(getattr(ref, f), np.asarray(getattr(topm, f))[0], err_msg=f)
    np.testing.assert_array_equal(state.q, topm_state.q[0])
    # the port's sort trajectory against it
    port = ws._cfg("sort")
    t_state, decs = simulate(port, torch.tensor(h2)[None], eta_schedule("ascend", ws.T), ws.V,
                             budget_seq=torch.tensor(inc)[None], traj="fused", device="cpu")[:2]
    d = decisions_to_numpy(decs)
    np.testing.assert_array_equal(d["a"].reshape(ref.a.shape), ref.a)
    np.testing.assert_array_equal(d["num_selected"].reshape(-1), ref.num_selected)
    np.testing.assert_allclose(d["b"].reshape(ref.b.shape), ref.b, atol=ws.B_ATOL, rtol=0)
    np.testing.assert_allclose(d["objective"].reshape(-1), ref.objective, rtol=ws.W_RTOL)
    np.testing.assert_allclose(t_state.q.numpy()[0], state.q, rtol=ws.Q_RTOL, atol=ws.Q_ATOL)
