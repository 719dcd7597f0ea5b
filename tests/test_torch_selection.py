"""repro_torch's P3 solve (OCEAN-P) and top-m ranking against the reference.

``ocean_p`` on the sort and the top-m path is held to the JAX package for
every solver; ``topm_extract`` and the K2 plain version are held to the
pure-jnp oracles of ``repro/kernels/ref.py`` (the reference's own Pallas
K2 kernel cannot run under the installed jax), at the tolerances of
``tests/test_ranking.py``.  Inputs come from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.energy import RadioParams as JRadio  # noqa: E402
from repro.core.selection import ocean_p as j_ocean_p  # noqa: E402
from repro.core.selection import p3_value as j_p3_value  # noqa: E402
from repro.kernels.ref import ocean_p_topm_ref, topm_extract_ref  # noqa: E402
from repro_torch.core.energy import RadioParams as TRadio  # noqa: E402
from repro_torch.core.selection import (  # noqa: E402
    RHO_DEMOTED,
    ocean_p,
    p3_value,
    priorities,
    topm_extract,
)
from repro_torch.kernels import ocean_p as tk  # noqa: E402

B_ATOL, W_RTOL = 2e-4, 2e-4


def _tied_inputs(rng, k, tie_eps=1e-9, zero_frac=0.2):
    """tests/test_ranking.py's idiom: clustered rho values split by
    +-tie_eps relative jitter, with a random zero fraction (S0)."""
    base_q = rng.uniform(0.01, 0.2, size=(k + 1) // 2)
    q = np.repeat(base_q, 2)[:k] * (1.0 + rng.uniform(-tie_eps, tie_eps, size=k))
    q[rng.random(k) < zero_frac] = 0.0
    base_h = rng.uniform(0.5, 2.0, size=(k + 1) // 2) * 2.5e-4
    h2 = np.repeat(base_h, 2)[:k] * (1.0 + rng.uniform(-tie_eps, tie_eps, size=k))
    return q.astype(np.float32), h2.astype(np.float32)


def _cells(seed, c, k, tie_eps=1e-9):
    rng = np.random.default_rng(seed)
    pairs = [_tied_inputs(rng, k, tie_eps) for _ in range(c)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _assert_solution_close(got, ref, msg=""):
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(ref.a), err_msg=msg + "a")
    assert got.num_selected.dtype == torch.int32
    np.testing.assert_array_equal(
        got.num_selected.numpy(), np.asarray(ref.num_selected), err_msg=msg + "n"
    )
    np.testing.assert_allclose(got.b.numpy(), np.asarray(ref.b), atol=B_ATOL, err_msg=msg + "b")
    np.testing.assert_allclose(
        got.objective.numpy(), np.asarray(ref.objective), rtol=W_RTOL, err_msg=msg + "W"
    )
    np.testing.assert_array_equal(got.rho.numpy(), np.asarray(ref.rho), err_msg=msg + "rho")


@pytest.mark.parametrize("solver", ["bisect", "pallas"])
def test_ocean_p_sort_and_topm_match_reference(solver):
    """The oracle solver and the K1 sweep on clustered (tied) rho, v = 1e-4
    so a good share of the clients is selected (``newton`` is held to the
    reference at the prefix level, tests/test_torch_energy_solvers.py).
    Both rankings are held to the reference's sort path: its top-m path
    equals it bit for bit whenever the optimum fits (tests/test_ranking.py),
    and the port's top-m must equal the port's sort the same way."""
    q, h2 = _cells(1, 4, 10)
    v = 1e-4
    top_m = 6
    ref = jax.jit(jax.vmap(lambda q, h: j_ocean_p(q, h, v, 1.0, JRadio(), solver=solver)))(
        jnp.asarray(q), jnp.asarray(h2)
    )
    tq, th = torch.tensor(q), torch.tensor(h2)
    got_sort = ocean_p(tq, th, v, 1.0, TRadio(), solver=solver)
    got_topm = ocean_p(tq, th, v, 1.0, TRadio(), solver=solver, ranking="topm", top_m=top_m)
    n0 = (q == 0).sum(1)
    assert (got_sort.num_selected.numpy() > n0).any()  # not just S0
    assert (got_sort.num_selected.numpy() - n0 <= top_m).all()  # the optimum fits
    _assert_solution_close(got_sort, ref, f"{solver} sort ")
    _assert_solution_close(got_topm, ref, f"{solver} topm ")
    for f in got_sort._fields:
        assert torch.equal(getattr(got_sort, f), getattr(got_topm, f)), f


def test_priorities_and_p3_value_match_reference():
    q, h2 = _cells(2, 3, 8)
    a = np.random.default_rng(2).random((3, 8)) < 0.5
    b = np.where(a, 1.0 / 8, 0.0).astype(np.float32)
    ref = jax.vmap(lambda a, b, q, h: j_p3_value(a, b, q, h, 1e-4, 1.0, JRadio()))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(q), jnp.asarray(h2)
    )
    tq, th = torch.tensor(q), torch.tensor(h2)
    got = p3_value(torch.tensor(a), torch.tensor(b), tq, th, 1e-4, 1.0, TRadio())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    np.testing.assert_array_equal(priorities(tq, th).numpy(), q / np.maximum(h2, 1e-30))


@pytest.mark.parametrize("k,top_m", [(10, 4), (33, 33), (40, 38)])
def test_topm_extract_matches_stable_argsort_oracle(k, top_m):
    """Exact values and indices, ties broken by client index, exhausted
    slots +inf / 0 (top_m above the positive count)."""
    q, h2 = _cells(k, 2, k)
    rho = q / np.maximum(h2, 1e-30)
    vals, idx = topm_extract(torch.tensor(rho), top_m)
    for c in range(2):
        v_ref, i_ref = topm_extract_ref(jnp.asarray(rho[c]), top_m)
        np.testing.assert_array_equal(vals[c].numpy(), np.asarray(v_ref))
        np.testing.assert_array_equal(idx[c].numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("k,block_k", [(3, 8), (17, 8), (130, 128)])
def test_k2_plain_matches_oracle(k, block_k):
    """The K2 plain version (through the pallas_tiled backend) vs
    ``ref.ocean_p_topm_ref`` with tie_eps = 1e-4 ties, at test_ranking.py's
    tolerances (selection exact, b rtol 2e-4 atol 1e-6, W rtol 2e-4)."""
    rng = np.random.default_rng(k)
    q, h2 = _tied_inputs(rng, k, tie_eps=1e-4)
    radio_kw = dict(b_min=min(0.005, 0.9 / k))
    ref = jax.jit(
        lambda q, h: ocean_p_topm_ref(q, h, 1e-5, 1.0, JRadio(**radio_kw))
    )(jnp.asarray(q), jnp.asarray(h2))
    got = ocean_p(
        torch.tensor(q)[None], torch.tensor(h2)[None], 1e-5, 1.0, TRadio(**radio_kw),
        solver="pallas_tiled", ranking="topm", top_m=k, block_k=block_k,
    )
    np.testing.assert_array_equal(got.a[0].numpy(), np.asarray(ref.a))
    np.testing.assert_array_equal(got.num_selected[0].numpy(), np.asarray(ref.num_selected))
    np.testing.assert_allclose(got.b[0].numpy(), np.asarray(ref.b), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(float(got.objective[0]), float(ref.objective), rtol=2e-4)


def test_k2_index_range_and_ranking_errors_mirror_reference():
    rho = torch.ones((1, 4))
    n0 = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\^24"):
        tk.ocean_p_topm_fused(
            torch.ones((1, 1 << 24)), n0, torch.ones(1), torch.ones(1), TRadio(b_min=1e-8),
            top_m=1, block_k=128,
        )
    with pytest.raises(ValueError, match="top_m"):
        tk.ocean_p_topm_fused(rho, n0, torch.ones(1), torch.ones(1), TRadio(), top_m=0)
    with pytest.raises(ValueError, match="sort-free"):
        ocean_p(torch.zeros((1, 4)), torch.ones((1, 4)), 1e-5, 1.0, TRadio(), solver="pallas_tiled")


def test_admit_mask_demotes_clients():
    """Demoted clients get rho = RHO_DEMOTED, sort last and never win: the
    solution equals the one without them (they hold no S0 slot either)."""
    q, h2 = _cells(4, 2, 8)
    q[:, :3] = np.maximum(q[:, :3], 0.05)  # demoted clients are not S0
    admit = np.ones((2, 8), bool)
    admit[:, :3] = False
    tq, th = torch.tensor(q), torch.tensor(h2)
    got = ocean_p(tq, th, 1e-4, 1.0, TRadio(), solver="pallas", admit=torch.tensor(admit))
    sub = ocean_p(tq[:, 3:], th[:, 3:], 1e-4, 1.0, TRadio(), solver="pallas")
    assert not got.a[:, :3].any() and not (got.b[:, :3] != 0).any()
    assert (got.rho[:, :3] == np.float32(RHO_DEMOTED)).all()
    assert torch.equal(got.a[:, 3:], sub.a) and torch.equal(got.num_selected, sub.num_selected)
    torch.testing.assert_close(got.b[:, 3:], sub.b, atol=B_ATOL, rtol=0)
    torch.testing.assert_close(got.objective, sub.objective, rtol=W_RTOL, atol=0)
