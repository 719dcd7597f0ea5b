"""repro_torch physics and P4/prefix solvers against the JAX reference.

Inputs are drawn with numpy from fixed seeds and handed to both packages;
every JAX function runs under ``jax.jit`` at one fixed shape (cells are
batched with ``jax.vmap``), so the reference's interpret-mode Pallas
kernel compiles once.  Tolerances are float32's: the two packages use
different exp2/log2 implementations and sum in different orders.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.bandwidth as jbw  # noqa: E402
jen = importlib.import_module("repro.core.energy")  # shadowed by repro.core.energy()
import repro.core.solvers as jsol  # noqa: E402
from repro.kernels.ocean_p import ocean_p_prefixes_fused as j_prefixes_fused  # noqa: E402
import repro_torch.core.bandwidth as tbw  # noqa: E402
ten = importlib.import_module("repro_torch.core.energy")
import repro_torch.core.solvers as tsol  # noqa: E402
from repro_torch.core.selection import prefix_inputs, priorities  # noqa: E402
from repro_torch.kernels import ocean_p as tk  # noqa: E402

JR, TR = jen.RadioParams(), ten.RadioParams()
C, K = 4, 10
B_ATOL, W_RTOL = 2e-4, 2e-4   # the kernel-parity tolerances of the slice


def _draws(seed, c=C, k=K, v_scale=1e-4):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.01, 0.2, (c, k)).astype(np.float32)
    q[rng.random((c, k)) < 0.2] = 0.0
    h2 = (rng.uniform(0.5, 2.0, (c, k)) * 2.5e-4).astype(np.float32)
    v_eta = (rng.uniform(0.2, 1.8, c) * v_scale).astype(np.float32)
    return q, h2, v_eta


def _sorted_inputs(q, h2, radio=TR):
    rho = priorities(torch.tensor(q), torch.tensor(h2))
    _, rho_sorted, n0, delta = prefix_inputs(rho, radio)
    return rho_sorted, n0, delta


def test_energy_functions_match_reference():
    """f, f', f'', exp2m1, transmit power and E — including b = 0, subnormal
    and tiny b (the 1e-30 floor) and large exponents (the +-80 clip)."""
    b = np.array(
        [0.0, 1e-40, 1e-30, 1e-12, 1e-4, 2e-3, 0.02, 0.1, 0.5, 1.0, 3.0, 1e3],
        np.float32,
    )
    h2 = np.full_like(b, 2.5e-4)
    x = np.array([-100.0, -3.0, 0.0, 1e-6, 0.5, 10.0, 79.9, 80.0, 200.0], np.float32)

    @jax.jit
    def ref(b, h2, x):
        return (
            jen.f_shannon(b, JR.beta), jen.f_shannon_prime(b, JR.beta),
            jen.f_shannon_second(b, JR.beta), jen.exp2m1(x),
            jen.transmit_power_w_per_hz(b, h2, JR), jen.energy(b, h2, JR),
        )

    want = ref(jnp.asarray(b), jnp.asarray(h2), jnp.asarray(x))
    tb, th, tx = torch.tensor(b), torch.tensor(h2), torch.tensor(x)
    got = (
        ten.f_shannon(tb, TR.beta), ten.f_shannon_prime(tb, TR.beta),
        ten.f_shannon_second(tb, TR.beta), ten.exp2m1(tx),
        ten.transmit_power_w_per_hz(tb, th, TR), ten.energy(tb, th, TR),
    )
    # f' = 2^y (1 - ln2 y) - 1 cancels to ~(ln2 y)^2 / 2 at large b: there
    # the two packages' exp2 differ by an ulp of the O(1) terms, 2.4e-7.
    atols = {"f'": 2.4e-7}
    for name, w, g in zip(("f", "f'", "f''", "exp2m1", "p", "E"), want, got):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=2e-6, atol=atols.get(name, 0.0), err_msg=name
        )
    assert float(got[-1][0]) == 0.0  # E is exactly 0 at b = 0


def test_radio_params_mirror_reference():
    for kw in ({}, {"b_min": 0.005, "model_bits": 1e6}):
        j, t = jen.RadioParams(**kw), ten.RadioParams(**kw)
        assert (j.beta, j.energy_scale) == (t.beta, t.energy_scale)
    with pytest.raises(ValueError, match="infeasible"):
        ten.RadioParams(b_min=0.2).validate(10)
    with pytest.raises(ValueError, match="positive"):
        ten.RadioParams(noise_w=0.0).validate(10)


def test_min_bandwidth_for_energy_matches_reference():
    rng = np.random.default_rng(3)
    h2 = (rng.uniform(0.2, 3.0, 16) * 2.5e-4).astype(np.float32)
    e_budget = np.concatenate(
        [rng.uniform(1e-4, 2e-3, 14), [1e-9, 1e3]]
    ).astype(np.float32)  # one infeasible (+inf), one already met at b_min
    want = jax.jit(lambda e, h: jen.min_bandwidth_for_energy(e, h, JR))(
        jnp.asarray(e_budget), jnp.asarray(h2)
    )
    got = ten.min_bandwidth_for_energy(torch.tensor(e_budget), torch.tensor(h2), TR)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def _p4_inputs():
    q, h2, _ = _draws(5)
    rho = (q / h2).astype(np.float32)
    mask = rho > 0
    mask[:, 7:] = False
    return rho, mask, np.ones(C, np.float32)


def test_solve_p4_matches_reference():
    rho, mask, delta = _p4_inputs()
    fn = jax.jit(jax.vmap(lambda r, m, d: jbw.solve_p4(r, m, d, JR)))
    b_ref, c_ref = fn(jnp.asarray(rho), jnp.asarray(mask), jnp.asarray(delta))
    b, c = tbw.solve_p4(torch.tensor(rho), torch.tensor(mask), torch.tensor(delta), TR)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-4)
    np.testing.assert_allclose(b.sum(1).numpy(), delta, atol=1e-5)


def test_waterfill_newton_matches_bisect():
    """``solve_p4(method="newton")`` (the Newton waterfiller) solves the same
    convex P4 as the bisection held to the reference above."""
    rho, mask, delta = (torch.tensor(x) for x in _p4_inputs())
    b_ref, c_ref = tbw.solve_p4(rho, mask, delta, TR)
    b, c = tbw.solve_p4(rho, mask, delta, TR, method="newton")
    np.testing.assert_allclose(b.numpy(), b_ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), c_ref.numpy(), rtol=1e-4)
    assert not b[~mask].any()


@pytest.mark.parametrize(
    "name,ref_fn",
    [("bisect", jsol._prefix_bisect), ("newton", jsol._prefix_newton)],
)
def test_prefix_solvers_match_reference(name, ref_fn):
    q, h2, v_eta = _draws(7)
    rho_sorted, n0, delta = _sorted_inputs(q, h2)
    fn = jax.jit(jax.vmap(lambda r, n, d, ve: ref_fn(r, n, d, ve, JR, 42, 42)))
    ref = fn(
        jnp.asarray(rho_sorted.numpy()), jnp.asarray(n0.numpy().astype(np.int32)),
        jnp.asarray(delta.numpy()), jnp.asarray(v_eta),
    )
    got = tsol.get_solver(name).prefixes(
        rho_sorted, n0, delta, torch.tensor(v_eta), TR, 42, 42
    )
    assert got.m_star.dtype == torch.int32
    np.testing.assert_array_equal(got.m_star.numpy(), np.asarray(ref.m_star))
    np.testing.assert_array_equal(got.sel_pos_sorted.numpy(), np.asarray(ref.sel_pos_sorted))
    np.testing.assert_allclose(got.b_pos_sorted.numpy(), np.asarray(ref.b_pos_sorted), atol=B_ATOL)
    np.testing.assert_allclose(got.w_star.numpy(), np.asarray(ref.w_star), rtol=W_RTOL)


def test_newton_budget_table_mirrors_reference():
    for dtype, jd in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        for k in (None, 10, 128, 129, 4096, 4097, 10_000):
            assert tsol.newton_iteration_budgets(dtype, k) == jsol.newton_iteration_budgets(jd, k)


def test_k1_plain_matches_pallas_reference():
    """K1's plain version vs the JAX fused kernel (interpret mode) at K = 10
    on 4 seeds: m* and selections exact, b atol 2e-4, W rtol 2e-4."""
    q = np.concatenate([_draws(s, c=1)[0] for s in range(4)])
    h2 = np.concatenate([_draws(s, c=1)[1] for s in range(4)])
    v_eta = np.concatenate([_draws(s, c=1)[2] for s in range(4)])
    rho_sorted, n0, delta = _sorted_inputs(q, h2)
    fn = jax.jit(jax.vmap(lambda r, n, d, ve: j_prefixes_fused(r, n, d, ve, JR)))
    ref = fn(
        jnp.asarray(rho_sorted.numpy()), jnp.asarray(n0.numpy().astype(np.int32)),
        jnp.asarray(delta.numpy()), jnp.asarray(v_eta),
    )
    got = tk.ocean_p_prefixes_fused(rho_sorted, n0, delta, torch.tensor(v_eta), TR)
    assert (got.m_star > 0).any()  # the draws select somebody
    np.testing.assert_array_equal(got.m_star.numpy(), np.asarray(ref.m_star))
    np.testing.assert_array_equal(got.sel_pos_sorted.numpy(), np.asarray(ref.sel_pos_sorted))
    np.testing.assert_allclose(got.b_pos_sorted.numpy(), np.asarray(ref.b_pos_sorted), atol=B_ATOL)
    np.testing.assert_allclose(got.w_star.numpy(), np.asarray(ref.w_star), rtol=W_RTOL)


def test_k1_wrapper_routes_cpu_tensors_to_the_plain_version():
    q, h2, v_eta = _draws(11)
    rho_sorted, n0, delta = _sorted_inputs(q, h2)
    scal = tk._scal(n0, delta, torch.tensor(v_eta), TR, rho_sorted)
    before = tk.ocean_p_prefix.launches
    b, wm = tk.ocean_p_prefix(scal, rho_sorted)
    b_p, wm_p = tk.ocean_p_prefix_plain(scal, rho_sorted)
    assert tk.ocean_p_prefix.launches == before  # nothing was launched
    assert torch.equal(b, b_p) and torch.equal(wm, wm_p)
    with pytest.raises(ValueError, match="float32"):
        tk.ocean_p_prefix(scal.double(), rho_sorted)
