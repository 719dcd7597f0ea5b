"""gemma3-1b's smoke variant on the port against the JAX package, on the CPU.

At head_dim 256 (the model's own) and 8 layers: one 5:1 local:global
superblock and two trailing local layers, MQA with 4 query heads, qk-norm.
The weights are drawn from a numpy seed in the shapes of the reference's
parameter tree (``jax.eval_shape`` of its init, which would take seconds
run eagerly), every norm scale (the layers', qk-norm's and the final one)
nonzero, so that the norms' scales are exercised and not left at 1 + 0,
and are carried over by ``repro_torch.convert.decoder_params_from_reference``.
The reference runs under ``jax.jit``, its forward and prefill in one call.
Tolerance atol 1e-4 / rtol 1e-4, as ``tests/test_torch_decoder.py``: both
sides compute in float32 and differ in summation order and the libraries'
ulps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_CONFIGS as J_CONFIGS  # noqa: E402
from repro.configs import smoke_variant as j_smoke  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill_step  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import ARCH_CONFIGS, smoke_variant  # noqa: E402
from repro_torch.convert import decoder_params_from_reference  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = RTOL = 1e-4
ARCH = "gemma3-1b"
OVER = dict(head_dim=256, num_layers=8)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, config) on the same weights."""
    jcfg = dataclasses.replace(j_smoke(J_CONFIGS[ARCH]), **OVER)
    cfg = dataclasses.replace(smoke_variant(ARCH_CONFIGS[ARCH]), **OVER)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = j_build(jcfg)
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        std = 0.3 if name.endswith("['scale']") else 0.03 if name == "['embed']" else 0.06
        return rng.normal(0.0, std, leaf.shape).astype(np.float32)

    jp = jax.tree_util.tree_map_with_path(draw, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    tm = build_model(cfg, "cpu")
    tm.load_state_dict(decoder_params_from_reference(jp, cfg), strict=True)
    return jm, jax.tree.map(jnp.asarray, jp), tm, cfg


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def prefill(pair):
    """Tokens (S = 40 > the smoke window of 16: the local layers mask) and
    the reference's hidden states and prefill logits on them, from one
    jitted call."""
    jm, jp, _, cfg = pair
    toks = _tokens(2, 2, 40, cfg.vocab)
    step = j_prefill_step(jm, cfg)

    @jax.jit
    def ref(params, tokens):
        return jm.forward(params, tokens)[0], step(params, {"tokens": tokens})

    return (toks, *map(np.asarray, ref(jp, jnp.asarray(toks))))


def test_smoke_config_is_gemma3s_pattern_at_head_dim_256(pair):
    _, _, tm, cfg = pair
    assert list(cfg.layer_kinds()) == ["local"] * 5 + ["global"] + ["local"] * 2
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.use_qk_norm) == (4, 1, 256, True)
    assert float(tm.layers[6].attn.q_norm.scale.abs().min()) > 0.0  # a remainder layer's


def test_forward_hidden_matches_reference(pair, prefill):
    _, _, tm, cfg = pair
    toks, h_ref, _ = prefill
    h, _ = tm(torch.as_tensor(toks, dtype=torch.int64))
    assert h.shape == (2, 40, cfg.d_model)
    np.testing.assert_allclose(h.numpy(), h_ref, atol=ATOL, rtol=RTOL)


def test_prefill_logits_match_reference(pair, prefill):
    _, _, tm, cfg = pair
    toks, _, ref = prefill
    got = make_prefill_step(tm, cfg)({"tokens": torch.as_tensor(toks, dtype=torch.int64)})
    assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_decode_steps_match_reference(pair):
    jm, jp, tm, cfg = pair
    b, steps = 2, 4
    toks = _tokens(8, b, steps, cfg.vocab)
    jcache = jm.init_cache(b, 8)
    cache = tm.init_cache(b, 8)
    serve = make_serve_step(tm, cfg)
    jstep = jax.jit(jm.decode_step)
    for t in range(steps):
        ref, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.asarray(t, jnp.int32))
        got, cache = serve(cache, torch.as_tensor(toks[:, t : t + 1], dtype=torch.int64), t)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL, err_msg=f"step {t}"
        )
