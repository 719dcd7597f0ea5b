"""The port's decoder LM (``repro_torch.models``) against the JAX package, on the CPU.

Smoke variants in float32, the reference's own random weights carried
over by ``repro_torch.convert.decoder_params_from_reference``, tokens
from a numpy seed.  Tolerance atol 1e-4 / rtol 1e-4 throughout: both
sides compute in float32 and differ only in summation order and in the
libraries' tanh/exp/cos ulps.
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
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = RTOL = 1e-4


def _pair(arch, seed=0, **over):
    """(jax model, jax params, port model) on the same weights."""
    jcfg = dataclasses.replace(j_smoke(J_CONFIGS[arch]), **over)
    cfg = dataclasses.replace(smoke_variant(ARCH_CONFIGS[arch]), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, "cpu")
    sd = decoder_params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    tm.load_state_dict(sd, strict=True)
    return jm, jp, tm, cfg


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_config_copy_matches_reference():
    for name, cfg in ARCH_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(J_CONFIGS[name])
        assert cfg.param_count() == J_CONFIGS[name].param_count()
        assert cfg.block_len == J_CONFIGS[name].block_len


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_carry_over_whole(dtype):
    jm, jp, tm, cfg = _pair("gemma2-27b", dtype=dtype)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tm.parameters()) == n_ref
    assert n_ref == cfg.param_count() + cfg.d_model  # the count leaves out the final norm
    assert [layer.kind for layer in tm.layers] == list(cfg.layer_kinds())
    wq = np.asarray(jp["blocks"][1]["attn"]["wq"][1], np.float32)  # layer 3, a global one
    assert tm.layers[3].attn.wq.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tm.layers[3].attn.wq.float().numpy(), wq)


@pytest.mark.parametrize("arch", ["gemma2-27b", "granite-20b", "command-r-35b"])
def test_forward_hidden_matches_reference(arch):
    """gemma2: local/global, softcaps, sqrt(d) embed scale; granite: MQA
    (g = 4), untied head, ungated MLP; command-r: silu, tied head."""
    jm, jp, tm, cfg = _pair(arch, seed=1)
    toks = _tokens(2, 2, 40, cfg.vocab)   # S = 40 > window 16: local layers mask
    h_ref, _ = jm.forward(jp, jnp.asarray(toks))
    h, aux = tm(torch.as_tensor(toks, dtype=torch.int64))
    assert h.shape == (2, 40, cfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL, rtol=RTOL)


def test_prefill_logits_match_reference():
    jm, jp, tm, cfg = _pair("gemma2-27b", seed=3)
    toks = _tokens(4, 2, 33, cfg.vocab)
    ref = j_prefill_step(jm, cfg)(jp, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(tm, cfg)({"tokens": torch.as_tensor(toks, dtype=torch.int64)})
    assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_plain_attention_flag_is_the_cpu_path():
    _, _, tm, cfg = _pair("gemma2-27b", seed=5)
    toks = torch.as_tensor(_tokens(6, 1, 24, cfg.vocab), dtype=torch.int64)
    h, _ = tm(toks)
    h_plain, _ = tm(toks, plain=True)
    assert torch.equal(h, h_plain)


def test_decode_steps_match_reference():
    """24 steps pass the smoke window of 16: the local ring wraps."""
    jm, jp, tm, cfg = _pair("gemma2-27b", seed=7)
    b, steps = 2, 24
    toks = _tokens(8, b, steps, cfg.vocab)
    jstep = jax.jit(jm.decode_step)
    jcache = jm.init_cache(b, 32)
    cache = tm.init_cache(b, 32)
    assert [c.k.shape[1] for c in cache] == [16, 32, 16, 32]
    serve = make_serve_step(tm, cfg)
    for t in range(steps):
        ref, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.asarray(t, jnp.int32))
        got, cache = serve(cache, torch.as_tensor(toks[:, t : t + 1], dtype=torch.int64), t)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL, err_msg=f"step {t}"
        )


def test_decode_continues_the_prefill():
    """The last prefill logits equal the decode path's after the same tokens."""
    _, _, tm, cfg = _pair("gemma2-27b", seed=9)
    toks = torch.as_tensor(_tokens(10, 2, 20, cfg.vocab), dtype=torch.int64)
    pre = make_prefill_step(tm, cfg)({"tokens": toks})
    cache = tm.init_cache(2, 20)
    serve = make_serve_step(tm, cfg)
    for t in range(20):
        dec, cache = serve(cache, toks[:, t : t + 1], t)
    torch.testing.assert_close(dec, pre, atol=ATOL, rtol=RTOL)


def test_generate_is_seeded_and_greedy_is_argmax():
    _, _, tm, cfg = _pair("gemma2-27b", seed=11)
    a = generate(tm, cfg, batch=2, prompt_len=5, gen=6, temperature=0.0, seed=4)
    b = generate(tm, cfg, batch=2, prompt_len=5, gen=6, temperature=0.0, seed=4)
    assert torch.equal(a["prompt"], b["prompt"]) and torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (2, 6) and a["decode_steps"] == 5
    s = generate(tm, cfg, batch=2, prompt_len=5, gen=6, temperature=1.0, seed=4)
    assert s["tokens"].shape == (2, 6) and int(s["tokens"].max()) < cfg.vocab


def test_init_is_seeded_per_tensor():
    cfg = smoke_variant(ARCH_CONFIGS["gemma2-27b"])
    big = build_model(cfg, "cpu").init(3)
    small = build_model(dataclasses.replace(cfg, num_layers=2), "cpu").init(3)
    sd_big = big.state_dict()
    for name, t in small.state_dict().items():
        assert torch.equal(t, sd_big[name]), name
    assert float(big.layers[0].ln1.scale.abs().max()) == 0.0
    std = float(big.layers[0].attn.wq.std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


@pytest.mark.parametrize(
    "change, what",
    [
        (dict(arch_type="audio"), "audio"),
        (dict(num_patches=4), "VLM"),
    ],
)
def test_unported_parts_raise(change, what):
    cfg = dataclasses.replace(smoke_variant(ARCH_CONFIGS["gemma2-27b"]), **change)
    with pytest.raises(NotImplementedError, match=what):
        build_model(cfg, "cpu")


def test_entry_points_need_the_card_unless_told(monkeypatch):
    cfg = smoke_variant(ARCH_CONFIGS["gemma2-27b"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
