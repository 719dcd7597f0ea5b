"""The port's RWKV6, Mamba and MoE layers against the JAX package, on the CPU.

Smoke variants of rwkv6-1.6b (2 RWKV6 layers, layernorm) and of
jamba-1.5-large-398b cut to its first 5 layers (Mamba + dense, Mamba +
MoE, Mamba + dense, Mamba + MoE, global attention + dense) in float32,
on the reference's own random weights carried over by
``repro_torch.convert.decoder_params_from_reference``, tokens from a
numpy seed.  RWKV6's decay LoRA ``wb`` starts at zero and the norms at
their identity, so the weights are perturbed away from init before they
cross over, and every path sees them.  Tolerance atol 1e-4 / rtol 1e-4
throughout, as in ``tests/test_torch_decoder.py``: both sides compute in
float32 and differ in summation order (the reference takes chunked
matrix and associative-scan forms of the recurrences, the port the
sequential ones) and in the libraries' exp/tanh ulps.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_CONFIGS as J_CONFIGS  # noqa: E402
from repro.configs import smoke_variant as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.layers import apply_norm as j_apply_norm  # noqa: E402
from repro.models.moe import apply_moe as j_apply_moe  # noqa: E402
from repro_torch.configs import ARCH_CONFIGS, smoke_variant  # noqa: E402
from repro_torch.convert import decoder_params_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import Norm, apply_norm  # noqa: E402
from repro_torch.models.moe import MoE, apply_moe, moe_route  # noqa: E402

ATOL = RTOL = 1e-4
RWKV, JAMBA = "rwkv6-1.6b", "jamba-1.5-large-398b"
CUTS = {RWKV: {}, JAMBA: {"num_layers": 5}}


def _perturb(tree, seed):
    """RWKV6's ``wb`` and every norm's scale/bias moved off their init values."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        key = getattr(path[-1], "key", None)
        if key == "wb":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        if key in ("scale", "bias"):
            return (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(move, tree)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's smoke weights (numpy), perturbed; drawn once per
    module, since the reference's eager init takes seconds."""
    jcfg = dataclasses.replace(j_smoke(J_CONFIGS[arch]), **CUTS[arch])
    tree = jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.PRNGKey(1)))
    return _perturb(tree, 101)


def _pair(arch, **over):
    """(jax model, jax params, port model, cfg) on the same perturbed weights;
    ``over`` may change fields that leave the parameter shapes alone."""
    over = {**CUTS[arch], **over}
    jcfg = dataclasses.replace(j_smoke(J_CONFIGS[arch]), **over)
    cfg = dataclasses.replace(smoke_variant(ARCH_CONFIGS[arch]), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    tree = _weights(arch)
    tm = build_model(cfg, "cpu")
    tm.load_state_dict(decoder_params_from_reference(tree, cfg), strict=True)
    return j_build(jcfg), jax.tree.map(jnp.asarray, tree), tm, cfg


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_layernorm_matches_reference(dtype, tol):
    rng = np.random.default_rng(0)
    x = (3.0 + rng.standard_normal((3, 5, 64))).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(64)).astype(np.float32)
    expected = j_apply_norm(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x).astype(dtype), "layernorm",
    )
    p = Norm(64, "layernorm")
    p.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    got = apply_norm(p, torch.from_numpy(x).to(getattr(torch, dtype)), "layernorm")
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(expected.astype(jnp.float32)), atol=tol, rtol=tol
    )


@pytest.mark.parametrize(
    "arch, b, s",
    [
        (RWKV, 2, 64),     # T % 32 == 0 and T > 32: the reference's chunked matrix form
        (RWKV, 1, 21),     # the reference's sequential scan
        (JAMBA, 1, 512),   # T % 256 == 0: the reference's chunked associative scan
        (JAMBA, 2, 40),
    ],
)
def test_forward_hidden_matches_reference(arch, b, s):
    jm, jp, tm, cfg = _pair(arch)
    toks = _tokens(2, b, s, cfg.vocab)
    h_ref, aux_ref = jm.forward(jp, jnp.asarray(toks))
    h, aux = tm(torch.as_tensor(toks, dtype=torch.int64))
    assert h.shape == (b, s, cfg.d_model)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), atol=ATOL, rtol=RTOL)
    if arch == JAMBA:
        assert float(aux) > 0.0  # two MoE layers' load-balance losses


def _ref_state(jcache, cfg, i):
    """Layer i's state in the reference's stacked (blocks, rem) cache."""
    bl, nsb = cfg.block_len, cfg.num_superblocks
    if i < nsb * bl:
        sb, j = divmod(i, bl)
        return jax.tree.map(lambda a: a[sb], jcache["blocks"][j])
    return jcache["rem"][i - nsb * bl]


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_decode_steps_match_reference(arch):
    """Logits at every step, and every layer's recurrent state at the end."""
    jm, jp, tm, cfg = _pair(arch)
    b, steps = 2, 6
    toks = _tokens(8, b, steps, cfg.vocab)
    jstep = jax.jit(jm.decode_step)
    jcache, cache = jm.init_cache(b, 8), tm.init_cache(b, 8)
    serve_step = make_serve_step(tm, cfg)
    for t in range(steps):
        ref, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.asarray(t, jnp.int32))
        got, cache = serve_step(cache, torch.as_tensor(toks[:, t : t + 1], dtype=torch.int64), t)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL, err_msg=f"step {t}"
        )
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind in ("global", "local"):
            continue
        ref_st = _ref_state(jcache, cfg, i)
        for field in cache[i]._fields:
            np.testing.assert_allclose(
                getattr(cache[i], field).numpy(), np.asarray(getattr(ref_st, field)),
                atol=ATOL, rtol=RTOL, err_msg=f"layer {i} ({kind}) {field}",
            )


@pytest.mark.parametrize("arch, over", [(RWKV, {}), (JAMBA, {"capacity_factor": 4.0})])
def test_prefill_matches_token_by_token_decode(arch, over):
    """In the port alone: the prefill (K6/K7's path) and the decode
    recurrence give the same last-position logits.  MoE capacity depends
    on the sequence length (a 20-token prefill gets 12 slots per expert
    at the default factor and drops choices; a decode step never does),
    so jamba runs with slots for every choice here."""
    _, _, tm, cfg = _pair(arch, **over)
    toks = torch.as_tensor(_tokens(10, 2, 20, cfg.vocab), dtype=torch.int64)
    pre = make_prefill_step(tm, cfg)({"tokens": toks})
    cache = tm.init_cache(2, 20)
    serve_step = make_serve_step(tm, cfg)
    for t in range(20):
        dec, cache = serve_step(cache, toks[:, t : t + 1], t)
    torch.testing.assert_close(dec, pre, atol=ATOL, rtol=RTOL)


def _ref_keep(p, x, cfg):
    """The reference's kept (token, choice) mask, from its own routing ops."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = int(max(1, round(s * k / e * cfg.capacity_factor)))
    oh = jax.nn.one_hot(idx.reshape(b, s * k), e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=1) - 1) * oh, axis=-1)
    return np.asarray(pos < cap), cap


@pytest.mark.parametrize("capacity_factor, capacity", [(0.25, 2), (0.75, 8)])
def test_moe_capacity_binds_and_drops_the_same_choices(capacity_factor, capacity):
    """20 tokens x top-2 over 4 experts: 40 x 0.25 / 4 = 2.5 rounds half
    to even (2 slots), 7.5 to 8; either way choices are dropped."""
    cfg = dataclasses.replace(smoke_variant(ARCH_CONFIGS[JAMBA]), capacity_factor=capacity_factor)
    rng = np.random.default_rng(3)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    params = {
        "router": rng.standard_normal((d, e)) / np.sqrt(d),
        "wi": rng.standard_normal((e, d, f)) / np.sqrt(d),
        "wg": rng.standard_normal((e, d, f)) / np.sqrt(d),
        "wo": rng.standard_normal((e, f, d)) / np.sqrt(f),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((2, 20, d)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out_ref, aux_ref = j_apply_moe(jp, jnp.asarray(x), cfg)
    keep_ref, cap_ref = _ref_keep(jp, jnp.asarray(x), cfg)

    p = MoE(cfg, torch.float32, "cpu")
    p.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x)
    rt = moe_route(p, xt, cfg)
    assert rt.capacity == cap_ref == capacity
    np.testing.assert_array_equal(rt.keep.numpy(), keep_ref)
    assert 0 < int((~rt.keep).sum()) < rt.keep.numel()
    out, aux = apply_moe(p, xt, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "arch, layers, stacked",
    [
        (RWKV, None, 2),      # block_len 1: both layers in blocks[0]
        (JAMBA, None, 16),    # the 16-layer smoke: 2 superblocks of 8
        (JAMBA, 9, 6),        # block_len 6: one superblock and 3 rem layers
    ],
)
def test_weights_carry_over_whole(arch, layers, stacked):
    cfg = smoke_variant(ARCH_CONFIGS[arch])
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    assert cfg.num_superblocks * cfg.block_len == stacked
    jp = jax.tree.map(np.asarray, j_build(cfg).init(jax.random.PRNGKey(4)))
    tm = build_model(cfg, "cpu")
    sd = decoder_params_from_reference(jp, cfg)
    tm.load_state_dict(sd, strict=True)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tm.parameters()) == n_ref
    assert [layer.kind for layer in tm.layers] == list(cfg.layer_kinds())
    last = cfg.num_layers - 1
    if last < stacked:
        sb, j = divmod(last, cfg.block_len)
        ref_layer = jax.tree.map(lambda a: a[sb], jp["blocks"][j])
    else:
        ref_layer = jp["rem"][last - stacked]
    name, leaf = ("rwkv", "wk") if arch == RWKV else ("mamba", "x_proj")
    if name not in ref_layer:
        name, leaf = "attn", "wq"
    np.testing.assert_array_equal(
        getattr(getattr(tm.layers[last], name), leaf).numpy(), ref_layer[name][leaf]
    )


def test_init_rules_give_the_reference_distributions():
    cfg = smoke_variant(ARCH_CONFIGS[RWKV])
    m = build_model(cfg, "cpu").init(0)
    rw = m.layers[0].rwkv
    assert bool((rw.mu == 0.5).all()) and bool((rw.cm_mu == 0.5).all())
    assert bool(((rw.w0 >= -6.0) & (rw.w0 <= -5.0)).all()) and float(rw.w0.std()) > 0.1
    assert float(rw.wb.abs().max()) == 0.0
    assert abs(float(rw.u.std()) - 0.5) < 0.1
    for norm in (rw.ln_x, m.layers[0].ln1, m.final_norm):
        assert bool((norm.scale == 1.0).all()) and bool((norm.bias == 0.0).all())
    h, _ = m(torch.as_tensor(_tokens(0, 1, 12, cfg.vocab), dtype=torch.int64))
    assert bool(torch.isfinite(h).all()) and float(h.std()) > 0.5  # layernorm not silenced

    jcfg = dataclasses.replace(smoke_variant(ARCH_CONFIGS[JAMBA]), num_layers=5)
    jm = build_model(jcfg, "cpu").init(0)
    mb = jm.layers[0].mamba
    ds = jcfg.d_state
    np.testing.assert_allclose(
        mb.a_log.numpy(), np.log(np.broadcast_to(np.arange(1, ds + 1), (jcfg.d_inner, ds)))
    )
    assert bool((mb.d_skip == 1.0).all()) and float(mb.conv_b.abs().max()) == 0.0
    dt = torch.nn.functional.softplus(mb.dt_bias)
    assert float(dt.min()) >= 0.999e-3 and float(dt.max()) <= 0.1001
    assert float(jm.layers[0].ln1.scale.abs().max()) == 0.0  # rmsnorm: 1 + 0
    h, aux = jm(torch.as_tensor(_tokens(1, 1, 12, jcfg.vocab), dtype=torch.int64))
    assert bool(torch.isfinite(h).all()) and float(aux) > 0.0


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_serve_cli_runs_the_smoke_model(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "3", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "decode:" in out
