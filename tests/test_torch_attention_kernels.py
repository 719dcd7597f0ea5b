"""K4 and K5's plain versions against the JAX package's Pallas kernels, on the CPU.

The JAX side runs ``repro.kernels.ops.flash_attention`` /
``ops.decode_attention`` in interpret mode, as ``tests/test_kernels.py``
does; the port's wrappers get CPU tensors and so run their plain
versions.  Inputs come from a numpy seed and are rounded to the dtype on
both sides alike.  Tolerances are ``tests/test_kernels.py``'s: 2e-5 in
float32, 2e-2 in bfloat16 (the plain versions round their probabilities
to bfloat16 before the second product, the Pallas kernels do not).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.configs import ARCH_CONFIGS, smoke_variant  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_plain,
)
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,kv,d,window,cap",
    [
        (2, 128, 4, 1, 64, None, 50.0),
        (1, 256, 6, 2, 128, 64, 30.0),
        (1, 128, 4, 1, 256, 32, None),     # gemma3's heads: MQA of 256, a window
        (1, 128, 4, 1, 256, None, 50.0),
    ],
)
def test_k4_plain_matches_pallas_interpret(b, s, h, kv, d, window, cap, dtype):
    rng = np.random.default_rng(s + h)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng, (b, s, n, d), dtype) for n in (h, kv, kv))
    expected = ops.flash_attention(
        jq, jk, jv, causal=True, window=window, logit_cap=cap, block=128, interpret=True
    )
    before = fa.flash_attention.launches
    out = fa.flash_attention(tq, tk, tv, causal=True, window=window, logit_cap=cap)
    assert fa.flash_attention.launches == before  # CPU tensors: the plain version
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(expected), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("s,window", [(100, None), (77, 16)])
def test_k4_plain_any_length_matches_oracle(s, window):
    """Ragged S, which the Pallas wrapper reaches by halving its block."""
    rng = np.random.default_rng(s)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng, (1, s, n, 32), "float32") for n in (4, 2, 2))
    expected = ref.mha_reference(jq, jk, jv, causal=True, window=window, logit_cap=50.0)
    out = fa.flash_attention(tq, tk, tv, window=window, logit_cap=50.0)
    np.testing.assert_allclose(_np(out), _np(expected), atol=2e-5, rtol=2e-5)


def test_k4_plain_chunks_queries_alike(monkeypatch):
    rng = np.random.default_rng(0)
    _, tq = _both(rng, (2, 96, 4, 32), "float32")
    _, tk = _both(rng, (2, 96, 2, 32), "float32")
    _, tv = _both(rng, (2, 96, 2, 32), "float32")
    whole = fa.flash_attention_plain(tq, tk, tv, window=40, logit_cap=30.0)
    monkeypatch.setattr(fa, "_PLAIN_LOGITS", 2 * 4 * 96 * 7)  # 7-row chunks
    chunked = fa.flash_attention_plain(tq, tk, tv, window=40, logit_cap=30.0)
    torch.testing.assert_close(chunked, whole, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,kv,d,s,valid",
    [
        (2, 8, 4, 64, 512, 300),
        (1, 16, 2, 128, 2048, 999),
    ],
)
def test_k5_plain_matches_pallas_interpret(b, h, kv, d, s, valid, dtype):
    rng = np.random.default_rng(valid)
    jq, tq = _both(rng, (b, h, d), dtype)
    jk, tk = _both(rng, (b, s, kv, d), dtype)
    jv, tv = _both(rng, (b, s, kv, d), dtype)
    expected = ops.decode_attention(jq, jk, jv, jnp.asarray(valid), logit_cap=50.0, interpret=True)
    before = decode_attention.launches
    out = decode_attention(tq, tk, tv, torch.tensor(valid), logit_cap=50.0)
    assert decode_attention.launches == before
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(expected), atol=TOL[dtype], rtol=TOL[dtype])


def test_k5_equals_the_decode_path_on_a_global_cache(monkeypatch):
    """The identity the card check relies on: every layer's decode attention
    is K5's plain version at valid_len = min(pos + 1, C) -- pos + 1 on a
    global cache, the ring's size once a local ring has wrapped -- so K5
    on the same inputs gives what the decode step used."""
    cfg = smoke_variant(ARCH_CONFIGS["gemma2-27b"])
    model = build_model(cfg, "cpu").init(2)
    cache = model.init_cache(2, 24)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 20)))
    calls = []

    def recording(q, k, v, valid_len, *, logit_cap=None):
        out = decode_attention_plain(q, k, v, valid_len, logit_cap=logit_cap)
        calls.append((q, k.clone(), v.clone(), valid_len, logit_cap, out))
        return out

    monkeypatch.setattr(model_attention, "decode_attention_plain", recording)
    for t in range(20):
        calls.clear()
        _, cache = model.decode_step(cache, toks[:, t : t + 1], t)
        assert len(calls) == cfg.num_layers
        for layer, (q, k, v, vl, cap, out) in zip(model.layers, calls):
            c = k.shape[1]
            assert c == (24 if layer.kind == "global" else cfg.sliding_window)
            # the ring's valid slots, slot s holding position t - ((t - s) mod C)
            valid = (t - torch.remainder(t - torch.arange(c), c)) >= 0
            assert vl == min(t + 1, c) == int(valid.sum()) and bool(valid[:vl].all())
            if t == 19:
                got = decode_attention(q, k, v, torch.tensor(vl), logit_cap=cap)
                torch.testing.assert_close(got, out, atol=1e-6, rtol=1e-5)
    assert {layer.kind for layer in model.layers} == {"global", "local"}


def test_wrappers_refuse_mismatched_inputs():
    q = torch.zeros(1, 8, 4, 32)
    kv = torch.zeros(1, 8, 3, 32)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="do not match"):
        decode_attention(torch.zeros(1, 4, 16), torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32), 3)
    with pytest.raises(ValueError, match="logit_cap"):
        decode_attention(torch.zeros(1, 4, 32), torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32), 3,
                         logit_cap=0.0)


def test_k5_plain_with_nothing_valid_is_zero():
    q, k = torch.ones(1, 2, 32), torch.ones(1, 8, 1, 32)
    assert torch.equal(decode_attention_plain(q, k, k, 0), torch.zeros(1, 2, 32))


@pytest.mark.parametrize("valid", [0, 1, 17, 63, 64])
def test_k5_valid_len_as_int_int32_int64_agree(valid):
    """The wrapper's plain path gives one output for valid_len as a Python
    int, a 0-d and a 1-element int32 tensor and an int64 tensor."""
    rng = np.random.default_rng(valid + 7)
    q = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, 4, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 64, 4, 32)).astype(np.float32))
    outs = [
        decode_attention(q, k, v, vl, logit_cap=50.0)
        for vl in (
            valid,
            torch.tensor(valid, dtype=torch.int32),
            torch.tensor([valid], dtype=torch.int32),
            torch.tensor(valid, dtype=torch.int64),
        )
    ]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    assert torch.equal(outs[0], decode_attention_plain(q, k, v, valid, logit_cap=50.0))


def test_k5_valid_len_reaches_the_kernel_as_it_lies():
    """What the kernel is handed: an int32 or int64 tensor as itself (no
    cast kernel), another integer dtype cast to int32, an int by value
    clamped to [0, S]; anything else is refused."""
    from repro_torch.kernels.decode_attention import _valid_arg

    cpu = torch.device("cpu")
    t32 = torch.tensor(7, dtype=torch.int32)
    t64 = torch.tensor([9], dtype=torch.int64)
    kind, value, t = _valid_arg(t32, cpu, 64)
    assert (kind, value) == (1, 0) and t.data_ptr() == t32.data_ptr()
    kind, value, t = _valid_arg(t64, cpu, 64)
    assert (kind, value) == (2, 0) and t.data_ptr() == t64.data_ptr()
    kind, _, t = _valid_arg(torch.tensor(5, dtype=torch.int16), cpu, 64)
    assert kind == 1 and t.dtype == torch.int32 and int(t) == 5
    assert _valid_arg(40, cpu, 64) == (0, 40, None)
    assert _valid_arg(-3, cpu, 64) == (0, 0, None)
    assert _valid_arg(100, cpu, 64) == (0, 64, None)
    with pytest.raises(ValueError, match="integer"):
        _valid_arg(torch.tensor(3.0), cpu, 64)
    with pytest.raises(ValueError, match="one element"):
        _valid_arg(torch.tensor([1, 2]), cpu, 64)
