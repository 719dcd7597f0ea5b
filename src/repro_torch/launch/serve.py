"""Serving launcher: batched decode against per-layer KV caches and
recurrent states.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
      --batch 4 --prompt-len 32 --gen 32

The port's ``repro.launch.serve``, with the same flags plus ``--device``
(the card unless ``--device cpu``).  Weights are random, drawn from
``--seed`` on the device; the prompt and the sampling come from a
``torch.Generator`` seeded likewise.  ``generate`` is the same loop for
callers that hold a model already.  ``--arch jamba-1.5-large-398b`` at
full depth (398.6e9 parameters) does not fit one card; ``--smoke`` or a
depth cut passed to ``generate`` does.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_CONFIGS, get_config, smoke_variant
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(
    model,
    cfg,
    *,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 32,
    temperature: float = 1.0,
    seed: int = 0,
) -> Dict[str, Any]:
    """Prefill a random prompt token by token, then decode ``gen`` tokens.

    Returns the prompt, the generated tokens (B, gen), the last step's
    logits, and the wall seconds of both loops (each ending in a device
    synchronisation) with their step counts.
    """
    dev = model.device
    serve = make_serve_step(model, cfg)
    max_len = prompt_len + gen
    cache = model.init_cache(batch, max_len)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g, device=dev)

    # prefill token-by-token (decode-path prefill keeps one code path)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for i in range(prompt_len):
        logits, cache = serve(cache, prompt[:, i : i + 1], i)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(prompt_len, max_len - 1):
        logits, cache = serve(cache, tok, i)
        if temperature > 0:
            probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=g)
        else:
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        out.append(tok)
    _sync(dev)
    t_gen = time.perf_counter() - t0
    return dict(
        prompt=prompt, tokens=torch.cat(out, dim=1), logits=logits, cache=cache,
        prefill_s=t_prefill, prefill_steps=prompt_len,
        decode_s=t_gen, decode_steps=max_len - 1 - prompt_len,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCH_CONFIGS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    model = build_model(cfg, resolve_device(args.device)).init(args.seed)
    r = generate(
        model, cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
        temperature=args.temperature, seed=args.seed,
    )
    gen = r["tokens"]
    print(f"arch={cfg.name} batch={args.batch} device={model.device}")
    print(f"prefill: {args.prompt_len} steps in {r['prefill_s']:.2f}s")
    print(
        f"decode:  {gen.shape[1]} tokens/seq in {r['decode_s']:.2f}s "
        f"({args.batch * gen.shape[1] / max(r['decode_s'], 1e-9):.1f} tok/s)"
    )
    print("sample token ids:", gen[0, :16].tolist())


if __name__ == "__main__":
    main()
