"""LM serving: batched greedy decode with a persistent KV/state cache.

Counterpart of ``repro.launch.serve``: the prompt is fed token by token
through ``decode_step`` (as JAX's driver does; the prefill step covers
bulk prompts), then each step's argmax is fed back.  An encoder-decoder
decodes over a memory: random (B, 16, d_model) bf16 unless given, as
JAX's launcher feeds it (no encode).  The reduced config by default;
``reduced=False`` serves the full width.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --tokens 16 [--batch 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as tfm

SEED = 0                    # JAX's driver draws from PRNGKey(0)


def serve(arch: str, *, batch=4, prompt_len=8, gen_tokens=16, reduced=True,
          device="cuda", params=None, prompt=None, cfg=None, memory=None):
    """Greedy-decode ``gen_tokens`` tokens after a ``prompt_len`` prompt for
    ``batch`` rows.  Params come from ``tfm.init`` and the prompt (and an
    encoder-decoder's ``memory``, (batch, 16, d_model) bf16) from a
    ``torch.Generator``, all seeded with ``SEED``, unless given
    (``prompt``: (batch, prompt_len) ints; ``memory``: (batch, S_src,
    d_model), e.g. ``tfm.encode``'s output).  ``cfg`` (default: ``arch``'s
    reduced or published config) is the config served, e.g. one with its
    depth cut to fit a card.  Returns (tokens (batch, gen_tokens) int64
    numpy, seconds)."""
    if cfg is None:
        cfg = (registry.get_reduced(arch) if reduced
               else registry.get_config(arch))
    dev = resolve_device(device)
    if params is None:
        params = tfm.init(cfg, seed=SEED, device=dev)
    if prompt is None:
        gen = torch.Generator().manual_seed(SEED)
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=gen)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64).to(dev)
    if cfg.is_encoder_decoder and memory is None:
        gen = torch.Generator().manual_seed(SEED)
        memory = torch.randn((batch, 16, cfg.d_model), generator=gen)
        memory = memory.to(dev, torch.bfloat16)
    max_len = prompt_len + gen_tokens
    cache = tfm.init_cache(cfg, batch, max_len, device=dev)
    step = make_serve_step(cfg)
    tok = prompt[:, :1]
    out_tokens = []
    t0 = time.perf_counter()
    for i in range(max_len - 1):
        tok, cache = step(params, cache,
                          prompt[:, i:i + 1] if i < prompt_len else tok, i,
                          memory)
        if i >= prompt_len - 1:
            out_tokens.append(tok[:, 0])
    gen_np = torch.stack(out_tokens, 1).cpu().numpy()
    return gen_np, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    gen, dt = serve(args.arch, batch=args.batch, gen_tokens=args.tokens,
                    device=args.device)
    n = gen.size
    print(f"arch={args.arch} device={args.device} generated {gen.shape} "
          f"tokens in {dt:.2f}s ({n / dt:.1f} tok/s); sample: "
          f"{gen[0][:8]}")
    assert np.isfinite(gen).all()
    return gen


if __name__ == "__main__":
    main()
