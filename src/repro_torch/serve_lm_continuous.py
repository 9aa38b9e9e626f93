"""Continuous-batching LM serving: requests of different prompt lengths
join and leave the slot pool mid-flight.

Counterpart of ``examples/serve_lm_continuous.py``: 9 requests (prompts of
2-7 tokens, 6 new tokens each) over 3 slots of ``ContinuousBatcher`` (on
the card one CUDA graph a slot), against the steps a one-at-a-time
scheduler would take.  ``--arch seamless-m4t-large-v2`` decodes over one
encoded source (``tfm.encode`` of seeded frames) for every request.

    PYTHONPATH=src python -m repro_torch.serve_lm_continuous
        [--arch llama3.2-1b] [--device cuda|cpu] [--full]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serving.batcher import ContinuousBatcher, Request

SRC_LEN = 16                # the encoder-decoder's source frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cfg = (registry.get_config(args.arch) if args.full
           else registry.get_reduced(args.arch))
    dev = resolve_device(args.device)
    params = tfm.init(cfg, seed=0, device=dev)
    memory = None
    if cfg.is_encoder_decoder:
        gen = torch.Generator().manual_seed(0)
        src = torch.randn((1, SRC_LEN, cfg.d_model), generator=gen).to(dev)
        with torch.no_grad():
            memory = tfm.encode(params, src, cfg)
    rng = np.random.default_rng(0)
    cb = ContinuousBatcher(cfg, params, slots=3, max_len=32, memory=memory,
                           device=dev)
    n_req = 9
    for i in range(n_req):
        plen = int(rng.integers(2, 8))
        cb.submit(Request(rid=i,
                          prompt=rng.integers(0, cfg.vocab_size,
                                              plen).astype(np.int32),
                          max_new=6))
    steps = cb.run()
    st = cb.stats()
    naive = sum(len(r.prompt) + 6 - 1 for r in cb.done)
    print(f"arch={args.arch} device={dev}: served {st['completed']} "
          f"requests in {steps} scheduler steps (sequential would take "
          f"{naive})")
    print(f"latency p50 {st['p50_ms']:.0f} ms  p95 {st['p95_ms']:.0f} ms  "
          f"p99 {st['p99_ms']:.0f} ms, p50 TTFT "
          f"{st['p50_ttft_s'] * 1e3:.0f} ms")
    assert st["completed"] == n_req and steps < naive
    print("continuous batching beats sequential scheduling ✓")
    return cb


if __name__ == "__main__":
    main()
