"""Train a reduced llama3.2-1b on a (data 2, model 2) mesh with
checkpointing and an injected node failure at step 12: atomic checkpoints
every 5 steps gathered whole from the ranks' blocks, the restart from the
latest one on every rank, and the data pipeline resumed exactly by step.

Counterpart of ``examples/lm_train.py``: its 2x2 mesh, as four ranks
(``launch.mesh.run_spmd``, gloo; on the card they share it unless each
has one).  The checkpoints go to a temporary directory.

    PYTHONPATH=src python -m repro_torch.lm_train [--steps 30] [--batch 8]
        [--seq 64] [--data 2 --model 2] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.mesh import run_spmd
from repro_torch.launch.train import train


def _rank(rank, world, dev, kw):
    return train("llama3.2-1b", reduced=True, device=dev.type, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        kw = dict(steps=args.steps, batch=args.batch, seq=args.seq,
                  ckpt_dir=os.path.join(d, "ckpt"), ckpt_every=5,
                  fail_at=[12], data=args.data, model=args.model)
        world = args.data * args.model
        if world > 1:
            runs = run_spmd(_rank, world, kw, device=args.device,
                            timeout=3600)
            losses, final = runs[0]
            assert all(r == runs[0] for r in runs), "ranks disagree"
        else:
            losses, final = train("llama3.2-1b", reduced=True,
                                  device=args.device, **kw)
    print(f"\nfinal step {final}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert final == args.steps
    assert losses[-1] < losses[0] + 0.05      # random tokens: bound drift
    print("survived injected failure, resumed from checkpoint ✓")
    return losses, final


if __name__ == "__main__":
    main()
