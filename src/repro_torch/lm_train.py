"""Train a reduced llama3.2-1b with checkpointing and an injected node
failure at step 12: atomic checkpoints every 5 steps, the restart from the
latest one, and the data pipeline resumed exactly by step.

Counterpart of ``examples/lm_train.py`` on one device (the JAX example's
2x2 mesh waits for ROADMAP Queue 1 item 13c).  The checkpoints go to a
temporary directory.

    PYTHONPATH=src python -m repro_torch.lm_train [--steps 30] [--batch 8]
        [--seq 64] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        losses, final = train(
            "llama3.2-1b", reduced=True, steps=args.steps, batch=args.batch,
            seq=args.seq, ckpt_dir=os.path.join(d, "ckpt"), ckpt_every=5,
            fail_at=[12], device=args.device)
    print(f"\nfinal step {final}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert final == args.steps
    assert losses[-1] < losses[0] + 0.05      # random tokens: bound drift
    print("survived injected failure, resumed from checkpoint ✓")
    return losses, final


if __name__ == "__main__":
    main()
