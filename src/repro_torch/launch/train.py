"""End-to-end LM training: data pipeline -> train step ->
checkpoint/restart -> straggler monitor.

Counterpart of ``repro.launch.train`` on one device: the token pipeline
(with the stub source frames of an encoder-decoder, 64 of them),
``make_train_step`` with the optimiser of ``opt_config_for`` and JAX's key
chunk (a quarter of the sequence, at least 16), an atomic checkpoint
every ``ckpt_every`` steps, and ``run_with_restarts``: an injected
``NodeFailure`` (``fail_at``) restores the latest checkpoint and replays
from its step, with the same batches (a batch is keyed by its step).
The mesh (``data * model > 1``) waits for ROADMAP Queue 1 item 13c.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 20 --batch 8 --seq 64 --ckpt-dir "$TMPDIR/ckpt" \\
        [--fail-at 12] [--device cpu] [--full]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.core import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tfm
from repro_torch.runtime.fault import (FailureInjector, Heartbeat,
                                       StragglerMonitor, run_with_restarts)
from repro_torch.train import optim as opt_lib
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import TokenPipeline

SEED = 0


def build_state(cfg, *, seed=SEED, device="cuda", params=None):
    """(train state {"params", "opt", "step"}, the optimiser's config):
    params from ``tfm.init`` seeded with ``seed`` unless given, the
    optimiser's state from ``opt_config_for(cfg)`` (over JAX's stacked
    shapes, ``tfm.param_stacks``)."""
    if params is None:
        params = tfm.init(cfg, seed=seed, device=device)
    opt_cfg = steps_lib.opt_config_for(cfg)
    opt_init, _ = opt_lib.OPTIMIZERS[opt_cfg.name]
    step = torch.zeros((), dtype=torch.int32,
                       device=params["embed"]["w"].device)
    opt = opt_init(params, opt_cfg, stacks=tfm.param_stacks(cfg, params))
    return ({"params": params, "opt": opt,
             "step": step}, opt_cfg)


def train(arch: str, *, reduced=True, steps=20, batch=8, seq=64,
          ckpt_dir=None, ckpt_every=10, fail_at=(), data=1, model=1,
          log_every=5, device="cuda", params=None, cfg=None):
    """Train ``steps`` steps of ``arch`` (its reduced config unless
    ``reduced=False``, or ``cfg``) from seeded params (or ``params``).
    Returns (the loss of every step run, replays included, the final
    step)."""
    if data * model > 1:
        raise NotImplementedError(
            f"train(data={data}, model={model}): the mesh is ROADMAP Queue 1 "
            f"item 13c; the port trains on one device")
    if cfg is None:
        cfg = (registry.get_reduced(arch) if reduced
               else registry.get_config(arch))
    dev = resolve_device(device)
    state, opt_cfg = build_state(cfg, device=dev, params=params)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg,
                                        kv_chunk=max(seq // 4, 16))
    pipe = TokenPipeline(cfg, batch, seq,
                         src_len=64 if cfg.is_encoder_decoder else 0)
    ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    injector = FailureInjector(tuple(fail_at))
    monitor = StragglerMonitor()
    hb = Heartbeat(timeout=3600)
    losses = []

    def restore_latest() -> int:
        # run_with_restarts' restore contract: reload the train state from
        # the latest checkpoint, return the step to resume at; an async
        # write still under way is waited for first (JAX's launcher reads
        # ``latest`` at once)
        nonlocal state
        assert ckpt is not None, "failure without checkpointing"
        ckpt.wait()
        step0 = ckpt.latest_step() or 0
        state = ckpt.restore(state, step=step0)
        print(f"[restart] restored step {step0}")
        return step0

    def loop(start_step: int) -> int:
        nonlocal state
        s = int(state["step"])
        while s < steps:
            batch_np = pipe.batch_at(s)
            t0 = time.monotonic()
            injector.check(s)
            state, metrics = step_fn(state, batch_np)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            monitor.record(s, dt)
            hb.beat()
            losses.append(loss)
            if s % log_every == 0:
                print(f"step {s:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['gnorm']):.3f} "
                      f"dt {dt * 1e3:.0f}ms")
            s += 1
            if ckpt and s % ckpt_every == 0:
                ckpt.save(s, state)
        if ckpt:
            # the final state, unless the loop's last save already holds it
            # (JAX's launcher writes that step a second time)
            if steps % ckpt_every:
                ckpt.save(steps, state, block=True)
            ckpt.wait()
        return s

    final = run_with_restarts(loop, restore=restore_latest if ckpt else None,
                              on_restart=lambda n, e: print(
                                  f"[fault] restart {n}: {e}"))
    return losses, final


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    losses, final = train(args.arch, reduced=args.reduced, steps=args.steps,
                          batch=args.batch, seq=args.seq,
                          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                          fail_at=args.fail_at, data=args.data,
                          model=args.model, device=args.device)
    print(f"done at step {final}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses, final


if __name__ == "__main__":
    main()
