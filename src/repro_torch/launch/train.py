"""End-to-end LM training: data pipeline -> train step ->
checkpoint/restart -> straggler monitor.

Counterpart of ``repro.launch.train``: the token pipeline (with the stub
source frames of an encoder-decoder, 64 of them), ``make_train_step``
with the optimiser of ``opt_config_for`` and JAX's key chunk (a quarter
of the sequence, at least 16), an atomic checkpoint every ``ckpt_every``
steps, and ``run_with_restarts``: an injected ``NodeFailure``
(``fail_at``) restores the latest checkpoint and replays from its step,
with the same batches (a batch is keyed by its step).  With ``data *
model > 1``, ``train`` runs as one rank of a world of at least that many
ranks (``launch.mesh.run_spmd``) on a (data, model) mesh under
``make_dist``'s rules: every rank the same seeded params' blocks, the
batch whole on every rank, the checkpoint gathered whole and restored
through ``runtime.elastic.restore_on_mesh``; every rank returns the same
losses.  The CLI launches the ranks itself and prints the first rank's
lines.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 20 --batch 8 --seq 64 --ckpt-dir "$TMPDIR/ckpt" \\
        [--fail-at 12] [--device cpu] [--full] [--data 2 --model 2]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tfm
from repro_torch.runtime.elastic import restore_on_mesh
from repro_torch.runtime.fault import (FailureInjector, Heartbeat,
                                       StragglerMonitor, run_with_restarts)
from repro_torch.train import optim as opt_lib
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import TokenPipeline

SEED = 0


def build_state(cfg, *, seed=SEED, device="cuda", params=None, dist=None):
    """(train state {"params", "opt", "step"}, the optimiser's config):
    params from ``tfm.init`` seeded with ``seed`` unless given (whole:
    ``params`` is cut into the rank's blocks on a mesh), the optimiser's
    state from ``opt_config_for(cfg)`` (over JAX's stacked shapes,
    ``tfm.param_stacks``; on a mesh each rank's part)."""
    mesh = dist is not None and dist.mesh is not None
    if params is None:
        params = tfm.init(cfg, seed=seed, device=device, dist=dist)
    elif mesh:
        params = dist.shard_params(params, tfm.specs(cfg))
    opt_cfg = steps_lib.opt_config_for(cfg)
    opt_init, _ = opt_lib.OPTIMIZERS[opt_cfg.name]
    step = torch.zeros((), dtype=torch.int32,
                       device=params["embed"]["w"].device)
    kw = (dict(specs=tfm.specs(cfg), dist=dist, shapes=tfm.param_shapes(cfg))
          if mesh else {})
    opt = opt_init(params, opt_cfg, stacks=tfm.param_stacks(cfg, params),
                   **kw)
    return ({"params": params, "opt": opt,
             "step": step}, opt_cfg)


def train_dist(cfg, data, model, batch, seq):
    """The (data, model) mesh's ``DistContext`` for a train run, from
    inside a world of at least ``data * model`` ranks."""
    import torch.distributed as tdist
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    if world < data * model:
        raise ValueError(
            f"train(data={data}, model={model}) runs as one rank of a world "
            f"of at least {data * model} ranks (this one has {world}): "
            f"launch it through launch.mesh.run_spmd, as the CLI's --data/"
            f"--model do")
    mesh = make_host_mesh(data=data, model=model)
    return steps_lib.make_dist(mesh, cfg, ShapeConfig("custom", "train",
                                                      seq, batch))


def train(arch: str, *, reduced=True, steps=20, batch=8, seq=64,
          ckpt_dir=None, ckpt_every=10, fail_at=(), data=1, model=1,
          log_every=5, device="cuda", params=None, cfg=None):
    """Train ``steps`` steps of ``arch`` (its reduced config unless
    ``reduced=False``, or ``cfg``) from seeded params (or ``params``,
    whole).  Returns (the loss of every step run, replays included, the
    final step); on a mesh the same on every rank of it (a rank outside
    the mesh returns ([], 0))."""
    if cfg is None:
        cfg = (registry.get_reduced(arch) if reduced
               else registry.get_config(arch))
    dev = resolve_device(device)
    dist = train_dist(cfg, data, model, batch, seq) \
        if data * model > 1 else None
    if dist is not None and dist.mesh.get_coordinate() is None:
        return [], 0
    lead = dist is None or dist.is_first()
    state, opt_cfg = build_state(cfg, device=dev, params=params, dist=dist)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg,
                                        kv_chunk=max(seq // 4, 16),
                                        dist=dist)
    placements = (steps_lib.train_state_specs(cfg, dist, opt_cfg)[1]
                  if dist is not None else None)
    pipe = TokenPipeline(cfg, batch, seq,
                         src_len=64 if cfg.is_encoder_decoder else 0)
    ckpt = CheckpointManager(ckpt_dir, keep=2, dist=dist) if ckpt_dir \
        else None
    injector = FailureInjector(tuple(fail_at))
    monitor = StragglerMonitor()
    hb = Heartbeat(timeout=3600)
    losses = []

    def say(msg):
        if lead:
            print(msg, flush=True)

    def restore_latest() -> int:
        # run_with_restarts' restore contract: reload the train state from
        # the latest checkpoint, return the step to resume at; an async
        # write still under way is waited for first and, on a mesh, every
        # rank meets before reading ``latest`` (JAX's launcher reads it at
        # once)
        nonlocal state
        assert ckpt is not None, "failure without checkpointing"
        ckpt.wait()
        step0 = ckpt.latest_step() or 0
        if dist is None:
            state = ckpt.restore(state, step=step0)
        else:
            state = restore_on_mesh(ckpt, state, placements, dist,
                                    step=step0)
        say(f"[restart] restored step {step0}")
        return step0

    def save(s, block=False):
        ckpt.save(s, state, block=block, placements=placements)

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
                say(f"step {s:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['gnorm']):.3f} "
                    f"dt {dt * 1e3:.0f}ms")
            s += 1
            if ckpt and s % ckpt_every == 0:
                save(s)
        if ckpt:
            # the final state, unless the loop's last save already holds it
            # (JAX's launcher writes that step a second time)
            if steps % ckpt_every:
                save(steps, block=True)
            ckpt.wait()
        return s

    final = run_with_restarts(loop, restore=restore_latest if ckpt else None,
                              on_restart=lambda n, e: say(
                                  f"[fault] restart {n}: {e}"))
    return losses, final


def _cli_rank(rank, world, dev, kw):
    return train(device=dev.type, **kw)


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
    kw = dict(arch=args.arch, reduced=args.reduced, steps=args.steps,
              batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, fail_at=args.fail_at,
              data=args.data, model=args.model)
    if args.data * args.model > 1:
        from repro_torch.launch.mesh import run_spmd
        losses, final = run_spmd(_cli_rank, args.data * args.model, kw,
                                 device=args.device, timeout=3600)[0]
    else:
        losses, final = train(device=args.device, **kw)
    print(f"done at step {final}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses, final


if __name__ == "__main__":
    main()
