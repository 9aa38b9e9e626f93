"""Optimisers over the params tree: AdamW (f32 m and v) and Adafactor
(factored second moment, no first moment; the memory-feasible choice for
the 671B/132B MoE configs).

Counterpart of ``repro.train.optim`` with JAX's arithmetic: gradients
clipped by their global norm in f32, each param updated in f32 from its
own dtype and rounded back to it (bf16 params keep no f32 master copy).
One card: the ZeRO-1 state specs (``_zero1_spec``) wait for the mesh,
ROADMAP Queue 1 item 13c.  Each optimiser exposes::

    init(params, cfg, stacks=None) -> state
    update(grads, state, params, cfg, stacks=None)
        -> (new_params, new_state, gnorm)

JAX stacks a stage's layers along a leading dim, and its optimisers read
that stacked shape: AdamW decays every leaf of rank 2 or more (so every
stacked layer leaf, norms included), Adafactor factors a stacked leaf's
last two dims and clips its update by the RMS over the whole stack.
``stacks`` (``models.transformer.param_stacks``) names the port's leaf
paths that JAX stacks into one leaf, each group in stack order; the
optimisers read each group as that one stacked leaf.  Leaves in no group
stand alone, as JAX's unstacked ones.  ``state["step"]`` is a 0-d int32
tensor on the params' device, as JAX's int32 scalar.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.train.tree import (tree_leaves, tree_map, tree_paths,
                                    tree_unflatten)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Any] = None   # train.schedule.ScheduleConfig


def _lr(cfg: OptConfig, step):
    if cfg.schedule is None:
        return cfg.lr
    from repro_torch.train.schedule import lr_at
    return lr_at(step, cfg.schedule)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    """(grads in f32 scaled to a global norm of at most ``max_norm``, the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _step0(params):
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _groups(params, stacks) -> list[tuple[str, list[int], bool]]:
    """(name, leaf indices in flattening order, stacked) for every leaf
    group: each of ``stacks`` (JAX's stacked leaves), then every other
    leaf alone.  The name keys the group's optimiser state: the first
    path with "." for "/", and ``*n`` for a stack of n."""
    paths = [k for k, _ in tree_paths(params)]
    index = {k: i for i, k in enumerate(paths)}
    out, seen = [], set()
    for st in stacks or ():
        idx = [index[k] for k in st]
        out.append((f"{st[0].replace('/', '.')}*{len(st)}", idx, True))
        seen.update(idx)
    out += [(paths[i].replace("/", "."), [i], False)
            for i in range(len(paths)) if i not in seen]
    return out


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params, cfg: OptConfig = OptConfig(), stacks=None):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _step0(params)}


def adamw_update(grads, state, params, cfg: OptConfig = OptConfig(),
                 stacks=None):
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    t = step.float()
    lr = _lr(cfg, step)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    stacked = set()
    for _, idx, st in _groups(params, stacks):
        stacked.update(idx if st else ())

    def upd(i, p, g, m, v):
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if p.dim() + (i in stacked) >= 2:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = [upd(i, *xs) for i, xs in enumerate(zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"])))]
    newp, newm, newv = (tree_unflatten(params, [o[i] for o in out])
                        for i in range(3))
    return newp, {"m": newm, "v": newv, "step": step}, gnorm


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------


def _factored(shape):
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def adafactor_init(params, cfg: OptConfig = OptConfig(name="adafactor"),
                   stacks=None):
    """{"f": {group name: {"vr", "vc"} (factored) or {"v"}}, "step"}: one
    state a leaf group (``_groups``), of the group's stacked shape."""
    leaves = tree_leaves(params)
    f = {}
    for name, idx, st in _groups(params, stacks):
        p = leaves[idx[0]]
        shape = ((len(idx),) if st else ()) + tuple(p.shape)

        def zeros(shape, dev=p.device):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        f[name] = ({"vr": zeros(shape[:-1]),
                    "vc": zeros(shape[:-2] + shape[-1:])}
                   if _factored(shape) else {"v": zeros(shape)})
    return {"f": f, "step": _step0(params)}


def adafactor_update(grads, state, params,
                     cfg: OptConfig = OptConfig(name="adafactor"),
                     stacks=None):
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    t = step.float()
    lr = _lr(cfg, step)
    beta2 = 1.0 - t ** -0.8

    def upd(p, g, f):
        g2 = g * g + 1e-30
        if _factored(p.shape):
            vr = beta2 * f["vr"] + (1 - beta2) * g2.mean(-1)
            vc = beta2 * f["vc"] + (1 - beta2) * g2.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(vr.mean(-1, keepdim=True)[..., None],
                                       1e-30))
            u = g * torch.rsqrt(denom + 1e-30)
            nf = {"vr": vr, "vc": vc}
        else:
            v = beta2 * f["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(v + 1e-30)
            nf = {"v": v}
        # update clipping (Shazeer & Stern)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp_min(rms_u, 1.0)
        newp = p.float() - lr * u
        if p.dim() >= 2:
            newp = newp - lr * cfg.weight_decay * p.float()
        return newp.to(p.dtype), nf

    leaves, gl = tree_leaves(params), tree_leaves(grads)
    new, nf = list(leaves), {}
    for name, idx, st in _groups(params, stacks):
        if st:
            p = torch.stack([leaves[i] for i in idx])
            g = torch.stack([gl[i] for i in idx])
        else:
            p, g = leaves[idx[0]], gl[idx[0]]
        newp, nf[name] = upd(p, g, state["f"][name])
        for j, i in enumerate(idx):
            new[i] = newp[j] if st else newp
    return (tree_unflatten(params, new), {"f": nf, "step": step}, gnorm)


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}
