"""Optimisers over the params tree: AdamW (f32 m and v) and Adafactor
(factored second moment, no first moment; the memory-feasible choice for
the 671B/132B MoE configs).

Counterpart of ``repro.train.optim`` with JAX's arithmetic: gradients
clipped by their global norm in f32, each param updated in f32 from its
own dtype and rounded back to it (bf16 params keep no f32 master copy).
Each optimiser exposes::

    init(params, cfg, stacks=None, specs=None, dist=None, shapes=None)
        -> state
    update(grads, state, params, cfg, stacks=None, specs=None, dist=None,
           shapes=None, sliced=False) -> (new_params, new_state, gnorm)

and ``state_specs(shapes, cfg, stacks, specs, dist)`` gives the state's
resolved specs, JAX's ``init(...)[1]`` (``OptConfig.zero1``: AdamW's m and
v split over 'data' on ``_zero1_spec``'s dim).

JAX stacks a stage's layers along a leading dim, and its optimisers read
that stacked shape: AdamW decays every leaf of rank 2 or more (so every
stacked layer leaf, norms included), Adafactor factors a stacked leaf's
last two dims and clips its update by the RMS over the whole stack.
``stacks`` (``models.transformer.param_stacks``) names the port's leaf
paths that JAX stacks into one leaf, each group in stack order; the
optimisers read each group as that one stacked leaf.  Leaves in no group
stand alone, as JAX's unstacked ones.  ``state["step"]`` is a 0-d int32
tensor on the params' device, as JAX's int32 scalar.

On a (data, model) mesh (``dist``; ``params`` and ``grads`` each rank's
blocks, ``specs`` the params' logical spec tree, ``shapes`` their whole
shapes as meta tensors, ``models.transformer.param_shapes``) every rank
runs the same code on its blocks and the arithmetic is the one-card
arithmetic of the whole leaves (``mesh_groups``: a leaf group's whole
stacked shape and resolved spec):

- ``global_norm`` sums each element's square once: a leaf's sum is
  all-reduced over the mesh axes that split it, a leaf replicated over an
  axis counted once.
- AdamW with ZeRO-1 keeps m and v only for this data rank's part of
  ``_zero1_spec``'s dim of the whole stacked shape (at full depth often
  the stack of layers: then a data rank holds the m and v of its layers,
  and an empty tensor in the others' places), updates that part of the
  param and all-gathers the new parts over 'data'.  ``sliced``: the
  gradients already arrive as those parts (the train step's ZeRO-2).
- Adafactor decides ``_factored`` on the whole stacked shape; the row and
  column means of ``g²``, the mean of ``vr`` and the update's RMS are
  sums all-reduced over the axes that split those dims, divided by the
  whole extent.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import comm
from repro_torch.sharding import Spec, _axes
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
    zero1: bool = True               # AdamW's m, v split over 'data'
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


def adamw_init(params, cfg: OptConfig = OptConfig(), stacks=None,
               specs=None, dist=None, shapes=None):
    if _on_mesh(dist):
        return _adamw_init_mesh(params, cfg, mesh_groups(
            params, cfg, stacks, specs, dist, shapes), dist)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _step0(params)}


def adamw_update(grads, state, params, cfg: OptConfig = OptConfig(),
                 stacks=None, specs=None, dist=None, shapes=None,
                 sliced=False):
    if _on_mesh(dist):
        return _adamw_update_mesh(grads, state, params, cfg, mesh_groups(
            params, cfg, stacks, specs, dist, shapes), dist, sliced)
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
                   stacks=None, specs=None, dist=None, shapes=None):
    """{"f": {group name: {"vr", "vc"} (factored) or {"v"}}, "step"}: one
    state a leaf group (``_groups``), of the group's stacked shape (on a
    mesh: its block, factored by the whole shape)."""
    if _on_mesh(dist):
        return _adafactor_init_mesh(params, mesh_groups(
            params, cfg, stacks, specs, dist, shapes))
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
                     stacks=None, specs=None, dist=None, shapes=None,
                     sliced=False):
    if _on_mesh(dist):
        return _adafactor_update_mesh(grads, state, params, cfg, mesh_groups(
            params, cfg, stacks, specs, dist, shapes), dist, sliced)
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


# ---------------------------------------------------------------------------
# on a (data, model) mesh
# ---------------------------------------------------------------------------


def _on_mesh(dist) -> bool:
    return dist is not None and dist.mesh is not None


def _zero1_spec(spec, shape, data_axes="data") -> Spec:
    """JAX's ``_zero1_spec``: the first dim of the whole ``shape`` that
    ``spec`` leaves unsplit and 16 divides (at least 16) goes over 'data';
    a no-op where 'data' is already in the spec."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    for ax in axes:
        used = ax if isinstance(ax, tuple) else (ax,)
        if "data" in used:
            return Spec(*axes)
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if ax is None and dim % 16 == 0 and dim >= 16:
            axes[i] = data_axes if isinstance(data_axes, str) else "data"
            return Spec(*axes)
    return Spec(*axes)


def spec_leaves(specs) -> list:
    """The ``Spec`` leaves of a spec tree in ``tree_leaves`` order (a
    ``Spec`` is a tuple: ``tree_leaves`` would walk into it)."""
    if isinstance(specs, Spec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for c in specs for s in spec_leaves(c)]


@dataclasses.dataclass(frozen=True)
class LeafGroup:
    """One leaf as JAX's optimiser sees it on a mesh: ``_groups``' name,
    leaf indices and stacked flag; ``spec`` its resolved spec and
    ``shape`` its whole shape, stacked (a leading None, the stack's
    length); ``zero`` the dim of that shape ZeRO-1 splits m and v over
    'data', ``gzero`` the one the gradient accumulator's ZeRO-2 split
    takes (None: no split)."""
    name: str
    idx: tuple
    stacked: bool
    spec: Spec
    shape: tuple
    zero: Optional[int]
    gzero: Optional[int]

    def leaf_spec(self) -> Spec:
        return Spec(*self.spec[1:]) if self.stacked else self.spec


def _split_axes(dist, entry, size: int) -> tuple:
    """The mesh axes of a resolved ``entry`` that split a dim of ``size``
    (() where it stays whole)."""
    if dist.shard_of(entry, size)[1] == 1:
        return ()
    return tuple(a for a in _axes(entry) if dist.extent(a) > 1)


def _zero_dim(dist, spec, shape) -> Optional[int]:
    z = _zero1_spec(spec, shape, "data")
    for i, (a, b) in enumerate(zip(tuple(spec) + (None,) * len(shape), z)):
        if a != b:
            return i if dist.shard_of("data", shape[i])[1] > 1 else None
    return None


def mesh_groups(params, cfg: OptConfig, stacks, specs, dist,
                shapes) -> list[LeafGroup]:
    """The leaf groups of ``params`` (each rank's blocks) with their whole
    stacked shapes (from ``shapes``) and resolved specs (from the logical
    ``specs``).  ZeRO-1's dim is ``_zero1_spec`` of the resolved spec
    (JAX's takes the logical one; the two agree unless a logical name
    resolves to 'data', where JAX's spec would name 'data' twice)."""
    sp = spec_leaves(specs)
    sh = [tuple(t.shape) for t in tree_leaves(shapes)]
    out = []
    for name, idx, st in _groups(params, stacks):
        lead = (None,) if st else ()
        shape = ((len(idx),) if st else ()) + sh[idx[0]]
        spec = dist.resolve(Spec(*lead, *sp[idx[0]]))
        spec = Spec(*(tuple(spec) + (None,) * (len(shape) - len(spec))))
        gzero = _zero_dim(dist, spec, shape)
        zero = gzero if cfg.name == "adamw" and cfg.zero1 else None
        out.append(LeafGroup(name, tuple(idx), st, spec, shape, zero, gzero))
    return out


def _stacked(leaves, g: LeafGroup):
    if g.stacked:
        return torch.stack([leaves[i] for i in g.idx])
    return leaves[g.idx[0]]


def _unstacked(t, g: LeafGroup) -> list:
    """``_stacked``'s inverse: each leaf of the group, in ``g.idx`` order."""
    return list(t.unbind(0)) if g.stacked else [t]


def _part_range(dist, g: LeafGroup, dim: int) -> tuple[int, int]:
    """(first index, length) of this data rank's part of ``g``'s ``dim``."""
    j, n = dist.shard_of("data", g.shape[dim])
    size = g.shape[dim] // n
    return j * size, size


def part_of(t, g: LeafGroup, k: int, dist, dim: int):
    """Leaf ``k`` of group ``g``'s share (``t`` its block) of this data
    rank's part along the stacked ``dim``: the block narrowed on that
    dim, or for the stack dim the whole block where the rank owns layer
    ``k``, an empty tensor where another does."""
    s0, size = _part_range(dist, g, dim)
    if g.stacked and dim == 0:
        return t if s0 <= k < s0 + size else t.new_empty((0,))
    return t.narrow(dim - g.stacked, s0, size).contiguous()


def stacked_part(leaves, g: LeafGroup, dist, dim: int):
    """The stacked part from every leaf's share (``part_of``)."""
    if not g.stacked:
        return leaves[g.idx[0]]
    if dim == 0:
        s0, size = _part_range(dist, g, 0)
        return torch.stack([leaves[i] for i in g.idx[s0:s0 + size]])
    return torch.stack([leaves[i] for i in g.idx])


def unstack_part(part, g: LeafGroup, dist, dim: int, like) -> list:
    """``stacked_part``'s inverse: each leaf's share, in ``g.idx`` order
    (``like``: a tensor whose dtype and device an empty share takes)."""
    if g.stacked and dim == 0:
        s0, size = _part_range(dist, g, 0)
        return [part[k - s0] if s0 <= k < s0 + size else
                like.new_empty((0,)) for k in range(len(g.idx))]
    return _unstacked(part, g)


def _gather_part(part, dist, dim):
    """Every data rank's part concatenated along ``dim``: the blocks."""
    return comm.all_gather(part, dist.group("data"), dim,
                           kind="zero_all_gather")


def _norm_axes(dist, g: LeafGroup, part: bool) -> tuple:
    names = list(dist.mesh.mesh_dim_names)
    axes = {a for d in range(len(g.shape))
            for a in _split_axes(dist, g.spec[d], g.shape[d])}
    if part:
        axes.add("data")
    return tuple(a for a in names if a in axes)


def global_norm_mesh(gl, groups, dist, parts=()) -> torch.Tensor:
    """The whole gradient's global norm from each rank's blocks ``gl``
    (``parts``: the names of the groups whose leaves are ZeRO parts over
    'data'): every element's square counted once."""
    sums: dict = {}
    for g in groups:
        key = _norm_axes(dist, g, g.name in parts)
        s = sum(torch.sum(torch.square(gl[i].float())) for i in g.idx)
        sums[key] = s if key not in sums else sums[key] + s
    total = None
    for key in sorted(sums):
        t = comm.all_reduce(sums[key], dist.group(key),
                            kind="norm_all_reduce")
        total = t if total is None else total + t
    return torch.sqrt(total)


def _whole_grads(gl, groups, dist, sliced):
    """The gradients as the optimiser reads them: where the train step
    handed ZeRO-2 parts (``sliced``) on a dim other than the optimiser's
    ZeRO-1 dim, gathered back to blocks (parts on it stay parts).
    Returns (leaves, the names of the groups left as parts)."""
    gl = list(gl)
    parts = set()
    if not sliced:
        return gl, parts
    for g in groups:
        if g.gzero is None:
            continue
        if g.zero == g.gzero:
            parts.add(g.name)
            continue
        whole = _gather_part(stacked_part(gl, g, dist, g.gzero), dist,
                             g.gzero)
        for i, t in zip(g.idx, _unstacked(whole, g)):
            gl[i] = t
    return gl, parts


def _adamw_init_mesh(params, cfg, groups, dist):
    leaves = tree_leaves(params)
    m = [None] * len(leaves)
    for g in groups:
        for k, i in enumerate(g.idx):
            p = leaves[i]
            t = p if g.zero is None else part_of(p, g, k, dist, g.zero)
            m[i] = torch.zeros(t.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_unflatten(params, m),
            "v": tree_unflatten(params, [t.clone() for t in m]),
            "step": _step0(params)}


def _adamw_update_mesh(grads, state, params, cfg, groups, dist, sliced):
    leaves = tree_leaves(params)
    gl, parts = _whole_grads(tree_leaves(grads), groups, dist, sliced)
    gnorm = global_norm_mesh(gl, groups, dist, parts)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    step = state["step"] + 1
    t = step.float()
    lr = _lr(cfg, step)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    ml, vl = tree_leaves(state["m"]), tree_leaves(state["v"])
    new, nm, nv = list(leaves), list(ml), list(vl)

    def upd(p, g, m, v, decay):
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    for g in groups:
        decay = len(g.shape) >= 2
        p = _stacked(leaves, g)
        if g.zero is None:
            newp, m2, v2 = upd(p, _stacked(gl, g).float() * scale,
                               _stacked(ml, g), _stacked(vl, g), decay)
            ms, vs = _unstacked(m2, g), _unstacked(v2, g)
        else:
            s0, size = _part_range(dist, g, g.zero)
            gp = (stacked_part(gl, g, dist, g.zero) if g.name in parts
                  else _stacked(gl, g).narrow(g.zero, s0, size))
            newp, m2, v2 = upd(p.narrow(g.zero, s0, size),
                               gp.float() * scale,
                               stacked_part(ml, g, dist, g.zero),
                               stacked_part(vl, g, dist, g.zero), decay)
            newp = _gather_part(newp, dist, g.zero)
            ms = unstack_part(m2, g, dist, g.zero, m2)
            vs = unstack_part(v2, g, dist, g.zero, v2)
        for i, t, m_, v_ in zip(g.idx, _unstacked(newp, g), ms, vs):
            new[i], nm[i], nv[i] = t, m_, v_
    return (tree_unflatten(params, new),
            {"m": tree_unflatten(params, nm), "v": tree_unflatten(params, nv),
             "step": step}, gnorm)


def _adafactor_init_mesh(params, groups):
    leaves = tree_leaves(params)
    f = {}
    for g in groups:
        p = leaves[g.idx[0]]
        shape = ((len(g.idx),) if g.stacked else ()) + tuple(p.shape)

        def zeros(shape, dev=p.device):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        f[g.name] = ({"vr": zeros(shape[:-1]),
                      "vc": zeros(shape[:-2] + shape[-1:])}
                     if _factored(g.shape) else {"v": zeros(shape)})
    return {"f": f, "step": _step0(params)}


def _adafactor_update_mesh(grads, state, params, cfg, groups, dist, sliced):
    leaves = tree_leaves(params)
    gl, _ = _whole_grads(tree_leaves(grads), groups, dist, sliced)
    gnorm = global_norm_mesh(gl, groups, dist)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    step = state["step"] + 1
    t = step.float()
    lr = _lr(cfg, step)
    beta2 = 1.0 - t ** -0.8
    new, nf = list(leaves), {}

    def mean(x, g, dims, keepdim=False):
        """The whole leaf's mean over ``dims`` (dims of ``g.shape``) from
        this rank's block ``x``: the block's sum all-reduced over the axes
        that split them (in mesh order: a sum's group), over the whole
        extent."""
        split = {a for d in dims
                 for a in _split_axes(dist, g.spec[d], g.shape[d])}
        axes = tuple(a for a in dist.mesh.mesh_dim_names if a in split)
        s = comm.all_reduce(x.sum(dim=dims, keepdim=keepdim),
                            dist.group(axes), kind="adafactor_all_reduce")
        n = 1
        for d in dims:
            n *= g.shape[d]
        return s / n

    for g in groups:
        # each f32 leaf-sized temporary goes as soon as it is read (the
        # leaves of a MoE layer's block are ~1 GB in f32)
        p = _stacked(leaves, g)
        gg = _stacked(gl, g).float() * scale
        f = state["f"][g.name]
        nd = len(g.shape)
        g2 = gg * gg + 1e-30
        if _factored(g.shape):
            vr = beta2 * f["vr"] + (1 - beta2) * mean(g2, g, (nd - 1,))
            vc = beta2 * f["vc"] + (1 - beta2) * mean(g2, g, (nd - 2,))
            del g2
            vr_mean = mean(vr, g, (nd - 2,), keepdim=True)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(vr_mean[..., None], 1e-30))
            u = gg * torch.rsqrt(denom + 1e-30)
            del denom
            nf[g.name] = {"vr": vr, "vc": vc}
        else:
            v = beta2 * f["v"] + (1 - beta2) * g2
            del g2
            u = gg * torch.rsqrt(v + 1e-30)
            nf[g.name] = {"v": v}
        del gg
        rms_u = torch.sqrt(mean(u * u, g, tuple(range(nd))) + 1e-30)
        u = u / torch.clamp_min(rms_u, 1.0)
        newp = p.float() - lr * u
        del u
        if nd >= 2:
            newp = newp - lr * cfg.weight_decay * p.float()
        for i, t in zip(g.idx, _unstacked(newp.to(p.dtype), g)):
            new[i] = t
    return tree_unflatten(params, new), {"f": nf, "step": step}, gnorm


def state_specs(shapes, cfg: OptConfig, stacks, specs, dist):
    """The optimiser state's resolved specs, JAX's ``init(...)[1]`` on
    ``dist`` (``shapes``: the params' whole shapes).  AdamW: m and v per
    leaf, each leaf of a stacked group carrying the group's stacked spec
    (a leading entry for the stack dim, 'data' there where ZeRO-1 splits
    the stack of layers); Adafactor: one {"vr", "vc"} or {"v"} a group,
    the group's spec less the reduced dim."""
    groups = mesh_groups(shapes, cfg, stacks, specs, dist, shapes)
    if cfg.name == "adafactor":
        f = {}
        for g in groups:
            ax = list(g.spec)
            f[g.name] = ({"vr": Spec(*ax[:-1]), "vc": Spec(*(ax[:-2]
                                                          + ax[-1:]))}
                         if _factored(g.shape) else {"v": Spec(*ax)})
        return {"f": f, "step": Spec()}
    out = [None] * len(tree_leaves(shapes))
    for g in groups:
        z = g.spec if g.zero is None else \
            _zero1_spec(g.spec, g.shape, "data")
        for i in g.idx:
            out[i] = z
    tree = tree_unflatten(shapes, out)
    return {"m": tree, "v": tree, "step": Spec()}


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}
