"""Dry-run of the production meshes: count one rank's step of every
(arch x shape x mesh) cell on fake tensors, with no card.

Counterpart of ``repro.launch.dryrun``.  JAX's lowers and compiles each
cell on 512 placeholder host devices and reads XLA's analyses; here one
process joins a fake world of 256 (16x16) or 512 (2x16x16) ranks
(``hlo_analysis.fake_world``), builds JAX's mesh and rules
(``launch.mesh.make_production_mesh``, ``launch.steps.make_dist``), cuts
the rank's blocks of fake tensors (``shard_params``; the train
state from ``launch.train.build_state``, the decode cache from
``init_cache``) and runs the rank's train, prefill or serve step once
under ``hlo_analysis.analyze_step``: every microbatch, the optimiser,
the collectives (on the fake group: nothing moves) and kernels A–F (their
fake branch: nothing is computed).  It touches no device.

The record is rank 0's, or where ranks' blocks cut the heads differently
(``layers.attention.Heads``: qwen2-7b's 28 heads over 16 ranks) the
largest of the first rank of each distinct layout (``rank``).  JAX's
choices are kept: ``kv_chunk`` 2048 past 8k tokens else 1024,
``default_grad_accum``, ``opt_config_for``, bf16 gradient accumulation
for the two huge MoEs.  The decode step runs at the cache's last
position (every key read).  The prefill step reads out the last position
only (``make_prefill_step``), where JAX's reads out every position: its
counted FLOPs fall short of ``model_flops`` by the rest of the readout.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--force]

Plane-parallel topology planning (``core.spatial``): one conv site's
device-tiled executor on a fake world of D_h·D_w ranks, with per-shard
memory, the halo geometry and the collectives:

    python -m repro_torch.launch.dryrun --convplane dilated_context_385
    python -m repro_torch.launch.dryrun --convplane decoder_96 --dev-tiles 2x2,4x1

Results go to results/dryrun/<arch>__<shape>__<mesh>.json (resp.
convplane__<site>__<DhxDw>.json); a cached record is kept unless
``--force``, so a long sweep restarts where it stopped.  Render them
with ``python -m repro_torch.launch.report``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tfm

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")

# the two huge MoEs accumulate their gradients in bf16, as JAX's dry-run
# does (f32 accumulation alone is 10.5 GB a chip for 671B)
BF16_ACCUM = ("deepseek-v3-671b", "dbrx-132b")


def _own(tree):
    """Each leaf copied out where it is a view of a larger storage (a
    block ``shard_params`` cut along dim 0), as ``tfm.init(dist=)`` draws
    it: the rank holds its blocks, not the whole tensors."""
    return tfm._map_tree(
        lambda t: t.clone() if t.untyped_storage().nbytes()
        > t.numel() * t.element_size() else t, tree)


def _fake(tree):
    """Fake tensors of ``tree``'s shapes and dtypes on the analysis's
    device (made inside the fake mode)."""
    return tfm._map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device=ha.DEVICE), tree)


class _Coord:
    """A mesh of ``sizes`` seen from the rank at ``coord``: what
    ``DistContext`` reads to place a block, with no process group."""

    def __init__(self, sizes: dict, coord: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self._coord = tuple(coord.get(a, 0) for a in sizes)

    def get_coordinate(self):
        return self._coord

    def get_group(self, axis):
        return axis


def _layout(cfg, dist) -> tuple:
    """What of a rank's work its 'model' coordinate changes: how its block
    of the 'heads' columns meets the heads (how many heads and kv heads it
    touches, its width, whether it cuts a head, which kv head each q head
    reads), and MLA's heads."""
    from repro_torch.layers import attention as attn
    out = []
    kinds = {k for kinds, _ in tuple(cfg.stages) + tuple(
        getattr(cfg, "encoder_stages", ())) for k in kinds}
    if kinds - {"ssd", "rec", "mla", "mla_moe"}:
        h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if h and kh and dh:
            hd = attn._local_heads(dist, h, kh, dh)
            out.append((hd.heads[1] - hd.heads[0], hd.kv[1] - hd.kv[0],
                        hd.cols[1] - hd.cols[0], hd.cut, hd.kv_gather,
                        tuple((hd.heads[0] + j) // (h // kh) - hd.kv[0]
                              for j in range(hd.heads[1] - hd.heads[0]))))
    if kinds & {"mla", "mla_moe"}:
        mh = attn._mla_heads(dist, cfg)
        out.append((mh.heads[1] - mh.heads[0], mh.cols[1] - mh.cols[0],
                    mh.o_split))
    return tuple(out)


def candidate_ranks(cfg, shape, multi_pod: bool, *, seq_parallel=False,
                    parallelism="auto") -> list[int]:
    """The first rank of each distinct ``_layout`` along 'model' (data
    and pod coordinates 0, so rank = model coordinate): rank 0 alone
    where every rank's blocks meet the heads alike."""
    sizes = ({"pod": 2} if multi_pod else {}) | {"data": 16, "model": 16}
    seen, ranks = set(), []
    for m in range(sizes["model"]):
        mesh = _Coord(sizes, {"model": m})
        dist = steps_lib.make_dist(mesh, cfg, shape,
                                   seq_parallel=seq_parallel,
                                   parallelism=parallelism)
        key = _layout(cfg, dist)
        if key not in seen:
            seen.add(key)
            ranks.append(m)
    return ranks


def rank_inputs(cfg, shape, dist, *, grad_accum=0, kv_chunk=1024,
                remat=True):
    """(step, its args, memory, extra record fields) of this rank of
    ``dist``'s mesh for ``shape``: its blocks of fake tensors (made in a
    fake mode), ``memory`` their exact bytes by kind (params, optimiser
    state, decode cache, batch)."""
    extra = {}
    with ha.fake_mode():
        whole = _fake(tfm.param_shapes(cfg))
        opt = cache = None
        if shape.kind == "train":
            from repro_torch.launch.train import build_state
            state, opt_cfg = build_state(cfg, params=whole, dist=dist)
            params = state["params"] = _own(state["params"])
            opt = state["opt"]
            accum = grad_accum or steps_lib.default_grad_accum(cfg, shape)
            grad_sh = steps_lib.train_state_specs(cfg, dist, opt_cfg)[2]
            step = steps_lib.make_train_step(
                cfg, opt_cfg, grad_accum=accum, kv_chunk=kv_chunk,
                remat=remat, dist=dist, grad_shardings=grad_sh,
                accum_dtype=(torch.bfloat16 if cfg.name in BF16_ACCUM
                             else torch.float32))
            batch = _fake(specs_lib.batch_specs(cfg, shape)[0])
            args = (state, batch)
            extra = {"grad_accum": accum, "optimizer": opt_cfg.name}
        else:
            params = _own(dist.shard_params(whole, tfm.specs(cfg)))
            if shape.kind == "prefill":
                step = steps_lib.make_prefill_step(cfg, dist,
                                                   kv_chunk=kv_chunk)
                batch = _fake(specs_lib.batch_specs(cfg, shape)[0])
                args = (params, batch)
            else:
                step = steps_lib.make_serve_step(cfg, dist)
                cache = tfm.init_cache(cfg, shape.global_batch,
                                       shape.seq_len, device=ha.DEVICE,
                                       dist=dist)
                tok, _, memory, _ = specs_lib.decode_specs(cfg, shape)
                batch = {"tokens": _fake(tok)}
                if memory is not None:
                    batch["memory"] = _fake(memory)
                args = (params, cache, batch["tokens"], shape.seq_len - 1,
                        batch.get("memory"))
    mem = {k: ha.tensor_bytes(t) for k, t in (
        ("param_bytes", params), ("opt_state_bytes", opt),
        ("cache_bytes", cache), ("batch_bytes", batch))}
    return step, args, mem, extra


def _count_rank(cfg, shape, multi_pod, rank, *, seq_parallel, grad_accum,
                kv_chunk, remat, parallelism) -> dict:
    chips = 512 if multi_pod else 256
    with ha.fake_world(chips, rank):
        mesh = make_production_mesh(multi_pod=multi_pod)
        dist = steps_lib.make_dist(mesh, cfg, shape,
                                   seq_parallel=seq_parallel,
                                   parallelism=parallelism)
        step, args, mem, extra = rank_inputs(
            cfg, shape, dist, grad_accum=grad_accum, kv_chunk=kv_chunk,
            remat=remat)
        t0 = time.time()
        hc = ha.analyze_step(step, *args, default_group=chips)
        count_s = time.time() - t0
    mem["peak_activation_bytes"] = hc["peak_activation_bytes"]
    model_flops = rl.model_flops_for(cfg, shape)
    roof = rl.roofline_from(
        {"flops": hc["flops"], "bytes accessed": hc["hbm_bytes"]},
        {"total": hc["coll_total"]}, chips, model_flops)
    return {
        "rank": rank, "count_s": round(count_s, 1), "memory": mem,
        "bytes_per_chip": hc["peak_bytes"],
        "product_flops": hc["product_flops"],
        "kernels": hc["kernels"], "moe_load": hc["moe_load"],
        "hbm_by_op": hc["hbm_by_op"],
        "top_buffers": hc["top_buffers"][:8],
        "collectives": {"per_kind": hc["coll_per_kind"],
                        "total": hc["coll_total"],
                        "num_ops": hc["num_collectives"],
                        "by_kind": {k: {"op": v["op"], "calls": v["calls"],
                                        "bytes": v["bytes"],
                                        "ring_bytes": v["ring_bytes"]}
                                    for k, v in hc["collectives"].items()}},
        "roofline": roof.to_dict(), **extra}


def count_cell(arch: str, shape_name: str, multi_pod: bool, *,
               seq_parallel: bool = False, grad_accum: int = 0,
               kv_chunk: int = 0, remat: bool = True,
               parallelism: str = "auto") -> dict:
    """Count one cell (JAX's ``lower_cell``): its record, or
    ``{"skipped": reason}`` where ``registry.shape_applicable`` skips it."""
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = registry.shape_applicable(cfg, shape)
    if not ok:
        return {"skipped": reason}
    kv_chunk = kv_chunk or (2048 if shape.seq_len > 8192 else 1024)
    t0 = time.time()
    ranks = candidate_ranks(cfg, shape, multi_pod,
                            seq_parallel=seq_parallel,
                            parallelism=parallelism)
    recs = [_count_rank(cfg, shape, multi_pod, r, seq_parallel=seq_parallel,
                        grad_accum=grad_accum, kv_chunk=kv_chunk,
                        remat=remat, parallelism=parallelism)
            for r in ranks]
    rec = max(recs, key=lambda r: (max(r["roofline"][k] for k in (
        "compute_s", "memory_s", "collective_s")), r["bytes_per_chip"]))
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "chips": 512 if multi_pod else 256,
            "seq_parallel": seq_parallel, "kv_chunk": kv_chunk,
            "layouts": len(ranks), "total_s": round(time.time() - t0, 1),
            **rec}


# -- plane-parallel conv topology planning ----------------------------------

# named conv sites the topology planner sweeps: the BENCH_spatial
# geometries plus a big SegNet-style encoder plane.  (kind, in_hw, c, n,
# kernel, strides, padding, dilation, batch)
CONVPLANE_SITES = {
    "dilated_context_385": dict(kind="dilated", in_hw=(385, 385), c=32, n=32,
                                kernel=(3, 3), strides=(1, 1),
                                padding=((2, 2), (2, 2)), dilation=(2, 2),
                                batch=4),
    # padding is the zoo's deconv_padding(4, 2) = (1, 3): out = 2·in
    "decoder_96": dict(kind="transposed", in_hw=(96, 96), c=64, n=32,
                       kernel=(4, 4), strides=(2, 2),
                       padding=((1, 3), (1, 3)), dilation=(1, 1), batch=4),
    "encoder_512": dict(kind="conv", in_hw=(512, 512), c=16, n=32,
                        kernel=(3, 3), strides=(1, 1),
                        padding=((1, 1), (1, 1)), dilation=(1, 1), batch=4),
}

DEFAULT_DEV_TILES = ((2, 1), (4, 1), (2, 2), (8, 1), (4, 2))


def convplane_spec(site: str, dev_tiles):
    from repro_torch.core.plan import ConvSpec
    g = CONVPLANE_SITES[site]
    return ConvSpec(kind=g["kind"], in_hw=g["in_hw"], in_c=g["c"],
                    out_c=g["n"], kernel_hw=g["kernel"],
                    strides=g["strides"], padding=g["padding"],
                    dilation=g["dilation"], backend="cuda",
                    spatial=tuple(dev_tiles))


def _dim(t) -> dict:
    return {"block": t.block, "tin": t.tin, "halo_lo": t.halo_lo,
            "halo_hi": t.halo_hi, "pad_to": t.pad_to}


def count_convplane(site: str, dev_tiles) -> dict:
    """One conv site's plane-parallel forward on a fake world of D_h·D_w
    ranks (JAX's ``lower_convplane``): the route, the halo geometry, the
    rank's bytes and its collectives."""
    from repro_torch.core import spatial
    from repro_torch.core.plan import plan_conv
    from repro_torch.launch.mesh import make_spatial_mesh

    spec = convplane_spec(site, dev_tiles)
    sp = spatial.spatial_plan(spec)
    if sp is None:
        return {"site": site, "dev_tiles": list(dev_tiles),
                "skipped": "geometry does not admit one-hop halo exchange"}
    plan = plan_conv(spec)
    b = CONVPLANE_SITES[site]["batch"]
    h, w = spec.in_hw
    dh, dw = dev_tiles
    t0 = time.time()
    with ha.fake_world(dh * dw):
        mesh = make_spatial_mesh(dh, dw)
        with ha.fake_mode():
            x = torch.empty((b, h, w, spec.in_c), device=ha.DEVICE)
            pk = torch.empty((plan.total_taps * spec.in_c, spec.out_c),
                             device=ha.DEVICE)
        with spatial.use_spatial_mesh(mesh):
            hc = ha.analyze_step(lambda a, k: plan.apply(a, k), x, pk,
                                 default_group=dh * dw)
    th, tw = sp.dims
    return {
        "site": site, "spec": {k: list(v) if isinstance(v, tuple) else v
                               for k, v in dataclasses.asdict(spec).items()},
        "dev_tiles": list(dev_tiles), "devices": dh * dw,
        "route": plan.route_for_batch(b).path,
        "halo": {"h": _dim(th), "w": _dim(tw)},
        "count_s": round(time.time() - t0, 1),
        "memory": {"input_bytes": hc["input_bytes"],
                   "peak_activation_bytes": hc["peak_activation_bytes"]},
        "bytes_per_chip": hc["peak_bytes"],
        "kernels": hc["kernels"],
        "collectives": {"per_kind": hc["coll_per_kind"],
                        "total": hc["coll_total"],
                        "num_ops": hc["num_collectives"]},
    }


def _run(out: str, label: str, fn, base: dict, force: bool) -> dict:
    """``fn()``'s record, written to ``out`` (kept and returned where it
    exists and not ``force``; an error goes to ``out + '.err'``)."""
    if os.path.exists(out) and not force:
        print(f"[skip-cached] {out}")
        with open(out) as f:
            return json.load(f)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    print(f"[dryrun] {label} ...", flush=True)
    try:
        rec = fn()
    except Exception as e:
        rec = dict(base, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        with open(out + ".err", "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[FAIL] {label}: {e}", flush=True)
        return rec
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    if os.path.exists(out + ".err"):
        os.remove(out + ".err")
    return rec


def run_convplane(site: str, dev_tiles, force=False):
    dh, dw = dev_tiles
    out = os.path.join(RESULTS_DIR, f"convplane__{site}__{dh}x{dw}.json")
    rec = _run(out, f"convplane {site} x {dh}x{dw}",
               lambda: count_convplane(site, dev_tiles),
               {"site": site, "dev_tiles": list(dev_tiles)}, force)
    if "skipped" in rec:
        print(f"[skip] {site} {dh}x{dw}: {rec['skipped']}", flush=True)
    elif "error" not in rec:
        print(f"[ok] count {rec['count_s']}s | "
              f"{rec['bytes_per_chip'] / 2**20:.1f} MiB/chip, "
              f"collectives {rec['collectives']['num_ops']}", flush=True)
    return rec


def cell_path(arch, shape_name, multi_pod, tag=""):
    mesh = "multi" if multi_pod else "single"
    sfx = f"__{tag}" if tag else ""
    return os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{mesh}{sfx}.json")


def run_cell(arch, shape_name, multi_pod, force=False, tag="", **kw):
    mesh = "2x16x16" if multi_pod else "16x16"
    rec = _run(cell_path(arch, shape_name, multi_pod, tag),
               f"{arch} x {shape_name} x {mesh}",
               lambda: count_cell(arch, shape_name, multi_pod, **kw),
               {"arch": arch, "shape": shape_name, "mesh": mesh}, force)
    if "skipped" in rec:
        print(f"[skip] {arch} {shape_name}: {rec['skipped']}", flush=True)
    elif "error" not in rec:
        r = rec["roofline"]
        print(f"[ok] count {rec['total_s']}s ({rec['layouts']} layout(s)) "
              f"| compute {r['compute_s']:.3e}s memory {r['memory_s']:.3e}s "
              f"collective {r['collective_s']:.3e}s -> {r['dominant']} | "
              f"{rec['bytes_per_chip'] / 2**30:.2f} GiB/chip", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=0)
    ap.add_argument("--kv-chunk", type=int, default=0)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--parallelism", choices=("auto", "dp_only"),
                    default="auto")
    ap.add_argument("--tag", default="", help="suffix for the result file "
                    "(variants keep the baseline intact)")
    ap.add_argument("--convplane", choices=tuple(CONVPLANE_SITES),
                    help="plane-parallel topology sweep for one conv site "
                    "(skips the transformer grid)")
    ap.add_argument("--dev-tiles", default="",
                    help="comma-separated DhxDw list for --convplane "
                    "(default: the standard candidate set)")
    args = ap.parse_args(argv)

    if args.convplane:
        if args.dev_tiles:
            tiles = tuple(tuple(int(v) for v in t.split("x"))
                          for t in args.dev_tiles.split(","))
        else:
            tiles = DEFAULT_DEV_TILES
        for dt in tiles:
            run_convplane(args.convplane, dt, force=args.force)
        return

    archs = registry.ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                run_cell(arch, shape, mp, force=args.force, tag=args.tag,
                         seq_parallel=args.seq_parallel,
                         grad_accum=args.grad_accum,
                         kv_chunk=args.kv_chunk,
                         remat=not args.no_remat,
                         parallelism=args.parallelism)


if __name__ == "__main__":
    main()
