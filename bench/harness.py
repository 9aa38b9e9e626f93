"""One run of one cell: set-up, the measured window, the check.

Set-up (``setup_s``: from the process's start to the window's) makes the
weights and the request payloads on the device from the seed, builds the
program's plans and packs the weights, and warms the timed path: the
batcher's own warm-up (each bucket run, captured as a CUDA graph and
timed), or a training cell's first steps.  The window then runs the cell's
traffic for ``seconds``.  With ``trace`` the same window keeps spans and
runs ``torch.profiler`` over a part of it, and the run reports the
per-layer metrics instead of the end-to-end ones.

After the window the program's state is freed and the plain reference
judges what the timed path produced (``check_*``): a sample, drawn from the
seed, of the images the clients got back; or a training cell's first three
steps, taken in set-up through the window's own step and feed.  Each number
compared has the limit in ``bench/cells/<cell>.json``.

``plant`` breaks the timed path on purpose, for the tests and for reading
the limits' upper ends on the card: 'control' (the reference in TF32 in
the program's place), 'alter_answer', 'half_batch', 'state_unchanged',
'leaf_doubled' (one layer's weights moved double: a wrong backward
product at one site).
"""
from __future__ import annotations

import functools
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import time
from types import SimpleNamespace as Context  # what a metric reads

import numpy as np
import torch

from bench import loadgen, work
from bench.trace import Spans, Tracer

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# the part of a traced window the profiler covers: from this share of it,
# for at most TRACE_S seconds or half the window
TRACE_FROM, TRACE_S = 0.3, 2.0
SEED_MASK = 2 ** 62 - 1


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic mix,
    limits and metrics, all found by name."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        spec = [w for w in bench["workloads"] if w["name"] == name]
        if not spec:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = spec[0]
        self.name = name
        self.chips = self.spec["chips"]
        cfg = [c for c in bench["configs"]
               if c["name"] == self.spec["config"]][0]
        self.config = load_json(ROOT / cfg["file"])
        self.traffic = load_json(BENCH / "traffic"
                                 / f"{self.spec['traffic']}.json")
        self.check = load_json(BENCH / "cells" / f"{name}.json")

        def here(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if here(m)]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", ())] + [
            m for m in bench["per_layer"]
            if "workloads" not in m and m["moves"] in moves]


def family(cfg: dict):
    return importlib.import_module(f"bench.families.{cfg['family']}")


def reader(metric: str):
    """The ``read(ctx)`` of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free_device(dev):
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def settle():
    """The end of set-up: what set-up made is collected once and frozen
    out of the collector's later passes (``gc.freeze``), as a long-lived
    server does after loading; what the window allocates is collected as
    usual.  Without it each full pass walks every object torch and the
    model loaded, 100-200 ms on the card's host, twice in a 10 s window."""
    gc.collect()
    gc.freeze()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             plant: str | None = None) -> tuple[dict, dict]:
    """One run: (the result line's object, details for the tools)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    seed = int(seed) & SEED_MASK
    loop = cell.traffic["loop"]
    run = run_train if loop == "train" else run_serve
    return run(cell, seed, seconds, trace, dev, t_start, plant)


# -- serving ---------------------------------------------------------------

def _plant_serve(fn, plant):
    if plant == "alter_answer":       # every other row's answer moved by 1
        def altered(x):
            y = fn(x).clone()
            y[::2] += 1
            return y
        return altered
    if plant == "half_batch":         # the second half of the rows unserved
        def half(x):                  # (a launch of one row: that row)
            y = fn(x)
            return torch.cat([y[:x.shape[0] // 2],
                              y.new_zeros((x.shape[0] - x.shape[0] // 2,)
                                          + y.shape[1:])])
        return half
    return fn


def _keep(index, served):
    """What the sample keeps of a served image: its payload's index in
    the pool and a copy of the answer."""
    return index, np.array(served.out)


def run_serve(cell, seed, seconds, trace, dev, t_start, plant):
    from repro_torch.serving.control_plane import ControlPlane
    cfg, tr = cell.config, cell.traffic
    fam = family(cfg)
    weights = fam.make_weights(cfg, seed, dev, train=False)
    fn, proto = fam.serving(cfg, weights)
    cp = ControlPlane()
    be = cp.register_image_model(cfg["name"], _plant_serve(fn, plant), proto,
                                 max_wait_ms=tr["max_wait_ms"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
    pool = fam.make_inputs(cfg, gen, tr["payload_pool"], dev).cpu().numpy()
    rows = list(pool)
    order = np.random.default_rng((seed, 1)).permutation(len(pool)).tolist()
    be.warmup()
    sync(dev)
    settle()

    sample = loadgen.Reservoir(cell.check["sample"],
                               np.random.default_rng((seed, 2)))
    spans = Spans()
    drv = loadgen.Driver(
        cp, cfg["name"], tr["images_per_request"],
        payload=lambda i: (rows[order[i % len(rows)]], order[i % len(rows)]),
        clock=time.perf_counter,
        on_image=functools.partial(sample.offer, _keep),
        launch_start=lambda: spans.last_start("batcher.execute"))
    batcher = be.batcher
    tracer = None
    if trace:
        spans.wrap(cp, "submit", "cp.submit")
        spans.wrap(cp, "pump", "cp.pump")
        spans.wrap(batcher, "execute", "batcher.execute")
        # the harness's own work for its clients: issuing (less the
        # program's request objects and submits inside) and handing
        # finished images back
        spans.wrap(drv, "issue", "driver.issue")
        spans.wrap(drv, "_request", "cp.request")
        spans.wrap(drv, "give_back", "driver.return")
        tracer = Tracer(spans, TRACE_FROM * seconds,
                        min(TRACE_S, seconds / 2),
                        counter=lambda: len(batcher.launches),
                        sync=lambda: sync(dev))
        drv.tick = tracer.tick
        tracer.arm()
    n_launch0 = len(batcher.launches)
    if tr["loop"] == "closed":
        st = loadgen.run_closed(drv, tr["clients"], seconds)
        drv.drain(time.perf_counter() + 60)
    else:
        n_users = round(tr["image_rate_per_s"] * seconds
                        / tr["images_per_request"])
        offsets = loadgen.arrival_offsets(
            n_users, seconds, np.random.default_rng((seed, 3)))
        st = loadgen.run_open(drv, offsets, seconds)
    if tracer is not None:
        tracer.stop()
    window = st["t1"] - st["t0"]
    setup_s = st["t0"] - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    users = drv.users
    failed = sum(1 for u in users if u.t_done is None)
    lat = [u.latency_s for u in users]
    e2e = {"setup_s": setup_s,
           "img_per_s": st["images"] / window if tr["loop"] == "closed"
           else None,
           "p95_ms": loadgen.percentile_ms(lat, 95)
           if tr["loop"] == "open" else None}
    launches = batcher.launches[n_launch0:]
    detail = {"window_s": window, "images": st["images"],
              "users": len(users), "launches": len(launches),
              "p50_ms": loadgen.percentile_ms(lat, 50),
              "p95_ms": loadgen.percentile_ms(lat, 95),
              "p99_ms": loadgen.percentile_ms(lat, 99),
              "backlog": st.get("backlog"),
              "late_p99_ms": loadgen.percentile_ms(
                  [u.t_issued - u.due for u in users], 99)}
    device_trace = tracer.trace if tracer is not None else None
    if device_trace is not None:
        detail["host_s"] = device_trace.host_seconds()
    if tracer is not None:
        detail["trace_log"] = tracer.log
    traced, unprofiled = None, dict(e2e)
    if tracer is not None and len(tracer.count_at) == 2:
        traced = batcher.launches[tracer.count_at[0]:tracer.count_at[1]]
        if e2e["img_per_s"] is not None:
            t_first, n_first = tracer.first
            before = batcher.launches[n_launch0:n_first]
            unprofiled["img_per_s"] = (sum(live for _, live in before)
                                       / (t_first - st["t0"]))
    ctx = Context(cell=cell, e2e=unprofiled, spans=spans, users=users,
                  launches=launches, window_s=window, trace=device_trace,
                  traced_launches=traced,
                  sites=lambda b: fam.sites(cfg, False, b),
                  peaks=_peaks(dev), loop=tr["loop"])
    del drv, cp, be, batcher, fn, spans, tracer
    free_device(dev)

    items = sample.items
    checks = check_images(fam, cfg, weights, pool, items, dev, plant,
                          cell.check["limits"])
    correct = failed == 0 and len(items) > 0 and all(
        v["value"] <= v["limit"] for v in checks.values())
    return _result(cell, trace, ctx, correct, len(users), failed, peak,
                   checks, dev), detail


def check_images(fam, cfg, weights, pool, items, dev, plant, limits):
    """The family's number (``fam.compare``) for each served answer in the
    sample, against the reference on the same payload: the worst.  The
    control puts the reference's own answer in TF32 in the program's
    place."""
    worst, name = 0.0, next(iter(limits))
    block = 32
    for i in range(0, len(items), block):
        part = items[i:i + block]
        x = torch.from_numpy(np.stack([pool[j] for j, _ in part])).to(dev)
        if plant == "control":
            got = fam.served_by_reference(cfg, weights, x, tf32=True)
        else:
            got = torch.from_numpy(np.stack([o for _, o in part])).to(dev)
        name, values = fam.compare(cfg, weights, x, got)
        worst = max(worst, float(values.nan_to_num(nan=math.inf).max()))
    return {name: {"value": worst, "limit": limits[name]}}


# -- training --------------------------------------------------------------

CHECK_STEPS = 3


def run_train(cell, seed, seconds, trace, dev, t_start, plant):
    cfg, tr = cell.config, cell.traffic
    fam = family(cfg)
    batch, lr = tr["batch"], tr["lr"]
    weights = fam.make_weights(cfg, seed, dev, train=True)
    trainer = fam.Trainer(cfg, weights, seed, batch, lr, dev)
    spans = Spans()
    feed, step = trainer.batch, trainer.step
    if plant == "half_batch":         # the mean over half the rows
        def feed(s):
            z, real = trainer.batch(s)
            return z[:batch // 2], real[:batch // 2]
    if plant == "state_unchanged":    # the step hands back its old state
        def step(z, real):
            gp, dp = trainer.gp, trainer.dp
            out = trainer.step(z, real)
            trainer.gp, trainer.dp = gp, dp
            return out
    if plant == "leaf_doubled":       # the first deconv's update doubled
        def step(z, real):
            old = trainer.gp["dc0"]
            out = trainer.step(z, real)
            trainer.gp["dc0"] = 2 * trainer.gp["dc0"] - old
            return out

    # set-up: the first steps through the window's own step and feed
    snaps, losses = [trainer.params()], []
    for s in range(CHECK_STEPS):
        losses.append(step(*feed(s)))
        if s == 0 or s == CHECK_STEPS - 1:
            snaps.append(trainer.params())
    program = _train_readings(snaps, losses, lr)
    del snaps
    sync(dev)
    settle()

    tracer = None
    n_steps = [0]
    if trace:
        tracer = Tracer(spans, TRACE_FROM * seconds,
                        min(TRACE_S, seconds / 2),
                        counter=lambda: n_steps[0], sync=lambda: sync(dev))
        tracer.arm()
    s, bad = CHECK_STEPS, 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        if tracer is not None:
            tracer.tick()
            with spans.span("train.data"):
                z, real = feed(s)
            with spans.span("train.step"):
                gl, dl = step(z, real)
        else:
            gl, dl = step(*feed(s))
        bad += not (math.isfinite(gl) and math.isfinite(dl))
        s += 1
        n_steps[0] += 1
    t1 = time.perf_counter()
    if tracer is not None:
        tracer.stop()
    steps = s - CHECK_STEPS
    window = t1 - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e = {"setup_s": t0 - t_start, "step_ms": window / steps * 1e3}
    traced, unprofiled = None, dict(e2e)
    if tracer is not None and len(tracer.count_at) == 2:
        traced = tracer.count_at[1] - tracer.count_at[0]
        t_first, n_first = tracer.first
        unprofiled["step_ms"] = (t_first - t0) / n_first * 1e3
    ctx = Context(cell=cell, e2e=unprofiled, spans=spans, window_s=window,
                  steps=steps, trace=tracer.trace if tracer else None,
                  trace_log=tracer.log if tracer else None,
                  traced_steps=traced,
                  sites=lambda b: fam.sites(cfg, True, b),
                  batch=batch, peaks=_peaks(dev), loop="train")
    del trainer, feed, step, tracer
    free_device(dev)

    ref_losses, after = fam.reference_train(cfg, weights, seed, batch, lr,
                                            CHECK_STEPS, dev, tf32=False)
    reference = _train_readings([weights, after[0], after[-1]], ref_losses,
                                lr)
    if plant == "control":
        c_losses, c_after = fam.reference_train(cfg, weights, seed, batch, lr,
                                                CHECK_STEPS, dev, tf32=True)
        program = _train_readings([weights, c_after[0], c_after[-1]],
                                  c_losses, lr)
    checks, beside = compare_training(program, reference,
                                      cell.check["limits"])
    correct = bad == 0 and all(v["value"] <= v["limit"]
                               for v in checks.values())
    detail = {"window_s": window, "steps": steps,
              "host_s": ctx.trace.host_seconds() if ctx.trace else None,
              "trace_log": ctx.trace_log,
              "losses": losses, "ref_losses": ref_losses, **beside,
              "leaves": {f"{key}.{k}": [program[key][k], reference[key][k]]
                         for key in ("grad", "change")
                         for k in reference[key]}}
    return _result(cell, trace, ctx, correct, steps, bad, peak, checks,
                   dev), detail


def _train_readings(snaps, losses, lr) -> dict:
    """From the params before the first step, after it and after the
    last checked step: each leaf's first gradient as SGD took it, (p0 -
    p1) / lr, and its change over the steps, by norm; and the losses."""
    p0, p1, p3 = snaps
    grad = {k: float((p0[k] - p1[k]).double().norm()) / lr for k in p0}
    change = {k: float((p3[k] - p0[k]).double().norm()) for k in p0}
    return {"losses": [list(x) for x in losses], "grad": grad,
            "change": change}


def compare_training(program: dict, reference: dict, limits: dict) -> dict:
    """(the numbers compared, each with its limit; the change's worst
    leaf, reported beside them).  Each step's losses, as the worst |a -
    b| / |b|; and the first gradient's norm and the change's norm, leaf
    by leaf as |‖a‖ - ‖b‖| / max(‖b‖, the median leaf's ‖b‖).  Of the
    gradient both the worst leaf's gap (``grad_worst_leaf``: a fault at
    one site moves one leaf) and the median leaf's are compared; of the
    change the median leaf's, since its worst leaf is as a rule the last
    layer's 3-channel bias, a sum over every pixel of the batch that
    reads the order of the sum.  A leaf whose reference gradient is
    under a thousandth of the median leaf's (moved by round-off alone)
    is left out."""
    loss_gap = max(abs(a - b) / abs(b) if b else abs(a - b)
                   for pa, ra in zip(program["losses"], reference["losses"])
                   for a, b in zip(pa, ra))
    g_ref = reference["grad"]
    med = float(np.median(list(g_ref.values())))
    kept = [k for k in g_ref if g_ref[k] >= 1e-3 * med]

    def gaps(key):
        r = reference[key]
        med_r = float(np.median([r[k] for k in kept]))
        return [abs(program[key][k] - r[k]) / max(r[k], med_r)
                for k in kept]
    out = {"loss_gap": loss_gap,
           "grad_norm_gap": float(np.median(gaps("grad"))),
           "grad_worst_leaf": max(gaps("grad")),
           "change_norm_gap": float(np.median(gaps("change")))}
    checks = {k: {"value": v if math.isfinite(v) else math.inf,
                  "limit": limits[k]} for k, v in out.items()}
    return checks, {"change_worst_leaf": max(gaps("change"))}


# -- the result line -------------------------------------------------------

def _peaks(dev):
    if dev.type != "cuda":
        return None
    return work.card_peaks(torch.cuda.get_device_name(dev))


def _result(cell, trace, ctx, correct, attempted, failed, peak, checks,
            dev) -> dict:
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = ctx.e2e.get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device["power_limit_w"] = work.power_limit_w()
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if trace and ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                            "idle_gaps": ctx.trace.idle_gaps(10)}
    out["checks"] = checks
    return out
