"""Arithmetic the per-layer readers share: a device trace's shares and
roofline, the essential FLOPs a forward or a step does."""
from __future__ import annotations

import statistics

from bench import work


def median(values):
    values = list(values)
    return statistics.median(values) if values else None


def launch_count(ctx) -> int | None:
    """Forwards (serving) or steps (training) inside the traced part."""
    if ctx.loop == "train":
        return ctx.traced_steps
    return None if ctx.traced_launches is None else len(ctx.traced_launches)


def idle_pct(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def other_share_pct(ctx):
    """Device time outside the program's conv kernels A-D, as a share of
    all device kernel time in the traced part."""
    n = launch_count(ctx)
    if ctx.trace is None or not n:
        return None
    parts = ctx.trace.part_seconds(n)
    total = sum(parts.values())
    return 100.0 * parts.get("other", 0.0) / total if total else None


def roofline_pct(ctx, kernels: str):
    """Kernels ``kernels`` (e.g. "BC"): the roofline time of the sites they
    ran in the traced part, each launch at its bucket, over their device
    time."""
    if ctx.trace is None or ctx.peaks is None or not ctx.traced_launches:
        return None
    bound = 0.0
    for bucket, _ in ctx.traced_launches:
        bound += sum(site.bound_s(bucket, ctx.peaks)
                     for site, k in ctx.sites(bucket) if k in kernels)
    parts = ctx.trace.part_seconds(len(ctx.traced_launches))
    spent = sum(parts.get(k, 0.0) for k in kernels)
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent


def serve_mfu_pct(ctx):
    """Essential forward FLOPs an image times the images a second the run
    returned, over the card's f32 peak."""
    rate = ctx.e2e.get("img_per_s")
    if ctx.peaks is None or not rate:
        return None
    flops = work.forward_flops(site for site, _ in ctx.sites(1))
    return 100.0 * flops * rate / ctx.peaks.flops


def train_mfu_pct(ctx):
    """Essential FLOPs of a step (``work.gan_step_flops``) over the step
    time, over the card's f32 peak."""
    step_ms = ctx.e2e.get("step_ms")
    if ctx.peaks is None or not step_ms:
        return None
    sites = [site for site, _ in ctx.sites(ctx.batch)]
    gen = [s for s in sites if s.name == "proj" or s.name.startswith("dc")]
    disc = [s for s in sites if s not in gen]
    flops = work.gan_step_flops(gen, disc, ctx.batch)
    return 100.0 * flops / (step_ms / 1e3) / ctx.peaks.flops
