"""Measured route autotuning: microbenchmark-backed plan decisions with a
persistent per-host route cache.

Counterpart of ``repro.core.autotune``.  The heuristic route choices
(``plan._transposed_route_1dev`` / ``plan._single_route_1dev``) decide a
route from byte caps and the reference's tile verdicts, arithmetic that
does not see the machine.  This module measures instead:

- ``measure_fn``       — the one timing loop: CUDA events around each call
  on CUDA tensors (a synchronize before the stop event is read), the host
  clock on CPU tensors; min and median reported.
- ``candidate_routes`` — the feasible routes of one (site, bucket): on the
  'cuda' policy the whole-plane kernel (A or B) and, where the reference's
  tile search fits a tile, the spatially tiled kernel (D or C) with the
  card's block tile; then ``pixel_shuffle``, ``fused_plane``,
  ``fused_tap``, ``taps`` and, transposed only, ``per_phase``.
- ``measure_bucket``   — time every measurable candidate and pick the
  winner; the heuristic route loses only to a challenger faster by
  ``AutotunePolicy.min_gain`` (hysteresis against noise).
- ``RouteCache``       — persistent per-host winners keyed by the spec and
  a device fingerprint, in the JSON route schema of the golden fixture
  ``tests/fixtures/route_table.json``, plus the image batcher's measured
  bucket costs.
- ``autotune_plan``    — what ``plan.plan_conv(spec, autotune=...)``
  dispatches to.

The fallback ladder, per bucket::

    cache hit  →  measured winner (no timing runs)
    cache miss + mode='measure'  →  measure the candidates, persist
    cache miss + mode='cache'    →  heuristic route
    unmeasurable heuristic route (a 'cuda' route on CPU tensors)  →  heuristic
    unreadable/stale/foreign cache  →  warn once, heuristic

A 'cuda' candidate is timed only on a CUDA device: on CPU tensors its
wrapper runs the kernel's plain version, whose time says nothing about the
kernel (the reference's rule for Pallas in interpret mode).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import plan as planmod
from repro_torch.core.plan import (BATCH_BUCKETS, ConvPlan, ConvSpec,
                                   QuantizedSuperpack, Route,
                                   pick_tiled_single, pick_tiled_transposed)
from repro_torch.kernels.untangled_conv import (pick_block_tile_single,
                                                pick_block_tile_transposed)

SCHEMA = "huge2-route-cache/v1"
CACHE_ENV = "HUGE2_ROUTE_CACHE"
# the port's own default file: a host running both packages keeps two sets
# of winners (the fingerprints already keep either from reading the other's)
DEFAULT_CACHE = "~/.cache/huge2/route_cache_torch.json"

# monotonic count of microbenchmark runs this process has performed; the
# tests assert that warm-cache model loads leave it unchanged
_MEASURE_CALLS = 0

# in-process singletons: one loaded cache per path, one tuned plan per
# (spec, policy); cleared by ``reset()`` / ``plan.plan_cache_clear()``
_OPEN_CACHES: dict[str, "RouteCache"] = {}
_TUNED: dict[tuple[ConvSpec, "AutotunePolicy"], ConvPlan] = {}


def measure_calls() -> int:
    """Total microbenchmark runs so far (monotonic; compare before/after)."""
    return _MEASURE_CALLS


def reset():
    """Drop in-process autotune state (tuned plans and loaded caches) so
    the next build re-reads the cache file.  The counter stays
    monotonic."""
    _OPEN_CACHES.clear()
    _TUNED.clear()


# ---------------------------------------------------------------------------
# timing: the one loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Timing:
    """One microbenchmark result.  ``min_s`` is the headline (interference
    only ever adds time); ``median_s`` beside it flags a noisy window."""

    min_s: float
    median_s: float
    iters: int

    @property
    def min_us(self) -> float:
        return self.min_s * 1e6


def _on_cuda(args) -> bool:
    """Whether the call's tensor arguments live on a CUDA device."""
    for a in args:
        if isinstance(a, QuantizedSuperpack):
            a = a.q
        if isinstance(a, torch.Tensor):
            return a.device.type == "cuda"
    return False


def measure_fn(fn: Callable, *args, iters: int = 10, warmup: int = 3
               ) -> Timing:
    """Time ``fn(*args)``: ``warmup`` untimed runs, then ``iters`` timed
    ones.  On CUDA tensors each run sits between two CUDA events and the
    device is synchronized before the stop event is read, so no work
    leaks past the clock; at least one warm-up run absorbs a kernel's
    first-use build.  On CPU tensors, the host clock."""
    cuda = _on_cuda(args)
    for _ in range(max(warmup, 1) if cuda else warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            stop.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return Timing(float(np.min(ts)), float(np.median(ts)), iters)


# ---------------------------------------------------------------------------
# cache schema: spec keys, route (de)serialization, device fingerprint
# ---------------------------------------------------------------------------

def _bench_device() -> torch.device:
    """Where plans are measured: the current card, else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_fingerprint() -> dict:
    """What has to match for measured winners to carry between hosts: the
    card's name, compute capability and count and the torch and CUDA
    versions (an upgrade can reshuffle the rankings); ``'cpu'`` and the
    torch version on a host without a card."""
    dev = _bench_device()
    if dev.type != "cuda":
        return {"platform": "cpu", "device_kind": "cpu", "device_count": 1,
                "torch": str(torch.__version__)}
    major, minor = torch.cuda.get_device_capability(dev)
    return {"platform": "cuda",
            "device_kind": torch.cuda.get_device_name(dev),
            "capability": f"{major}.{minor}",
            "device_count": int(torch.cuda.device_count()),
            "torch": str(torch.__version__),
            "cuda": str(torch.version.cuda)}


def spec_key(spec: ConvSpec) -> str:
    """Deterministic cache key over every plan-relevant spec constant (the
    spatial and wdtype suffixes only for specs that set them, as in the
    reference)."""
    (ph, pw) = spec.padding
    key = (f"{spec.kind}:{spec.in_hw[0]}x{spec.in_hw[1]}"
           f":c{spec.in_c}->{spec.out_c}"
           f":k{spec.kernel_hw[0]}x{spec.kernel_hw[1]}"
           f":s{spec.strides[0]}x{spec.strides[1]}"
           f":p{ph[0]},{ph[1]},{pw[0]},{pw[1]}"
           f":d{spec.dilation[0]}x{spec.dilation[1]}"
           f":{spec.dtype}:{spec.backend}")
    if spec.spatial != (1, 1):
        key += f":sp{spec.spatial[0]}x{spec.spatial[1]}"
    if spec.wdtype != "float32":
        key += f":w{spec.wdtype}"
    return key


def spec_to_json(spec: ConvSpec) -> dict:
    """The fixture's spec record."""
    return {
        "kind": spec.kind, "in_hw": list(spec.in_hw),
        "in_c": spec.in_c, "out_c": spec.out_c,
        "kernel_hw": list(spec.kernel_hw),
        "strides": list(spec.strides),
        "padding": [list(p) for p in spec.padding],
        "dilation": list(spec.dilation),
        "spatial": list(spec.spatial),
        "wdtype": spec.wdtype,
    }


def route_to_json(route: Route) -> dict:
    """The fixture's route record, one schema for the fixture and the
    cache."""
    return {
        "batch": route.batch,
        "path": route.path,
        "tiles": list(route.tiles) if route.tiles else None,
        "sp_tiles": list(route.sp_tiles) if route.sp_tiles else None,
        "dev_tiles": list(route.dev_tiles) if route.dev_tiles else None,
        "fused_bwd": route.fused_bwd,
    }


def route_from_json(d: dict) -> Route:
    return Route(
        batch=int(d["batch"]), path=str(d["path"]),
        tiles=tuple(d["tiles"]) if d.get("tiles") else None,
        fused_bwd=bool(d.get("fused_bwd", True)),
        sp_tiles=tuple(d["sp_tiles"]) if d.get("sp_tiles") else None,
        dev_tiles=tuple(d["dev_tiles"]) if d.get("dev_tiles") else None)


def cache_path(path: Optional[str] = None) -> Optional[str]:
    """The cache location: explicit arg > ``$HUGE2_ROUTE_CACHE`` > the
    per-user default.  ``''`` means memory-only (no file)."""
    if path == "":
        return None
    if path is None:
        path = os.environ.get(CACHE_ENV) or DEFAULT_CACHE
    return str(pathlib.Path(path).expanduser())


class RouteCache:
    """Persistent per-host route winners and serving bucket costs.

    One JSON file, schema-versioned and fingerprint-guarded.  Every load
    failure (missing file, corrupt or truncated JSON, stale schema,
    foreign fingerprint, malformed entries) leaves an *empty* cache and a
    ``RuntimeWarning``: the caller falls back to heuristic routes and a
    later ``save`` rewrites the file cleanly."""

    def __init__(self, path: Optional[str] = None):
        self.path = cache_path(path)
        self.fingerprint = device_fingerprint()
        # spec_key -> {"spec": {...}, "routes": {batch(str): route-json}}
        self.entries: dict[str, dict] = {}
        # serving-side warmup costs: cache_key -> {bucket(str): seconds}
        self.bucket_costs: dict[str, dict] = {}
        self.loaded_from_disk = False
        if self.path is not None:
            self._load()

    # -- persistence ---------------------------------------------------------
    def _warn(self, why: str):
        warnings.warn(
            f"route cache {self.path}: {why} — falling back to heuristic "
            f"routes (the cache will be rewritten on the next save)",
            RuntimeWarning, stacklevel=3)

    def _load(self):
        p = pathlib.Path(self.path)
        if not p.exists():
            return
        try:
            raw = json.loads(p.read_text())
        except (OSError, ValueError) as e:
            self._warn(f"unreadable ({e.__class__.__name__}: {e})")
            return
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA:
            got = raw.get("schema") if isinstance(raw, dict) else None
            self._warn(f"stale or unknown schema {got!r} (want {SCHEMA!r})")
            return
        if raw.get("fingerprint") != self.fingerprint:
            self._warn(f"device fingerprint mismatch "
                       f"(file {raw.get('fingerprint')!r}, "
                       f"host {self.fingerprint!r})")
            return
        try:
            entries = dict(raw.get("entries", {}))
            # validate eagerly: every route record must deserialize
            for ent in entries.values():
                for b, rj in ent["routes"].items():
                    int(b), route_from_json(rj)
            self.entries = entries
            self.bucket_costs = {
                k: {str(b): float(c) for b, c in v.items()}
                for k, v in dict(raw.get("bucket_costs", {})).items()}
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            self._warn(f"malformed entries ({e.__class__.__name__}: {e})")
            self.entries, self.bucket_costs = {}, {}
            return
        self.loaded_from_disk = True

    def save(self):
        """Atomic write (tmp + rename) of the full cache state."""
        if self.path is None:
            return
        p = pathlib.Path(self.path)
        p.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "schema": SCHEMA,
            "fingerprint": self.fingerprint,
            "generated_by": "repro_torch.core.autotune",
            "entries": self.entries,
            "bucket_costs": self.bucket_costs,
        }
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
        tmp.replace(p)

    # -- routes --------------------------------------------------------------
    def get(self, spec: ConvSpec, batch: int) -> Optional[Route]:
        ent = self.entries.get(spec_key(spec))
        if ent is None:
            return None
        rj = ent["routes"].get(str(batch))
        return None if rj is None else route_from_json(rj)

    def put(self, spec: ConvSpec, route: Route,
            timings: Optional[dict] = None):
        ent = self.entries.setdefault(
            spec_key(spec), {"spec": spec_to_json(spec),
                             "backend": spec.backend, "routes": {}})
        rj = route_to_json(route)
        if timings:
            rj["measured_us"] = {k: round(v * 1e6, 3)
                                 for k, v in timings.items()}
        ent["routes"][str(route.batch)] = rj

    # -- serving bucket costs ------------------------------------------------
    def get_bucket_costs(self, key: str) -> dict[int, float]:
        return {int(b): float(c)
                for b, c in self.bucket_costs.get(key, {}).items()}

    def put_bucket_costs(self, key: str, costs: dict[int, float]):
        self.bucket_costs[key] = {str(b): float(c) for b, c in costs.items()}


def open_cache(path: Optional[str] = None) -> RouteCache:
    """Load or create the cache at ``path`` (one per resolved path in the
    process, so concurrent plan builds share one view and saves merge)."""
    resolved = cache_path(path)
    if resolved is None:
        return RouteCache("")
    if resolved not in _OPEN_CACHES:
        _OPEN_CACHES[resolved] = RouteCache(resolved)
    return _OPEN_CACHES[resolved]


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutotunePolicy:
    """How ``plan_conv(spec, autotune=...)`` resolves routes.

    ``mode``: ``'measure'`` times cache misses on the live device and
    persists the winners; ``'cache'`` only reads cached winners (a host
    that ships the cache never runs a timing loop); ``'off'`` is the
    heuristic (as ``autotune=None``).  ``cache_path``: ``None`` →
    ``$HUGE2_ROUTE_CACHE`` or the per-user default; ``''`` → memory only.
    ``buckets`` limits tuning to some of the plan's batch buckets (``None``
    = all).  ``min_gain``: a challenger's median time must beat the
    heuristic route's min time by this factor to replace it."""

    mode: str = "measure"             # 'off' | 'cache' | 'measure'
    cache_path: Optional[str] = None  # None=env/default, ''=memory-only
    buckets: Optional[tuple[int, ...]] = None
    iters: int = 5
    warmup: int = 2
    min_gain: float = 1.03

    def __post_init__(self):
        if self.mode not in ("off", "cache", "measure"):
            raise ValueError(f"bad autotune mode {self.mode!r}")


# ---------------------------------------------------------------------------
# candidate enumeration: the feasible set the heuristic picks one of
# ---------------------------------------------------------------------------

def _dedupe(routes: Sequence[Route]) -> tuple[Route, ...]:
    seen, out = set(), []
    for r in routes:
        k = (r.path, r.tiles, r.sp_tiles, r.dev_tiles)
        if k not in seen:
            seen.add(k)
            out.append(r)
    return tuple(out)


def _with_dev_candidates(plan: ConvPlan, batch: int,
                         cands: Sequence[Route]) -> tuple[Route, ...]:
    """Device-tiled candidates for a spatial spec: each single-device
    candidate paired with its plane-parallel twin (the same per-block
    path, ``dev_tiles`` attached), so ``measure_bucket`` ranks split
    against single-device execution on the bound mesh like any other
    route."""
    if plan.spec.spatial == (1, 1):
        return _dedupe(cands)
    from repro_torch.core import spatial as spatialmod
    if spatialmod.spatial_plan(plan.spec) is None:
        return _dedupe(cands)
    both = []
    for r in cands:
        both.append(dataclasses.replace(r, dev_tiles=None))
        both.append(dataclasses.replace(r, dev_tiles=plan.spec.spatial))
    return _dedupe(both)


def candidate_routes(plan: ConvPlan, batch: int) -> tuple[Route, ...]:
    """Every feasible whole-conv route of this (site, bucket), the set the
    heuristic picks one of.  All share the bucket's ``fused_bwd`` verdict
    (a memory cap on the backward, not a tunable)."""
    spec = plan.spec
    itemsize = planmod._itemsize(spec)
    witemsize = planmod._weight_itemsize(spec)
    c, n = spec.in_c, spec.out_c
    oh, ow = plan.out_hw
    want_cuda = planmod._want_cuda(spec.backend)
    cands: list[Route] = []

    if spec.kind == "transposed":
        if plan.total_taps == 0:
            return (Route(batch, "taps", None),)
        (glh, ghh), (glw, ghw) = plan.gpad
        hg = spec.in_hw[0] + glh + ghh
        wg = spec.in_hw[1] + glw + ghw
        if want_cuda:
            cands.append(Route(batch, "cuda", None))
            if plan.uniform and oh % spec.strides[0] == 0 \
                    and ow % spec.strides[1] == 0 \
                    and pick_tiled_transposed(
                        c, n, plan.total_taps, plan.phases, itemsize,
                        witemsize=witemsize) is not None:
                cands.append(Route(batch, "cuda", None,
                                   sp_tiles=pick_block_tile_transposed(
                                       plan.phases, n)))
        ps = planmod._pixel_shuffle_route(spec, plan.phases, batch)
        if ps is not None:
            cands.append(ps)
        plane_bytes = 4 * batch * hg * wg * plan.total_taps * n
        if plane_bytes <= planmod._PLANE_BYTES_MAX:
            cands.append(Route(batch, "fused_plane", None))
        if plan.uniform:
            cands.append(Route(batch, "fused_tap", None))
        cands.append(Route(batch, "taps", None))
        cands.append(Route(batch, "per_phase", None))
        return _with_dev_candidates(plan, batch, cands)

    # 'conv' / 'dilated': the single-correlation feasible set
    r, s = spec.kernel_hw
    fused_ok = 4 * batch * oh * ow * r * s * c <= planmod._PLANE_BYTES_MAX
    if want_cuda:
        cands.append(Route(batch, "cuda", None, fused_bwd=fused_ok))
        dil = spec.dilation if spec.kind == "dilated" else (1, 1)
        if pick_tiled_single(c, n, r, s, oh, ow, spec.strides, dil,
                             itemsize, witemsize=witemsize) is not None:
            cands.append(Route(batch, "cuda", None, fused_bwd=fused_ok,
                               sp_tiles=pick_block_tile_single(
                                   plan.out_hw, spec.kernel_hw,
                                   spec.strides, dil, n)))
    if fused_ok:
        cands.append(Route(batch, "fused_tap", None, fused_bwd=True))
    cands.append(Route(batch, "taps", None, fused_bwd=fused_ok))
    return _with_dev_candidates(plan, batch, cands)


def _measurable(route: Route) -> bool:
    """A 'cuda' route is timed only on a CUDA device (on CPU tensors its
    wrapper runs the plain version); a device-tiled route only under a
    bound spatial mesh that matches it (without one the forced plan would
    time the single-device run)."""
    if route.path == "cuda" and _bench_device().type != "cuda":
        return False
    if route.dev_tiles is not None:
        from repro_torch.core import spatial as spatialmod
        active = spatialmod.active_spatial_mesh()
        if active is None or not spatialmod.mesh_matches(
                *active, route.dev_tiles):
            return False
    return True


def route_label(route: Route) -> str:
    lab = route.path
    if route.tiles:
        lab += f"@{route.tiles[0]}x{route.tiles[1]}"
    if route.sp_tiles:
        lab += f"@sp{route.sp_tiles[0]}x{route.sp_tiles[1]}"
    if route.dev_tiles:
        lab += f"@dev{route.dev_tiles[0]}x{route.dev_tiles[1]}"
    return lab


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _bench_inputs(plan: ConvPlan, batch: int):
    """Seeded synthetic (x, packed) at the bucket's batch on the
    measurement device: the same draws on every host."""
    spec = plan.spec
    dtype = getattr(torch, spec.dtype)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((batch, spec.in_hw[0], spec.in_hw[1], spec.in_c),
                    generator=gen, dtype=dtype)
    kernel = torch.randn((*spec.kernel_hw, spec.in_c, spec.out_c),
                         generator=gen, dtype=dtype)
    dev = _bench_device()
    return x.to(dev), plan.pack(kernel).to(dev)


def measure_route(plan: ConvPlan, route: Route, x, packed, *,
                  iters: int = 5, warmup: int = 2) -> Timing:
    """Time ONE candidate: the plan's forward with the route forced for
    every batch, through the shared loop.  Every timing run goes through
    here, so the counter behind ``measure_calls()`` lives here."""
    global _MEASURE_CALLS
    _MEASURE_CALLS += 1
    forced = plan.with_routes((route,))

    def fwd(x_, p_):
        with torch.inference_mode():
            return forced.apply(x_, p_)

    return measure_fn(fwd, x, packed, iters=iters, warmup=warmup)


def _slowest_rank(measured: dict) -> dict:
    """Under a bound spatial mesh every rank takes the slowest rank's
    times (the split run's time is its slowest rank's), so all ranks pick
    the same winner; without one, the times as they are."""
    from repro_torch.core import spatial as spatialmod
    active = spatialmod.active_spatial_mesh()
    if active is None or not measured:
        return measured
    dist = torch.distributed
    mesh = active[0]
    t = torch.tensor([[m.min_s, m.median_s] for m in measured.values()],
                     dtype=torch.float64)
    for name in mesh.mesh_dim_names:
        group = mesh.get_group(name)
        # gloo reduces host tensors, NCCL device ones
        t = t.to("cpu" if dist.get_backend(group) == "gloo" else "cuda")
        dist.all_reduce(t, dist.ReduceOp.MAX, group=group)
    return {cand: Timing(float(a), float(b), m.iters) for (cand, m), (a, b)
            in zip(measured.items(), t.tolist())}


def measure_bucket(plan: ConvPlan, batch: int,
                   policy: Optional[AutotunePolicy] = None
                   ) -> tuple[Route, dict[str, float]]:
    """Measure every feasible candidate of (plan, bucket) and return
    ``(winner, {label: min_seconds})``.  The heuristic route is always a
    candidate and wins ties: a challenger replaces it only when its
    *median* run beats the heuristic's *min* by ``policy.min_gain``, so a
    win has to hold across the challenger's runs, not in one lucky run
    (the reference compares min with min; on the card, calls of a few
    microseconds are paced by the host, and a min-only margin of a few
    percent lies inside the run-to-run spread).  Among the challengers
    that qualify the lowest min wins.  A bucket whose heuristic route
    cannot be timed honestly (a 'cuda' route on a host without a card) is
    not tuned."""
    policy = policy or AutotunePolicy()
    heuristic = plan.route_for_batch(batch)
    if not _measurable(heuristic):
        return heuristic, {}
    cands = [r for r in _dedupe((heuristic,) + candidate_routes(plan, batch))
             if _measurable(r)]
    if len(cands) < 2:
        return heuristic, {}
    x, packed = _bench_inputs(plan, batch)
    measured = _slowest_rank({
        cand: measure_route(plan, cand, x, packed, iters=policy.iters,
                            warmup=policy.warmup) for cand in cands})
    h_t = measured[heuristic].min_s
    best_route, best_t = heuristic, None
    for cand, t in measured.items():
        if cand == heuristic:
            continue
        if t.median_s * policy.min_gain < h_t and (
                best_t is None or t.min_s < best_t):
            best_route, best_t = cand, t.min_s
    return best_route, {route_label(c): t.min_s for c, t in measured.items()}


# ---------------------------------------------------------------------------
# the plan-level entry: what plan_conv(spec, autotune=...) dispatches to
# ---------------------------------------------------------------------------

def autotune_plan(plan: ConvPlan, policy: AutotunePolicy) -> ConvPlan:
    """The tuned sibling of ``plan`` under ``policy`` (one per (spec,
    policy) in the process).  Per bucket: cache hit → cached winner; miss
    + ``mode='measure'`` → measure and persist; miss + ``mode='cache'`` →
    the heuristic route."""
    if policy.mode == "off":
        return plan
    key = (plan.spec, policy)
    if key in _TUNED:
        return _TUNED[key]
    cache = open_cache(policy.cache_path)
    tune_buckets = (set(policy.buckets) if policy.buckets is not None
                    else set(BATCH_BUCKETS))
    routes, dirty = [], False
    for hr in plan.routes:
        if hr.batch not in tune_buckets:
            routes.append(hr)
            continue
        cached = cache.get(plan.spec, hr.batch)
        if cached is not None:
            routes.append(cached)
            continue
        if policy.mode != "measure":
            routes.append(hr)
            continue
        best, timings = measure_bucket(plan, hr.batch, policy)
        routes.append(best)
        if timings:
            cache.put(plan.spec, best, timings)
            dirty = True
    if dirty:
        cache.save()
    tuned = plan.with_routes(tuple(routes))
    _TUNED[key] = tuned
    return tuned
