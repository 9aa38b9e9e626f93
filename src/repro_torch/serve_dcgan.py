"""Serve the DCGAN generator on the port through the SLO-aware control
plane: model load, bucket warmup, an open-loop drive and the latency
report.

Counterpart of ``examples/serve_dcgan.py``.  Latent requests arrive at
``--rate`` req/s (0 = one burst) with a priority class and an optional
deadline; the control plane (``serving/control_plane.py``) admits or
rejects them against the measured backlog, coalesces them into the plan
batch buckets (1/4/16/64) through its ``DynamicImageBatcher`` backend
(on the card one CUDA graph per bucket, captured at warmup), and sheds
what expired before launch.

``--inject-fault-at N`` kills the N-th launch mid-batch with a
``NodeFailure``: the control plane re-queues the launch's live requests
and replays them, and the driver checks zero drops and duplicates and,
for a burst (``--rate 0``), answers bit-equal to a fault-free reference
pass.

With ``--autotune cache|measure`` the plans take measured routes from the
per-host route cache (``--route-cache PATH``, default
``$HUGE2_ROUTE_CACHE`` or ``~/.cache/huge2/route_cache_torch.json``); the
same file keeps the backend's measured bucket costs, so a restarted server
re-runs neither the route microbenchmarks nor the bucket timings.

    PYTHONPATH=src python -m repro_torch.serve_dcgan [--requests 64]
        [--rate 0] [--max-wait-ms 2] [--backend cuda|torch] [--small]
        [--slo-ms 0] [--priority interactive|batch] [--inject-fault-at 0]
        [--device cuda|cpu] [--autotune off|cache|measure]
        [--route-cache PATH]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import autotune as at
from repro_torch.models import gan
from repro_torch.runtime.fault import FailureInjector
from repro_torch.serving.control_plane import ControlPlane, ServeRequest
from repro_torch.serving.metrics import format_stats

SMALL_LAYERS = (
    gan.DeconvLayer(4, 128, 64, 5, 2),
    gan.DeconvLayer(8, 64, 32, 5, 2),
    gan.DeconvLayer(16, 32, 3, 5, 2),
)


def load_model(*, small: bool, backend: str, device, seed: int = 0,
               autotune=None):
    """Build every conv plan (under the ``autotune`` policy, if any) and
    pack the weights once: (cfg, params)."""
    layers = SMALL_LAYERS if small else gan.DCGAN_LAYERS
    cfg = gan.GANConfig("dcgan", layers, backend=backend, autotune=autotune)
    gan.generator_plans(cfg)
    return cfg, gan.generator_init(seed, cfg, device=device)


def build_control_plane(serve_fn, proto, *, max_wait_ms, cache, cache_key,
                        device, fault_at=0, model="dcgan"):
    """A control plane serving ``serve_fn`` as ``model``, with a
    ``FailureInjector`` at launch ``fault_at`` (0 = none): (plane,
    backend)."""
    injector = FailureInjector((fault_at,)) if fault_at > 0 else None
    cp = ControlPlane(injector=injector)
    be = cp.register_image_model(model, serve_fn, proto,
                                 max_wait_ms=max_wait_ms, cache=cache,
                                 cache_key=cache_key, device=device)
    return cp, be


def drive(cp, payloads, *, rate, priority, slo_ms, model="dcgan"):
    """Submit ``payloads`` at ``rate`` req/s, pumping as they arrive, then
    drain.  A burst (``rate`` 0) is queued whole before the first pump,
    so its launch grouping does not depend on the host's clock (the
    fault check compares bits with a second pass)."""
    gap = 1.0 / rate if rate > 0 else 0.0
    for i, x in enumerate(payloads):
        if gap:
            time.sleep(gap)
        cp.submit(ServeRequest(rid=i, model=model, payload=x,
                               priority=priority,
                               slo_ms=slo_ms if slo_ms > 0 else None))
        if gap:
            cp.pump()
    cp.run()
    return cp


def check_replay(cp, be, payloads, args, *, serve_fn, proto, cache,
                 cache_key, model):
    """The fault checks: the fault fired and its requests were replayed;
    for a burst, every answer bit-equal to a fault-free reference pass on
    the same measured costs (launch grouping is deterministic there).
    Returns the line to print."""
    st = cp.stats()
    if st["faults"]["events"] < 1 or st["replayed_requests"] < 1:
        raise RuntimeError(f"fault at launch {args.inject_fault_at} never "
                           f"fired or replayed nothing: {st['faults']}")
    live = st["faults"]["records"][0]["live"]
    if args.rate != 0:
        return (f"fault at launch {args.inject_fault_at}: {live} live "
                f"requests re-queued + replayed; zero dropped, zero "
                f"duplicated (the bit-equal reference pass needs --rate 0)")
    ref, ref_be = build_control_plane(
        serve_fn, proto, max_wait_ms=args.max_wait_ms, cache=cache,
        cache_key=cache_key, device=args.device, model=model)
    ref_be.batcher.bucket_cost_s = dict(be.batcher.bucket_cost_s)
    drive(ref, payloads, rate=0.0, priority=args.priority, slo_ms=0.0,
          model=model)
    got, want = cp.results(), ref.results()
    if not set(got) <= set(want) or (args.slo_ms <= 0
                                      and sorted(got) != sorted(want)):
        raise RuntimeError("the faulted run served other requests than "
                           "the fault-free pass")
    bad = [rid for rid in got if not np.array_equal(got[rid], want[rid])]
    if bad:
        raise RuntimeError(f"replayed answers differ from the fault-free "
                           f"pass: rids {bad}")
    return (f"fault at launch {args.inject_fault_at}: {live} live requests "
            f"re-queued + replayed; zero dropped, zero duplicated, answers "
            f"bit-equal to the fault-free pass")


def report(cp, args, model) -> dict:
    """Print the serving report, check conservation and zero duplicates,
    and return ``stats()`` with ``completed``, ``launches`` and
    ``requests`` (the served ``ServeRequest``s)."""
    st = cp.stats()
    pm = st["per_model"][model]
    print(f"served {st['served']} of {st['submitted']} (rejected "
          f"{st['rejected']}, shed {st['shed']}; {pm['launches']} launches, "
          f"pad fraction {pm['pad_fraction']:.2f}, goodput under SLO "
          f"{st['goodput_under_slo']:.2f})")
    print(format_stats(st["per_class"][args.priority], unit="img"))
    if st["submitted"] != st["served"] + st["rejected"] + st["shed"]:
        raise RuntimeError(f"requests lost: {st}")
    rids = [r.rid for r in cp.done]
    if len(rids) != len(set(rids)):
        raise RuntimeError("a request was answered twice")
    st.update(completed=st["served"], launches=pm["launches"],
              requests=list(cp.done))
    return st


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="arrival rate in req/s (0 = submit all at once)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="reduced 32px generator")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--autotune", choices=("off", "cache", "measure"),
                    default="off",
                    help="measured routes: 'cache' = cached winners only, "
                         "'measure' = microbenchmark on a cache miss")
    ap.add_argument("--route-cache", default=None,
                    help="route/bucket-cost cache path (default "
                         "$HUGE2_ROUTE_CACHE or ~/.cache/huge2)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-request SLO in ms (0 = no deadline); blown "
                         "backlogs reject at admission, expired requests "
                         "shed before launch")
    ap.add_argument("--priority", choices=("interactive", "batch"),
                    default="interactive")
    ap.add_argument("--inject-fault-at", type=int, default=0,
                    help="kill the N-th launch mid-batch with a "
                         "NodeFailure (0 = off) and check the replay")
    args = ap.parse_args(argv)

    policy = cache = None
    if args.autotune != "off":
        policy = at.AutotunePolicy(mode=args.autotune,
                                   cache_path=args.route_cache)
        cache = at.open_cache(args.route_cache)
    t_load = time.perf_counter()
    cfg, params = load_model(small=args.small, backend=args.backend,
                             device=args.device, autotune=policy)
    plans = gan.generator_plans(cfg)
    t_load = time.perf_counter() - t_load
    print(f"model load: {len(plans)} conv plans built + weights packed "
          f"in {t_load * 1e3:.1f} ms "
          f"(plan build {sum(p.build_ms for p in plans):.2f} ms; routes "
          f"{[p.path for p in plans]})")

    def serve_fn(z):
        return gan.generator_apply(params, z, cfg)

    proto = np.zeros((cfg.z_dim,), np.float32)
    cache_key = f"serve_dcgan/{cfg.name}{'-small' if args.small else ''}"
    cp, be = build_control_plane(serve_fn, proto,
                                 max_wait_ms=args.max_wait_ms, cache=cache,
                                 cache_key=cache_key, device=args.device,
                                 fault_at=args.inject_fault_at)
    batcher = be.batcher
    t0 = time.perf_counter()
    timed = be.warmup()
    print(f"warmup: buckets {batcher.buckets} "
          f"{'captured as CUDA graphs' if batcher.graphed else 'run'} in "
          f"{time.perf_counter() - t0:.2f} s, {len(timed)} timed / "
          f"{len(batcher.buckets) - len(timed)} from the cache "
          f"(ms {[round(batcher.bucket_cost_s[b] * 1e3, 3) for b in batcher.buckets]})")

    rng = np.random.default_rng(0)
    payloads = [rng.standard_normal(cfg.z_dim).astype(np.float32)
                for _ in range(args.requests)]
    drive(cp, payloads, rate=args.rate, priority=args.priority,
          slo_ms=args.slo_ms)
    st = report(cp, args, "dcgan")
    if not all(np.isfinite(r.out).all() for r in cp.done):
        raise RuntimeError("non-finite output")
    if args.inject_fault_at > 0:
        print(check_replay(cp, be, payloads, args, serve_fn=serve_fn,
                           proto=proto, cache=cache, cache_key=cache_key,
                           model="dcgan"))
    if cp.done:
        print(f"output image shape: {cp.done[-1].out.shape} "
              f"({'32x32x3 reduced' if args.small else '64x64x3 from Table 1'}"
              f"; device {torch.device(args.device)})")
    st["warmup_timed"] = timed
    return st


if __name__ == "__main__":
    main()
