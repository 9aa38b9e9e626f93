"""Dynamic batching for image/latent serving, on PyTorch.

Counterpart of ``repro.serving.image_batcher``.  Requests are single
tensors (a latent for a GAN), so scheduling is pure coalescing: gather what
is queued, pad it up to the nearest plan batch bucket
(``core.plan.BATCH_BUCKETS`` — the sizes every ``ConvPlan`` routed at build
time) and run one launch of the serve function on the device.

Scheduling policy (as in the JAX package):

- launch immediately when a full largest bucket is queued;
- otherwise wait for more arrivals, but never longer than ``max_wait_ms``
  past the oldest request's arrival, then serve the queue in bucket-sized
  launches, padding the tail;
- ``drain=True`` flushes without waiting.

``warmup`` runs every bucket once (kernel build, library handles) and then
measures each bucket's launch wall time; the scheduler covers the queue with
the bucket multiset of least measured cost (a coin-change DP).  Until costs
are measured it rounds up to the nearest bucket.  With a route cache
(``core.autotune.RouteCache``) and a ``cache_key`` naming the served model,
the measured costs persist: a restarted server preloads them, and its
warmup runs every bucket but re-times none unless asked.

The serve function runs eagerly under ``torch.inference_mode()``; one CUDA
graph per bucket is later work, and so is data-parallel serving
(``dist``), which comes with the data-parallel slice.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.core.plan import BATCH_BUCKETS
from repro_torch.serving.metrics import latency_stats


@dataclasses.dataclass
class ImageRequest:
    rid: int
    payload: np.ndarray                    # (z_dim,) latent or (H, W, C) image
    # None = stamped by the batcher's injected clock at submit (open-loop
    # drivers stamp scheduled arrivals explicitly, in the same clock domain)
    t_arrival: Optional[float] = None
    t_done: Optional[float] = None
    out: Optional[np.ndarray] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None or self.t_arrival is None:
            return None
        return self.t_done - self.t_arrival


class DynamicImageBatcher:
    """Coalesce image requests into plan batch buckets.

    ``serve_fn(batch) -> batch`` is the model forward on a device tensor
    with parameters already bound (e.g. ``lambda z: generator_apply(params,
    z, cfg)``); ``device`` is where batches are placed (``"cuda"`` unless the
    caller asks for the CPU).  ``cache`` (a ``RouteCache``) and ``cache_key``
    persist the measured bucket costs per model and host.
    """

    def __init__(self, serve_fn: Callable, *,
                 buckets: Sequence[int] = BATCH_BUCKETS,
                 max_wait_ms: float = 2.0,
                 cache=None, cache_key: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device="cuda"):
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad buckets {buckets}")
        self.device = resolve_device(device)
        self.max_wait_s = max_wait_ms / 1e3
        # ONE clock for every scheduling timestamp (arrival, max-wait
        # expiry, completion); compute-cost durations (``warmup``) stay on
        # time.perf_counter — they measure the device, not the schedule
        self.clock = clock
        self._serve_fn = serve_fn
        self.cache = cache
        self.cache_key = cache_key
        self.queue: deque[ImageRequest] = deque()
        self.done: list[ImageRequest] = []
        self.launches: list[tuple[int, int]] = []   # (bucket, live) per call
        self.bucket_cost_s: dict[int, float] = {}   # measured by warmup
        if cache is not None and cache_key is not None:
            self.bucket_cost_s = {
                b: c for b, c in cache.get_bucket_costs(cache_key).items()
                if b in self.buckets}
        self._sched_memo: dict[int, tuple[float, int]] = {0: (0.0, 0)}
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def _serve(self, batch: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._serve_fn(batch)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- client API ----------------------------------------------------------
    def submit(self, req: ImageRequest):
        if req.t_arrival is None:
            req.t_arrival = self.clock()
        if self._t_first is None:
            self._t_first = self.clock()
        self.queue.append(req)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` (the largest bucket caps a launch)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def warmup(self, proto: Optional[np.ndarray] = None, *,
               iters: int = 2, force: bool = False) -> tuple[int, ...]:
        """Run every bucket once on a zeros payload (first-use set-up never
        lands in a request's latency), then measure each bucket's launch
        cost (min of ``iters``, synchronized) for the cost-aware scheduler.
        A bucket whose cost came from the route cache is run but not
        re-timed unless ``force=True``; newly measured costs are written
        back to the cache.  ``proto`` is one request payload; defaults to
        the oldest queued request's.  Returns the buckets timed."""
        if proto is None:
            if not self.queue:
                raise ValueError("warmup needs a proto payload or a queued "
                                 "request for the shape")
            proto = self.queue[0].payload
        timed = []
        for b in self.buckets:
            x = torch.from_numpy(
                np.zeros((b,) + proto.shape, proto.dtype)).to(self.device)
            self._serve(x)
            self._sync()
            if b in self.bucket_cost_s and not force:
                continue                                # cost from the cache
            ts = []
            for _ in range(iters):
                t0 = time.perf_counter()
                self._serve(x)
                self._sync()
                ts.append(time.perf_counter() - t0)
            self.bucket_cost_s[b] = min(ts)
            timed.append(b)
        self._sched_memo = {0: (0.0, 0)}                # rebuild on new costs
        if timed and self.cache is not None and self.cache_key is not None:
            self.cache.put_bucket_costs(self.cache_key, self.bucket_cost_s)
            self.cache.save()
        return tuple(timed)

    def _first_launch_size(self, n: int) -> int:
        """Bucket of the next launch for a queue of ``n``: head of the
        cheapest bucket cover under the measured costs, else round-up."""
        if not self.bucket_cost_s:
            return self.bucket_for(n)
        return max(self._plan_cover(n))

    def _plan_cover(self, n: int) -> tuple[int, ...]:
        """Bucket multiset covering ``n`` requests at minimum measured cost
        (coin-change DP over launch sizes; overshoot = tail pad)."""
        memo = self._sched_memo
        for i in range(1, n + 1):
            if i not in memo:
                memo[i] = min(
                    (self.bucket_cost_s[b] + memo[max(0, i - b)][0], b)
                    for b in self.buckets)
        cover, k = [], n
        while k > 0:
            b = memo[k][1]
            cover.append(b)
            k = max(0, k - b)
        return tuple(cover)

    # -- scheduler -----------------------------------------------------------
    def pump(self, *, drain: bool = False) -> list[ImageRequest]:
        """Launch at most one batch if the policy says go; returns the
        requests completed by that launch (empty when still coalescing)."""
        if not self.queue:
            return []
        now = self.clock()
        full = len(self.queue) >= self.buckets[-1]
        expired = now - self.queue[0].t_arrival >= self.max_wait_s
        if not (full or expired or drain):
            return []
        size = self._first_launch_size(len(self.queue))
        take = min(len(self.queue), size)
        reqs = [self.queue.popleft() for _ in range(take)]
        return self._launch(reqs, bucket=size)

    def run(self, reqs=None, *, drain: bool = True) -> list[ImageRequest]:
        """Submit ``reqs`` (optional) and pump until the queue is empty.
        With ``drain=False`` the loop sleeps out the oldest request's
        max-wait deadline instead of spinning on empty pumps."""
        for r in reqs or ():
            self.submit(r)
        while self.queue:
            if not self.pump(drain=drain) and not drain and self.queue:
                wait = self.max_wait_s - (self.clock()
                                          - self.queue[0].t_arrival)
                if wait > 0:
                    time.sleep(min(wait, 1e-3))
        return self.done

    def execute(self, rows: Sequence[np.ndarray],
                bucket: Optional[int] = None) -> np.ndarray:
        """Pad ``rows`` up to ``bucket`` and run ONE launch on the device,
        returning the live output rows (copied back to the host)."""
        bucket = self.bucket_for(len(rows)) if bucket is None else bucket
        batch = np.stack([np.asarray(r) for r in rows])
        if len(rows) < bucket:                       # pad the tail
            pad = np.zeros((bucket - len(rows),) + batch.shape[1:],
                           batch.dtype)
            batch = np.concatenate([batch, pad])
        out = self._serve(torch.from_numpy(batch).to(self.device))
        self.launches.append((bucket, len(rows)))
        return out[:len(rows)].cpu().numpy()

    def _launch(self, reqs: list[ImageRequest],
                bucket: Optional[int] = None) -> list[ImageRequest]:
        out = self.execute([r.payload for r in reqs], bucket)
        now = self.clock()
        for i, r in enumerate(reqs):
            r.out = out[i]
            r.t_done = now
        self.done.extend(reqs)
        self._t_last = now
        return reqs

    def reset_stats(self):
        """Drop request/launch history for a fresh measurement window; the
        measured bucket costs are kept."""
        self.queue.clear()
        self.done = []
        self.launches = []
        self._t_first = self._t_last = None

    # -- open-loop driver ----------------------------------------------------
    def drive_open_loop(self, make_payload: Callable[[int], np.ndarray],
                        requests: int, rate: float = 0.0
                        ) -> list[ImageRequest]:
        """Submit ``requests`` payloads at ``rate`` req/s (0 = one burst),
        pumping as arrivals trickle in, then drain the tail."""
        gap = 1.0 / rate if rate > 0 else 0.0
        for i in range(requests):
            if gap:
                time.sleep(gap)
            self.submit(ImageRequest(rid=i, payload=make_payload(i)))
            self.pump()
        return self.run()

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        window = None
        if self._t_first is not None and self._t_last is not None:
            window = self._t_last - self._t_first
        st = latency_stats([r.latency_s for r in self.done], window_s=window)
        st["launches"] = len(self.launches)
        st["bucket_histogram"] = {
            b: sum(1 for bb, _ in self.launches if bb == b)
            for b in self.buckets}
        st["pad_fraction"] = (
            1.0 - (sum(live for _, live in self.launches)
                   / max(1, sum(b for b, _ in self.launches))))
        return st
