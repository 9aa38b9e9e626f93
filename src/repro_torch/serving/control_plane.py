"""SLO-aware serving control plane: one admission + scheduling layer in
front of every model backend (the bucket image batchers and the LM slot
scheduler), with fault-injected replay wired into the launch path.

Counterpart of ``repro.serving.control_plane``, with its names, its policy
and its ``stats()`` keys:

admission → schedule → launch → replay

- **Admission** (``submit``): a request carries an SLO (``slo_ms``) and a
  priority class (``interactive`` > ``batch``).  When the backend has
  measured launch costs, the estimate of wait + service for the backlog
  ahead of the request is held against its deadline; a blown estimate
  **rejects at admission**.  Without measured costs admission is
  permissive.
- **Schedule** (``pump``): per-model, per-class FIFO queues.  Interactive
  launches first, but a batch request older than ``starvation_ms`` goes
  ahead of fresher interactive work.  Across models the head-of-line
  request with the earliest deadline wins (EDF).  A launch takes from the
  chosen class and *backfills* the bucket's other slots with the other
  class.  Requests whose deadline has passed are **shed before launch**.
- **Launch**: image models go through the backend's bucket executables
  (``DynamicImageBatcher.execute``: on the card one CUDA graph per bucket,
  captured at warmup); LM models advance one ``ContinuousBatcher`` step
  per pump (on the card one CUDA graph per slot).  Every launch's wall
  time feeds a per-(model, bucket) ``StragglerMonitor``.
- **Replay**: a ``FailureInjector`` (or a real ``NodeFailure``) firing at
  a launch kills that launch's results.  The affected live requests go
  back to the *front* of their class queues in arrival order and replay
  on the next pump: zero dropped, zero answered twice, and the answers
  bit-equal to a fault-free run (the replay hits the same executables on
  the same payloads).

``degrade`` serves on a shrunk mesh: data-parallel through
``runtime.elastic.shrink_mesh`` (each rank serves its rows of a batch),
or plane-parallel (``spatial_tiles=``)
on a ``make_spatial_mesh`` bound as the active spatial mesh; every image
backend is rebound (``ImageBackend.rebind``).  Run under SPMD, every rank
drives its own plane with the same requests and the same clock readings
(a fake clock, or rank 0's), so all ranks take the same decisions and
meet in the same launches.  ``LMBackend(memory=)`` serves an
encoder-decoder over one encoder output for every request, as JAX's.

``stats()`` reports per-class p50/p95/p99, **goodput under SLO** (served
within deadline / submitted), the fault and replay records, and the
straggler alert.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.plan import BATCH_BUCKETS
from repro_torch.runtime.fault import NodeFailure, StragglerMonitor
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.image_batcher import DynamicImageBatcher
from repro_torch.serving.metrics import latency_stats

PRIORITIES = ("interactive", "batch")


@dataclasses.dataclass
class ServeRequest:
    """One request under the control plane.

    Status lifecycle: ``queued`` -> ``served`` | ``rejected`` | ``shed``
    (a fault replay moves a request back to ``queued`` and bumps
    ``replays``).  ``slo_ms=None`` means no deadline: never rejected or
    shed.
    """

    rid: int
    model: str
    payload: np.ndarray                     # image/latent, or (P,) int LM prompt
    priority: str = "interactive"
    slo_ms: Optional[float] = None
    max_new: int = 16                       # LM backends only
    # None = stamped by the control plane's injected clock at submit
    t_arrival: Optional[float] = None
    t_done: Optional[float] = None
    out: Optional[np.ndarray] = None
    status: str = "queued"
    replays: int = 0
    reason: str = ""                        # why rejected / shed

    def __post_init__(self):
        if self.priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {self.priority!r}")

    @property
    def deadline(self) -> Optional[float]:
        if self.slo_ms is None or self.t_arrival is None:
            return None
        return self.t_arrival + self.slo_ms / 1e3

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None or self.t_arrival is None:
            return None
        return self.t_done - self.t_arrival

    @property
    def in_slo(self) -> Optional[bool]:
        """Served within deadline; ``None`` when no SLO was attached."""
        if self.slo_ms is None:
            return None
        return self.t_done is not None and self.t_done <= self.deadline


class ImageBackend:
    """Image/latent launch engine: a ``DynamicImageBatcher`` for its bucket
    executables, measured bucket costs and cover planning; the control
    plane owns admission and ordering (the batcher's own queue stays
    empty).  ``device`` is where the batches run (``"cuda"`` unless the
    caller asks for the CPU)."""

    kind = "image"

    def __init__(self, name: str, serve_fn: Callable, proto: np.ndarray, *,
                 buckets: Sequence[int] = BATCH_BUCKETS,
                 max_wait_ms: float = 2.0, dist=None,
                 cache=None, cache_key: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device="cuda"):
        self.name = name
        self.proto = np.asarray(proto)
        self.batcher = DynamicImageBatcher(
            serve_fn, buckets=buckets, max_wait_ms=max_wait_ms,
            cache=cache, cache_key=cache_key or name, clock=clock,
            device=device, dist=dist)

    @property
    def max_wait_s(self) -> float:
        return self.batcher.max_wait_s

    @property
    def largest_bucket(self) -> int:
        return self.batcher.buckets[-1]

    def warmup(self, **kw):
        return self.batcher.warmup(self.proto, **kw)

    def next_launch_size(self, n: int) -> int:
        return self.batcher._first_launch_size(n)

    def estimate_s(self, ahead: list, req: ServeRequest) -> Optional[float]:
        """Admission estimate: measured cost of covering the ``ahead``
        backlog plus this request (``None`` until costs are measured)."""
        if not self.batcher.bucket_cost_s:
            return None
        n = len(ahead) + 1
        self.batcher._plan_cover(n)
        return self.batcher._sched_memo[n][0]

    def launch(self, payloads: Sequence[np.ndarray],
               bucket: int) -> np.ndarray:
        return self.batcher.execute(payloads, bucket)

    def rebind(self, dist, serve_fn: Optional[Callable] = None):
        self.batcher.rebind_dist(dist, serve_fn)


class LMBackend:
    """LM slot-scheduler backend: admitted prompts go into a
    ``ContinuousBatcher`` as slots free up (priority order is held at the
    control plane's queues) and it advances one decode step per pump.  On
    device loss every in-flight slot is evicted, its cache zeroed and its
    partial output discarded, and the requests go back to the control
    plane for replay (greedy decode is deterministic, so the replayed
    tokens equal a fault-free run's).  ``memory`` (1, S_src, D): the
    encoder's output an encoder-decoder's every request decodes over."""

    kind = "lm"
    max_wait_s = 0.0                        # LM decodes continuously

    def __init__(self, name: str, cfg, params, *, slots: int = 4,
                 max_len: int = 128, memory=None, device="cuda"):
        self.name = name
        self.cb = ContinuousBatcher(cfg, params, slots=slots,
                                    max_len=max_len, memory=memory,
                                    device=device)
        self._wrapped: dict[int, ServeRequest] = {}
        self._consumed = 0                  # cb.done prefix already reported
        self.steps = 0
        self.step_cost_s: Optional[float] = None

    def warmup(self):
        """Capture the slot graphs up front (on the card)."""
        self.cb.warmup()

    def free_slots(self) -> int:
        return sum(1 for s in self.cb.slots if s.req is None)

    def active(self) -> bool:
        return bool(self.cb.queue) or any(s.req for s in self.cb.slots)

    def feed(self, sreq: ServeRequest):
        self._wrapped[sreq.rid] = sreq
        self.cb.submit(Request(rid=sreq.rid,
                               prompt=np.asarray(sreq.payload, np.int32),
                               max_new=sreq.max_new))

    def estimate_s(self, ahead: list, req: ServeRequest) -> Optional[float]:
        """Admission estimate: backlog tokens spread over the slots, plus
        this request's own prefill + decode, at the EWMA step cost."""
        if self.step_cost_s is None:
            return None
        backlog = sum(len(r.payload) + r.max_new for r in ahead)
        own = len(req.payload) + req.max_new
        return (backlog / max(1, self.cb.n) + own) * self.step_cost_s

    def step(self) -> list[ServeRequest]:
        """One decode step; returns the requests that finished on it."""
        t0 = time.perf_counter()
        self.cb.step()
        dt = time.perf_counter() - t0
        self.steps += 1
        self.step_cost_s = (dt if self.step_cost_s is None
                            else 0.8 * self.step_cost_s + 0.2 * dt)
        finished = []
        for r in self.cb.done[self._consumed:]:
            sreq = self._wrapped.pop(r.rid)
            sreq.out = np.asarray(r.out, np.int32)
            sreq.t_done = r.t_done
            finished.append(sreq)
        self._consumed = len(self.cb.done)
        return finished

    def evict_live(self) -> list[ServeRequest]:
        """Device loss mid-step: evict every in-flight slot and queued
        request, zero the slot caches in place (a slot's decode graph
        holds those buffers) and hand the ``ServeRequest``s back for
        re-queue + replay."""
        live = []
        for si, s in enumerate(self.cb.slots):
            if s.req is not None:
                live.append(self._wrapped.pop(s.req.rid))
                s.req, s.pos, s.prompt_left = None, 0, 0
                self.cb.reset_slot(si)
        while self.cb.queue:
            live.append(self._wrapped.pop(self.cb.queue.popleft().rid))
        return live


class ControlPlane:
    """Admission + scheduling + fault replay over registered backends.

    ``injector`` is a ``runtime.fault.FailureInjector`` keyed by *launch
    sequence number* (every image bucket launch and every LM decode step
    increments it): ``FailureInjector((3,))`` kills the third launch
    mid-batch.
    """

    def __init__(self, *, starvation_ms: float = 50.0, injector=None,
                 admission: bool = True, straggler_k: float = 3.0,
                 straggler_warmup: int = 3,
                 on_fault: Optional[Callable] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.backends: dict[str, object] = {}
        self.queues: dict[str, dict[str, deque]] = {}
        self.starvation_s = starvation_ms / 1e3
        # ONE clock for every scheduling timestamp (arrivals, admission,
        # shedding, max-wait expiry), handed down to every image backend's
        # batcher; compute-cost durations (_observe) stay on
        # time.perf_counter: they measure the device
        self.clock = clock
        self.injector = injector
        self.admission = admission
        self.on_fault = on_fault
        self.done: list[ServeRequest] = []
        self.rejected: list[ServeRequest] = []
        self.shed: list[ServeRequest] = []
        self.submitted = 0
        self._submitted_by_class = {c: 0 for c in PRIORITIES}
        self.launch_seq = 0
        self.fault_events: list[dict] = []
        self.degraded: Optional[dict] = None
        self._served_rids: set = set()      # zero-duplicate guard
        self.monitors: dict[tuple, StragglerMonitor] = {}
        self._straggler_kw = dict(k=straggler_k, warmup=straggler_warmup)
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- model registration (model load: plans pre-built by the caller) ------
    def register_image_model(self, name: str, serve_fn: Callable,
                             proto: np.ndarray, *, warmup: bool = False,
                             **kw) -> ImageBackend:
        kw.setdefault("clock", self.clock)   # one clock, both layers
        be = ImageBackend(name, serve_fn, proto, **kw)
        self._register(name, be)
        if warmup:
            be.warmup()
        return be

    def register_lm_model(self, name: str, cfg, params,
                          **kw) -> LMBackend:
        be = LMBackend(name, cfg, params, **kw)
        self._register(name, be)
        return be

    def _register(self, name, be):
        if name in self.backends:
            raise ValueError(f"model {name!r} already registered")
        self.backends[name] = be
        self.queues[name] = {c: deque() for c in PRIORITIES}

    def warmup(self):
        """Build every backend's executables up front: each image bucket
        (on the card: its graph, and its measured cost) and, on the card,
        each LM slot's decode graph."""
        for be in self.backends.values():
            be.warmup()

    # -- admission ------------------------------------------------------------
    def submit(self, req: ServeRequest) -> bool:
        """Admit or reject (``False``) a request.  Rejection happens only
        when the measured-cost estimate for the backlog ahead of the
        request already exceeds its deadline."""
        if req.model not in self.backends:
            raise ValueError(f"unknown model {req.model!r} "
                             f"(registered: {sorted(self.backends)})")
        self.submitted += 1
        self._submitted_by_class[req.priority] += 1
        if req.t_arrival is None:
            req.t_arrival = self.clock()
        if self._t_first is None:
            self._t_first = self.clock()
        ddl = req.deadline
        if ddl is not None and self.admission:
            ahead = self._ahead_of(req)
            est = self.backends[req.model].estimate_s(ahead, req)
            if est is not None and self.clock() + est > ddl:
                req.status = "rejected"
                req.reason = (f"admission: backlog estimate {est * 1e3:.2f} "
                              f"ms blows slo {req.slo_ms:.2f} ms")
                self.rejected.append(req)
                return False
        self.queues[req.model][req.priority].append(req)
        return True

    def _ahead_of(self, req: ServeRequest) -> list:
        """Queued requests that will be scheduled before ``req``:
        same-class backlog, plus the interactive queue for a batch
        request."""
        q = self.queues[req.model]
        ahead = list(q[req.priority])
        if req.priority == "batch":
            ahead += list(q["interactive"])
        return ahead

    # -- scheduling -----------------------------------------------------------
    def _pick_class(self, q: dict, now: float) -> str:
        """Interactive first; a batch head past the starvation bound (or an
        empty interactive queue) flips the choice."""
        inter, batch = q["interactive"], q["batch"]
        if batch and (not inter
                      or now - batch[0].t_arrival >= self.starvation_s):
            return "batch"
        return "interactive" if inter else "batch"

    def _launch_due(self, name: str, now: float, drain: bool) -> bool:
        be, q = self.backends[name], self.queues[name]
        n = len(q["interactive"]) + len(q["batch"])
        if n == 0:
            return False
        if drain or n >= be.largest_bucket:
            return True
        heads = [c[0] for c in q.values() if c]
        oldest = min(h.t_arrival for h in heads)
        if now - oldest >= be.max_wait_s:
            return True
        # deadline urgency: coalescing any longer would blow the head SLO
        ddls = [h.deadline for h in heads if h.deadline is not None]
        return bool(ddls) and min(ddls) - now <= be.max_wait_s

    def pump(self, *, drain: bool = False) -> list[ServeRequest]:
        """One scheduling round: advance every LM backend a step, launch at
        most one image bucket; returns the requests completed."""
        now = self.clock()
        finished = self._pump_lm(now)
        due = [n for n, b in self.backends.items()
               if isinstance(b, ImageBackend) and self._launch_due(n, now,
                                                                   drain)]
        if due:
            # EDF across models: earliest head-of-line deadline wins
            def urgency(name):
                heads = [c[0] for c in self.queues[name].values() if c]
                ddl = min((h.deadline for h in heads
                           if h.deadline is not None), default=float("inf"))
                return (ddl, min(h.t_arrival for h in heads))
            name = min(due, key=urgency)
            finished += self._launch_image(name, now)
        return finished

    def _take(self, name: str, cls: str, want: int,
              now: float) -> list[ServeRequest]:
        """Pop up to ``want`` launchable requests from one class queue,
        shedding the expired."""
        out, q = [], self.queues[name][cls]
        while q and len(out) < want:
            r = q.popleft()
            ddl = r.deadline
            if ddl is not None and now > ddl:
                r.status = "shed"
                r.reason = f"shed: deadline passed {(now - ddl) * 1e3:.2f} ms ago"
                self.shed.append(r)
            else:
                out.append(r)
        return out

    def _launch_image(self, name: str, now: float) -> list[ServeRequest]:
        be, q = self.backends[name], self.queues[name]
        cls = self._pick_class(q, now)
        n = len(q["interactive"]) + len(q["batch"])
        size = be.next_launch_size(n)
        reqs = self._take(name, cls, size, now)
        other = "batch" if cls == "interactive" else "interactive"
        reqs += self._take(name, other, size - len(reqs), now)  # backfill
        if not reqs:
            return []
        return self._execute(be, reqs, size)

    def _pump_lm(self, now: float) -> list[ServeRequest]:
        finished = []
        for name, be in self.backends.items():
            if not isinstance(be, LMBackend):
                continue
            q = self.queues[name]
            while be.free_slots() and (q["interactive"] or q["batch"]):
                for r in self._take(name, self._pick_class(q, now), 1, now):
                    be.feed(r)
            if not be.active():
                continue
            self.launch_seq += 1
            try:
                if self.injector is not None:
                    self.injector.check(self.launch_seq)
                t0 = time.perf_counter()
                done = be.step()
                self._observe(be.name, "step", time.perf_counter() - t0)
            except NodeFailure as e:
                self._on_failure(be, be.evict_live(), e)
                continue
            for r in done:
                self._commit(r)
            finished += done
        return finished

    # -- launch + replay ------------------------------------------------------
    def _execute(self, be: ImageBackend, reqs: list[ServeRequest],
                 bucket: int) -> list[ServeRequest]:
        self.launch_seq += 1
        t0 = time.perf_counter()
        try:
            if self.injector is not None:
                self.injector.check(self.launch_seq)   # device lost mid-batch
            outs = be.launch([r.payload for r in reqs], bucket)
        except NodeFailure as e:
            self._on_failure(be, reqs, e)
            return []
        self._observe(be.name, bucket, time.perf_counter() - t0)
        now = self.clock()
        for r, out in zip(reqs, outs):
            r.out = out
            r.t_done = now
            self._commit(r)
        return reqs

    def _commit(self, r: ServeRequest):
        if r.rid in self._served_rids:
            raise AssertionError(f"request {r.rid} answered twice")
        self._served_rids.add(r.rid)
        r.status = "served"
        self.done.append(r)
        self._t_last = self.clock()

    def _on_failure(self, be, live: list[ServeRequest], err: Exception):
        """Discard the dead launch, re-queue its live requests at the front
        of their class queues in arrival order, and replay on the next
        pump; then call the ``on_fault`` hook."""
        self.fault_events.append({
            "launch": self.launch_seq, "model": be.name,
            "live": len(live), "error": str(err)})
        for r in sorted(live, key=lambda r: (r.t_arrival, r.rid),
                        reverse=True):
            r.replays += 1
            r.status = "queued"
            r.out = None
            r.t_done = None
            self.queues[be.name][r.priority].appendleft(r)
        if self.on_fault is not None:
            self.on_fault(self, err)

    def degrade(self, devices_left: int, *, model_parallel: int = 1,
                pod: int = 0, serve_fns: Optional[dict] = None,
                spatial_tiles: Optional[tuple] = None):
        """Degraded serving after replica loss: shrink the mesh to the
        surviving ranks and rebind every image backend to it.
        ``serve_fns`` optionally maps model name -> a rebuilt closure
        (e.g. over configs re-planned for the new tiling); without it the
        existing closures serve on the shrunk mesh.

        Data-parallel (default): ``runtime.elastic.shrink_mesh``, the
        model-parallel extent kept, whole data-parallel replicas dropped
        (``pod``: a (pod, data, model) mesh of that many pods); each rank
        serves its rows of every batch the 'data' extent divides
        (``DistContext.split_batch``).

        Plane-parallel (``spatial_tiles=(D_h, D_w)``): the survivors form a
        spatial mesh (``launch.mesh.make_spatial_mesh``, the leftover
        extent on 'data') bound as the active spatial mesh, so plans built
        for that tiling carry matching ``dev_tiles`` verdicts; the
        ``serve_fns`` should close over configs whose ``spatial`` is
        ``spatial_tiles``.  Returns the new mesh."""
        from repro_torch.sharding import DistContext
        from repro_torch.launch.mesh import mesh_shape
        if spatial_tiles is not None:
            from repro_torch.core import spatial as spatialmod
            from repro_torch.launch.mesh import make_spatial_mesh
            sp_h, sp_w = (int(v) for v in spatial_tiles)
            if devices_left % (sp_h * sp_w):
                raise ValueError(
                    f"degrade: spatial_tiles {sp_h}x{sp_w} does not divide "
                    f"{devices_left} surviving devices")
            mesh = make_spatial_mesh(
                sp_h, sp_w, data=devices_left // (sp_h * sp_w))
            spatialmod.set_spatial_mesh(mesh)
        else:
            from repro_torch.runtime.elastic import shrink_mesh
            mesh = shrink_mesh(devices_left, model_parallel, pod)
        dist = DistContext(mesh=mesh)
        for name, be in self.backends.items():
            if isinstance(be, ImageBackend):
                be.rebind(dist, (serve_fns or {}).get(name))
        self.degraded = {"devices_left": devices_left,
                         "mesh_shape": mesh_shape(mesh),
                         "at_launch": self.launch_seq}
        if spatial_tiles is not None:
            self.degraded["spatial_tiles"] = (sp_h, sp_w)
        return mesh

    def _observe(self, model: str, bucket, dt: float):
        key = (model, bucket)
        if key not in self.monitors:
            self.monitors[key] = StragglerMonitor(**self._straggler_kw)
        self.monitors[key].record(self.launch_seq, dt)

    # -- drivers --------------------------------------------------------------
    def run(self, reqs: Optional[Sequence[ServeRequest]] = None,
            *, max_pumps: int = 100_000) -> list[ServeRequest]:
        """Submit ``reqs`` and pump to empty (drain mode)."""
        for r in reqs or ():
            self.submit(r)
        pumps = 0
        while self.pending() and pumps < max_pumps:
            self.pump(drain=True)
            pumps += 1
        return self.done

    def pending(self) -> int:
        n = sum(len(c) for q in self.queues.values() for c in q.values())
        n += sum(1 for be in self.backends.values()
                 if isinstance(be, LMBackend) and be.active())
        return n

    def results(self) -> dict[int, np.ndarray]:
        return {r.rid: r.out for r in self.done}

    # -- reporting ------------------------------------------------------------
    def stats(self) -> dict:
        window = None
        if self._t_first is not None and self._t_last is not None:
            window = self._t_last - self._t_first
        per_class = {}
        for cls in PRIORITIES:
            rs = [r for r in self.done if r.priority == cls]
            st = latency_stats([r.latency_s for r in rs], window_s=window)
            good = sum(1 for r in rs if r.in_slo is not False)
            n_sub = self._submitted_by_class[cls]
            st["slo_miss"] = sum(1 for r in rs if r.in_slo is False)
            st["rejected"] = sum(1 for r in self.rejected
                                 if r.priority == cls)
            st["shed"] = sum(1 for r in self.shed if r.priority == cls)
            st["goodput_rps"] = (good / window if window else 0.0)
            st["goodput_under_slo"] = (good / n_sub) if n_sub else 1.0
            per_class[cls] = st
        per_model = {}
        for name, be in self.backends.items():
            served = sum(1 for r in self.done if r.model == name)
            m = {"kind": be.kind, "served": served}
            if isinstance(be, ImageBackend):
                launches = be.batcher.launches
                m["launches"] = len(launches)
                m["pad_fraction"] = (
                    1.0 - (sum(live for _, live in launches)
                           / max(1, sum(b for b, _ in launches))))
            else:
                m["steps"] = be.steps
                m["step_cost_ms"] = (None if be.step_cost_s is None
                                     else be.step_cost_s * 1e3)
            per_model[name] = m
        slow = sorted(f"{m}/b{b}" for (m, b), mon in self.monitors.items()
                      if mon.events)
        good = sum(1 for r in self.done if r.in_slo is not False)
        return {
            "submitted": self.submitted,
            "served": len(self.done),
            "rejected": len(self.rejected),
            "shed": len(self.shed),
            "queued": self.pending(),
            "replayed_requests": sum(1 for r in self.done if r.replays),
            "goodput_rps": (good / window if window else 0.0),
            "goodput_under_slo": ((good / self.submitted)
                                  if self.submitted else 1.0),
            "per_class": per_class,
            "per_model": per_model,
            "faults": {"events": len(self.fault_events),
                       "records": list(self.fault_events),
                       "degraded": self.degraded},
            "stragglers": {
                "events": sum(len(m.events) for m in self.monitors.values()),
                "slow_buckets": slow},
        }
