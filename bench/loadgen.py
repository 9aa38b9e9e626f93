"""Load generators over the program's control plane.

A user request is one or more image requests (``ServeRequest``), all
stamped with the user request's due time as their arrival; it is done when
its last image returns.  Latency runs from the due time, never from the
moment the host got round to submitting: a launch that holds the host
delays the submissions behind it, and that wait is the users' (no
coordinated omission).

- ``run_closed``: N clients, each with one user request outstanding; a
  client issues its next request when the previous one returns, due then.
- ``run_open``: user requests due on a fixed schedule from the window's
  start, whatever the system does (``arrival_offsets``), then the window's
  requests are waited for.

Percentiles are numpy's linear interpolation (written out, so that an
infinity stays one), as the program's
``serving/metrics.latency_stats`` takes them, but over every user request
due in the window: one that failed or never returned counts as missing
(an infinite latency), and in ``failed``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np


def arrival_offsets(n: int, seconds: float, rng) -> np.ndarray:
    """Due times (s from the window's start) of ``n`` user requests over
    ``seconds``: exponential gaps at their ``n`` stratified quantiles
    (``-log(1 - (i + 1/2) / n)``), scaled to fill the window and put in an
    order drawn from ``rng``.  Every seed gets the same gaps, so the same
    amount of work and the same burstiness, in another order."""
    if n <= 0:
        return np.zeros(0)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due * (seconds / gaps.sum())


def percentile_ms(latencies_s, q: float) -> float:
    """The ``q``-th percentile of ``latencies_s`` in ms (inf counts as a
    latency above every other)."""
    lat = np.sort(np.asarray(latencies_s, np.float64))
    if lat.size == 0:
        return math.inf
    h = (lat.size - 1) * q / 100.0
    lo, hi = math.floor(h), math.ceil(h)
    if math.isinf(lat[hi]):
        return math.inf
    return float((lat[lo] + (h - lo) * (lat[hi] - lat[lo])) * 1e3)


@dataclasses.dataclass(slots=True)
class UserRequest:
    uid: int
    due: float
    parts: int                          # image requests it is made of
    client: int = -1
    left: int = 0
    t_issued: Optional[float] = None    # when the host submitted it
    t_done: Optional[float] = None
    t_launch: Optional[float] = None    # start of its first image's launch

    @property
    def latency_s(self) -> float:
        return math.inf if self.t_done is None else self.t_done - self.due


class Driver:
    """Issues user requests into a control plane and pumps it.

    ``payload(i)`` gives the i-th image request's payload and its index in
    the payload pool; ``on_image(index, served request)`` sees every image
    as it returns (to keep a sample and drop the rest)."""

    def __init__(self, cp, model: str, parts: int,
                 payload: Callable[[int], tuple], clock: Callable[[], float],
                 on_image: Callable = lambda index, req: None,
                 launch_start: Callable[[], Optional[float]] = lambda: None):
        from repro_torch.serving.control_plane import ServeRequest
        self._request = ServeRequest
        self.cp, self.model, self.parts = cp, model, parts
        self.payload, self.clock, self.on_image = payload, clock, on_image
        self.launch_start = launch_start
        self.tick: Callable[[], None] = lambda: None   # called every round
        self.users: list[UserRequest] = []
        self._owner: dict[int, tuple[UserRequest, int]] = {}
        self._rid = 0
        self.images_done = 0

    def issue(self, due: float, client: int = -1) -> UserRequest:
        parts, rid = self.parts, self._rid
        u = UserRequest(len(self.users), due, parts, client, parts)
        self.users.append(u)
        owner, submit, request = self._owner, self.cp.submit, self._request
        for rid in range(rid, rid + parts):
            x, index = self.payload(rid)
            owner[rid] = (u, index)
            submit(request(rid, self.model, x, t_arrival=due))
        self._rid = rid + 1
        u.t_issued = self.clock()
        return u

    def pump(self, drain: bool = False) -> list[UserRequest]:
        """One scheduling round; returns the user requests it completed."""
        self.tick()
        finished = self.cp.pump(drain=drain)
        return self.give_back(finished) if finished else []

    def give_back(self, finished) -> list[UserRequest]:
        """Hand a round's finished images to their users; returns the user
        requests completed."""
        done, owner, on_image = [], self._owner, self.on_image
        start = self.launch_start()
        for r in finished:
            u, index = owner.pop(r.rid)
            if u.t_launch is None:
                u.t_launch = start
            on_image(index, r)
            r.out = None                # the image is not kept past here
            u.left -= 1
            if u.left == 0:
                u.t_done = r.t_done
                done.append(u)
        self.images_done += len(finished)
        return done

    def pending(self) -> int:
        return self.cp.pending()

    def drain(self, deadline: float):
        """Pump until nothing is queued or ``deadline`` passes."""
        while self.pending() and self.clock() < deadline:
            self.pump(drain=True)


def run_closed(drv: Driver, clients: int, seconds: float) -> dict:
    """``clients`` closed-loop clients for ``seconds``: the window runs from
    the first requests to the end of the last round started inside it, and
    counts every image returned in it."""
    t0 = drv.clock()
    for c in range(clients):
        drv.issue(t0, c)
    t_end = t0 + seconds
    while drv.clock() < t_end:
        for u in drv.pump():
            drv.issue(drv.clock(), u.client)
    t1 = drv.clock()
    return {"t0": t0, "t1": t1, "images": drv.images_done}


def run_open(drv: Driver, offsets: np.ndarray, seconds: float,
             wait_s: float = 60.0, every_s: float = 0.01) -> dict:
    """User requests due at ``offsets`` from the window's start; after the
    last is issued, its stragglers are waited for, ``wait_s`` at most past
    the window.  ``backlog`` is the mean number of image requests queued
    in each quarter of the window (read every ``every_s``): below the knee
    it stays level, past it it grows from quarter to quarter."""
    t0 = drv.clock()
    due = t0 + np.asarray(offsets, np.float64)
    i, n = 0, len(due)
    queued = [[] for _ in range(4)]
    t_read = t0
    while True:
        now = drv.clock()
        while i < n and due[i] <= now:
            drv.issue(float(due[i]))
            i += 1
        if now >= t_read and now < t0 + seconds:
            queued[int(4 * (now - t0) / seconds)].append(drv.pending())
            t_read = now + every_s
        if i == n and not drv.pending():
            break
        if now > t0 + seconds + wait_s:
            break
        drv.pump()
    backlog = [float(np.mean(q)) if q else None for q in queued]
    return {"t0": t0, "t1": drv.clock(), "backlog": backlog,
            "images": drv.images_done}


class Reservoir:
    """A uniform sample of ``k`` items from a stream, drawn from ``rng``
    (Li's algorithm L: the gaps between kept items are drawn, so an item
    that is not kept costs one comparison); ``offer(make, *args)`` calls
    ``make(*args)`` only for an item it keeps."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []
        self._w = 1.0
        self._next = k

    def offer(self, make: Callable, *args):
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(make(*args))
            if i == self.k - 1:
                self._draw(i)
        elif i == self._next:
            self.items[int(self.rng.integers(self.k))] = make(*args)
            self._draw(i)

    def _draw(self, i: int):
        u1, u2 = self.rng.random(2)
        self._w *= math.exp(math.log(u1) / self.k)
        self._next = i + 1 + int(math.log(u2) / math.log1p(-self._w))
