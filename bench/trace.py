"""Spans and the device trace of a ``--trace 1`` run.

Spans are the harness's own, taken around its calls into the program's
layers (the control plane's ``submit`` and ``pump``, the batcher's
``execute``, a training step and its batch): (start, end) on the host's
``perf_counter``, kept in memory.

The device trace is ``torch.profiler`` with CUDA activity only (CUPTI) over
a part of the window (``Tracer``).  Recording the host's operators too
slowed the eager training step by 84% on the card, CUDA activity alone by
13%.  A marker kernel (``torch.cuda._sleep``) launched right after the
profiler starts and another right before it stops bound the traced window
on the device's clock and tie it to the host's: the first marker's device
start less its host launch time is the offset that puts the spans on the
trace.  ``DeviceTrace`` reduces the trace: the union of kernel intervals
(busy), each of the program's kernels A-D by its symbol, the time of each
symbol corrected for events CUPTI dropped, the top device operations and
the idle gaps by span.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Optional

# the program's conv kernels by symbol, in match order: a symbol that holds
# another comes first ("deconv_kernel" holds "conv_kernel")
CONV_KERNELS = (("deconv_tiled_kernel", "D"), ("conv_tiled_kernel", "C"),
                ("deconv_thin_kernel", "A"), ("deconv_split_reduce", "A"),
                ("deconv_kernel", "A"), ("conv_split_reduce", "B"),
                ("conv_kernel", "B"))
MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


def kernel_part(name: str) -> str:
    """Which of the program's conv kernels (A-D) a device kernel is, by its
    symbol, else "other"."""
    return next((part for sym, part in CONV_KERNELS if sym in name), "other")


class Spans:
    """Named host intervals; ``wrap`` times an object's method in place."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.records: dict[str, list[tuple[float, float]]] = \
            collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = self.clock()
        try:
            yield
        finally:
            self.records[name].append((t0, self.clock()))

    def wrap(self, obj, attr: str, name: str):
        fn, clock, rec = getattr(obj, attr), self.clock, self.records[name]

        def timed(*a, **kw):
            t0 = clock()
            try:
                return fn(*a, **kw)
            finally:
                rec.append((t0, clock()))
        setattr(obj, attr, timed)

    def last_start(self, name: str) -> Optional[float]:
        rec = self.records.get(name)
        return rec[-1][0] if rec else None

    def durations_ms(self, name: str) -> list[float]:
        return [(b - a) * 1e3 for a, b in self.records.get(name, ())]

    def between(self, t0: float, t1: float) -> list[tuple[str, float, float]]:
        return [(name, a, b) for name, rec in self.records.items()
                for a, b in rec if b >= t0 and a <= t1]


def _profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def _marker() -> int:
    """Launch a marker kernel; returns its host launch time in ns."""
    import torch
    t = time.perf_counter_ns()
    torch.cuda._sleep(1000)
    return t


class Tracer:
    """Runs ``torch.profiler`` for ``length`` seconds from ``delay`` after
    ``arm()`` (the window's start), switched by ``tick()`` between rounds
    of the loop, and counts ``counter()`` (launches or steps so far) at
    both ends.  Made in set-up, where it runs one profiler session on a
    marker: CUPTI's first start takes 7-8 s on the card, and later starts
    take milliseconds; that marker also gives the offset from the host's
    clock to the device's, for a trace that lost its own markers
    (``DeviceTrace.from_events``).  One without a kernel in it (CUPTI now
    and then loses events) is taken again, ``tries`` times at most while
    the window lasts.  ``log`` holds what
    each try read: events, markers, kernels.
    ``first`` is (host time, count) just before the first start: the part
    of the window before it is the untraced part."""

    def __init__(self, spans: Spans, delay: float, length: float,
                 counter: Callable[[], object], sync: Callable[[], None],
                 tries: int = 5):
        self.spans, self.delay, self.length = spans, delay, length
        self.start_at = float("inf")
        self.counter, self.sync, self.tries = counter, sync, tries
        self.first = None
        self.prof = self.trace = self.offset = None
        self.count_at, self.log = [], []
        self.done = False
        self.on_card = _on_card()
        if self.on_card:
            with _profile() as prof:
                host = _marker()
                sync()
            starts = [s for name, s, _ in _device_events(prof)
                      if MARKER in name]
            self.offset = starts[0] - host if starts else None

    def arm(self):
        self.start_at = self.spans.clock() + self.delay

    def tick(self):
        if self.done:
            return
        now = self.spans.clock()
        if not self.count_at and now >= self.start_at:
            self._begin(now)
        elif self.count_at and now >= self._t0 + self.length:
            self._end(retry=True)

    def _begin(self, now: float):
        self.sync()
        self.count_at = [self.counter()]
        if self.first is None:
            self.first = (now, self.count_at[0])
        self.tries -= 1
        self._t0 = self.spans.clock()
        if self.on_card:
            self.prof = _profile()
            self.prof.start()
            self.sync()
            self._host0 = _marker()

    def _end(self, retry: bool):
        self.sync()
        self.count_at.append(self.counter())
        t1 = self.spans.clock()
        if self.prof is not None:
            host1 = _marker()
            self.sync()
            self.prof.stop()
            self.trace = DeviceTrace.from_profile(
                self.prof, (self._host0, host1),
                self.spans.between(self._t0, t1), self.offset, self.log)
            self.prof = None
        if self.trace is None and self.on_card and retry and self.tries:
            self.count_at = []
            self.start_at = t1
            return
        self.done = True

    def stop(self):
        """The window has closed: end a trace still running."""
        if self.count_at and not self.done:
            self._end(retry=False)
        self.done = True


def _on_card() -> bool:
    import torch
    return torch.cuda.is_available()


def _device_events(prof):
    """(name, start_ns, end_ns) of every device event in the trace."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start = e.start_ns()
            end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
        else:
            start = e.start_us() * 1000
            end = start + e.duration_us() * 1000
        yield e.name(), start, end


class DeviceTrace:
    """A trace reduced to what the per-layer metrics read: the traced
    window, the device kernels in it, the harness spans in it."""

    def __init__(self, window: tuple[int, int], kernels: list, spans: list):
        self.t0, self.t1 = window
        self.kernels = sorted(kernels, key=lambda k: k[1])   # (name, s, e)
        self.spans = spans                                    # (name, s, e)

    @classmethod
    def from_profile(cls, prof, host_ns: tuple[int, int], spans: list,
                     offset: Optional[int] = None,
                     log: Optional[list] = None) -> Optional["DeviceTrace"]:
        return cls.from_events(_device_events(prof), host_ns, spans, offset,
                               log)

    @classmethod
    def from_events(cls, events, host_ns: tuple[int, int], spans: list,
                    offset: Optional[int] = None,
                    log: Optional[list] = None) -> Optional["DeviceTrace"]:
        """The trace between its two markers, launched at ``host_ns``;
        ``spans`` (host seconds) put on the device's clock by the first
        marker's offset.  Where CUPTI lost a marker, the window is the
        extent of the session's kernels (the window's leading and trailing
        idle, a gap each at most, is not counted) and the spans go on by
        ``offset``, the one set-up's marker measured."""
        markers, kernels, n = [], [], 0
        for name, start, end in events:
            n += 1
            if MARKER in name:
                markers.append((start, end))
            elif not name.startswith("Memcpy") and end > start:
                kernels.append((name, start, end))
        if log is not None:
            log.append({"events": n, "markers": len(markers),
                        "kernels": len(kernels)})
        if len(markers) >= 2:
            markers.sort()
            t0, t1 = markers[0][0], markers[-1][1]
            offset = t0 - host_ns[0]
        elif kernels:
            t0 = min(k[1] for k in kernels)
            t1 = max(k[2] for k in kernels)
            if offset is None:
                offset = t0 - host_ns[0]
        else:
            return None
        kernels = [k for k in kernels if k[1] >= t0 and k[2] <= t1]
        spans = [(name, int(a * 1e9) + offset, int(b * 1e9) + offset)
                 for name, a, b in spans]
        return cls((t0, t1), kernels, spans) if kernels else None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        merged = []
        for _, s, e in self.kernels:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def by_symbol(self) -> dict[str, list[float]]:
        out = collections.defaultdict(list)
        for name, s, e in self.kernels:
            out[name].append((e - s) / 1e9)
        return out

    def part_seconds(self, launches: int) -> dict[str, float]:
        """Device seconds of each of A-D and "other" over ``launches``
        forwards or steps: each symbol's mean event time times its events
        a launch (its events over ``launches``, rounded) times
        ``launches``, so an event CUPTI dropped is not time the kernel did
        not take."""
        out = collections.defaultdict(float)
        for name, times in self.by_symbol().items():
            per = round(len(times) / max(1, launches))
            n = max(len(times), per * launches)
            out[kernel_part(name)] += sum(times) / len(times) * n
        return dict(out)

    def top_ops(self, k: int = 10) -> list[list]:
        tot = collections.Counter()
        for name, times in self.by_symbol().items():
            tot[name] = sum(times)
        return [[name, s] for name, s in tot.most_common(k)]

    def host_intervals(self) -> list[tuple[int, int, str]]:
        """The traced window cut where a span opens or closes, each piece
        named by the innermost span open over it ("no span" where none
        is).  The spans are one thread's, so they nest."""
        out, t, stack = [], self.t0, []

        def upto(b):
            nonlocal t
            b = min(b, self.t1)
            if b > t:
                out.append((t, b, stack[-1][0] if stack else "no span"))
                t = b
        for name, s, e in sorted(self.spans, key=lambda x: (x[1], -x[2])):
            while stack and stack[-1][1] <= s:
                upto(stack[-1][1])
                stack.pop()
            upto(s)
            stack.append((name, e))
        while stack:
            upto(stack[-1][1])
            stack.pop()
        upto(self.t1)
        return out

    def host_seconds(self) -> dict[str, float]:
        """Seconds of the traced window in each innermost span."""
        tot = collections.Counter()
        for a, b, name in self.host_intervals():
            tot[name] += (b - a) / 1e9
        return dict(tot)

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle device time inside the window, summed by the innermost
        harness span open over each part of each gap ("no span" where
        none is), largest first."""
        gaps, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            gaps.append((t, self.t1))
        tot = collections.Counter()
        host, j = self.host_intervals(), 0
        for a, b in gaps:
            while j < len(host) and host[j][1] <= a:
                j += 1
            i = j
            while i < len(host) and host[i][0] < b:
                s, e, name = host[i]
                tot[f"idle in {name}"] += (min(b, e) - max(a, s)) / 1e9
                i += 1
        return [[name, s] for name, s in tot.most_common(k)]
