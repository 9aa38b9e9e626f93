"""Continuous batching for LM serving (fixed-slot scheduler).

Counterpart of ``repro.serving.batcher``, with its admission, stop and
recycle rules.  The server keeps a fixed pool of cache *slots*; requests
join whenever a slot frees, and a joining prompt is fed token by token
into its slot's cache while the other slots keep decoding.  Each slot owns
a B = 1 cache (``decode_step`` takes one cache index, and slots sit at
different positions), so a request's tokens do not depend on its
neighbours.  The port runs eagerly: a step is one ``decode_step`` per
occupied slot.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.serving.metrics import latency_stats


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                      # (P,) int
    max_new: int
    t_arrival: float = dataclasses.field(default_factory=time.perf_counter)
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    out: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                            # next cache index to write
    prompt_left: int = 0


class ContinuousBatcher:
    """Fixed-slot continuous batching over ``decode_step``.

    Each step advances every occupied slot by one token (prefill or
    decode); a finished request's slot cache is zeroed for the next."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 128,
                 device="cuda"):
        self.cfg, self.params = cfg, params
        self.n = slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.slots = [_Slot() for _ in range(slots)]
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self.slot_caches = [tfm.init_cache(cfg, 1, max_len,
                                           device=self.device)
                            for _ in range(slots)]

    # -- client API ----------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in self.slots:
            if s.req is None and self.queue:
                s.req = self.queue.popleft()
                s.pos = 0
                s.prompt_left = len(s.req.prompt)

    def step(self):
        """Advance every occupied slot by one token (prefill or decode)."""
        self._admit()
        for si, s in enumerate(self.slots):
            if s.req is None:
                continue
            r = s.req
            if s.prompt_left > 0:
                tok = int(r.prompt[len(r.prompt) - s.prompt_left])
            else:
                tok = r.out[-1]
            with torch.no_grad():
                logits, self.slot_caches[si] = tfm.decode_step(
                    self.params, self.slot_caches[si],
                    torch.tensor([[tok]], device=self.device), s.pos,
                    self.cfg)
            s.pos += 1
            if s.prompt_left > 0:
                s.prompt_left -= 1
                if s.prompt_left == 0:      # prompt consumed: first token
                    r.out.append(int(torch.argmax(logits[0, -1])))
                    r.t_first = time.perf_counter()
            else:
                r.out.append(int(torch.argmax(logits[0, -1])))
            if len(r.out) >= r.max_new or s.pos >= self.max_len - 1:
                r.t_done = time.perf_counter()
                self.done.append(r)
                s.req = None
                for c in self.slot_caches[si]:   # recycle: zeros
                    for t in c.values():
                        t.zero_()

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(s.req for s in self.slots)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return steps

    def stats(self):
        """Serving report via the shared ``serving.metrics`` implementation,
        plus the second-unit keys of JAX's batcher."""
        lat = [r.t_done - r.t_arrival for r in self.done if r.t_done]
        ttft = [r.t_first - r.t_arrival for r in self.done if r.t_first]
        st = latency_stats(lat)
        ttft_st = latency_stats(ttft)
        st["completed"] = len(self.done)
        st["p50_latency_s"] = st["p50_ms"] / 1e3
        st["p50_ttft_s"] = ttft_st["p50_ms"] / 1e3
        st["ttft_p95_ms"] = ttft_st["p95_ms"]
        return st
