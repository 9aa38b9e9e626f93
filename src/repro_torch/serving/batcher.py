"""Continuous batching for LM serving (fixed-slot scheduler).

Counterpart of ``repro.serving.batcher``, with its admission, stop and
recycle rules.  The server keeps a fixed pool of cache *slots*; requests
join whenever a slot frees, and a joining prompt is fed token by token
into its slot's cache while the other slots keep decoding.  Each slot owns
a B = 1 cache (``decode_step`` takes one cache index, and slots sit at
different positions), so a request's tokens do not depend on its
neighbours.

On a CUDA device each slot decodes through one CUDA graph
(``serving.graphs``), the counterpart of JAX's one jitted B = 1
``_step1``: ``decode_step`` captured on the slot's own cache from a static
(1, 1) token and a static 0-d position to static logits and their argmax.
A step writes each occupied slot's token and position with ``fill_``,
replays the slots' graphs in turn and reads their argmaxes back in one
copy.  An encoder-decoder's ``memory`` (1, S_src, D), one for every
request as in JAX's batcher, is a static input of every slot graph: the
graphs read it where it lies.  The graphs are captured by ``warmup``,
else at the first step (one
eager step on each slot's zeroed cache first, which the zeroing then
undoes); a capture or replay that fails raises.  On the CPU, or with
``graphs=False`` (the eager reference the card's graphs are held to and
timed against), a step is one eager ``decode_step`` per occupied slot.
Every cache kind (GQA's KV, MLA's compressed ``ckv``/``kr``, the RG-LRU
and SSD states) is written in place and the MoE decodes in static shapes
(``layers.moe.moe_decode``), so one graph a slot serves every ported
architecture.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.serving.graphs import CapturedGraph
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
    decode); a finished request's slot cache is zeroed for the next.
    ``device`` is where the caches live (``"cuda"``: one graph a slot,
    unless ``graphs=False``)."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 128,
                 memory=None, device="cuda", graphs: bool = True):
        self.cfg, self.params = cfg, params
        self.memory = memory
        self.n = slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.graphed = graphs and self.device.type == "cuda"
        self.slots = [_Slot() for _ in range(slots)]
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self.slot_caches = [tfm.init_cache(cfg, 1, max_len,
                                           device=self.device)
                            for _ in range(slots)]
        # on the card: per slot a graph, its inputs a static token and
        # position
        self.graphs: list[CapturedGraph] = []

    # -- client API ----------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in self.slots:
            if s.req is None and self.queue:
                s.req = self.queue.popleft()
                s.pos = 0
                s.prompt_left = len(s.req.prompt)

    def reset_slot(self, si: int):
        """Zero slot ``si``'s cache in place (its graph holds the
        buffers)."""
        for c in self.slot_caches[si]:
            for t in c.values():
                t.zero_()

    def _capture(self):
        """One graph per slot: an eager ``decode_step`` on the slot's
        zeroed cache (kernel and table set-up), then the capture of the
        same step from the static token and position, then the cache
        zeroed again (the eager step wrote its row 0)."""
        for si in range(self.n):
            tok = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
            pos = torch.zeros((), dtype=torch.int64, device=self.device)

            def fn(si=si, tok=tok, pos=pos):
                logits, _ = tfm.decode_step(self.params, self.slot_caches[si],
                                            tok, pos, self.cfg, self.memory)
                return logits, torch.argmax(logits[0, -1])
            with torch.no_grad():
                fn()
            torch.cuda.synchronize(self.device)
            self.graphs.append(CapturedGraph(fn, (tok, pos, self.memory),
                                             grad_mode=torch.no_grad))
            self.reset_slot(si)

    def warmup(self):
        """Capture the slot graphs now (on the card; nothing to do on the
        CPU or with ``graphs=False``), so no request's latency holds a
        capture."""
        if self.graphed and not self.graphs:
            self._capture()

    def _next_tokens(self, live) -> list[int]:
        """One decode step of each slot in ``live`` [(slot index, input
        token)]: the greedy next tokens, in order."""
        if self.graphed:
            self.warmup()
            for si, tok in live:
                tok_in, pos_in, _ = self.graphs[si].inputs
                tok_in.fill_(tok)
                pos_in.fill_(self.slots[si].pos)
                self.graphs[si].replay()
            return torch.stack([self.graphs[si].out[1]
                                for si, _ in live]).tolist()
        nxt = []
        for si, tok in live:
            with torch.no_grad():
                logits, self.slot_caches[si] = tfm.decode_step(
                    self.params, self.slot_caches[si],
                    torch.tensor([[tok]], device=self.device),
                    self.slots[si].pos, self.cfg, self.memory)
            nxt.append(int(torch.argmax(logits[0, -1])))
        return nxt

    def step(self):
        """Advance every occupied slot by one token (prefill or decode)."""
        self._admit()
        live = []
        for si, s in enumerate(self.slots):
            if s.req is None:
                continue
            r = s.req
            if s.prompt_left > 0:
                tok = int(r.prompt[len(r.prompt) - s.prompt_left])
            else:
                tok = r.out[-1]
            live.append((si, tok))
        if not live:
            return
        for (si, _), nxt in zip(live, self._next_tokens(live)):
            s = self.slots[si]
            r = s.req
            s.pos += 1
            if s.prompt_left > 0:
                s.prompt_left -= 1
                if s.prompt_left == 0:      # prompt consumed: first token
                    r.out.append(nxt)
                    r.t_first = time.perf_counter()
            else:
                r.out.append(nxt)
            if len(r.out) >= r.max_new or s.pos >= self.max_len - 1:
                r.t_done = time.perf_counter()
                self.done.append(r)
                s.req = None
                self.reset_slot(si)          # recycle: zeros

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
