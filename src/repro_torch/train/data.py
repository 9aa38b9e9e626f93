"""Deterministic, restartable data pipelines (numpy only).

Counterpart of ``repro.train.data``: synthetic-token (and stub-embedding)
pipelines, a memory-mapped token file, GAN batches and a host-side
prefetch thread.  A batch is keyed by ``(seed, step)``, so any step's
batch is reproducible from the step counter alone (what a restart from a
checkpoint relies on: no iterator state to persist), and the same seed
gives the JAX package's batches bit for bit.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class TokenPipeline:
    """Language-model batches: {"inputs", "targets": (B, S) int32}, plus
    the stub frontend's embeddings (B, S, D) f32 for a decoder-only
    stub, or the source frames ``src_embeds`` (B, ``src_len`` or 64, D)
    f32 for an encoder-decoder."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0,
                 src_len: int = 0):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.src_len = src_len

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.cfg.vocab_size,
                            (self.batch, self.seq + 1), dtype=np.int32)
        out = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        if self.cfg.frontend != "none" and not self.cfg.is_encoder_decoder:
            out["embeds"] = rng.standard_normal(
                (self.batch, self.seq, self.cfg.d_model),
                dtype=np.float32).astype(np.float32)
        if self.cfg.is_encoder_decoder:
            out["src_embeds"] = rng.standard_normal(
                (self.batch, self.src_len or 64, self.cfg.d_model),
                dtype=np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class GANPipeline:
    """(z, real image) pairs for GAN training; CIFAR-like 3-channel images."""

    def __init__(self, gan_cfg, batch: int, image_hw: int, seed: int = 0):
        self.cfg, self.batch, self.hw, self.seed = gan_cfg, batch, image_hw, seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        return {
            "z": rng.standard_normal((self.batch, self.cfg.z_dim),
                                     dtype=np.float32),
            "real": rng.uniform(-1, 1, (self.batch, self.hw, self.hw, 3)
                                ).astype(np.float32),
        }


class FileTokenPipeline:
    """A memory-mapped token file (a flat uint32 stream) as LM batches:
    ``(seed, step)`` picks disjoint strided windows of the file, so a
    restart by step is exact, and an epoch boundary wraps with a
    reshuffled offset."""

    def __init__(self, path: str, cfg, batch: int, seq: int, seed: int = 0):
        self.tokens = np.memmap(path, dtype=np.uint32, mode="r")
        if len(self.tokens) < (seq + 1) * batch:
            raise ValueError("token file too small for one batch")
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.windows = (len(self.tokens) - 1) // seq

    @staticmethod
    def write_token_file(path: str, tokens: np.ndarray):
        np.asarray(tokens, np.uint32).tofile(path)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step // max(
            self.windows // self.batch, 1)))
        perm = rng.permutation(self.windows)
        base = (step * self.batch) % max(self.windows - self.batch, 1)
        idx = perm[base:base + self.batch]
        if len(idx) < self.batch:
            idx = np.concatenate([idx, perm[:self.batch - len(idx)]])
        rows = np.stack([
            self.tokens[i * self.seq:i * self.seq + self.seq + 1]
            for i in idx]).astype(np.int32)
        rows = rows % self.cfg.vocab_size
        return {"inputs": rows[:, :-1], "targets": rows[:, 1:]}


class Prefetcher:
    """Host-side prefetch: a thread builds the next batches (``depth``
    ahead, from ``start_step`` on) while the device runs a step."""

    def __init__(self, pipeline, start_step: int = 0, depth: int = 2):
        self.pipeline = pipeline
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put(self.pipeline.batch_at(s), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def next(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
