"""Deterministic, restartable data pipelines (numpy only).

Counterpart of ``repro.train.data``; only ``GANPipeline`` is ported.  A
batch is keyed by ``(seed, step)``, so any step's batch is reproducible
from the step counter alone, and the same seed gives the JAX package's
batches bit for bit.
"""
from __future__ import annotations

import numpy as np


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
