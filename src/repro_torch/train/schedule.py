"""Learning-rate schedules (warmup, then cosine or linear decay): pure
functions of the step counter.

Counterpart of ``repro.train.schedule``, JAX's arithmetic in f32."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 2000
    total_steps: int = 100_000
    final_frac: float = 0.1          # floor as a fraction of peak
    kind: str = "cosine"             # cosine | linear | constant


def lr_at(step, cfg: ScheduleConfig) -> torch.Tensor:
    """step: an int or a 0-d int tensor -> the f32 learning rate (a 0-d
    tensor on the step's device)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.kind == "constant":
        return cfg.peak_lr * warm
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.kind == "cosine":
        decay = cfg.final_frac + (1 - cfg.final_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    else:
        decay = cfg.final_frac + (1 - cfg.final_frac) * (1 - frac)
    return cfg.peak_lr * warm * decay
