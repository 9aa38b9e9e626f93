"""Tiny stand-ins of the benchmark's cells for the CPU tests: the same
harness, traffic kinds and checks at sizes a test run holds."""
from __future__ import annotations

from bench.harness import BENCH, Cell, load_json

GAN_LAYERS = [[4, 32, 16, 5, 2], [8, 16, 3, 5, 2]]


def tiny_cell(name: str, traffic: str | None = None) -> Cell:
    """The cell ``name`` at a tiny size; ``traffic`` runs another mix of
    ``bench/traffic/`` through it (the open loop has no cell yet)."""
    c = Cell(name)
    if traffic is not None:
        c.traffic = load_json(BENCH / "traffic" / f"{traffic}.json")
    c.config = dict(c.config, layers=GAN_LAYERS, z_dim=8)
    tr = c.traffic
    if tr["loop"] == "closed":
        c.traffic = dict(tr, payload_pool=16)
    elif tr["loop"] == "open":
        c.traffic = dict(tr, image_rate_per_s=400, payload_pool=16)
    else:
        c.traffic = dict(tr, batch=4)
    if "sample" in c.check:
        c.check = dict(c.check, sample=16)
    return c
