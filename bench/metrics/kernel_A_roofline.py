"""Kernel A: the roofline time of its sites over its device time."""
from bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "A")
