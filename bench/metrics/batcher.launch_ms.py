"""Image batcher: the median host time of one ``execute`` (stack the
rows, copy them in, replay the bucket's graph, copy the live rows out)."""
from bench.readers import median


def read(ctx):
    return median(ctx.spans.durations_ms("batcher.execute"))
