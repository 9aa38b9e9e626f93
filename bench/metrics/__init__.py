"""Per-layer metric readers, one file a metric, named as in
``BENCHMARK.json``: ``read(ctx)`` returns the metric's value, or None where
the run holds nothing to read."""
