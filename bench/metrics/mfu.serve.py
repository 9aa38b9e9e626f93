"""The served model: essential FLOPs times images a second over the f32
peak."""
from bench.readers import serve_mfu_pct as read  # noqa: F401
