"""The training step: essential FLOPs a step over its time and the f32
peak."""
from bench.readers import train_mfu_pct as read  # noqa: F401
