"""The plan's backward and the SGD update: device time outside the conv
kernels A-D as a share of device time in the training step."""
from bench.readers import other_share_pct as read  # noqa: F401
