"""The plan: device time outside the conv kernels A-D (pads, bias, ReLU,
tanh, the dense projection) as a share of device time, serving."""
from bench.readers import other_share_pct as read  # noqa: F401
