"""The device: the share of the traced window with no kernel running."""
from bench.readers import idle_pct as read  # noqa: F401
