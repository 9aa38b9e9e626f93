"""Latency/throughput statistics shared by every serving surface.

Counterpart of ``repro.serving.metrics``, the same math: one implementation
of percentile reporting for the image batcher (``serving/image_batcher.py``),
the LM slot scheduler (``serving/batcher.py``) and the serve driver
(``serve_dcgan.py``).

Percentiles use numpy's default linear interpolation over the *completed*
requests only; throughput is completions over the measured wall-clock
window, not the sum of latencies (batched serving overlaps requests, so
the two differ by design).
"""
from __future__ import annotations

import numpy as np

PERCENTILES = (50, 95, 99)


def latency_stats(latencies_s, *, window_s: float | None = None) -> dict:
    """Summarize per-request latencies (seconds) into the serving report.

    Returns ``completed``, ``mean_ms`` and ``p50_ms``/``p95_ms``/``p99_ms``;
    when ``window_s`` (the measured serving window) is given, also
    ``throughput_rps`` = completed / window.
    """
    lat = np.asarray([float(v) for v in latencies_s], np.float64)
    out = {"completed": int(lat.size)}
    if lat.size:
        out["mean_ms"] = float(lat.mean() * 1e3)
        for p in PERCENTILES:
            out[f"p{p}_ms"] = float(np.percentile(lat, p) * 1e3)
    else:
        out["mean_ms"] = 0.0
        out.update({f"p{p}_ms": 0.0 for p in PERCENTILES})
    if window_s is not None:
        out["throughput_rps"] = (lat.size / window_s) if window_s > 0 else 0.0
    return out


def format_stats(st: dict, unit: str = "req") -> str:
    """One-line human rendering of a ``latency_stats`` dict."""
    parts = []
    if "throughput_rps" in st:
        parts.append(f"throughput {st['throughput_rps']:8.1f} {unit}/s")
    parts.append(f"latency p50 {st['p50_ms']:6.1f} ms")
    parts.append(f"p95 {st['p95_ms']:6.1f} ms")
    parts.append(f"p99 {st['p99_ms']:6.1f} ms")
    return "  ".join(parts)
