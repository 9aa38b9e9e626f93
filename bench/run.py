"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
check compared, beside its limit); the numbers compared are also the last
lines of standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end ones, with ``--trace 1`` its per-layer ones.

Exits non-zero, with no result, when there is no CUDA card or fewer than
the cell asks for, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` is loaded once the window has closed.  Build caches stay in the
checkout: nvcc's in ``src/repro_torch/kernels/_build/``, Triton's (should
the program ever use it) in ``.bench_cache/triton/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX one, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def finite(obj):
    """``obj`` with every NaN or infinity replaced by None (JSON null)."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    import torch

    from bench.harness import Cell, run_cell
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, detail = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded in the benchmark's process: {found}",
              file=sys.stderr)
        return 3
    print(f"detail {json.dumps(finite(detail), default=float)}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(finite(result), allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
