"""Render the §Dry-run and §Roofline tables from results/dryrun/*.json.

Counterpart of ``repro.launch.report``, over ``launch.dryrun``'s records:

    PYTHONPATH=src python -m repro_torch.launch.report > results/roofline_tables.md

The roofline's times are predictions at the nominal peaks of an NVIDIA
H100 80GB HBM3 (``launch.roofline``), not measurements.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun

CARD = "NVIDIA H100 80GB HBM3"


def fmt_bytes(b):
    for u in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{u}"
        b /= 1024
    return f"{b:.1f}EB"


def fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def load_all(directory=None):
    recs = {}
    for f in glob.glob(os.path.join(directory or dryrun.RESULTS_DIR,
                                    "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        parts = os.path.basename(f)[:-5].split("__")
        if len(parts) != 3 or parts[0] == "convplane":
            continue                       # tagged variants, the planner
        arch, shape, mesh = parts
        recs[(arch, shape, mesh)] = r
    return recs


def roofline_table(recs, mesh="single"):
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "bytes/chip | MODEL/counted flops | MFU@roof |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in registry.ARCH_IDS:
        for shape in SHAPES:
            r = recs.get((arch, shape, mesh))
            if r is None:
                lines.append(f"| {arch} | {shape} | — | — | — | MISSING "
                             f"| | | |")
                continue
            if "skipped" in r:
                lines.append(f"| {arch} | {shape} | — | — | — | "
                             f"skip: {r['skipped'][:40]} | | | |")
                continue
            if "error" in r:
                lines.append(f"| {arch} | {shape} | — | — | — | "
                             f"ERROR: {r['error'][:40]} | | | |")
                continue
            rf = r["roofline"]
            lines.append(
                f"| {arch} | {shape} | {fmt_s(rf['compute_s'])} | "
                f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
                f"**{rf['dominant']}** | {fmt_bytes(r['bytes_per_chip'])} | "
                f"{rf['model_over_hlo_flops']:.2f} | "
                f"{rf['mfu_at_roofline'] * 100:.1f}% |")
    return "\n".join(lines)


def dryrun_summary(recs):
    n_ok = sum(1 for r in recs.values() if "roofline" in r)
    n_skip = sum(1 for r in recs.values() if "skipped" in r)
    n_err = sum(1 for r in recs.values() if "error" in r)
    lines = [f"cells counted: {n_ok}; skipped (documented): {n_skip}; "
             f"errors: {n_err}", ""]
    lines.append("| arch | shape | mesh | rank | count | params/chip | "
                 "opt state/chip | cache/chip | peak act./chip | "
                 "kernel launches | collective ops |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|---|")
    for arch in registry.ARCH_IDS:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                r = recs.get((arch, shape, mesh))
                if r is None or "roofline" not in r:
                    continue
                m = r["memory"]
                ks = ", ".join(f"{k} {v['launches']}"
                               for k, v in r["kernels"].items()) or "—"
                lines.append(
                    f"| {arch} | {shape} | {r['mesh']} | {r['rank']} | "
                    f"{r['total_s']}s | {fmt_bytes(m['param_bytes'])} | "
                    f"{fmt_bytes(m['opt_state_bytes'])} | "
                    f"{fmt_bytes(m['cache_bytes'])} | "
                    f"{fmt_bytes(m['peak_activation_bytes'])} | {ks} | "
                    f"{r['collectives']['num_ops']} |")
    return "\n".join(lines)


def main(directory=None):
    recs = load_all(directory)
    print("## §Dry-run\n")
    print(dryrun_summary(recs))
    print(f"\n## §Roofline — single-pod 16x16 (256 chips), per-chip terms, "
          f"predicted at the nominal peaks of an {CARD}\n")
    print(roofline_table(recs, "single"))
    print(f"\n## §Roofline — multi-pod 2x16x16 (512 chips), predicted at "
          f"the nominal peaks of an {CARD}\n")
    print(roofline_table(recs, "multi"))


if __name__ == "__main__":
    main()
