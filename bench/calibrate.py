"""Read a cell's check numbers over many seeds in one process, for setting
its limits: sound runs (``none``), the control (``control``: the reference
in TF32 in the program's place) and the planted faults.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --plants none,control,half_batch --seconds 2

Each run is a whole run of the cell (set-up, a window of ``--seconds`` at
the cell's own load, the check); one JSON line a run on standard output.
The benchmark's own runs never call this."""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--plants", default="none")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import Cell, run_cell
    cell = Cell(args.workload)
    for plant in args.plants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            res, detail = run_cell(cell, seed, args.seconds, False,
                                   plant=None if plant == "none" else plant)
            print(json.dumps({
                "workload": args.workload, "plant": plant, "seed": seed,
                "correct": res["correct"], "failed": res["failed"],
                "checks": {k: v["value"] for k, v in res["checks"].items()},
                "metrics": {k: v["value"]
                            for k, v in res["metrics"].items()},
                "s": time.perf_counter() - t0,
                "leaves": detail.get("leaves")}), flush=True)


if __name__ == "__main__":
    main()
