"""Find the highest image rate an open-loop cell sustains: one window a
rate, in one process, at the rates given in rising order.

    python3 bench/sweep.py --workload dcgan.gen.closed \
        --traffic poisson_grid4 --rates 8000,9000,10000 --seconds 40 --seed 1

``--traffic`` runs an open-loop mix of ``bench/traffic/`` through the
cell's configuration.

Each line: the offered rate, p50/p95/p99 from the due time, how late the
generator submitted (p99), the mean image requests queued in each quarter
of the window, launches and rows a launch.  The sweep stops at the first
rate that fails a request or whose queue grows (its last quarter's mean
more than a tenth over the larger of the first two quarters'); the knee
is the rate before it.  The last line gives the knee and
four fifths of it, which the cell's traffic file then takes as its fixed
rate; the benchmark's own runs never search for one."""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def grows(backlog) -> bool:
    q1, q2, _, q4 = backlog
    return q4 > 1.1 * max(q1, q2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--traffic")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import BENCH, Cell, load_json, run_cell
    cell = Cell(args.workload)
    if args.traffic:
        cell.traffic = load_json(BENCH / "traffic" / f"{args.traffic}.json")
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic = dict(cell.traffic, image_rate_per_s=rate)
        res, d = run_cell(cell, args.seed, args.seconds, False)
        print(json.dumps({
            "rate": rate, "correct": res["correct"],
            "failed": res["failed"], "users": d["users"],
            "p50_ms": d["p50_ms"], "p95_ms": d["p95_ms"],
            "p99_ms": d["p99_ms"], "late_p99_ms": d["late_p99_ms"],
            "backlog": d["backlog"], "launches": d["launches"],
            "rows_per_launch": d["images"] / max(1, d["launches"]),
            "window_s": d["window_s"]}), flush=True)
        if res["failed"] > 0 or grows(d["backlog"]):
            break
        knee = rate
    print(json.dumps({"knee": knee,
                      "four_fifths": None if knee is None else 0.8 * knee}))


if __name__ == "__main__":
    main()
