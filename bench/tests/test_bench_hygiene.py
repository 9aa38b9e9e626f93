"""The benchmark's files against its contract, its imports, and its refusal
to run without a card."""
import json
import math
import re
import subprocess
import sys

import pytest

from bench.harness import BENCH, ROOT, Cell, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["bench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCHMARK[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_file_a_cell_names_is_there():
    used = set()
    for w in BENCHMARK["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = Cell(w["name"], BENCHMARK)
        used.add(w["config"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(reader(m["name"]))
        assert set(cell.check["limits"]) and all(
            0 < v < math.inf for v in cell.check["limits"].values())
    for c in BENCHMARK["configs"]:
        assert c["name"] in used and c["file"].startswith("bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_metric_files_belong_to_metrics():
    declared = {m["name"] for m in BENCHMARK["per_layer"]}
    files = {p.stem for p in (BENCH / "metrics").glob("*.py")
             if p.stem != "__init__"}
    assert files == declared


def run_python(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


TOP = ("import json, sys; print(json.dumps(sorted("
       "{m.split('.')[0] for m in sys.modules})))")


def test_a_run_imports_no_jax():
    mods = run_python(
        "import json, runpy\n"
        "runpy.run_path('bench/run.py', run_name='bench_run')\n"
        "from bench import harness\n"
        "from bench.families import gan\n"
        "for m in json.load(open('BENCHMARK.json'))['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "import repro_torch.train_gan, repro_torch.serving.control_plane\n"
        + TOP)
    assert "repro_torch" in mods and "bench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    mods = run_python("import bench.reference.gan;"
                      + TOP)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "dcgan.gen.closed",
         "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={"CUDA_VISIBLE_DEVICES": "",
                                     "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs on the card")
    return torch.device("cuda")


def test_a_cell_runs_on_the_card(card):
    from bench.harness import run_cell
    from bench.tests.tiny import tiny_cell
    res, _ = run_cell(tiny_cell("dcgan.gen.closed"), 7, 0.5, False,
                      device="cuda")
    assert res["correct"] and res["device"]["platform"] == "gpu"
