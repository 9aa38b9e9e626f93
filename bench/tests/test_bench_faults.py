"""A whole run of each kind of cell at a tiny size on the CPU (the look for
a card skipped): sound, the check passes; with the timed path broken
underneath, or the TF32 reference (the control) in the program's place,
``correct`` comes out false."""
import pytest

from bench.harness import run_cell
from bench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 12345
SERVE = [("dcgan.gen.closed", None), ("dcgan.gen.closed", "poisson_grid4")]
CASES = [(c, t, p) for c, t in SERVE
         for p in (None, "control", "alter_answer", "half_batch")] + [
    ("dcgan.train.b64", None, p)
    for p in (None, "control", "half_batch", "state_unchanged",
              "leaf_doubled")]


@pytest.mark.parametrize("cell,traffic,plant", CASES)
def test_check_catches_the_fault(cell, traffic, plant):
    res, _ = run_cell(tiny_cell(cell, traffic), SEED, 0.1, False,
                      device="cpu", plant=plant)
    assert res["correct"] is (plant is None), res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    # the open mix runs in no cell yet: it reports set-up alone
    assert "setup_s" in res["metrics"]
    assert len(res["metrics"]) == (1 if traffic else 2)


def test_traced_run_reports_the_host_metrics():
    res, _ = run_cell(tiny_cell("dcgan.gen.closed"), SEED, 0.3, True,
                      device="cpu")
    assert res["correct"]
    assert set(res["metrics"]) == {"batcher.launch_ms"}


def test_one_leaf_fault_shows_at_the_worst_leaf():
    res, _ = run_cell(tiny_cell("dcgan.train.b64"), SEED, 0.1, False,
                      device="cpu", plant="leaf_doubled")
    c = res["checks"]
    assert c["grad_worst_leaf"]["value"] > c["grad_worst_leaf"]["limit"]
    assert c["grad_norm_gap"]["value"] <= c["grad_norm_gap"]["limit"]
