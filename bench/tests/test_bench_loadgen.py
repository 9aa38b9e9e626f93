"""The load generators: a fixed set of arrival gaps for every seed, the
closed loop's window, and latency from the due time, which keeps a stall
that a submit-time stamp would hide."""
import time

import numpy as np
import pytest

from bench import loadgen


def test_arrival_gaps_are_one_set_in_another_order():
    a = loadgen.arrival_offsets(500, 2.0, np.random.default_rng(1))
    b = loadgen.arrival_offsets(500, 2.0, np.random.default_rng(2))
    assert a[0] == b[0] == 0.0 and np.all(np.diff(a) > 0)
    assert a[-1] < 2.0 and b[-1] < 2.0
    assert not np.allclose(a, b)
    ga = np.sort(np.diff(np.append(a, 2.0)))
    gb = np.sort(np.diff(np.append(b, 2.0)))
    np.testing.assert_allclose(ga, gb, rtol=1e-9)
    # exponential gaps: the mean over the median is ln 2's inverse
    assert np.mean(ga) / np.median(ga) == pytest.approx(1 / np.log(2),
                                                        rel=0.02)


def plane(serve_fn, max_wait_ms=2.0):
    from repro_torch.serving.control_plane import ControlPlane
    cp = ControlPlane()
    cp.register_image_model("m", serve_fn, np.zeros(4, np.float32),
                            max_wait_ms=max_wait_ms, device="cpu")
    return cp


def driver(cp, parts=1):
    pool = np.arange(64, dtype=np.float32).reshape(16, 4)
    return loadgen.Driver(cp, "m", parts,
                          payload=lambda i: (pool[i % 16], i % 16),
                          clock=time.perf_counter)


def test_closed_loop_keeps_every_client_busy():
    drv = driver(plane(lambda x: x * 2))
    st = loadgen.run_closed(drv, 8, 0.2)
    drv.drain(time.perf_counter() + 5)
    assert st["images"] > 8 and st["t1"] - st["t0"] >= 0.2
    assert all(u.t_done is not None for u in drv.users)
    assert {u.client for u in drv.users} == set(range(8))


def test_a_stall_shows_in_the_latency_of_the_requests_due_during_it():
    stall = {"at": None, "s": 0.1}

    def serve(x):
        if stall["at"] is not None and time.perf_counter() >= stall["at"]:
            stall["at"] = None
            time.sleep(stall["s"])
        return x * 2
    cp = plane(serve)
    drv = driver(cp, parts=2)
    offsets = loadgen.arrival_offsets(400, 0.4, np.random.default_rng(0))
    stall["at"] = time.perf_counter() + 0.1
    t_stall = stall["at"]
    loadgen.run_open(drv, offsets, 0.4)
    during = [u for u in drv.users
              if t_stall + 0.01 <= u.due <= t_stall + 0.05]
    assert during and all(u.t_done is not None for u in drv.users)
    # from the due time: each waits out the rest of the stall
    p95_due = loadgen.percentile_ms([u.latency_s for u in during], 95)
    # from the submit, as a driver that stamps arrival at submit would
    p95_submit = loadgen.percentile_ms(
        [u.t_done - u.t_issued for u in during], 95)
    assert p95_due >= 50.0
    assert p95_submit <= p95_due - 40.0


def test_reservoir_keeps_a_seeded_uniform_sample():
    def draw(seed):
        r = loadgen.Reservoir(10, np.random.default_rng(seed))
        for i in range(1000):
            r.offer(int, i)
        return r.items
    assert draw(3) == draw(3) and draw(3) != draw(4)
    assert len(draw(3)) == 10 and max(draw(3)) > 100


def test_percentiles_match_numpy_and_count_failures_as_missing():
    lat = list(np.random.default_rng(0).exponential(0.01, 101))
    for q in (50, 95, 99):
        assert loadgen.percentile_ms(lat, q) == pytest.approx(
            np.percentile(lat, q) * 1e3)
    failed = loadgen.UserRequest(uid=0, due=0.0, parts=1)
    lat = [0.001] * 98 + [failed.latency_s] * 2
    assert loadgen.percentile_ms(lat, 95) == pytest.approx(1.0)
    assert loadgen.percentile_ms(lat, 99) == float("inf")


@pytest.mark.parametrize("rate,grows", [(400, False), (20000, True)])
def test_backlog_grows_only_past_capacity(rate, grows):
    def serve(x):                      # 30 ms a launch: ~2,000 images/s
        time.sleep(0.03)
        return x * 2
    drv = driver(plane(serve))
    n = int(rate * 0.4)
    st = loadgen.run_open(drv, loadgen.arrival_offsets(
        n, 0.4, np.random.default_rng(0)), 0.4, wait_s=0.1)
    q = st["backlog"]
    assert len(q) == 4 and all(v is not None for v in q)
    assert (q[3] > 2 * q[1] + 10) is grows, q
