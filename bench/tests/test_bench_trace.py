"""The reduction of a device trace: busy time, and idle time split by the
innermost harness span open over each part of a gap."""
import pytest

from bench.trace import DeviceTrace, Spans


def trace():
    # device ns: kernels at 0-10, 30-40, 70-100 of a window 0-100
    kernels = [("k", 0, 10), ("k", 30, 40), ("k", 70, 100)]
    # host spans on the same clock: pump 5-60 holding execute 5-35, then
    # submit 50-55 inside pump; nothing from 60
    spans = [("cp.pump", 5, 60), ("batcher.execute", 5, 35),
             ("cp.submit", 50, 55)]
    return DeviceTrace((0, 100), kernels, spans)


def test_idle_time_is_split_by_the_innermost_span():
    t = trace()
    assert t.busy_s == pytest.approx(50e-9)
    gaps = dict(t.idle_gaps())
    # idle 10-30 in execute; 40-70: pump 40-50 and 55-60, submit 50-55,
    # no span 60-70
    assert gaps == pytest.approx({"idle in batcher.execute": 20e-9,
                                  "idle in cp.pump": 15e-9,
                                  "idle in cp.submit": 5e-9,
                                  "idle in no span": 10e-9})
    assert sum(t.host_seconds().values()) == pytest.approx(t.window_s)
    assert t.host_seconds()["no span"] == pytest.approx(45e-9)


def test_a_wrapped_method_keeps_its_span():
    clock = iter(range(100)).__next__
    spans = Spans(clock=clock)

    class Obj:
        def f(self, x):
            return 2 * x
    o = Obj()
    spans.wrap(o, "f", "f")
    assert o.f(3) == 6 and spans.records["f"] == [(0, 1)]


def test_markers_bound_the_window_and_place_the_spans():
    events = [("spin_kernel", 1000, 1010), ("k", 1020, 1030),
              ("k", 1050, 1060), ("Memcpy HtoD", 1060, 1065),
              ("spin_kernel", 1090, 1100)]
    log = []
    t = DeviceTrace.from_events(events, (400, 490), [("s", 4e-7, 5e-7)],
                                offset=7, log=log)
    # the window from the markers; the first marker's offset (600) wins
    assert (t.t0, t.t1) == (1000, 1100) and t.busy_s == pytest.approx(2e-8)
    assert t.spans == [("s", 1000, 1100)]
    assert log == [{"events": 5, "markers": 2, "kernels": 2}]


def test_a_lost_marker_leaves_the_kernels_extent():
    events = [("k", 1020, 1030), ("k", 1050, 1060),
              ("spin_kernel", 1090, 1100)]
    t = DeviceTrace.from_events(events, (400, 490), [("s", 4e-7, 5e-7)],
                                offset=600)
    assert (t.t0, t.t1) == (1020, 1060) and t.busy_s == pytest.approx(2e-8)
    assert t.spans == [("s", 1000, 1100)]
    assert DeviceTrace.from_events([("spin_kernel", 1, 2)], (0, 1), [],
                                   offset=0) is None
