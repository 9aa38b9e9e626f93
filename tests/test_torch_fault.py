"""The port's fault-tolerance primitives (``repro_torch.runtime.fault``)
against the JAX package's, case by case as ``tests/test_fault.py``: EWMA
straggler detection, deterministic failure injection, the heartbeat
watchdog and the restart driver's restore contract.  Every sequence runs
through both packages and gives the same flags, events and calls."""
import pytest

from repro.runtime import fault as jfault
from repro_torch.runtime import fault as tfault

BOTH = (jfault, tfault)


def records(mod, dts, **kw):
    """(flags, events) of a monitor of ``mod`` fed ``dts``."""
    m = mod.StragglerMonitor(**kw)
    return [m.record(s, dt) for s, dt in enumerate(dts)], list(m.events)


# ---------------------------------------------------------------------------
# StragglerMonitor
# ---------------------------------------------------------------------------


def test_straggler_warmup_window_never_flags():
    # a wild spike inside the warmup window: no variance estimate yet
    dts = [0.1, 5.0, 0.1]
    (flags, events), want = (records(m, dts, warmup=5, k=3.0) for m in BOTH)
    assert flags == want[0] and events == want[1]
    assert not any(flags) and not events


def test_straggler_sub_noise_jitter_never_flags():
    # jitter within the 5%-of-mean stddev floor never flags
    dts = [0.1 + 0.0004 * (s % 2) for s in range(200)]
    got, want = (records(m, dts, warmup=3, k=3.0) for m in (tfault, jfault))
    assert got == want
    assert not any(got[0]) and not got[1]


def test_straggler_monitor_flags_slow_step():
    dts = [0.1 + 0.001 * (s % 2) for s in range(10)] + [1.5]   # 15x slower
    got, want = (records(m, dts, warmup=3, k=3.0) for m in (tfault, jfault))
    assert got == want
    flags, events = got
    assert not any(flags[:10]) and flags[10]
    step, dt, _mean = events[0]
    assert (step, dt) == (10, 1.5)


def test_straggler_recovers_after_flagged_spike():
    dts = [0.1] * 10 + [1.5] + [0.1] * 20
    got, want = (records(m, dts, warmup=3, k=3.0) for m in (tfault, jfault))
    assert got == want
    flags = got[0]
    assert flags[10]
    # the spike moved the EWMA mean up; steady steps settle back down
    assert not any(flags[11 + 5:])


# ---------------------------------------------------------------------------
# FailureInjector / Heartbeat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", BOTH, ids=["jax", "torch"])
def test_failure_injector_fires_once_per_step(mod):
    inj = mod.FailureInjector((3, 5))
    inj.check(0)
    with pytest.raises(mod.NodeFailure, match="injected node failure at "
                                              "step 3"):
        inj.check(3)
    inj.check(3)                      # already fired: replay passes
    with pytest.raises(mod.NodeFailure):
        inj.check(5)
    inj.check(5)
    assert inj.fired == {3, 5}
    assert issubclass(tfault.NodeFailure, RuntimeError)


def test_heartbeat_beat_and_expiry():
    hb = tfault.Heartbeat(timeout=1e4)
    assert hb.beat() >= 0.0
    assert not hb.expired()
    hb.last -= 2e4                    # pretend the last beat was long ago
    assert hb.expired()
    hb.beat()                         # beating un-expires the watchdog
    assert not hb.expired()
    assert tfault.Heartbeat().timeout == jfault.Heartbeat().timeout


# ---------------------------------------------------------------------------
# run_with_restarts: explicit restore contract
# ---------------------------------------------------------------------------


def restart_calls(mod, **kw):
    inj = mod.FailureInjector((3,))
    calls = []

    def loop(start):
        calls.append(start)
        for s in range(start, 6):
            inj.check(s)
        return 6

    return mod.run_with_restarts(loop, **kw), calls


def test_restart_reenters_at_restored_step():
    # restore() says "checkpoint at 2": the second attempt enters there
    got, want = (restart_calls(m, restore=lambda: 2) for m in (tfault,
                                                               jfault))
    assert got == want == (6, [0, 2])


def test_restart_without_restore_reenters_at_initial_step():
    got, want = (restart_calls(m, initial_step=1) for m in (tfault, jfault))
    assert got == want == (6, [1, 1])


def test_restart_budget_exhausted():
    seen = {}
    for mod in BOTH:
        inj = mod.FailureInjector((0,))
        seen[mod] = []

        def loop(start, inj=inj):
            inj.fired.clear()             # fail every time
            inj.check(0)
            return 1

        with pytest.raises(mod.NodeFailure):
            mod.run_with_restarts(loop, max_restarts=2,
                                  on_restart=lambda n, e, s=seen[mod]:
                                  s.append(n))
    assert seen[tfault] == seen[jfault] == [1, 2]   # each retry only
