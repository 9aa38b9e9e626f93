"""The port's SLO-aware control plane (``repro_torch.serving.control_plane``)
against the JAX package's, on the CPU: each case of
``tests/test_control_plane.py`` (admission, shed, priority and
starvation, backfill, multi-model routing and EDF, fault replay of image
launches and LM decode, the duplicate guard, stragglers, accounting and
the one injected clock) runs the same numpy inputs through both planes
and compares what they decided (the two ``degrade`` cases on a one-rank
mesh; the plane-parallel degrade across ranks is
``tests/test_torch_spatial_dist.py``).
Then one seeded trace on one fake clock through both planes over
``SEGNET_TINY`` on JAX's weights, and one over the reduced llama3.2-1b,
each with an injected fault: the same statuses, replays, launches, fault
records, ``stats()`` counts and answers.  Last, ``decode_step`` gives the
same bits with its cache index as an int and as a 0-d tensor."""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import segnet as jseg
from repro.models import transformer as jtfm
from repro.runtime import fault as jfault
from repro.serving import control_plane as jcp
from repro_torch.configs import registry as tregistry
from repro_torch.models import segnet as tseg
from repro_torch.models import transformer as ttfm
from repro_torch.runtime import fault as tfault
from repro_torch.serving import control_plane as tcp

ECHO_COSTS = {1: 1e-4, 4: 2e-4, 16: 5e-4, 64: 1e-3}
PKGS = {"jax": (jcp, jfault), "torch": (tcp, tfault)}
STAT_COUNTS = ("submitted", "served", "rejected", "shed", "queued",
               "replayed_requests")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def register(cp, name, fn, proto, **kw):
    """``register_image_model``; the port's backend on the CPU."""
    if isinstance(cp, tcp.ControlPlane):
        kw["device"] = "cpu"
    return cp.register_image_model(name, fn, proto, **kw)


def set_costs(be, costs):
    be.batcher.bucket_cost_s = {b: c for b, c in costs.items()
                                if b in be.batcher.buckets}
    be.batcher._sched_memo = {0: (0.0, 0)}


def echo_plane(mod, *, buckets=(1, 4, 16, 64), costs=None, **kw):
    """A control plane of ``mod`` over an echo backend (x * 2), the same
    lambda for both packages."""
    cp = mod.ControlPlane(**kw)
    be = register(cp, "echo", lambda x: x * 2.0, np.zeros((4,), np.float32),
                  buckets=buckets)
    if costs is not None:
        set_costs(be, costs)
    return cp, be


def payloads(n, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(dim).astype(np.float32) for _ in range(n)]


def decisions(cp):
    """What a plane decided: the served order, every request's status,
    reason prefix and replays, the stats counts and the fault records."""
    st = cp.stats()
    reqs = cp.done + cp.rejected + cp.shed
    return {"order": [r.rid for r in cp.done],
            "requests": sorted((r.rid, r.status, r.reason.split(":")[0],
                                r.replays) for r in reqs),
            "counts": {k: st[k] for k in STAT_COUNTS},
            "per_class": {c: {k: st["per_class"][c][k] for k in
                              ("completed", "slo_miss", "rejected", "shed")}
                          for c in tcp.PRIORITIES},
            "faults": st["faults"]["records"]}


def on_both(scenario):
    """Run ``scenario(cp_module, fault_module)`` for both packages: (the
    port's result, JAX's)."""
    return scenario(*PKGS["torch"]), scenario(*PKGS["jax"])


def assert_outputs_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for rid in got:
        np.testing.assert_array_equal(got[rid], want[rid])


# ---------------------------------------------------------------------------
# admission + shed
# ---------------------------------------------------------------------------

def test_admission_rejects_when_backlog_blows_slo():
    def scenario(mod, _):
        cp, _ = echo_plane(mod, costs=ECHO_COSTS)
        admitted = [cp.submit(mod.ServeRequest(rid=i, model="echo",
                                               payload=z))
                    for i, z in enumerate(payloads(16))]
        late = mod.ServeRequest(rid=99, model="echo",
                                payload=payloads(1)[0], slo_ms=0.01)
        admitted.append(cp.submit(late))
        ok = mod.ServeRequest(rid=100, model="echo", payload=payloads(1)[0],
                              slo_ms=10_000.0)
        admitted.append(cp.submit(ok))
        cp.run()
        return admitted, decisions(cp), cp.results()

    (adm, dec, out), (jadm, jdec, jout) = on_both(scenario)
    assert adm == jadm == [True] * 16 + [False, True]
    assert dec == jdec
    assert ("rejected", "admission") in [(s, r) for _, s, r, _ in
                                         dec["requests"]]
    assert dec["counts"]["rejected"] == 1 and dec["counts"]["served"] == 17
    assert_outputs_equal(out, jout)


def test_admission_permissive_without_measured_costs():
    cp, be = echo_plane(tcp)
    assert not be.batcher.bucket_cost_s
    assert cp.submit(tcp.ServeRequest(rid=0, model="echo",
                                      payload=payloads(1)[0], slo_ms=1e-6))
    assert cp.queues["echo"]["interactive"]
    jplane, _ = echo_plane(jcp)
    assert jplane.submit(jcp.ServeRequest(rid=0, model="echo",
                                        payload=payloads(1)[0],
                                        slo_ms=1e-6))


def test_admission_disabled_never_rejects():
    def scenario(mod, _):
        cp, _ = echo_plane(mod, costs=ECHO_COSTS, admission=False)
        ok = [cp.submit(mod.ServeRequest(rid=i, model="echo", payload=z,
                                         slo_ms=1e-6))
              for i, z in enumerate(payloads(32))]
        return ok, cp.stats()["rejected"]

    got, want = on_both(scenario)
    assert got == want == ([True] * 32, 0)


def test_shed_on_expiry_before_launch():
    def scenario(mod, _):
        cp, _ = echo_plane(mod)
        expired = mod.ServeRequest(rid=0, model="echo",
                                   payload=payloads(1)[0], slo_ms=1.0,
                                   t_arrival=time.perf_counter() - 1.0)
        live = mod.ServeRequest(rid=1, model="echo",
                                payload=payloads(1, seed=1)[0],
                                slo_ms=60_000.0)
        cp.run([expired, live])
        return (expired.out, live.in_slo, decisions(cp),
                cp.stats()["per_class"]["interactive"]["shed"])

    (out, in_slo, dec, shed), (jout, jin, jdec, jshed) = on_both(scenario)
    assert out is None and jout is None           # never computed
    assert in_slo and jin
    assert dec == jdec
    assert dec["requests"] == [(0, "shed", "shed", 0),
                               (1, "served", "", 0)]
    assert shed == jshed == 1 and dec["counts"]["queued"] == 0


# ---------------------------------------------------------------------------
# priority, starvation bound, backfill
# ---------------------------------------------------------------------------

def test_interactive_launches_before_fresh_batch():
    def scenario(mod, _):
        cp, _ = echo_plane(mod, buckets=(1,))
        b = mod.ServeRequest(rid=0, model="echo", payload=payloads(1)[0],
                             priority="batch")
        i = mod.ServeRequest(rid=1, model="echo",
                             payload=payloads(1, seed=1)[0])
        cp.run([b, i])                            # batch arrived first...
        return [r.rid for r in cp.done]

    assert on_both(scenario) == ([1, 0], [1, 0])  # ...interactive wins


def test_starvation_bound_flips_to_batch():
    def scenario(mod, _):
        cp, _ = echo_plane(mod, buckets=(1,), starvation_ms=50.0)
        old_batch = mod.ServeRequest(rid=0, model="echo",
                                     payload=payloads(1)[0],
                                     priority="batch",
                                     t_arrival=time.perf_counter() - 1.0)
        fresh = mod.ServeRequest(rid=1, model="echo",
                                 payload=payloads(1, seed=1)[0])
        cp.run([old_batch, fresh])
        return [r.rid for r in cp.done]

    assert on_both(scenario) == ([0, 1], [0, 1])  # starved batch first


def test_launch_backfills_other_class():
    def scenario(mod, _):
        cp, be = echo_plane(mod, buckets=(1, 4))
        cp.run([mod.ServeRequest(rid=i, model="echo", payload=z,
                                 priority="interactive" if i < 3
                                 else "batch")
                for i, z in enumerate(payloads(4))])
        return (be.batcher.launches,
                cp.stats()["per_model"]["echo"]["pad_fraction"],
                sorted(r.rid for r in cp.done))

    got, want = on_both(scenario)
    # one bucket-4 launch: 3 interactive + 1 batch backfilled into the pad
    assert got == want == ([(4, 4)], 0.0, [0, 1, 2, 3])


def test_bad_priority_and_unknown_model_raise():
    cp, _ = echo_plane(tcp)
    with pytest.raises(ValueError, match="priority"):
        tcp.ServeRequest(rid=0, model="echo", payload=payloads(1)[0],
                         priority="realtime")
    with pytest.raises(ValueError, match="unknown model"):
        cp.submit(tcp.ServeRequest(rid=0, model="nope",
                                   payload=payloads(1)[0]))
    with pytest.raises(ValueError, match="already registered"):
        register(cp, "echo", lambda x: x, np.zeros((4,), np.float32))
    assert tcp.PRIORITIES == jcp.PRIORITIES


# ---------------------------------------------------------------------------
# multi-model hosting
# ---------------------------------------------------------------------------

def test_multi_model_routing_and_per_model_stats():
    zs = payloads(8)

    def scenario(mod, _):
        cp = mod.ControlPlane()
        register(cp, "x2", lambda x: x * 2.0, np.zeros((4,), np.float32),
                 buckets=(1, 4))
        register(cp, "x3", lambda x: x * 3.0, np.zeros((4,), np.float32),
                 buckets=(1, 4))
        cp.run([mod.ServeRequest(rid=i, model="x2" if i % 2 == 0 else "x3",
                                 payload=z) for i, z in enumerate(zs)])
        return cp, cp.stats()["per_model"]

    (cp, pm), (jcp_, jpm) = on_both(scenario)
    assert len(cp.done) == 8 and cp.pending() == 0
    for r in cp.done:
        np.testing.assert_array_equal(
            r.out, zs[r.rid] * (2.0 if r.model == "x2" else 3.0))
    assert pm == jpm
    assert pm["x2"]["served"] == 4 and pm["x3"]["served"] == 4
    assert [r.rid for r in cp.done] == [r.rid for r in jcp_.done]


def test_edf_across_models_picks_earliest_deadline():
    def scenario(mod, _):
        cp = mod.ControlPlane()
        register(cp, "a", lambda x: x + 1.0, np.zeros((4,), np.float32),
                 buckets=(1,))
        register(cp, "b", lambda x: x - 1.0, np.zeros((4,), np.float32),
                 buckets=(1,))
        # b's head has the earlier deadline: it launches first although
        # a's request arrived first
        cp.submit(mod.ServeRequest(rid=0, model="a", payload=payloads(1)[0],
                                   slo_ms=60_000.0))
        cp.submit(mod.ServeRequest(rid=1, model="b",
                                   payload=payloads(1, seed=1)[0],
                                   slo_ms=5_000.0))
        first = [r.rid for r in cp.pump(drain=True)]
        cp.run()
        return first, sorted(r.rid for r in cp.done)

    assert on_both(scenario) == (([1], [0, 1]), ([1], [0, 1]))


# ---------------------------------------------------------------------------
# fault injection: re-queue + replay
# ---------------------------------------------------------------------------

def test_fault_replay_echo_bit_equal_zero_drops_zero_dups():
    zs = payloads(24)

    def scenario(mod, fault):
        def reqs():
            return [mod.ServeRequest(rid=i, model="echo", payload=z)
                    for i, z in enumerate(zs)]
        ref, _ = echo_plane(mod, costs=ECHO_COSTS)
        ref.run(reqs())
        # kill the first launch mid-batch: its requests re-queue + replay
        cp, _ = echo_plane(mod, costs=ECHO_COSTS,
                           injector=fault.FailureInjector((1,)))
        cp.run(reqs())
        return cp, ref

    (cp, ref), (jcp_, _) = on_both(scenario)
    dec = decisions(cp)
    assert dec == decisions(jcp_)
    assert dec["faults"][0]["live"] == 16             # the bucket-16 launch
    assert dec["counts"]["replayed_requests"] == 16
    assert dec["counts"]["served"] == 24 and dec["counts"]["queued"] == 0
    rids = [r.rid for r in cp.done]
    assert len(rids) == len(set(rids))                # zero duplicates
    assert_outputs_equal(cp.results(), ref.results())  # bit-equal replay
    assert_outputs_equal(cp.results(), jcp_.results())


def test_fault_replay_preserves_arrival_order_and_priority():
    def scenario(mod, fault):
        cp, _ = echo_plane(mod, buckets=(1, 4),
                           injector=fault.FailureInjector((1,)))
        cp.run([mod.ServeRequest(rid=i, model="echo", payload=z,
                                 priority="interactive" if i < 2
                                 else "batch")
                for i, z in enumerate(payloads(4))])
        return [(r.rid, r.replays, r.priority) for r in cp.done]

    got, want = on_both(scenario)
    # back at the FRONT of their own class queues in arrival order
    assert got == want
    assert sorted(rid for rid, _, _ in got) == [0, 1, 2, 3]
    assert all(rep == 1 for _, rep, _ in got)
    assert dict((rid, pr) for rid, _, pr in got)[2] == "batch"


def segnet_models():
    """(JAX serve fn, port serve fn, proto) over ``SEGNET_TINY`` on JAX's
    weights, carried over by ``params_from_jax``."""
    jc = jseg.SEGNET_TINY
    tc = dataclasses.replace(tseg.SEGNET_TINY, backend="torch")
    jp, _ = jseg.segnet_init(jax.random.PRNGKey(0), jc)
    tp = tseg.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                              device="cpu")

    def jfn(x):
        return jnp.argmax(jseg.segnet_apply(jp, x, jc), axis=-1)

    def tfn(x):
        return torch.argmax(tseg.segnet_apply(tp, x, tc), dim=-1)

    return jfn, tfn, np.zeros((jc.in_hw, jc.in_hw, jc.in_c), np.float32)


def test_fault_replay_segnet_integration_bit_equal():
    """Device loss mid-batch on a planned model: the second bucket launch
    dies, its live requests re-queue + replay, and every answer is
    bit-equal to the fault-free run's and to JAX's."""
    jfn, tfn, proto = segnet_models()
    rng = np.random.default_rng(0)
    xs = [rng.uniform(-1, 1, proto.shape).astype(np.float32)
          for _ in range(8)]

    def scenario(mod, fault):
        fn = tfn if mod is tcp else jfn

        def reqs():
            return [mod.ServeRequest(rid=i, model="seg", payload=x)
                    for i, x in enumerate(xs)]
        ref = mod.ControlPlane()
        register(ref, "seg", fn, proto, buckets=(1, 4))
        ref.run(reqs())
        cp = mod.ControlPlane(injector=fault.FailureInjector((2,)))
        register(cp, "seg", fn, proto, buckets=(1, 4))
        cp.run(reqs())
        return cp, ref

    (cp, ref), (jcp_, _) = on_both(scenario)
    dec = decisions(cp)
    assert dec == decisions(jcp_)
    assert len(dec["faults"]) == 1 and dec["counts"]["replayed_requests"] == 4
    assert dec["counts"]["served"] == 8 and dec["counts"]["queued"] == 0
    assert_outputs_equal(cp.results(), ref.results())
    assert_outputs_equal(cp.results(), jcp_.results())


@pytest.fixture(scope="module")
def lm():
    """(JAX cfg, port cfg, JAX's f32 params, the port's copy)."""
    jc, tc = (jregistry.get_reduced("llama3.2-1b"),
              tregistry.get_reduced("llama3.2-1b"))
    jp, _ = jtfm.init(jax.random.PRNGKey(0), jc)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jc, tc, jp, ttfm.params_from_jax(jax.tree.map(np.asarray, jp),
                                            tc, "cpu")


def register_lm(mod, cp, lm, **kw):
    jc, tc, jp, tp = lm
    if mod is tcp:
        return cp.register_lm_model("lm", tc, tp, device="cpu", **kw)
    return cp.register_lm_model("lm", jc, jp, **kw)


def test_fault_replay_lm_decode_bit_equal(lm):
    """A NodeFailure mid-decode evicts every live slot; the prompts
    re-queue and the replayed greedy tokens equal a fault-free run's and
    JAX's."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, lm[0].vocab_size, p).astype(np.int32)
               for p in (3, 5, 2, 4)]

    def scenario(mod, fault):
        def reqs():
            return [mod.ServeRequest(rid=i, model="lm", payload=p,
                                     max_new=4)
                    for i, p in enumerate(prompts)]
        ref = mod.ControlPlane()
        register_lm(mod, ref, lm, slots=2, max_len=16)
        ref.run(reqs())
        cp = mod.ControlPlane(injector=fault.FailureInjector((3,)))
        be = register_lm(mod, cp, lm, slots=2, max_len=16)
        cp.run(reqs())
        return cp, ref, be

    (cp, ref, be), (jcp_, _, jbe) = on_both(scenario)
    dec = decisions(cp)
    assert dec == decisions(jcp_)
    assert len(dec["faults"]) == 1
    assert dec["counts"]["replayed_requests"] >= 1
    assert dec["counts"]["served"] == 4 and dec["counts"]["queued"] == 0
    assert not be.active() and be.steps == jbe.steps
    assert_outputs_equal(cp.results(), ref.results())
    assert_outputs_equal(cp.results(), jcp_.results())
    pm = cp.stats()["per_model"]["lm"]
    assert pm["steps"] > 0 and pm["step_cost_ms"] > 0


def test_duplicate_commit_guard():
    cp, _ = echo_plane(tcp)
    r = tcp.ServeRequest(rid=7, model="echo", payload=payloads(1)[0])
    cp._commit(dataclasses.replace(r))
    with pytest.raises(AssertionError, match="answered twice"):
        cp._commit(dataclasses.replace(r))


# ---------------------------------------------------------------------------
# stragglers + elastic degrade
# ---------------------------------------------------------------------------

def test_straggler_alert_surfaces_in_stats():
    def scenario(mod, _):
        cp, _ = echo_plane(mod, straggler_warmup=3)
        for _ in range(10):
            cp._observe("echo", 16, 0.01)
        cp._observe("echo", 16, 1.0)              # 100x spike on one bucket
        for _ in range(10):
            cp._observe("echo", 4, 0.01)          # healthy bucket
        return cp.stats()["stragglers"]

    got, want = on_both(scenario)
    assert got == want == {"events": 1, "slow_buckets": ["echo/b16"]}


@pytest.fixture
def one_rank_world():
    """``degrade`` in a process that joined no group starts a one-rank
    group; end it, so later tests in this process run in no group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import one_rank_world_end
    yield
    one_rank_world_end()
    assert not dist.is_initialized()


def test_degrade_then_serve(one_rank_world):
    """All but one replica lost: ``degrade(1)`` gives JAX's one-rank
    (data, model) mesh, rebinds the backend and serves as JAX's does;
    ``ImageBackend(dist=)`` serves over a mesh."""
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.sharding import DistContext

    def scenario(mod, _):
        cp, _ = echo_plane(mod)
        mesh = cp.degrade(1)
        zs = payloads(4)
        cp.run([mod.ServeRequest(rid=i, model="echo", payload=z)
                for i, z in enumerate(zs)])
        assert len(cp.done) == 4
        for r in cp.done:
            np.testing.assert_array_equal(r.out, zs[r.rid] * 2.0)
        return mesh, cp.stats()["faults"]["degraded"], cp.backends["echo"]

    (mesh, deg, be), (jmesh, jdeg, _) = on_both(scenario)
    assert mesh_shape(mesh) == dict(jmesh.shape) == {"data": 1, "model": 1}
    assert deg == jdeg and deg["devices_left"] == 1
    assert be.batcher.dist.mesh is mesh
    be2 = tcp.ImageBackend("m", lambda x: x + 1.0,
                           np.zeros((4,), np.float32),
                           dist=DistContext(mesh), device="cpu")
    z = payloads(1)[0]
    np.testing.assert_array_equal(be2.launch([z], 1)[0], z + 1.0)
    # an encoder-decoder's memory is taken, and the backend serves
    s2t = tregistry.get_reduced("seamless-m4t-large-v2")
    mem = torch.zeros((1, 4, s2t.d_model))
    be = tcp.LMBackend("s2t", s2t, ttfm.init(s2t, device="cpu",
                                              dtype=torch.float32),
                       memory=mem, device="cpu", slots=1, max_len=8)
    assert be.cb.memory is mem
    be.feed(tcp.ServeRequest(rid=0, model="s2t",
                             payload=np.array([1, 2], np.int32), max_new=2))
    while be.active():
        done = be.step()
    assert len(done) == 1 and len(done[0].out) == 2


def test_on_fault_hook_can_degrade(one_rank_world):
    calls = []

    def hook(plane, err):
        calls.append((str(err), plane.pending()))
        plane.degrade(1)

    cp, _ = echo_plane(tcp, injector=tfault.FailureInjector((1,)),
                       on_fault=hook)
    cp.run([tcp.ServeRequest(rid=i, model="echo", payload=z)
            for i, z in enumerate(payloads(4))])
    # the hook ran once, after the dead launch's requests were re-queued,
    # and the replay served on the shrunk mesh
    assert calls == [("injected node failure at step 1", 4)]
    assert sorted(r.rid for r in cp.done) == [0, 1, 2, 3]
    assert cp.stats()["faults"]["degraded"]["devices_left"] == 1


def test_degrade_onto_pods(one_rank_world):
    """``degrade(..., pod=)`` shrinks onto a (pod, data, model) mesh, as
    JAX's does, and ``degraded`` holds its shape."""
    from repro_torch.launch.mesh import mesh_shape

    def scenario(mod, _):
        cp, _ = echo_plane(mod)
        mesh = cp.degrade(1, pod=1)
        cp.run([mod.ServeRequest(rid=0, model="echo",
                                 payload=payloads(1)[0])])
        assert len(cp.done) == 1
        return mesh, cp.stats()["faults"]["degraded"]

    (mesh, deg), (jmesh, jdeg) = on_both(scenario)
    want = {"pod": 1, "data": 1, "model": 1}
    assert mesh_shape(mesh) == dict(jmesh.shape) == want
    assert deg == jdeg and deg["mesh_shape"] == want


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def test_conservation_and_goodput_accounting():
    def scenario(mod, _):
        cp, _ = echo_plane(mod, costs=ECHO_COSTS)
        cp.run([mod.ServeRequest(rid=i, model="echo", payload=z,
                                 slo_ms=0.01 if i % 3 == 0 else 60_000.0)
                for i, z in enumerate(payloads(30))])
        return cp

    cp, jcp_ = on_both(scenario)
    st = cp.stats()
    assert st["queued"] == 0 and st["submitted"] == 30
    assert st["submitted"] == st["served"] + st["rejected"] + st["shed"]
    assert st["rejected"] + st["shed"] > 0        # tight slos did fail
    good = sum(1 for r in cp.done if r.in_slo is not False)
    assert st["goodput_under_slo"] == pytest.approx(good / 30)
    for cls in tcp.PRIORITIES:
        assert set(st["per_class"][cls]) == set(
            jcp_.stats()["per_class"][cls])
        assert set(st["per_class"][cls]) >= {
            "p50_ms", "p95_ms", "p99_ms", "slo_miss",
            "rejected", "shed", "goodput_rps", "goodput_under_slo"}
    assert set(st) == set(jcp_.stats())
    # every 0.01 ms SLO is below the least measured launch cost: rejected
    assert {r.rid for r in cp.rejected} == \
        {r.rid for r in jcp_.rejected} == set(range(0, 30, 3))


def test_no_slo_requests_never_rejected_or_shed():
    def scenario(mod, _):
        cp, be = echo_plane(mod, costs=ECHO_COSTS)
        cp.run([mod.ServeRequest(rid=i, model="echo", payload=z)
                for i, z in enumerate(payloads(70))])
        return cp, be.batcher.launches

    (cp, launches), (jcp_, jlaunches) = on_both(scenario)
    st = cp.stats()
    assert st["served"] == 70 and st["rejected"] == 0 and st["shed"] == 0
    assert st["goodput_under_slo"] == 1.0
    assert all(r.in_slo is None for r in cp.done)
    assert launches == jlaunches
    assert decisions(cp) == decisions(jcp_)


# ---------------------------------------------------------------------------
# one injected clock across both scheduling layers
# ---------------------------------------------------------------------------

def test_injected_clock_is_shared_and_max_wait_boundary_is_exact():
    """Admission/shed (control plane) and max-wait coalescing (batcher) run
    on ONE injected clock: a partial bucket whose oldest request has
    waited exactly ``max_wait`` launches at the boundary and not a tick
    before, in both packages."""
    def scenario(mod, _):
        t = [0.0]
        cp, be = echo_plane(mod, costs=ECHO_COSTS, clock=lambda: t[0])
        assert be.batcher.clock is cp.clock       # one clock, both layers
        req = mod.ServeRequest(rid=0, model="echo", payload=payloads(1)[0])
        assert cp.submit(req)
        assert req.t_arrival == 0.0               # stamped by the fake clock
        wait = be.max_wait_s
        t[0] = wait - 1e-6                        # one microsecond early
        early = cp.pump()
        status = req.status
        t[0] = wait                               # exactly max_wait
        done = cp.pump()
        return (early, status, [r.rid for r in done], done[0].out,
                done[0].t_done == t[0], done[0].latency_s, wait)

    got, want = on_both(scenario)
    early, status, rids, out, stamped, lat, wait = got
    assert early == [] and status == "queued"
    assert rids == [0] and stamped
    np.testing.assert_allclose(out, payloads(1)[0] * 2.0)
    assert lat == pytest.approx(wait)
    assert got[:3] == want[:3] and got[4:] == want[4:]
    np.testing.assert_array_equal(out, want[3])


def test_injected_clock_governs_shed_and_deadline():
    """A request whose SLO expires in fake time is shed although no real
    time elapsed."""
    def scenario(mod, _):
        t = [0.0]
        cp, _ = echo_plane(mod, costs=ECHO_COSTS, clock=lambda: t[0])
        req = mod.ServeRequest(rid=1, model="echo", payload=payloads(1)[0],
                               slo_ms=5.0)
        assert cp.submit(req)
        t[0] = 0.1                                # 100 ms of fake time
        return cp.pump(drain=True), req.reason, decisions(cp)

    (done, reason, dec), (jdone, jreason, jdec) = on_both(scenario)
    assert done == jdone == []
    assert "deadline passed" in reason and reason == jreason
    assert dec == jdec
    assert dec["counts"]["shed"] == 1 and dec["counts"]["served"] == 0


# ---------------------------------------------------------------------------
# one seeded trace through both planes: SegNet and the LM, with faults
# ---------------------------------------------------------------------------

SEG_COSTS = {1: 1e-3, 4: 2e-3, 16: 5e-3}


def seg_trace(mod, fault, fn, proto):
    """One seeded trace on one fake clock: a burst of interactive and
    batch requests, some with an SLO; one rejected at admission, one shed
    in fake time, a batch head past the starvation bound; a fault at
    launch 2.  Returns (plane, backend)."""
    t = [0.0]
    cp = mod.ControlPlane(injector=fault.FailureInjector((2,)),
                          clock=lambda: t[0])
    be = register(cp, "seg", fn, proto, buckets=(1, 4, 16))
    set_costs(be, SEG_COSTS)
    rng = np.random.default_rng(5)
    rid = iter(range(100))

    def submit(priority, slo_ms=None):
        x = rng.uniform(-1, 1, proto.shape).astype(np.float32)
        return cp.submit(mod.ServeRequest(rid=next(rid), model="seg",
                                          payload=x, priority=priority,
                                          slo_ms=slo_ms))

    for i in range(5):
        submit("interactive", None if i % 2 else 1_000.0)
    for _ in range(3):
        submit("batch", 1_000.0)
    cp.pump()                                 # t = 0: still coalescing
    t[0] = 0.003
    cp.pump()                                 # max wait: launch 1
    t[0] = 0.004
    submit("interactive", 0.5)                # backlog blows it: rejected
    submit("interactive", 3.0)                # deadline 7 ms
    cp.pump()                                 # launch 2: the fault
    t[0] = 0.1                                # the 3 ms SLO expires
    for _ in range(4):
        submit("batch")
    cp.pump()                                 # starved batch first; shed
    t[0] = 0.2
    for i in range(6):
        submit("interactive" if i % 2 else "batch", 5_000.0)
    cp.run()
    return cp, be


def test_segnet_trace_same_decisions_and_answers_as_jax():
    jfn, tfn, proto = segnet_models()
    cp, be = seg_trace(tcp, tfault, tfn, proto)
    jcp_, jbe = seg_trace(jcp, jfault, jfn, proto)
    dec = decisions(cp)
    assert dec == decisions(jcp_)
    assert be.batcher.launches == jbe.batcher.launches
    # the trace exercised what it set out to
    assert dec["faults"][0]["launch"] == 2 and dec["faults"][0]["live"] > 0
    assert {s for _, s, _, _ in dec["requests"]} == {"served", "rejected",
                                                     "shed"}
    # the killed launch's requests were replayed once each; one of them
    # then expired in fake time and was shed
    replayed = [(rid, st_) for rid, st_, _, n in dec["requests"] if n]
    assert len(replayed) == dec["faults"][0]["live"]
    assert {st_ for _, st_ in replayed} == {"served", "shed"}
    assert dec["counts"]["queued"] == 0
    st, jst = cp.stats(), jcp_.stats()
    assert st["per_model"] == jst["per_model"]
    assert st["goodput_under_slo"] == jst["goodput_under_slo"]
    # class ids: both argmax logits that agree within 1e-5
    assert_outputs_equal(cp.results(), jcp_.results())


def lm_trace(mod, fault, lm):
    """A seeded LM trace: six prompts of mixed priority over two slots,
    a fault at decode step 3, a fake clock."""
    t = [0.0]
    cp = mod.ControlPlane(injector=fault.FailureInjector((3,)),
                          clock=lambda: t[0])
    be = register_lm(mod, cp, lm, slots=2, max_len=16)
    rng = np.random.default_rng(6)
    for i, (plen, new) in enumerate(((3, 4), (5, 2), (2, 5), (4, 3),
                                     (3, 3), (2, 4))):
        cp.submit(mod.ServeRequest(
            rid=i, model="lm", max_new=new,
            payload=rng.integers(0, lm[0].vocab_size, plen).astype(np.int32),
            priority="batch" if i % 3 == 1 else "interactive"))
        t[0] += 0.001
    cp.run()
    return cp, be


def test_lm_trace_same_decisions_and_tokens_as_jax(lm):
    cp, be = lm_trace(tcp, tfault, lm)
    jcp_, jbe = lm_trace(jcp, jfault, lm)
    dec = decisions(cp)
    assert dec == decisions(jcp_)
    assert dec["faults"][0]["launch"] == 3 and dec["faults"][0]["live"] > 0
    assert dec["counts"]["served"] == 6
    assert be.steps == jbe.steps
    assert_outputs_equal(cp.results(), jcp_.results())


def test_decode_step_same_bits_with_int_or_tensor_index(lm):
    """``gqa_decode`` and ``decode_step`` with the cache index as a Python
    int and as a 0-d int64 tensor: the same logits and caches, bit for
    bit."""
    _, tc, _, tp = lm
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tc.vocab_size, (2, 5))).long()
    caches = [ttfm.init_cache(tc, 2, 8, device="cpu") for _ in range(2)]
    for i in range(5):
        a, caches[0] = ttfm.decode_step(tp, caches[0], toks[:, i:i + 1], i,
                                        tc)
        b, caches[1] = ttfm.decode_step(tp, caches[1], toks[:, i:i + 1],
                                        torch.tensor(i), tc)
        assert torch.equal(a, b)
    for ca, cb in zip(*caches):
        for k in ca:
            assert torch.equal(ca[k], cb[k])
    from repro_torch.layers import attention as tattn
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 1, tc.d_model)).astype(np.float32))
    p = tp["layers"][0]["attn"]
    outs = []
    for idx in (3, torch.tensor(3)):
        cache = ttfm.init_cache_layer("global", tc, 2, 8, torch.float32,
                                      "cpu")
        outs.append(tattn.gqa_decode(p, x, cache, idx, tc))
    assert torch.equal(outs[0][0], outs[1][0])
    for k in ("k", "v"):
        assert torch.equal(outs[0][1][k], outs[1][1][k])
