"""The port's measured route autotuning (``repro_torch.core.autotune``),
case for case ``tests/test_autotune.py``: the timing loop, the candidate
sets (against JAX's, 'torch' for 'xla'; the 'cuda' kernels listed but not
timed on the CPU), the cache schema (against JAX's keys and the golden
fixture), every rung of the corruption ladder, the warm-cache zero-
measurement criterion, the hysteresis, tuned and forced-per-phase plans
against JAX's oracle and JAX's per-phase route on the same numpy inputs,
the batcher's bucket-cost persistence and the models threading the
policy."""
from __future__ import annotations

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.autotune as jat
import repro_torch.core.autotune as at
from repro.core import plan as jplan
from repro_torch.core import plan as tplan
from repro_torch.core.autotune import (SCHEMA, AutotunePolicy, RouteCache,
                                       Timing, candidate_routes,
                                       device_fingerprint, measure_bucket,
                                       measure_fn, route_from_json,
                                       route_label, route_to_json)
from repro_torch.core.plan import (BATCH_BUCKETS, ConvSpec, Route,
                                   plan_cache_clear, plan_conv)

from tests.conftest import TOL_FWD, TOL_GRAD, assert_close, oracle_transposed

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "route_table.json"

# a tiny transposed site: cheap, with the full transposed candidate set
# (fused_plane / fused_tap / taps / per_phase)
TINY = ConvSpec(kind="transposed", in_hw=(4, 4), in_c=4, out_c=4,
                kernel_hw=(3, 3), strides=(2, 2),
                padding=((1, 0), (1, 0)), backend="torch")
# fast measure policy for tests: one bucket, one timed iteration
FAST = dict(buckets=(1,), iters=1, warmup=0)
# the reference's names of the port's policies
JAX_BACKEND = {"torch": "xla", "cuda": "pallas"}


@pytest.fixture(autouse=True)
def _fresh_caches():
    plan_cache_clear()
    jplan.plan_cache_clear()
    yield
    plan_cache_clear()
    jplan.plan_cache_clear()


def tiny_spec(**kw):
    """A distinct tiny spec per test (vary in_c/out_c to dodge the
    in-process tuned-plan singleton across tests)."""
    return dataclasses.replace(TINY, **kw)


def jax_spec(spec: ConvSpec) -> jplan.ConvSpec:
    fields = dataclasses.asdict(spec)
    fields["backend"] = JAX_BACKEND[spec.backend]
    return jplan.ConvSpec(**fields)


def case(seed, b, spec):
    """Seeded numpy input and HWIO kernel for ``spec``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, *spec.in_hw, spec.in_c)).astype(np.float32)
    k = rng.standard_normal((*spec.kernel_hw, spec.in_c, spec.out_c)) \
        .astype(np.float32)
    return x, k


# ---------------------------------------------------------------------------
# timing loop
# ---------------------------------------------------------------------------

def test_measure_fn_min_le_median_and_iters():
    t = measure_fn(lambda x: x * 2.0, torch.ones((8, 8)), iters=5,
                   warmup=1)
    assert isinstance(t, Timing)
    assert 0.0 < t.min_s <= t.median_s
    assert t.iters == 5
    assert t.min_us == pytest.approx(t.min_s * 1e6)


def test_measure_route_is_the_shared_loop(monkeypatch):
    """Every candidate is timed by ``measure_fn`` (ONE implementation, as
    the reference's benches delegate to it), one counted run each."""
    seen = []

    def spy(fn, *args, iters, warmup):
        seen.append((iters, warmup))
        return Timing(1e-3, 1e-3, iters)

    monkeypatch.setattr(at, "measure_fn", spy)
    plan = plan_conv(tiny_spec(in_c=6))
    before = at.measure_calls()
    winner, timings = measure_bucket(plan, 1, AutotunePolicy(**FAST))
    assert len(seen) == len(timings) == at.measure_calls() - before >= 2
    assert set(seen) == {(1, 0)}
    assert winner == plan.route_for_batch(1)          # all tied


# ---------------------------------------------------------------------------
# candidate enumeration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_candidates_include_heuristic_and_per_phase(backend):
    spec = tiny_spec(backend=backend)
    plan = plan_conv(spec)
    jp = jplan.plan_conv(jax_spec(spec))
    for b in BATCH_BUCKETS:
        cands = candidate_routes(plan, b)
        labels = [route_label(r) for r in cands]
        assert len(labels) == len(set(labels))          # deduped
        assert plan.route_for_batch(b) in cands         # heuristic is in set
        assert any(r.path == "per_phase" for r in cands)
        assert all(r.batch == b for r in cands)
        # the plain routes are JAX's, in JAX's order
        jlabels = [route_label(r) for r in jat.candidate_routes(jp, b)]
        assert [lab for lab in labels if not lab.startswith("cuda")] == \
            [lab for lab in jlabels if not lab.startswith("pallas")]
        if backend == "cuda":
            # kernel A, and kernel D where the reference's tile search
            # fits a tile, as JAX lists its tiled Pallas candidate
            assert labels[0] == "cuda"
            assert any("@sp" in lab for lab in labels) == \
                any("@sp" in lab for lab in jlabels)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_candidates_single_kind_feasible_set(backend):
    spec = ConvSpec(kind="conv", in_hw=(8, 8), in_c=4, out_c=4,
                    kernel_hw=(3, 3), padding=((1, 1), (1, 1)),
                    backend=backend)
    plan = plan_conv(spec)
    cands = candidate_routes(plan, 1)
    paths = {r.path for r in cands}
    assert "taps" in paths and "fused_tap" in paths
    assert "per_phase" not in paths          # transposed-only executor
    assert plan.route_for_batch(1) in cands
    assert ("cuda" in paths) == (backend == "cuda")


def test_cuda_candidates_are_listed_but_not_timed_on_the_cpu(tmp_path):
    """A 'cuda' route on CPU tensors runs the kernel's plain version, so
    the bucket is not tuned, as JAX leaves Pallas in interpret mode."""
    spec = tiny_spec(in_c=12, backend="cuda")
    plan = plan_conv(spec)
    assert plan.route_for_batch(1).path == "cuda"
    before = at.measure_calls()
    winner, timings = measure_bucket(plan, 1, AutotunePolicy(**FAST))
    assert (winner, timings) == (plan.route_for_batch(1), {})
    tuned = plan_conv(spec, autotune=AutotunePolicy(
        mode="measure", cache_path=str(tmp_path / "c.json"), **FAST))
    assert at.measure_calls() == before
    assert tuned.routes == plan.routes
    assert not (tmp_path / "c.json").exists()        # nothing measured


# ---------------------------------------------------------------------------
# cache round-trip + corruption ladder
# ---------------------------------------------------------------------------

def test_cache_roundtrip_identical_routes(tmp_path):
    path = str(tmp_path / "c.json")
    spec = tiny_spec()
    routes = (Route(1, "per_phase", None),
              Route(4, "fused_plane", None),
              Route(16, "cuda", None, sp_tiles=(4, 4)),
              Route(64, "taps", None, fused_bwd=False))
    cache = RouteCache(path)
    for r in routes:
        cache.put(spec, r, {"taps": 1e-4})
    cache.save()
    fresh = RouteCache(path)
    assert fresh.loaded_from_disk
    for r in routes:
        assert fresh.get(spec, r.batch) == r            # exact Route tuples
    assert fresh.get(spec, 2) is None
    assert fresh.get(tiny_spec(in_c=8), 1) is None


def test_route_json_schema_matches_fixture():
    r = Route(4, "cuda", None, sp_tiles=(4, 4), fused_bwd=False)
    rj = route_to_json(r)
    assert set(rj) == {"batch", "path", "tiles", "sp_tiles", "fused_bwd",
                       "dev_tiles"}
    assert set(rj) == set(jat.route_to_json(jplan.Route(4, "pallas", None)))
    assert route_from_json(rj) == r
    dev = Route(16, "cuda", None, sp_tiles=(4, 4), dev_tiles=(2, 2))
    assert route_from_json(route_to_json(dev)) == dev
    # every record of the golden fixture reads back to itself, keys and
    # types; its 'xla'/'pallas' paths are the port's 'torch'/'cuda' ones
    table = json.loads(FIXTURE.read_text())
    for ent in table["entries"]:
        spec = jplan.ConvSpec(**{
            **{k: tuple(tuple(p) for p in v) if k == "padding"
               else tuple(v) if isinstance(v, list) else v
               for k, v in ent["spec"].items()},
            "backend": ent["backend"]})
        port = ConvSpec(**{**dataclasses.asdict(spec),
                           "backend": {"xla": "torch",
                                       "pallas": "cuda"}[ent["backend"]]})
        assert at.spec_to_json(port) == jat.spec_to_json(spec) \
            == ent["spec"]
        assert at.spec_key(port) == jat.spec_key(spec).replace(
            f":{ent['backend']}", f":{port.backend}")
        for rj in ent["routes"]:
            want = dict(rj, path="cuda" if rj["path"] == "pallas"
                        else rj["path"])
            back = route_to_json(route_from_json(want))
            assert back == want
            assert {k: type(v) for k, v in back.items()} == \
                {k: type(v) for k, v in want.items()}


@pytest.mark.parametrize("poison", ["corrupt", "truncated", "stale_schema",
                                    "bad_fingerprint", "malformed_entries"])
def test_cache_poison_warns_and_falls_back(tmp_path, poison):
    path = tmp_path / "c.json"
    good = {"schema": SCHEMA, "fingerprint": device_fingerprint(),
            "entries": {"k": {"spec": {}, "routes": {
                "1": route_to_json(Route(1, "taps", None))}}},
            "bucket_costs": {}}
    if poison == "corrupt":
        path.write_text("{this is not json")
    elif poison == "truncated":
        full = json.dumps(good)
        path.write_text(full[:len(full) // 2])
    elif poison == "stale_schema":
        path.write_text(json.dumps({**good, "schema": "huge2-route-cache/v0"}))
    elif poison == "bad_fingerprint":
        path.write_text(json.dumps(
            {**good, "fingerprint": {"platform": "mars"}}))
    elif poison == "malformed_entries":
        path.write_text(json.dumps(
            {**good, "entries": {"k": {"routes": {"1": {"batch": "NaN?"}}}}}))
    with pytest.warns(RuntimeWarning, match="falling back to heuristic"):
        cache = RouteCache(str(path))
    assert cache.entries == {} and not cache.loaded_from_disk
    assert cache.get(tiny_spec(), 1) is None
    cache.save()                                     # rewrites cleanly
    assert RouteCache(str(path)).fingerprint == device_fingerprint()


def test_fingerprint_keeps_the_packages_apart(tmp_path):
    """A cache the JAX package wrote is a foreign fingerprint to the port
    (warn, heuristic routes), and the port's default file is its own."""
    path = tmp_path / "c.json"
    jcache = jat.RouteCache(str(path))
    jcache.put(jax_spec(tiny_spec()), jplan.Route(1, "taps", None))
    jcache.save()
    with pytest.warns(RuntimeWarning, match="fingerprint mismatch"):
        cache = RouteCache(str(path))
    assert cache.entries == {}
    assert device_fingerprint()["platform"] == "cpu"
    assert at.CACHE_ENV == jat.CACHE_ENV and at.SCHEMA == jat.SCHEMA
    assert at.DEFAULT_CACHE != jat.DEFAULT_CACHE


def test_poisoned_cache_never_crashes_plan_build(tmp_path):
    path = tmp_path / "c.json"
    path.write_text("garbage")
    spec = tiny_spec(out_c=8)
    with pytest.warns(RuntimeWarning):
        plan = plan_conv(spec, autotune=AutotunePolicy(
            mode="cache", cache_path=str(path), **FAST))
    assert plan.routes == plan_conv(spec).routes     # heuristic fallback


# ---------------------------------------------------------------------------
# fallback ladder + warm-cache zero-measurement acceptance
# ---------------------------------------------------------------------------

def test_cache_mode_cold_is_heuristic_and_measures_nothing(tmp_path):
    spec = tiny_spec(in_c=8)
    before = at.measure_calls()
    plan = plan_conv(spec, autotune=AutotunePolicy(
        mode="cache", cache_path=str(tmp_path / "c.json"), **FAST))
    assert at.measure_calls() == before              # cold + cache-only
    assert plan.tuned
    assert plan.routes == plan_conv(spec).routes


def test_measure_mode_persists_then_warm_load_measures_zero(tmp_path):
    path = str(tmp_path / "c.json")
    spec = tiny_spec(in_c=8, out_c=8)
    policy = AutotunePolicy(mode="measure", cache_path=path, **FAST)

    before = at.measure_calls()
    plan1 = plan_conv(spec, autotune=policy)
    assert at.measure_calls() > before               # cold: measured
    raw = json.loads((tmp_path / "c.json").read_text())
    assert raw["schema"] == SCHEMA                   # file produced + valid
    assert raw["fingerprint"] == device_fingerprint()
    (ent,) = raw["entries"].values()
    assert "1" in ent["routes"]
    assert "measured_us" in ent["routes"]["1"]

    plan_cache_clear()                               # simulate a restart
    before = at.measure_calls()
    plan2 = plan_conv(spec, autotune=policy)
    assert at.measure_calls() == before              # warm: ZERO runs
    assert plan2.routes == plan1.routes
    assert plan2.tuned


def test_untuned_buckets_keep_heuristic_routes(tmp_path):
    spec = tiny_spec(kernel_hw=(5, 5), padding=((2, 1), (2, 1)))
    heur = plan_conv(spec)
    plan = plan_conv(spec, autotune=AutotunePolicy(
        mode="measure", cache_path=str(tmp_path / "c.json"), buckets=(1,),
        iters=1, warmup=0))
    for b in BATCH_BUCKETS[1:]:
        assert plan.route_for_batch(b) == heur.route_for_batch(b)


def test_min_gain_hysteresis(monkeypatch):
    spec = tiny_spec(in_c=16)
    plan = plan_conv(spec)
    heur = plan.route_for_batch(1)

    def fake_measure(plan_, route, x, packed, *, iters, warmup):
        # challenger 2% faster than the heuristic: inside min_gain=1.03
        t = 1.00e-3 if route == heur else 0.98e-3
        return Timing(t, t, iters)

    monkeypatch.setattr(at, "measure_route", fake_measure)
    winner, timings = measure_bucket(plan, 1, AutotunePolicy(**FAST))
    assert winner == heur                            # tie stays heuristic
    assert timings[route_label(heur)] == pytest.approx(1.00e-3)

    def fake_measure_big(plan_, route, x, packed, *, iters, warmup):
        t = 1.00e-3 if route == heur else 0.50e-3    # 2x: a real flip
        return Timing(t, t, iters)

    monkeypatch.setattr(at, "measure_route", fake_measure_big)
    winner, _ = measure_bucket(plan, 1, AutotunePolicy(**FAST))
    assert winner != heur


@pytest.mark.parametrize("median,flips", [(0.99e-3, False),
                                          (0.90e-3, True)])
def test_min_gain_needs_the_challengers_median(monkeypatch, median, flips):
    """A challenger whose best run is twice as fast flips the bucket only
    when its median run also beats the heuristic's best by min_gain: one
    lucky run inside the spread is not a win."""
    spec = tiny_spec(in_c=16)
    plan = plan_conv(spec)
    heur = plan.route_for_batch(1)

    def fake_measure(plan_, route, x, packed, *, iters, warmup):
        if route == heur:
            return Timing(1.00e-3, 1.00e-3, iters)
        return Timing(0.50e-3, median, iters)

    monkeypatch.setattr(at, "measure_route", fake_measure)
    winner, timings = measure_bucket(plan, 1, AutotunePolicy(**FAST))
    assert (winner != heur) == flips
    assert min(timings.values()) == pytest.approx(0.50e-3)


# ---------------------------------------------------------------------------
# tuned plans stay correct: forward + backward against JAX
# ---------------------------------------------------------------------------

def _grads_vs_oracle(plan, spec, x, k):
    """The port's (y, dx, dK) through ``plan`` and JAX's oracle values."""
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    y = plan.apply(xt, plan.pack(kt))
    gx, gk = torch.autograd.grad(y.sum(), [xt, kt])

    def oracle(a, w):
        return oracle_transposed(a, w, strides=spec.strides,
                                 padding=spec.padding)

    want = oracle(jnp.asarray(x), jnp.asarray(k))
    ox, ok = jax.grad(lambda a, w: oracle(a, w).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(k))
    return (y.detach(), gx, gk), (want, ox, ok)


def test_autotuned_plan_oracle_parity():
    spec = tiny_spec(in_hw=(6, 6))
    plan = plan_conv(spec, autotune=AutotunePolicy(
        mode="measure", cache_path="", **FAST))      # memory-only
    assert plan.tuned
    x, k = case(0, 1, spec)
    (y, gx, gk), (want, ox, ok) = _grads_vs_oracle(plan, spec, x, k)
    assert_close(y, want)
    assert_close(gx, ox, TOL_GRAD)
    assert_close(gk, ok, TOL_GRAD)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("wdtype", ["float32", "int8"])
@pytest.mark.parametrize("batch", [1, 3])
def test_forced_per_phase_route_parity(batch, wdtype, backend):
    """The forced 'per_phase' route against JAX's forced 'per_phase' on
    JAX's superpack (f32 and int8; on 'cuda' each phase is kernel B's
    plain version on the CPU, where JAX's 'pallas' one runs its Pallas
    kernel in interpret mode), and its gradients against the oracle."""
    spec = tiny_spec(in_hw=(8, 8), backend=backend, wdtype=wdtype)
    base = plan_conv(spec)
    plan = base.with_routes(tuple(
        Route(r.batch, "per_phase", None, fused_bwd=r.fused_bwd)
        for r in base.routes))
    jbase = jplan.plan_conv(jax_spec(spec))
    jforced = jbase.with_routes(tuple(
        jplan.Route(r.batch, "per_phase", None, fused_bwd=r.fused_bwd)
        for r in jbase.routes))
    x, k = case(1, batch, spec)
    jpacked = jbase.pack(jnp.asarray(k))
    want = np.asarray(jforced.apply(jnp.asarray(x), jpacked))
    packed = tplan.QuantizedSuperpack(
        torch.from_numpy(np.array(jpacked.q)),
        torch.from_numpy(np.array(jpacked.scale))) \
        if wdtype == "int8" else torch.from_numpy(np.array(jpacked))
    got = plan.apply(torch.from_numpy(x), packed)
    assert_close(got, want, TOL_FWD)
    assert_close(plan.apply_per_phase(torch.from_numpy(x), packed), want,
                 TOL_FWD)
    if wdtype == "float32":
        (y, gx, gk), (oy, ox, ok) = _grads_vs_oracle(plan, spec, x, k)
        assert_close(y, oy)
        assert_close(gx, ox, TOL_GRAD)
        assert_close(gk, ok, TOL_GRAD)


# ---------------------------------------------------------------------------
# serving: bucket-cost persistence through the same cache file
# ---------------------------------------------------------------------------

def test_batcher_bucket_costs_persist_and_skip_remeasure(tmp_path):
    from repro_torch.serving.image_batcher import DynamicImageBatcher

    path = str(tmp_path / "c.json")
    serve = lambda x: x * 2.0                        # noqa: E731
    proto = np.zeros((3,), np.float32)

    cache = RouteCache(path)
    b1 = DynamicImageBatcher(serve, buckets=(1, 4), cache=cache,
                             cache_key="m", device="cpu")
    assert b1.warmup(proto) == (1, 4)                # cold: both timed
    assert set(b1.bucket_cost_s) == {1, 4}

    cache2 = RouteCache(path)                        # restarted server
    assert cache2.loaded_from_disk
    b2 = DynamicImageBatcher(serve, buckets=(1, 4), cache=cache2,
                             cache_key="m", device="cpu")
    assert set(b2.bucket_cost_s) == {1, 4}           # preloaded
    assert b2.warmup(proto) == ()                    # runs, times none
    assert b2.bucket_cost_s == pytest.approx(b1.bucket_cost_s)
    assert b2.warmup(proto, force=True) == (1, 4)    # explicit re-measure


def test_batcher_foreign_cache_key_measures(tmp_path):
    from repro_torch.serving.image_batcher import DynamicImageBatcher

    cache = RouteCache(str(tmp_path / "c.json"))
    cache.put_bucket_costs("other-model", {1: 1.0})
    b = DynamicImageBatcher(lambda x: x, buckets=(1,), cache=cache,
                            cache_key="mine", device="cpu")
    assert b.bucket_cost_s == {}                     # keys don't bleed
    assert b.warmup(np.zeros((2,), np.float32)) == (1,)


def test_serve_dcgan_warm_cache_retimes_nothing(tmp_path):
    """``serve_dcgan --autotune measure`` fills the route cache; a second
    run with ``--autotune cache`` measures no route and times no bucket,
    and serves the same rows."""
    from repro_torch import serve_dcgan

    argv = ["--device", "cpu", "--backend", "torch", "--small",
            "--requests", "5", "--route-cache", str(tmp_path / "c.json")]
    first = serve_dcgan.main(argv + ["--autotune", "measure"])
    assert first["warmup_timed"] == BATCH_BUCKETS
    plan_cache_clear()                               # a restarted server
    before = at.measure_calls()
    second = serve_dcgan.main(argv + ["--autotune", "cache"])
    assert at.measure_calls() == before
    assert second["warmup_timed"] == ()
    outs = {r.rid: r.out for r in second["requests"]}
    for r in first["requests"]:
        assert_close(outs[r.rid], r.out)


# ---------------------------------------------------------------------------
# model zoo threads the policy
# ---------------------------------------------------------------------------

def test_models_thread_policy_to_plans():
    from repro_torch.models import gan, segnet, unet, vae

    policy = AutotunePolicy(mode="cache", cache_path="", **FAST)
    g = gan.GANConfig("t", (gan.DeconvLayer(4, 8, 4, 3, 2),),
                      autotune=policy)
    s = dataclasses.replace(segnet.SEGNET_TINY, autotune=policy)
    v = dataclasses.replace(vae.VAE_TINY, autotune=policy)
    u = dataclasses.replace(unet.UNET_TINY, autotune=policy)
    before = at.measure_calls()
    for plans in (gan.generator_plans(g), gan.discriminator_plans(g),
                  segnet.segnet_plans(s), vae.vae_plans(v),
                  tuple(unet.unet_plans(u).values())):
        assert plans and all(p.tuned for p in plans)
    assert at.measure_calls() == before              # cache-mode: zero runs
    assert not any(p.tuned for p in gan.generator_plans(
        gan.GANConfig("t2", g.layers)))              # None policy: untouched
