"""``launch.hlo_analysis``: one rank's step counted on fake tensors, held
to the model's FLOPs, the kernels' work formulas and a real run's
collectives, on reduced configs (their head dim raised to 32, kernel F's
least, where it is 16) and with no card:

- reduced llama3.2-1b's teacher-forced forward (a prefill that reads out
  every position, as JAX's prefill step): the counted products equal
  ``roofline.model_flops_for`` exactly, kernel F launches once an
  attention layer with 4·D·pairs FLOPs;
- the DCGAN generator and discriminator on the 'cuda' route: kernel A's
  and B's launches at every site, with 2·B·(Σ U·V·T)·C·N and
  2·B·OH·OW·taps·C·N FLOPs;
- reduced dbrx-132b: the MoE's counts set to the balanced load, and the
  counted products equal ``model_flops_for``;
- a fake world of 4: each collective's ring traffic against hand values;
  a row-parallel site on kernel C (its launch walks the whole K) and a
  weight gathered over the batch axis (its gather and, in the backward,
  its reduce-scatter), launches, work and collective bytes exactly;
- the (2, 2) forward of reduced llama3.2-1b over 4 real gloo ranks: rank
  0's ``comm.traffic()`` calls and bytes per kind equal its count on a
  fake world of 4;
- no kernel entry builds or launches on a fake tensor (``_build.build``
  and ``_build.load`` patched to raise; the launch counters do not move),
  and no real tensor takes the fake
  branch (a CPU tensor runs the plain version, a real 'meta' one raises);
- ``fake_world`` leaves no default group behind, also after an
  exception, and refuses to start inside one."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import comm
from repro_torch.kernels import fake
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import untangled_conv as uc
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (make_host_mesh, one_rank_world_end,
                                     run_spmd)
from repro_torch.launch.steps import make_dist
from repro_torch.models import gan
from repro_torch.models import transformer as tfm

WORLD = 4
LM_BATCH = (4, 16)


def _cfg(arch):
    """The reduced config of ``arch``, its head dim one kernel F takes."""
    cfg = registry.get_reduced(arch)
    return dataclasses.replace(cfg, head_dim=max(cfg.head_dim, 32))


def _fake(tree):
    return tfm._map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device=ha.DEVICE), tree)


class _Launches:
    """A sink of every fake launch: (kernel, FLOPs, bytes)."""

    def __init__(self):
        self.calls = []

    def kernel(self, name, flops, nbytes):
        self.calls.append((name, flops, nbytes))

    def note(self, key, value):
        pass


@pytest.fixture(autouse=True)
def _no_world():
    one_rank_world_end()
    yield
    assert not tdist.is_initialized()


def _attention_layers(cfg):
    return sum(1 for k in tfm.layer_kinds(cfg) if k not in ("ssd", "rec"))


def test_llama_prefill_products_equal_model_flops():
    cfg = _cfg("llama3.2-1b")
    b, s = LM_BATCH
    with ha.fake_mode():
        params = _fake(tfm.param_shapes(cfg))
        batch = {"inputs": torch.empty((b, s), dtype=torch.int32,
                                       device=ha.DEVICE)}
    r = ha.analyze_step(lambda p, x: tfm.forward(p, x, cfg, kv_chunk=8),
                        params, batch)
    assert r["product_flops"] == rl.model_flops_for(
        cfg, ShapeConfig("p", "prefill", s, b))
    layers = _attention_layers(cfg)
    f = r["kernels"]["F"]
    assert set(r["kernels"]) == {"F"}
    assert f["launches"] == layers
    h, d = cfg.num_heads, cfg.head_dim
    assert f["flops"] == layers * 4 * d * b * h * s * (s + 1) // 2
    assert r["flops"] == r["product_flops"] + f["flops"]
    assert r["moe_load"] is None and r["num_collectives"] == 0
    assert tuple(r["out"].shape) == (b, s, cfg.vocab_size)
    assert r["peak_bytes"] == r["input_bytes"] + r["peak_activation_bytes"]
    assert r["peak_activation_bytes"] >= 4 * b * s * cfg.vocab_size


def test_f_pairs_formula():
    """``pairs_per_head`` against a count over the masks themselves."""
    for sq, sk, causal, window, q_off in ((7, 7, True, 0, 0),
                                          (5, 9, True, 3, 4),
                                          (6, 4, False, 0, 0),
                                          (6, 10, False, 2, 3),
                                          (1, 33, True, 0, 32)):
        qp = q_off + np.arange(sq)[:, None]
        kp = np.arange(sk)[None, :]
        m = np.ones((sq, sk), bool)
        if causal:
            m &= qp >= kp
        if window:
            m &= qp - kp < window
        assert fa.pairs_per_head(sq, sk, causal, window, q_off) == m.sum()


def test_dcgan_sites_on_kernels_a_and_b():
    cfg = dataclasses.replace(gan.DCGAN, backend="cuda")
    b = 2
    gp = gan.generator_init(0, cfg, device="cpu")
    dp = gan.discriminator_init(0, cfg, device="cpu")
    with ha.fake_mode():
        gp, dp = _fake(gp), _fake(dp)
        z = torch.empty((b, cfg.z_dim), device=ha.DEVICE)
    sink = _Launches()
    with fake.recording(sink):
        rg = ha.analyze_step(lambda p, z: gan.generator_apply(p, z, cfg),
                             gp, z)
        rd = ha.analyze_step(lambda p, x: gan.discriminator_apply(p, x, cfg),
                             dp, rg["out"])
    want = []
    for plan, l in zip(gan.generator_plans(cfg), cfg.layers):
        pix_taps = sum(ex.out_hw[0] * ex.out_hw[1] * ex.taps[0] * ex.taps[1]
                       for ex in plan.phases)
        assert pix_taps * l.stride ** 2 == (l.in_hw * l.stride) ** 2 \
            * l.kernel ** 2
        want.append(("A", 2 * b * pix_taps * l.in_c * l.out_c))
    for l in reversed(cfg.layers):
        want.append(("B", 2 * b * l.in_hw ** 2 * l.kernel ** 2 * l.out_c
                     * l.in_c))
    assert [(k, f) for k, f, _ in sink.calls] == want
    assert rg["kernels"]["A"]["launches"] == len(cfg.layers)
    assert rd["kernels"]["B"]["launches"] == len(cfg.layers)
    assert rg["kernels"]["A"]["flops"] == sum(f for k, f in want if k == "A")
    assert rd["kernels"]["B"]["flops"] == sum(f for k, f in want if k == "B")


def test_dbrx_moe_balanced_load():
    from repro_torch.layers import moe
    with ha.fake_mode():
        for n, e in ((64, 4), (30, 4), (7, 16)):
            counts = moe._expert_counts(torch.empty(n, dtype=torch.int64,
                                                    device=ha.DEVICE), e)
            assert sum(counts) == n and max(counts) - min(counts) <= 1
            assert counts == sorted(counts, reverse=True)
    real = torch.tensor([0, 3, 3, 1])
    assert moe._expert_counts(real, 4) == [1, 1, 0, 2]
    cfg = _cfg("dbrx-132b")
    assert cfg.moe_impl == "dense"
    b, s = 2, 12
    with ha.fake_mode():
        params = _fake(tfm.param_shapes(cfg))
        batch = {"inputs": torch.empty((b, s), dtype=torch.int32,
                                       device=ha.DEVICE)}
    r = ha.analyze_step(lambda p, x: tfm.forward(p, x, cfg, kv_chunk=4),
                        params, batch)
    assert r["moe_load"] == "balanced"
    assert r["product_flops"] == rl.model_flops_for(
        cfg, ShapeConfig("p", "prefill", s, b))


def test_ring_bytes_on_a_fake_world_of_4():
    from repro_torch.core.comm import _send_recv
    with ha.fake_world(WORLD):
        g4 = tdist.new_group([0, 1, 2, 3])
        g2 = tdist.new_group([0, 1])
        with ha.fake_mode():
            t = torch.empty((8, 16), device=ha.DEVICE)       # 512 bytes
            buf = torch.empty((8, 16), device=ha.DEVICE)

        def step(t, buf):
            comm.all_reduce(t, g4, kind="ar")
            comm.all_gather(t, g4, 0, kind="ag")
            comm.reduce_scatter(t, g4, 0, kind="rs")
            comm.all_to_all(t, g4, kind="a2a")
            comm.broadcast(t, 0, g2, kind="bc")
            comm.all_reduce(t, g2, kind="ar")
            _send_recv([(t, 1)], [(buf, 1)], g2)
        r = ha.analyze_step(step, t, buf, default_group=WORLD)
    assert r["coll_per_kind"] == {
        "all-reduce": 2 * 512 * 3 / 4 + 2 * 512 * 1 / 2,
        "all-gather": 4 * 512 * 3 / 4,
        "reduce-scatter": 128 * 3.0,
        "all-to-all": 512 * 3 / 4,
        "collective-permute": 512.0 + 512.0}
    assert r["num_collectives"] == 7
    c = r["collectives"]
    assert c["ar"]["calls"] == 2 and c["ar"]["bytes"] == 1024
    assert c["ar"]["sizes"] == {4: 512, 2: 512}
    assert c["halo_exchange"]["op"] == "send_recv"
    assert comm.traffic() == {} or "ar" not in comm.traffic()


def _llama_2x2(dist, params, cfg, batch):
    with torch.no_grad():
        return tfm.forward(params, batch, cfg, dist, kv_chunk=8)


def _traffic_rank(rank, world, dev):
    """Reduced llama3.2-1b's forward on a (2, 2) mesh of real gloo ranks:
    this rank's ``comm.traffic()`` calls and bytes per kind."""
    torch.set_num_threads(1)
    cfg = _cfg("llama3.2-1b")
    b, s = LM_BATCH
    dist = make_dist(make_host_mesh(2, 2), cfg,
                     ShapeConfig("p", "prefill", s, b))
    params = tfm.init(cfg, seed=0, device="cpu", dist=dist)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    comm.traffic_reset()
    _llama_2x2(dist, params, cfg, {"inputs": toks})
    return {k: (v["calls"], v["bytes"]) for k, v in comm.traffic().items()}


def test_counted_collectives_equal_gloo_ranks():
    ranks = run_spmd(_traffic_rank, WORLD, device="cpu", timeout=240)
    cfg = _cfg("llama3.2-1b")
    b, s = LM_BATCH
    with ha.fake_world(WORLD, rank=0):
        dist = make_dist(make_host_mesh(2, 2), cfg,
                         ShapeConfig("p", "prefill", s, b))
        with ha.fake_mode():
            params = dist.shard_params(_fake(tfm.param_shapes(cfg)),
                                       tfm.specs(cfg))
            batch = {"inputs": torch.empty((b, s), dtype=torch.int32,
                                           device=ha.DEVICE)}
        r = ha.analyze_step(_llama_2x2, dist, params, cfg, batch,
                            default_group=WORLD)
    counted = {k: (v["calls"], v["bytes"])
               for k, v in r["collectives"].items()}
    assert counted and counted == ranks[0]
    assert r["coll_total"] == pytest.approx(sum(
        v["ring_bytes"] for v in r["collectives"].values()), rel=1e-12)


def test_fake_launches_never_build(monkeypatch):
    from repro_torch.kernels import _build

    def refuse(*a, **k):
        raise AssertionError("a kernel build was reached")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    for entry in (fa._entry, uc._entry, uc._conv_entry, uc._conv_tiled_entry,
                  uc._deconv_tiled_entry):
        entry.cache_clear()
    before = (fa.flash_attention.launches, uc.untangled_deconv2d.launches,
              uc.untangled_conv2d_superpack.launches)
    cfg = dataclasses.replace(gan.CGAN, backend="cuda")
    with ha.fake_mode():
        gp = _fake(gan.generator_init(0, cfg, device="cpu"))
        z = torch.empty((2, cfg.z_dim), device=ha.DEVICE)
        q = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16,
                        device=ha.DEVICE)
        x = torch.empty((2, 9, 9, 4), device=ha.DEVICE)
        sp = torch.empty((36, 8), device=ha.DEVICE)
    r = ha.analyze_step(lambda p, z: gan.generator_apply(p, z, cfg), gp, z)
    r2 = ha.analyze_step(lambda q: fa.flash_attention(q, q, q), q)
    r3 = ha.analyze_step(lambda x, sp: (
        uc.untangled_conv2d_superpack(x, sp, taps_hw=(3, 3)),
        uc.untangled_conv2d_superpack(x, sp, taps_hw=(3, 3),
                                      sp_tiles=(4, 4))), x, sp)
    assert r["kernels"]["A"]["launches"] == len(cfg.layers)
    assert r2["kernels"]["F"]["launches"] == 1
    assert r3["kernels"]["B"]["launches"] == 1
    assert r3["kernels"]["C"]["launches"] == 1
    assert r3["kernels"]["C"]["flops"] == 2 * 2 * 7 * 7 * 36 * 8
    # nothing launched: the counters stay where they were
    assert (fa.flash_attention.launches, uc.untangled_deconv2d.launches,
            uc.untangled_conv2d_superpack.launches) == before


def test_split_sites_on_a_fake_world_of_4():
    """(2, 2), rank 0.  A conv site whose route picks kernel C with its
    rows on 'model' (rows [0, 36) of 72): one C launch on the row block
    that walks all R·S·C rows (2·B·OH·OW·72·N FLOPs) and reads the padded
    plane, the block and the output once, and one all-reduce of the f32
    partial.  A transposed site with its rows on 'data', which carries the
    batch: the block (64 of 128 rows) gathered whole, one kernel A launch
    on the whole superpack, and in the backward its gradient
    reduce-scattered (the whole dK handed over, the block kept)."""
    from repro_torch.core.plan import ConvSpec, RowSuperpack, plan_conv
    from repro_torch.sharding import DEFAULT_RULES, SUPERPACK_SPEC, DistContext
    b = 2
    conv = plan_conv(ConvSpec(kind="conv", in_hw=(16, 16), in_c=8, out_c=8,
                              kernel_hw=(3, 3), padding=((1, 1), (1, 1)),
                              backend="cuda"))
    conv = conv.with_routes(tuple(dataclasses.replace(r, sp_tiles=(8, 8))
                                  for r in conv.routes))
    deconv = plan_conv(ConvSpec(kind="transposed", in_hw=(4, 4), in_c=8,
                                out_c=8, kernel_hw=(4, 4), strides=(2, 2),
                                padding=((1, 3), (1, 3)), backend="cuda"))
    with ha.fake_world(WORLD, rank=0):
        mesh = make_host_mesh(2, 2)
        rows = DistContext(mesh, rules=dict(DEFAULT_RULES, conv_taps="model",
                                            conv_out=None))
        batch = DistContext(mesh, rules=dict(DEFAULT_RULES, conv_taps="data",
                                             conv_out=None))
        with ha.fake_mode():
            x = torch.empty((b, 16, 16, 8), device=ha.DEVICE)
            xd = torch.empty((b, 4, 4, 8), device=ha.DEVICE)
            wc = rows.shard_params(
                {"w": torch.empty((72, 8), device=ha.DEVICE)},
                {"w": SUPERPACK_SPEC})["w"]
            wd = batch.shard_params(
                {"w": torch.empty((128, 8), device=ha.DEVICE)},
                {"w": SUPERPACK_SPEC})["w"]
        assert isinstance(wc, RowSuperpack) and wc.rows == (0, 36)
        assert isinstance(wd, RowSuperpack) and wd.batch == {"data"}
        rc = ha.analyze_step(lambda x, w: conv.apply(x, w), x, wc,
                             default_group=WORLD)

        def step(x, blk):
            blk = blk.requires_grad_()
            y = deconv.apply(x, dataclasses.replace(wd, block=blk))
            return torch.autograd.grad(y.sum(), blk)[0]
        rd = ha.analyze_step(step, xd, wd.block, default_group=WORLD)
    c = rc["kernels"]
    assert set(c) == {"C"} and c["C"]["launches"] == 1
    assert c["C"]["flops"] == 2 * b * 16 * 16 * 72 * 8
    assert c["C"]["bytes"] == 4 * (b * 18 * 18 * 8 + 36 * 8 + b * 16 * 16 * 8)
    assert {k: (v["calls"], v["bytes"]) for k, v in
            rc["collectives"].items()} == {
        "rows_all_reduce": (1, 4 * b * 16 * 16 * 8)}
    pix_taps = sum(ex.out_hw[0] * ex.out_hw[1] * ex.taps[0] * ex.taps[1]
                   for ex in deconv.phases)
    assert rd["kernels"]["A"]["launches"] == 1
    assert rd["kernels"]["A"]["flops"] == 2 * b * pix_taps * 8 * 8
    assert {k: (v["op"], v["calls"], v["bytes"]) for k, v in
            rd["collectives"].items()} == {
        "rows_weight_gather": ("all_gather", 1, 4 * 64 * 8),
        "rows_weight_gather_bwd": ("reduce_scatter", 1, 4 * 128 * 8)}
    assert tuple(rd["out"].shape) == (64, 8)


def test_real_tensors_never_take_the_fake_branch():
    sink = _Launches()
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 2, 32), generator=g)
    x = torch.randn((2, 9, 9, 4), generator=g)
    sp = torch.randn((36, 8), generator=g)
    before = (fa.flash_attention.launches,
              uc.untangled_conv2d_superpack.launches)
    with fake.recording(sink):
        y = fa.flash_attention(q, q, q)
        yc = uc.untangled_conv2d_superpack(x, sp, taps_hw=(3, 3))
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
        with pytest.raises(ValueError, match="CUDA"):
            uc.untangled_conv2d_superpack(x.to("meta"), sp.to("meta"),
                                          taps_hw=(3, 3))
    assert sink.calls == []
    assert before == (fa.flash_attention.launches,
                      uc.untangled_conv2d_superpack.launches)
    torch.testing.assert_close(y, fa.flash_attention_plain(q, q, q))
    torch.testing.assert_close(yc, uc.untangled_conv2d_superpack_ref(
        x, sp, taps_hw=(3, 3)))


def test_fake_world_leaves_no_group():
    with ha.fake_world(WORLD, rank=2):
        assert tdist.get_world_size() == WORLD and tdist.get_rank() == 2
        make_host_mesh(2, 2)
    assert not tdist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with ha.fake_world(WORLD):
            make_host_mesh(2, 2)
            1 / 0
    assert not tdist.is_initialized()
    make_host_mesh(1, 1)                       # a one-rank world
    try:
        with pytest.raises(RuntimeError, match="default process group"):
            with ha.fake_world(WORLD):
                pass
        assert tdist.get_world_size() == 1
    finally:
        one_rank_world_end()
    assert not tdist.is_initialized()
