"""The port's training runtime against the JAX package on the CPU: one
``make_train_step`` step with AdamW and one with Adafactor, each with and
without ``grad_accum = 2`` (loss, global norm, each tensor's update
(new - old) within TOL_GRAD of its largest, AdamW's moments), the same
gradients with and without ``remat``, Adafactor's
factored state, the global-norm clipping and the learning-rate schedule;
the checkpoint manager (the cases of ``tests/test_runtime.py``: round trip,
keep-k GC and ``latest``, the async writer, the dtype cast on restore;
plus a state tree of the port's kind, bf16 params and an optimiser
state, restored bit for bit), the token pipelines (batches bit-equal to
JAX's for a seed and a step, the stub embeddings and an
encoder-decoder's source frames included), the ``Prefetcher``'s order,
and ``launch.train.train``: a run killed at ``fail_at`` resumes from its
checkpoint to the last step with the losses of an uninterrupted run, bit
for bit (the CPU is deterministic)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optim as jopt
from repro.train import schedule as jsched
from repro_torch import lm_train
from repro_torch.configs import registry as tregistry
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.train import data as tdata
from repro_torch.train import optim as topt
from repro_torch.train import schedule as tsched
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.tree import tree_leaves, tree_paths
from tests.test_torch_lm_families import port_params
from tests.test_torch_lm_train import (TOL_GRAD, TOL_LOSS, jparams32,
                                       lm_batch, port_layout)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the train step and the optimisers
# ---------------------------------------------------------------------------

def assert_trees_close(got, want, tol, what, base=None):
    """Each leaf within ``tol`` of its own scale; with ``base``, the
    differences from ``base``'s leaves (a step's updates) instead."""
    base = tree_paths(base) if base is not None else None
    for i, ((k, a), (k2, b)) in enumerate(zip(tree_paths(got),
                                              tree_paths(want))):
        assert k == k2
        a, b = a.float().numpy(), b.float().numpy()
        if base is not None:
            a, b = a - base[i][1].float().numpy(), b - base[i][1].float().numpy()
        err = float(np.abs(a - b).max())
        assert err <= tol * float(np.abs(b).max()) + 1e-30, \
            f"{what} {k}: {err:.3e} of max {float(np.abs(b).max()):.3e}"



@pytest.mark.parametrize("opt,accum", [("adamw", 1), ("adamw", 2),
                                       ("adafactor", 1), ("adafactor", 2)])
def test_train_step_matches_jax(opt, accum):
    arch = "llama3.2-1b" if opt == "adamw" else "dbrx-132b"
    jc, tc = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    jp = jparams32(arch)
    ocfg = (dict(name="adamw", lr=3e-4, eps=1e-3) if opt == "adamw"
            else dict(name="adafactor", lr=1e-4))
    jo, to_ = jopt.OptConfig(**ocfg), topt.OptConfig(**ocfg)
    want = dataclasses.asdict(jsteps.opt_config_for(jc))
    assert want == dataclasses.asdict(tsteps.opt_config_for(tc))
    bt = lm_batch(arch, b=4, s=8)
    jinit, _ = jopt.OPTIMIZERS[opt]
    jstate = {"params": jp, "opt": jinit(jp, None, None, jo)[0],
              "step": jnp.zeros((), jnp.int32)}
    jnew, jm = jax.jit(jsteps.make_train_step(jc, None, jo,
                                              grad_accum=accum, kv_chunk=8))(
        jstate, jax.tree.map(jnp.asarray, bt))
    tp = port_params(arch, jp)
    tinit, _ = topt.OPTIMIZERS[opt]
    tstate = {"params": tp, "opt": tinit(tp, to_,
                                         ttfm.param_stacks(tc, tp)),
              "step": torch.zeros((), dtype=torch.int32)}
    tnew, tm = tsteps.make_train_step(tc, to_, grad_accum=accum,
                                      kv_chunk=8)(tstate, bt)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        TOL_LOSS * abs(float(jm["loss"]))
    assert abs(float(tm["gnorm"]) - float(jm["gnorm"])) <= \
        1e-4 * float(jm["gnorm"])
    assert int(tnew["step"]) == 1 and int(tnew["opt"]["step"]) == 1
    assert_trees_close(tnew["params"], port_layout(arch, jnew["params"]),
                       TOL_GRAD, "update", base=tp)
    if opt == "adamw":
        for key in ("m", "v"):
            assert_trees_close(tnew["opt"][key],
                               port_layout(arch, jnew["opt"][key]),
                               TOL_GRAD, key)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-large-v2"])
def test_remat_gives_the_same_gradients(arch):
    """``remat=True`` (each layer recomputed in the backward) and
    ``remat=False``: the same loss and gradients, bit for bit."""
    tc = tregistry.get_reduced(arch)
    bt = tsteps.batch_to(lm_batch(arch), "cpu")
    out = []
    for remat in (False, True):
        tp = port_params(arch, jparams32(arch))
        leaves = [t.requires_grad_() for t in tree_leaves(tp)]
        loss = ttfm.loss_fn(tp, bt, tc, kv_chunk=8, remat=remat)
        out.append([loss] + list(torch.autograd.grad(loss, leaves,
                                                     allow_unused=True)))
    for a, b in zip(*out):
        assert (a is None and b is None) or torch.equal(a, b)


def test_adafactor_state_matches_jax():
    """Adafactor's factored (vr, vc) and unfactored (v) second moments
    after one update of the same params and grads."""
    rng = np.random.default_rng(55)
    shapes = {"w": (12, 10), "b": (10,), "e": (3, 9, 8), "thin": (4, 16)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) * 3
         for k, s in shapes.items()}
    cfg = dict(name="adafactor", lr=1e-2)
    jstate = jopt.adafactor_init(jax.tree.map(jnp.asarray, p))[0]
    jp, js, jn = jax.jit(lambda g, s, p: jopt.adafactor_update(
        g, s, p, jopt.OptConfig(**cfg)))(jax.tree.map(jnp.asarray, g),
                                         jstate, jax.tree.map(jnp.asarray, p))
    tparams = {k: torch.from_numpy(v) for k, v in p.items()}
    tp, ts, tn = topt.adafactor_update(
        {k: torch.from_numpy(v) for k, v in g.items()},
        topt.adafactor_init(tparams), tparams, topt.OptConfig(**cfg))
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
        assert sorted(ts["f"][k]) == sorted(js["f"][k])
        for s in js["f"][k]:
            np.testing.assert_allclose(ts["f"][k][s].numpy(),
                                       np.asarray(js["f"][k][s]), rtol=1e-5)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(56)
    g = {"a": rng.standard_normal((5, 4)).astype(np.float32),
         "b": [rng.standard_normal((3,)).astype(np.float32)]}
    for max_norm in (0.5, 100.0):
        jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                          max_norm)
        tg, tn = topt.clip_by_global_norm(
            {"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"][0])]},
            max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        np.testing.assert_allclose(tg["a"].numpy(), np.asarray(jg["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tg["b"][0].numpy(),
                                   np.asarray(jg["b"][0]), rtol=1e-6)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(kind):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100, kind=kind)
    jc, tc = jsched.ScheduleConfig(**kw), tsched.ScheduleConfig(**kw)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 250):
        want = float(jsched.lr_at(step, jc))
        assert float(tsched.lr_at(step, tc)) == pytest.approx(want,
                                                              rel=1e-6)
        assert float(tsched.lr_at(torch.tensor(step, dtype=torch.int32),
                                  tc)) == pytest.approx(want, rel=1e-6)


def test_scheduled_adamw_matches_jax():
    """AdamW with a warmup schedule: the lr of step 1 read from it."""
    sched = dict(peak_lr=1e-2, warmup_steps=4, total_steps=20)
    rng = np.random.default_rng(57)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32)}
    g = {"w": rng.standard_normal((6, 5)).astype(np.float32)}
    jcfg = jopt.OptConfig(schedule=jsched.ScheduleConfig(**sched))
    tcfg = topt.OptConfig(schedule=tsched.ScheduleConfig(**sched))
    jp, _, _ = jopt.adamw_update(
        jax.tree.map(jnp.asarray, g),
        jopt.adamw_init(jax.tree.map(jnp.asarray, p))[0],
        jax.tree.map(jnp.asarray, p), jcfg)
    tparams = {"w": torch.from_numpy(p["w"])}
    tp, ts, _ = topt.adamw_update({"w": torch.from_numpy(g["w"])},
                                  topt.adamw_init(tparams), tparams, tcfg)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == 1

# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def make_state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros((3,))},
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    ckpt.save(5, make_state(5.0))
    assert ckpt.latest_step() == 5
    restored = ckpt.restore(make_state(0.0))
    np.testing.assert_allclose(restored["params"]["w"].numpy(), 5.0)
    assert int(restored["step"]) == 5
    assert restored["step"].dtype == torch.int32


def test_checkpoint_gc_and_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, make_state(float(s)))
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert sorted(dirs) == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step() == 4
    assert CheckpointManager(str(tmp_path / "empty")).latest_step() is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(make_state())


def test_checkpoint_async(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    ckpt.save(7, make_state(7.0))
    ckpt.wait()
    assert ckpt.latest_step() == 7


def test_checkpoint_restore_with_dtype_cast(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    w = torch.randn((4,)).to(torch.bfloat16)
    ckpt.save(1, {"w": w})
    restored = ckpt.restore({"w": torch.zeros((4,), dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], w)


def test_checkpoint_layout_matches_jax(tmp_path):
    """The same tree saved by both managers: the same npz keys, dtypes and
    values (bf16 stored as f32 by both), the same manifest step and
    ``latest`` pointer."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    jstate = {"params": {"w": jnp.asarray(w, jnp.bfloat16),
                         "layers": [{"g": jnp.ones((2,))}]},
              "step": jnp.asarray(9, jnp.int32)}
    tstate = {"params": {"w": torch.from_numpy(w).to(torch.bfloat16),
                         "layers": [{"g": torch.ones((2,))}]},
              "step": torch.tensor(9, dtype=torch.int32)}
    jckpt.CheckpointManager(str(tmp_path / "j"), async_save=False).save(
        9, jstate)
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(9, tstate)
    for sub in ("j", "t"):
        assert (tmp_path / sub / "latest").read_text() == "step_00000009"
    zj = np.load(tmp_path / "j" / "step_00000009" / "arrays.npz")
    zt = np.load(tmp_path / "t" / "step_00000009" / "arrays.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zj[k], zt[k])


def test_train_state_restores_bit_for_bit(tmp_path):
    """A reduced llama's train state (bf16 params, f32 AdamW moments, the
    int32 steps) after two steps, saved and restored into a fresh state:
    every leaf equal, dtype kept."""
    state, _ = ttrain.build_state(tregistry.get_reduced("llama3.2-1b"),
                                  device="cpu")
    fresh, _ = ttrain.build_state(tregistry.get_reduced("llama3.2-1b"),
                                  seed=1, device="cpu")
    for t in tree_leaves(state["opt"]["m"]):
        t.normal_()
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(2, state)
    got = ckpt.restore(fresh)
    for (ka, a), (kb, b) in zip(tree_paths(state), tree_paths(got)):
        assert ka == kb and a.dtype == b.dtype, ka
        assert torch.equal(a, b), ka


# ---------------------------------------------------------------------------
# data pipelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,src_len", [("llama3.2-1b", 0),
                                          ("qwen2-vl-2b", 0),
                                          ("seamless-m4t-large-v2", 0),
                                          ("seamless-m4t-large-v2", 12)])
def test_token_pipeline_bit_equal_to_jax(arch, src_len):
    jp = jdata.TokenPipeline(jregistry.get_reduced(arch), 3, 16, seed=7,
                             src_len=src_len)
    tp = tdata.TokenPipeline(tregistry.get_reduced(arch), 3, 16, seed=7,
                             src_len=src_len)
    for step in (0, 1, 123):
        a, b = jp.batch_at(step), tp.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(tp.batch_at(0)["inputs"],
                              tp.batch_at(1)["inputs"])
    it = iter(tp)
    np.testing.assert_array_equal(next(it)["inputs"],
                                  tp.batch_at(0)["inputs"])


def test_file_token_pipeline_bit_equal_to_jax(tmp_path):
    cfg = tregistry.get_reduced("llama3.2-1b")
    toks = np.random.default_rng(0).integers(0, 2 ** 20, 4000)
    path = str(tmp_path / "tokens.bin")
    tdata.FileTokenPipeline.write_token_file(path, toks)
    tp = tdata.FileTokenPipeline(path, cfg, batch=4, seq=16, seed=3)
    jp = jdata.FileTokenPipeline(path, jregistry.get_reduced("llama3.2-1b"),
                                 batch=4, seq=16, seed=3)
    for step in (0, 5, 61, 62, 500):
        a, b = jp.batch_at(step), tp.batch_at(step)
        for k in ("inputs", "targets"):
            np.testing.assert_array_equal(a[k], b[k])
        assert b["inputs"].max() < cfg.vocab_size
    with pytest.raises(ValueError, match="too small"):
        tdata.FileTokenPipeline(path, cfg, batch=4, seq=2000)


def test_prefetcher_yields_in_order():
    cfg = tregistry.get_reduced("llama3.2-1b")
    pipe = tdata.TokenPipeline(cfg, 2, 8, seed=1)
    pf = tdata.Prefetcher(pipe, start_step=3, depth=2)
    try:
        for step in (3, 4, 5, 6):
            np.testing.assert_array_equal(pf.next()["inputs"],
                                          pipe.batch_at(step)["inputs"])
    finally:
        pf.close()
    pf.thread.join(timeout=5)
    assert not pf.thread.is_alive()


# ---------------------------------------------------------------------------
# the training entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-large-v2"])
def test_train_resumes_from_checkpoint_bit_for_bit(tmp_path, arch, capsys):
    """Killed at step 5 with a checkpoint every 2 steps: ``train``
    restores step 4, replays steps 4-7, and every loss (the replayed step
    4's too) equals the uninterrupted run's at that step."""
    kw = dict(steps=8, batch=2, seq=16, ckpt_every=2, device="cpu",
              log_every=100)
    want, final = ttrain.train(arch, **kw)
    assert final == 8 and len(want) == 8
    got, final = ttrain.train(arch, ckpt_dir=str(tmp_path / "ckpt"),
                              fail_at=(5,), **kw)
    assert final == 8
    assert "[restart] restored step 4" in capsys.readouterr().out
    # steps 0-4 ran, then 4-7 again from the checkpoint of step 4
    assert got == want[:5] + want[4:]
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() == 8


def test_train_refuses_a_mesh_and_needs_a_card():
    """A (2, 2) mesh outside a world of 4 ranks is refused, naming the
    launcher (the mesh itself: tests/test_torch_mesh_train.py)."""
    with pytest.raises(ValueError, match="run_spmd"):
        ttrain.train("llama3.2-1b", data=2, model=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.train("llama3.2-1b", steps=1)


def test_train_cli_and_lm_train_on_cpu(tmp_path, capsys):
    losses, final = ttrain.main(["--device", "cpu", "--steps", "3",
                                 "--batch", "2", "--seq", "16"])
    assert final == 3 and len(losses) == 3
    assert "done at step 3" in capsys.readouterr().out
    losses, final = lm_train.main(["--device", "cpu", "--steps", "14",
                                   "--batch", "2", "--seq", "16",
                                   "--data", "1", "--model", "1"])
    assert final == 14
    out = capsys.readouterr().out
    assert "[fault] restart 1" in out and "resumed from checkpoint" in out
    assert all(np.isfinite(losses))
