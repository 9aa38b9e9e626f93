"""The port's greedy decode on a (data, model) mesh across gloo processes
on the CPU, held to the JAX package on the same numpy weights, prompts
and memory.

The JAX references come from one subprocess with four forced host
devices (as ``tests/test_torch_mesh_forward.py`` makes them): reduced
configs in f32, the prompt fed token by token through ``decode_step`` as
JAX's ``serve`` does, then greedy tokens; every step's logits, the tokens
and the final cache.  The dense archs' reference is JAX's single-device
decode (its decode does not depend on the mesh); deepseek-v3-671b runs
JAX's ``make_serve_step(cfg, dist)`` on its own 2x2 mesh (MLA, and the
MoE on expert parallelism at a capacity that drops tokens).
recurrentgemma-2b and seamless-m4t-large-v2 also prefill on the mesh
against JAX's ``forward``.  The four ranks (one ``run_spmd`` launch) run
``make_serve_step(cfg, dist)`` with ``tfm.init_cache(..., dist=)`` under
``make_dist``'s decode rules:

- llama3.2-1b on (2, 2) (kv heads over 'model', batch over 'data') and on
  (1, 4) (a kv head cut: the sequence over 'model', q gathered over the
  heads); gemma3-1b on (2, 2) (one kv head: the sequence over 'model');
  llama3.2-1b at B = 1 (batch replicated, the sequence over 'data', kv
  heads over 'model');
- deepseek-v3-671b (the compressed cache's sequence over 'model', EP over
  ('data', 'model') at decode);
- recurrentgemma-2b (the RG-LRU's channels over 'model', its local layers'
  cache sequence over 'model') and seamless-m4t-large-v2 (8 of 16 heads:
  2 of 4 here, cross attention tensor-parallel).

Each case checks the tokens equal to JAX's, every step's logits and each
rank's final cache blocks against the slices of JAX's cache.  The smoke's
phase 3q planted faults each read past the tolerance: a 'kv_seq' rank
that skips the merge, the new row written on a rank that does not own
its position, the RG-LRU's gather before ``wa``/``wx`` skipped, one rank
skipping the cross attention's row-parallel all-reduce.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_spmd

WORLD = 4
# f32 decode: relative to max|ref| (f32 sums in another order, the f32
# row-parallel all-reduce and the merged softmax)
TOL_F32 = 2e-5
PROMPT, GEN = 8, 8           # max_len 16: divides every 'kv_seq' extent
# (name, arch, (data, model), batch, capacity factor or None, prefill)
CASES = [
    ("llama_2x2", "llama3.2-1b", (2, 2), 4, None, False),
    ("llama_1x4", "llama3.2-1b", (1, 4), 4, None, False),
    ("gemma3_2x2", "gemma3-1b", (2, 2), 4, None, False),
    ("llama_B1", "llama3.2-1b", (2, 2), 1, None, False),
    ("deepseek_ep", "deepseek-v3-671b", (2, 2), 8, 1.0, False),
    ("recurrentgemma", "recurrentgemma-2b", (2, 2), 4, None, True),
    ("seamless", "seamless-m4t-large-v2", (2, 2), 4, None, True),
]
SRC = 16                     # the encoder-decoder's source frames

JAX_REFS = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_dist, make_serve_step
from repro.models import transformer as tfm

with open(sys.argv[1], "rb") as f:
    conf = pickle.load(f)
P_LEN, GEN, SRC = conf["prompt"], conf["gen"], conf["src"]
out = {}

def config(arch, cf):
    cfg = registry.get_reduced(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe_impl="ep", capacity_factor=cf)
    return cfg

def draw(cfg, rng):
    shapes = jax.eval_shape(lambda k: tfm.init(k, cfg, dtype=jnp.float32)[0],
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: jnp.asarray(
        rng.standard_normal(s.shape).astype(np.float32)
        * (0.5 if len(s.shape) < 3 else 0.1)), shapes)

def unstack(cfg, stages):
    layers = []
    for (kinds, reps), st in zip(cfg.stages, stages):
        for r in range(reps):
            for i in range(len(kinds)):
                layers.append({k: np.asarray(v[r])
                               for k, v in st[f"l{i}"].items()})
    return layers

for name, arch, mesh_shape, b, cf, prefill in conf["cases"]:
    cfg = config(arch, cf)
    rng = np.random.default_rng(len(name))
    p = draw(cfg, rng)
    max_len = P_LEN + GEN
    prompt = rng.integers(0, cfg.vocab_size, (b, P_LEN)).astype(np.int32)
    memory = src = None
    rec = {}
    if cfg.is_encoder_decoder:
        src = rng.standard_normal((b, SRC, cfg.d_model)).astype(np.float32)
        memory = jax.jit(lambda p, s: tfm.encode(p, s, cfg, None, kv_chunk=4))(
            p, jnp.asarray(src))
    if prefill:
        batch = {"inputs": jnp.asarray(prompt)}
        if src is not None:
            batch["src_embeds"] = jnp.asarray(src)
        rec["prefill"] = np.asarray(jax.jit(lambda p, bt: tfm.forward(
            p, bt, cfg, kv_chunk=4))(p, batch)[:, -1])
    cache, _ = tfm.init_cache(cfg, b, max_len, dtype=jnp.float32)
    if cf is not None:
        # JAX's own serve step on its mesh, and its logits beside
        mesh = make_host_mesh(*mesh_shape)
        dist = make_dist(mesh, cfg, ShapeConfig("d", "decode", max_len, b))
        serve = jax.jit(make_serve_step(cfg, dist))
        logit_fn = jax.jit(lambda p, c, t, i, m: tfm.decode_step(
            p, c, t, i, cfg, dist, memory=m)[0])

        def step(p, c, t, i, m):
            return (logit_fn(p, c, t, i, m),) + serve(p, c, t, i, m)
        rec["rules"] = dict(dist.rules)
    else:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("x",))

        @jax.jit
        def step(p, c, t, i, m):
            logits, c = tfm.decode_step(p, c, t, i, cfg, None, memory=m)
            nxt = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
            return logits, nxt[:, None], c
    logits, toks, tok = [], [], jnp.asarray(prompt[:, :1])
    with mesh:
        for i in range(max_len - 1):
            t = jnp.asarray(prompt[:, i:i + 1]) if i < P_LEN else tok
            lg, tok, cache = step(p, cache, t, i, memory)
            logits.append(np.asarray(lg))
            if i >= P_LEN - 1:
                toks.append(np.asarray(tok)[:, 0])
    rec.update(params=jax.tree.map(np.asarray, p), prompt=prompt,
               memory=None if memory is None else np.asarray(memory),
               src=src, logits=np.stack(logits), tokens=np.stack(toks, 1),
               cache=unstack(cfg, cache))
    out[name] = rec
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f, protocol=5)
"""


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _patch(obj, name, wrap):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    return lambda: setattr(obj, name, orig)


def fault_skip_merge(rank):
    """Rank 1 keeps its own partials of the 'kv_seq' merge (the
    collectives still run, so no rank waits)."""
    def wrap(orig):
        def all_reduce(t, group, kind="all_reduce", op="sum"):
            y = orig(t, group, kind, op)
            return t if rank == 1 and kind.startswith("kv_seq") else y
        return all_reduce
    return wrap


def fault_every_rank_writes(orig):
    """The new row written by every rank of the sequence's group, at its
    position clamped into the rank's block."""
    def write(cache, rows, idx, s0, group):
        n, length = rows.shape[1], cache.shape[1]
        pos = (idx - s0 + torch.arange(n)).clamp(0, length - 1)
        cache.index_copy_(1, pos, rows.to(cache.dtype))
    return write


def fault_skip_gather(n):
    """The RG-LRU's channel gather skipped: the rank's own block stands in
    for every rank's."""
    def wrap(orig):
        def gather(x, group, dim=-1, kind="all_gather", reduce_bwd=False):
            y = orig(x, group, dim, kind, reduce_bwd)
            return torch.cat([x] * n, dim) if kind == "rec_gather" else y
        return gather
    return wrap


def fault_unsummed(rank, planted):
    def wrap(orig):
        def reduce_from(x, group, kind="all_reduce"):
            y = orig(x, group, kind)
            return x if rank == 1 and kind == planted else y
        return reduce_from
    return wrap


def _config(arch, cf):
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.get_reduced(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe_impl="ep", capacity_factor=cf)
    return cfg


def _serve(cfg, dist, params, ref, b, max_len):
    """JAX's serve loop through ``make_serve_step(cfg, dist)``: (every
    step's whole logits, the greedy tokens, the cache blocks, the
    collectives of one step)."""
    from repro_torch.core import comm
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as tfm
    logits = []

    def keep(orig):
        def f(*a, **kw):
            out = orig(*a, **kw)
            logits.append(out[0])
            return out
        return f
    prompt = torch.from_numpy(ref["prompt"].astype(np.int64))
    memory = (None if ref["memory"] is None
              else torch.from_numpy(ref["memory"]))
    cache = tfm.init_cache(cfg, b, max_len, dtype=torch.float32,
                           device="cpu", dist=dist)
    step = make_serve_step(cfg, dist)
    toks, tok, traffic = [], prompt[:, :1], None
    undo = _patch(tfm, "decode_step", keep)
    try:
        for i in range(max_len - 1):
            comm.traffic_reset()
            tok, cache = step(params, cache,
                              prompt[:, i:i + 1] if i < PROMPT else tok, i,
                              memory)
            traffic = traffic or comm.traffic()
            if i >= PROMPT - 1:
                toks.append(tok[:, 0])
    finally:
        undo()
    return (torch.stack(logits).numpy(), torch.stack(toks, 1).numpy(),
            cache, traffic)


def _cache_rel(cfg, dist, cache, want):
    """The worst relative error of this rank's cache blocks against the
    slices of JAX's whole cache (``want``), layer by layer."""
    from repro_torch.models import transformer as tfm
    worst = 0.0
    for kind, blocks, whole in zip(tfm.layer_kinds(cfg), cache, want):
        specs = tfm.cache_layer_specs(kind, cfg)
        for k, w in whole.items():
            pl = dist.placement(dist.resolve(specs[k]), w.shape)
            ref = pl.block(torch.tensor(w))
            assert tuple(blocks[k].shape) == tuple(ref.shape), (k, blocks[k]
                                                                .shape)
            if ref.numel():
                worst = max(worst, rel(ref.numpy(), blocks[k].numpy()))
    return worst


def _case(rank, case, ref):
    import warnings
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_dist, make_prefill_step
    from repro_torch.layers import attention
    from repro_torch.models import transformer as tfm
    name, arch, mesh_shape, b, cf, prefill = case
    cfg = _config(arch, cf)
    max_len = PROMPT + GEN
    dist = make_dist(make_host_mesh(*mesh_shape), cfg,
                     ShapeConfig("d", "decode", max_len, b))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        params = dist.shard_params(
            tfm.params_from_jax(ref["params"], cfg, device="cpu"),
            tfm.specs(cfg))
    logits, toks, cache, traffic = _serve(cfg, dist, params, ref, b,
                                          max_len)
    out = {"rules": dict(dist.rules), "logits": rel(ref["logits"], logits),
           "tokens": bool(np.array_equal(toks, ref["tokens"])),
           "cache": _cache_rel(cfg, dist, cache, ref["cache"]),
           "traffic": sorted(traffic),
           "cache_shapes": [{k: tuple(v.shape) for k, v in c.items()}
                            for c in cache]}
    batch = {"inputs": torch.from_numpy(ref["prompt"].astype(np.int64))}
    if ref["src"] is not None:
        batch["src_embeds"] = torch.from_numpy(ref["src"])
    if prefill:
        pre = make_prefill_step(cfg, dist, kv_chunk=4)
        out["prefill"] = rel(ref["prefill"], pre(params, batch).numpy())
    # ---- the planted faults ----------------------------------------------
    if name == "gemma3_2x2":
        undo = _patch(comm, "all_reduce", fault_skip_merge(rank))
        try:
            bad, *_ = _serve(cfg, dist, params, ref, b, max_len)
        finally:
            undo()
        out["planted"] = rel(ref["logits"], bad)
    if name == "llama_B1":
        undo = _patch(attention, "_write_rows", fault_every_rank_writes)
        try:
            _, _, bad, _ = _serve(cfg, dist, params, ref, b, max_len)
        finally:
            undo()
        out["planted"] = _cache_rel(cfg, dist, bad, ref["cache"])
    if name == "recurrentgemma":
        undo = _patch(comm, "gather_from", fault_skip_gather(2))
        try:
            bad = make_prefill_step(cfg, dist, kv_chunk=4)(params, batch)
        finally:
            undo()
        out["planted"] = rel(ref["prefill"], bad.numpy())
    if name == "seamless":
        undo = _patch(comm, "reduce_from",
                      fault_unsummed(rank, "cross_all_reduce"))
        try:
            bad, *_ = _serve(cfg, dist, params, ref, b, max_len)
        finally:
            undo()
        out["planted"] = rel(ref["logits"], bad)
    return out


def _rank(rank, world, dev, path):
    # four ranks on the host's cores: one thread each (the reduced shapes'
    # ops are tiny; a pool a rank only contends)
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        refs = pickle.load(f)
    return {case[0]: _case(rank, case, refs[case[0]]) for case in CASES}


# ---------------------------------------------------------------------------
# the JAX side and the launch (here)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    with open(tmp / "conf.pkl", "wb") as f:
        pickle.dump({"cases": CASES, "prompt": PROMPT, "gen": GEN,
                     "src": SRC}, f)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_REFS),
                        str(tmp / "conf.pkl"), str(tmp / "refs.pkl")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(tmp / "refs.pkl", "rb") as f:
        refs = pickle.load(f)
    ranks = run_spmd(_rank, WORLD, str(tmp / "refs.pkl"), device="cpu",
                     timeout=300)
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_decode_matches_jax(launch, case):
    """Every step's whole logits within TOL_F32 of JAX's, the greedy
    tokens equal, each rank's cache blocks within TOL_F32 of the slices
    of JAX's cache (the prefill's last-position logits too, where the
    case prefills)."""
    for res in launch["ranks"]:
        rec = res[case]
        assert rec["logits"] < TOL_F32 and rec["cache"] < TOL_F32, rec
        assert rec["tokens"], rec
        if "prefill" in rec:
            assert rec["prefill"] < TOL_F32, rec


def test_decode_rules_and_layouts():
    """The rules each case runs under and the cache block they give the
    mesh's last rank (no processes: a duck-typed mesh coordinate), and
    a cache whose length the 'kv_seq' axes do not divide is refused."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import make_dist
    from repro_torch.models import transformer as tfm

    class Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, shape):
            self.shape = shape

        def get_coordinate(self):
            return [n - 1 for n in self.shape]

    # (batch, kv_heads, kv_seq), {leaf: block} of the first layer (and of
    # recurrentgemma's first local layer)
    want = {"llama_2x2": (("data", "model", None), {"k": (2, 16, 1, 16)}),
            "llama_1x4": (("data", None, "model"), {"k": (4, 4, 2, 16)}),
            "gemma3_2x2": (("data", None, "model"), {"k": (2, 8, 1, 32)}),
            "llama_B1": ((None, "model", "data"), {"k": (1, 8, 1, 16)}),
            "deepseek_ep": (("data", None, "model"), {"ckv": (4, 8, 16),
                                                      "kr": (4, 8, 8)}),
            "recurrentgemma": (("data", None, "model"),
                               {"h": (2, 32), "conv": (2, 3, 32),
                                "k": (2, 8, 1, 32)}),
            "seamless": (("data", "model", None), {"k": (2, 16, 2, 16)})}
    for name, arch, mesh_shape, b, cf, _ in CASES:
        cfg = _config(arch, cf)
        dist = make_dist(Mesh(mesh_shape), cfg,
                         ShapeConfig("d", "decode", PROMPT + GEN, b))
        rules, blocks = want[name]
        assert (dist.rules["batch"], dist.rules["kv_heads"],
                dist.rules["kv_seq"]) == rules, name
        cache = tfm.init_cache(cfg, b, PROMPT + GEN, device="meta",
                               dist=dist)
        got = {k: tuple(v.shape) for c in cache for k, v in c.items()}
        assert {k: got[k] for k in blocks} == blocks, name
        if rules[2] is not None:
            with pytest.raises(ValueError):
                tfm.init_cache(cfg, b, PROMPT + GEN - 1, device="meta",
                               dist=dist)


def test_deepseek_rules_equal_jax_and_drop(launch):
    """deepseek's rules on the mesh are JAX's own (experts over ('data',
    'model'): the all-to-all path), and its decode capacity drops tokens
    (2 a rank, capacity 1)."""
    from repro_torch.layers import moe
    cfg = _config("deepseek-v3-671b", 1.0)
    for res in launch["ranks"]:
        assert res["deepseek_ep"]["rules"] == \
            launch["refs"]["deepseek_ep"]["rules"]
        assert res["deepseek_ep"]["rules"]["expert"] == ("data", "model")
    t_l = 8 // WORLD
    assert moe._capacity(t_l, cfg) < t_l


def test_collectives_follow_the_layout(launch):
    """A decode step's collective kinds: the softmax merge only where
    'kv_seq' splits, q gathered only where its group shares the heads'
    axis, the RG-LRU's gather and the cross attention's all-reduce on
    their kinds."""
    ranks = launch["ranks"]
    for res in ranks:
        kinds = {k: set(v["traffic"]) for k, v in res.items()}
        assert "kv_seq_merge" not in kinds["llama_2x2"]
        assert "decode_q_gather" not in kinds["llama_2x2"]
        for name in ("llama_1x4", "gemma3_2x2", "deepseek_ep"):
            assert {"kv_seq_max", "kv_seq_merge",
                    "decode_q_gather"} <= kinds[name], name
        assert {"kv_seq_max", "kv_seq_merge"} <= kinds["llama_B1"]
        assert "decode_q_gather" not in kinds["llama_B1"]
        assert "rec_gather" in kinds["recurrentgemma"]
        assert "cross_all_reduce" in kinds["seamless"]
        assert "ep_all_to_all" in kinds["deepseek_ep"]


def test_planted_faults_exceed_the_tolerance(launch):
    """A 'kv_seq' rank that skips the merge (gemma3's logits), the new row
    written on a non-owner rank (the B = 1 case's cache on some rank),
    the RG-LRU's gather skipped (recurrentgemma's prefill), one rank
    skipping the cross attention's all-reduce (seamless's logits)."""
    ranks = launch["ranks"]
    for name in ("gemma3_2x2", "recurrentgemma", "seamless"):
        assert all(r[name]["planted"] > TOL_F32 for r in ranks), name
    assert max(r["llama_B1"]["planted"] for r in ranks) > TOL_F32
