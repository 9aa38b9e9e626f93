"""One rank's step counted on fake tensors: FLOPs, HBM bytes, kernels,
collectives and peak memory, with no card and no real process group.

Counterpart of ``repro.launch.hlo_analysis``, whose name it keeps so the
port's layout mirrors ``src/repro/``.  There is no HLO here: JAX's module
walks the compiled program's text, this one runs the rank's step in eager
PyTorch on ``FakeTensor``s (shapes, dtypes and a device, no data) and
counts every op it dispatches:

  flops        — the products, by ``torch.utils.flop_counter``'s formulas
                 (mm, bmm, addmm, baddbmm, convolution, SDPA), plus kernels
                 A–F by their work formulas (``kernels.fake``)
  hbm bytes    — operand plus result bytes per dispatched op (eager PyTorch
                 launches one kernel an op: JAX's "per codegen unit"); views,
                 ``empty`` and the like cost nothing, as JAX's
                 ``_ZERO_COST``; kernels A–F by their work formulas
  collectives  — what ``core.comm`` records, under the ring factors of
                 ``launch.roofline``
  peak memory  — the bytes of the storages live at once during the step
                 (rounded up to the caching allocator's 512-byte blocks on
                 a CUDA device), on top of the step's inputs

The fake tensors stand for the card's: they sit on ``DEVICE``, 'meta',
off the CPU, so the step takes the card's paths (every branch of the port
that picks between the card's path and the plain one asks whether a
tensor is on the CPU; a kernel entry takes its fake branch, ``kernels
.fake``, for a fake tensor on 'cuda' or 'meta').  They are not on 'cuda'
because autograd cannot hold a fake CUDA tensor without CUDA: its graph
nodes take the device's guard, which a torch built for the CPU, or a host
with no card, does not have, so a train step would abort.  The
collectives run on a fake process group (``fake_world``) that moves
nothing.  Where the MoE's dispatch reads its expert counts from the data
(``layers.moe._expert_counts``) the counts are the balanced load, the one
``roofline.model_flops_for`` assumes, and the record says so
(``moe_load``).
"""
from __future__ import annotations

import contextlib
import heapq
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import comm
from repro_torch.kernels import fake

# ops that move no data: JAX's ``_ZERO_COST`` (views are found by their
# schema)
_ZERO_COST = {
    "aten.empty.memory_format", "aten.empty_strided.default",
    "aten.empty_like.default", "aten.new_empty.default",
    "aten.new_empty_strided.default", "aten.detach.default",
    "aten.alias.default", "aten.lift_fresh.default",
    "aten._unsafe_view.default",
    "aten._local_scalar_dense.default", "aten.resize_.default",
    "aten.set_.source_Storage_storage_offset", "prim.device.default",
}

# the caching allocator's block: a CUDA tensor takes a multiple of it
_BLOCK = 512

# the device the fake tensors sit on (module docstring)
DEVICE = "meta"

KERNELS = ("A", "A_int8", "B", "B_int8", "C", "C_int8", "D", "D_int8", "F")


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A default process group of ``world_size`` ranks on the fake backend
    (``torch.testing``'s ``FakeProcessGroup``: every collective returns at
    once and moves nothing) for tensors on the CPU, the card and
    ``DEVICE``, this process its rank ``rank``.  Refuses to
    start where a default group exists; on exit, also on an exception, the
    group is destroyed, the mesh code's cached groups are dropped and
    ``launch.mesh``'s one-rank flag reset, so nothing of it outlives the
    block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import sharding
    from repro_torch.launch import mesh
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group exists; "
                           "the fake world needs a process of its own")
    dist.init_process_group(f"cpu:fake,cuda:fake,{DEVICE}:fake",
                            store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        sharding._GROUPS.clear()
        mesh._ONE_RANK[0] = False


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------

def _tensors(tree):
    """Every tensor in a tree of dicts, lists, tuples and dataclasses."""
    import dataclasses
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _alloc_bytes(t: torch.Tensor) -> int:
    """What the storage under ``t`` takes: its bytes, a multiple of the
    caching allocator's block off the CPU (on the card, or on ``DEVICE``
    standing for it)."""
    n = t.untyped_storage().nbytes()
    return -(-n // _BLOCK) * _BLOCK if t.device.type != "cpu" else n


def tensor_bytes(tree) -> int:
    """The bytes of ``tree``'s tensors, each at its dtype's size."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def storage_bytes(tree) -> int:
    """The bytes the distinct storages under ``tree``'s tensors take
    (``_alloc_bytes``)."""
    seen = {}
    for t in _tensors(tree):
        seen.setdefault(t.untyped_storage()._cdata, _alloc_bytes(t))
    return sum(seen.values())


class _Counter(TorchDispatchMode):
    """Operand plus result bytes per op (``_ZERO_COST`` and views free),
    bytes by op, and the live bytes of the storages the ops make: their
    peak, with the largest buffers live at it."""

    def __init__(self, top_k: int = 20):
        super().__init__()
        self.hbm = 0
        self.by_op: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        # storage cdata -> (bytes, op, 'dtype[shape]', weakref)
        self._store: dict[int, tuple] = {}
        self._top_k = top_k
        self._snap_at = 0
        self.top: list = []
        self.kernels = {k: {"launches": 0, "flops": 0, "bytes": 0}
                        for k in KERNELS}
        self.notes: dict = {}

    # -- the kernels' and the MoE's reports (``kernels.fake``) -------------
    def kernel(self, name, flops, nbytes):
        k = self.kernels[name]
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def note(self, key, value):
        self.notes[key] = value

    # -- live storages -----------------------------------------------------
    def _freed(self, key, _ref):
        rec = self._store.pop(key, None)
        if rec is not None:
            self.live -= rec[0]

    def _track(self, t: torch.Tensor, op: str):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._store:
            return
        n = _alloc_bytes(t)
        self._store[key] = (n, op, f"{str(t.dtype)[6:]}{list(t.shape)}",
                            weakref.ref(st, lambda r, k=key:
                                        self._freed(k, r)))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
            # the largest live buffers, retaken as the peak grows by 1%
            if self.peak > self._snap_at * 1.01:
                self._snap_at = self.peak
                self.top = heapq.nlargest(self._top_k, (
                    (r[0], r[1], r[2]) for r in self._store.values()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        if name not in _ZERO_COST and not func.is_view:
            n = sum(t.numel() * t.element_size() for t in _tensors(
                (args, kwargs, out)))
            self.hbm += n
            op = str(func._overloadpacket)
            self.by_op[op] = self.by_op.get(op, 0) + n
        if not func.is_view:
            # an op's new storages: a view, an in-place or ``out=`` result
            # lies in a storage one of its inputs already holds
            held = {t.untyped_storage()._cdata for t in _tensors(
                (args, kwargs))}
            for t in _tensors(out):
                if t.untyped_storage()._cdata not in held:
                    self._track(t, str(func._overloadpacket))
        return out


def fake_mode() -> FakeTensorMode:
    """The mode to make a step's inputs in (``torch.empty(...,
    device=DEVICE)`` inside it); ``analyze_step`` runs the step in the
    same mode."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def _mode_of(args) -> FakeTensorMode:
    for t in _tensors(args):
        if isinstance(t, FakeTensor):
            return t.fake_mode
    return fake_mode()


def analyze_step(fn, *args, default_group: int = 1, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once on fake tensors (the args made in
    ``fake_mode()``; real ones are read as fake) and count it.  Returns
    JAX's ``analyze`` keys (``flops``, ``hbm_bytes``, ``coll_per_kind``,
    ``coll_total``, ``num_collectives``, ``hbm_by_op``) and ``product_flops``
    (``FlopCounterMode``'s total), ``kernels`` ({A … F: launches, FLOPs,
    bytes}), ``input_bytes`` (the args' storages), ``peak_activation_bytes``
    (the most bytes the step's own storages held at once), ``peak_bytes``
    (their sum), ``top_buffers`` ((GB, op, 'dtype[shape]') of the largest
    storages live at the peak), ``collectives`` (``comm.collectives()``
    of the step, each kind with its ``ring_bytes``: the traffic per
    participant ``roofline.collective_bytes`` reads it as), ``moe_load``
    ("balanced" where the MoE's counts were set, else None) and ``out``
    (what ``fn`` returned).  ``comm``'s traffic record is left as it
    was."""
    from repro_torch.launch import roofline as rl
    mode = _mode_of(args)
    saved = dict(comm._TRAFFIC)
    comm.traffic_reset()
    counter = _Counter()
    fc = FlopCounterMode(display=False)
    try:
        with mode, counter, fc, fake.recording(counter):
            out = fn(*args, **kwargs)
        traffic = comm.collectives()
    finally:
        comm._TRAFFIC.clear()
        comm._TRAFFIC.update(saved)
    coll = rl.collective_bytes(traffic, default_group)
    kernels = {k: v for k, v in counter.kernels.items() if v["launches"]}
    k_flops = sum(v["flops"] for v in kernels.values())
    k_bytes = sum(v["bytes"] for v in kernels.values())
    product = fc.get_total_flops()
    inputs = storage_bytes((args, kwargs))
    return {
        "flops": float(product + k_flops),
        "hbm_bytes": float(counter.hbm + k_bytes),
        "coll_per_kind": coll["per_kind"],
        "coll_total": coll["total"],
        "num_collectives": coll["num_ops"],
        "hbm_by_op": dict(sorted(
            list(counter.by_op.items()) + [(f"kernel {k}", v["bytes"])
                                           for k, v in kernels.items()],
            key=lambda kv: -kv[1])[:12]),
        "product_flops": product,
        "kernels": kernels,
        "input_bytes": inputs,
        "peak_activation_bytes": counter.peak,
        "peak_bytes": inputs + counter.peak,
        "top_buffers": [(b / 1e9, op, what) for b, op, what in counter.top],
        "collectives": {k: {**v, "ring_bytes": coll["per_record"][k]}
                        for k, v in traffic.items()},
        "moe_load": counter.notes.get("moe_load"),
        "out": out,
    }
