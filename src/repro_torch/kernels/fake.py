"""The kernels' branch for fake tensors: count the launch, compute nothing.

A ``FakeTensor`` (``torch._subclasses.fake_tensor``) has a shape, a dtype
and a device but no data, so a kernel entry handed one cannot launch.
Each entry (kernels A–F and their int8, row-block and tiled forms) takes
a fake tensor off the CPU (on 'cuda', or on 'meta' standing for the card:
``launch.hlo_analysis``) where it takes a CUDA tensor, checks its
operands as for a launch, makes its output with ``torch.empty``, and
then, only where its first operand is fake, hands the launch and its
work, (FLOPs, bytes) from the kernel module's work function, to every
sink ``recording`` installed: that is how ``launch.hlo_analysis`` counts
a rank's step with no card.  The kernel's own launch counter is left as
it is: it counts launches, and nothing launched.  A real tensor
never takes the branch (a CPU tensor goes to the plain version before it,
a CUDA tensor on to the launch after it), so a launch pays one
``isinstance`` for it.
"""
from __future__ import annotations

import contextlib

from torch._subclasses.fake_tensor import FakeTensor

# the active sinks, innermost last: each has ``kernel(name, flops,
# nbytes)`` and ``note(key, value)``
_SINKS: list = []


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def launched(kernel: str, work: tuple) -> None:
    """One fake launch of ``kernel`` ("A", "A_int8", …, "F") doing
    ``work`` = (FLOPs, bytes)."""
    for sink in _SINKS:
        sink.kernel(kernel, *work)


def note(key: str, value) -> None:
    """Tell the active sinks a fact of the count (``moe_load``)."""
    for sink in _SINKS:
        sink.note(key, value)


@contextlib.contextmanager
def recording(sink):
    """Hand every fake launch inside the block to ``sink.kernel(name,
    flops, nbytes)`` and every note to ``sink.note(key, value)``."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def nbytes(*tensors) -> int:
    """The bytes of the given tensors (None skipped), each once at its
    dtype's size."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
