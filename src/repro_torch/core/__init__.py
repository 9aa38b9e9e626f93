"""HUGE² core: phase decomposition + untangling, planned once per site.

Counterpart of ``repro.core``, with every one of its public names, and
``resolve_device``.  Importing it builds and loads no kernel: the kernels
are built at their first launch."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) raises when no card is present — the port never falls back
    to the CPU on its own; the caller asks for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


from repro_torch.core.decompose import (decompose_kernel,  # noqa: E402
                                        interleave_phases,
                                        interleave_uniform, plan_phases_1d,
                                        transposed_out_size)
from repro_torch.core.engine import (huge_conv2d,  # noqa: E402
                                     huge_conv_transpose2d,
                                     huge_dilated_conv2d)
from repro_torch.core.plan import (BATCH_BUCKETS, ConvPlan,  # noqa: E402
                                   ConvSpec, Route, conv_spec,
                                   plan_cache_clear, plan_cache_info,
                                   plan_conv)
from repro_torch.core.untangle import (untangled_conv2d,  # noqa: E402
                                       untangled_depthwise_conv1d)
from repro_torch.core.autotune import (AutotunePolicy,  # noqa: E402
                                       RouteCache, measure_fn)
from repro_torch.core import reference  # noqa: E402

__all__ = [
    "decompose_kernel", "interleave_phases", "interleave_uniform",
    "plan_phases_1d",
    "transposed_out_size", "huge_conv2d", "huge_conv_transpose2d",
    "huge_dilated_conv2d", "untangled_conv2d", "untangled_depthwise_conv1d",
    "BATCH_BUCKETS", "ConvPlan", "ConvSpec", "Route", "conv_spec",
    "plan_conv", "plan_cache_info", "plan_cache_clear", "reference",
    "AutotunePolicy", "RouteCache", "measure_fn", "resolve_device",
]
