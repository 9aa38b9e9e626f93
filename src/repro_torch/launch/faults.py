"""Planted faults that the tests and ``chip_smoke.py`` share.  Each takes
the original function and returns its faulty stand-in, for a patch such as
``setattr(obj, name, fault(getattr(obj, name)))`` that the caller undoes
after the run: a gate that reads the faulty run past its tolerance shows
that it can fail.
"""
from __future__ import annotations


def skip_gather_sum(orig):
    """For ``core.comm.gather_from``: a split superpack's weight gathers
    keep their own cotangent slice in the backward, unsummed over the
    ranks that read other pieces of the plane or the batch."""
    def gather_from(x, group, dim=-1, kind="all_gather", reduce_bwd=False):
        if kind in ("rows_weight_gather", "cols_weight_gather"):
            reduce_bwd = False
        return orig(x, group, dim, kind, reduce_bwd)
    return gather_from


def no_batch_axes(orig):
    """For ``sharding.DistContext.axes_of``: no split axis carries the
    image batch, so a weight split over the batch axis runs as before its
    gather (row partials summed, or channels gathered, over ranks that
    hold other rows of the batch)."""
    def axes_of(self, entry):
        return orig(self, entry)[0], frozenset()
    return axes_of
