"""Step builders: the prefill and greedy serve steps.

Counterpart of ``repro.launch.steps``' ``make_prefill_step`` and
``make_serve_step``, without a ``DistContext`` (one card, no sharding),
for every layer kind the port runs (GQA and MLA attention, the MoE FFN,
``rec``, ``ssd``).  LM training (``make_train_step``, the loss, the
optimiser) is not ported yet: ROADMAP Queue 1 item 14.5."""
from __future__ import annotations

import torch

from repro_torch.layers import common as cm
from repro_torch.models import transformer as tfm


def make_prefill_step(cfg, kv_chunk: int = 1024):
    """``prefill_step(params, batch) -> (B, V)`` float32: the next-token
    logits of the last position.  The final norm and the readout work per
    position, so they run on the last position only: the same numbers as
    JAX's ``forward(...)[:, -1, :]`` without the (B, S, V) logits (2.1 GB
    in f32 at llama3.2-1b, B = 1, S = 4096)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            x = tfm.hidden(params, batch, cfg, kv_chunk=kv_chunk)[:, -1:]
            x = cm.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps,
                                 gemma_style=cfg.gemma_norm)
            return tfm._readout(params, x, cfg)[:, -1, :]

    return prefill_step


def make_serve_step(cfg):
    """``serve_step(params, cache, tokens, idx) -> (next (B, 1), cache)``:
    one greedy decode step."""
    def serve_step(params, cache, tokens, idx):
        with torch.no_grad():
            logits, cache = tfm.decode_step(params, cache, tokens, idx, cfg)
            return torch.argmax(logits[:, -1, :], dim=-1)[:, None], cache

    return serve_step
