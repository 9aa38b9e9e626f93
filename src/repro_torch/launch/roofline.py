"""Three-term roofline of one rank's step, at an H100's nominal peaks.

Counterpart of ``repro.launch.roofline``:

    compute     = FLOPs / peak FLOP/s
    memory      = HBM bytes / HBM bandwidth
    collective  = per-rank collective traffic / link bandwidth

The FLOPs and bytes are one rank's, counted by ``launch.hlo_analysis`` on
fake tensors (every op the rank's step dispatches, and kernels A–F by
their work formulas); the collective traffic is what ``core.comm``
records, each collective's size times the ring factor of its kind:

    all-reduce(S)        2 * S * (n-1)/n        (reduce-scatter + all-gather)
    all-gather(S_out)    S_out * (n-1)/n
    reduce-scatter(S_o)  S_o * (n-1)            (streams (n-1)/n of its input)
    all-to-all(S)        S * (n-1)/n
    collective-permute   S                      (halo exchange, broadcast)

Constants: NVIDIA H100 SXM (the card ``PERF.md``'s bound column uses):
989e12 FLOP/s dense bf16 on the tensor cores (``PEAK_FLOPS``, every FLOP
of the compute term, so that term is a lower bound), 67e12 FLOP/s f32 on
the CUDA cores (``PEAK_FLOPS_F32``, the FFMA kernels' bound), 3.35e12 B/s
HBM3.  ``LINK_BW`` is NVLink 4's nominal 450e9 B/s a direction (NVIDIA's
H100 SXM datasheet: 900 GB/s bidirectional a GPU), not a measurement.  An
NVLink domain is one 8-card node, so a (16, 16) mesh spans nodes and the
collective term is optimistic on an axis that leaves one; like JAX's,
the model has one link figure.  Every time it gives is a prediction at
nominal peaks, not a measurement.

``PEAKS``/``card_peaks`` are the published dense peaks by card name
(fp32, HBM bytes/s, bf16), what ``chip_smoke.py``'s bounds read.

``MODEL_FLOPS`` = 6·N_active·D (train) / 2·N_active·D (inference), as
JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12
LINK_BW = 450e9

# published dense peaks by card: fp32 on CUDA cores, HBM bytes/s, and bf16
# on the tensor cores (kernel F's bound)
PEAKS = {"H100 PCIe": (51e12, 2.0e12, 756e12),
         "H100 NVL": (60e12, 3.9e12, 835e12),
         "H100": (PEAK_FLOPS_F32, HBM_BW, PEAK_FLOPS),
         "H200": (67e12, 4.8e12, 989e12)}


def card_peaks(name: str) -> tuple[float, float, float]:
    """(fp32 FLOP/s, HBM B/s, bf16 FLOP/s) of the card ``name`` (as
    ``torch.cuda.get_device_name`` or ``nvidia-smi`` gives it): the first
    ``PEAKS`` key whose words it all holds."""
    for key, peaks in PEAKS.items():
        if all(part in name for part in key.split()):
            return peaks
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def _traffic(kind: str, size: int, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if kind == "all-gather":
        return size * (n - 1) / n
    if kind == "reduce-scatter":
        return float(size) * (n - 1)
    if kind == "all-to-all":
        return size * (n - 1) / n
    return float(size)        # collective-permute


# ``core.comm``'s ops under XLA's collective kinds
KIND_OF_OP = {"all_reduce": "all-reduce", "all_gather": "all-gather",
              "gather": "all-gather", "reduce_scatter": "reduce-scatter",
              "all_to_all": "all-to-all", "broadcast": "collective-permute",
              "send_recv": "collective-permute"}


def collective_bytes(records: dict, default_group: int) -> dict:
    """Per-participant collective traffic of ``records``
    (``comm.collectives()``): by XLA's kind (``per_kind``) and by the
    records' own kinds (``per_record``); a record with no ``sizes`` reads
    its bytes as one collective over ``default_group`` ranks."""
    per_kind: dict[str, float] = {}
    per_record: dict[str, float] = {}
    count = 0
    for key, rec in records.items():
        kind = KIND_OF_OP[rec["op"]]
        sizes = rec.get("sizes") or {default_group: rec["bytes"]}
        per_record[key] = sum(_traffic(kind, size, n)
                              for n, size in sizes.items())
        per_kind[kind] = per_kind.get(kind, 0.0) + per_record[key]
        count += rec["calls"]
    return {"per_kind": per_kind, "per_record": per_record,
            "total": sum(per_kind.values()), "num_ops": count}


@dataclasses.dataclass
class Roofline:
    """All inputs are PER-RANK (one rank's step); model_flops is global
    and normalized by chips."""

    compute_s: float
    memory_s: float
    collective_s: float
    flops: float              # per chip
    bytes_hbm: float          # per chip
    bytes_coll: float         # per chip
    model_flops: float        # global
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """model-FLOPs utilization at the roofline-predicted step time."""
        t = self.step_time_s
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / t if t else 0.0

    @property
    def flops_ratio(self) -> float:
        """useful (model) FLOPs / counted FLOPs — remat/redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self):
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops_per_chip": self.flops,
            "hlo_bytes_per_chip": self.bytes_hbm,
            "coll_bytes_per_chip": self.bytes_coll,
            "model_flops": self.model_flops,
            "model_over_hlo_flops": self.flops_ratio,
            "mfu_at_roofline": self.mfu, "chips": self.chips,
        }


def roofline_from(cost: dict, coll: dict, chips: int,
                  model_flops: float) -> Roofline:
    """``cost`` ({"flops", "bytes accessed"}) and ``coll`` ({"total"})
    are one rank's."""
    flops = float(cost.get("flops", 0.0))
    bts = float(cost.get("bytes accessed", 0.0))
    coll_b = float(coll["total"])
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bts / HBM_BW,
        collective_s=coll_b / LINK_BW,
        flops=flops, bytes_hbm=bts, bytes_coll=coll_b,
        model_flops=model_flops, chips=chips)


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference)
# ---------------------------------------------------------------------------

def active_param_count(cfg) -> float:
    """Matmul parameters touched per token (MoE: top-k + shared only)."""
    d = cfg.d_model

    def layer_params(kind: str) -> float:
        if kind == "ssd":
            di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
            return d * (2 * di + 2 * g * n + h) + di * d
        if kind == "rec":
            dr = cfg.lru_width
            return 2 * d * dr + 2 * dr * dr + dr * d + 3 * d * cfg.d_ff
        if kind in ("mla", "mla_moe"):
            a = (d * cfg.q_lora_rank
                 + cfg.q_lora_rank * cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                 + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                 + cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                 + cfg.num_heads * cfg.v_head_dim * d)
        else:
            hd = cfg.head_dim
            a = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
                + cfg.num_heads * hd * d
            if kind == "dec":
                a *= 2  # + cross attention
        if kind in ("moe", "mla_moe"):
            f = (cfg.top_k * 3 * d * cfg.d_expert
                 + cfg.n_shared * 3 * d * cfg.d_expert + d * cfg.n_experts)
        else:
            f = 3 * d * cfg.d_ff
        return a + f

    total = 0.0
    for kinds, reps in cfg.stages:
        total += reps * sum(layer_params(k) for k in kinds)
    for kinds, reps in getattr(cfg, "encoder_stages", ()):
        total += reps * sum(layer_params(k) for k in kinds)
    total += d * cfg.vocab_size          # lm head (tied or not, compute is real)
    return total


def model_flops_for(cfg, shape, chips_tokens: Optional[int] = None) -> float:
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
