"""The benchmark's yardstick: the essential work of each conv site, from
its layer shapes alone, and the card's published peaks.

A site's work does not depend on the route or the kernel that runs it:

- a transposed site (stride s, k x k kernel, out = s * in) counts only the
  taps that meet the input, the HUGE count: every input pixel meets each of
  the k² taps once, so in² · k² · C · N MACs an image, never the zeros of a
  zero-inserted plane;
- a correlation site ('conv' or 'dilated') counts R · S · C · N MACs an
  output pixel; dilation moves the taps and changes nothing;
- a dense site counts C · N MACs a row.

A FLOP is 2 a MAC.  Bytes count the logical input, the weights (and bias)
and the output once each, in float32.  A site's bound is the larger of its
FLOPs over the f32 peak and its bytes over the HBM bandwidth.
"""
from __future__ import annotations

import dataclasses
import re
import subprocess

# published dense peaks: f32 FLOP/s on the CUDA cores, HBM bytes/s; the
# first key whose words the card's name all holds
PEAKS = {"H100 PCIe": (51e12, 2.0e12),
         "H100 NVL": (60e12, 3.9e12),
         "H100": (67e12, 3.35e12)}


@dataclasses.dataclass(frozen=True)
class Peaks:
    flops: float        # f32 FLOP/s
    bytes: float        # HBM bytes/s


def card_peaks(name: str) -> Peaks | None:
    """The published peaks of the card ``name`` (as
    ``torch.cuda.get_device_name`` gives it), or None for a card not
    listed."""
    for key, (flops, bw) in PEAKS.items():
        if all(part in name for part in key.split()):
            return Peaks(flops, bw)
    return None


def power_limit_w() -> float | None:
    """The card's power limit in watts as ``nvidia-smi`` reads it (None
    where it cannot be read): a card set below its maximum runs slower."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    m = re.search(r"[\d.]+", out)
    return float(m.group()) if m else None


@dataclasses.dataclass(frozen=True)
class Site:
    """One layer's shapes: ``kind`` is 'transposed', 'conv', 'dilated' or
    'dense' (``in_c`` inputs to ``out_c`` outputs a row, ``in_hw`` 1)."""

    name: str
    kind: str
    in_hw: int
    in_c: int
    out_c: int
    kernel: int = 1
    stride: int = 1
    bias: bool = False

    @property
    def out_hw(self) -> int:
        if self.kind == "transposed":
            return self.in_hw * self.stride
        return -(-self.in_hw // self.stride)

    def macs(self) -> int:
        """Essential multiply-adds for one image (or one dense row)."""
        taps_cn = self.kernel * self.kernel * self.in_c * self.out_c
        if self.kind == "transposed":
            return self.in_hw * self.in_hw * taps_cn
        if self.kind in ("conv", "dilated"):
            return self.out_hw * self.out_hw * taps_cn
        if self.kind == "dense":
            return self.in_c * self.out_c
        raise ValueError(f"unknown site kind {self.kind!r}")

    def flops(self, batch: int = 1) -> float:
        return 2.0 * batch * self.macs()

    def bytes(self, batch: int = 1, itemsize: int = 4) -> float:
        plane_in = self.in_hw * self.in_hw * self.in_c
        plane_out = self.out_hw * self.out_hw * self.out_c
        weights = self.kernel * self.kernel * self.in_c * self.out_c
        return float(itemsize * (batch * (plane_in + plane_out) + weights
                                 + self.out_c * self.bias))

    def bound_s(self, batch: int, peaks: Peaks) -> float:
        """The site's roofline time at ``batch`` rows."""
        return max(self.flops(batch) / peaks.flops,
                   self.bytes(batch) / peaks.bytes)


def forward_flops(sites, batch: int = 1) -> float:
    return sum(s.flops(batch) for s in sites)


def gan_step_flops(gen: list[Site], disc: list[Site], batch: int) -> float:
    """Essential FLOPs of one GAN training step of two passes, each from
    the old params: the d-pass (G forward; D forward on fake and real; D's
    weight products and its input products below the first layer) and the
    g-pass (G forward; D forward on fake; D's input products down to the
    image; G's weight and input products).  ``gen`` is the generator's
    sites in order (the dense projection first), ``disc`` the
    discriminator's (its first conv on the image first, the dense head
    last).  A product's backward for the input or the weights costs its
    forward's FLOPs."""
    proj, convs_g = gen[0], gen[1:]
    d0, head = disc[0], disc[-1]
    g = forward_flops(convs_g, batch)
    d = forward_flops(disc[:-1], batch)
    p, h, f0 = proj.flops(batch), head.flops(batch), d0.flops(batch)
    # G: two forwards, the g-pass's weight and input products; the
    # projection: two forwards and its weight product
    gen_part = 4 * g + 3 * p
    # D: three forwards (fake, real; fake), the d-pass's weight products
    # on both and input products below the first conv, the g-pass's input
    # products down to the image
    disc_part = 8 * (d + h) - 2 * f0
    return gen_part + disc_part
