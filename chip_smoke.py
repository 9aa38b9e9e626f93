#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main paths on one NVIDIA GPU and fails (non-zero exit, no
result line) if anything is off:

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every hand-written kernel from this checkout's sources (one
   ``nvcc`` per source, all started together), with ``-Xptxas -v``'s
   registers, stack frames and spills (kernels F, A, B, C and D per
   instantiation on lines of their own; a kernel-A, B, C or D
   instantiation that spills fails, and so does a kernel-C or D
   instantiation with a stack frame);
2. kernel A (``untangled_deconv2d``) against its plain PyTorch version on
   the card, both held to the float64 oracle's ULP bound, at the full-width
   DCGAN sites (B = 1 and 64), the cGAN sites, the VAE's decoder sites
   (B = 1 and 64), a non-uniform-phase case, an
   empty-phase case (stride > kernel) and ragged C/N — every output, and
   the split K's workspace, comes from ``torch.empty`` on memory pre-filled
   with NaN; a second launch bit-equal to the first; each site's schedule
   (tile, slices, work units);
2b. kernel B (``untangled_conv2d_superpack``) the same way, at the four
   DCGAN discriminator sites (B = 1 and 64), both cGAN discriminator sites
   (B = 16), the VAE's encoder sites (B = 1 and 64; the stem's C = 3),
   dilated (d = 2, 4), ragged C/N and odd-output cases, the
   output and the split K's workspace on NaN-filled memory, two launches
   bit-equal, each site's schedule (tile, slices, work units);
2c. kernel B's int8 entry (kernel E inside B) and its plain version against
   the f64 oracle of ``(x, dequantize_int8(q, scale))``, at the 10 SegNet
   sites (B = 1 and 64), the six discriminator sites (B = 16), the VAE's
   encoder sites (B = 1 and 64) and ragged
   C/N, each superpack with an all-zero row; the int8 kernel bit-equal to
   the f32 kernel on the dequantized superpack, two launches bit-equal, on
   NaN-filled output and workspace;
2d. kernel A's int8 entry the same way, at the DCGAN (B = 1 and 64) and
   cGAN (B = 16) generator sites, the VAE's decoder sites (B = 1 and 64),
   the non-uniform, empty-phase and ragged cases, two launches bit-equal;
3. serving at full width: the Table-1 DCGAN on the 'cuda' route behind
   ``DynamicImageBatcher``, a burst answered once per request, 4 kernel
   launches per batcher launch, each row equal to a B = 1 forward;
3b. training at full width: the Table-1 DCGAN generator and discriminator
   on the 'cuda' route through ``train_step`` (3 SGD steps at B = 16), with
   finite losses and params, A and B launched exactly once per planned
   forward, and every gradient of one step equal to the 'torch' route's
   within ``max|Δ| ≤ TOL_GRAD·max|g_torch|`` per tensor (TF32 off);
3c. SegNet serving at full width (``SEGNET``, 64 px, width 128) on the
   'cuda' route, f32 and int8: a burst answered once per request, kernel B
   (f32 or int8 entry) launched exactly 10 times per batcher launch, every
   served argmax map equal to a B = 1 forward's, the int8 logits within
   10/127 rel L∞ of the f32 twin's and the int8 weights at most half the
   f32 bytes; the forward's time per bucket, and at B = 1 and 64 its device
   time by kernel and idle share (``torch.profiler``);
3d. the int8 DCGAN generator served the same way: 4 int8 kernel-A launches
   per batcher launch, rows equal to B = 1 forwards, output within 4/127
   rel L∞ of the f32 generator from the same seed;
4. times (CUDA events): per DCGAN generator site at B = 1 and 64 kernel A,
   its plain version, ``F.conv_transpose2d`` as the library yardstick and
   the roofline bound, with the kernel's and the library's device time per
   call (``torch.profiler``; at B = 1 the events time the host's Python)
   and the site's schedule (at least 132 work units at B = 1); one full
   generator forward per bucket;
4b. per discriminator site at B = 1 and 64 the same for kernel B, with
   ``F.conv2d`` on the pre-padded plane as the yardstick (device times and
   the schedule too; at least 132 work units at every DCGAN site at B = 1
   whose K the schedule splits); ms per train step at B = 16 and 64 on
   'cuda' and on 'torch';
4c. the int8 entries: kernel B at every SegNet site and kernel A at every
   DCGAN site (B = 1 and 64) against the f32 kernel, the plain version, the
   library call on the dequantized weights and the bound (1 B per weight
   plus 4 B per scale row), with device times and the schedule (at least
   132 work units at SegNet L1-L8 at B = 1); the SegNet forward per
   bucket, f32 and int8;
2e. kernel C (``untangled_conv2d_superpack`` with ``sp_tiles=``) and its
   int8 entry against the plain version and the f64 oracle's ULP bound on
   NaN-poisoned outputs, at the four tiled sites of the U-Net at a 512 px
   image (B = 1, the routes' block tiles), the 385 px 32->32 d = 2 context
   site and a d = 4 twin, the geometries of
   ``tests/test_tiled_kernels.py:SINGLE_CASES`` with their tiles, C = 3
   and N = 3 sites, a 3x3 site at every BN (4, 32, 64, 128), the stem's C
   = 3, a stride-2 site, a ragged C not divisible by 4, a 7x7 site and
   the VAE's two k4 s2 encoder sites (autotune candidates); the
   int8 entry bit-equal to the f32 entry on the dequantized superpack
   everywhere, two launches of either bit-equal; each site's schedule
   (``tiled_conv_schedule``: tile, BN, tap loop, halo, ring, blocks an
   SM);
2f. kernel D (``untangled_deconv2d`` with ``sp_tiles=``) and its int8 entry
   the same way, at the U-Net's tiled up0 (512 px, B = 1; there the
   cropped ``F.conv_transpose2d`` of phase 4d too), the geometries of
   ``DECONV_CASES`` (DCGAN and cGAN phases, an empty phase, stride 1) and
   each path and edge on the card's tiles (the shared-window path at k4
   s2, the run-time path at k5 s2, nine phases, C % 4 != 0, N not a
   multiple of BN, BN 4 and 128), the VAE's decoder sites and DCGAN DC1
   and DC4 (autotune candidates), empty phases written as zeros; each
   site's schedule (``tiled_deconv_schedule``: tap loop, BN, register
   split, tile, halo, ring);
3e. the U-Net on the 'cuda' route, f32 and int8: ``UNET`` (32 px) at B = 1
   and 64 and a 512 px image at B = 1 and 16, one ``unet_apply`` per bucket
   with the launches counted per kernel (512 px: 4 C + 1 D + 4 B + 1 A; 32
   px: 8 B + 2 A; the int8 model in the int8 counters), each forward within
   ``2e-4·max|y_torch|`` of the 'torch' route on the same weights, the int8
   model within ``0.15·max|y32| + 1e-3`` of its f32 twin, and an 8-step
   ``denoise_loop`` at 512 px that stays finite;
4d. times of kernels C and D (f32 and int8) at every tiled 512 px site at
   B = 1 and 16 beside the plain version, the library (kernel C:
   ``F.conv2d``; kernel D: ``F.conv_transpose2d`` at ``padding=0``
   cropped to up0's pad (1, 3), one call and a view) and the bound, with
   the schedules and D's device times; the U-Net forward per
   bucket, and one 512 px forward's device time by kernel, its busy share
   and kernel B's share of the device time;
2g. kernel F (``flash_attention``) against its plain version and the f64
   dense oracle, f32 (the FFMA entry) and bf16 (the tensor-core entry, its
   worst error and share of the tolerance), on NaN-poisoned outputs: the
   four geometries of ``tests/test_flash_attention_kernel.py``, ragged
   (1, 1000, 32, 8, 64) causal, (2, 77, 4, 2, 128) non-causal, a
   decode-style row at q_offset 300 over 512 keys, gemma3-1b's window-512
   D = 256 layer and a llama3.2-1b layer at S = 4096;
3f. the llama3.2-1b prefill step at full width in bf16 (seeded weights) at
   B = 1, S = 4096 and B = 8, S = 512: 16 F launches per forward, finite
   f32 logits (off the bf16 grid: the tied readout does not round them),
   the kernel route's last-position logits within 3e-2·max|logits|
   of the plain attention route's on the same weights, the same argmax on
   every row whose top two logits are not within twice that error;
3g. greedy serving at full width: ``serve(reduced=False, batch=4,
   prompt_len=8, gen_tokens=16)``, then 6 requests over 4 slots of
   ``ContinuousBatcher``, each request's tokens equal to its lone run's, 0
   F launches at decode (JAX decodes with a dense softmax), tok/s;
4e. kernel F a layer at both prefill geometries (bf16) beside its f32
   FFMA entry on the same values, its plain version,
   ``F.scaled_dot_product_attention`` as the library yardstick and the
   bound (the unmasked pairs' FLOPs at the bf16 tensor-core peak,
   or the bytes of q, k, v and o); the prefill step's ms; its device time
   split into F, dense products and the rest with the idle share
   (``torch.profiler``); ``decode_step`` ms at B = 4;
3h. the full-width VAE (``VAE``: 32 px, widths 64/128, latent 64) on the
   'cuda' route, f32 and int8: ``vae_apply`` at B = 1 and 64 launches 2 B
   and 2 A (the int8 model in the int8 counters), recon, mu and logvar
   within ``2e-4·max|y_torch|`` of the 'torch' route on the same weights
   and noise, the int8 twin within 4/127 rel L∞ of the f32 model; three
   SGD steps of ``elbo_loss`` at B = 64 (finite, 6 A and 6 B launches),
   one step's gradients within ``TOL_GRAD·max|g_torch|`` per tensor and
   the loss within ``TOL_LOSS`` of the 'torch' route's; ``sample(n=16)``
   finite in [-1, 1];
4f. times: per VAE site at B = 1 and 64 kernel B or A, its plain version,
   the library call (``F.conv2d`` on the pre-padded plane; the cropped
   ``F.conv_transpose2d`` at the decoder's pad (1, 3)), the bound, device
   ms and the schedule; the same for kernel A at its other pad (1, 3)
   sites (cGAN DC1-DC2 at B = 1 and 64, the U-Net's whole-plane up sites
   at 32 px, B = 1 and 64, and at 512 px, B = 1 and 16) and at the DCGAN
   sites; the ``per_phase`` route (a kernel-B or -C launch a live phase,
   f32 and int8, int8 bit-equal to f32 on the dequantized superpack)
   beside kernel A at the DCGAN, cGAN and VAE decoder sites; the VAE
   forward per bucket with its device split and busy share; the ELBO step
   at B = 64 on 'cuda' and on 'torch';
4g. measured route autotuning (``AutotunePolicy(mode='measure')``, a route
   cache in a temporary directory) at the VAE's and the DCGAN generator's
   sites, every bucket: each candidate's min µs, the winner, whether it
   flipped the heuristic route; every tuned plan's output within the f64
   bound (a kernel winner) or ``2e-4·max|y_torch|`` (a plain winner); a
   second load in 'cache' mode measures nothing and gives the same
   routes; ``serve_dcgan --autotune cache`` re-times no bucket and
   measures no route, every served row equal to a B = 1 forward;
5. the ``kernels`` line (A, B, A-int8, B-int8, C, D, C-int8, D-int8, F;
   A's, B's, A-int8's and B-int8's B = 64 sums with their B = 1 sums
   beside), the card line, and the result line.

    python3 chip_smoke.py        # from the repository root, one GPU
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# forward tolerance of the served rows against a B = 1 forward: the kernel's
# per-element sum order does not depend on the batch, but the projection GEMM
# (cuBLAS) may pick another algorithm per batch size
TOL_ROW = 2e-4
# gradient tolerance of the 'cuda' route against the 'torch' route (both
# IEEE fp32, other summation orders through up to eight stacked layers;
# ReLU kinks turn forward rounding into whole-element gradient changes),
# relative to each tensor's own scale: max|Δ| ≤ TOL_GRAD·max|g_torch|, the
# form and value of the CPU tests' gradient check against JAX
TOL_GRAD = 1e-3
TOL_LOSS = 1e-4               # relative, on the two losses
TRAIN_STEPS = 3
TRAIN_BATCH = 16
# published dense peaks by card: fp32 on CUDA cores, HBM bytes/s, and bf16
# on the tensor cores (kernel F's bound)
PEAKS = {"H100 PCIe": (51e12, 2.0e12, 756e12),
         "H100 NVL": (60e12, 3.9e12, 835e12),
         "H100": (67e12, 3.35e12, 989e12),
         "H200": (67e12, 4.8e12, 989e12)}
BURST = 24
# forward tolerance of the U-Net's 'cuda' route against its 'torch' route,
# relative to max|y_torch| (the CPU tests' TOL_FWD form against JAX)
TOL_UNET = 2e-4
UNET_512_HW = 512
UNET_512_BATCHES = (1, 16)
# the VAE's forward against its 'torch' route, relative to max|y_torch|
# (the CPU tests' TOL_FWD form against JAX), and its buckets and SGD rate
# (the full config's -ELBO sums 3072 squared errors an image; the JAX
# example's 1e-3 diverges there)
TOL_VAE = 2e-4
VAE_BATCHES = (1, 64)
VAE_LR = 1e-4
UNET_32_BATCHES = (1, 64)
DENOISE_STEPS = 8
# kernel C cases beside the U-Net's: (name, b, hp, wp, c, n, r, s, stride,
# dilation, tile) on a pre-padded plane; tile None takes the card's own.
# The geometries of tests/test_tiled_kernels.py's SINGLE_CASES (ragged
# edge, strided, big halo, ragged C, 1x1, one tile = plane), then C = 3
# and N = 3 (the scalar paths), a 3x3 site at every BN (4, 32, 64, 128,
# the last over two N tiles), the stem's C = 3, a stride-2 site, a ragged
# C not divisible by 4 and a 7x7 site (the run-time tap loop)
TILED_CONV_CASES = [
    ("ctx385_d2", 1, 389, 389, 32, 32, 3, 3, 1, 2, None),
    ("ctx385_d4", 1, 393, 393, 32, 32, 3, 3, 1, 4, None),
    ("ragged_edge", 2, 13, 11, 5, 7, 3, 2, 1, 1, (4, 4)),
    ("strided", 1, 17, 17, 8, 8, 3, 3, 2, 1, (3, 5)),
    ("big_halo", 1, 21, 21, 4, 4, 3, 3, 1, 3, (8, 8)),
    ("ragged_c", 2, 14, 14, 130, 40, 2, 2, 2, 2, (2, 7)),
    ("one_by_one", 1, 9, 9, 3, 4, 1, 1, 1, 1, (4, 4)),
    ("one_tile_is_plane", 1, 16, 16, 6, 5, 3, 3, 1, 1, (16, 16)),
    ("c3_n32", 2, 34, 34, 3, 32, 3, 3, 1, 1, None),
    ("c32_n3", 2, 34, 34, 32, 3, 3, 3, 1, 1, None),
    ("bn4_n4", 2, 42, 40, 8, 4, 3, 3, 1, 1, None),
    ("bn32_n32", 2, 42, 40, 16, 32, 3, 3, 1, 1, None),
    ("bn64_n48", 1, 42, 40, 16, 48, 3, 3, 1, 1, None),
    ("bn128_n160", 1, 26, 24, 8, 160, 3, 3, 1, 1, None),
    ("stem_c3_n32", 2, 66, 66, 3, 32, 3, 3, 1, 1, None),
    ("s2_c16_n32", 2, 65, 65, 16, 32, 3, 3, 2, 1, None),
    ("ragged_c10_n32", 1, 30, 30, 10, 32, 3, 3, 1, 1, None),
    ("k7_n256", 1, 30, 29, 16, 256, 7, 7, 1, 1, None),
    ("vae_enc0_k4s2_c3", 2, 35, 35, 3, 64, 4, 4, 2, 1, None),
    ("vae_enc1_k4s2", 2, 19, 19, 64, 128, 4, 4, 2, 1, None),
]
# kernel D cases beside up0: (name, b, h, c, n, k, stride, pads, tile), the
# geometries of DECONV_CASES (square planes), then on the card's tiles
# (tile None) each path and edge: the shared-window path at k4 s2 (up0's
# widths over ragged tiles; C % 4 != 0 with N not a multiple of BN; BN 128
# over two N tiles; BN 4 with N = 3), the run-time path at k5 s2 with N
# not a multiple of BN, nine phases of one shared window (run-time)
TILED_DECONV_CASES = [
    ("dcgan_k5s2", 2, 8, 6, 4, 5, 2, ((2, 3), (2, 3)), (3, 3)),
    ("cgan_k4s2", 1, 8, 5, 4, 4, 2, ((1, 3), (1, 3)), (8, 2)),
    ("empty_phase_k2s3", 2, 6, 5, 4, 2, 3, ((0, 0), (0, 0)), (2, 3)),
    ("stride_1", 1, 7, 4, 3, 3, 1, ((1, 1), (1, 1)), (3, 2)),
    ("dcgan_card_tile", 2, 8, 6, 4, 5, 2, ((2, 3), (2, 3)), None),
    ("shared_k4s2_up0_widths", 2, 37, 64, 32, 4, 2, ((1, 3), (1, 3)), None),
    ("shared_k4s2_c10_n48", 1, 20, 10, 48, 4, 2, ((1, 3), (1, 3)), None),
    ("shared_k4s2_n160", 1, 12, 8, 160, 4, 2, ((1, 3), (1, 3)), None),
    ("shared_k4s2_n3", 2, 16, 8, 3, 4, 2, ((1, 3), (1, 3)), None),
    ("runtime_k5s2_c16_n40", 1, 16, 16, 40, 5, 2, ((2, 3), (2, 3)), None),
    ("runtime_k6s3_nine_phases", 1, 9, 8, 8, 6, 3, ((2, 5), (2, 5)), None),
    ("vae_dec0_k4s2", 2, 8, 128, 64, 4, 2, ((1, 3), (1, 3)), None),
    ("vae_dec1_k4s2_n3", 2, 16, 64, 3, 4, 2, ((1, 3), (1, 3)), None),
    ("dcgan_dc1_k5s2", 1, 4, 1024, 512, 5, 2, ((2, 3), (2, 3)), None),
    ("dcgan_dc4_k5s2_n3", 1, 32, 128, 3, 5, 2, ((2, 3), (2, 3)), None),
]


# kernel F cases: (name, b, sq, sk, h, kh, d, causal, window, q_offset):
# tests/test_flash_attention_kernel.py's four geometries, ragged lengths, a
# non-causal D = 128 case, a decode-style row at q_offset 300, gemma3-1b's
# local layer (window 512, D = 256) and a llama3.2-1b layer at S = 4096
FLASH_CASES = [
    ("jax_mha_d64", 1, 256, 256, 4, 4, 64, True, 0, 0),
    ("jax_gqa_d32", 2, 256, 256, 8, 2, 32, True, 0, 0),
    ("jax_mqa_window", 1, 512, 512, 4, 1, 64, True, 128, 0),
    ("jax_bidirectional", 1, 256, 256, 2, 2, 64, False, 0, 0),
    ("ragged_1000", 1, 1000, 1000, 32, 8, 64, True, 0, 0),
    ("noncausal_77_d128", 2, 77, 77, 4, 2, 128, False, 0, 0),
    ("decode_q_offset_300", 1, 1, 512, 32, 8, 64, True, 0, 300),
    ("gemma3_window_512", 1, 2048, 2048, 4, 1, 256, True, 512, 0),
    ("llama_4096", 1, 4096, 4096, 32, 8, 64, True, 0, 0),
]
# kernel F against its plain version and the f64 oracle: f32 as
# tests/test_flash_attention_kernel.py:34 (2e-4); bf16 adds one bf16
# rounding of the output, a relative 2^-7
TOL_F = 2e-4
TOL_F_BF16_REL = 2.0 ** -7
# SDPA (bf16 P) against kernel F (f32 P) on bf16 inputs: the bf16 tolerance
# of tests/test_flash_attention_kernel.py:49
TOL_F_LIBRARY = 3e-2
# the llama3.2-1b prefill's last-position logits, kernel route against the
# plain attention route on the same bf16 weights, relative to max|logits|
# (the CPU tests' bf16 tolerance)
TOL_LM = 3e-2
LM_PREFILL = ((1, 4096), (8, 512))
# ContinuousBatcher requests: (prompt length, new tokens), 6 over 4 slots
LM_REQUESTS = ((8, 16), (5, 8), (7, 12), (3, 6), (6, 10), (4, 16))
# device kernels of the dense products (cuBLAS / CUTLASS names)
MATMUL_NAMES = ("gemm", "xmma", "cutlass", "matmul", "gemv", "splitk",
                "nvjet")


# device kernels of the port's conv kernels A-D by symbol, for the profiler
# splits, in match order: a symbol that holds another comes first
# ("deconv_kernel" holds "conv_kernel", "deconv_split_reduce" holds
# "conv_split_reduce", "deconv_tiled_kernel" holds "conv_tiled_kernel")
CONV_KERNELS = (("deconv_tiled_kernel", "D"), ("conv_tiled_kernel", "C"),
                ("deconv_thin_kernel", "A"), ("deconv_split_reduce", "A"),
                ("deconv_kernel", "A"), ("conv_split_reduce", "B"),
                ("conv_kernel", "B"))


def kernel_part(name: str) -> str:
    """Which of the port's conv kernels (A-D) a device kernel belongs to,
    by its symbol, else "other"."""
    return next((part for sym, part in CONV_KERNELS if sym in name), "other")


def device_events(fn, min_events, with_cpu=False, tries=3):
    """``fn()`` under ``torch.profiler``: (profile, its device kernels'
    events).  CUPTI now and then hands back a trace short of the kernels
    that ran; a trace with fewer than ``min_events`` timed device events is
    taken again, up to ``tries`` times, and after that the events are None
    (the caller reports the device time as not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] * with_cpu + [ProfilerActivity.CUDA]
    for _ in range(tries):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and ev.device_time_total > 0]
        if len(evs) >= min_events:
            return prof, evs
        print(f"[profiler] trace holds {len(evs)} timed device events of "
              f"at least {min_events}: taken again")
    return prof, None


def ms_text(v, fmt=".4f"):
    """A device time (or a share of it) as printed: "not measured" where
    the profiler caught no trace."""
    return "not measured" if v is None else format(v, fmt)


def ptxas_report(log: str) -> list[dict]:
    """Registers, stack frame and spills of each kernel instantiation
    (kernel F's, kernel A's, B's, C's and D's and the reductions), from an
    ``nvcc -Xptxas -v`` log: [{"kernel", "registers", "stack_frame",
    "spill_stores", "spill_loads"}], the kernel
    named by its symbol and template arguments (int8_t for the int8
    entries)."""
    import re
    out = []
    names = {"i": str, "b": lambda v: "true" if v == "1" else "false"}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(flash_fwd\w*?_kernel"
                      r"|deconv_kernel|deconv_thin_kernel|deconv_split_reduce"
                      r"|deconv_tiled_kernel|conv_tiled_kernel|conv_kernel"
                      r"|conv_split_reduce)"
                      r"(?:I(\w*?)EEv|E)", line)
        if m:
            args = [names[kind](v) if kind else
                    {"f": "float", "a": "int8_t"}[typ]
                    for kind, v, typ in re.findall(r"L([ib])(\d+)E|([fa])",
                                                   m.group(2) or "")]
            out.append({"kernel": f"{m.group(1)}<{', '.join(args)}>"
                        if m.group(2) else m.group(1)})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and out:
            (out[-1]["stack_frame"], out[-1]["spill_stores"],
             out[-1]["spill_loads"]) = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def card_peaks(name: str) -> tuple[float, float, float]:
    for key, peaks in PEAKS.items():
        if all(part in name for part in key.split()):
            return peaks
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def library_args(x, kernel, strides, padding):
    """``F.conv_transpose2d`` arguments computing the port's transposed conv
    (NHWC ``x``, HWIO ``kernel``, lhs-dilated correlation padding): NCHW
    input, the kernel flipped in space and laid out (C_in, C_out, kH, kW),
    ``padding = R - 1 - pad_lo`` and ``output_padding = pad_hi - pad_lo``."""
    r, s = kernel.shape[:2]
    (plh, phh), (plw, phw) = padding
    pad = (r - 1 - plh, s - 1 - plw)
    out_pad = (phh - plh, phw - plw)
    if min(pad + out_pad) < 0 or out_pad[0] >= strides[0] \
            or out_pad[1] >= strides[1]:
        raise ValueError(f"padding {padding} has no conv_transpose2d form")
    w = kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    return (x.permute(0, 3, 1, 2).contiguous(), w,
            dict(stride=tuple(strides), padding=pad, output_padding=out_pad))


def cropped_library_args(x, kernel, strides, padding):
    """``F.conv_transpose2d`` arguments computing the port's transposed conv
    where ``library_args`` finds no form (the cGAN's and the U-Net's pad
    (1, 3), whose ``output_padding`` would equal the stride): the full
    transposed conv (``padding=0``) cropped to the rows and columns from
    ``R - 1 - pad_lo``, as many as the padded conv has (``pad_hi <= R -
    1``); one call and a view.  Returns (NCHW input, (C_in, C_out, kH, kW)
    kernel, keywords, (row slice, column slice))."""
    r, s = kernel.shape[:2]
    (plh, phh), (plw, phw) = padding
    if not (0 <= plh <= r - 1 and 0 <= phh <= r - 1
            and 0 <= plw <= s - 1 and 0 <= phw <= s - 1):
        raise ValueError(f"padding {padding} has no cropped form")
    oh = (x.shape[1] - 1) * strides[0] + 1 + plh + phh - r + 1
    ow = (x.shape[2] - 1) * strides[1] + 1 + plw + phw - s + 1
    crop = (slice(r - 1 - plh, r - 1 - plh + oh),
            slice(s - 1 - plw, s - 1 - plw + ow))
    w = kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    return (x.permute(0, 3, 1, 2).contiguous(), w,
            dict(stride=tuple(strides)), crop)


def conv_library_args(xp, kernel, strides, dilation):
    """``F.conv2d`` arguments computing kernel B's valid correlation: the
    pre-padded NCHW plane (``padding=0``), the kernel as (N, C, R, S)."""
    return (xp.permute(0, 3, 1, 2).contiguous(),
            kernel.permute(3, 2, 0, 1).contiguous(),
            dict(stride=tuple(strides), dilation=tuple(dilation)))


def time_ms(fn, iters=20, warmup=3):
    """CUDA-event ms of one call of ``fn``, over ``iters`` back-to-back
    calls after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_device_ms(fn, iters=20, tries=4):
    """Device time of one call of ``fn`` (after a warm-up): its kernels'
    time over ``iters`` calls under ``torch.profiler``, per call.  Beside
    the CUDA-event time, which at B = 1 is the host's pace.  CUPTI now
    and then drops device events from a trace, a kernel's symbol at times
    altogether, so the time is taken per kernel symbol (the mean event
    times the launches a call makes, its events over ``iters``, rounded,
    summed over symbols) from a trace that holds every symbol a call
    launches: every symbol seen in any of at least two traces, and each of
    the port's kernels (A-D) that the warm-up call counted in its wrapper,
    each symbol with at least ``iters - 1`` events.  Failing that after
    ``tries`` traces the time is None (not measured).  With no event
    missing this is the sum over ``iters``."""
    import torch

    def counts():
        return {k: getattr(f, a) + getattr(f, a + "_int8")
                for k, (f, a) in launch_counters().items()}
    before = counts()
    fn()
    torch.cuda.synchronize()
    parts = {k for k, v in counts().items() if v > before[k]}

    def calls():
        for _ in range(iters):
            fn()
    traces, seen = [], set()
    for i in range(tries):
        _, evs = device_events(calls, 1, tries=1)
        if evs is not None:
            by_symbol = {}
            for ev in evs:
                by_symbol.setdefault(ev.name, []).append(
                    ev.device_time_total)
            traces.append(by_symbol)
            seen |= by_symbol.keys()
        if len(traces) < 2 and i < tries - 1:
            continue
        for by_symbol in traces:
            if parts <= {kernel_part(sym) for sym in by_symbol} and all(
                    len(by_symbol.get(sym, ())) >= iters - 1
                    for sym in seen):
                return sum(sum(v) / len(v) * max(1, round(len(v) / iters))
                           for v in by_symbol.values()) / 1e3
        print(f"[profiler] no trace holds every kernel of the call "
              f"({len(seen)} symbols seen, kernels {sorted(parts)}) with "
              f"{iters - 1} of its {iters} calls' events: taken again")
    return None


def f64_bound(plan, x, kern):
    """(y64, elementwise ULP bound) of ``plan``'s conv of ``x`` with the
    HWIO ``kern``: the f64 oracle, and the bound's term count per output
    element (per phase for the transposed kind)."""
    import torch
    from repro_torch.core import reference as ref
    sp_ = plan.spec
    if sp_.kind != "transposed":
        dil = sp_.dilation if sp_.kind == "dilated" else (1, 1)
        y64, amax = ref.conv_oracle_f64(x, kern, strides=sp_.strides,
                                        dilation=dil, padding=sp_.padding)
        return y64, ref.ulp_bound(y64, amax, sp_.kernel_hw[0]
                                  * sp_.kernel_hw[1] * sp_.in_c)
    y64, amax = ref.conv_oracle_f64(ref.zero_insert(x, sp_.strides), kern,
                                    padding=sp_.padding)
    terms = torch.zeros(plan.out_hw, dtype=torch.float64, device=x.device)
    for ex in plan.phases:
        terms[ex.q[0]::sp_.strides[0], ex.q[1]::sp_.strides[1]] = \
            ex.taps[0] * ex.taps[1] * sp_.in_c
    return y64, ref.ulp_bound(y64, amax, terms[None, :, :, None])


def check_library(name, y_lib, y_k):
    """The library yardstick's output against the kernel's (the library
    call must compute the same function before it is timed)."""
    err = float((y_lib - y_k).abs().max())
    if err > TOL_ROW * (1 + float(y_k.abs().max())):
        raise RuntimeError(f"library yardstick disagrees on {name}: "
                           f"{err:.3e}")
    return err


def schedule_of(plan, b):
    """Kernel A's schedule for a call, as printed beside its checks and
    times: tile, slice length, slices per phase, work units."""
    from repro_torch.kernels.untangled_conv import deconv_schedule
    sch = deconv_schedule(tuple(plan.phases), b, plan.spec.in_c,
                          plan.spec.out_c)
    return {"tile": list(sch.tile), "chunk_len": sch.chunk_len,
            "slices": list(sch.slices), "units": sch.units,
            "workspace_bytes": sch.workspace_bytes}


def conv_schedule_of(b, oh, ow, k, c, n):
    """Kernel B's schedule for a call, as printed beside its checks and
    times: tile, slice length, slices, work units, workspace."""
    from repro_torch.kernels.untangled_conv import conv_schedule
    sch = conv_schedule(b * oh * ow, k * k * c, n)
    return {"tile": list(sch.tile), "chunks": sch.chunks,
            "chunk_len": sch.chunk_len, "slices": sch.slices,
            "units": sch.units, "workspace_bytes": sch.workspace_bytes}


def launch_counters() -> dict:
    """Kernel -> (wrapper, f32 counter); the int8 entry's counter is the
    same name + ``_int8``."""
    from repro_torch.kernels.untangled_conv import (
        untangled_conv2d_superpack, untangled_deconv2d)
    return {"A": (untangled_deconv2d, "launches"),
            "B": (untangled_conv2d_superpack, "launches"),
            "C": (untangled_conv2d_superpack, "launches_tiled"),
            "D": (untangled_deconv2d, "launches_tiled")}


def zero_counts():
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)
        setattr(fn, attr + "_int8", 0)


def read_counts(wdtype):
    """({kernel: launches of ``wdtype``'s entry}, launches of the other
    dtype's entries) since the last ``zero_counts``."""
    suffix = "_int8" if wdtype == "int8" else ""
    other = "" if wdtype == "int8" else "_int8"
    counters = launch_counters()
    return ({k: getattr(fn, attr + suffix)
             for k, (fn, attr) in counters.items()},
            sum(getattr(fn, attr + other) for fn, attr in
                counters.values()))


def forward_split(fn, wall_ms):
    """One forward ``fn()`` (after one untimed) under ``torch.profiler``:
    device time of kernels A-D and of everything else, summed over
    device-side events, and the busy share against ``wall_ms`` (measured
    without the profiler); the shares are None where the profiler caught
    no trace."""
    import torch
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        _, evs = device_events(fn, 1, with_cpu=True)
    out = {f"{k}_ms": 0.0 for k in ("A", "B", "C", "D", "other")}
    for ev in evs or ():
        out[f"{kernel_part(ev.name)}_ms"] += ev.device_time_total / 1e3
    busy = sum(out.values())
    out.update(device_busy_ms=busy, wall_ms=wall_ms,
               busy_share=busy / wall_ms if evs else None,
               B_share=out["B_ms"] / busy if evs else None)
    return out


def site(h, c, n, k, s, pads, backend="cuda"):
    """The plan of a square transposed site."""
    from repro_torch.core.plan import ConvSpec, plan_conv
    return plan_conv(ConvSpec(
        kind="transposed", in_hw=(h, h), in_c=c, out_c=n,
        kernel_hw=(k, k), strides=(s, s), padding=pads, backend=backend))


def kernel_call(plan, xg, packed, **scales):
    """Kernel A (its int8 entry with ``scales=``) on the padded plane."""
    from repro_torch.kernels.untangled_conv import untangled_deconv2d
    return untangled_deconv2d(xg, packed, phases=plan.phases,
                              out_hw=plan.out_hw, strides=plan.spec.strides,
                              sum_uv=plan.sum_uv, **scales)


def ref_call(plan, xg, packed, **scales):
    """Kernel A's plain version, as ``kernel_call``."""
    from repro_torch.kernels.untangled_conv import untangled_deconv2d_ref
    return untangled_deconv2d_ref(xg, packed, phases=plan.phases,
                                  out_hw=plan.out_hw,
                                  strides=plan.spec.strides,
                                  sum_uv=plan.sum_uv, **scales)


def conv_call(xp, sp, k, s, d, plain=False, **scales):
    """Kernel B (or its plain version) on the pre-padded plane."""
    from repro_torch.kernels.untangled_conv import (
        untangled_conv2d_superpack, untangled_conv2d_superpack_ref)
    fn = untangled_conv2d_superpack_ref if plain \
        else untangled_conv2d_superpack
    return fn(xp, sp, taps_hw=(k, k), strides=(s, s), rhs_dilation=(d, d),
              **scales)


def seg_sites():
    """(name, in_hw, C, N, k, stride, dilation, pads) of every site of the
    full-width SegNet (``SEGNET``, ``segnet_plans``' geometry)."""
    from repro_torch.models import segnet
    return [(f"SegNet_L{i}", l.in_hw, l.in_c, l.out_c, l.kernel, l.stride,
             l.dilation, segnet.atrous_padding(l.kernel, l.dilation))
            for i, l in enumerate(segnet.SEGNET.layers)]


def disc_sites():
    """(name, in_hw, C, N, k, stride, pads) of every discriminator site of
    the Table-1 DCGAN and cGAN (``discriminator_plans``' mirror)."""
    from repro_torch.models import gan
    sites = []
    for tag, layers in (("DCGAN", gan.DCGAN_LAYERS),
                        ("cGAN", gan.CGAN_LAYERS)):
        for i, l in enumerate(reversed(layers)):
            k = l.kernel
            sites.append((f"{tag}_D{i + 1}", l.in_hw * l.stride, l.out_c,
                          l.in_c, k, l.stride,
                          ((k // 2, (k - 1) // 2), (k // 2, (k - 1) // 2))))
    return sites


def vae_sites():
    """(name, kind, in_hw, C, N, k, stride, pads) of the four sites of the
    full-width VAE (``vae_plans``' geometry): the encoder's strided convs
    (kernel B) and the decoder's transposed convs (kernel A)."""
    from repro_torch.models import gan, vae
    sites = []
    for i, l in enumerate(vae.VAE.encoder_layers):
        k = l.kernel
        sites.append((f"VAE_enc{i}", "conv", l.in_hw, l.in_c, l.out_c, k,
                      l.stride, ((k // 2, (k - 1) // 2),) * 2))
    for i, l in enumerate(vae.VAE.decoder_layers):
        sites.append((f"VAE_dec{i}", "transposed", l.in_hw, l.in_c, l.out_c,
                      l.kernel, l.stride,
                      gan.deconv_padding(l.kernel, l.stride)))
    return sites


def lm_phases(dev, peak_bw, peak_bf16, time_ms, gen):
    """Phases 2g, 3f, 3g and 4e: kernel F against its plain version and the
    f64 oracle, the full-width llama3.2-1b prefill on F (launches, finite
    logits, kernel route against the plain attention route), greedy serving
    through ``serve`` and ``ContinuousBatcher`` (tokens equal to lone runs,
    no F launch at decode), and the times.  Returns (records for the
    results line, F's entry for the kernels line)."""
    import contextlib

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.layers import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.batcher import ContinuousBatcher, Request

    # ---- 2g. kernel F vs its plain version, both vs the f64 oracle --------
    max_err_f = max_err_bf16 = gate_share_bf16 = 0.0
    for case in FLASH_CASES:
        name, b, sq, sk, h, kh, d, causal, window, q_offset = case
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                       for shape in ((b, sq, h, d), (b, sk, kh, d),
                                     (b, sk, kh, d)))
            torch.full((q.numel(),), float("nan"), device=dev)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            plain = fa.flash_attention_plain(q, k, v, **kw)
            oracle = flash_attention_ref(q.double(), k.double(), v.double(),
                                         **kw)
            rel = TOL_F_BF16_REL if dtype == torch.bfloat16 else 0.0
            errs, share = {}, 0.0
            for tag, want in (("plain", plain), ("f64", oracle)):
                diff = (got.double() - want.double()).abs()
                bound = TOL_F + rel * want.double().abs()
                errs[tag] = float(diff.max())
                share = max(share, float((diff / bound).max()))
                if not bool((diff <= bound).all()) or not bool(
                        torch.isfinite(got).all()):
                    raise RuntimeError(
                        f"kernel F off its {tag} reference at {name} "
                        f"{dtype}: max|Δ| {errs[tag]:.3e}")
            if dtype == torch.float32:
                max_err_f = max(max_err_f, errs["plain"], errs["f64"])
            else:
                max_err_bf16 = max(max_err_bf16, errs["plain"], errs["f64"])
                gate_share_bf16 = max(gate_share_bf16, share)
            print(f"[F] {name} {str(dtype)[6:]}: max|Δ| vs plain "
                  f"{errs['plain']:.3e}, vs f64 oracle {errs['f64']:.3e}, "
                  f"{share:.3f} of the tolerance")
            del q, k, v, got, plain, oracle
    torch.cuda.empty_cache()
    print(f"[F] kernel F within 2e-4 (f32; + 2^-7·|o| in bf16) of its plain "
          f"version and the f64 oracle at {len(FLASH_CASES)} geometries, "
          f"f32 and bf16; worst f32 error {max_err_f:.3e}, worst bf16 error "
          f"{max_err_bf16:.3e} ({gate_share_bf16:.3f} of its tolerance)")

    @contextlib.contextmanager
    def plain_attention():
        """The attention core on F's plain version (the card's 'plain
        route'): the layer's ``flash_attention`` swapped for it."""
        core = attention.flash_attention

        def plain(q, k, v, *, causal=True, window=0, q_offset=0,
                  kv_chunk=1024, scale=None):
            return fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, q_offset=q_offset,
                                            scale=scale, ck=kv_chunk)
        attention.flash_attention = plain
        try:
            yield
        finally:
            attention.flash_attention = core

    # ---- 3f. the llama3.2-1b prefill at full width, bf16 -------------------
    cfg = registry.get_config("llama3.2-1b")
    params = tfm.init(cfg, seed=0, device=dev)

    def numel(tree):
        if isinstance(tree, dict):
            return sum(numel(t) for t in tree.values())
        if isinstance(tree, list):
            return sum(numel(t) for t in tree)
        return tree.numel()
    n_params = numel(params)
    prefill = make_prefill_step(cfg)
    f_paths, prefill_rec, batches = {}, {}, {}
    for b, s in LM_PREFILL:
        tag = f"B{b}_S{s}"
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
        batches[tag] = {"inputs": toks.to(dev)}
        fa.flash_attention.launches = 0
        logits = prefill(params, batches[tag])
        torch.cuda.synchronize()
        f_paths[f"lm_prefill_{tag}"] = fa.flash_attention.launches
        if fa.flash_attention.launches != cfg.num_layers:
            raise RuntimeError(f"prefill {tag}: kernel F launched "
                               f"{fa.flash_attention.launches} times, not "
                               f"{cfg.num_layers}")
        if logits.shape != (b, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            raise RuntimeError(f"prefill {tag}: logits {tuple(logits.shape)}"
                               f" not finite")
        # the tied readout returns the f32 sum: most logits lie off the
        # bf16 grid, none would after a bf16 rounding
        off_grid = int((logits.to(torch.bfloat16).float() != logits).sum())
        if off_grid == 0:
            raise RuntimeError(f"prefill {tag}: every logit is a bf16 value")
        with plain_attention():
            ref_logits = prefill(params, batches[tag])
        err = float((logits - ref_logits).abs().max())
        scale = float(ref_logits.abs().max())
        if err > TOL_LM * scale:
            raise RuntimeError(f"prefill {tag}: kernel route {err:.3e} off "
                               f"the plain route (max|logits| {scale:.3f})")
        top2 = ref_logits.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = logits.argmax(-1) == ref_logits.argmax(-1)
        # a row whose top two logits sit within twice the worst error of
        # each other may flip by rounding alone; every other row must agree
        clear = gap > 2 * err
        if not bool(same[clear].all()):
            raise RuntimeError(f"prefill {tag}: argmax differs from the "
                               f"plain route on a clear row")
        prefill_rec[tag] = {
            "launches": f_paths[f"lm_prefill_{tag}"],
            "max_abs_err_vs_plain": err, "max_abs_logit": scale,
            "argmax_equal_rows": int(same.sum()), "rows": b,
            "near_tie_rows": int((~clear).sum()),
            "logits_off_bf16_grid": off_grid, "logits": logits.numel()}
        print(f"[lm] prefill {tag}: {cfg.num_layers} F launches, logits "
              f"finite, kernel vs plain route max|Δ| {err:.3e} (max|logits| "
              f"{scale:.3f}, tol {TOL_LM}·max), argmax equal on "
              f"{int(same.sum())}/{b} rows ({int((~clear).sum())} near "
              f"ties); {off_grid}/{logits.numel()} logits off the bf16 "
              f"grid (f32 readout)")
        del logits, ref_logits

    # ---- 3g. greedy serving: serve() and ContinuousBatcher -----------------
    fa.flash_attention.launches = 0
    served, serve_s = serve("llama3.2-1b", reduced=False, batch=4,
                            prompt_len=8, gen_tokens=16, device=dev)
    if served.shape != (4, 16) or served.min() < 0 \
            or served.max() >= cfg.vocab_size:
        raise RuntimeError(f"serve: tokens {served.shape} out of range")
    f_paths["lm_serve"] = fa.flash_attention.launches
    torch.cuda.empty_cache()

    def requests():
        g = torch.Generator().manual_seed(7)
        return [Request(rid=i, prompt=torch.randint(
            0, cfg.vocab_size, (p,), generator=g).numpy(), max_new=n)
            for i, (p, n) in enumerate(LM_REQUESTS)]

    fa.flash_attention.launches = 0
    batcher = ContinuousBatcher(cfg, params, slots=4, max_len=32, device=dev)
    for r in requests():
        batcher.submit(r)
    t0 = time.perf_counter()
    steps = batcher.run()
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    f_paths["lm_batcher"] = fa.flash_attention.launches
    if f_paths["lm_serve"] or f_paths["lm_batcher"]:
        raise RuntimeError(f"kernel F launched at decode: {f_paths}")
    got = {r.rid: r.out for r in batcher.done}
    for r in requests():
        lone = ContinuousBatcher(cfg, params, slots=1, max_len=32,
                                 device=dev)
        lone.submit(r)
        lone.run()
        if r.out != got[r.rid] or len(r.out) != r.max_new:
            raise RuntimeError(f"request {r.rid}: batched tokens "
                               f"{got[r.rid]} != lone run {r.out}")
    n_tok = sum(len(o) for o in got.values())
    st = batcher.stats()
    serve_rec = {"serve_tokens": int(served.size), "serve_s": serve_s,
                 "serve_tok_per_s": served.size / serve_s,
                 "batcher_requests": len(got), "batcher_steps": steps,
                 "batcher_tokens": n_tok, "batcher_s": batch_s,
                 "batcher_tok_per_s": n_tok / batch_s,
                 "batcher_p50_ms": st["p50_ms"],
                 "batcher_ttft_p95_ms": st["ttft_p95_ms"]}
    print(f"[lm] serve (B=4, 8-token prompts, 16 new): "
          f"{served.size / serve_s:.1f} tok/s (host clock, token-by-token "
          f"prompt); ContinuousBatcher {len(got)} requests over 4 slots: "
          f"{n_tok} tokens in {steps} steps, {n_tok / batch_s:.1f} tok/s, "
          f"each request's tokens equal to its lone run; 0 F launches at "
          f"decode")

    # ---- 4e. times: kernel F a layer, the prefill step, decode -------------
    f_times = []
    for b, s in LM_PREFILL:
        h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
        y_k = fa.flash_attention(q, k, v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        lib_err = float((library().transpose(1, 2).float()
                         - y_k.float()).abs().max())
        if lib_err > TOL_F_LIBRARY:
            raise RuntimeError(f"library yardstick disagrees with kernel F "
                               f"at B={b} S={s}: {lib_err:.3e}")
        pairs = b * h * s * (s + 1) // 2
        flops = 4 * d * pairs
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + y_k.numel())
        t_ops, t_bytes = flops / peak_bf16 * 1e3, nbytes / peak_bw * 1e3
        q32, k32, v32 = (t.float() for t in (q, k, v))
        rec = {"site": f"B{b}_S{s}", "batch": b, "seq": s, "flops": flops,
               "bytes": nbytes,
               "ms": time_ms(lambda: fa.flash_attention(q, k, v)),
               "f32_ms": time_ms(lambda: fa.flash_attention(q32, k32, v32)),
               "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v)),
               "library_ms": time_ms(library),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_max_abs_err": lib_err}
        rec["tflops"] = flops / rec["ms"] / 1e9
        f_times.append(rec)
        print(f"[time] kernel F llama layer B={b} S={s}: kernel "
              f"{rec['ms']:.4f} ms ({rec['tflops']:.1f} TFLOP/s; the f32 "
              f"FFMA entry on the same values {rec['f32_ms']:.4f} ms), plain "
              f"{rec['plain_ms']:.4f} ms, SDPA {rec['library_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), kernel "
              f"at {rec['bound_ms'] / rec['ms']:.1%} of bound")
        del q, k, v, y_k, qt, kt, vt, q32, k32, v32
    prefill_ms = {tag: time_ms(lambda: prefill(params, batch), iters=5,
                               warmup=1)
                  for tag, batch in batches.items()}
    print(f"[time] llama3.2-1b prefill step (bf16, {cfg.num_layers} layers, "
          f"last-position logits) ms: {json.dumps(prefill_ms)}")

    def device_split(fn, wall_ms):
        """One call of ``fn`` under ``torch.profiler``: device time of
        kernel F, of the dense products and of everything else, the number
        of device kernels, and the idle share against ``wall_ms`` (its time
        measured without the profiler); the shares are None where the
        profiler caught no trace."""
        _, evs = device_events(fn, 1, with_cpu=True)
        out = {"F_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0, "F_calls": 0,
               "device_kernels": 0}
        for ev in evs or ():
            name = ev.name.lower()
            part = ("F" if "flash_fwd" in name
                    else "matmul" if any(p in name for p in MATMUL_NAMES)
                    else "other")
            out[f"{part}_ms"] += ev.device_time_total / 1e3
            out["F_calls"] += part == "F"
            out["device_kernels"] += 1
        busy = out["F_ms"] + out["matmul_ms"] + out["other_ms"]
        out.update(device_busy_ms=busy, wall_ms=wall_ms,
                   idle_share=1 - busy / wall_ms if evs else None)
        return out

    split = {tag: device_split(lambda: prefill(params, batch),
                               prefill_ms[tag])
             for tag, batch in batches.items()}
    print(f"[time] llama3.2-1b prefill, device time by part "
          f"(torch.profiler, one step after the timed ones): "
          f"{json.dumps(split)}")
    cache = tfm.init_cache(cfg, 4, 32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen).to(dev)

    def decode():
        with torch.no_grad():
            tfm.decode_step(params, cache, tok, 10, cfg)
    decode_ms = time_ms(decode)
    split["decode_B4"] = device_split(decode, decode_ms)
    print(f"[time] llama3.2-1b decode_step at B=4 (cache 32): "
          f"{decode_ms:.4f} ms a step, {4 / decode_ms * 1e3:.1f} tok/s; "
          f"one step under torch.profiler: {json.dumps(split['decode_B4'])}")

    big = f_times[0]
    entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "tpu_kernel": "src/repro/kernels/flash_attention.py::_kernel",
        "launches": sum(f_paths.values()), "launches_by_path": f_paths,
        "held_against_plain": True, "max_abs_err": max_err_f,
        "max_abs_err_bf16": max_err_bf16,
        "tolerance_share_bf16": gate_share_bf16,
        "shape": f"llama3.2-1b attention layer, B={big['batch']} "
                 f"S={big['seq']}, bf16, causal",
        **{k: big[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "f32_ms")}}
    records = {"lm_params": n_params, "lm_prefill": prefill_rec,
               "lm_serve": serve_rec, "flash_sites": f_times,
               "lm_prefill_ms": prefill_ms, "lm_prefill_split": split,
               "lm_decode_ms_B4": decode_ms}
    return records, entry


def vae_phases(dev, smi, peak_flops, peak_bw, gen):
    """Phases 3h, 4f and 4g: the full-width VAE on the 'cuda' route (2 B
    and 2 A launches a forward, f32 and int8, against the 'torch' route;
    three ELBO steps, one step's gradients against the 'torch' route's; a
    prior sample; the int8 twin's gate), the times of its sites and of
    kernel A's other pad (1, 3) sites with the library call, the
    per-phase route beside kernel A, the VAE forward and ELBO step, and
    measured route autotuning with its route cache.  Returns (records for
    the results line, {path: launch counts} for the kernels line)."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import serve_dcgan, vae_train
    from repro_torch.core import autotune as at
    from repro_torch.core.plan import plan_cache_clear, plan_conv
    from repro_torch.core.untangle import pad_or_crop
    from repro_torch.models import gan, unet, vae

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def bound_of(flops, nbytes):
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    # ---- 3h. the VAE at full width, f32 and int8, on the 'cuda' route ------
    vcfg = dataclasses.replace(vae.VAE, backend="cuda")
    v_cfgs = {w: dataclasses.replace(vcfg, wdtype=w)
              for w in ("float32", "int8")}
    v_params, vae_serve, vae_launches, recon = {}, {}, {}, {}
    for wdtype, c_ in v_cfgs.items():
        bad = [(p.spec.kind, p.spec.in_hw, r.batch, r.path, r.sp_tiles)
               for p in vae.vae_plans(c_) for r in p.routes
               if r.path != "cuda" or r.sp_tiles is not None]
        if bad:
            raise RuntimeError(f"VAE {wdtype} sites off kernels A and B: "
                               f"{bad}")
        v_params[wdtype] = vae.vae_init(0, c_, device=dev)
    n_sites = len(vae.vae_plans(vcfg))
    want_v = {"A": 2, "B": 2, "C": 0, "D": 0}
    for bb in VAE_BATCHES:
        g_ = torch.Generator().manual_seed(30 + bb)
        xv = torch.randn((bb, vcfg.image_hw, vcfg.image_hw, vcfg.in_c),
                         generator=g_).to(dev)
        ev = torch.randn((bb, vcfg.latent_dim), generator=g_).to(dev)
        for wdtype, c_ in v_cfgs.items():
            with torch.inference_mode():
                zero_counts()
                out_c = vae.vae_apply(v_params[wdtype], xv, None, c_, eps=ev)
                torch.cuda.synchronize()
                got, stray = read_counts(wdtype)
                out_t = vae.vae_apply(v_params[wdtype], xv, None,
                                      dataclasses.replace(c_,
                                                          backend="torch"),
                                      eps=ev)
                torch.cuda.synchronize()
            key = f"vae_{wdtype}_B{bb}"
            vae_launches[key] = got
            if got != want_v or stray:
                raise RuntimeError(f"{key}: launches {got} (+{stray} in the "
                                   f"other dtype's counters), want {want_v}")
            rels = {nm: float((a - b_).abs().max() / b_.abs().max())
                    for nm, a, b_ in zip(("recon", "mu", "logvar"), out_c,
                                         out_t)}
            if not (max(rels.values()) <= TOL_VAE
                    and out_c[0].shape == xv.shape
                    and all(bool(torch.isfinite(t).all()) for t in out_c)):
                raise RuntimeError(f"{key}: cuda vs torch max|Δ|/max|y| "
                                   f"{rels}")
            vae_serve[key] = {"cuda_vs_torch": rels, "launches": got}
            recon[wdtype] = out_c[0]
        rel8 = float((recon["int8"] - recon["float32"]).abs().max()
                     / recon["float32"].abs().max())
        vae_serve[f"vae_int8_B{bb}"]["int8_vs_f32"] = rel8
        if not rel8 <= n_sites / 127.0:
            raise RuntimeError(f"int8 VAE B={bb} off its f32 twin: "
                               f"{rel8:.4f}")
    print(f"[VAE] full width on 'cuda', per forward (recon, mu, logvar vs "
          f"the 'torch' route, tol {TOL_VAE}; int8 gate "
          f"{n_sites}/127): {json.dumps(vae_serve)}")

    # three SGD steps of the -ELBO at B = 64, one step's gradients
    xs_v = [torch.from_numpy(vae_train.batch_at(vcfg, 64, s)).to(dev)
            for s in range(TRAIN_STEPS)]
    pv = v_params["float32"]
    gen_v = torch.Generator().manual_seed(7)
    zero_counts()
    vae_losses = []
    for s in range(TRAIN_STEPS):
        pv, loss = vae_train.sgd_step(pv, xs_v[s], gen_v, vcfg, VAE_LR)
        vae_losses.append(loss)
    torch.cuda.synchronize()
    vae_train_launches, stray = read_counts("float32")
    want_t = {"A": 2 * TRAIN_STEPS, "B": 2 * TRAIN_STEPS, "C": 0, "D": 0}
    if vae_train_launches != want_t or stray:
        raise RuntimeError(f"VAE train launches {vae_train_launches} "
                           f"(+{stray}), want {want_t}")
    if not (all(np.isfinite(vae_losses))
            and all(bool(torch.isfinite(v).all()) for v in pv.values())):
        raise RuntimeError(f"non-finite VAE training state: {vae_losses}")
    eps_g = torch.randn((64, vcfg.latent_dim),
                        generator=torch.Generator().manual_seed(8)).to(dev)

    def elbo_grads(cfg_):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in v_params["float32"].items()}
        loss_ = vae.elbo_loss(leaves, xs_v[0], None, cfg_, eps=eps_g)
        return float(loss_.detach()), dict(zip(leaves, torch.autograd.grad(
            loss_, list(leaves.values()))))

    loss_c, g_c = elbo_grads(vcfg)
    loss_t, g_t = elbo_grads(dataclasses.replace(vcfg, backend="torch"))
    torch.cuda.synchronize()
    grad_rel = {k: float((g_c[k] - g_t[k]).abs().max() / g_t[k].abs().max())
                for k in g_t}
    loss_rel = abs(loss_c - loss_t) / abs(loss_t)
    if not (max(grad_rel.values()) <= TOL_GRAD and loss_rel <= TOL_LOSS
            and all(bool(torch.isfinite(g).all()) for g in g_c.values())):
        raise RuntimeError(f"VAE gradients cuda vs torch {grad_rel}, loss "
                           f"{loss_rel:.3e}")
    with torch.inference_mode():
        imgs = vae.sample(pv, torch.Generator().manual_seed(9), vcfg, n=16)
    if imgs.shape != (16, vcfg.image_hw, vcfg.image_hw, vcfg.in_c) or not (
            bool(torch.isfinite(imgs).all())
            and float(imgs.abs().max()) <= 1.0):
        raise RuntimeError(f"VAE prior samples {tuple(imgs.shape)} not "
                           f"finite in [-1, 1]")
    print(f"[VAE train] B=64, {TRAIN_STEPS} SGD steps on 'cuda' (lr "
          f"{VAE_LR}): -ELBO {vae_losses}; launches {vae_train_launches} "
          f"(= {want_t}); one step's gradients cuda vs torch max|Δ|/max|g| "
          f"per tensor {json.dumps(grad_rel)} (tol {TOL_GRAD}), loss "
          f"{loss_rel:.3e} (tol {TOL_LOSS}); sample(n=16) "
          f"{tuple(imgs.shape)} finite")

    # ---- 4f. times: the VAE's sites, A's pad (1, 3) sites, per_phase ------
    print(f"[time VAE] kernels A and B at the VAE's sites, kernel A at its "
          f"other pad (1, 3) sites with the library call, the per_phase "
          f"route beside A; CUDA events; card {smi}")

    def conv_record(name, h, c, n, k, s, pads, b):
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        xp = pad_or_crop(x, pads).contiguous()
        sp = kern.reshape(k * k * c, n)
        xl, wl, kw = conv_library_args(xp, kern, (s, s), (1, 1))
        y_k = conv_call(xp, sp, k, s, 1)
        lib_err = check_library(f"{name} B={b}",
                                F.conv2d(xl, wl, **kw).permute(0, 2, 3, 1),
                                y_k)
        oh, ow = y_k.shape[1:3]
        flops = 2 * b * oh * ow * k * k * c * n
        nbytes = 4 * (xp.numel() + sp.numel() + y_k.numel())
        bound, by = bound_of(flops, nbytes)
        rec = {"site": name, "batch": b, "flops": flops, "bytes": nbytes,
               "ms": time_ms(lambda: conv_call(xp, sp, k, s, 1)),
               "device_ms": call_device_ms(lambda: conv_call(xp, sp, k, s, 1)),
               "plain_ms": time_ms(lambda: conv_call(xp, sp, k, s, 1,
                                                     plain=True)),
               "library": "F.conv2d",
               "library_ms": time_ms(lambda: F.conv2d(xl, wl, **kw)),
               "library_device_ms": call_device_ms(
                   lambda: F.conv2d(xl, wl, **kw)),
               "bound_ms": bound, "bound_by": by,
               "library_max_abs_err": lib_err,
               "schedule": conv_schedule_of(b, oh, ow, k, c, n)}
        print(f"[time VAE B] {name} B={b}: kernel {rec['ms']:.4f} ms "
              f"(device {ms_text(rec['device_ms'])}), plain "
              f"{rec['plain_ms']:.4f} ms, F.conv2d {rec['library_ms']:.4f} "
              f"ms (device {ms_text(rec['library_device_ms'])}), bound "
              f"{bound:.4f} ms ({by}); schedule "
              f"{json.dumps(rec['schedule'])}")
        return rec

    def deconv_record(name, plan, b, per_phase):
        sp_ = plan.spec
        x = randn(b, *sp_.in_hw, sp_.in_c)
        kern = randn(*sp_.kernel_hw, sp_.in_c, sp_.out_c)
        packed = plan.pack(kern)
        xg = pad_or_crop(x, plan.gpad).contiguous()
        try:
            xl, wl, kw = library_args(x, kern, sp_.strides, sp_.padding)
            crop, form = (slice(None), slice(None)), "F.conv_transpose2d"
        except ValueError:
            xl, wl, kw, crop = cropped_library_args(x, kern, sp_.strides,
                                                    sp_.padding)
            form = "cropped F.conv_transpose2d"

        def library():
            return F.conv_transpose2d(xl, wl, **kw)[:, :, crop[0], crop[1]]

        y_k = kernel_call(plan, xg, packed)
        lib_err = check_library(f"{name} B={b}",
                                library().permute(0, 2, 3, 1), y_k)
        flops = 2 * sum(b * ex.out_hw[0] * ex.out_hw[1] * ex.taps[0]
                        * ex.taps[1] for ex in plan.phases) \
            * sp_.in_c * sp_.out_c
        nbytes = 4 * (xg.numel() + packed.numel() + y_k.numel())
        bound, by = bound_of(flops, nbytes)
        rec = {"site": name, "batch": b, "flops": flops, "bytes": nbytes,
               "ms": time_ms(lambda: kernel_call(plan, xg, packed)),
               "device_ms": call_device_ms(
                   lambda: kernel_call(plan, xg, packed)),
               "plain_ms": time_ms(lambda: ref_call(plan, xg, packed),
                                   iters=5 if y_k.numel() > 2 ** 24 else 20),
               "library": form, "library_ms": time_ms(library),
               "library_device_ms": call_device_ms(library),
               "bound_ms": bound, "bound_by": by,
               "library_max_abs_err": lib_err,
               "schedule": schedule_of(plan, b)}
        extra = ""
        if per_phase:
            # every live phase is one launch of B (or C where the phase's
            # plane tiles), f32 and int8; the int8 plan's per-phase output
            # is bit-equal to the f32 one on the dequantized superpack
            live = sum(1 for ex in plan.phases
                       if ex.taps[0] * ex.taps[1] and ex.out_hw[0]
                       and ex.out_hw[1])
            plan8 = plan_conv(dataclasses.replace(sp_, wdtype="int8"))
            packed8 = plan8.pack(kern)
            zero_counts()
            y_pp = plan.apply_per_phase(x, packed)
            y_pp8 = plan8.apply_per_phase(x, packed8)
            torch.cuda.synchronize()
            n32, _ = read_counts("float32")
            n8, _ = read_counts("int8")
            launched = (n32["B"] + n32["C"], n8["B"] + n8["C"])
            if launched != (live, live) or sum(n32.values()) + sum(
                    n8.values()) != 2 * live:
                raise RuntimeError(
                    f"{name} per_phase B={b}: {live} live phases launched "
                    f"f32 {n32}, int8 {n8}")
            if not torch.equal(
                    y_pp8, plan.apply_per_phase(x, packed8.dequant())):
                raise RuntimeError(f"{name} per_phase B={b}: int8 not "
                                   f"bit-equal to f32 on the dequantized "
                                   f"superpack")
            rec["per_phase_b_launches"] = n32["B"]
            rec["per_phase_c_launches"] = n32["C"]
            rec["per_phase_max_abs_err"] = check_library(
                f"{name} per_phase B={b}", y_pp, y_k)
            rec["per_phase_ms"] = time_ms(
                lambda: plan.apply_per_phase(x, packed))
            rec["per_phase_device_ms"] = call_device_ms(
                lambda: plan.apply_per_phase(x, packed))
            extra = (f", per_phase {rec['per_phase_ms']:.4f} ms (device "
                     f"{ms_text(rec['per_phase_device_ms'])}; "
                     f"{live} live phases: {rec['per_phase_b_launches']} "
                     f"on kernel B, {rec['per_phase_c_launches']} on C, "
                     f"f32 and int8; int8 bit-equal to f32 on the "
                     f"dequantized superpack)")
        print(f"[time VAE A] {name} B={b}: kernel {rec['ms']:.4f} ms "
              f"(device {ms_text(rec['device_ms'])}), plain "
              f"{rec['plain_ms']:.4f} ms, {form} {rec['library_ms']:.4f} "
              f"ms (device {ms_text(rec['library_device_ms'])}), bound "
              f"{bound:.4f} ms ({by}){extra}; schedule "
              f"{json.dumps(rec['schedule'])}")
        return rec

    vae_b_sites, vae_a_sites, pad13_sites, pp_sites = [], [], [], []
    for b in VAE_BATCHES:
        for name, kind, h, c, n, k, s, pads in vae_sites():
            if kind == "conv":
                vae_b_sites.append(conv_record(name, h, c, n, k, s, pads, b))
            else:
                vae_a_sites.append(deconv_record(
                    name, site(h, c, n, k, s, pads), b, True))
        for tag, layers in (("cGAN", gan.CGAN_LAYERS),
                            ("DCGAN", gan.DCGAN_LAYERS)):
            for i, l in enumerate(layers):
                rec = deconv_record(f"{tag}_DC{i + 1}", site(
                    l.in_hw, l.in_c, l.out_c, l.kernel, l.stride,
                    gan.deconv_padding(l.kernel, l.stride)), b, True)
                (pad13_sites if tag == "cGAN" else pp_sites).append(rec)
    u32 = dataclasses.replace(unet.UNET, backend="cuda")
    u512 = unet.UNetConfig("unet-512", image_hw=UNET_512_HW, backend="cuda")
    for ucfg, batches in ((u32, VAE_BATCHES), (u512, UNET_512_BATCHES)):
        for name, plan in unet.unet_plans(ucfg).items():
            if plan.spec.kind == "transposed" \
                    and plan.routes[0].sp_tiles is None:
                for b in batches:
                    pad13_sites.append(deconv_record(
                        f"unet{ucfg.image_hw}_{name}", plan, b, False))

    vae_ms, vae_split = {}, {}
    with torch.inference_mode():
        for wdtype, c_ in v_cfgs.items():
            for b in (1, 4, 16, 64):
                xv, ev = randn(b, 32, 32, 3), randn(b, vcfg.latent_dim)

                def fwd(p_=v_params[wdtype], x_=xv, e_=ev, c__=c_):
                    return vae.vae_apply(p_, x_, None, c__, eps=e_)
                key = f"{wdtype}_B{b}"
                vae_ms[key] = time_ms(fwd, iters=10)
                if b in VAE_BATCHES:
                    vae_split[key] = forward_split(fwd, vae_ms[key])
    print(f"[time] VAE forward ms per bucket (CUDA events): "
          f"{json.dumps(vae_ms)}; device time by kernel, busy share "
          f"(torch.profiler): {json.dumps(vae_split)}")

    def elbo_step_ms(cfg_, iters=5):
        p_, g_ = v_params["float32"], torch.Generator().manual_seed(11)
        for _ in range(2):
            p_, _ = vae_train.sgd_step(p_, xs_v[0], g_, cfg_, VAE_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            p_, _ = vae_train.sgd_step(p_, xs_v[0], g_, cfg_, VAE_LR)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    elbo_ms = {backend: elbo_step_ms(dataclasses.replace(vcfg,
                                                         backend=backend))
               for backend in ("cuda", "torch")}
    print(f"[time] VAE ELBO step at B=64 (host clock over 5 steps after 2, "
          f"synchronized) ms: {json.dumps(elbo_ms)} | {smi}")

    # ---- 4g. measured route autotuning at the VAE and DCGAN sites ---------
    autotune_recs = []
    with tempfile.TemporaryDirectory() as tmp:
        cache_file = os.path.join(tmp, "route_cache.json")
        policy = at.AutotunePolicy(mode="measure", cache_path=cache_file)
        heur = {f"VAE_{i}": p for i, p in enumerate(vae.vae_plans(vcfg))}
        heur.update({f"DCGAN_DC{i + 1}": p for i, p in enumerate(
            gan.generator_plans(gan.GANConfig("dcgan", gan.DCGAN_LAYERS,
                                              backend="cuda")))})
        before = at.measure_calls()
        t0 = time.perf_counter()
        tuned = {name: plan_conv(p.spec, autotune=policy)
                 for name, p in heur.items()}
        tune_s = time.perf_counter() - t0
        measured = at.measure_calls() - before
        cache = at.open_cache(cache_file)
        for name, p in heur.items():
            ent = cache.entries[at.spec_key(p.spec)]
            for r in tuned[name].routes:
                h_r = p.route_for_batch(r.batch)
                us = ent["routes"][str(r.batch)]["measured_us"]
                b = r.batch
                sp_ = p.spec
                x = randn(b, *sp_.in_hw, sp_.in_c)
                kern = randn(*sp_.kernel_hw, sp_.in_c, sp_.out_c)
                packed = p.pack(kern)
                with torch.inference_mode():
                    y = tuned[name].apply(x, packed)
                    y_t = plan_conv(dataclasses.replace(
                        sp_, backend="torch")).apply(x, packed)
                if r.path == "cuda":
                    y64, bound = f64_bound(p, x, kern)
                    ok = bool(((y.double() - y64).abs() <= bound).all())
                    check = "f64 bound"
                    del y64, bound
                else:
                    ok = float((y - y_t).abs().max()) \
                        <= TOL_VAE * float(y_t.abs().max())
                    check = f"{TOL_VAE}·max|y_torch|"
                rec = {"site": name, "batch": b, "candidates_us": us,
                       "winner": at.route_label(r),
                       "heuristic": at.route_label(h_r),
                       "flipped": r != h_r, "checked": check, "ok": ok}
                autotune_recs.append(rec)
                print(f"[autotune] {name} B={b}: min µs "
                      + ", ".join(f"{lab} {v:.1f}" for lab, v in
                                  sorted(us.items(), key=lambda kv: kv[1]))
                      + f"; winner {rec['winner']} (heuristic "
                      f"{rec['heuristic']}, "
                      f"{'flipped' if rec['flipped'] else 'kept'}); output "
                      f"within {check}: {ok}")
                if not ok:
                    raise RuntimeError(f"tuned {name} B={b} "
                                       f"({rec['winner']}) off its check")
        # a second load reads the cache and measures nothing
        plan_cache_clear()
        before = at.measure_calls()
        cpolicy = at.AutotunePolicy(mode="cache", cache_path=cache_file)
        again = {name: plan_conv(p.spec, autotune=cpolicy)
                 for name, p in heur.items()}
        if at.measure_calls() != before or any(
                again[n].routes != tuned[n].routes for n in heur):
            raise RuntimeError("the warm route cache measured again or "
                               "gave other routes")
        # serve_dcgan on the cache: bucket costs measured once, then a
        # restarted server re-times no bucket and measures no route
        argv = ["--requests", str(BURST), "--route-cache", cache_file,
                "--device", str(dev)]
        plan_cache_clear()
        first = serve_dcgan.main(argv + ["--autotune", "measure"])
        plan_cache_clear()
        before = at.measure_calls()
        st = serve_dcgan.main(argv + ["--autotune", "cache"])
        if st["warmup_timed"] != () or at.measure_calls() != before:
            raise RuntimeError(f"the warm serve_dcgan timed buckets "
                               f"{st['warmup_timed']} or measured routes")
        cfg_s, params_s = serve_dcgan.load_model(
            small=False, backend="cuda", device=dev, autotune=cpolicy)
        worst = 0.0
        with torch.inference_mode():
            for r in st["requests"]:
                one = gan.generator_apply(
                    params_s, torch.from_numpy(r.payload)[None].to(dev),
                    cfg_s)[0].cpu()
                diff = (one - torch.from_numpy(r.out)).abs()
                worst = max(worst, float(diff.max()))
                if not bool((diff <= TOL_ROW * (1 + one.abs())).all()):
                    raise RuntimeError(f"tuned serve_dcgan request {r.rid} "
                                       f"differs from its B=1 forward by "
                                       f"{float(diff.max()):.3e}")
        if sorted(r.rid for r in st["requests"]) != list(range(BURST)):
            raise RuntimeError("tuned serve_dcgan dropped or repeated a "
                               "request")
    flips = [(r["site"], r["batch"], r["heuristic"], r["winner"])
             for r in autotune_recs if r["flipped"]]
    print(f"[autotune] {len(heur)} sites x 4 buckets tuned in {tune_s:.1f} "
          f"s ({measured} candidate measurements); flips {flips}; a second "
          f"load in 'cache' mode measured nothing and gave the same routes; "
          f"serve_dcgan --autotune cache: {len(st['requests'])}/{BURST} "
          f"answered, warmup timed {st['warmup_timed']} (first run timed "
          f"{first['warmup_timed']}), max |row - B=1 forward| {worst:.3e}")
    records = {"vae_serve": vae_serve, "vae_train_losses": vae_losses,
               "vae_grad_rel": grad_rel, "vae_b_sites": vae_b_sites,
               "vae_a_sites": vae_a_sites, "pad13_sites": pad13_sites,
               "per_phase_dcgan_sites": pp_sites, "vae_forward_ms": vae_ms,
               "vae_device_split": vae_split, "vae_elbo_step_ms": elbo_ms,
               "autotune": autotune_recs}
    launches = {"A": {"vae": sum(v["A"] for k, v in vae_launches.items()
                                 if "_float32_" in k),
                      "train_vae": vae_train_launches["A"]},
                "B": {"vae": sum(v["B"] for k, v in vae_launches.items()
                                 if "_float32_" in k),
                      "train_vae": vae_train_launches["B"]},
                "A_int8": {"vae_int8": sum(v["A"] for k, v in
                                           vae_launches.items()
                                           if "_int8_" in k)},
                "B_int8": {"vae_int8": sum(v["B"] for k, v in
                                           vae_launches.items()
                                           if "_int8_" in k)}}
    return records, launches


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32 throughout, as JAX's dots do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import reference as ref
    from repro_torch.core.plan import BATCH_BUCKETS
    from repro_torch.core.untangle import pad_or_crop
    from repro_torch.kernels import _build
    from repro_torch import serve_segnet, train_gan
    from repro_torch.kernels.untangled_conv import (
        _MIN_SLICE as MIN_SLICE, SMS, deconv_schedule,
        pick_block_tile_single,
        pick_block_tile_transposed, single_out_hw, tiled_conv_schedule,
        tiled_deconv_schedule,
        untangled_conv2d_superpack, untangled_conv2d_superpack_tiled_ref,
        untangled_deconv2d, untangled_deconv2d_tiled_ref)
    from repro_torch.models import gan, segnet, unet
    from repro_torch.runtime.compress import (dequantize_int8,
                                              quantize_int8_rows)
    from repro_torch.serving.image_batcher import DynamicImageBatcher
    from repro_torch.train.data import GANPipeline

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # ---- 1. environment + build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    peak_flops, peak_bw, peak_bf16 = card_peaks(card)
    print(f"[env] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | peaks fp32 {peak_flops / 1e12:.0f} TFLOP/s, bf16 tensor "
          f"cores {peak_bf16 / 1e12:.0f} TFLOP/s, HBM "
          f"{peak_bw / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    print(f"[build] {len(logs)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    f_ptxas = ptxas_report(logs.get("flash_attention", ""))
    a_ptxas = ptxas_report(logs.get("untangled_deconv", ""))
    b_ptxas = ptxas_report(logs.get("untangled_conv", ""))
    c_ptxas = ptxas_report(logs.get("untangled_conv_tiled", ""))
    d_ptxas = ptxas_report(logs.get("untangled_deconv_tiled", ""))
    for tag, recs in (("F", f_ptxas), ("A", a_ptxas), ("B", b_ptxas),
                      ("C", c_ptxas), ("D", d_ptxas)):
        for rec in recs:
            print(f"[build] kernel {tag} {rec['kernel']}: "
                  f"{rec.get('registers')} registers, "
                  f"{rec.get('stack_frame')} bytes stack frame, "
                  f"{rec.get('spill_stores')} bytes spill stores, "
                  f"{rec.get('spill_loads')} bytes spill loads")
    for tag, recs in (("A", a_ptxas), ("B", b_ptxas), ("C", c_ptxas),
                      ("D", d_ptxas)):
        spilled = [r["kernel"] for r in recs
                   if r.get("spill_stores") or r.get("spill_loads")]
        if len(recs) < 2 or spilled:
            raise RuntimeError(f"kernel {tag} instantiations that spill: "
                               f"{spilled} (of {len(recs)} reported)")
    # kernels C and D keep their ring slots as offsets, never as pointer
    # arrays in local memory: every instantiation has no stack frame
    framed = [r["kernel"] for r in c_ptxas + d_ptxas
              if r.get("stack_frame") != 0]
    if framed:
        raise RuntimeError(f"kernel C or D instantiations with a stack "
                           f"frame (local memory): {framed}")

    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def poison(*numels):
        # NaN-fill blocks the caching allocator will hand out next (the
        # output, then kernel A's workspace), so an element the kernel
        # leaves unwritten cannot pass as a value
        blocks = [torch.full((n,), float("nan"), device=dev)
                  for n in numels if n]
        del blocks

    def device_split(fn, wall_ms):
        """One call of ``fn`` (after the warm-up ``time_ms`` gave it) under
        ``torch.profiler``: device time of kernel B's launches and of
        everything else, summed over device-side events only, the idle
        share against ``wall_ms`` (its time measured without the profiler)
        and the host ops of most self CPU time (name, calls, ms); the idle
        share is None where the profiler caught no trace."""
        prof, evs = device_events(fn, 1, with_cpu=True)
        out = {"kernel_ms": 0.0, "other_ms": 0.0, "kernel_calls": 0,
               "other_calls": 0}
        for ev in evs or ():
            part = "kernel" if kernel_part(ev.name) == "B" else "other"
            out[f"{part}_ms"] += ev.device_time_total / 1e3
            out[f"{part}_calls"] += 1
        busy = out["kernel_ms"] + out["other_ms"]
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        out.update(device_busy_ms=busy, wall_ms=wall_ms,
                   idle_share=1 - busy / wall_ms if evs else None,
                   top_host_ops=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                                 for e in top[:8]])
        return out

    def fills_card(sch):
        """Kernel B's batch-1 rule: at least 132 work units, but for a K of
        fewer than ``_MIN_SLICE`` chunks, which the schedule keeps whole
        (a second pass costs more than it saves there)."""
        return sch["units"] >= SMS or sch["chunks"] < MIN_SLICE

    def int8_of(sp):
        """(q, scale, dequantized) of an f32 superpack whose middle row is
        zeroed first (an all-zero row: its scale floors, its codes are 0)."""
        sp = sp.clone()
        sp[sp.shape[0] // 2] = 0.0
        q, scale = quantize_int8_rows(sp)
        return q, scale, dequantize_int8(q, scale)

    # ---- 2. kernel A vs its plain version, both vs the f64 oracle ----------
    dc = gan.DCGAN_LAYERS
    pad52 = gan.deconv_padding(5, 2)
    cases = [(f"DCGAN_DC{i + 1}_B{b}", b, l.in_hw, l.in_c, l.out_c, l.kernel,
              l.stride, gan.deconv_padding(l.kernel, l.stride))
             for b in (1, 64) for i, l in enumerate(dc)]
    cases += [(f"cGAN_DC{i + 1}_B16", 16, l.in_hw, l.in_c, l.out_c,
               l.kernel, l.stride, gan.deconv_padding(l.kernel, l.stride))
              for i, l in enumerate(gan.CGAN_LAYERS)]
    cases += [(f"{name}_B{b}", b, h, c, n, k, s, pads) for b in VAE_BATCHES
              for name, kind, h, c, n, k, s, pads in vae_sites()
              if kind == "transposed"]
    cases += [("nonuniform_7_k5s2", 2, 7, 16, 8, 5, 2, ((1, 1), (1, 1))),
              ("empty_phase_4_k2s3", 2, 4, 8, 8, 2, 3, ((1, 1), (1, 1))),
              ("ragged_C5_N3", 3, 5, 5, 3, 3, 2, ((1, 1), (1, 1))),
              ("ragged_C6_N20", 2, 6, 6, 20, 5, 2, pad52),
              ("ragged_C8_N36", 2, 6, 8, 36, 5, 2, pad52)]
    max_err = 0.0
    for name, b, h, c, n, k, s, pads in cases:
        plan = site(h, c, n, k, s, pads)
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        packed = plan.pack(kern)
        xg = pad_or_crop(x, plan.gpad)
        numels = (b * plan.out_hw[0] * plan.out_hw[1] * n,
                  deconv_schedule(tuple(plan.phases), b, c,
                                  n).workspace_bytes // 4)
        poison(*numels)
        y_k = kernel_call(plan, xg, packed)
        y_r = ref_call(plan, xg, packed)
        poison(*numels)
        again = torch.equal(kernel_call(plan, xg, packed), y_k)
        torch.cuda.synchronize()
        y64, bound = f64_bound(plan, x, kern)
        ok_k = bool(((y_k.double() - y64).abs() <= bound).all())
        ok_r = bool(((y_r.double() - y64).abs() <= bound).all())
        err = float((y_k - y_r).abs().max())
        max_err = max(max_err, err)
        print(f"[kernel] {name}: out {tuple(y_k.shape)} |kernel-plain| "
              f"{err:.3e} kernel<=ulp_bound {ok_k} plain<=ulp_bound {ok_r} "
              f"(max bound {float(bound.max()):.3e}); two launches "
              f"bit-equal {again}; {schedule_of(plan, b)}")
        if not (ok_k and ok_r and again and torch.isfinite(y_k).all()):
            raise RuntimeError(f"kernel A disagrees on {name}")
        if name.startswith("empty_phase"):
            empty = [ex for ex in plan.phases if ex.taps[0] * ex.taps[1] == 0]
            if not empty or any(bool(y_k[:, ex.q[0]::s, ex.q[1]::s].ne(0).any())
                                for ex in empty):
                raise RuntimeError("empty phases are not zero")

    # ---- 2b. kernel B vs its plain version, both vs the f64 oracle --------
    conv_cases = [(f"{name}_B{b}", b, h, c, n, k, s, 1, pads)
                  for b in (1, 64)
                  for name, h, c, n, k, s, pads in disc_sites()
                  if name.startswith("DCGAN")]
    conv_cases += [(f"{name}_B16", 16, h, c, n, k, s, 1, pads)
                   for name, h, c, n, k, s, pads in disc_sites()
                   if name.startswith("cGAN")]
    vae_conv_cases = [(f"{name}_B{b}", b, h, c, n, k, s, 1, pads)
                      for b in VAE_BATCHES
                      for name, kind, h, c, n, k, s, pads in vae_sites()
                      if kind == "conv"]
    conv_cases += vae_conv_cases
    conv_cases += [("dilated_17_k3_d2", 4, 17, 16, 32, 3, 1, 2,
                    ((2, 2), (2, 2))),
                   ("dilated_17_k3_d4", 4, 17, 16, 32, 3, 1, 4,
                    ((4, 4), (4, 4))),
                   ("ragged_C5_N3", 3, 9, 5, 3, 3, 2, 1, ((1, 1), (1, 1))),
                   ("ragged_C6_N20", 2, 9, 6, 20, 5, 1, 1, ((2, 2), (2, 2))),
                   ("odd_9_k5s2", 2, 9, 8, 8, 5, 2, 1, ((2, 2), (2, 2)))]
    max_err_b = 0.0
    for name, b, h, c, n, k, s, d, pads in conv_cases:
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        xp = pad_or_crop(x, pads).contiguous()
        sp = kern.reshape(k * k * c, n)
        oh, ow = single_out_hw(xp.shape[1], xp.shape[2], (k, k), (s, s),
                               (d, d))
        sch = conv_schedule_of(b, oh, ow, k, c, n)
        numels = (b * oh * ow * n, sch["workspace_bytes"] // 4)
        poison(*numels)
        y_k = conv_call(xp, sp, k, s, d)
        y_r = conv_call(xp, sp, k, s, d, plain=True)
        poison(*numels)
        again = torch.equal(conv_call(xp, sp, k, s, d), y_k)
        torch.cuda.synchronize()
        y64, amax = ref.conv_oracle_f64(x, kern, strides=(s, s),
                                        dilation=(d, d), padding=pads)
        bound = ref.ulp_bound(y64, amax, k * k * c)
        ok_k = bool(((y_k.double() - y64).abs() <= bound).all())
        ok_r = bool(((y_r.double() - y64).abs() <= bound).all())
        err = float((y_k - y_r).abs().max())
        max_err_b = max(max_err_b, err)
        print(f"[kernel B] {name}: out {tuple(y_k.shape)} |kernel-plain| "
              f"{err:.3e} kernel<=ulp_bound {ok_k} plain<=ulp_bound {ok_r} "
              f"(n_terms {k * k * c}, max bound {float(bound.max()):.3e}); "
              f"two launches bit-equal {again}; {sch}")
        if not (ok_k and ok_r and again and torch.isfinite(y_k).all()):
            raise RuntimeError(f"kernel B disagrees on {name}")

    # ---- 2c. kernel B int8 (kernel E) vs plain, f64 oracle, f32 kernel ----
    i8_conv_cases = [(f"{name}_B{b}", b, h, c, n, k, s, d, pads)
                     for b in (1, 64)
                     for name, h, c, n, k, s, d, pads in seg_sites()]
    i8_conv_cases += [(f"{name}_B16", 16, h, c, n, k, s, 1, pads)
                      for name, h, c, n, k, s, pads in disc_sites()]
    i8_conv_cases += vae_conv_cases
    i8_conv_cases += [("ragged_C5_N3", 3, 9, 5, 3, 3, 2, 1, ((1, 1), (1, 1))),
                      ("ragged_C6_N20", 2, 9, 6, 20, 5, 1, 1,
                       ((2, 2), (2, 2)))]
    max_err_bi8 = 0.0
    for name, b, h, c, n, k, s, d, pads in i8_conv_cases:
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        xp = pad_or_crop(x, pads).contiguous()
        q, scale, wd = int8_of(kern.reshape(k * k * c, n))
        oh, ow = single_out_hw(xp.shape[1], xp.shape[2], (k, k), (s, s),
                               (d, d))
        sch = conv_schedule_of(b, oh, ow, k, c, n)
        numels = (b * oh * ow * n, sch["workspace_bytes"] // 4)
        poison(*numels)
        y_k = conv_call(xp, q, k, s, d, scales=scale)
        y_r = conv_call(xp, q, k, s, d, plain=True, scales=scale)
        poison(*numels)
        y_f = conv_call(xp, wd, k, s, d)
        poison(*numels)
        again = torch.equal(conv_call(xp, q, k, s, d, scales=scale), y_k)
        torch.cuda.synchronize()
        y64, amax = ref.conv_oracle_f64(x, wd.reshape(k, k, c, n),
                                        strides=(s, s), dilation=(d, d),
                                        padding=pads)
        bound = ref.ulp_bound(y64, amax, k * k * c)
        ok_k = bool(((y_k.double() - y64).abs() <= bound).all())
        ok_r = bool(((y_r.double() - y64).abs() <= bound).all())
        bit = torch.equal(y_k, y_f)
        err = float((y_k - y_r).abs().max())
        max_err_bi8 = max(max_err_bi8, err)
        print(f"[kernel B int8] {name}: out {tuple(y_k.shape)} "
              f"|kernel-plain| {err:.3e} kernel<=ulp_bound {ok_k} "
              f"plain<=ulp_bound {ok_r} bit-equal to f32 kernel on "
              f"dequant {bit} (n_terms {k * k * c}); two launches bit-equal "
              f"{again}; {sch}")
        if not (ok_k and ok_r and bit and again
                and torch.isfinite(y_k).all()):
            raise RuntimeError(f"kernel B int8 disagrees on {name}")

    # ---- 2d. kernel A int8 (kernel E) vs plain, f64 oracle, f32 kernel ----
    max_err_ai8 = 0.0
    for name, b, h, c, n, k, s, pads in cases:
        plan = site(h, c, n, k, s, pads)
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        q, scale, wd = int8_of(plan.pack(kern))
        xg = pad_or_crop(x, plan.gpad)
        numels = (b * plan.out_hw[0] * plan.out_hw[1] * n,
                  deconv_schedule(tuple(plan.phases), b, c,
                                  n).workspace_bytes // 4)
        poison(*numels)
        y_k = kernel_call(plan, xg, q, scales=scale)
        y_r = ref_call(plan, xg, q, scales=scale)
        y_f = kernel_call(plan, xg, wd)
        poison(*numels)
        again = torch.equal(kernel_call(plan, xg, q, scales=scale), y_k)
        torch.cuda.synchronize()
        y64, bound = f64_bound(plan, x, plan.unpack(wd))
        ok_k = bool(((y_k.double() - y64).abs() <= bound).all())
        ok_r = bool(((y_r.double() - y64).abs() <= bound).all())
        bit = torch.equal(y_k, y_f)
        err = float((y_k - y_r).abs().max())
        max_err_ai8 = max(max_err_ai8, err)
        print(f"[kernel A int8] {name}: out {tuple(y_k.shape)} "
              f"|kernel-plain| {err:.3e} kernel<=ulp_bound {ok_k} "
              f"plain<=ulp_bound {ok_r} bit-equal to f32 kernel on "
              f"dequant {bit}; two launches bit-equal {again}")
        if not (ok_k and ok_r and bit and again
                and torch.isfinite(y_k).all()):
            raise RuntimeError(f"kernel A int8 disagrees on {name}")

    # ---- 2e. kernel C (tiled B) f32 and int8 vs plain, f64 oracle ---------
    unet512 = unet.UNetConfig("unet-512", image_hw=UNET_512_HW,
                              backend="cuda")
    hw512 = unet512.image_hw
    u_plans = unet.unet_plans(unet512)
    tiled_c = [(n, p) for n, p in u_plans.items()
               if p.routes[0].sp_tiles is not None
               and p.spec.kind != "transposed"]
    tiled_d = [(n, p) for n, p in u_plans.items()
               if p.routes[0].sp_tiles is not None
               and p.spec.kind == "transposed"]
    if [n for n, _ in tiled_c] != ["stem", "down0", "fuse0", "head"] or \
            [n for n, _ in tiled_d] != ["up0"]:
        raise RuntimeError(f"U-Net 512 tiled sites {tiled_c} {tiled_d}")

    def tiled_conv_call(xp, sp, r, s_, st, d, tile, plain=False, **scales):
        fn = untangled_conv2d_superpack_tiled_ref if plain \
            else untangled_conv2d_superpack
        return fn(xp, sp, taps_hw=(r, s_), strides=(st, st),
                  rhs_dilation=(d, d), sp_tiles=tile, **scales)

    def tiled_schedule_of(out_hw, r, s_, st, d, c, n, tile):
        """Kernel C's layout of one call: tile, BN, tap loop, pixel
        spacing, staged halo and row pitch, ring stages, threads, blocks an
        SM, shared memory, tiles."""
        sch = tiled_conv_schedule(tuple(out_hw), (r, s_), (st, st), (d, d),
                                  c, n, tuple(tile))
        return {"tile": sch.tile, "bn": sch.bn, "path": sch.path,
                "pd": sch.pd, "halo": sch.halo, "pitch": sch.pitch,
                "stages": sch.stages, "threads": sch.threads,
                "blocks_sm": sch.blocks_sm, "smem_bytes": sch.smem_bytes,
                "tiles": sch.tiles}

    c_cases = []
    for name, plan in tiled_c:
        sp_ = plan.spec
        c_cases.append((f"unet512_{name}_B1", 1,
                        sp_.in_hw[0] + sum(sp_.padding[0]),
                        sp_.in_hw[1] + sum(sp_.padding[1]), sp_.in_c,
                        sp_.out_c,
                        *sp_.kernel_hw, sp_.strides[0], 1,
                        plan.routes[0].sp_tiles))
    c_cases += TILED_CONV_CASES
    max_err_c = max_err_ci8 = 0.0
    for name, b, hp, wp, c, n, r, s_, st, d, tile in c_cases:
        oh, ow = single_out_hw(hp, wp, (r, s_), (st, st), (d, d))
        if tile is None:
            tile = pick_block_tile_single((oh, ow), (r, s_), (st, st),
                                          (d, d), n)
        xp, kern = randn(b, hp, wp, c), randn(r, s_, c, n)
        sp = kern.reshape(r * s_ * c, n)
        q, scale, wd = int8_of(sp)
        poison(b * oh * ow * n)
        y_k = tiled_conv_call(xp, sp, r, s_, st, d, tile)
        y_r = tiled_conv_call(xp, sp, r, s_, st, d, tile, plain=True)
        poison(b * oh * ow * n)
        again = torch.equal(tiled_conv_call(xp, sp, r, s_, st, d, tile), y_k)
        poison(b * oh * ow * n)
        y_k8 = tiled_conv_call(xp, q, r, s_, st, d, tile, scales=scale)
        y_r8 = tiled_conv_call(xp, q, r, s_, st, d, tile, plain=True,
                               scales=scale)
        y_f = tiled_conv_call(xp, wd, r, s_, st, d, tile)
        poison(b * oh * ow * n)
        again8 = torch.equal(
            tiled_conv_call(xp, q, r, s_, st, d, tile, scales=scale), y_k8)
        torch.cuda.synchronize()
        oks = []
        for yk, yr, w_ in ((y_k, y_r, kern), (y_k8, y_r8, wd)):
            y64, amax = ref.conv_oracle_f64(xp, w_.reshape(r, s_, c, n),
                                            strides=(st, st),
                                            dilation=(d, d))
            bound = ref.ulp_bound(y64, amax, r * s_ * c)
            oks += [bool(((yk.double() - y64).abs() <= bound).all()),
                    bool(((yr.double() - y64).abs() <= bound).all())]
            del y64, amax, bound
        bit = torch.equal(y_k8, y_f)
        err, err8 = (float((y_k - y_r).abs().max()),
                     float((y_k8 - y_r8).abs().max()))
        max_err_c, max_err_ci8 = max(max_err_c, err), max(max_err_ci8, err8)
        print(f"[kernel C] {name}: out {tuple(y_k.shape)} "
              f"|kernel-plain| f32 {err:.3e} int8 {err8:.3e}; within "
              f"ulp_bound (f32 kernel, plain, int8 kernel, plain) {oks}; "
              f"int8 bit-equal to f32 on dequant {bit}; two launches "
              f"bit-equal f32 {again} int8 {again8} (n_terms {r * s_ * c}); "
              f"schedule "
              f"{tiled_schedule_of((oh, ow), r, s_, st, d, c, n, tile)}")
        if not (all(oks) and bit and again and again8
                and torch.isfinite(y_k).all()
                and torch.isfinite(y_k8).all()):
            raise RuntimeError(f"kernel C disagrees on {name}")

    # ---- 2f. kernel D (tiled A) f32 and int8 vs plain, f64 oracle ---------
    def tiled_deconv_call(plan, xg, packed, tile, plain=False, **scales):
        if plain:
            return untangled_deconv2d_tiled_ref(
                xg, packed, phases=plan.phases, out_hw=plan.out_hw,
                strides=plan.spec.strides, sp_tiles=tile, **scales)
        return untangled_deconv2d(xg, packed, phases=plan.phases,
                                  out_hw=plan.out_hw,
                                  strides=plan.spec.strides,
                                  sum_uv=plan.sum_uv, sp_tiles=tile,
                                  **scales)

    def tiled_deconv_schedule_of(plan, c, n, tile):
        """Kernel D's layout of one call: tap loop, BN, register split
        (pixels x phases a thread, threads a block, blocks an SM), tile,
        pixel groups a tile row and a phase, staged halo and row pitch,
        ring stages, shared memory, tiles."""
        sch = tiled_deconv_schedule(tuple(plan.phases), plan.out_hw, c, n,
                                    tuple(tile))
        return {"path": sch.path, "bn": sch.bn,
                "split": (sch.tm, sch.tp, sch.threads, sch.blocks_sm),
                "tile": sch.tile, "gpr": sch.gpr, "gpp": sch.gpp,
                "halo": sch.halo, "pitch": sch.pitch, "stages": sch.stages,
                "smem_bytes": sch.smem_bytes, "tiles": sch.tiles}

    d_cases = [(f"unet512_{name}_B1", 1, p.spec.in_hw[0], p.spec.in_c,
                p.spec.out_c, p.spec.kernel_hw[0], p.spec.strides[0],
                p.spec.padding, p.routes[0].sp_tiles) for name, p in tiled_d]
    d_cases += TILED_DECONV_CASES
    max_err_d = max_err_di8 = 0.0
    for name, b, h, c, n, k, s_, pads, tile in d_cases:
        plan = site(h, c, n, k, s_, pads)
        if tile is None:
            tile = pick_block_tile_transposed(plan.phases, n)
        x, kern = randn(b, h, h, c), randn(k, k, c, n)
        packed = plan.pack(kern)
        q, scale, wd = int8_of(packed)
        xg = pad_or_crop(x, plan.gpad).contiguous()
        numel = b * plan.out_hw[0] * plan.out_hw[1] * n
        poison(numel)
        y_k = tiled_deconv_call(plan, xg, packed, tile)
        y_r = tiled_deconv_call(plan, xg, packed, tile, plain=True)
        poison(numel)
        again = torch.equal(tiled_deconv_call(plan, xg, packed, tile), y_k)
        poison(numel)
        y_k8 = tiled_deconv_call(plan, xg, q, tile, scales=scale)
        y_r8 = tiled_deconv_call(plan, xg, q, tile, plain=True, scales=scale)
        y_f = tiled_deconv_call(plan, xg, wd, tile)
        poison(numel)
        again8 = torch.equal(
            tiled_deconv_call(plan, xg, q, tile, scales=scale), y_k8)
        # the library yardstick of the U-Net's up sites (phase 4d), held to
        # the same f64 bound before it is timed there
        y_lib = None
        if name.startswith("unet512_"):
            xl, wl, kw, crop = cropped_library_args(x, kern, (s_, s_), pads)
            y_lib = F.conv_transpose2d(xl, wl, **kw)[:, :, crop[0], crop[1]]
            y_lib = y_lib.permute(0, 2, 3, 1)
            del xl
        torch.cuda.synchronize()
        oks, lib_ok = [], None
        for yk, yr, w_ in ((y_k, y_r, kern), (y_k8, y_r8, plan.unpack(wd))):
            y64, bound = f64_bound(plan, x, w_)
            oks += [bool(((yk.double() - y64).abs() <= bound).all()),
                    bool(((yr.double() - y64).abs() <= bound).all())]
            if y_lib is not None and lib_ok is None:
                lib_ok = bool(((y_lib.double() - y64).abs() <= bound).all())
            del y64, bound
        bit = torch.equal(y_k8, y_f)
        empty_ok = all(not bool(y[:, ex.q[0]::s_, ex.q[1]::s_].ne(0).any())
                       for ex in plan.phases if ex.taps[0] * ex.taps[1] == 0
                       for y in (y_k, y_k8))
        err, err8 = (float((y_k - y_r).abs().max()),
                     float((y_k8 - y_r8).abs().max()))
        max_err_d, max_err_di8 = max(max_err_d, err), max(max_err_di8, err8)
        print(f"[kernel D] {name}: out {tuple(y_k.shape)} tile {tile} "
              f"|kernel-plain| f32 {err:.3e} int8 {err8:.3e}; within "
              f"ulp_bound (f32 kernel, plain, int8 kernel, plain) {oks}; "
              f"int8 bit-equal to f32 on dequant {bit}; two launches "
              f"bit-equal f32 {again} int8 {again8}; empty phases zero "
              f"{empty_ok}"
              + ("" if lib_ok is None else f"; the cropped "
                 f"F.conv_transpose2d within ulp_bound {lib_ok}")
              + f"; schedule {tiled_deconv_schedule_of(plan, c, n, tile)}")
        if not (all(oks) and bit and again and again8 and empty_ok
                and lib_ok is not False and torch.isfinite(y_k).all()
                and torch.isfinite(y_k8).all()):
            raise RuntimeError(f"kernel D disagrees on {name}")

    # ---- 3. serving at full width on the 'cuda' route ----------------------
    cfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="cuda")
    plans = gan.generator_plans(cfg)
    bad = [(i, r.batch, r.path) for i, p in enumerate(plans)
           for r in p.routes if r.path != "cuda"]
    if bad:
        raise RuntimeError(f"sites off the cuda route: {bad}")
    params = gan.generator_init(0, cfg, device=dev)
    batcher = DynamicImageBatcher(
        lambda z: gan.generator_apply(params, z, cfg), device=dev)
    proto = torch.zeros(cfg.z_dim).numpy()
    batcher.warmup(proto)
    rng = torch.Generator().manual_seed(1)
    lat = torch.randn((BURST, cfg.z_dim), generator=rng).numpy()
    untangled_deconv2d.launches = 0
    done = batcher.drive_open_loop(lambda i: lat[i], BURST)
    launches = untangled_deconv2d.launches
    st = batcher.stats()
    if sorted(r.rid for r in done) != list(range(BURST)):
        raise RuntimeError("a request was dropped or answered twice")
    if launches != 4 * len(batcher.launches) or launches == 0:
        raise RuntimeError(f"{launches} kernel launches for "
                           f"{len(batcher.launches)} batcher launches")
    worst = 0.0
    with torch.inference_mode():
        for r in done:
            if r.out.shape != (64, 64, 3) or not torch.isfinite(
                    torch.from_numpy(r.out)).all():
                raise RuntimeError(f"request {r.rid}: bad output")
            one = gan.generator_apply(
                params, torch.from_numpy(lat[r.rid][None]).to(dev), cfg)
            diff = (one[0].cpu() - torch.from_numpy(r.out)).abs()
            worst = max(worst, float(diff.max()))
            if not bool((diff <= TOL_ROW * (1 + one[0].cpu().abs())).all()):
                raise RuntimeError(f"request {r.rid} differs from its B=1 "
                                   f"forward by {float(diff.max()):.3e}")
    print(f"[serve] {st['completed']}/{BURST} answered once, batcher "
          f"launches {batcher.launches}, kernel launches {launches} "
          f"(= 4 x {len(batcher.launches)}), max |row - B=1 forward| "
          f"{worst:.3e} (tol {TOL_ROW}), p50 {st['p50_ms']:.3f} ms, "
          f"p99 {st['p99_ms']:.3f} ms")

    # ---- 3b. training at full width on the 'cuda' route --------------------
    tcfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="cuda")
    t_plans = gan.generator_plans(tcfg) + gan.discriminator_plans(tcfg)
    bad = [(p.spec.kind, p.spec.in_hw, r.batch, r.path) for p in t_plans
           for r in p.routes if r.path != "cuda"]
    if bad:
        raise RuntimeError(f"training sites off the cuda route: {bad}")
    gp = gan.generator_init(2, tcfg, device=dev)
    dp = gan.discriminator_init(3, tcfg, device=dev)
    pipe = GANPipeline(tcfg, TRAIN_BATCH, image_hw=64)

    def batch_on_card(step):
        bt = pipe.batch_at(step)
        return (torch.from_numpy(bt["z"]).to(dev),
                torch.from_numpy(bt["real"]).to(dev))

    z0, real0 = batch_on_card(0)
    gp0, dp0 = gp, dp
    untangled_deconv2d.launches = 0
    untangled_conv2d_superpack.launches = 0
    losses = []
    for step in range(TRAIN_STEPS):
        z, real = batch_on_card(step)
        gp, dp, gl, dl = train_gan.train_step(gp, dp, z, real, tcfg, 2e-4)
        losses.append((float(gl), float(dl)))
    torch.cuda.synchronize()
    train_launches = {"A": untangled_deconv2d.launches,
                      "B": untangled_conv2d_superpack.launches}
    n_layers = len(tcfg.layers)
    # per step: two passes (d-grads, g-grads), each one generator (A at
    # every generator site) and two discriminators (B at every disc site)
    want = {"A": TRAIN_STEPS * 2 * n_layers, "B": TRAIN_STEPS * 4 * n_layers}
    if train_launches != want:
        raise RuntimeError(f"train launches {train_launches}, want {want}")
    if not all(torch.isfinite(torch.tensor(l)).all() for l in losses) or \
            not all(bool(torch.isfinite(v).all())
                    for v in list(gp.values()) + list(dp.values())):
        raise RuntimeError(f"non-finite training state: losses {losses}")
    # one step's gradients, 'cuda' against 'torch', same params and batch
    ccfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="torch")
    out_c = train_gan.step_grads(gp0, dp0, z0, real0, tcfg)
    out_t = train_gan.step_grads(gp0, dp0, z0, real0, ccfg)
    # fp32 noise floor of the comparison: the 'torch' route again with every
    # latent moved by one ulp
    out_n = train_gan.step_grads(
        gp0, dp0, torch.nextafter(z0, torch.full_like(z0, float("inf"))),
        real0, ccfg)
    torch.cuda.synchronize()
    worst_grad, leaf_lines, bad = 0.0, [], []
    for i, who in ((2, "g"), (3, "d")):
        gc_, gt_, gn_ = out_c[i], out_t[i], out_n[i]
        for k in gt_:
            scale = float(gt_[k].abs().max()) or float("nan")
            rel = float((gc_[k] - gt_[k]).abs().max()) / scale
            noise = float((gn_[k] - gt_[k]).abs().max()) / scale
            worst_grad = max(worst_grad, rel)
            leaf_lines.append(f"{who}.{k} max|g| {scale:.3e} max|Δ|/max|g| "
                              f"{rel:.3e} (1-ulp z nudge {noise:.3e})")
            if not (rel <= TOL_GRAD and bool(torch.isfinite(gc_[k]).all())):
                bad.append(leaf_lines[-1])
    print("[train] one step's gradients per tensor, cuda vs torch: "
          + "; ".join(leaf_lines))
    if bad:
        raise RuntimeError(f"gradients off by more than {TOL_GRAD} of their "
                           f"scale (or non-finite): {bad}")
    loss_rel = max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in zip(out_c[:2], out_t[:2]))
    if loss_rel > TOL_LOSS:
        raise RuntimeError(f"losses differ by {loss_rel:.3e} of their size")
    print(f"[train] DCGAN full width, B={TRAIN_BATCH}, {TRAIN_STEPS} SGD "
          f"steps on 'cuda': (g_loss, d_loss) {losses}; launches "
          f"{train_launches} (= {want}); one step's gradients cuda vs torch "
          f"max|Δ|/max|g| {worst_grad:.3e} (tol {TOL_GRAD}), losses "
          f"|Δ|/|loss| {loss_rel:.3e} (tol {TOL_LOSS})")

    # ---- 3c. SegNet serving at full width, f32 and int8, on 'cuda' --------
    seg_serve = {}
    seg_launches = {}
    for wdtype in ("float32", "int8"):
        scfg, sparams = serve_segnet.load_model(
            full=True, backend="cuda", wdtype=wdtype, device=dev)
        splans = segnet.segnet_plans(scfg)
        bad = [(i, r.batch, r.path) for i, p in enumerate(splans)
               for r in p.routes if r.path != "cuda"]
        if bad or len(splans) != 10:
            raise RuntimeError(f"SegNet sites off the cuda route: {bad}")

        def seg_fn(x, p=sparams, c=scfg):
            return torch.argmax(segnet.segnet_apply(p, x, c), dim=-1)

        sb = DynamicImageBatcher(seg_fn, device=dev)
        sb.warmup(torch.zeros((scfg.in_hw, scfg.in_hw, scfg.in_c)).numpy())
        imgs = (torch.rand((BURST, scfg.in_hw, scfg.in_hw, scfg.in_c),
                           generator=torch.Generator().manual_seed(4))
                * 2 - 1).numpy()
        untangled_conv2d_superpack.launches = 0
        untangled_conv2d_superpack.launches_int8 = 0
        done = sb.drive_open_loop(lambda i: imgs[i], BURST)
        got = {"float32": untangled_conv2d_superpack.launches,
               "int8": untangled_conv2d_superpack.launches_int8}
        st = sb.stats()
        want = {w: (10 * len(sb.launches) if w == wdtype else 0)
                for w in got}
        if sorted(r.rid for r in done) != list(range(BURST)):
            raise RuntimeError("a SegNet request was dropped or answered "
                               "twice")
        if got != want or not sb.launches:
            raise RuntimeError(f"SegNet {wdtype}: kernel B launches {got}, "
                               f"want {want} (10 per batcher launch)")
        seg_launches[wdtype] = got[wdtype]
        with torch.inference_mode():
            for r in done:
                one = seg_fn(torch.from_numpy(imgs[r.rid][None]).to(dev))
                if r.out.shape != (scfg.out_hw, scfg.out_hw) or \
                        not (one[0].cpu().numpy() == r.out).all():
                    raise RuntimeError(f"SegNet {wdtype} request {r.rid}: "
                                       f"served map differs from its B=1 "
                                       f"forward's")
        gate = None
        if wdtype == "int8":
            gate = serve_segnet.int8_gate(scfg, sparams, dev)
            if gate["int8_bytes"] > 0.5 * gate["f32_bytes"]:
                raise RuntimeError(f"int8 SegNet weights too large: {gate}")
        seg_serve[wdtype] = {
            "batcher_launches": sb.launches, "kernel_b_launches": got,
            "img_per_s": st["throughput_rps"], "p50_ms": st["p50_ms"],
            "p99_ms": st["p99_ms"], "int8_gate": gate,
            "forward_ms": {}}
        with torch.inference_mode():
            for bb in BATCH_BUCKETS:
                xb = randn(bb, scfg.in_hw, scfg.in_hw, scfg.in_c)
                seg_serve[wdtype]["forward_ms"][bb] = time_ms(
                    lambda: segnet.segnet_apply(sparams, xb, scfg), iters=10)
                if bb in (1, 64):
                    seg_serve[wdtype][f"device_split_B{bb}"] = device_split(
                        lambda: segnet.segnet_apply(sparams, xb, scfg),
                        seg_serve[wdtype]["forward_ms"][bb])
        print(f"[serve SegNet {wdtype}] {st['completed']}/{BURST} answered "
              f"once, batcher launches {sb.launches}, kernel B launches "
              f"{got} (= 10 x {len(sb.launches)}), every map == its B=1 "
              f"forward's; {st['throughput_rps']:.1f} img/s, p50 "
              f"{st['p50_ms']:.3f} ms; forward ms per bucket "
              f"{json.dumps(seg_serve[wdtype]['forward_ms'])}"
              + (f"; int8 gate {json.dumps(gate)}" if gate else "")
              + f" | {smi}")

    # ---- 3d. the int8 DCGAN generator served on 'cuda' --------------------
    qcfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="cuda",
                         wdtype="int8")
    qparams = gan.generator_init(0, qcfg, device=dev)
    qb = DynamicImageBatcher(
        lambda z: gan.generator_apply(qparams, z, qcfg), device=dev)
    qb.warmup(proto)
    untangled_deconv2d.launches = 0
    untangled_deconv2d.launches_int8 = 0
    done = qb.drive_open_loop(lambda i: lat[i], BURST)
    q_launches = {"float32": untangled_deconv2d.launches,
                  "int8": untangled_deconv2d.launches_int8}
    if sorted(r.rid for r in done) != list(range(BURST)):
        raise RuntimeError("an int8 DCGAN request was dropped or answered "
                           "twice")
    if q_launches != {"float32": 0, "int8": 4 * len(qb.launches)} \
            or not qb.launches:
        raise RuntimeError(f"int8 DCGAN kernel A launches {q_launches}")
    with torch.inference_mode():
        for r in done:
            one = gan.generator_apply(
                qparams, torch.from_numpy(lat[r.rid][None]).to(dev), qcfg)
            diff = (one[0].cpu() - torch.from_numpy(r.out)).abs()
            if not bool((diff <= TOL_ROW * (1 + one[0].cpu().abs())).all()):
                raise RuntimeError(f"int8 request {r.rid} differs from its "
                                   f"B=1 forward by {float(diff.max()):.3e}")
        zb = torch.from_numpy(lat).to(dev)
        yq = gan.generator_apply(qparams, zb, qcfg)
        yf = gan.generator_apply(params, zb, cfg)
    dcgan_rel = float((yq - yf).abs().max() / yf.abs().max())
    if not dcgan_rel <= len(qcfg.layers) / 127.0:
        raise RuntimeError(f"int8 DCGAN off its f32 twin: {dcgan_rel:.4f}")
    print(f"[serve DCGAN int8] {len(done)}/{BURST} answered once, batcher "
          f"launches {qb.launches}, kernel A launches {q_launches} "
          f"(= 4 x {len(qb.launches)}), rows == B=1 forwards; output rel "
          f"L-inf vs the f32 twin {dcgan_rel:.4e} (bound "
          f"{len(qcfg.layers) / 127.0:.4f})")

    # ---- 3e. the U-Net, f32 and int8, on the 'cuda' route ------------------
    unet32 = dataclasses.replace(unet.UNET, backend="cuda")
    unet_serve, unet_launches = {}, {}
    u_params = {}
    for cfg_u, batches, want in (
            (unet32, UNET_32_BATCHES, {"A": 2, "B": 8, "C": 0, "D": 0}),
            (unet512, UNET_512_BATCHES, {"A": 1, "B": 4, "C": 4, "D": 1})):
        for wdtype in ("float32", "int8"):
            ucfg = dataclasses.replace(cfg_u, wdtype=wdtype)
            tcfg_u = dataclasses.replace(ucfg, backend="torch")
            params_u = unet.unet_init(6, ucfg, device=dev)
            u_params[(cfg_u.image_hw, wdtype)] = params_u
            key = f"unet{cfg_u.image_hw}_{wdtype}"
            unet_serve[key] = {}
            for bb in batches:
                gen_u = torch.Generator().manual_seed(bb)
                xu = torch.randn((bb, ucfg.image_hw, ucfg.image_hw,
                                  ucfg.in_c), generator=gen_u).to(dev)
                tu = torch.rand((bb,), generator=gen_u).to(dev)
                with torch.inference_mode():
                    zero_counts()
                    y_c = unet.unet_apply(params_u, xu, tu, ucfg)
                    torch.cuda.synchronize()
                    got, stray = read_counts(wdtype)
                    unet_launches[f"{key}_B{bb}"] = got
                    y_t = unet.unet_apply(params_u, xu, tu, tcfg_u)
                    torch.cuda.synchronize()
                if got != want or stray:
                    raise RuntimeError(f"{key} B={bb}: launches {got} "
                                       f"(+{stray} in the other dtype's "
                                       f"counters), want {want}")
                scale = float(y_t.abs().max())
                rel = float((y_c - y_t).abs().max()) / scale
                if not (rel <= TOL_UNET and y_c.shape == xu.shape
                        and bool(torch.isfinite(y_c).all())):
                    raise RuntimeError(f"{key} B={bb}: cuda vs torch "
                                       f"max|Δ|/max|y| {rel:.3e}")
                rec = {"cuda_vs_torch": rel, "launches": got}
                if wdtype == "int8":
                    with torch.inference_mode():
                        y32 = unet.unet_apply(
                            u_params[(cfg_u.image_hw, "float32")], xu, tu,
                            cfg_u)
                    dev8 = float((y_c - y32).abs().max())
                    ref32 = float(y32.abs().max())
                    rec["int8_vs_f32"] = (dev8, ref32)
                    if not dev8 < 0.15 * ref32 + 1e-3:
                        raise RuntimeError(f"{key} B={bb}: int8 twin off by "
                                           f"{dev8:.3e} (max|y32| "
                                           f"{ref32:.3e})")
                unet_serve[key][bb] = rec
                del y_c, y_t
            print(f"[serve U-Net {cfg_u.image_hw}px {wdtype}] per bucket: "
                  f"{json.dumps(unet_serve[key])} (tol {TOL_UNET}; int8 "
                  f"gate max|y8-y32| < 0.15 max|y32| + 1e-3)")
    xd = torch.randn((1, hw512, hw512, 3), generator=torch.Generator()
                     .manual_seed(9)).to(dev)
    denoise = {}
    for wdtype in ("float32", "int8"):
        ucfg = dataclasses.replace(unet512, wdtype=wdtype)
        with torch.inference_mode():
            unet.denoise_loop(u_params[(hw512, wdtype)], xd, ucfg, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = unet.denoise_loop(u_params[(hw512, wdtype)], xd, ucfg,
                                    DENOISE_STEPS)
            torch.cuda.synchronize()
        denoise[wdtype] = (time.perf_counter() - t0) * 1e3 / DENOISE_STEPS
        if not bool(torch.isfinite(out).all()) or out.shape != xd.shape:
            raise RuntimeError(f"512px {wdtype} denoise loop not finite")
    print(f"[serve U-Net] {DENOISE_STEPS}-step denoise_loop at 512px, B=1, "
          f"finite; ms per step (host clock, synchronized) "
          f"{json.dumps(denoise)} | {smi}")

    # ---- 4. times ------------------------------------------------------------
    sites = []
    for b in (1, 64):
        for i, l in enumerate(dc):
            pads = gan.deconv_padding(l.kernel, l.stride)
            plan = site(l.in_hw, l.in_c, l.out_c, l.kernel, l.stride, pads)
            x = randn(b, l.in_hw, l.in_hw, l.in_c)
            kern = randn(l.kernel, l.kernel, l.in_c, l.out_c)
            packed = plan.pack(kern)
            xg = pad_or_crop(x, plan.gpad)
            xl, wl, kw = library_args(x, kern, plan.spec.strides, pads)
            y_k = kernel_call(plan, xg, packed)
            lib_err = check_library(
                f"DC{i + 1} B={b}",
                F.conv_transpose2d(xl, wl, **kw).permute(0, 2, 3, 1), y_k)
            flops = 2 * sum(b * ex.out_hw[0] * ex.out_hw[1] * ex.taps[0]
                            * ex.taps[1] for ex in plan.phases) \
                * l.in_c * l.out_c
            nbytes = 4 * (xg.numel() + packed.numel() + y_k.numel())
            t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
            rec = {
                "site": f"DC{i + 1}", "batch": b, "flops": flops,
                "bytes": nbytes,
                "ms": time_ms(lambda: kernel_call(plan, xg, packed)),
                "device_ms": call_device_ms(
                    lambda: kernel_call(plan, xg, packed)),
                "plain_ms": time_ms(lambda: ref_call(plan, xg, packed)),
                "library_ms": time_ms(
                    lambda: F.conv_transpose2d(xl, wl, **kw)),
                "library_device_ms": call_device_ms(
                    lambda: F.conv_transpose2d(xl, wl, **kw)),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_max_abs_err": lib_err,
                "schedule": schedule_of(plan, b)}
            sites.append(rec)
            if b == 1 and rec["schedule"]["units"] < SMS:
                raise RuntimeError(f"DC{i + 1} B=1: {rec['schedule']} leaves "
                                   f"SMs idle")
            dev_share = (None if rec["device_ms"] is None
                         else rec["bound_ms"] / rec["device_ms"])
            print(f"[time] DC{i + 1} B={b}: kernel {rec['ms']:.4f} ms "
                  f"(device {ms_text(rec['device_ms'])}), plain "
                  f"{rec['plain_ms']:.4f} ms, library "
                  f"{rec['library_ms']:.4f} ms (device "
                  f"{ms_text(rec['library_device_ms'])}), bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), kernel at "
                  f"{rec['bound_ms'] / rec['ms']:.1%} of bound "
                  f"({ms_text(dev_share, '.1%')} of its device "
                  f"time); schedule {json.dumps(rec['schedule'])}")
    gen_ms = {}
    with torch.inference_mode():
        for b in BATCH_BUCKETS:
            z = randn(b, cfg.z_dim)
            gen_ms[b] = time_ms(lambda: gan.generator_apply(params, z, cfg),
                                iters=10)
    print(f"[time] generator forward (4 kernel launches + proj/bias/act) "
          f"ms per bucket: {json.dumps(gen_ms)}")

    # ---- 4b. kernel B times, train-step times --------------------------------
    dsites = []
    for b in (1, 64):
        for name, h, c, n, k, s, pads in disc_sites():
            x, kern = randn(b, h, h, c), randn(k, k, c, n)
            xp = pad_or_crop(x, pads).contiguous()
            sp = kern.reshape(k * k * c, n)
            xl, wl, kw = conv_library_args(xp, kern, (s, s), (1, 1))
            y_k = conv_call(xp, sp, k, s, 1)
            lib_err = check_library(
                f"{name} B={b}", F.conv2d(xl, wl, **kw).permute(0, 2, 3, 1),
                y_k)
            oh, ow = y_k.shape[1:3]
            flops = 2 * b * oh * ow * k * k * c * n
            nbytes = 4 * (xp.numel() + sp.numel() + y_k.numel())
            t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
            rec = {
                "site": name, "batch": b, "flops": flops, "bytes": nbytes,
                "ms": time_ms(lambda: conv_call(xp, sp, k, s, 1)),
                "device_ms": call_device_ms(
                    lambda: conv_call(xp, sp, k, s, 1)),
                "plain_ms": time_ms(
                    lambda: conv_call(xp, sp, k, s, 1, plain=True)),
                "library_ms": time_ms(lambda: F.conv2d(xl, wl, **kw)),
                "library_device_ms": call_device_ms(
                    lambda: F.conv2d(xl, wl, **kw)),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_max_abs_err": lib_err,
                "schedule": conv_schedule_of(b, oh, ow, k, c, n)}
            dsites.append(rec)
            if b == 1 and name.startswith("DCGAN") \
                    and not fills_card(rec["schedule"]):
                raise RuntimeError(f"{name} B=1: {rec['schedule']} leaves "
                                   f"SMs idle")
            dev_share = (None if rec["device_ms"] is None
                         else rec["bound_ms"] / rec["device_ms"])
            print(f"[time B] {name} B={b}: kernel {rec['ms']:.4f} ms "
                  f"(device {ms_text(rec['device_ms'])}), plain "
                  f"{rec['plain_ms']:.4f} ms, library "
                  f"{rec['library_ms']:.4f} ms (device "
                  f"{ms_text(rec['library_device_ms'])}), bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), kernel at "
                  f"{ms_text(dev_share, '.1%')} of bound by "
                  f"device time; schedule {json.dumps(rec['schedule'])}")

    def step_ms(cfg, b, iters=5):
        gp_, dp_ = gan.generator_init(4, cfg, device=dev), \
            gan.discriminator_init(5, cfg, device=dev)
        bt = GANPipeline(cfg, b, image_hw=64).batch_at(0)
        z_, r_ = (torch.from_numpy(bt[k]).to(dev) for k in ("z", "real"))
        for _ in range(2):
            train_gan.train_step(gp_, dp_, z_, r_, cfg, 2e-4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            gp_, dp_, _, _ = train_gan.train_step(gp_, dp_, z_, r_, cfg,
                                                  2e-4)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    def step_split(b, wall_ms):
        """One 'cuda' train step under ``torch.profiler``: device time of
        kernel A, kernel B and everything else (the backward products, the
        pads, the elementwise ops), summed over the device-side events only
        (an op's own entry repeats its kernels' time), and the idle share
        against ``wall_ms``, the step's time measured without the profiler
        (which slows the host); None where the profiler caught no trace."""
        gp_ = gan.generator_init(4, tcfg, device=dev)
        dp_ = gan.discriminator_init(5, tcfg, device=dev)
        bt = GANPipeline(tcfg, b, image_hw=64).batch_at(0)
        z_, r_ = (torch.from_numpy(bt[k]).to(dev) for k in ("z", "real"))
        for _ in range(2):
            train_gan.train_step(gp_, dp_, z_, r_, tcfg, 2e-4)
        torch.cuda.synchronize()
        _, evs = device_events(
            lambda: train_gan.train_step(gp_, dp_, z_, r_, tcfg, 2e-4), 1,
            with_cpu=True)
        out = {"A_ms": 0.0, "B_ms": 0.0, "other_ms": 0.0, "A_calls": 0,
               "B_calls": 0, "other_calls": 0}
        for ev in evs or ():
            part = kernel_part(ev.name)
            part = part if part in ("A", "B") else "other"
            out[f"{part}_ms"] += ev.device_time_total / 1e3
            out[f"{part}_calls"] += 1
        busy = out["A_ms"] + out["B_ms"] + out["other_ms"]
        out.update(device_busy_ms=busy, wall_ms=wall_ms,
                   idle_share=1 - busy / wall_ms if evs else None)
        return out

    train_ms = {f"{backend}_B{b}": step_ms(
        gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend=backend), b)
        for b in (TRAIN_BATCH, 64) for backend in ("cuda", "torch")}
    print(f"[time] DCGAN train step (full width; host clock over 5 steps "
          f"after 2, synchronized) ms: {json.dumps(train_ms)}")
    split = {f"B{b}": step_split(b, train_ms[f"cuda_B{b}"])
             for b in (TRAIN_BATCH, 64)}
    print(f"[time] DCGAN 'cuda' train step, device time by kernel "
          f"(torch.profiler, one step after 2): {json.dumps(split)}")

    # ---- 4c. the int8 entries' times -----------------------------------------
    def bound_of(flops, nbytes):
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    def time_int8(name, b, flops, in_bytes, out_numel, kernel, f32_kernel,
                  plain, library, lib_err, schedule=None):
        """One int8 site's record: the int8 kernel against the f32 kernel
        on the dequantized weights, the plain version and the library call
        (already checked against the kernel); the bound counts the input,
        1 B per code, 4 B per scale row and the f32 output.  With kernel
        A's, B's or D's ``schedule``, also the three calls' device times."""
        bound, by = bound_of(flops, in_bytes + 4 * out_numel)
        rec = {"site": name, "batch": b, "flops": flops,
               "bytes": in_bytes + 4 * out_numel,
               "ms": time_ms(kernel), "f32_ms": time_ms(f32_kernel),
               "plain_ms": time_ms(plain), "library_ms": time_ms(library),
               "bound_ms": bound, "bound_by": by,
               "library_max_abs_err": lib_err}
        extra = ""
        if schedule is not None:
            rec.update(device_ms=call_device_ms(kernel),
                       f32_device_ms=call_device_ms(f32_kernel),
                       library_device_ms=call_device_ms(library),
                       schedule=schedule)
            extra = (f"; device ms int8 {ms_text(rec['device_ms'])}, f32 "
                     f"{ms_text(rec['f32_device_ms'])}, library "
                     f"{ms_text(rec['library_device_ms'])}; schedule "
                     f"{json.dumps(schedule)}")
        print(f"[time int8] {name} B={b}: int8 kernel {rec['ms']:.4f} ms, "
              f"f32 kernel {rec['f32_ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} "
              f"ms, bound {bound:.4f} ms ({by}), int8 kernel at "
              f"{bound / rec['ms']:.1%} of bound" + extra)
        return rec

    print(f"[time int8] kernel E inside B at the SegNet sites, inside A at "
          f"the DCGAN sites, B = 1 and 64, CUDA events; card {smi}")
    i8_bsites, i8_asites = [], []
    for b in (1, 64):
        for name, h, c, n, k, s, d, pads in seg_sites():
            x, kern = randn(b, h, h, c), randn(k, k, c, n)
            xp = pad_or_crop(x, pads).contiguous()
            q, scale, wd = int8_of(kern.reshape(k * k * c, n))
            xl, wl, kw = conv_library_args(xp, wd.reshape(k, k, c, n),
                                           (s, s), (d, d))
            y_k = conv_call(xp, q, k, s, d, scales=scale)
            lib_err = check_library(
                f"{name} B={b}", F.conv2d(xl, wl, **kw).permute(0, 2, 3, 1),
                y_k)
            oh, ow = y_k.shape[1:3]
            i8_bsites.append(time_int8(
                name, b, 2 * b * oh * ow * k * k * c * n,
                4 * xp.numel() + q.numel() + 4 * scale.numel(), y_k.numel(),
                lambda: conv_call(xp, q, k, s, d, scales=scale),
                lambda: conv_call(xp, wd, k, s, d),
                lambda: conv_call(xp, q, k, s, d, plain=True, scales=scale),
                lambda: F.conv2d(xl, wl, **kw), lib_err,
                schedule=conv_schedule_of(b, oh, ow, k, c, n)))
            if b == 1 and name in {f"SegNet_L{i}" for i in range(1, 9)} \
                    and not fills_card(i8_bsites[-1]["schedule"]):
                raise RuntimeError(f"{name} B=1: {i8_bsites[-1]['schedule']}"
                                   f" leaves SMs idle")
        for i, l in enumerate(dc):
            pads = gan.deconv_padding(l.kernel, l.stride)
            plan = site(l.in_hw, l.in_c, l.out_c, l.kernel, l.stride, pads)
            x = randn(b, l.in_hw, l.in_hw, l.in_c)
            q, scale, wd = int8_of(plan.pack(
                randn(l.kernel, l.kernel, l.in_c, l.out_c)))
            xg = pad_or_crop(x, plan.gpad)
            xl, wl, kw = library_args(x, plan.unpack(wd), plan.spec.strides,
                                      pads)
            y_k = kernel_call(plan, xg, q, scales=scale)
            lib_err = check_library(
                f"DC{i + 1} B={b}",
                F.conv_transpose2d(xl, wl, **kw).permute(0, 2, 3, 1), y_k)
            flops = 2 * sum(b * ex.out_hw[0] * ex.out_hw[1] * ex.taps[0]
                            * ex.taps[1] for ex in plan.phases) \
                * l.in_c * l.out_c
            i8_asites.append(time_int8(
                f"DC{i + 1}", b, flops,
                4 * xg.numel() + q.numel() + 4 * scale.numel(), y_k.numel(),
                lambda: kernel_call(plan, xg, q, scales=scale),
                lambda: kernel_call(plan, xg, wd),
                lambda: ref_call(plan, xg, q, scales=scale),
                lambda: F.conv_transpose2d(xl, wl, **kw), lib_err,
                schedule=schedule_of(plan, b)))
    # ---- 4d. kernels C and D (f32, int8) at the 512 px U-Net's tiled sites
    print(f"[time tiled] kernels C and D at the tiled sites of the U-Net at "
          f"a 512 px image, B = 1 and 16, CUDA events; card {smi}")
    c_sites, d_sites, ci8_sites, di8_sites = [], [], [], []
    for b in UNET_512_BATCHES:
        for name, plan in tiled_c:
            sp_ = plan.spec
            (r, s_), st, tile = sp_.kernel_hw, sp_.strides[0], \
                plan.routes[0].sp_tiles
            x = randn(b, *sp_.in_hw, sp_.in_c)
            xp = pad_or_crop(x, sp_.padding).contiguous()
            kern = randn(r, s_, sp_.in_c, sp_.out_c)
            sp = kern.reshape(-1, sp_.out_c)
            q, scale, wd = int8_of(sp)
            xl, wl, kw = conv_library_args(xp, kern, (st, st), (1, 1))
            y_k = tiled_conv_call(xp, sp, r, s_, st, 1, tile)
            lib_err = check_library(
                f"{name} B={b}", F.conv2d(xl, wl, **kw).permute(0, 2, 3, 1),
                y_k)
            flops = 2 * y_k.numel() * r * s_ * sp_.in_c
            nbytes = 4 * (xp.numel() + sp.numel() + y_k.numel())
            bound, by = bound_of(flops, nbytes)
            rec = {"site": name, "batch": b, "flops": flops,
                   "bytes": nbytes, "tile": tile,
                   "schedule": tiled_schedule_of(
                       y_k.shape[1:3], r, s_, st, 1, sp_.in_c, sp_.out_c,
                       tile),
                   "ms": time_ms(lambda: tiled_conv_call(
                       xp, sp, r, s_, st, 1, tile)),
                   "plain_ms": time_ms(lambda: tiled_conv_call(
                       xp, sp, r, s_, st, 1, tile, plain=True), iters=5),
                   "whole_plane_ms": time_ms(lambda: conv_call(
                       xp, sp, r, st, 1)) if r == s_ else None,
                   "library_ms": time_ms(lambda: F.conv2d(xl, wl, **kw)),
                   "bound_ms": bound, "bound_by": by,
                   "library_max_abs_err": lib_err}
            c_sites.append(rec)
            print(f"[time C] {name} B={b} tile {tile}: kernel "
                  f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                  f"kernel B (whole plane) {rec['whole_plane_ms']:.4f} ms, "
                  f"library {rec['library_ms']:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}), kernel at {bound / rec['ms']:.1%}"
                  f" of bound; schedule {rec['schedule']}")
            xl8, wl8, kw8 = conv_library_args(
                xp, wd.reshape(r, s_, sp_.in_c, sp_.out_c), (st, st),
                (1, 1))
            y_k8 = tiled_conv_call(xp, q, r, s_, st, 1, tile, scales=scale)
            lib_err8 = check_library(
                f"{name} int8 B={b}",
                F.conv2d(xl8, wl8, **kw8).permute(0, 2, 3, 1), y_k8)
            ci8_sites.append(time_int8(
                f"C {name}", b, flops,
                4 * xp.numel() + q.numel() + 4 * scale.numel(), y_k8.numel(),
                lambda: tiled_conv_call(xp, q, r, s_, st, 1, tile,
                                        scales=scale),
                lambda: tiled_conv_call(xp, wd, r, s_, st, 1, tile),
                lambda: tiled_conv_call(xp, q, r, s_, st, 1, tile,
                                        plain=True, scales=scale),
                lambda: F.conv2d(xl8, wl8, **kw8), lib_err8))
            del xp, x, y_k, y_k8, xl, xl8
        for name, plan in tiled_d:
            sp_ = plan.spec
            tile = plan.routes[0].sp_tiles
            x = randn(b, *sp_.in_hw, sp_.in_c)
            xg = pad_or_crop(x, plan.gpad).contiguous()
            kern = randn(*sp_.kernel_hw, sp_.in_c, sp_.out_c)
            packed = plan.pack(kern)
            q, scale, wd = int8_of(packed)
            # the library: F.conv_transpose2d at padding 0, cropped (one
            # call and a view; phase 2f held it to the f64 bound)
            xl, wl, kw, crop = cropped_library_args(x, kern, sp_.strides,
                                                    sp_.padding)
            _, wl8, _, _ = cropped_library_args(x, plan.unpack(wd),
                                                sp_.strides, sp_.padding)

            def library(w_=wl):
                return F.conv_transpose2d(xl, w_, **kw)[:, :, crop[0],
                                                        crop[1]]
            y_k = tiled_deconv_call(plan, xg, packed, tile)
            lib_err = check_library(f"{name} B={b}",
                                    library().permute(0, 2, 3, 1), y_k)
            flops = 2 * sum(b * ex.out_hw[0] * ex.out_hw[1] * ex.taps[0]
                            * ex.taps[1] for ex in plan.phases) \
                * sp_.in_c * sp_.out_c
            nbytes = 4 * (xg.numel() + packed.numel() + y_k.numel())
            bound, by = bound_of(flops, nbytes)
            sched = tiled_deconv_schedule_of(plan, sp_.in_c, sp_.out_c,
                                             tile)
            rec = {"site": name, "batch": b, "flops": flops,
                   "bytes": nbytes, "tile": tile, "schedule": sched,
                   "ms": time_ms(lambda: tiled_deconv_call(
                       plan, xg, packed, tile)),
                   "device_ms": call_device_ms(lambda: tiled_deconv_call(
                       plan, xg, packed, tile)),
                   "plain_ms": time_ms(lambda: tiled_deconv_call(
                       plan, xg, packed, tile, plain=True), iters=5),
                   "whole_plane_ms": time_ms(lambda: kernel_call(
                       plan, xg, packed)),
                   "library_ms": time_ms(library),
                   "library_device_ms": call_device_ms(library),
                   "bound_ms": bound, "bound_by": by,
                   "library_max_abs_err": lib_err}
            d_sites.append(rec)
            print(f"[time D] {name} B={b} tile {tile}: kernel "
                  f"{rec['ms']:.4f} ms (device "
                  f"{ms_text(rec['device_ms'])}), plain "
                  f"{rec['plain_ms']:.4f} ms, kernel A (whole plane) "
                  f"{rec['whole_plane_ms']:.4f} ms, library (cropped "
                  f"F.conv_transpose2d) {rec['library_ms']:.4f} ms (device "
                  f"{ms_text(rec['library_device_ms'])}), bound "
                  f"{bound:.4f} ms ({by}), kernel at {bound / rec['ms']:.1%}"
                  f" of bound; schedule {sched}")
            y_k8 = tiled_deconv_call(plan, xg, q, tile, scales=scale)
            lib_err8 = check_library(f"{name} int8 B={b}",
                                     library(wl8).permute(0, 2, 3, 1), y_k8)
            di8_sites.append(time_int8(
                f"D {name}", b, flops,
                4 * xg.numel() + q.numel() + 4 * scale.numel(), y_k8.numel(),
                lambda: tiled_deconv_call(plan, xg, q, tile, scales=scale),
                lambda: tiled_deconv_call(plan, xg, wd, tile),
                lambda: tiled_deconv_call(plan, xg, q, tile, plain=True,
                                          scales=scale),
                lambda: library(wl8), lib_err8, schedule=sched))
            del x, xg, xl, y_k, y_k8
    unet_ms = {}
    with torch.inference_mode():
        for cfg_u, batches in ((unet32, BATCH_BUCKETS),
                               (unet512, UNET_512_BATCHES)):
            for wdtype in ("float32", "int8"):
                ucfg = dataclasses.replace(cfg_u, wdtype=wdtype)
                pu = u_params[(cfg_u.image_hw, wdtype)]
                for bb in batches:
                    xu = randn(bb, ucfg.image_hw, ucfg.image_hw, ucfg.in_c)
                    tu = torch.rand((bb,), device=dev)
                    unet_ms[f"unet{cfg_u.image_hw}_{wdtype}_B{bb}"] = \
                        time_ms(lambda: unet.unet_apply(pu, xu, tu, ucfg),
                                iters=5, warmup=2)
    print(f"[time] U-Net forward ms per bucket (CUDA events): "
          f"{json.dumps(unet_ms)}")

    def unet_split(pu, ucfg, b, wall_ms):
        xu = randn(b, ucfg.image_hw, ucfg.image_hw, ucfg.in_c)
        tu = torch.rand((b,), device=dev)
        return forward_split(lambda: unet.unet_apply(pu, xu, tu, ucfg),
                             wall_ms)

    unet_split_512 = {
        f"{wdtype}_B{bb}": unet_split(
            u_params[(hw512, wdtype)], dataclasses.replace(unet512,
                                                           wdtype=wdtype),
            bb, unet_ms[f"unet{hw512}_{wdtype}_B{bb}"])
        for wdtype in ("float32", "int8") for bb in UNET_512_BATCHES}
    print(f"[time] U-Net 512px forward, device time by kernel "
          f"(torch.profiler, one forward after one): "
          f"{json.dumps(unet_split_512)}")

    print(json.dumps({"card": smi, "sites": sites, "generator_ms": gen_ms,
                      "disc_sites": dsites, "train_step_ms": train_ms,
                      "train_step_device_split": split,
                      "int8_segnet_sites": i8_bsites,
                      "int8_dcgan_sites": i8_asites,
                      "segnet_serve": seg_serve,
                      "dcgan_int8_rel_err": dcgan_rel,
                      "tiled_c_sites": c_sites, "tiled_d_sites": d_sites,
                      "tiled_c_int8_sites": ci8_sites,
                      "tiled_d_int8_sites": di8_sites,
                      "unet_serve": unet_serve, "unet_forward_ms": unet_ms,
                      "unet512_device_split": unet_split_512,
                      "unet512_denoise_ms_per_step": denoise}))

    lm_records, f_entry = lm_phases(dev, peak_bw, peak_bf16, time_ms, gen)
    f_entry["ptxas"] = f_ptxas
    print(json.dumps({"card": smi, **lm_records}))

    vae_records, vae_paths = vae_phases(dev, smi, peak_flops, peak_bw, gen)
    print(json.dumps({"card": smi, **vae_records}))

    # ---- 5. the kernels line, the card line, the result line ---------------
    def sums(recs):
        t_ops = sum(r["flops"] for r in recs) / peak_flops * 1e3
        t_bytes = sum(r["bytes"] for r in recs) / peak_bw * 1e3
        lib = [r["library_ms"] for r in recs]
        out = {"ms": sum(r["ms"] for r in recs),
               "plain_ms": sum(r["plain_ms"] for r in recs),
               "bound_ms": sum(r["bound_ms"] for r in recs),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": None if None in lib else sum(lib)}
        if all(r.get("device_ms") is not None
               and r.get("library_device_ms") is not None for r in recs):
            out.update(device_ms=sum(r["device_ms"] for r in recs),
                       library_device_ms=sum(r["library_device_ms"]
                                             for r in recs))
        return out

    def unet_paths_of(kern_, wdtype):
        return {k: v[kern_] for k, v in unet_launches.items()
                if f"_{wdtype}_" in k and v[kern_]}

    a_paths = {"serve_dcgan": launches, "train_dcgan": train_launches["A"],
               **unet_paths_of("A", "float32"), **vae_paths["A"]}
    b_paths = {"train_dcgan": train_launches["B"],
               "serve_segnet": seg_launches["float32"],
               **unet_paths_of("B", "float32"), **vae_paths["B"]}
    ai8_paths = {**unet_paths_of("A", "int8"), **vae_paths["A_int8"]}
    bi8_paths = {**unet_paths_of("B", "int8"), **vae_paths["B_int8"]}
    c_paths, d_paths = (unet_paths_of("C", "float32"),
                        unet_paths_of("D", "float32"))
    ci8_paths, di8_paths = (unet_paths_of("C", "int8"),
                            unet_paths_of("D", "int8"))
    for kern_, paths_ in (("C", c_paths), ("D", d_paths),
                          ("C int8", ci8_paths), ("D int8", di8_paths)):
        if sum(paths_.values()) == 0:
            raise RuntimeError(f"kernel {kern_} never launched on the "
                               f"U-Net path")
    big = UNET_512_BATCHES[-1]
    kernels = [{
        "name": "untangled_deconv2d", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_deconv.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:373",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_deconv_kernel",
        "launches": sum(a_paths.values()), "launches_by_path": a_paths,
        "held_against_plain": True, "max_abs_err": max_err,
        "shape": "DCGAN generator, 4 sites, B=64 (sums)",
        **sums([r for r in sites if r["batch"] == 64]),
        "B1": sums([r for r in sites if r["batch"] == 1])}, {
        "name": "untangled_conv2d_superpack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_conv.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:77",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_kernel",
        "launches": sum(b_paths.values()), "launches_by_path": b_paths,
        "held_against_plain": True, "max_abs_err": max_err_b,
        "shape": "DCGAN discriminator, 4 sites, B=64 (sums)",
        **sums([r for r in dsites if r["batch"] == 64
                and r["site"].startswith("DCGAN")]),
        "B1": sums([r for r in dsites if r["batch"] == 1
                    and r["site"].startswith("DCGAN")])}, {
        "name": "untangled_deconv2d_i8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_deconv.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:63",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_tap_panel "
                      "inside _deconv_kernel",
        "launches": q_launches["int8"] + sum(ai8_paths.values()),
        "launches_by_path": {"serve_dcgan_int8": q_launches["int8"],
                             **ai8_paths},
        "held_against_plain": True, "max_abs_err": max_err_ai8,
        "shape": "DCGAN generator int8, 4 sites, B=64 (sums)",
        **sums([r for r in i8_asites if r["batch"] == 64]),
        "B1": sums([r for r in i8_asites if r["batch"] == 1])}, {
        "name": "untangled_conv2d_i8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_conv.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:63",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_tap_panel "
                      "inside _kernel",
        "launches": seg_launches["int8"] + sum(bi8_paths.values()),
        "launches_by_path": {"serve_segnet_int8": seg_launches["int8"],
                             **bi8_paths},
        "held_against_plain": True, "max_abs_err": max_err_bi8,
        "shape": "SegNet int8, 10 sites, B=64 (sums)",
        **sums([r for r in i8_bsites if r["batch"] == 64]),
        "B1": sums([r for r in i8_bsites if r["batch"] == 1])}, {
        "name": "untangled_conv2d_tiled", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_conv_tiled.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:158",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_tiled_kernel "
                      "+ _halo_stream",
        "launches": sum(c_paths.values()), "launches_by_path": c_paths,
        "held_against_plain": True, "max_abs_err": max_err_c,
        "shape": f"U-Net 512px tiled sites stem, down0, fuse0, head, "
                 f"B={big} (sums)",
        **sums([r for r in c_sites if r["batch"] == big])}, {
        "name": "untangled_deconv2d_tiled", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_deconv_tiled.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:503",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::"
                      "_deconv_tiled_kernel + _halo_stream",
        "launches": sum(d_paths.values()), "launches_by_path": d_paths,
        "held_against_plain": True, "max_abs_err": max_err_d,
        "shape": f"U-Net 512px up0, B={big}",
        **sums([r for r in d_sites if r["batch"] == big])}, {
        "name": "untangled_conv2d_tiled_i8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_conv_tiled.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:63",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_tap_panel "
                      "inside _tiled_kernel",
        "launches": sum(ci8_paths.values()), "launches_by_path": ci8_paths,
        "held_against_plain": True, "max_abs_err": max_err_ci8,
        "shape": f"U-Net 512px int8 tiled sites, B={big} (sums)",
        **sums([r for r in ci8_sites if r["batch"] == big])}, {
        "name": "untangled_deconv2d_tiled_i8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/untangled_deconv_tiled.cu",
        "replaces": "src/repro/kernels/untangled_conv.py:63",
        "tpu_kernel": "src/repro/kernels/untangled_conv.py::_tap_panel "
                      "inside _deconv_tiled_kernel",
        "launches": sum(di8_paths.values()), "launches_by_path": di8_paths,
        "held_against_plain": True, "max_abs_err": max_err_di8,
        "shape": f"U-Net 512px int8 up0, B={big}",
        **sums([r for r in di8_sites if r["batch"] == big])}, f_entry]
    for k in kernels:
        print(f"[kernels] {k['name']} <- {k['tpu_kernel']}: {k['launches']} "
              f"launches on the main path, held against its plain version")
    print(f"[done] every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
