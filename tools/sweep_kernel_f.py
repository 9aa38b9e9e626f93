"""Kernel F's key chunk (BK) at head dim 192 on one GPU: each candidate
BK built from a copy of ``csrc/flash_attention.cu`` with only the D = 192
tile changed, its ``-Xptxas -v`` registers and spills, and its bf16 time
at deepseek-v3-671b's MLA prefill layer (B = 1, S = 4096, 128 query and
key heads, D = 192, causal, v zero past column 128 as MLA pads it) beside
SDPA on the same inputs, each held against F's plain version first (the
bf16 rule of ``chip_smoke.py``'s ``FLASH_CASES``).  The measurements the
``Tile<192>`` choice in the source comes from.  One JSON object a line,
the card's name and power limit last:

    python tools/sweep_kernel_f.py [--bk 32,64] [--seq 4096]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
TILE_LINE = "  static constexpr int BK = D <= 128 ? 64 : 32;"
TOL_F, TOL_REL = 2e-4, 2.0 ** -7
ITERS, WARMUP = 20, 3


def variant(bk: int, out_dir: pathlib.Path):
    """Build the source with BK = ``bk`` at D = 192: (ctypes entry,
    ptxas lines of the D = 192 instantiations)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    text = SRC.read_text()
    line = next(ln for ln in text.splitlines() if ln.startswith(TILE_LINE))
    text = text.replace(line, f"  static constexpr int BK = D <= 128 ? 64 "
                              f": (D == 192 ? {bk} : 32);")
    src = out_dir / f"flash_bk{bk}.cu"
    src.write_text(text)
    lib = out_dir / f"libflash_bk{bk}.so"
    log = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-o", str(lib), str(src)], check=True,
                         capture_output=True, text=True)
    lines = (log.stdout + log.stderr).splitlines()
    report, keep = [], False
    for ln in lines:
        if "Compiling entry function" in ln:
            keep = "ILi192E" in ln
        if keep and ("registers" in ln or "spill" in ln
                     or "Compiling" in ln):
            report.append(ln.strip())
    fn = ctypes.CDLL(str(lib)).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, report


def time_ms(fn):
    import torch
    for _ in range(WARMUP):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(ITERS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / ITERS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bk", default="32,64")
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("sweep_kernel_f: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    s, h, d = args.seq, 128, 192
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, s, h, d), generator=gen).to(dev,
                                                          torch.bfloat16)
               for _ in range(3))
    v[..., 128:] = 0
    scale = d ** -0.5
    want = fa.flash_attention_plain(q, k, v, scale=scale).float()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale))
    with tempfile.TemporaryDirectory() as tmp:
        for bk in map(int, args.bk.split(",")):
            fn, report = variant(bk, pathlib.Path(tmp))
            fa._entry = lambda fn=fn: fn
            got = fa.flash_attention(q, k, v, scale=scale).float()
            share = float(((got - want).abs()
                           / (TOL_F + TOL_REL * want.abs())).max())
            if not share <= 1.0:
                raise RuntimeError(f"BK = {bk}: {share:.3f} of the bf16 "
                                   f"bound against the plain version")
            ms = time_ms(lambda: fa.flash_attention(q, k, v, scale=scale))
            print(json.dumps({"bk": bk, "ms": ms, "sdpa_ms": sdpa_ms,
                              "share_of_bound_vs_plain": share,
                              "ptxas": report}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
