"""The pair word on the card (port of tools/pair_probe.py).

    python -m vsim_tpu_torch.tools.pair_probe [bitcast|pairA] [--device cpu]

``bitcast``: K14 (``pair_bitcast``) on a random [256, 256] u8 weight, each
byte's pair word 0x43004300 | lo | hi << 16 read as two bf16 rows of f32;
prints which row takes the low nibble (the TPU probe's question) and holds
the kernel against its plain version, exactly.  ``pairA``: K12 under pairA
with unit scales (``q4_lab.unit_scales``), x [8, 512] bf16 times (v - 8)
for a [256, 256] u8 weight, held against its plain version and against a
second run of itself, bit for bit.  On the card
each is timed (``timing.timed``), pairA beside a library yardstick the
port never calls: ``torch.matmul`` of x and the unit-scale weight
dequantized to bf16 (``dequantize_km``), the same function.  The TPU
probe's lower/compile stages do not carry over.
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.ops.q4_lab import (TOL_LAB, pair_bitcast,
                                       pair_bitcast_plain, q4_lab_gemv,
                                       q4_lab_gemv_plain, unit_scales)
from vsim_tpu_torch.quant.q4 import Q4Tensor, dequantize_km
from vsim_tpu_torch.timing import rel_err, timed

STAGES = ("bitcast", "pairA")
N, KH, O = 8, 256, 256


def run(stage: str = "bitcast", device: DeviceLike = None) -> List[Dict]:
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; known: {STAGES}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    p = torch.randint(0, 256, (KH, O), generator=g, device=dev,
                      dtype=torch.uint8)
    library = None
    if stage == "bitcast":
        def fn():
            return pair_bitcast(p)

        def plain():
            return pair_bitcast_plain(p)
        out = fn()
        lo = (p & 0x0F).float() + 128.0
        hi = (p >> 4).float() + 128.0
        print(f"pair_probe bitcast: device={card} low->even rows: "
              f"{torch.equal(out[0::2], lo) and torch.equal(out[1::2], hi)}",
              flush=True)
        if not torch.equal(out, plain()):
            raise RuntimeError("pair_bitcast differs from its plain version")
        err = rel = 0.0
        kernel, nbytes, ops = "pair_bitcast", p.numel() * 9, 0
    else:
        x = torch.randn((N, 2 * KH), generator=g, device=dev).to(torch.bfloat16)
        s = unit_scales(p)

        def fn():
            return q4_lab_gemv(x, p, s, "pairA")

        def plain():
            return q4_lab_gemv_plain(x, p, s, "pairA")
        got = fn()
        err, rel = rel_err(got, plain())
        if rel > TOL_LAB:
            raise RuntimeError(f"pair_probe pairA: max|err| {err:.3g} (rel "
                               f"{rel:.3g} > {TOL_LAB})")
        if not torch.equal(got, fn()):
            raise RuntimeError("pair_probe pairA: differs from run to run")
        kernel = "q4_lab_gemv"
        nbytes = p.numel() + s.numel() * 2 + x.numel() * 2 + N * O * 4

        def library():
            return torch.matmul(x, dequantize_km(Q4Tensor(p, s, "i"),
                                                 torch.bfloat16))
        ops = 2 * N * 2 * KH * O
    ms = timed(fn) if on_card else None
    plain_ms = timed(plain, reps=3, warmup=1) if on_card else None
    lib_ms = (timed(library, reps=5, warmup=1)
              if on_card and library is not None else None)
    row = dict(tool="pair_probe", kernel=kernel, variant=stage,
               shape=f"probe {stage} KH={KH} O={O}", n=N, K=2 * KH, O=O,
               ms=ms, max_abs_err=err, rel_err=rel, plain_ms=plain_ms,
               library_ms=lib_ms, nbytes=nbytes, ops=ops,
               peak="bf16", device=card)
    print(f"  {stage} KH={KH} O={O}: "
          + (f"{ms:.4f} ms, plain {plain_ms:.4f} ms" if on_card
             else f"ms not measured (on {card})")
          + (f", library {lib_ms:.4f} ms" if lib_ms is not None else "")
          + f"  max|err| {err:.2e}", flush=True)
    return [row]


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stage", nargs="?", default="bitcast", choices=STAGES)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless given")
    args = ap.parse_args(argv)
    return run(args.stage, args.device)


if __name__ == "__main__":
    main()
