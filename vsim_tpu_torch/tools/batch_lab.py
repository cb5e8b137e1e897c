"""Batch-decode Q4 lab on the card (port of tools/batch_lab.py).

    python -m vsim_tpu_torch.tools.batch_lab [--batch 64] [--shapes gptj]
        [--shape O,K] [--variants 2d/dma,2d/f32x,...] [--block-kh 256]
        [--check] [--device cpu]

How to dequantize at batch (n > 8) on the tensor cores: K15
(``q4_batch_lab``) under the maths f32x, bsub and bnos, in the geometries
2d (a block an O tile, all of K) and band (a block a band of K across all
of O, partials merged in order), beside K13's touch of the same geometry
("dma": a read of every byte, on the "ps" repack).  One random plane-split
weight per shape of ``--shapes`` (``SHAPES``: the TPU tool's; ``--shape``
names one O,K instead) and ``--batch`` rows of bf16 x.  Each variant is
held against its plain version (and K13/K15 against a second run, bit for
bit), then timed on the card over a rotation of weights past the 50 MB
L2; bnos's time includes its correction (``batch_corr``: torch ops outside
the kernel), as the TPU tool charges it.  Prints ms, GB/s of weight bytes,
the ratio to the geometry's dma rate, max|err|, the library yardstick
(``dequantize_km`` + ``torch.matmul`` in bf16) and K15's plan on the card
((n-tiles, cluster) for 2d, (n-tiles, bands) for band).  ``--check`` runs the
numerics only, each K15 variant against an f32 oracle (f32 dequantize and
a matmul), and prints its relative error.  ``--block-kh`` is part of the
dma touch's function (band's needs 256 or more); the TPU's ``--ochunk`` and
``--vmem-mb`` do not carry over (the TPU band drops the columns past the
last whole ``ochunk``; K15 computes them all).
"""

from __future__ import annotations

import argparse
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.ops.q4_batch_lab import (BATCH_MATHS, GEOMETRIES,
                                             TOL_BATCH, batch_corr,
                                             batch_plan, q4_batch_lab,
                                             q4_batch_lab_plain)
from vsim_tpu_torch.ops.q4_lab import q4_lab_dma, q4_lab_dma_plain
from vsim_tpu_torch.quant.q4 import QK, Q4Tensor, dequantize_km, to_plane_split
from vsim_tpu_torch.timing import rel_err, rotation, timed
from vsim_tpu_torch.tools.lab import _exact, lab_weight

SHAPES = {  # (O, K), as tools/batch_lab.py:SHAPES
    "gptj": [(12288, 4096), (4096, 4096), (16384, 4096), (4096, 16384)],
    "pythia12b": [(15360, 5120), (5120, 5120), (20480, 5120),
                  (5120, 20480)],
    "one": [(4096, 16384)],
}
VARIANTS = tuple(f"{g}/{m}" for g in GEOMETRIES for m in ("dma",)
                 + BATCH_MATHS)
BLOCK_KH = 256


def _plane_split_weight(K: int, O: int, seed: int, device) -> Q4Tensor:  # noqa: N803
    return to_plane_split(lab_weight(K, O, seed, device))


def run(batch: int = 64, shapes: Sequence[Tuple[int, int]] = SHAPES["gptj"],
        variants: Sequence[str] = VARIANTS, device: DeviceLike = None,
        block_kh: int = BLOCK_KH) -> List[Dict]:
    """One row a (shape, variant), each geometry's dma first, printed as it
    is measured; raises on an unknown variant or a failed check."""
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {VARIANTS}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    order = [v for v in VARIANTS if v in variants]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows: List[Dict] = []
    for O, K in shapes:  # noqa: N806
        x = torch.randn((batch, K), generator=g, device=dev).to(torch.bfloat16)
        w0 = _plane_split_weight(K, O, 0, dev)
        wbytes = w0.nbytes
        ws = (rotation(lambda i: w0 if i == 0 else _plane_split_weight(
            K, O, i, dev), wbytes) if on_card else [w0])
        print(f"batch_lab: device={card} batch={batch} shape O={O} K={K} "
              f"({wbytes / 1e6:.1f} MB of weight, {len(ws)} in rotation)",
              flush=True)
        lib_ms: Optional[float] = None
        dma_gbs: Dict[str, float] = {}
        bkh = min(block_kh, K // 2)
        for v in order:
            geom, math_ = v.split("/")
            if math_ == "dma":
                def fn(w, geom=geom):
                    return q4_lab_dma(x, w.packed, w.scales, geom, bkh)

                def plain(w, geom=geom):
                    return q4_lab_dma_plain(x, w.packed, w.scales, geom, bkh)
            else:
                def fn(w, geom=geom, math_=math_):
                    corr = (batch_corr(x, w.scales) if math_ == "bnos"
                            else None)
                    return q4_batch_lab(x, w.packed, w.scales, math_, geom,
                                        corr)

                def plain(w, geom=geom, math_=math_):
                    corr = (batch_corr(x, w.scales) if math_ == "bnos"
                            else None)
                    return q4_batch_lab_plain(x, w.packed, w.scales, math_,
                                              geom, corr)
            got, ref = fn(ws[0]), plain(ws[0])
            if math_ == "dma":
                err, rel = _exact(got, ref)
                again = fn(ws[0])
                same = all(torch.equal(a, b) for a, b in zip(got, again))
            else:
                err, rel = rel_err(got, ref)
                if not torch.isfinite(got).all() or rel > TOL_BATCH:
                    raise RuntimeError(
                        f"batch_lab {v} n={batch} {K}->{O}: max|err| "
                        f"{err:.3g} (rel {rel:.3g} > {TOL_BATCH})")
                same = torch.equal(got, fn(ws[0]))
            if not same:
                raise RuntimeError(f"batch_lab {v} n={batch} {K}->{O}: "
                                   "differs from run to run")
            ms = gbs = plain_ms = None
            if on_card:
                cyc = itertools.cycle(ws)
                ms = timed(lambda: fn(next(cyc)))
                gbs = wbytes / (ms * 1e-3) / 1e9
                plain_ms = timed(lambda: plain(ws[0]), reps=3, warmup=1)
                if lib_ms is None and math_ != "dma":
                    cyw = itertools.cycle(ws)
                    lib_ms = timed(lambda: torch.matmul(
                        x, dequantize_km(next(cyw), torch.bfloat16)),
                        reps=5, warmup=1)
            if math_ == "dma":
                dma_gbs[geom] = gbs
            corr_ops = 2 * batch * (K // QK) * O if math_ == "bnos" else 0
            nbytes = (wbytes + x.numel() * 2 + batch * O * 4
                      + (2 * O * 4 if math_ == "dma" else 0)
                      + (K // QK * O * 2 + batch * O * 4
                         if math_ == "bnos" else 0))
            plan = (list(batch_plan(dev, math_, geom, batch, K, O))
                    if on_card and math_ != "dma" else None)
            row = dict(tool="batch_lab", variant=v, geometry=geom, math=math_,
                       plan=plan,
                       kernel="q4_lab_dma" if math_ == "dma"
                       else "q4_batch_lab",
                       shape=f"{v} n={batch} {K}->{O}", n=batch, K=K, O=O,
                       layout="ps", block_kh=bkh if math_ == "dma" else None,
                       ms=ms, gbs=gbs,
                       vs_dma=(gbs / dma_gbs[geom]
                               if gbs and dma_gbs.get(geom) else None),
                       max_abs_err=err, rel_err=rel, plain_ms=plain_ms,
                       yardstick_ms=lib_ms,
                       library_ms=None if math_ == "dma" else lib_ms,
                       nbytes=nbytes,
                       ops=0 if math_ == "dma"
                       else 2 * batch * K * O + corr_ops,
                       peak="bf16", device=card)
            rows.append(row)
            print(format_row(row), flush=True)
    return rows


def format_row(r: Dict) -> str:
    head = f"  {r['variant']:10s} n={r['n']} {r['K']}->{r['O']} "
    err = f"max|err| {r['max_abs_err']:.2e} (rel {r['rel_err']:.2e})"
    if r["ms"] is None:
        return head + f"ms not measured (on {r['device']})  {err}"
    ratio = "" if r["vs_dma"] is None else f"  {r['vs_dma']:.2f}x dma"
    lib = ("" if r["library_ms"] is None
           else f"  library {r['library_ms']:.4f} ms")
    what = "nt, cluster" if r["geometry"] == "2d" else "nt, bands"
    plan = ("" if r.get("plan") is None
            else f"  plan {tuple(r['plan'])} ({what})")
    return (head + f"{r['ms']:8.4f} ms {r['gbs']:7.1f} GB/s{ratio}  {err}"
            + lib + plan)


def check(n: int = 16, device: DeviceLike = None) -> Dict[str, float]:
    """Each K15 variant's max|err| / max|oracle| against an f32 oracle
    (f32 dequantize and a matmul) on a 1024 x 1024 weight, as the TPU
    tool's ``check``: what the plane's rounding costs, not a port error."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    K = O = 1024  # noqa: N806
    w = _plane_split_weight(K, O, 1, dev)
    x = torch.randn((n, K), generator=g, device=dev).to(torch.bfloat16)
    ref = torch.matmul(x.to(torch.float32), dequantize_km(w, torch.float32))
    out = {}
    for geom in GEOMETRIES:
        for math_ in BATCH_MATHS:
            corr = batch_corr(x, w.scales) if math_ == "bnos" else None
            got = q4_batch_lab(x, w.packed, w.scales, math_, geom, corr)
            out[f"{geom}/{math_}"] = rel_err(got, ref)[1]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--shapes", default="gptj", choices=sorted(SHAPES))
    ap.add_argument("--shape", default=None,
                    help="one O,K instead of --shapes")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--block-kh", type=int, default=BLOCK_KH)
    ap.add_argument("--check", action="store_true",
                    help="numerics only (vs an f32 oracle)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.check:
        rel = check(device=args.device)
        for v, e in rel.items():
            print(f"{v:10s} relerr {e:.2e}", flush=True)
        return rel
    shapes = ([tuple(int(t) for t in args.shape.split(","))] if args.shape
              else SHAPES[args.shapes])
    return run(args.batch, shapes, args.variants.split(","), args.device,
               args.block_kh)


if __name__ == "__main__":
    main()
