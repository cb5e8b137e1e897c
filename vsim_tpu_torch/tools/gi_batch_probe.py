"""K1 at 8-32 rows against K2 (port of tools/gi_batch_probe.py).

    python -m vsim_tpu_torch.tools.gi_batch_probe [--check]
        [--shapes gptj|pythia12b] [--device cpu]

The TPU tool asked whether the grouped-integer kernel (``_kernel_ps_giw``,
pallas_q4.py:339) with its n <= 8 gate lifted streams a Q4 weight near the
memory rate at 8 < n <= 32.  Its counterpart here is K1 ``q4_gemv_ps``,
whose 9-32-row instance (csrc/q4_gemv_ps.cu, ``rows::``) reads the weight
once for 2 or 4 n-tiles of 8 rows; the router still sends 9-32 rows to K2,
and this tool measures where that hand-over should sit on the card.

``--check``: K1 against its plain version (``q4_gemv_ps_plain``, the
grouped-integer math) at n in {8, 16, 24, 32} on a 1024x1024 weight,
printing the relative error.  The default mode: GPT-J-6B's shapes
(12288x4096, 16384x4096, 4096x16384; ``--shapes pythia12b``: 15360x5120,
20480x5120, 5120x20480) at n in {8, 16, 32}, two variants:

  giw   K1 (bf16 x, integer sums per 32-row group, scale after)
  f32x  K2 ``q4_matmul_ps`` under the f32x math: bf16 planes and x
        (``ops/matmul.py:ps_round_planes``)

Each is first held against its plain version (and K1 against a second run
of itself, bit for bit) and raises on a miss; then, on the card, timed with
``timing.timed`` over a rotation of weights past the 50 MB L2, as
tools/lab.py does.  A row prints the JAX tool's keys (``shape``, ``n``,
``variant``, ``kchunk``, ``ms``, ``gbs``: GB/s of the weight's bytes, O·K/2
+ O·K/32·2) and the card's: the bound (max of the bytes over the memory
rate and 2·n·K·O at the bf16 peak), the ratio to K2 at the same shape and
n, the plain version's and the library's ms (``dequantize_km`` +
``torch.matmul`` in bf16, never called by the port).  The TPU's ``kchunk``
(how its block-diagonal dot split the contraction) and ``block_kh`` (its
DMA band) have no counterpart: K1 walks whole 32-row groups of each plane,
so ``kchunk`` is null.  Runs on the card; ``--device cpu`` runs the plain
versions and times nothing.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Dict, List, Sequence, Tuple

import torch

from vsim_tpu_torch.device import DeviceLike, card_peaks, resolve_device
from vsim_tpu_torch.ops.matmul import ps_round_planes
from vsim_tpu_torch.ops.q4_cuda import (q4_gemv_ps, q4_gemv_ps_plain,
                                        q4_matmul_ps, q4_matmul_ps_plain)
from vsim_tpu_torch.quant.q4 import QK, Q4Tensor, dequantize_km
from vsim_tpu_torch.timing import rel_err, rotation, timed

SHAPES = {"gptj": ((12288, 4096), (16384, 4096), (4096, 16384)),
          "pythia12b": ((15360, 5120), (20480, 5120), (5120, 20480))}
NS = (8, 16, 32)
CHECK_NS = (8, 16, 24, 32)
VARIANTS = ("giw", "f32x")
TOL = 1e-4  # of max|plain|: K1 and K2 sum in another order than the plain


def ps_weight(K: int, O: int, seed: int, device) -> Q4Tensor:  # noqa: N803
    """A random plane-split Q4 weight [K/2, O] from ``seed``: uniform bytes,
    bf16 scales of N(0, 0.01²)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    packed = torch.randint(0, 256, (K // 2, O), generator=g, device=device,
                           dtype=torch.uint8)
    scales = (torch.randn((K // QK, O), generator=g, device=device)
              * 0.01).to(torch.bfloat16)
    return Q4Tensor(packed, scales, "ps")


def weight_bytes(O: int, K: int) -> int:  # noqa: N803
    """The TPU tool's count: packed nibbles and bf16 scales."""
    return O * K // 2 + O * K // 32 * 2


def _variant(v: str, n: int):
    """(kernel, plain) of a variant at n rows of bf16 x."""
    if v == "giw":
        return (lambda x, w: q4_gemv_ps(x, w.packed, w.scales),
                lambda x, w: q4_gemv_ps_plain(x, w.packed, w.scales))
    if v == "f32x":
        rp = ps_round_planes(n, torch.bfloat16, "f32x")
        return (lambda x, w: q4_matmul_ps(x, w.packed, w.scales, None, rp),
                lambda x, w: q4_matmul_ps_plain(x, w.packed, w.scales, None,
                                                rp))
    raise ValueError(f"unknown variant {v!r}; known: {VARIANTS}")


def check(ns: Sequence[int] = CHECK_NS,
          device: DeviceLike = None) -> List[Dict]:
    """K1 against its plain version at each n on a 1024x1024 weight: one
    row each, printed."""
    dev = resolve_device(device)
    O = K = 1024  # noqa: N806
    w = ps_weight(K, O, 1, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rows = []
    for n in ns:
        x = torch.randn((n, K), generator=g, device=dev).to(torch.bfloat16)
        got = q4_gemv_ps(x, w.packed, w.scales)
        err, rel = rel_err(got, q4_gemv_ps_plain(x, w.packed, w.scales))
        if not torch.isfinite(got).all() or rel > TOL:
            raise RuntimeError(f"gi_batch_probe --check n={n}: rel err "
                               f"{rel:.3g} > {TOL}")
        rows.append(dict(shape=[O, K], n=n, max_abs_err=err, rel_err=rel))
        print(f"n={n:3d} relerr {rel:.2e}", flush=True)
    return rows


def run(shapes: Sequence[Tuple[int, int]] = SHAPES["gptj"],
        ns: Sequence[int] = NS, variants: Sequence[str] = VARIANTS,
        device: DeviceLike = None) -> List[Dict]:
    """One row a (shape, n, variant), printed as a JSON line as it is
    measured; raises on a failed check."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    peaks = card_peaks(torch.cuda.get_device_name(dev)) if on_card else None
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    rows: List[Dict] = []
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for O, K in shapes:  # noqa: N806
        w0 = ps_weight(K, O, 0, dev)
        wb = weight_bytes(O, K)
        ws = (rotation(lambda i: w0 if i == 0 else ps_weight(K, O, i, dev),
                       wb) if on_card else [w0])
        for n in ns:
            x = torch.randn((n, K), generator=g, device=dev).to(
                torch.bfloat16)
            lib_ms = None
            for v in variants:
                fn, plain = _variant(v, n)
                got = fn(x, w0)
                err, rel = rel_err(got, plain(x, w0))
                if not torch.isfinite(got).all() or rel > TOL:
                    raise RuntimeError(f"gi_batch_probe {v} n={n} {K}->{O}: "
                                       f"rel err {rel:.3g} > {TOL}")
                if v == "giw" and not torch.equal(got, fn(x, w0)):
                    raise RuntimeError(f"gi_batch_probe giw n={n} {K}->{O}: "
                                       "differs from run to run")
                ms = gbs = plain_ms = bound_ms = None
                if on_card:
                    cyc = itertools.cycle(ws)
                    ms = timed(lambda: fn(x, next(cyc)))
                    gbs = wb / (ms * 1e-3) / 1e9
                    plain_ms = timed(lambda: plain(x, w0), reps=3, warmup=1)
                    if lib_ms is None:
                        cyw = itertools.cycle(ws)
                        lib_ms = timed(lambda: torch.matmul(
                            x, dequantize_km(next(cyw), torch.bfloat16)),
                            reps=5, warmup=1)
                    nbytes = wb + n * K * 2 + n * O * 4
                    bound_ms = max(nbytes / peaks[0],
                                   2 * n * K * O / peaks[1]) * 1e3
                rows.append({"shape": [O, K], "n": n, "variant": v,
                             "kchunk": None, "ms": ms, "gbs": gbs,
                             "kernel": ("q4_gemv_ps" if v == "giw"
                                        else "q4_matmul_ps"),
                             "bound_ms": bound_ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "max_abs_err": err,
                             "rel_err": rel, "device": card})
        # each row's ratio to K2 at its shape and n
        for r in rows[-len(ns) * len(variants):]:
            k2 = next((q["ms"] for q in rows if q["shape"] == r["shape"]
                       and q["n"] == r["n"] and q["variant"] == "f32x"), None)
            r["vs_k2"] = r["ms"] / k2 if r["ms"] and k2 else None
            print(json.dumps(r), flush=True)
        del ws, w0
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--shapes", default="gptj", choices=sorted(SHAPES))
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions and times nothing")
    args = ap.parse_args(argv)
    if args.check:
        check(device=args.device)
    else:
        run(SHAPES[args.shapes], device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
