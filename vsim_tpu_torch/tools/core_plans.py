"""K1, K9/K10, K12 and K15, under every plan of their split, beside the
plan the wrapper picks.

    python -m vsim_tpu_torch.tools.core_plans [--n 1] [--kernel k1 i lab batch]

At every Q4 weight shape of GPT-J-6B and Pythia-12B (``read_designs.SHAPES``),
on random weights rotated past the 50 MB L2, times K1
(``q4_gemv_ps_planned``, plane-split weights) and the "i"-layout kernel
(``q4_matmul_i_planned`` with f32 planes: K9, and K10 under the stacked
engine's gi math) and K12 (``q4_lab_gemv_planned``, f32x, "i" layout)
under each (wc, cluster) whose clusters all fit on the card at once, best
of two rounds of ``timing.timed``, after checking each plan within
``TOL_LAB`` of the plain version.  Prints one line a shape and kernel: the
card's flat read of the same bytes (``read_designs.flat_ms``), the fastest
plans, and the wrapper's pick (``core_plan``, ``i_plan``, ``lab_plan``)
with its time and its ratio to the flat read and to the fastest plan.
n <= 8 (K1's rows; the "i" kernels' one n-tile).  ``--kernel batch`` times
K15's 2d geometry (``q4_batch_lab_planned``, f32x) at GPT-J-6B's four Q4
shapes at n = 64 and 128 under every cluster (1-8) whose clusters all fit at once,
on the n-tiles the wrapper takes, marking its pick (``batch_2d_plan``).
Runs on the CUDA card only.
"""

from __future__ import annotations

import argparse
import functools
import itertools
from typing import Dict, List, Sequence

import torch

from vsim_tpu_torch.ops import q4_batch_lab as bl
from vsim_tpu_torch.ops import q4_cuda, q4_lab
from vsim_tpu_torch.ops.q4_lab import TOL_LAB
from vsim_tpu_torch.quant.q4 import to_plane_split
from vsim_tpu_torch.timing import rel_err, rotation, timed
from vsim_tpu_torch.tools.lab import lab_weight
from vsim_tpu_torch.tools.read_designs import SHAPES, flat_ms

KERNELS = ("k1", "i", "lab", "batch")
BATCH_SHAPES = (("qkv", 4096, 12288), ("wo", 4096, 4096), ("fc", 4096, 16384),
                ("proj", 16384, 4096))  # GPT-J-6B's (name, K, O)


def _k1_weight(K, O, i, dev):  # noqa: N803
    return to_plane_split(lab_weight(K, O, i, dev))


def _kernel(kind: str, index: int):
    """(weight maker, planned call, plain call, clusters that fit, pick)."""
    if kind == "k1":
        return (_k1_weight,
                lambda x, w, plan: q4_cuda.q4_gemv_ps_planned(
                    x, w.packed, w.scales, None, plan),
                lambda x, w: q4_cuda.q4_gemv_ps_plain(x, w.packed, w.scales),
                functools.partial(q4_cuda._max_clusters, "q4_gemv_ps", index),
                lambda n, k, o: q4_cuda._plan("q4_gemv_ps", index, k, o))
    if kind == "lab":
        return (lab_weight,
                lambda x, w, plan: q4_lab.q4_lab_gemv_planned(
                    x, w.packed, w.scales, "f32x", "i", plan=(1, *plan)),
                lambda x, w: q4_lab.q4_lab_gemv_plain(x, w.packed, w.scales,
                                                      "f32x"),
                functools.partial(q4_lab._max_clusters, index, "f32x", "i",
                                  1),
                lambda n, k, o: q4_lab._plan(index, "f32x", "i", n, k,
                                             o)[1:])
    return (lab_weight,
            lambda x, w, plan: q4_cuda.q4_matmul_i_planned(
                x, w.packed, w.scales, None, None, False, (1, *plan)),
            lambda x, w: q4_cuda.q4_matmul_i_plain(x, w.packed, w.scales),
            functools.partial(q4_cuda._i_max_clusters, index, True, False, 1),
            lambda n, k, o: q4_cuda._i_plan(index, n, k, o, True, False)[1:])


def run_batch(ns: Sequence[int] = (64, 128), math_: str = "f32x") -> List[Dict]:
    """K15's 2d geometry under every cluster that fits, at GPT-J-6B's four
    shapes, one printed line a (shape, n)."""
    dev = torch.device("cuda")
    index = dev.index or 0
    card = torch.cuda.get_device_name(dev)
    m = bl.BATCH_MATHS.index(math_)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for n in ns:
        nt = bl.batch_tiles(n)
        fits = [bl._max_clusters(index, m, False, nt, c)
                for c in range(1, bl.BATCH_MAX_CLUSTER + 1)]
        print(f"core_plans batch: device={card}, n = {n}, {math_}, {nt} "
              f"n-tiles, clusters that fit by size 1-{len(fits)}: {fits}",
              flush=True)
        for name, K, O in BATCH_SHAPES:  # noqa: N806
            w0 = to_plane_split(lab_weight(K, O, 0, dev))
            ws = rotation(lambda i: w0 if i == 0 else to_plane_split(  # noqa: B023
                lab_weight(K, O, i, dev)), w0.nbytes)  # noqa: B023
            x = torch.randn((n, K), generator=g, device=dev).to(torch.bfloat16)
            ref = bl.q4_batch_lab_plain(x, w0.packed, w0.scales, math_, "2d")
            tiles = -(-O // (bl.BATCH_WARPS * bl.batch_tile_o(nt)))
            times = {}
            for c in range(1, len(fits) + 1):
                if c > 1 and tiles > fits[c - 1]:
                    continue
                plan = (nt, c)
                err, rel = rel_err(bl.q4_batch_lab_planned(
                    x, w0.packed, w0.scales, math_, "2d", None, plan), ref)
                if rel > bl.TOL_BATCH:
                    raise RuntimeError(f"core_plans batch {plan} {K}->{O}: "
                                       f"max|err| {err:.3g} (rel {rel:.3g})")
                cyc = itertools.cycle(ws)

                def call(plan=plan):
                    w = next(cyc)  # noqa: B023
                    return bl.q4_batch_lab_planned(x, w.packed, w.scales,  # noqa: B023
                                                   math_, "2d", None, plan)

                times[plan] = min(timed(call) for _ in range(2))
            pick = bl.batch_plan(dev, math_, "2d", n, K, O)
            best = min(times.values())
            print(f"  batch gpt-j-6b {name} n={n} {K}->{O}: " + ", ".join(
                f"{p}{' (pick)' if p == pick else ''} {times[p] * 1e3:.1f}"
                for p in sorted(times, key=times.get)) + f" us; pick {pick} "
                f"{times[pick] / best:.2f}x the fastest plan", flush=True)
            rows.append(dict(kernel="batch", model="gpt-j-6b", weight=name,
                             K=K, O=O, n=n, math=math_, pick=pick,
                             device=card,
                             times={str(p): t for p, t in times.items()}))
            del ws, w0
            torch.cuda.empty_cache()
    return rows


def run(n: int = 1, kernels: Sequence[str] = KERNELS) -> List[Dict]:
    rows = run_batch() if "batch" in kernels else []
    kernels = [k for k in kernels if k != "batch"]
    if kernels and not 1 <= n <= q4_cuda.GEMV_MAX_ROWS:
        raise ValueError(f"core_plans times n <= {q4_cuda.GEMV_MAX_ROWS}")
    dev = torch.device("cuda")
    index = dev.index or 0
    card = torch.cuda.get_device_name(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for kind in kernels:
        make, planned, plain, max_clusters, pick_of = _kernel(kind, index)
        fits = [max_clusters(c)
                for c in range(1, q4_cuda.CORE_MAX_CLUSTER + 1)]
        print(f"core_plans {kind}: device={card}, n = {n}, clusters that "
              f"fit by size 1-{q4_cuda.CORE_MAX_CLUSTER}: {fits}", flush=True)
        for model, name, K, O in SHAPES:  # noqa: N806
            w0 = make(K, O, 0, dev)

            def weight(i, K=K, O=O):  # noqa: N803
                return w0 if i == 0 else make(K, O, i, dev)  # noqa: B023

            ws = rotation(weight, w0.nbytes)
            x = torch.randn((n, K), generator=g, device=dev).to(torch.bfloat16)
            ref = plain(x, w0)
            tiles = -(-O // q4_cuda.CORE_TILE_O)
            times = {}
            for wc, c in itertools.product((1, 2, 4), range(1, len(fits) + 1)):
                if -(-tiles // wc) > fits[c - 1]:
                    continue
                plan = (wc, c)
                err, rel = rel_err(planned(x, w0, plan), ref)
                if rel > TOL_LAB:
                    raise RuntimeError(f"core_plans {kind} {plan} {K}->{O}: "
                                       f"max|err| {err:.3g} (rel {rel:.3g} > "
                                       f"{TOL_LAB})")
                cyc = itertools.cycle(ws)

                def call(plan=plan):
                    return planned(x, next(cyc), plan)  # noqa: B023

                times[plan] = min(timed(call) for _ in range(2))
            pick = pick_of(n, K, O)
            flat = flat_ms(K, O, dev)
            best = min(times.values())
            order = sorted(times, key=times.get)
            print(f"  {kind} {model} {name} {K}->{O}: flat {flat * 1e3:.2f} "
                  "us; " + ", ".join(f"{p} {times[p] * 1e3:.2f}"
                                     for p in order[:4])
                  + f"; pick {pick} {times[pick] * 1e3:.2f} us "
                  f"({times[pick] / flat:.2f}x flat, {times[pick] / best:.2f}x "
                  "the fastest plan)", flush=True)
            rows.append(dict(kernel=kind, model=model, weight=name, K=K, O=O,
                             n=n, flat_ms=flat, pick=pick, device=card,
                             times={str(p): t for p, t in times.items()}))
            del ws, w0
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1)
    ap.add_argument("--kernel", nargs="+", choices=KERNELS,
                    default=list(KERNELS))
    args = ap.parse_args(argv)
    return run(args.n, args.kernel)


if __name__ == "__main__":
    main()
