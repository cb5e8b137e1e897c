"""K1 under every plan of its split, beside the plan ``core_plan`` picks.

    python -m vsim_tpu_torch.tools.core_plans [--n 1]

At every Q4 weight shape of GPT-J-6B and Pythia-12B (``read_designs.SHAPES``),
on random weights rotated past the 50 MB L2, times K1
(``q4_gemv_ps_planned``) under each (wc, cluster) whose clusters all fit on
the card at once, best of two rounds of ``timing.timed``, after checking
each plan within ``TOL_LAB`` of the plain version.  Prints one line a
shape: the card's flat read of the same bytes (``read_designs.flat_ms``),
the fastest plans, and ``core_plan``'s pick with its time and its ratio to
the flat read and to the fastest plan.  Runs on the CUDA card only.
"""

from __future__ import annotations

import argparse
import itertools
from typing import Dict, List

import torch

from vsim_tpu_torch.ops import q4_cuda
from vsim_tpu_torch.ops.q4_lab import TOL_LAB
from vsim_tpu_torch.quant.q4 import to_plane_split
from vsim_tpu_torch.timing import rel_err, rotation, timed
from vsim_tpu_torch.tools.lab import lab_weight
from vsim_tpu_torch.tools.read_designs import SHAPES, flat_ms


def run(n: int = 1) -> List[Dict]:
    dev = torch.device("cuda")
    index = dev.index or 0
    card = torch.cuda.get_device_name(dev)
    fits = [q4_cuda._max_clusters("q4_gemv_ps", index, c)
            for c in range(1, q4_cuda.CORE_MAX_CLUSTER + 1)]
    print(f"core_plans: device={card}, n = {n}, clusters that fit by size "
          f"1-{q4_cuda.CORE_MAX_CLUSTER}: {fits}", flush=True)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for model, name, K, O in SHAPES:  # noqa: N806
        w0 = to_plane_split(lab_weight(K, O, 0, dev))
        ws = rotation(lambda i: w0 if i == 0 else to_plane_split(
            lab_weight(K, O, i, dev)), w0.nbytes)
        x = torch.randn((n, K), generator=g, device=dev).to(torch.bfloat16)
        ref = q4_cuda.q4_gemv_ps_plain(x, w0.packed, w0.scales)
        tiles = -(-O // q4_cuda.CORE_TILE_O)
        times = {}
        for wc, c in itertools.product((1, 2, 4), range(1, len(fits) + 1)):
            if -(-tiles // wc) > fits[c - 1]:
                continue
            plan = (wc, c)
            err, rel = rel_err(q4_cuda.q4_gemv_ps_planned(
                x, w0.packed, w0.scales, None, plan), ref)
            if rel > TOL_LAB:
                raise RuntimeError(f"core_plans {plan} {K}->{O}: max|err| "
                                   f"{err:.3g} (rel {rel:.3g} > {TOL_LAB})")
            cyc = itertools.cycle(ws)

            def call(plan=plan):
                w = next(cyc)
                return q4_cuda.q4_gemv_ps_planned(x, w.packed, w.scales, None,
                                                  plan)

            times[plan] = min(timed(call) for _ in range(2))
        pick = q4_cuda._plan("q4_gemv_ps", index, K, O)
        flat = flat_ms(K, O, dev)
        best = min(times.values())
        order = sorted(times, key=times.get)
        print(f"  {model} {name} {K}->{O}: flat {flat * 1e3:.2f} us; "
              + ", ".join(f"{p} {times[p] * 1e3:.2f}" for p in order[:4])
              + f"; pick {pick} {times[pick] * 1e3:.2f} us "
              f"({times[pick] / flat:.2f}x flat, {times[pick] / best:.2f}x "
              "the fastest plan)", flush=True)
        rows.append(dict(model=model, weight=name, K=K, O=O, n=n,
                         flat_ms=flat, pick=pick, device=card,
                         times={str(p): t for p, t in times.items()}))
        del ws, w0
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1)
    return run(ap.parse_args(argv).n)


if __name__ == "__main__":
    main()
