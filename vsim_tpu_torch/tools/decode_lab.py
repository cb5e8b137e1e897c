"""Stacked-layer Q4 decode lab on the card (port of tools/decode_lab.py).

    python -m vsim_tpu_torch.tools.decode_lab [--n 1]
        [--variants cur,flat,v2] [--groups w_qkv,wo,w_fc,w_proj]
        [--shape K,O] [--layers L] [--device cpu]

Does a stacked kernel that reads its layer index on the device and
de-interleaves x itself cost more than one on a single layer's weight?  On
GPT-J-6B's four stacked groups (``SHAPES``, L = 28 layers of random bytes
and scales U[0, 0.01) in bf16 from a seed, as ``stacked_weight`` makes
them) at ``--n`` rows of bf16 x:

  cur   K10 ``q4_matmul_stacked`` with bf16 planes (the main path's stacked
        kernel; layer index an int32 on the device)
  flat  K9 ``q4_matmul_i`` on one layer's view (f32 planes, its contract)
  v2    K12 ``q4_lab_gemv_layout(..., "v2")``: f32x on the stacked "i"
        weight, layer index on the device, raw x de-interleaved inside

Each call takes layer i % L, so the stack itself rotates the weights past
the 50 MB L2 (flat's view rotates with it).  Each variant is held against
its plain version on the last layer (v2 also against a second run, bit for
bit, and against cur: the same function), then timed per call beside a
library yardstick the port never calls (``dequantize_km`` of the layer to
bf16 + ``torch.matmul``, the layers rotating too).  Prints µs a call and
GB/s of one layer's bytes.  ``--shape`` and ``--layers`` size a
run on the CPU.  The TPU's geometry sweep (``--sweep``) does not carry
over.
"""

from __future__ import annotations

import argparse
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.ops.q4_cuda import (q4_matmul_i, q4_matmul_i_plain,
                                        q4_matmul_stacked,
                                        q4_matmul_stacked_plain)
from vsim_tpu_torch.ops.q4_lab import (TOL_LAB, q4_lab_gemv_layout,
                                       q4_lab_gemv_layout_plain)
from vsim_tpu_torch.quant.q4 import QK, Q4Tensor, dequantize_km
from vsim_tpu_torch.timing import rel_err, timed

L = 28  # GPT-J-6B's layers
SHAPES = {  # group -> (K, O), as tools/decode_lab.py:SHAPES
    "w_qkv": (4096, 12288),
    "wo": (4096, 4096),
    "w_fc": (4096, 16384),
    "w_proj": (16384, 4096),
}
VARIANTS = ("cur", "flat", "v2")
KERNEL = {"cur": "q4_matmul_stacked", "flat": "q4_matmul_i",
          "v2": "q4_lab_gemv"}


def stacked_weight(L: int, K: int, O: int, seed: int,  # noqa: N803
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed uint8 [L, K/2, O], bf16 scales [L, K/32, O]): uniform bytes
    and scales U[0, 0.01) (tools/decode_lab.py:stacked_weight)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    packed = torch.randint(0, 256, (L, K // 2, O), generator=g, device=device,
                           dtype=torch.uint8)
    scales = (torch.rand((L, K // QK, O), generator=g, device=device)
              * 0.01).to(torch.bfloat16)
    return packed, scales


def run(n: int = 1, groups: Sequence[str] = tuple(SHAPES),
        variants: Sequence[str] = VARIANTS, device: DeviceLike = None,
        shape: Optional[Tuple[int, int]] = None,
        layers: int = L) -> List[Dict]:
    """One row a (group, variant), printed as it is measured; raises on an
    unknown variant or a failed check."""
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {VARIANTS}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    il_all = torch.arange(layers, dtype=torch.int32, device=dev)
    last = il_all[layers - 1:]
    rows: List[Dict] = []
    for gi, group in enumerate(groups):
        K, O = shape or SHAPES[group]  # noqa: N806
        packed, scales = stacked_weight(layers, K, O, gi, dev)
        layer_bytes = (packed[0].numel() + scales[0].numel() * 2)
        g = torch.Generator(device=dev)
        g.manual_seed(100 + gi)
        x = torch.randn((n, K), generator=g, device=dev).to(torch.bfloat16)
        print(f"decode_lab: device={card} n={n} {group} K={K} O={O} "
              f"L={layers} ({layer_bytes / 1e6:.1f} MB a layer)", flush=True)
        fns = {
            "cur": (lambda i: q4_matmul_stacked(x, packed, scales,
                                                il_all[i:i + 1], None, True),
                    lambda il: q4_matmul_stacked_plain(x, packed, scales, il,
                                                       None, True)),
            "flat": (lambda i: q4_matmul_i(x, packed[i], scales[i]),
                     lambda il: q4_matmul_i_plain(x, packed[layers - 1],
                                                  scales[layers - 1])),
            "v2": (lambda i: q4_lab_gemv_layout(x, packed, scales, "v2",
                                                il_all[i:i + 1]),
                   lambda il: q4_lab_gemv_layout_plain(x, packed, scales,
                                                       "v2", il)),
        }
        outs = {}
        lib_ms = None
        if on_card:
            cyc = itertools.cycle(range(layers))
            lib_ms = timed(lambda: torch.matmul(x, dequantize_km(
                Q4Tensor(packed, scales).layer(next(cyc)), torch.bfloat16)),
                reps=5, warmup=1)
        for v in [v for v in VARIANTS if v in variants]:
            fn, plain = fns[v]
            got = fn(layers - 1)
            err, rel = rel_err(got, plain(last))
            if not torch.isfinite(got).all() or rel > TOL_LAB:
                raise RuntimeError(f"decode_lab {v} n={n} {group}: max|err| "
                                   f"{err:.3g} (rel {rel:.3g} > {TOL_LAB})")
            if v == "v2" and not torch.equal(got, fn(layers - 1)):
                raise RuntimeError(f"decode_lab v2 n={n} {group}: differs "
                                   "from run to run")
            outs[v] = got
            ms = gbs = plain_ms = None
            if on_card:
                cyc = itertools.cycle(range(layers))
                ms = timed(lambda: fn(next(cyc)))
                gbs = layer_bytes / (ms * 1e-3) / 1e9
                plain_ms = timed(lambda: plain(last), reps=3, warmup=1)
            row = dict(tool="decode_lab", variant=v, kernel=KERNEL[v],
                       group=group, shape=f"{group} {v} n={n} {K}->{O} "
                       f"L={layers}", n=n, K=K, O=O, L=layers, ms=ms, gbs=gbs,
                       max_abs_err=err, rel_err=rel, plain_ms=plain_ms,
                       library_ms=lib_ms,
                       nbytes=layer_bytes + n * K * 2 + n * O * 4,
                       ops=2 * n * K * O,
                       peak="f32" if v == "flat" else "bf16", device=card)
            rows.append(row)
            print(format_row(row), flush=True)
        if "v2" in outs and "cur" in outs:  # one function, two kernels
            err, rel = rel_err(outs["v2"], outs["cur"])
            if rel > TOL_LAB:
                raise RuntimeError(f"decode_lab n={n} {group}: v2 and cur "
                                   f"differ by {err:.3g} (rel {rel:.3g})")
    return rows


def format_row(r: Dict) -> str:
    head = f"  {r['group']:7s} {r['variant']:5s} "
    err = f"max|err| {r['max_abs_err']:.2e} (rel {r['rel_err']:.2e})"
    if r["ms"] is None:
        return head + f"ms not measured (on {r['device']})  {err}"
    return head + (f"{r['ms'] * 1e3:7.1f} us/call {r['gbs']:7.1f} GB/s  "
                   f"{err}  library {r['library_ms'] * 1e3:.1f} us")


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1, help="decode rows (batch)")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--groups", default=",".join(SHAPES))
    ap.add_argument("--shape", default=None,
                    help="K,O for every group instead of GPT-J-6B's")
    ap.add_argument("--layers", type=int, default=L)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    shape = (tuple(int(t) for t in args.shape.split(","))
             if args.shape else None)
    return run(args.n, args.groups.split(","), args.variants.split(","),
               args.device, shape, args.layers)


if __name__ == "__main__":
    main()
