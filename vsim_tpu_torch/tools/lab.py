"""The bench the Q4 lab tools share (kernel_lab, gi_sweep, pair_lab,
pair_sweep, pair_probe in this package).

One shape and batch at a time: random Q4 weights from a seed on the device
(uniform bytes, bf16 scales of N(0, 0.01²)), bf16 x of N(0, 1).  Each
variant is first held against its plain version (and a lab kernel against a
second run of itself, bit for bit) and raises on a miss; then, on the card,
it is timed with ``timing.timed`` over a rotation of weights larger than
the 50 MB L2.  Variants:

  i32 u16 f32x f32f f32xf i32f f32b pairA pairB pairC   K12 under that math
  res w32 ps K12 under f32x in that operand layout (``q4_lab.GEMV_LAYOUTS``:
             "res" the "i" weight with K unsplit, "w32" and "ps" repacks
             made once for each weight of the rotation)
  dma        K13 (its layout: "i", or "ps" for gi_sweep), a read of every byte
  cur        K9 ``q4_matmul_i``: the main path's "i"-layout matmul
  gi         K2 ``q4_matmul_ps`` with bf16 planes, on the "ps" repack
  giw        K1 ``q4_gemv_ps`` (n <= 32), on the "ps" repack

Every run times K13 too, so each row carries its ratio to K13's rate
at its shape.  A row's GB/s counts the weight's bytes (packed and scales).
``yardstick_ms`` times ``dequantize_km`` + ``torch.matmul`` on the same
inputs (bf16 or f32 as the variant's planes), a yardstick the port never
calls; it is a row's ``library_ms`` where it computes the row's function
(not for K13).  On the CPU (``device="cpu"``)
the wrappers run their plain versions and nothing is timed.
"""

from __future__ import annotations

import argparse
import itertools
import types
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.ops.q4_cuda import (q4_gemv_ps, q4_gemv_ps_plain,
                                        q4_matmul_i, q4_matmul_i_plain,
                                        q4_matmul_ps, q4_matmul_ps_plain)
from vsim_tpu_torch.ops.q4_lab import (F32_MATHS, LAB_MATHS, TOL_LAB,
                                       block_sums, pack_w32, q4_lab_dma,
                                       q4_lab_dma_plain, q4_lab_gemv,
                                       q4_lab_gemv_layout,
                                       q4_lab_gemv_layout_plain,
                                       q4_lab_gemv_plain)
from vsim_tpu_torch.quant.q4 import (QK, Q4Tensor, dequantize_km,
                                     to_plane_split)
from vsim_tpu_torch.timing import rel_err, rotation, timed

LAYOUT_VARIANTS = ("res", "w32", "ps")  # K12's layouts on one weight
VARIANT_KERNEL = {**{m: "q4_lab_gemv" for m in LAB_MATHS + LAYOUT_VARIANTS},
                  "dma": "q4_lab_dma", "cur": "q4_matmul_i",
                  "gi": "q4_matmul_ps", "giw": "q4_gemv_ps"}
PS_VARIANTS = ("gi", "giw", "ps")


def tool_main(run, doc: str, batch: int, shape: Tuple[int, int],
              variants: Sequence[str], argv=None) -> List[Dict]:
    """The command line of a lab tool: ``--batch``, ``--shape`` O,K,
    ``--variants`` and ``--device`` (the CUDA card unless given; cpu runs
    the plain versions and times nothing), into ``run``."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--shape", default=f"{shape[0]},{shape[1]}",
                    help="O,K of the weight (e.g. 4096,16384 = GPT-J proj)")
    ap.add_argument("--variants", default=",".join(variants))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    o, k = (int(t) for t in args.shape.split(","))
    return run(args.batch, (o, k), args.variants.split(","), args.device)


def lab_weight(K: int, O: int, seed: int, device) -> Q4Tensor:  # noqa: N803
    """A random interleaved Q4 weight [K/2, O] from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    packed = torch.randint(0, 256, (K // 2, O), generator=g, device=device,
                           dtype=torch.uint8)
    scales = (torch.randn((K // QK, O), generator=g, device=device)
              * 0.01).to(torch.bfloat16)
    return Q4Tensor(packed, scales, "i")


def _exact(got, ref):
    """Max |difference| over the touch output and the checksum; raises
    unless both are equal."""
    (t, c), (tr, cr) = got, ref
    if not (torch.equal(t, tr) and torch.equal(c, cr)):
        d = max((t - tr).abs().max().item(),
                (c - cr).abs().max().item())
        raise RuntimeError(f"q4_lab_dma differs from its plain version "
                           f"(max|err| {d:.3g})")
    return 0.0, 0.0


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def run_variants(tool: str, O: int, K: int, batch: int,  # noqa: N803
                 variants: Sequence[str], device: DeviceLike = None,
                 block_kh: int = 512, dma_layout: str = "i") -> List[Dict]:
    """One row a variant (K13's "dma" first, always), printed as it is
    measured; raises on an unknown variant or a failed check."""
    unknown = [v for v in variants if v not in VARIANT_KERNEL]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: "
                         f"{sorted(VARIANT_KERNEL)}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    order = ["dma"] + [v for v in dict.fromkeys(variants) if v != "dma"]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn((batch, K), generator=g, device=dev).to(torch.bfloat16)
    xs = block_sums(x)
    w0 = lab_weight(K, O, 0, dev)
    wbytes = w0.nbytes
    ws = (rotation(lambda i: w0 if i == 0 else lab_weight(K, O, i, dev),
                   wbytes) if on_card else [w0])
    need_ps = dma_layout == "ps" or any(v in PS_VARIANTS for v in order)
    wps = [to_plane_split(w) for w in ws] if need_ps else None
    w32s = ([types.SimpleNamespace(packed=pack_w32(w.packed),
                                   scales=w.scales) for w in ws]
            if "w32" in order else None)
    print(f"{tool}: device={card} batch={batch} shape O={O} K={K} "
          f"({wbytes / 1e6:.1f} MB of weight, {len(ws)} in rotation)",
          flush=True)
    lib_ms: Dict[torch.dtype, Optional[float]] = {}
    rows: List[Dict] = []
    dma_gbs = None
    for v in order:
        wl = (wps if v in PS_VARIANTS or (v == "dma" and dma_layout == "ps")
              else w32s if v == "w32" else ws)
        bf16_planes = v not in F32_MATHS and v != "cur"
        if v == "dma":
            def fn(w):
                return q4_lab_dma(x, w.packed, w.scales, dma_layout, block_kh)

            def plain(w):
                return q4_lab_dma_plain(x, w.packed, w.scales, dma_layout,
                                        block_kh)
        elif v in LAB_MATHS:
            vxs = xs if v == "pairC" else None

            def fn(w, v=v, vxs=vxs):
                return q4_lab_gemv(x, w.packed, w.scales, v, vxs)

            def plain(w, v=v, vxs=vxs):
                return q4_lab_gemv_plain(x, w.packed, w.scales, v, vxs)
        elif v in LAYOUT_VARIANTS:
            def fn(w, v=v):
                return q4_lab_gemv_layout(x, w.packed, w.scales, v)

            def plain(w, v=v):
                return q4_lab_gemv_layout_plain(x, w.packed, w.scales, v)
        elif v == "cur":
            def fn(w):
                return q4_matmul_i(x, w.packed, w.scales)

            def plain(w):
                return q4_matmul_i_plain(x, w.packed, w.scales)
        elif v == "gi":
            def fn(w):
                return q4_matmul_ps(x, w.packed, w.scales, None, True)

            def plain(w):
                return q4_matmul_ps_plain(x, w.packed, w.scales, None, True)
        else:
            def fn(w):
                return q4_gemv_ps(x, w.packed, w.scales)

            def plain(w):
                return q4_gemv_ps_plain(x, w.packed, w.scales)
        got = fn(wl[0])
        ref = plain(wl[0])
        if v == "dma":
            err, rel = _exact(got, ref)
        else:
            err, rel = rel_err(got, ref)
            if not torch.isfinite(got).all() or rel > TOL_LAB:
                raise RuntimeError(f"{tool} {v} n={batch} {K}->{O}: max|err| "
                                   f"{err:.3g} (rel {rel:.3g} > {TOL_LAB})")
        if VARIANT_KERNEL[v].startswith("q4_lab") and not _same(got, fn(wl[0])):
            raise RuntimeError(f"{tool} {v} n={batch} {K}->{O}: differs from "
                               "run to run")
        ms = gbs = plain_ms = None
        wdt = torch.bfloat16 if bf16_planes else torch.float32
        if on_card:
            cyc = itertools.cycle(wl)
            ms = timed(lambda: fn(next(cyc)))
            gbs = wbytes / (ms * 1e-3) / 1e9
            plain_ms = timed(lambda: plain(wl[0]), reps=3, warmup=1)
            if wdt not in lib_ms:
                cyw = itertools.cycle(ws)
                lib_ms[wdt] = timed(lambda: torch.matmul(
                    x.to(wdt), dequantize_km(next(cyw), wdt)), reps=5,
                    warmup=1)
        if v == "dma":
            dma_gbs = gbs
        nbytes = (wbytes + x.numel() * 2
                  + (2 * O * 4 if v == "dma" else 0) + batch * O * 4
                  + (xs.numel() * 2 if v == "pairC" else 0))
        row = dict(tool=tool, kernel=VARIANT_KERNEL[v], variant=v,
                   shape=f"{v} n={batch} {K}->{O}", n=batch, K=K, O=O,
                   layout=(dma_layout if v == "dma" else
                           "ps" if v in PS_VARIANTS else
                           "w32" if v == "w32" else "i"),
                   block_kh=block_kh if v == "dma" else None,
                   ms=ms, gbs=gbs,
                   vs_dma=(gbs / dma_gbs if gbs and dma_gbs else None),
                   max_abs_err=err, rel_err=rel, plain_ms=plain_ms,
                   yardstick_ms=lib_ms.get(wdt),
                   library_ms=None if v == "dma" else lib_ms.get(wdt),
                   nbytes=nbytes,
                   ops=0 if v == "dma" else 2 * batch * K * O,
                   peak=("tf32" if v in F32_MATHS else
                         "bf16" if bf16_planes else "f32"), device=card)
        rows.append(row)
        print(format_row(row), flush=True)
    return rows


def format_row(r: Dict) -> str:
    head = f"  {r['variant']:5s} n={r['n']} {r['K']}->{r['O']} "
    err = f"max|err| {r['max_abs_err']:.2e} (rel {r['rel_err']:.2e})"
    if r["ms"] is None:
        return head + f"ms not measured (on {r['device']})  {err}"
    ratio = "" if r["vs_dma"] is None else f"  {r['vs_dma']:.2f}x dma"
    return (head + f"{r['ms']:8.4f} ms {r['gbs']:7.1f} GB/s{ratio}  {err}  "
            f"yardstick {r['yardstick_ms']:.4f} ms")
