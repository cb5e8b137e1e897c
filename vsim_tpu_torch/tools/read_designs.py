"""How fast the card reads a Q4 weight, and K13 against that.

    python -m vsim_tpu_torch.tools.read_designs

At every Q4 weight shape of GPT-J-6B and Pythia-12B, at n = 1, on random
weights rotated past the 50 MB L2 (``timing.rotation``), each design's
device time from ``timing.timed``, best of two rounds:

  flat        csrc/read_designs.cu ``read_flat``: every byte of the packed
              weight and the scales in one grid-stride loop, summed without
              columns: the fastest read of those bytes measured here
  k13 i, ps   K13 ``q4_lab_dma`` in the "i" and "ps" layouts (block_kh 512
              and 256): the touch output and the per-column checksum
  span 512 B, 2 KB, 4 KB, 8 KB
              ``read_spans``: K13's checksum with 512 threads a block, two
              blocks an SM, a block reading that many contiguous bytes of a
              row at a time: the designs K13 was chosen from
  gi, giw, cur
              K2 (bf16 planes) and K1 on the "ps" repack, K9 on the "i"
              layout: the GEMVs the main path runs

Each design is first checked: flat's totals and the checksums exactly
against PyTorch's sums of the same bytes, K13 against its plain version,
K1, K2 and K9 within ``TOL_LAB`` of theirs; a miss raises.  Prints one
line a shape (µs, GB/s of the weight's bytes, share of flat's rate) and
returns the rows.  Runs on the CUDA card only.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
from typing import Dict, List, Tuple

import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.q4_cuda import (q4_gemv_ps, q4_gemv_ps_plain,
                                        q4_matmul_i, q4_matmul_i_plain,
                                        q4_matmul_ps, q4_matmul_ps_plain)
from vsim_tpu_torch.ops.q4_lab import TOL_LAB, q4_lab_dma, q4_lab_dma_plain
from vsim_tpu_torch.quant.q4 import to_plane_split
from vsim_tpu_torch.timing import rel_err, rotation, timed
from vsim_tpu_torch.tools.lab import lab_weight

# (model, weight, K, O): the lm heads' vocabularies padded to 51200
SHAPES = (("gpt-j-6b", "qkv", 4096, 12288), ("gpt-j-6b", "wo", 4096, 4096),
          ("gpt-j-6b", "fc", 4096, 16384), ("gpt-j-6b", "proj", 16384, 4096),
          ("gpt-j-6b", "lm_head", 4096, 51200),
          ("pythia-12b", "qkv", 5120, 15360), ("pythia-12b", "wo", 5120, 5120),
          ("pythia-12b", "fc", 5120, 20480),
          ("pythia-12b", "proj", 20480, 5120),
          ("pythia-12b", "lm_head", 5120, 51200))
SPANS = (512, 2048, 4096, 8192)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _launch(symbol: str, argtypes, *args) -> None:
    lib = _build.load("read_designs")
    _build.check(lib, _build.function("read_designs", symbol, argtypes)(*args),
                 symbol)


def read_flat(packed: torch.Tensor, scales: torch.Tensor,
              totals: torch.Tensor) -> None:
    """totals [2] int64 ← (Σ packed bytes, Σ scale bit patterns)."""
    sm = torch.cuda.get_device_properties(packed.device).multi_processor_count
    _launch("read_flat_launch", [_P, _L, _P, _L, _P, _I, _P],
            _build.ptr(packed), packed.numel(), _build.ptr(scales),
            2 * scales.numel(), _build.ptr(totals), 4 * sm,
            _build.stream_ptr(packed.device))


def read_spans(packed: torch.Tensor, scales: torch.Tensor,
               checksum: torch.Tensor, span_bytes: int) -> None:
    """checksum [2, O] int32 ← K13's checksum, read ``span_bytes`` a row."""
    KH, O = packed.shape  # noqa: N806
    sm = torch.cuda.get_device_properties(packed.device).multi_processor_count
    _launch("read_spans_launch", [_P, _P, _P, _I, _I, _I, _I, _P],
            _build.ptr(packed), _build.ptr(scales), _build.ptr(checksum),
            2 * KH, O, span_bytes, 2 * sm, _build.stream_ptr(packed.device))


def _totals(packed, scales):
    return torch.stack([packed.sum(dtype=torch.int64),
                        (scales.view(torch.int16).to(torch.int64)
                         & 0xFFFF).sum()])


def run_shape(K: int, O: int,  # noqa: N803
              device: DeviceLike = None) -> Tuple[Dict[str, float], int]:
    """({design: device ms}, the weight's bytes) at one shape, n = 1, after
    every check."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("read_designs times kernels on a CUDA card")
    w0 = lab_weight(K, O, 0, dev)
    ws = rotation(lambda i: w0 if i == 0 else lab_weight(K, O, i, dev),
                  w0.nbytes)
    wps = [to_plane_split(w) for w in ws]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn((1, K), generator=g, device=dev).to(torch.bfloat16)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    checksum = torch.empty((2, O), dtype=torch.int32, device=dev)
    ref_sum = q4_lab_dma_plain(x, w0.packed, w0.scales, "i", 512)[1]

    def exact(what, got, ref):
        if not torch.equal(got, ref):
            raise RuntimeError(f"read_designs {what} {K}->{O}: differs from "
                               "PyTorch's sums of the same bytes")

    designs = {"flat": (ws, lambda w: read_flat(w.packed, w.scales, totals)),
               "k13 i": (ws, lambda w: q4_lab_dma(x, w.packed, w.scales,
                                                  "i", 512)),
               "k13 ps": (wps, lambda w: q4_lab_dma(x, w.packed, w.scales,
                                                    "ps", 256))}
    for span in SPANS:
        designs[f"span {span}"] = (ws, lambda w, span=span: read_spans(
            w.packed, w.scales, checksum, span))
    designs.update(
        gi=(wps, lambda w: q4_matmul_ps(x, w.packed, w.scales, None, True)),
        giw=(wps, lambda w: q4_gemv_ps(x, w.packed, w.scales)),
        cur=(ws, lambda w: q4_matmul_i(x, w.packed, w.scales)))
    plains = {"gi": lambda w: q4_matmul_ps_plain(x, w.packed, w.scales, None,
                                                 True),
              "giw": lambda w: q4_gemv_ps_plain(x, w.packed, w.scales),
              "cur": lambda w: q4_matmul_i_plain(x, w.packed, w.scales)}
    for name, (wl, fn) in designs.items():
        got = fn(wl[0])
        if name == "flat":
            exact(name, totals, _totals(w0.packed, w0.scales))
        elif name.startswith("span"):
            exact(name, checksum, ref_sum)
        elif name.startswith("k13"):
            ref = q4_lab_dma_plain(x, wl[0].packed, wl[0].scales,
                                   name[4:], 512 if name == "k13 i" else 256)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise RuntimeError(f"read_designs {name} {K}->{O}: differs "
                                   "from its plain version")
        else:
            err, rel = rel_err(got, plains[name](wl[0]))
            if rel > TOL_LAB:
                raise RuntimeError(f"read_designs {name} {K}->{O}: max|err| "
                                   f"{err:.3g} (rel {rel:.3g} > {TOL_LAB})")
    best: Dict[str, float] = {}
    for _ in range(2):
        for name, (wl, fn) in designs.items():
            cyc = itertools.cycle(wl)
            ms = timed(lambda: fn(next(cyc)))
            best[name] = min(ms, best.get(name, ms))
    return best, w0.nbytes


def launch_floor_ms(device: DeviceLike = None) -> float:
    """An empty kernel's device ms a call (``empty_launch``: one warp that
    does nothing), best of two rounds of ``timing.timed``: the floor under
    any one-launch kernel's time."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("read_designs times kernels on a CUDA card")
    stream = _build.stream_ptr(dev)
    return min(timed(lambda: _launch("empty_launch", [_P], stream), reps=50)
               for _ in range(2))


def graph_launch_floor_ms(device: DeviceLike = None, n: int = 100) -> float:
    """An empty kernel's device ms a launch inside a CUDA graph: ``n``
    ``empty_launch`` calls captured in one graph, the graph replayed under
    ``timing.timed``, best of two rounds, over ``n``: the floor under a
    one-launch kernel of a replayed decode step."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("read_designs times kernels on a CUDA card")
    _launch("empty_launch", [_P], _build.stream_ptr(dev))  # load, outside
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = _build.stream_ptr(dev)  # the capturing stream
        for _ in range(n):
            _launch("empty_launch", [_P], stream)
    return min(timed(graph.replay, reps=20) for _ in range(2)) / n


def flat_ms(K: int, O: int, device: DeviceLike = None) -> float:  # noqa: N803
    """``read_flat``'s device ms for a [K/2, O] Q4 weight and its scales at
    n = 1, rotated past the L2, best of two rounds, its totals checked:
    the bar chip_smoke.py holds K1 and K11 against."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("read_designs times kernels on a CUDA card")
    w0 = lab_weight(K, O, 0, dev)
    ws = rotation(lambda i: w0 if i == 0 else lab_weight(K, O, i, dev),
                  w0.nbytes)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    read_flat(w0.packed, w0.scales, totals)
    if not torch.equal(totals, _totals(w0.packed, w0.scales)):
        raise RuntimeError(f"read_designs flat {K}->{O}: differs from "
                           "PyTorch's sums of the same bytes")
    cyc = itertools.cycle(ws)
    return min(timed(lambda: (lambda w: read_flat(w.packed, w.scales,
                                                  totals))(next(cyc)))
               for _ in range(2))


def run(device: DeviceLike = None) -> List[Dict]:
    """Every shape of ``SHAPES``, one printed line each."""
    dev = resolve_device(device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"read_designs: device={card}, n = 1, best of two rounds",
          flush=True)
    rows = []
    for model, name, K, O in SHAPES:  # noqa: N806
        ms, nbytes = run_shape(K, O, dev)
        mb = nbytes / 1e6
        flat = ms["flat"]
        print(f"  {model} {name} {K}->{O} ({mb:.1f} MB): " + "; ".join(
            f"{d} {t * 1e3:.2f} us {mb / t:.0f} GB/s ({flat / t:.2f})"
            for d, t in ms.items()), flush=True)
        rows += [dict(model=model, weight=name, K=K, O=O, design=d, ms=t,
                      gbs=mb / t, vs_flat=flat / t, device=card)
                 for d, t in ms.items()]
    return rows


def main(argv=None) -> List[Dict]:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    return run()


if __name__ == "__main__":
    main()
