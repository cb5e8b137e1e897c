"""K1's n <= 8 instance against another checkout's build of it, bit for bit.

    python -m vsim_tpu_torch.tools.k1_compare --other DIR
        [--out build/k1_compare.json]

DIR is the root of another checkout of the repository, for example an
earlier commit unpacked with ``git archive <commit> | tar -x -C DIR``.  Its
``vsim_tpu_torch/csrc/q4_gemv_ps.cu`` (with the headers beside it in that
checkout) is compiled with this tree's ``nvcc`` flags into
``build/k1_compare/``; this tree's library is the one ``ops/_build`` builds.
Both libraries' ``q4_gemv_ps_launch`` (the n <= 8 instance's C entry point,
whose signature has not changed since K1's first port) then run on the same
inputs under the same plan, this tree's ``core_plan`` (wc, cluster), at
seven weights (1024x1024, GPT-J-6B's qkv, fc and proj, Pythia-12B's three)
x n = 1..8, each with and without a bias: 112 cases, inputs from seed 0.
Every output is compared as raw 32-bit words.  Prints a line a weight and
one JSON summary, writes the cases to ``--out``, and exits 1 if any word
differs.  Needs the card: both sides are kernels, and no plain version
stands in for either.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from typing import Dict, List, Sequence, Tuple

import torch

from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.q4_cuda import _GEMV_ARGS, _plan

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join("vsim_tpu_torch", "csrc", "q4_gemv_ps.cu")
# (O, K) of each weight: a small square, then GPT-J-6B's qkv, fc and proj
# and Pythia-12B's
SHAPES = ((1024, 1024), (12288, 4096), (16384, 4096), (4096, 16384),
          (15360, 5120), (20480, 5120), (5120, 20480))
NS = tuple(range(1, 9))


def build_other(other: str, out_dir: str) -> ctypes.CDLL:
    """The other checkout's K1 library, compiled into ``out_dir``."""
    src = os.path.join(other, SOURCE)
    if not os.path.isfile(src):
        raise FileNotFoundError(f"{src} not found: --other must be the root "
                                "of a checkout of the repository")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libq4_gemv_ps_other.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(lib)


def launcher(lib: ctypes.CDLL):
    fn = lib.q4_gemv_ps_launch
    fn.argtypes, fn.restype = list(_GEMV_ARGS), ctypes.c_int
    lib.vsim_cuda_error_string.restype = ctypes.c_char_p
    lib.vsim_cuda_error_string.argtypes = [ctypes.c_int]
    return fn


def inputs(n: int, K: int, O: int, dev: torch.device,  # noqa: N803
           gen: torch.Generator) -> Tuple[torch.Tensor, ...]:
    """x [n, K] bf16, packed [K/2, O] uint8, scales [K/32, O] bf16, bias
    [O] f32, drawn on the host from ``gen``."""
    x = torch.randn((n, K), generator=gen).to(torch.bfloat16)
    packed = torch.randint(0, 256, (K // 2, O), generator=gen,
                           dtype=torch.uint8)
    scales = (0.02 * torch.randn((K // 32, O), generator=gen)
              ).to(torch.bfloat16)
    bias = torch.randn((O,), generator=gen)
    return tuple(t.to(dev) for t in (x, packed, scales, bias))


def run_case(fn, lib, x, packed, scales, bias, plan) -> torch.Tensor:
    n, K = x.shape  # noqa: N806
    O = packed.shape[1]  # noqa: N806
    out = torch.full((n, O), float("nan"), dtype=torch.float32,
                     device=x.device)
    err = fn(_build.ptr(x), _build.ptr(packed), _build.ptr(scales),
             _build.ptr(bias), _build.ptr(out), n, K, O, plan[0], plan[1],
             _build.stream_ptr(x.device))
    _build.check(lib, err, "q4_gemv_ps_launch")
    torch.cuda.synchronize(x.device)
    return out


def compare(other: str, shapes: Sequence[Tuple[int, int]] = SHAPES,
            ns: Sequence[int] = NS,
            build_dir: str = os.path.join(ROOT, "build", "k1_compare")
            ) -> List[Dict]:
    """One row a case: the weight, n, bias or not, the plan, and the count
    of 32-bit words that differ between this tree's K1 and ``other``'s."""
    if not torch.cuda.is_available():
        raise RuntimeError("k1_compare needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    mine_lib = _build.load("q4_gemv_ps")
    other_lib = build_other(other, build_dir)
    mine, theirs = launcher(mine_lib), launcher(other_lib)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for O, K in shapes:  # noqa: N806
        plan = _plan("q4_gemv_ps", dev.index, K, O)
        for n in ns:
            x, packed, scales, bias = inputs(n, K, O, dev, gen)
            for b in (None, bias):
                a = run_case(mine, mine_lib, x, packed, scales, b, plan)
                o = run_case(theirs, other_lib, x, packed, scales, b, plan)
                diff = int((a.view(torch.int32) != o.view(torch.int32))
                           .sum())
                rows.append(dict(shape=[O, K], n=n, bias=b is not None,
                                 plan=list(plan), words=a.numel(),
                                 differ=diff,
                                 finite=bool(torch.isfinite(a).all())))
        del x, packed, scales, bias
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "k1_compare.json"))
    args = ap.parse_args(argv)
    rows = compare(args.other)
    for O, K in SHAPES:  # noqa: N806
        mine = [r for r in rows if r["shape"] == [O, K]]
        print(f"{O}x{K}: plan {mine[0]['plan']}, {len(mine)} cases, "
              f"{sum(r['differ'] for r in mine)} words differ", flush=True)
    same = all(r["differ"] == 0 and r["finite"] for r in rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps({"cases": len(rows), "bit_identical": same,
                      "words": sum(r["words"] for r in rows),
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
