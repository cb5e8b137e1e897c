"""Opcode counts in the SASS of the port's kernels.

    python -m vsim_tpu_torch.tools.sass_ops [--csrc DIR] [NAME ...]

Compiles each ``NAME.cu`` of ``DIR`` (default: the package's ``csrc/``;
names default to the sources of K1, K11 and K9/K10) with the port's nvcc flags into
``build/sass/``, disassembles it with ``cuobjdump -sass`` and prints, for
every kernel function, how many instructions of each opcode in ``OPS`` it
holds: I2F and I2FP (integer-to-float conversions) show whether nibbles are
converted one by one, HMMA whether the tensor cores run; and where the
conversions sit beside the first and last HMMA.  ``--csrc`` takes
another checkout's sources, to compare a design with its parent's.  Needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit); runs no kernel.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from vsim_tpu_torch.ops import _build

OPS = ("I2F", "I2FP", "F2I", "HMMA", "PRMT", "LOP3", "SHF", "HFMA2", "FFMA",
       "LDG", "LDS", "STG", "ATOM", "RED")
OUT = _build.BUILD_DIR.parent / "sass"


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(_build._nvcc()).with_name("cuobjdump"))


def count(source: Path) -> Dict[str, Dict]:
    """``count_lib`` of one ``.cu`` source, compiled with the port's flags
    into ``build/sass/``."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{source.stem}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(source)], check=True, capture_output=True, text=True)
    return count_lib(lib)


def count_lib(lib: Path) -> Dict[str, Dict]:
    """{kernel function: {"ops": {opcode: count}, "convert_at": offsets of
    its I2F, I2FP and F2I, "hmma": (first, last) HMMA offset or None}} of
    a built library."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out: Dict[str, Dict] = {}
    fn = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = out[head.group(1)] = dict(ops=collections.Counter(),
                                           convert_at=[], hmma=None)
        elif fn is not None:
            m = re.match(
                r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
            if not m:
                continue
            at, op = int(m.group(1), 16), m.group(2)
            if op in OPS:
                fn["ops"][op] += 1
            if op in ("I2F", "I2FP", "F2I"):
                fn["convert_at"].append(at)
            if op == "HMMA":
                fn["hmma"] = (fn["hmma"] or (at, at))[0], at
    for fn in out.values():
        fn["ops"] = {op: fn["ops"].get(op, 0) for op in OPS}
    return out


def convert_in_mma_span(fn: Dict) -> int:
    """How many of a function's conversions sit between its first and last
    HMMA (a loop that runs the tensor cores converts nothing when 0)."""
    if fn["hmma"] is None:
        return 0
    lo, hi = fn["hmma"]
    return sum(lo <= at <= hi for at in fn["convert_at"])


def main(argv=None) -> Dict[str, Dict[str, Dict]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("names", nargs="*",
                    default=["q4_gemv_ps", "q4_mlp_ps", "q4_matmul_i"])
    args = ap.parse_args(argv)
    result = {}
    for name in args.names:
        result[name] = count(args.csrc / f"{name}.cu")
        for fn, got in result[name].items():
            where = ", ".join(f"{a:#x}" for a in got["convert_at"][:4])
            if len(got["convert_at"]) > 4:
                where += ", ..."
            span = ("" if got["hmma"] is None else
                    f"; HMMA {got['hmma'][0]:#x}-{got['hmma'][1]:#x}")
            print(f"{name} {fn[:72]}: " + ", ".join(
                f"{op} {n}" for op, n in got["ops"].items() if n)
                + (f"; conversions at {where}" if where else "") + span,
                flush=True)
    return result


if __name__ == "__main__":
    main()
