"""K7/K8's "mma_bf16" instance under candidate geometries, beside the one
``csrc/flash_attention_bwd.cu:bf_plan`` takes.

    python -m vsim_tpu_torch.tools.bwd_plans [--out FILE]

A plan is compiled into the kernel (``BfPlan``: resident row tiles, warps
splitting the gradient columns, streamed rows a tile, the blocks an SM the
register budget is set for), so each round of candidates is a copy of
``csrc/`` whose ``bf_plan`` returns the round's candidate for every (head
dim, pass) that has one and ``bf_plan``'s own plan otherwise, built with
``nvcc`` into ``build/kernels/bwd_plans/``, all rounds at once.  Each build's
``ptxas -v`` registers and spills are printed for every bf16 instance; then,
at the shapes of ``SHAPES``, each round's K7 and K8 are held to the plain
backward (every element within 2^-8 of max|plain|, at most 2% of the bf16
elements differing) and timed (``timing.timed``, best of two).  Runs on the
CUDA card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess

import torch

from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.attention import (_BWD_DKV_ARGS, _BWD_DQ_ARGS,
                                          _INSTANCES, flash_attention_bwd_plain,
                                          flash_attention_fwd)
from vsim_tpu_torch.timing import timed

# (pass, padded head dim) -> candidate (rt, cs, tile, min_blocks), one a
# round (round 0: bf_plan's own); a round past a key's list builds
# bf_plan's own plan there
CANDIDATES = {
    ("dq", 64): [(4, 1, 64, 3), (4, 1, 64, 2), (4, 1, 32, 4), (4, 1, 32, 3)],
    ("dq", 80): [(4, 1, 32, 3), (4, 1, 32, 4), (4, 1, 64, 2)],
    ("dq", 96): [(4, 1, 32, 3), (4, 1, 32, 4), (4, 1, 64, 2)],
    ("dq", 128): [(4, 1, 64, 2), (4, 1, 32, 2), (4, 1, 32, 3)],
    ("dq", 256): [(4, 1, 16, 1), (4, 1, 32, 1)],
    ("dkv", 64): [(4, 2, 64, 2), (4, 1, 64, 2), (4, 2, 64, 1), (4, 2, 32, 2)],
    ("dkv", 80): [(4, 1, 32, 2), (4, 1, 16, 3), (4, 1, 32, 1)],
    ("dkv", 96): [(4, 2, 64, 1), (4, 2, 32, 1), (4, 2, 32, 2), (4, 1, 16, 2)],
    ("dkv", 128): [(4, 2, 64, 1), (4, 2, 32, 1), (4, 2, 32, 2),
                   (4, 4, 64, 1)],
    ("dkv", 256): [(2, 4, 64, 1), (4, 2, 32, 1), (2, 2, 32, 1)],
}
# (B, H, T, D): phase 6's and phase 2's bf16 shapes
SHAPES = ((1, 16, 2048, 64), (4, 16, 2048, 64), (1, 32, 2048, 80),
          (1, 16, 2048, 96), (1, 40, 2048, 128), (1, 16, 2048, 256),
          (1, 16, 512, 256))
_DPADS = (64, 80, 96, 128, 256)


def _dpad(D: int) -> int:  # noqa: N803
    return next(p for p in _DPADS if D <= p)


def _round_source(src: str, rnd: int) -> str:
    """flash_attention_bwd.cu with bf_plan returning round ``rnd``'s
    candidates."""
    src = src.replace("constexpr BfPlan bf_plan(int dpad, bool dkv) {",
                      "constexpr BfPlan bf_plan_default(int dpad, bool dkv) {")
    cases = "".join(
        f"  if (dpad == {d} && dkv == {str(k == 'dkv').lower()}) "
        f"return BfPlan{{{', '.join(map(str, c[rnd]))}}};\n"
        for (k, d), c in CANDIDATES.items() if rnd < len(c))
    fn = ("__host__ __device__ constexpr BfPlan bf_plan(int dpad, bool dkv) "
          "{\n" + cases + "  return bf_plan_default(dpad, dkv);\n}\n")
    at = src.index("__host__ __device__ constexpr int bf_threads(")
    return src[:at] + fn + src[at:]


def _plan_of(rnd: int, kind: str, dpad: int):
    c = CANDIDATES[(kind, dpad)]
    return c[rnd] if rnd < len(c) else "bf_plan"


def build_rounds():
    """One library a round, built in parallel: [(path, ptxas report)]."""
    rounds = max(len(c) for c in CANDIDATES.values())
    root = _build.BUILD_DIR / "bwd_plans"
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for rnd in range(rounds):
        d = root / f"r{rnd}"
        shutil.copytree(_build.CSRC, d / "csrc")
        cu = d / "csrc" / "flash_attention_bwd.cu"
        cu.write_text(_round_source(cu.read_text(), rnd))
        lib = d / "libflash_attention_bwd.so"
        procs.append((lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = []
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log}")
        out.append((lib, log))
    return out


def ptxas_lines(log: str):
    """{(pass, dpad): (registers, spill store bytes)} of the bf16 kernels."""
    res, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"flash_bwd_(dq|dkv)_bf16_kernelILi(\d+)E", line)
        if m and "Compiling entry" in line:
            cur = (m.group(1), int(m.group(2)))
        elif cur and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            res[cur] = [None, spill]
        elif cur and "Used" in line and "registers" in line:
            res[cur][0] = int(re.search(r"Used (\d+) registers", line).group(1))
            cur = None
    return res


def _launch(lib, kind, args):
    fn = getattr(lib, f"flash_attention_bwd_{kind}_launch")
    fn.argtypes = list(_BWD_DQ_ARGS if kind == "dq" else _BWD_DKV_ARGS)
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err:
        raise RuntimeError(f"{kind}: CUDA error {err}")


def run(shapes=SHAPES):
    builds = build_rounds()
    libs = [ctypes.CDLL(str(lib)) for lib, _ in builds]
    regs = [ptxas_lines(log) for _, log in builds]
    for rnd, r in enumerate(regs):
        print(f"round {rnd}: " + ", ".join(
            f"{k}<{d}> {_plan_of(rnd, k, d)} {v[0]} regs, {v[1]} B spilled"
            for (k, d), v in sorted(r.items())), flush=True)
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    p = _build.ptr
    for B, H, T, D in shapes:  # noqa: N806
        sc = 1.0 / math.sqrt(D)
        q, k, v, do = (torch.randn((B, H, T, D), generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v, scale=sc)
        dsum = (do.float() * out.float()).sum(-1)
        ref = flash_attention_bwd_plain(q, k, v, out, lse, do, scale=sc)
        head = (p(q), p(k), p(v), p(do), p(lse), p(dsum))
        tail = (p(None), 1, _INSTANCES["mma_bf16"], B, H, T, T, D, 0, sc,
                _build.stream_ptr(q.device))
        for rnd, lib in enumerate(libs):
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            calls = {"dq": lambda: _launch(lib, "dq", head + (p(dq),) + tail),
                     "dkv": lambda: _launch(lib, "dkv",
                                            head + (p(dk), p(dv)) + tail)}
            for fn in calls.values():
                fn()
            torch.cuda.synchronize()
            worst = max(((a.float() - b.float()).abs().max()
                         / b.float().abs().max()).item()
                        for a, b in zip((dq, dk, dv), ref))
            share = sum((a != b).sum().item() for a, b in
                        zip((dq, dk, dv), ref)) / sum(b.numel() for b in ref)
            if worst > 2.0 ** -8 or share > 0.02:
                raise RuntimeError(f"round {rnd} at {(B, H, T, D)}: "
                                   f"{worst:.3g} of max|plain|, {share:.3g} "
                                   "of the elements differ")
            for kind, fn in calls.items():
                ms = min(timed(fn), timed(fn))
                plan = _plan_of(rnd, kind, _dpad(D))
                rows.append(dict(shape=[B, H, T, D], kind=kind, round=rnd,
                                 plan=plan, ms=ms,
                                 regs=regs[rnd].get((kind, _dpad(D)))))
                print(f"B={B} H={H} T={T} D={D} {kind} round {rnd} {plan}: "
                      f"{ms:.4f} ms {regs[rnd].get((kind, _dpad(D)))}",
                      flush=True)
        del q, k, v, do, out, lse, dsum, ref
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_plans: needs a CUDA device")
    rows = run()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
