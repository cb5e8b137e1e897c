"""K7/K8's and K4's tensor-core instances under candidate geometries, beside
the ones the sources take: K7/K8's "mma_bf16" (``bf_plan`` in
``csrc/flash_attention_bwd.cu``), with ``--f32`` their zero-padded
"mma_3xtf32" instances (``tf_plan``, f32 at head dims other than 64 and
128), with ``--fwd`` K4's f32 instance ("mma_3xtf32", ``fwd_plan`` in
``csrc/flash_attention.cu``).

    python -m vsim_tpu_torch.tools.bwd_plans [--f32 | --fwd] [--out FILE]

A plan is compiled into the kernel (``BfPlan`` / ``TfPlan``: resident row
tiles, warps a row tile splitting the streamed rows -- with ``TfPlan``'s
``ks``, the head dim -- and the gradient columns, streamed rows a tile, the
blocks an SM the register budget is set for; ``FwdPlan``: 16-query row
tiles, warps a row tile splitting the head dim, keys a tile, ring stages,
blocks an SM, for T > 32 and for short prompts), so
each round of candidates is a copy of ``csrc/`` whose plan function returns
the round's candidate for every (pass, padded head dim) that has one and
the source's own plan otherwise, built with ``nvcc`` into
``build/kernels/bwd_plans/``, all rounds at once.  Each build's ``ptxas
-v`` registers and spills are printed for every instance of the mode; then,
at the mode's shapes, each round's kernels are held to their plain version
(bf16: every element within 2^-8 of max|plain|, at most 2% of the bf16
elements differing; f32: each of dq, dk, dv -- K4: out and lse -- within
1e-4 of its max|plain|; a round that fails is reported and not timed) and
timed (``timing.timed``, best of two; K4 beside scaled_dot_product_attention
on the same inputs).  Runs on the CUDA card only.
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
from vsim_tpu_torch.ops.attention import (_ARGS, _BWD_DKV_ARGS, _BWD_DQ_ARGS,
                                          _INSTANCES, flash_attention_bwd_plain,
                                          flash_attention_fwd,
                                          flash_attention_plain)
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
# the padded "mma_3xtf32" instances (tf_plan), as CANDIDATES with a fifth
# field, ks (1: the cs warps of a row tile split the head dim for s and dp
# instead of the streamed rows) (round 0: tf_plan's own)
CANDIDATES_F32 = {
    ("dq", 80): [(4, 1, 32, 2, 0), (4, 1, 16, 3, 0), (4, 2, 32, 2, 0),
                 (4, 2, 32, 2, 1)],
    ("dq", 96): [(4, 2, 32, 2, 0), (4, 1, 32, 2, 0), (4, 1, 16, 2, 0),
                 (4, 2, 32, 2, 1)],
    ("dq", 256): [(2, 4, 32, 1, 1), (2, 4, 32, 1, 0), (4, 2, 16, 1, 0),
                  (4, 2, 16, 1, 1)],
    ("dkv", 80): [(4, 2, 32, 2, 0), (4, 1, 32, 2, 0), (4, 1, 16, 3, 0),
                  (4, 2, 32, 2, 1)],
    ("dkv", 96): [(4, 1, 16, 2, 0), (4, 1, 32, 2, 0), (4, 2, 32, 1, 0),
                  (4, 2, 16, 2, 1)],
    ("dkv", 256): [(2, 4, 32, 1, 1), (2, 4, 32, 1, 0), (4, 2, 16, 1, 0),
                   (2, 2, 32, 1, 0)],
}
# (B, H, T, D): phase 6's and phase 2's f32 shapes at D other than 64, 128
SHAPES_F32 = ((1, 16, 2048, 256), (1, 16, 512, 256), (1, 32, 2048, 80),
              (1, 64, 2048, 96))
# K4's f32 instance (fwd_plan): ("fwd", padded head dim) -> candidate (rt,
# cs, tile, stages, min_blocks): rt row tiles of 16 queries, cs warps a row
# tile splitting the head dim, keys a tile, 1 or 2 ring stages, the blocks
# an SM of __launch_bounds__; ("few", padded head dim) the same for T <=
# FEW_ROWS (round 0: fwd_plan's own)
CANDIDATES_FWD = {
    ("fwd", 64): [(4, 1, 32, 1, 4), (4, 1, 32, 2, 4), (4, 1, 32, 2, 3),
                  (8, 1, 32, 2, 2), (4, 1, 64, 2, 2), (4, 1, 16, 2, 4)],
    ("fwd", 80): [(4, 1, 32, 1, 3), (4, 1, 32, 2, 3), (4, 1, 32, 1, 4),
                  (8, 1, 32, 2, 2), (4, 1, 64, 2, 2), (4, 2, 32, 2, 2)],
    ("fwd", 96): [(4, 1, 32, 2, 3), (4, 1, 32, 1, 3), (4, 1, 32, 1, 4),
                  (8, 1, 32, 2, 2), (4, 1, 64, 2, 2), (4, 2, 32, 2, 2)],
    ("fwd", 128): [(4, 2, 64, 2, 1), (4, 1, 32, 2, 2), (4, 1, 32, 1, 3),
                   (4, 2, 32, 1, 2), (8, 1, 32, 2, 1), (4, 1, 64, 1, 2)],
    ("fwd", 256): [(4, 2, 32, 2, 1), (4, 2, 32, 1, 1), (4, 4, 32, 1, 1),
                   (2, 4, 32, 2, 1), (4, 2, 16, 2, 1), (4, 4, 16, 2, 1)],
    ("few", 64): [(1, 4, 32, 1, 2), (2, 2, 32, 1, 2), (1, 4, 16, 1, 2),
                  (1, 2, 16, 1, 2), (1, 8, 16, 1, 1), (2, 4, 16, 1, 1)],
    ("few", 80): [(1, 5, 32, 1, 1), (2, 2, 32, 1, 2), (1, 2, 16, 1, 2),
                  (1, 5, 16, 1, 1), (1, 2, 32, 1, 2), (2, 2, 16, 1, 2)],
    ("few", 96): [(1, 4, 32, 1, 2), (2, 2, 32, 1, 2), (1, 4, 16, 1, 2),
                  (1, 3, 16, 1, 2), (1, 6, 16, 1, 1), (2, 2, 16, 1, 2)],
    ("few", 128): [(1, 4, 16, 1, 2), (4, 2, 32, 1, 2), (1, 8, 16, 1, 1),
                   (2, 2, 16, 1, 2), (1, 2, 32, 1, 2), (2, 4, 32, 1, 1)],
    ("few", 256): [(1, 8, 16, 1, 1), (1, 4, 16, 1, 1), (1, 2, 16, 1, 2),
                   (1, 4, 32, 1, 1), (2, 4, 16, 1, 1), (1, 8, 32, 1, 1)],
}
FEW_ROWS = 32  # csrc/flash_attention.cu kFewRows
# (B, H, T, D): K4's f32 shapes on the main path -- Pythia-410M's training
# (B=4) and perplexity (B=1) at D=64, phase 2's T=512 and T=16 at D=256,
# GPT-J-6B's and CodeGen-2B's widths in training, GPT-NeoX-20B's D=96,
# Pythia-12B's width at T=2048 and at the chat CLI's f32 prefill of 100 and
# 20 tokens -- and a 20-token prompt at Pythia-410M's, CodeGen-2B's and
# GPT-NeoX-20B's heads (the short-prompt plans at D = 64, 80, 96)
SHAPES_FWD = ((4, 16, 2048, 64), (1, 16, 2048, 64), (1, 16, 512, 256),
              (1, 16, 16, 256), (1, 16, 2048, 256), (1, 32, 2048, 80),
              (1, 64, 2048, 96), (1, 40, 2048, 128), (1, 40, 100, 128),
              (1, 40, 20, 128), (1, 16, 20, 64), (1, 32, 20, 80),
              (1, 64, 20, 96))
_DPADS = (64, 80, 96, 128, 256)
# per mode: candidates, shapes, the source, the plan function and its type,
# its threads function, the dtype, the K7/K8 instance launched, and the
# plan function's bool argument with the candidate kind that sets it
MODES = {
    "bf16": dict(candidates=CANDIDATES, shapes=SHAPES, fn="bf_plan",
                 plan="BfPlan", dtype=torch.bfloat16, instance="mma_bf16",
                 source="flash_attention_bwd", threads="bf_threads",
                 flag="dkv", flag_on="dkv"),
    "f32": dict(candidates=CANDIDATES_F32, shapes=SHAPES_F32, fn="tf_plan",
                plan="TfPlan", dtype=torch.float32, instance="mma_3xtf32",
                source="flash_attention_bwd", threads="tf_threads",
                flag="dkv", flag_on="dkv"),
    "fwd": dict(candidates=CANDIDATES_FWD, shapes=SHAPES_FWD, fn="fwd_plan",
                plan="FwdPlan", dtype=torch.float32, instance="mma_3xtf32",
                source="flash_attention", threads="fwd_threads",
                flag="few", flag_on="few"),
}
TOL_F32 = 1e-4  # chip_smoke.py TOL_BWD_F32


def _dpad(D: int) -> int:  # noqa: N803
    return next(p for p in _DPADS if D <= p)


def _round_source(src: str, rnd: int, mode: str = "bf16") -> str:
    """flash_attention_bwd.cu with the mode's plan function returning round
    ``rnd``'s candidates."""
    m = MODES[mode]
    fn, plan, flag, on = m["fn"], m["plan"], m["flag"], m["flag_on"]
    head = f"constexpr {plan} {fn}(int dpad, bool {flag}) {{"
    src = src.replace(head, head.replace(f"{fn}(", f"{fn}_default("))
    cases = "".join(
        f"  if (dpad == {d} && {flag} == {str(k == on).lower()}) "
        f"return {plan}{{{', '.join(map(str, c[rnd]))}}};\n"
        for (k, d), c in m["candidates"].items() if rnd < len(c))
    body = (f"__host__ __device__ {head}\n" + cases
            + f"  return {fn}_default(dpad, {flag});\n}}\n")
    at = src.index(f"__host__ __device__ constexpr int {m['threads']}(")
    return src[:at] + body + src[at:]


def _plan_of(rnd: int, kind: str, dpad: int, mode: str = "bf16"):
    c = MODES[mode]["candidates"].get((kind, dpad), ())
    return c[rnd] if rnd < len(c) else MODES[mode]["fn"]


def build_rounds(mode: str = "bf16"):
    """One library a round, built in parallel: [(path, ptxas report)]."""
    rounds = max(len(c) for c in MODES[mode]["candidates"].values())
    source = MODES[mode]["source"]
    root = _build.BUILD_DIR / "bwd_plans"
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for rnd in range(rounds):
        d = root / f"r{rnd}"
        shutil.copytree(_build.CSRC, d / "csrc")
        cu = d / "csrc" / f"{source}.cu"
        cu.write_text(_round_source(cu.read_text(), rnd, mode))
        lib = d / f"lib{source}.so"
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


def _entry(line: str, mode: str):
    """(pass, dpad) of a ptxas "Compiling entry" line of the mode's
    kernels, else None."""
    if mode == "bf16":
        m = re.search(r"flash_bwd_(dq|dkv)_bf16_kernelILi(\d+)E", line)
        return m and (m.group(1), int(m.group(2)))
    if mode == "fwd":
        m = re.search(r"flash_fwd_3xtf32_kernelILi(\d+)ELb([01])E", line)
        return m and ("few" if m.group(2) == "1" else "fwd", int(m.group(1)))
    m = re.search(r"flash_bwd_(dq|dkv)_3xtf32_pad_kernelILi(\d+)E", line)
    return m and (m.group(1), int(m.group(2)))


def ptxas_lines(log: str, mode: str = "bf16"):
    """{(pass, dpad): (registers, spill store bytes)} of the mode's
    kernels."""
    res, cur = {}, None
    for line in log.splitlines():
        key = _entry(line, mode) if "Compiling entry" in line else None
        if key:
            cur = key
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


def _check(mode, rnd, shape, got, ref):
    """Raise unless a round's gradients hold the mode's checks; returns
    the worst distance relative to max|plain|."""
    rels = [((a.float() - b.float()).abs().max()
             / b.float().abs().max()).item() for a, b in zip(got, ref)]
    if mode == "f32":
        if not all(math.isfinite(r) and r <= TOL_F32 for r in rels):
            raise RuntimeError(f"round {rnd} at {shape}: {rels} of "
                               f"max|plain| (limit {TOL_F32})")
        return max(rels)
    share = sum((a != b).sum().item() for a, b in
                zip(got, ref)) / sum(b.numel() for b in ref)
    if max(rels) > 2.0 ** -8 or share > 0.02:
        raise RuntimeError(f"round {rnd} at {shape}: {max(rels):.3g} of "
                           f"max|plain|, {share:.3g} of the elements differ")
    return max(rels)


def run(mode: str = "bf16", shapes=None):
    m = MODES[mode]
    builds = build_rounds(mode)
    libs = [ctypes.CDLL(str(lib)) for lib, _ in builds]
    regs = [ptxas_lines(log, mode) for _, log in builds]
    for rnd, r in enumerate(regs):
        print(f"round {rnd}: " + ", ".join(
            f"{k}<{d}> {_plan_of(rnd, k, d, mode)} {v[0]} regs, {v[1]} B "
            "spilled" for (k, d), v in sorted(r.items())), flush=True)
    if mode == "fwd":
        return _run_fwd(libs, regs, shapes or m["shapes"])
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    p = _build.ptr
    dt = m["dtype"]
    for B, H, T, D in shapes or m["shapes"]:  # noqa: N806
        sc = 1.0 / math.sqrt(D)
        q, k, v, do = (torch.randn((B, H, T, D), generator=g, device="cuda")
                       .to(dt) for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v, scale=sc)
        dsum = (do.float() * out.float()).sum(-1)
        ref = flash_attention_bwd_plain(q, k, v, out, lse, do, scale=sc)
        head = (p(q), p(k), p(v), p(do), p(lse), p(dsum))
        tail = (p(None), int(dt == torch.bfloat16), _INSTANCES[m["instance"]],
                B, H, T, T, D, 0, sc, _build.stream_ptr(q.device))
        for rnd, lib in enumerate(libs):
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            calls = {"dq": lambda: _launch(lib, "dq", head + (p(dq),) + tail),
                     "dkv": lambda: _launch(lib, "dkv",
                                            head + (p(dk), p(dv)) + tail)}
            for fn in calls.values():
                fn()
            torch.cuda.synchronize()
            try:
                worst = _check(mode, rnd, (B, H, T, D), (dq, dk, dv), ref)
            except RuntimeError as exc:  # a wrong candidate is not timed
                print(f"B={B} H={H} T={T} D={D} round {rnd}: FAILED {exc}",
                      flush=True)
                rows.append(dict(mode=mode, shape=[B, H, T, D], round=rnd,
                                 failed=str(exc)))
                continue
            for kind, fn in calls.items():
                ms = min(timed(fn), timed(fn))
                plan = _plan_of(rnd, kind, _dpad(D), mode)
                reg = regs[rnd].get((kind, _dpad(D)))
                rows.append(dict(mode=mode, shape=[B, H, T, D], kind=kind,
                                 round=rnd, plan=plan, ms=ms, regs=reg,
                                 rel_err=worst))
                print(f"B={B} H={H} T={T} D={D} {kind} round {rnd} {plan}: "
                      f"{ms:.4f} ms {reg}, worst {worst:.3g}", flush=True)
        del q, k, v, do, out, lse, dsum, ref
        torch.cuda.empty_cache()
    return rows


def _run_fwd(libs, regs, shapes):
    """K4's f32 rounds at ``shapes``: out and lse within 1e-4 of their
    max|plain|, then each round timed beside SDPA on the same inputs."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    p = _build.ptr
    for B, H, T, D in shapes:  # noqa: N806
        sc = 1.0 / math.sqrt(D)
        q, k, v = (torch.randn((B, H, T, D), generator=g, device="cuda")
                   for _ in range(3))
        ref = flash_attention_plain(q, k, v, scale=sc)
        lib_ms = min(timed(lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               q, k, v, is_causal=True, scale=sc))
                     for _ in range(2))
        for rnd, lib in enumerate(libs):
            out = torch.empty_like(q)
            lse = torch.empty((B, H, T), device="cuda")
            fn = lib.flash_attention_launch
            fn.argtypes, fn.restype = list(_ARGS), ctypes.c_int

            def call(fn=fn, out=out, lse=lse):
                err = fn(p(q), p(k), p(v), p(out), p(lse), p(None), 0, B, H,
                         T, T, D, 0, sc, _build.stream_ptr(q.device))
                if err:
                    raise RuntimeError(f"fwd: CUDA error {err}")

            try:
                call()
                torch.cuda.synchronize()
                worst = _check("f32", rnd, (B, H, T, D), (out, lse), ref)
            except RuntimeError as exc:  # a refused or wrong candidate is
                # reported and not timed
                print(f"B={B} H={H} T={T} D={D} round {rnd}: FAILED {exc}",
                      flush=True)
                rows.append(dict(mode="fwd", shape=[B, H, T, D], round=rnd,
                                 failed=str(exc)))
                continue
            ms = min(timed(call), timed(call))
            kind = "few" if T <= FEW_ROWS else "fwd"
            plan = _plan_of(rnd, kind, _dpad(D), "fwd")
            reg = regs[rnd].get((kind, _dpad(D)))
            rows.append(dict(mode="fwd", shape=[B, H, T, D], kind=kind,
                             round=rnd, plan=plan, ms=ms, regs=reg,
                             rel_err=worst, library_ms=lib_ms))
            print(f"B={B} H={H} T={T} D={D} {kind} round {rnd} {plan}: "
                  f"{ms:.4f} ms ({ms / lib_ms:.2f}x SDPA {lib_ms:.4f}) "
                  f"{reg}, worst {worst:.3g}", flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--f32", action="store_true",
                      help="the padded mma_3xtf32 instances (tf_plan)")
    kind.add_argument("--fwd", action="store_true",
                      help="K4's f32 instance (fwd_plan)")
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_plans: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = run("f32" if args.f32 else "fwd" if args.fwd else "bf16")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
