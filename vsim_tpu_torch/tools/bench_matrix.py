"""The benchmark's configurations, one after another (port of
tools/bench_matrix.py): one ``python -m vsim_tpu_torch.bench`` process per
configuration, its one JSON line kept, all of them written to
build/bench_matrix.json after each (the repo's BENCH_MATRIX.json is the
TPU's record).

    python -m vsim_tpu_torch.tools.bench_matrix [--out PATH]
        [--only NAME ...] [--device cpu]

The configurations are the JAX tool's: BLOOM-560m and GPT-2 at B=1,
CodeGen-2B at B=32, GPT-J-6B at B=64 with int4 and with int8 KV,
Pythia-12B at B=16 and GPT-NeoX-20B at B=8 (head dim 96: K3 with f32 q).
A configuration that fails, or runs past TIMEOUT_S, is recorded with its
exit code and the end of its stderr, and the matrix goes on.  ``--device`` is passed to each
process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TIMEOUT_S = 1800

CONFIGS = [
    {"name": "bloom-560m-b1", "args": ["--model", "bloom-560m", "--batch",
                                       "1", "--tokens", "64"]},
    {"name": "gpt2-b1", "args": ["--model", "gpt2", "--batch", "1",
                                 "--tokens", "64"]},
    {"name": "codegen-2b-b32", "args": ["--model", "codegen-2b", "--batch",
                                        "32", "--tokens", "64"]},
    {"name": "gpt-j-6b-b64", "args": ["--model", "gpt-j-6b", "--batch",
                                      "64", "--tokens", "64"]},
    {"name": "gpt-j-6b-b64-int8kv", "args": ["--model", "gpt-j-6b",
                                             "--batch", "64", "--kv",
                                             "int8", "--tokens", "64"]},
    {"name": "pythia-12b-b16", "args": ["--model", "pythia-12b", "--batch",
                                        "16", "--tokens", "64"]},
    {"name": "gpt-neox-20b-b8", "args": ["--model", "gpt-neox-20b",
                                         "--batch", "8", "--tokens", "32"]},
]


def commands(only: Optional[List[str]] = None,
             extra: List[str] = ()) -> List[tuple]:
    """(name, command) of each configuration to run."""
    return [(c["name"], [sys.executable, "-m", "vsim_tpu_torch.bench",
                         *c["args"], *extra])
            for c in CONFIGS if not only or c["name"] in only]


def run_one(cmd: List[str], timeout_s: float) -> Dict:
    """The configuration's JSON line, or what its failure left."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout_s, cwd=ROOT)
    except subprocess.TimeoutExpired as e:
        stderr = e.stderr or ""
        if isinstance(stderr, bytes):
            stderr = stderr.decode("utf-8", "replace")
        return {"error": f"timed out after {timeout_s} s",
                "stderr_tail": stderr[-2000:]}
    lines = [ln for ln in out.stdout.strip().splitlines()
             if ln.startswith("{")]
    if out.returncode != 0 or not lines:
        return {"error": f"the bench exited {out.returncode} with no JSON "
                         "line", "stderr_tail": out.stderr[-2000:]}
    return json.loads(lines[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "bench_matrix.json"))
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    extra = [] if args.device is None else ["--device", args.device]
    results = {}
    if args.only and os.path.exists(args.out):  # keep the other entries
        with open(args.out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failed = 0
    for name, cmd in commands(args.only, extra):
        print(f"== {name}: {' '.join(cmd[1:])}", flush=True)
        t0 = time.time()
        results[name] = run_one(cmd, TIMEOUT_S)
        results[name]["wall_s_total"] = round(time.time() - t0, 1)
        if "error" in results[name]:
            failed += 1
            print(f"   FAILED: {results[name]['error']}\n   stderr tail: "
                  f"...{results[name]['stderr_tail'][-500:]}", flush=True)
        else:
            print(f"   {json.dumps(results[name])}", flush=True)
        with open(args.out, "w") as f:  # after every configuration
            json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
