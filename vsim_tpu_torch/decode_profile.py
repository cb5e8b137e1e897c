"""Where a decode step's time goes, on the card.

    python -m vsim_tpu_torch.decode_profile [--eager] [--out build/decode_profile.json]

Builds an InferenceEngine for GPT-J-6B at full width (random Q4 weights,
seed 0, bf16 compute, int8 KV), prefills 300 tokens, then measures the
engine's single-token decode step at B=1, replayed from its CUDA graph
(``--eager``: the same step run op by op):
  * wall ms per step (host clock around a step that ends in a synchronize)
    and the host's enqueue ms (the same step without the synchronize; a
    replay's is ``replay()``);
  * from a torch.profiler trace over 10 steps: device busy ms per
    step (the union of kernel, memcpy and memset intervals), the idle share
    1 - busy / (the unprofiled wall), and device time by kernel name.
Prints one JSON line and writes it to ``--out``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in µs."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/decode_profile.json")
    ap.add_argument("--eager", action="store_true",
                    help="run the step op by op, not from its graph")
    args = ap.parse_args(argv)
    kv, n_past, steps = "int8", 300, 10

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params

    if not torch.cuda.is_available():
        raise SystemExit("decode_profile: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    cfg = PRESETS["gpt-j-6b"].replace(compute_dtype="bfloat16")
    eng = InferenceEngine(cfg, random_q4_params(cfg, seed=0), kv_dtype=kv)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.n_vocab, (n_past,), generator=g).tolist()
    logits = eng.prefill(ids)
    _, _, graphed = eng.start(ids, logits[:, -1], SamplingParams(greedy=True))
    step = graphed.fn if args.eager else graphed

    for _ in range(3):  # warm up
        step()
    enq, wall = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append(t1 - t0)
        wall.append(time.perf_counter() - t0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    intervals, by_name = [], collections.Counter()
    counts = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            s, e = ev.time_range.start, ev.time_range.end
            intervals.append((s, e))
            by_name[ev.name[:80]] += (e - s) / 1e3
            counts[ev.name[:80]] += 1
    busy_ms = busy_us(intervals) / 1e3 / steps if intervals else None
    wall_ms = sorted(wall)[len(wall) // 2] * 1e3
    out = dict(
        card=card, kv=kv, n_past=n_past, mode="eager" if args.eager else "graphed",
        steps=steps,
        wall_ms_per_step_median=wall_ms,
        enqueue_ms_per_step_median=sorted(enq)[len(enq) // 2] * 1e3,
        profiled_wall_ms_per_step=prof_wall * 1e3 / steps,
        device_busy_ms_per_step=busy_ms,
        # against the unprofiled wall time: the profiler slows the host
        device_idle_share=(None if busy_ms is None
                           else 1 - busy_ms / wall_ms),
        device_ms_per_step_by_kernel={
            k: v / steps for k, v in by_name.most_common(20)},
        launches_per_step_by_kernel={
            k: counts[k] / steps for k, _ in by_name.most_common(20)},
        device_events_per_step=len(intervals) / steps,
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
