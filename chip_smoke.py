#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vsim_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi) and build the
     kernels from csrc/ (one nvcc per source, all at once, into build/);
  2. kernels: each of K1-K4 at GPT-J-6B shapes against its plain PyTorch
     version on the card, its device time (torch.profiler) beside its bound
     and a PyTorch yardstick the port never calls;
  3. main path: InferenceEngine on GPT-J-6B at full width (28 layers,
     random Q4 weights from seed 0, bf16 compute) with int8 and with int4
     KV, serving prompts of 8, 100 and 300 tokens (64 new tokens, greedy)
     and one sampled request; every kernel's launch count must grow;
  4. card against CPU: GPT-J width at depth 2, f32 greedy streams must be
     identical, bf16 return_logits must agree within the stated tolerance.
Prints a JSON line {"kernels": [...]} and, last, the device line.  Details
go to build/chip_smoke.json.  Exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Tolerances, relative to max|plain| on the same inputs.
TOL_Q4 = 1e-4     # K1/K2: only the order of the f32 sums differs
TOL_DECODE = 1e-3  # K3: only the exp and sum order differ
TOL_FLASH_BF16 = 1e-2  # K4 bf16: the output is rounded to bf16
TOL_FLASH_F32 = 1e-4   # K4 f32: sum order only
# bf16 logits card vs CPU, relative to max|logit|: every activation rounds
# to bf16 (~4e-3 relative) and a rounding that flips between the two
# devices' sum orders propagates through the 2-layer stack.
TOL_LOGITS_BF16 = 5e-2

# Card peaks by name (NVIDIA data sheets, dense): bytes/s, bf16 FLOP/s,
# f32 (non-tensor) FLOP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100": (3.35e12, 989e12, 67e12),
         "H200": (4.8e12, 989e12, 67e12)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    fail(f"no peak table for card {name!r}")


def timed(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call of fn(): the summed durations of the kernels and
    copies fn() puts on the card, from a torch.profiler trace over ``reps``
    calls.  A wall clock around the calls would time the host's launches
    instead, which take longer than a small kernel runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # device activity only: with CPU ops traced too, an op's kernels count
    # twice in key_averages (once on the op, once on the kernel)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    if us <= 0:
        fail("torch.profiler recorded no device time")
    return us / 1e3 / reps


def rel_err(got, ref) -> tuple:
    d = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return d, d / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def _rotation(make, nbytes: int):
    """Enough copies of the inputs that a timed loop cycles through more
    than the 50 MB L2 (the decode step reads each weight cold)."""
    n = max(1, math.ceil(200e6 / max(nbytes, 1)))
    return [make(i) for i in range(min(n, 16))]


def phase_kernels(peaks):
    import torch

    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.ops.attention import (flash_attention_fwd,
                                              flash_attention_plain)
    from vsim_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                     decode_attention_q,
                                                     kv_int)
    from vsim_tpu_torch.ops.q4_cuda import (q4_gemv_ps, q4_gemv_ps_plain,
                                            q4_matmul_ps, q4_matmul_ps_plain)
    from vsim_tpu_torch.quant.q4 import Q4Tensor, dequantize_km

    bw, bf16_peak, f32_peak = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []

    def bound(nbytes, ops, peak):
        t_b, t_o = nbytes / bw * 1e3, ops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def q4_weight(K, O, seed):
        gg = torch.Generator(device=dev)
        gg.manual_seed(seed)
        packed = torch.randint(0, 256, (K // 2, O), generator=gg, device=dev,
                               dtype=torch.uint8)
        scales = (torch.rand((K // 32, O), generator=gg, device=dev)
                  * 0.01).to(torch.bfloat16)
        return Q4Tensor(packed, scales, "ps")

    # GPT-J-6B decode/prefill matmuls: (name, K, O, bias)
    shapes = [("qkv", 4096, 12288, False), ("wo", 4096, 4096, False),
              ("fc", 4096, 16384, True), ("proj", 16384, 4096, True),
              ("lm_head", 4096, 51200, True)]
    q4_cases = ([("q4_gemv_ps", n, torch.bfloat16) for n in (1, 8)]
                + [("q4_matmul_ps", n, dt) for n in (16, 128)
                   for dt in (torch.bfloat16, torch.float32)])
    kern = {"q4_gemv_ps": (q4_gemv_ps, q4_gemv_ps_plain),
            "q4_matmul_ps": (q4_matmul_ps, q4_matmul_ps_plain)}
    for kname, n, xdt in q4_cases:
        fn, plain = kern[kname]
        for sname, K, O, has_bias in shapes:
            w0 = q4_weight(K, O, K + O)
            wbytes = w0.nbytes
            ws = _rotation(lambda i: q4_weight(K, O, K + O + i), wbytes)
            ws[0] = w0
            x = torch.randn((n, K), generator=g, device=dev).to(xdt)
            bias = (torch.randn((O,), generator=g, device=dev)
                    if has_bias else None)
            got = fn(x, w0.packed, w0.scales, bias)
            ref = plain(x, w0.packed, w0.scales, bias)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            if not torch.isfinite(got).all() or rel > TOL_Q4:
                fail(f"{kname} {sname} n={n} {xdt}: max|err| {err:.3g} "
                     f"(rel {rel:.3g} > {TOL_Q4})")
            cyc = itertools.cycle(ws)

            def run_kernel():
                w = next(cyc)
                return fn(x, w.packed, w.scales, bias)

            ms = timed(run_kernel)
            plain_ms = timed(lambda: plain(x, w0.packed, w0.scales, bias),
                             reps=5, warmup=1)
            wdt = torch.bfloat16 if xdt == torch.bfloat16 else torch.float32
            lib_ms = timed(lambda: torch.matmul(
                x.to(wdt), dequantize_km(next(cyc), wdt)), reps=5, warmup=1)
            nbytes = (wbytes + x.numel() * x.element_size() + n * O * 4
                      + (O * 4 if has_bias else 0))
            peak = bf16_peak if xdt == torch.bfloat16 else f32_peak
            b_ms, b_by = bound(nbytes, 2 * n * K * O, peak)
            rows.append(dict(kernel=kname, shape=f"{sname} n={n} {K}->{O} "
                             f"x={str(xdt)[6:]}", max_abs_err=err,
                             rel_err=rel, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))

    # K3: GPT-J decode attention, H=16, D=256, S=2048, stacked L=2, layer 1
    L, B, H, S, D = 2, 1, 16, 2048, 256  # noqa: N806
    scale = 1.0 / math.sqrt(D)
    for kv in ("int8", "int4"):
        Dp = D // 2 if kv == "int4" else D  # noqa: N806
        vdt = torch.uint8 if kv == "int4" else torch.int8
        lo, hi = (0, 256) if kv == "int4" else (-127, 128)

        def cache(seed):
            gg = torch.Generator(device=dev)
            gg.manual_seed(seed)
            vals = torch.randint(lo, hi, (L, B, H, S, Dp), generator=gg,
                                 device=dev, dtype=vdt)
            sc = (torch.rand((L, B, H, S), generator=gg, device=dev)
                  * 0.05).to(torch.bfloat16)
            return vals, sc

        k_store, v_store = cache(1), cache(2)
        q = torch.randn((B, H, D), generator=g, device=dev)
        for n_past in (0, 127, 1500):
            npv = torch.full((B,), n_past, dtype=torch.int32, device=dev)
            got = decode_attention_q(q, k_store, v_store, 1, npv, scale=scale)
            ref = decode_attention_plain(q, k_store, v_store, 1, npv,
                                         scale=scale)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            if not torch.isfinite(got).all() or rel > TOL_DECODE:
                fail(f"decode_attention_q {kv} n_past={n_past}: max|err| "
                     f"{err:.3g} (rel {rel:.3g} > {TOL_DECODE})")
            ms = timed(lambda: decode_attention_q(q, k_store, v_store, 1, npv,
                                                  scale=scale), reps=50)
            plain_ms = timed(lambda: decode_attention_plain(
                q, k_store, v_store, 1, npv, scale=scale), reps=5, warmup=1)
            nk = n_past + 1
            kd = (kv_int(k_store[0][1, :, :, :nk])
                  * k_store[1][1, :, :, :nk].float()[..., None]).to(torch.bfloat16)
            vd = (kv_int(v_store[0][1, :, :, :nk])
                  * v_store[1][1, :, :, :nk].float()[..., None]).to(torch.bfloat16)
            qb = q.to(torch.bfloat16)[:, :, None, :]
            lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                qb, kd, vd, scale=scale), reps=50)
            nbytes = 2 * B * H * nk * (Dp + 2) + B * H * D * (2 + 4)
            b_ms, b_by = bound(nbytes, 4 * B * H * nk * D, bf16_peak)
            rows.append(dict(kernel="decode_attention_q",
                             shape=f"{kv} B={B} H={H} D={D} S={S} "
                             f"n_past={n_past}", max_abs_err=err, rel_err=rel,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms))

    # K4: prefill flash attention, H=16, D=256
    for dt in (torch.bfloat16, torch.float32):
        for T in (16, 512):  # noqa: N806
            q, k, v = (torch.randn((1, H, T, D), generator=g, device=dev)
                       .to(dt) for _ in range(3))
            got, lse = flash_attention_fwd(q, k, v, scale=scale)
            ref, lse_ref = flash_attention_plain(q, k, v, scale=scale)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            _, rel_lse = rel_err(lse, lse_ref)
            tol = TOL_FLASH_BF16 if dt == torch.bfloat16 else TOL_FLASH_F32
            if not torch.isfinite(got).all() or max(rel, rel_lse) > tol:
                fail(f"flash_attention_fwd T={T} {dt}: max|err| {err:.3g} "
                     f"(rel {rel:.3g}, lse rel {rel_lse:.3g} > {tol})")
            ms = timed(lambda: flash_attention_fwd(q, k, v, scale=scale))
            plain_ms = timed(lambda: flash_attention_plain(q, k, v,
                                                           scale=scale), reps=5)
            lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale))
            esz = q.element_size()
            nbytes = 4 * H * T * D * esz + H * T * 4
            pairs = H * T * (T + 1) // 2
            peak = bf16_peak if dt == torch.bfloat16 else f32_peak
            b_ms, b_by = bound(nbytes, 4 * pairs * D, peak)
            rows.append(dict(kernel="flash_attention_fwd",
                             shape=f"T={T} H={H} D={D} {str(dt)[6:]}",
                             max_abs_err=err, rel_err=rel, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms))
    _build.reset_launch_counts()  # comparison launches do not count
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def phase_model(peaks):
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import iter_tensors, random_q4_params
    from vsim_tpu_torch.models.transformer import forward
    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.quant.q4 import Q4Tensor

    cfg = PRESETS["gpt-j-6b"].replace(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    params = random_q4_params(cfg, seed=0)
    engines = {"int8": InferenceEngine(cfg, params, kv_dtype="int8")}
    del params
    engines["int4"] = InferenceEngine(cfg, engines["int8"].params,
                                      kv_dtype="int4")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    p = engines["int8"].params
    step_bytes = sum(t.nbytes for lp in p["layers"] for t in lp.values()
                     if isinstance(t, Q4Tensor)) + p["lm_head"].nbytes
    bound_ms = step_bytes / peaks[0] * 1e3
    weight_gb = sum(t.numel() * t.element_size()
                    for t in iter_tensors(p)) / 1e9

    rng = torch.Generator().manual_seed(0)
    prompts = {n: torch.randint(0, cfg.n_vocab, (n,), generator=rng).tolist()
               for n in (8, 100, 300)}
    results = {}
    _build.reset_launch_counts()
    for kv, eng in engines.items():
        for n, prompt in prompts.items():
            r = eng.generate(prompt, 64, SamplingParams(greedy=True))
            if len(r.token_ids) != 64 or not all(
                    0 <= t < cfg.n_vocab for t in r.token_ids):
                fail(f"{kv} prompt {n}: bad tokens {r.token_ids[:8]}...")
            tm = r.timings
            results[f"{kv} prompt={n}"] = dict(
                prefill_ms=tm["prefill_s"] * 1e3,
                decode_ms_per_token=tm["decode_s"] * 1e3 / (tm["tokens"] - 1),
                tokens_per_s=tm["tokens_per_s"])
        r = eng.generate(prompts[8], 32, SamplingParams(seed=42))
        if len(r.token_ids) != 32:
            fail(f"{kv} sampled request returned {len(r.token_ids)} tokens")
        results[f"{kv} sampled"] = dict(tokens=r.token_ids[:8])
    launches = dict(_build.launch_counts)
    for name in _build.SOURCES:
        if launches.get(name, 0) == 0:
            fail(f"the main path never launched {name}: {launches}")

    # one bf16 decode step at n_past=300, timed alone: launches per step,
    # host enqueue time, and wall time to completion
    eng = engines["int8"]
    cache = eng.new_cache()
    ids = torch.tensor([prompts[300]], device="cuda")
    _, cache = forward(cfg, eng.params, ids, cache, 0, fresh_kv=True)
    tok = ids[:, -1:]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    forward(cfg, eng.params, tok, cache, 300)
    per_step = dict(_build.launch_counts)
    enq, wall = [], []
    for i in range(20):
        torch.cuda.synchronize()
        a = time.perf_counter()
        forward(cfg, eng.params, tok, cache, 301 + i)
        b = time.perf_counter()
        torch.cuda.synchronize()
        enq.append(b - a)
        wall.append(time.perf_counter() - a)
    enq.sort()
    wall.sort()
    step = dict(launches_per_step=per_step,
                enqueue_ms_median=enq[10] * 1e3, wall_ms_median=wall[10] * 1e3,
                bound_ms_per_token=bound_ms, weight_bytes_per_step=step_bytes)
    return dict(setup_s=setup_s, weight_gb=weight_gb, requests=results,
                step=step), launches


# ---------------------------------------------------------------------------
# phase 4: card against CPU
# ---------------------------------------------------------------------------


def phase_card_vs_cpu():
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params

    base = PRESETS["gpt-j-6b"].replace(n_layer=2, n_ctx=64)
    params = random_q4_params(base, seed=1, device="cpu")
    prompt = list(range(100, 112))
    out = {}
    cfg = base.replace(compute_dtype="float32")
    streams = {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngine(cfg, params, kv_dtype="int8", device=dev)
        streams[dev] = eng.generate(prompt, 16,
                                    SamplingParams(greedy=True)).token_ids
    if streams["cuda"] != streams["cpu"]:
        fail(f"f32 greedy streams differ: card {streams['cuda']} "
             f"cpu {streams['cpu']}")
    out["f32_greedy_tokens"] = streams["cuda"]
    cfg = base.replace(compute_dtype="bfloat16")
    logits = {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngine(cfg, params, kv_dtype="int8", device=dev)
        logits[dev] = torch.from_numpy(
            eng.generate(prompt, 1, return_logits=True).logits)
    if not torch.isfinite(logits["cuda"]).all():
        fail("bf16 logits on the card are not finite")
    err, rel = rel_err(logits["cuda"], logits["cpu"])
    if rel > TOL_LOGITS_BF16:
        fail(f"bf16 logits card vs cpu: max|err| {err:.3g} (rel {rel:.3g} > "
             f"{TOL_LOGITS_BF16})")
    out["bf16_logits_max_abs_err"] = err
    out["bf16_logits_rel_err"] = rel
    return out


KERNEL_META = {
    "q4_gemv_ps": ("vsim_tpu_torch/csrc/q4_gemv_ps.cu",
                   "vsim_tpu/ops/pallas_q4.py:339", "fc n=1"),
    "q4_matmul_ps": ("vsim_tpu_torch/csrc/q4_matmul_ps.cu",
                     "vsim_tpu/ops/pallas_q4.py:482", "fc n=128"),
    "decode_attention": ("vsim_tpu_torch/csrc/decode_attention.cu",
                         "vsim_tpu/ops/decode_attention.py:82",
                         "int8 B=1 H=16 D=256 S=2048 n_past=1500"),
    "flash_attention": ("vsim_tpu_torch/csrc/flash_attention.cu",
                        "vsim_tpu/ops/attention.py:62",
                        "T=512 H=16 D=256 bfloat16"),
}
ROW_KERNEL = {"q4_gemv_ps": "q4_gemv_ps", "q4_matmul_ps": "q4_matmul_ps",
              "decode_attention_q": "decode_attention",
              "flash_attention_fwd": "flash_attention"}


def kernel_line(rows, launches):
    """One entry per kernel, at the representative shape named in
    KERNEL_META (every shape is in build/chip_smoke.json)."""
    out = []
    for name, (src, replaces, shape) in KERNEL_META.items():
        mine = [r for r in rows if ROW_KERNEL[r["kernel"]] == name]
        rep = [r for r in mine if r["shape"] == shape
               or r["shape"].startswith(shape + " ")]
        r = rep[0]
        out.append(dict(name=name, route="cuda", source=src,
                        replaces=replaces, launches=launches.get(name, 0),
                        max_abs_err=max(x["max_abs_err"] for x in mine),
                        ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["library_ms"], shape=r["shape"]))
    return out


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "vsim_tpu_torch")):
        fail("vsim_tpu_torch/ is missing: run from a checkout of the repo")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)
    from vsim_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows = phase_kernels(peaks)
    print(f"kernel phase: {len(rows)} cases pass in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    model, launches = phase_model(peaks)
    print(f"main path in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(model['step'])}", flush=True)
    for k, v in model["requests"].items():
        print(f"  {k}: {json.dumps(v)}", flush=True)
    t0 = time.perf_counter()
    vs_cpu = phase_card_vs_cpu()
    print(f"card vs cpu in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(vs_cpu)}", flush=True)

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernel_rows=rows, model=model,
                       card_vs_cpu=vs_cpu, ptxas=reports), f, indent=1)
    print(json.dumps({"kernels": kernel_line(rows, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
