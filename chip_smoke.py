#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vsim_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi) and build the
     kernels from csrc/ (one nvcc per source, all at once, into build/);
  2. kernels: each of K1-K6 at GPT-J-6B shapes against its plain PyTorch
     version on the card, its device time (CUDA events, the calls held
     back to back) beside its bound and a PyTorch yardstick the port never
     calls;
  3. InferenceEngine on GPT-J-6B at full width (28 layers, random Q4
     weights from seed 0, bf16 compute) with int8 and with int4 KV, serving
     prompts of 8, 100 and 300 tokens (64 new tokens, greedy) and one
     sampled request; the launch counts of K1-K4 must grow;
  4. ServingEngine on the same params, max_batch 8, int8 and int4 KV: 12
     requests (seeded prompt lengths 8-300, 32 or 64 new tokens, greedy,
     chunks of 8 steps) and one submitted mid-flight; every request returns
     its token count; the launch counts of K1, K4, K5 and K6 must grow;
  5. card against CPU: GPT-J width at depth 2, f32 greedy streams must be
     identical (InferenceEngine, and ServingEngine card vs CPU vs the
     card's InferenceEngine), bf16 return_logits must agree within the
     stated tolerance.
Each path's launch counts are set to 0 just before it runs and read just
after.  Prints a JSON line {"kernels": [...]} and, last, the device line.
Details go to build/chip_smoke.json.  Exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import collections
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
TOL_DECODE = 1e-3  # K3, K5: only the exp and sum order differ
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
# Cycles per second that sizes timed()'s spin: at or above the SM clock
# (H100 boost 1.98 GHz), so the spin lasts at least as long as asked.
SPIN_HZ = 2.0e9
UNHELD = [0]  # timed() calls whose spin ended before the calls were queued


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    fail(f"no peak table for card {name!r}")


def timed(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call of fn(), from CUDA events around ``reps`` calls
    that the host enqueues while a spin kernel holds the stream, so they
    run back to back on the card.  Events around calls on a free stream
    would time the host's launches instead, which take longer than a small
    kernel runs.  The spin is sized from the host's own enqueue time; a
    call that waits on the host cannot be held, and its time then includes
    the host's gaps (counted in ``UNHELD``)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - a
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for spin_s in (2 * host_s + 2e-3, 8 * host_s + 20e-3):
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()  # the spin still ran when all were queued
        torch.cuda.synchronize()
        if held:
            break
    else:
        UNHELD[0] += 1
    return start.elapsed_time(end) / reps


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
    from vsim_tpu_torch.ops.decode_attention import (
        decode_attention_fresh, decode_attention_fresh_plain,
        decode_attention_plain, decode_attention_q, kv_int, scatter_rows,
        scatter_rows_plain)
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

    # K5 (fresh-mode decode attention) and K6 (the all-layer row writer):
    # one ragged serving step at B=8, each row at its own n_past (2048 = S
    # is the inactive-slot sentinel: K5 reads all S rows, K6 writes none)
    B = 8  # noqa: N806
    n_list = [0, 1, 127, 128, 300, 1500, 2047, 2048]
    npv = torch.tensor(n_list, dtype=torch.int32, device=dev)
    n_keys = [min(n, S) for n in n_list]
    live = [b for b, n in enumerate(n_list) if n < S]
    for kv in ("int8", "int4"):
        Dp = D // 2 if kv == "int4" else D  # noqa: N806
        vdt = torch.uint8 if kv == "int4" else torch.int8
        lo, hi = (0, 256) if kv == "int4" else (-127, 128)

        def side(shape):
            vals = torch.randint(lo, hi, shape, generator=g, device=dev,
                                 dtype=vdt)
            sc = (torch.rand(shape[:-1], generator=g, device=dev)
                  * 0.05).to(torch.bfloat16)
            return vals, sc

        k_store, v_store = side((L, B, H, S, Dp)), side((L, B, H, S, Dp))
        fresh = (*side((B, H, Dp)), *side((B, H, Dp)))
        q = torch.randn((B, H, D), generator=g, device=dev)
        got = decode_attention_fresh(q, k_store, v_store, 1, npv, fresh,
                                     scale=scale)
        ref = decode_attention_fresh_plain(q, k_store, v_store, 1, npv, fresh,
                                           scale=scale)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not torch.isfinite(got).all() or rel > TOL_DECODE:
            fail(f"decode_attention_fresh {kv}: max|err| {err:.3g} "
                 f"(rel {rel:.3g} > {TOL_DECODE})")
        ms = timed(lambda: decode_attention_fresh(
            q, k_store, v_store, 1, npv, fresh, scale=scale), reps=50)
        plain_ms = timed(lambda: decode_attention_fresh_plain(
            q, k_store, v_store, 1, npv, fresh, scale=scale), reps=5,
            warmup=1)
        # yardstick: SDPA over the dequantized layer and the fresh row as
        # one more key, masked to rows < n_past[b] and that row
        def deq(vals, sc):
            return kv_int(vals) * sc.float()[..., None]

        kd = torch.cat([deq(k_store[0][1], k_store[1][1]),
                        deq(*fresh[:2])[:, :, None]], dim=2).to(torch.bfloat16)
        vd = torch.cat([deq(v_store[0][1], v_store[1][1]),
                        deq(*fresh[2:])[:, :, None]], dim=2).to(torch.bfloat16)
        s_idx = torch.arange(S + 1, device=dev)
        mask = ((s_idx[None, :] < npv[:, None]) | (s_idx[None, :] == S))
        mask = mask[:, None, None, :]
        qb = q.to(torch.bfloat16)[:, :, None, :]
        lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
            qb, kd, vd, attn_mask=mask, scale=scale), reps=50)
        del kd, vd
        rows_read = sum(n_keys) + B  # cache rows and the fresh ones, per head
        nbytes = (2 * H * rows_read * (Dp + 2) + B * H * D * (2 + 4))
        b_ms, b_by = bound(nbytes, 4 * H * rows_read * D, bf16_peak)
        rows.append(dict(kernel="decode_attention_fresh",
                         shape=f"{kv} B={B} H={H} D={D} S={S} n_past={n_list}",
                         max_abs_err=err, rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
        del k_store, v_store

        # K6 over the whole GPT-J-6B cache, 28 layers
        L6 = 28  # noqa: N806
        k_store, v_store = side((L6, B, H, S, Dp)), side((L6, B, H, S, Dp))
        new = (*side((L6, B, H, Dp)), *side((L6, B, H, Dp)))
        k_ref, v_ref = (tuple(t.clone() for t in st)
                        for st in (k_store, v_store))
        scatter_rows(k_store, v_store, new, npv)
        scatter_rows_plain(k_ref, v_ref, new, npv)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((*k_store, *v_store),
                                                     (*k_ref, *v_ref))):
            fail(f"scatter_rows {kv}: differs from its plain version")
        del k_ref, v_ref
        ms = timed(lambda: scatter_rows(k_store, v_store, new, npv), reps=50)
        plain_ms = timed(lambda: scatter_rows_plain(k_store, v_store, new,
                                                    npv), reps=5, warmup=1)
        # yardstick: index_put_ of the rows that land (the host picks them)
        lv = torch.tensor(live, device=dev)
        ix = (torch.arange(L6, device=dev)[:, None, None], lv[None, :, None],
              torch.arange(H, device=dev)[None, None, :],
              npv.long()[lv][None, :, None])
        sel = [t[:, lv] for t in new]

        def index_put():
            for (vals, sc), (rq, rs) in ((k_store, sel[:2]),
                                         (v_store, sel[2:])):
                vals.index_put_(ix, rq)
                sc.index_put_(ix, rs)

        lib_ms = timed(index_put, reps=50)
        nbytes = 2 * 2 * L6 * len(live) * H * (Dp + 2)  # read + write
        b_ms, b_by = bound(nbytes, 0, bf16_peak)
        rows.append(dict(kernel="scatter_rows",
                         shape=f"{kv} L={L6} B={B} H={H} Dp={Dp} S={S} "
                         f"n_past={n_list}", max_abs_err=0.0, rel_err=0.0,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms))
        del k_store, v_store, new, sel
        torch.cuda.empty_cache()

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
# phase 3: InferenceEngine at full width
# ---------------------------------------------------------------------------

INFERENCE_KERNELS = ("q4_gemv_ps", "q4_matmul_ps", "decode_attention",
                     "flash_attention")
SERVING_KERNELS = ("q4_gemv_ps", "flash_attention", "decode_attention_fresh",
                   "scatter_rows")


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
    for name in INFERENCE_KERNELS:
        if launches.get(name, 0) == 0:
            fail(f"InferenceEngine never launched {name}: {launches}")

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
                step=step), launches, cfg, p


# ---------------------------------------------------------------------------
# phase 4: ServingEngine at full width
# ---------------------------------------------------------------------------


def phase_serving(cfg, params):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vsim_tpu_torch import monitor
    from vsim_tpu_torch.decode_profile import busy_us
    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.models.transformer import forward
    from vsim_tpu_torch.ops import _build

    rng = torch.Generator().manual_seed(1)
    lens = torch.randint(8, 301, (13,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.n_vocab, (n,), generator=rng).tolist()
               for n in lens]
    n_pred = [64 if i % 2 == 0 else 32 for i in range(13)]
    out, launches = {}, {}
    for kv in ("int8", "int4"):
        srv = ServingEngine(cfg, params, max_batch=8, kv_dtype=kv)
        warmup_s = srv.warmup()
        monitor.reset()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        for p, n in zip(prompts[:12], n_pred[:12]):
            srv.submit(p, n, stop_tokens=())
        chunks = 0
        while srv._queue or srv._active:
            if chunks == 2:  # joins while the first eight decode
                srv.submit(prompts[12], n_pred[12], stop_tokens=())
            srv.step_chunk(8)
            chunks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[kv] = run_counts = dict(_build.launch_counts)
        for name in SERVING_KERNELS:
            if run_counts.get(name, 0) == 0:
                fail(f"ServingEngine ({kv}) never launched {name}: "
                     f"{run_counts}")
        reqs = [srv._results[i] for i in sorted(srv._results)]
        if len(reqs) != 13:
            fail(f"serving {kv}: {len(reqs)} of 13 requests finished")
        for r, n in zip(reqs, n_pred):
            if len(r.generated) != n or not all(
                    0 <= t < cfg.n_vocab for t in r.generated):
                fail(f"serving {kv} request {r.request_id}: "
                     f"{len(r.generated)} tokens of {n}")
        st = monitor.stats()  # read now: later spans add to these entries
        chunk_calls, chunk_s = st["serve/step_chunk"].calls, \
            st["serve/step_chunk"].wall_s
        admit_calls, admit_s = (st["serve/admit"].calls,
                                st["serve/admit"].wall_s)
        n_tok = sum(len(r.generated) for r in reqs)

        # one B=8 decode step alone, every slot live at its own n_past
        for p in prompts[:8]:
            srv.submit(p[:100], 4, stop_tokens=())
        srv._admit()
        tok, npv = srv.tokens[:, None].clone(), srv.n_past.clone()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        forward(cfg, srv.params, tok, srv.cache, npv)
        per_step = dict(_build.launch_counts)
        enq, wall_step = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            a = time.perf_counter()
            forward(cfg, srv.params, tok, srv.cache, npv)
            b = time.perf_counter()
            torch.cuda.synchronize()
            enq.append(b - a)
            wall_step.append(time.perf_counter() - a)
        enq.sort()
        wall_step.sort()
        # the same step under torch.profiler: device busy time (the union
        # of kernel and copy intervals) and device time by kernel; None
        # where the profiler records no device activity
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                forward(cfg, srv.params, tok, srv.cache, npv)
            torch.cuda.synchronize()
        intervals, by_name = [], collections.Counter()
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                s, e = ev.time_range.start, ev.time_range.end
                intervals.append((s, e))
                by_name[ev.name[:60]] += (e - s) / 1e3 / 5
        busy_ms = busy_us(intervals) / 1e3 / 5 if intervals else None
        out[kv] = dict(
            warmup_s=warmup_s, wall_s=wall, requests=len(reqs),
            generated_tokens=n_tok, tokens_per_s=n_tok / wall,
            ttft_ms=[(r.first_token_s - r.submitted_s) * 1e3 for r in reqs],
            chunks=chunk_calls,
            ms_per_chunk_step=chunk_s * 1e3 / (chunk_calls * 8),
            admit_ms_total=admit_s * 1e3, admissions=admit_calls,
            launches_per_decode_step=per_step,
            step_b8_enqueue_ms_median=enq[5] * 1e3,
            step_b8_wall_ms_median=wall_step[5] * 1e3,
            step_b8_device_busy_ms=busy_ms,
            step_b8_device_idle_share=(None if busy_ms is None else
                                       1 - busy_ms / (wall_step[5] * 1e3)),
            step_b8_device_ms_by_kernel=dict(by_name.most_common(8)))
        del srv
        torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# phase 5: card against CPU
# ---------------------------------------------------------------------------


def phase_card_vs_cpu():
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.engine.serving import ServingEngine
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
    # serving: 4 prompts on 3 slots (one waits for a slot), 12 tokens each.
    # Random weights give the odd near-tie, where card and CPU f32 sums may
    # pick different tokens (range(300, 320) has a top-2 logit margin of
    # 3e-4 of max|logit| at its third step): every greedy step of these
    # prompts has a margin above 2e-3 on the CPU.
    prompts = [prompt, list(range(7, 10)), list(range(1000, 1020)), [42]]
    served = {}
    for dev in ("cuda", "cpu"):
        srv = ServingEngine(cfg, params, max_batch=3, kv_dtype="int8",
                            device=dev)
        res = srv.run(prompts, 12, stop_tokens=(), chunk_steps=4)
        served[dev] = [res[i].generated for i in sorted(res)]
    eng = InferenceEngine(cfg, params, kv_dtype="int8", device="cuda")
    single = [eng.generate(p, 12, SamplingParams(greedy=True)).token_ids
              for p in prompts]
    if not served["cuda"] == served["cpu"] == single:
        fail(f"f32 serving streams differ: card {served['cuda']} cpu "
             f"{served['cpu']} card InferenceEngine {single}")
    out["f32_serving_tokens"] = served["cuda"]
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
    "decode_attention_fresh": ("vsim_tpu_torch/csrc/decode_attention.cu",
                               "vsim_tpu/ops/decode_attention.py:82",
                               "int8 B=8 H=16 D=256 S=2048"),
    "scatter_rows": ("vsim_tpu_torch/csrc/kv_scatter_rows.cu",
                     "vsim_tpu/ops/decode_attention.py:370",
                     "int8 L=28 B=8 H=16 Dp=256 S=2048"),
}
ROW_KERNEL = {"q4_gemv_ps": "q4_gemv_ps", "q4_matmul_ps": "q4_matmul_ps",
              "decode_attention_q": "decode_attention",
              "flash_attention_fwd": "flash_attention",
              "decode_attention_fresh": "decode_attention_fresh",
              "scatter_rows": "scatter_rows"}


def kernel_line(rows, launches):
    """One entry per kernel, at the representative shape named in
    KERNEL_META (every shape is in build/chip_smoke.json); ``launches``
    sums the launch counts of the driven paths."""
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
    model, launches, cfg, params = phase_model(peaks)
    print(f"InferenceEngine in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(model['step'])}", flush=True)
    for k, v in model["requests"].items():
        print(f"  {k}: {json.dumps(v)}", flush=True)
    t0 = time.perf_counter()
    serving, serve_launches = phase_serving(cfg, params)
    del params
    print(f"ServingEngine in {time.perf_counter() - t0:.1f} s", flush=True)
    for k, v in serving.items():
        print(f"  {k}: {json.dumps(v)}", flush=True)
    t0 = time.perf_counter()
    vs_cpu = phase_card_vs_cpu()
    print(f"card vs cpu in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(vs_cpu)}", flush=True)

    total = collections.Counter(launches)
    for counts in serve_launches.values():
        total.update(counts)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernel_rows=rows, model=model,
                       launches_inference=launches, serving=serving,
                       launches_serving=serve_launches, card_vs_cpu=vs_cpu,
                       timings_unheld=UNHELD[0], ptxas=reports), f,
                  indent=1)
    print(json.dumps({"kernels": kernel_line(rows, total)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
