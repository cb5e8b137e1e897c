#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vsim_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi) and build the
     kernels from csrc/ (one nvcc per source, all at once, into build/);
     every instance of K9/K10's kernel must run HMMA and convert nothing
     between its first and last HMMA, and every instance of K15's must run
     HMMA, and so must every instance of K12's (tools/sass_ops.py on the
     build; K15's opcode counts printed by math);
  2. kernels: each of K1-K6 at GPT-J-6B shapes (K2 at 1 and 8 rows under
     both plane contracts and at 9-128 rows, K5 on the B=8 ragged step, on
     phase 4's timed step and at B=1), K4 and K7/K8 (the flash
     backward) also at the Pythia-410M shapes of phase 6 (B=4 training,
     B=1 perplexity) and K7/K8 at GPT-J's; K1-K4 and K9-K11 at the
     Pythia-12B shapes phase 7 gives them (K1 at 1 and 8 rows, K2 at 1, 8
     and 100 rows under both plane contracts, K3 on layer 35 of a 36-layer
     int8 and int4 cache, K4 at the prompt lengths; K9 and K11 at GPT-J's
     too; K10 at every stacked shape of both models at n = 1 and fc at 8,
     100 and 128 rows under both plane contracts; K1, K11, K9 and K10 with
     their ratio to the flat read of their bytes); K4 also at codegen-2b's
     D=80 and at D=72; K6's two instances (every layer of the B=8 serving
     cache, and one layer at B=1 of GPT-J-6B's and Pythia-12B's, as the
     graphed one-token step calls it), byte for byte; each against its
     plain PyTorch version on the card
     (K1, K2-K5 and K9-K11 also against a second run of themselves, bit
     for bit), its device time (CUDA events, the calls held back to back)
     beside its bound and a PyTorch yardstick the port never calls (K1-K5
     and K9-K11 rows are printed with their ratio to it); then the lab's
     path, the five lab entry points' ``run`` (vsim_tpu_torch/tools): K12
     under every dequant math at GPT-J-6B's five Q4 weight shapes at n = 1
     and 8, K13 (a per-column read of every byte) in both layouts with
     K9, K1 and K2 beside it at every Q4 weight shape of GPT-J-6B and
     Pythia-12B at n = 1, the
     tools' own defaults, and K14; each tool holds every variant against
     its plain version (K12 and K13 also against a second run, bit for
     bit) and raises on a miss; kernel_lab also runs K12's "res", "w32"
     and "ps" layouts there; decode_lab runs K12's stacked "v2" layout
     beside K10 and K9 on GPT-J-6B's four stacked groups (L = 28) at n = 1
     and 8; batch_lab runs K15 (three maths, two geometries) and K13's
     batch touches at GPT-J-6B's four shapes at n = 64 and 128 and
     Pythia-12B's at n = 64; attn_lab runs K16 (vpu3d, mxu) beside K3 and
     the einsum route over a whole L-layer int8 cache for GPT-J-6B at
     B=32 x 128 and B=8 x 2048 and Pythia-12B at B=1 x 2048; prints each
     math's GB/s by shape, each shape's K13 rate with K9's, K1's and K2's
     share of it, each batch_lab variant's GB/s by shape with its ratio to
     the bound and the library and K15's plan, and each attn_lab
     configuration's ms a pass with K16's plan, and each K12 case at GPT-J's
     fc and the tools' defaults with its ratio to the flat read of its
     bytes and the earlier FMA design's recorded time; then an empty
     kernel's time (the
     launch floor) beside K6's and K14's rows;
  3. InferenceEngine on GPT-J-6B at full width (28 layers, random Q4
     weights from seed 0, bf16 compute) with int8 and with int4 KV, its
     decode step replayed from a captured CUDA graph (the default), serving
     prompts of 8, 100 and 300 tokens (64 new tokens, greedy) and one
     seeded sampled request twice (the same tokens both times); the launch
     counts of K1-K4 (replays included) must grow; one prompt and the
     sampled request again with the graph off must give the same tokens;
     the step after a 300-token prompt under each KV dtype, replayed and
     eager: host ms (a replay's is ``replay()`` alone), wall ms, device
     busy ms, idle share and ms by kernel (torch.profiler), the replay's
     device ms from CUDA events, and launches a step, equal in both modes,
     K6 once a layer (its one-layer instance writes the row) and fewer of
     PyTorch's gather/scatter kernels a step than layers;
  4. ServingEngine on the same params, max_batch 8, int8 and int4 KV,
     graphed (``warmup()`` captures the step): 12 requests (seeded prompt
     lengths 8-300, 32 or 64 new tokens, greedy, chunks of 8 steps) and one
     submitted mid-flight; every request returns its token count; the
     launch counts of K1, K4, K5 and K6 must grow; the same traffic through
     an engine with the graph off must give the same 13 streams; a B=8
     step alone, replayed and eager (as phase 3's), with K5's, K6's and
     K1's device ms in the replayed step beside an empty kernel's launch
     inside a graph (``tools/read_designs.py:graph_launch_floor_ms``);
  5. card against CPU, each part's seconds printed: GPT-J width at depth
     2, f32 greedy streams must be identical (InferenceEngine, 8 tokens,
     and ServingEngine card vs CPU vs the card's InferenceEngine, 6
     tokens), bf16 return_logits must agree within the stated tolerance;
     Pythia-410M width at depth 2, three f32 training steps: losses and
     every leaf's step-0 gradient must agree; Pythia-12B width at depth 2
     through phase 7's three engines: f32 greedy streams (6 tokens)
     identical, bf16 logits within the tolerance (the gi engine's from a
     12-token prompt, whose prefill takes K2's tensor cores);
  6. training: Pythia-410M at full width and depth, dense f32 weights from
     seed 0, make_train_step with the default AdamW, 5 steps on one seeded
     batch of 4 x 2049 tokens: finite losses, the last below the first, and
     K4, K7 and K8 launched once per layer in every step; then
     evaluate.perplexity on random Q4 params over a seeded 4096-token
     stream at window 2048;
  7. Pythia-12B at full width (36 layers, random Q4 weights from seed 0,
     bf16 compute, int8 KV) through three InferenceEngines, graphed,
     serving prompts of 8, 100 and 300 tokens (64 new tokens, greedy) and a
     seeded sampled request: stacked layers (unroll_layers=False: K10 4
     launches a layer and K9 1 a step), the default engine under the f32xf
     math (K11 once a layer, K2) and under gi (K1, K2; one engine object,
     a graph for each math); K3 and K4 in each; one prompt and the sampled
     request with the graph off must give the same tokens; the step after
     a 300-token prompt, replayed and eager, as phase 3's (K3's two passes
     and K2's launches summed, K10's and K9's ms apart; K6 once a layer),
     against the weight bytes' bound.  Before its run, K10 on layer 35 of the stacked
     engine's own weights is held against its plain version.
Each path's launch counts are set to 0 just before it runs and read just
after (the lab's too: K12-K16 launch only there).  Prints the run's total
seconds, a JSON line {"kernels": [...]} (K1-K16) and, last, the device line.
Details go to build/chip_smoke.json.  Exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import math
import re
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
try:
    from vsim_tpu_torch.timing import UNHELD, rel_err, rotation, timed
except ImportError as exc:  # outside a checkout, or without PyTorch
    print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
    sys.exit(1)

# Tolerances, relative to max|plain| on the same inputs.
TOL_Q4 = 1e-4     # K1/K2: only the order of the f32 sums differs
TOL_DECODE = 1e-3  # K3, K5: only the exp and sum order differ
TOL_FLASH_BF16 = 1e-2  # K4 bf16: the output is rounded to bf16
TOL_FLASH_F32 = 1e-4   # K4 f32: sum order only
# K7/K8: bf16 gradients are rounded to bf16 at the store; f32 ones at D = 64
# and 128 take each product as three TF32 products of split operands
# ("mma_3xtf32": ~1e-6 of max|plain| in tests/test_torch_flash_bwd.py's
# emulation, where one TF32 product misses 1e-4), at other D the FMA tiles
# differ from the plain version's cuBLAS products in sum order only
TOL_BWD_BF16 = 1e-2
TOL_BWD_F32 = 1e-4
# training card vs CPU, f32: the step-0 loss, each leaf's step-0 gradient
# (relative to that leaf's max|grad|, plus 1e-6 of the largest gradient of
# any leaf: a leaf whose true gradient is 0, such as the key bias of the
# unrotated dims, holds only rounding noise), the losses after AdamW steps
TOL_TRAIN_LOSS0 = 1e-5
TOL_TRAIN_GRAD = 1e-3
TOL_TRAIN_LOSS = 1e-4
# bf16 logits card vs CPU, relative to max|logit|: every activation rounds
# to bf16 (~4e-3 relative) and a rounding that flips between the two
# devices' sum orders propagates through the 2-layer stack.
TOL_LOGITS_BF16 = 5e-2

# Card peaks by name (NVIDIA data sheets, dense): bytes/s, bf16 FLOP/s,
# f32 (non-tensor) FLOP/s.
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100": (3.35e12, 989e12, 67e12),
         "H200": (4.8e12, 989e12, 67e12)}
# dense TF32 FLOP/s (NVIDIA data sheets): the second bound of K7/K8's
# "mma_3xtf32" instance, three TF32 products per f32 product
TF32_PEAKS = {"H100 PCIe": 378e12, "H100": 494.7e12, "H200": 494.7e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    fail(f"no peak table for card {name!r}")


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def phase_kernels(peaks):
    import torch

    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.ops.attention import (flash_attention_bwd_dkv,
                                              flash_attention_bwd_dq,
                                              flash_attention_bwd_plain,
                                              flash_attention_bwd_route,
                                              flash_attention_fwd,
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
    # (kernel, n, x dtype, K2's plane contract): K1 at decode and serving
    # batches; K2's GEMV at n = 1 and 8 under both contracts (f32xf, i32 /
    # f32x), its tensor cores at 9-128 rows (gi's contract for bf16 x), its
    # f32 FMA tiles for f32 x past 8 rows
    bf16, f32 = torch.bfloat16, torch.float32
    q4_cases = ([("q4_gemv_ps", n, bf16, None) for n in (1, 8)]
                + [("q4_matmul_ps", n, bf16, r) for n in (1, 8)
                   for r in (False, True)]
                + [("q4_matmul_ps", n, bf16, True) for n in (9, 16, 32, 64,
                                                             128)]
                + [("q4_matmul_ps", n, f32, False) for n in (16, 128)])
    kern = {"q4_gemv_ps": (q4_gemv_ps, q4_gemv_ps_plain),
            "q4_matmul_ps": (q4_matmul_ps, q4_matmul_ps_plain)}
    for kname, n, xdt, round_planes in q4_cases:
        fn, plain = kern[kname]
        if kname == "q4_matmul_ps":
            fn, plain = (functools.partial(f, round_planes=round_planes)
                         for f in (fn, plain))
        for sname, K, O, has_bias in shapes:
            w0 = q4_weight(K, O, K + O)
            wbytes = w0.nbytes
            ws = rotation(lambda i: q4_weight(K, O, K + O + i), wbytes)
            ws[0] = w0
            x = torch.randn((n, K), generator=g, device=dev).to(xdt)
            bias = (torch.randn((O,), generator=g, device=dev)
                    if has_bias else None)
            got = fn(x, w0.packed, w0.scales, bias)
            ref = plain(x, w0.packed, w0.scales, bias)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            shape = (f"{sname} n={n} {K}->{O} x={str(xdt)[6:]}"
                     + ("" if round_planes is None else
                        f" planes={'bf16' if round_planes else 'f32'}"))
            if not torch.isfinite(got).all() or rel > TOL_Q4:
                fail(f"{kname} {shape}: max|err| {err:.3g} "
                     f"(rel {rel:.3g} > {TOL_Q4})")
            if not torch.equal(got, fn(x, w0.packed, w0.scales, bias)):
                fail(f"{kname} {shape}: differs from run to run")
            cyc = itertools.cycle(ws)

            def run_kernel():
                w = next(cyc)
                return fn(x, w.packed, w.scales, bias)

            ms = timed(run_kernel)
            plain_ms = timed(lambda: plain(x, w0.packed, w0.scales, bias),
                             reps=5, warmup=1)
            wdt = bf16 if round_planes in (None, True) else f32
            lib_ms = timed(lambda: torch.matmul(
                x.to(wdt), dequantize_km(next(cyc), wdt)), reps=5, warmup=1)
            nbytes = (wbytes + x.numel() * x.element_size() + n * O * 4
                      + (O * 4 if has_bias else 0))
            peak = bf16_peak if wdt == bf16 else f32_peak
            b_ms, b_by = bound(nbytes, 2 * n * K * O, peak)
            rows.append(dict(kernel=kname, shape=shape, max_abs_err=err,
                             rel_err=rel, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             weights=[(K, O)]))

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
            if not torch.equal(got, decode_attention_q(q, k_store, v_store, 1,
                                                       npv, scale=scale)):
                fail(f"decode_attention_q {kv} n_past={n_past}: differs "
                     "from run to run")
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
    # is the inactive-slot sentinel: K5 reads all S rows, K6 writes none);
    # K5 also at phase 4's timed step (slots at n_past 38 and 100) and at B=1
    def fresh_row(kv, n_list, side):
        Bf = len(n_list)  # noqa: N806
        npv = torch.tensor(n_list, dtype=torch.int32, device=dev)
        Dp = D // 2 if kv == "int4" else D  # noqa: N806
        k_store, v_store = side((L, Bf, H, S, Dp)), side((L, Bf, H, S, Dp))
        fresh = (*side((Bf, H, Dp)), *side((Bf, H, Dp)))
        q = torch.randn((Bf, H, D), generator=g, device=dev)
        shape = f"{kv} B={Bf} H={H} D={D} S={S} n_past={n_list}"

        def run():
            return decode_attention_fresh(q, k_store, v_store, 1, npv, fresh,
                                          scale=scale)

        got = run()
        ref = decode_attention_fresh_plain(q, k_store, v_store, 1, npv, fresh,
                                           scale=scale)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not torch.isfinite(got).all() or rel > TOL_DECODE:
            fail(f"decode_attention_fresh {shape}: max|err| {err:.3g} "
                 f"(rel {rel:.3g} > {TOL_DECODE})")
        if not torch.equal(got, run()):
            fail(f"decode_attention_fresh {shape}: differs from run to run")
        ms = timed(run, reps=50)
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
        # cache rows and the fresh ones, per head
        rows_read = sum(min(n, S) for n in n_list) + Bf
        nbytes = (2 * H * rows_read * (Dp + 2) + Bf * H * D * (2 + 4))
        b_ms, b_by = bound(nbytes, 4 * H * rows_read * D, bf16_peak)
        rows.append(dict(kernel="decode_attention_fresh", shape=shape,
                         max_abs_err=err, rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))

    def k6_rows(k_store, v_store, new, npv, il, live, shape):
        """K6 (every layer, or layer ``il`` alone) byte for byte against its
        plain version, then timed beside its plain version and
        ``index_put_`` of the rows that land."""
        k_ref, v_ref = (tuple(t.clone() for t in st)
                        for st in (k_store, v_store))
        scatter_rows(k_store, v_store, new, npv, il)
        scatter_rows_plain(k_ref, v_ref, new, npv, il)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((*k_store, *v_store),
                                                     (*k_ref, *v_ref))):
            fail(f"scatter_rows {shape}: differs from its plain version")
        del k_ref, v_ref
        ms = timed(lambda: scatter_rows(k_store, v_store, new, npv, il),
                   reps=50)
        plain_ms = timed(lambda: scatter_rows_plain(k_store, v_store, new,
                                                    npv, il), reps=5, warmup=1)
        # yardstick: index_put_ of the rows that land (the host picks them)
        lv = torch.tensor(live, device=dev)
        sel = [t[:, lv] if il is None else t[None, lv] for t in new]
        Lw, Bw, Hw = sel[1].shape  # noqa: N806
        ix = (torch.arange(Lw, device=dev)[:, None, None]
              + (0 if il is None else il), lv[None, :, None],
              torch.arange(Hw, device=dev)[None, None, :],
              npv.long()[lv][None, :, None])

        def index_put():
            for (vals, sc), (rq, rs) in ((k_store, sel[:2]),
                                         (v_store, sel[2:])):
                vals.index_put_(ix, rq)
                sc.index_put_(ix, rs)

        lib_ms = timed(index_put, reps=50)
        Dp = new[0].shape[-1]  # noqa: N806
        nbytes = 2 * 2 * Lw * Bw * Hw * (Dp + 2)  # read + write, rows landing
        b_ms, b_by = bound(nbytes, 0, bf16_peak)
        rows.append(dict(kernel="scatter_rows", shape=shape, max_abs_err=0.0,
                         rel_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, layers=Lw))

    B = 8  # noqa: N806
    n_list = [0, 1, 127, 128, 300, 1500, 2047, 2048]
    npv = torch.tensor(n_list, dtype=torch.int32, device=dev)
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

        for nl in (n_list, [38] + [100] * 7, [100], [1500]):
            fresh_row(kv, nl, side)
        torch.cuda.empty_cache()

        # K6 over the whole GPT-J-6B cache, 28 layers
        L6 = 28  # noqa: N806
        k_store, v_store = side((L6, B, H, S, Dp)), side((L6, B, H, S, Dp))
        new = (*side((L6, B, H, Dp)), *side((L6, B, H, Dp)))
        k6_rows(k_store, v_store, new, npv, None, live,
                f"{kv} L={L6} B={B} H={H} Dp={Dp} S={S} n_past={n_list}")
        del k_store, v_store, new
        torch.cuda.empty_cache()

    # K6's one-layer instance, as the graphed one-token step calls it: B=1,
    # n_past 1500, the last layer of GPT-J-6B's and Pythia-12B's caches
    for model, L6, H6, D6 in (("gpt-j-6b", 28, 16, 256),  # noqa: N806
                              ("pythia-12b", 36, 40, 128)):
        for kv in ("int8", "int4"):
            Dp = D6 // 2 if kv == "int4" else D6  # noqa: N806
            vdt = torch.uint8 if kv == "int4" else torch.int8
            lo, hi = (0, 256) if kv == "int4" else (-127, 128)

            def side1(shape):
                vals = torch.randint(lo, hi, shape, generator=g, device=dev,
                                     dtype=vdt)
                sc = (torch.rand(shape[:-1], generator=g, device=dev)
                      * 0.05).to(torch.bfloat16)
                return vals, sc

            k_store, v_store = (side1((L6, 1, H6, S, Dp)) for _ in range(2))
            new = (*side1((1, H6, Dp)), *side1((1, H6, Dp)))
            np1 = torch.tensor([1500], dtype=torch.int32, device=dev)
            k6_rows(k_store, v_store, new, np1, L6 - 1, [0],
                    f"one-layer {model} {kv} il={L6 - 1} of {L6} B=1 H={H6} "
                    f"Dp={Dp} S={S} n_past=1500")
            del k_store, v_store, new
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
            if not torch.equal(got, flash_attention_fwd(q, k, v,
                                                        scale=scale)[0]):
                fail(f"flash_attention_fwd T={T} {dt}: differs from run to "
                     "run")
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

    # K7/K8, the flash backward, against the plain backward at the shapes
    # of the training and perplexity paths (Pythia-410M: H=16, T=S=2048,
    # D=64, f32; training B=4, perplexity B=1), in bf16 at B=1, and at
    # GPT-J's (T=S=512, D=256); K4 at the Pythia-410M shapes as well.  The
    # yardsticks are scaled_dot_product_attention and its backward (dq, dk
    # and dv in one call, so both rows carry it; the plain time is likewise
    # that of the whole plain backward).  Each row names its instance; the
    # "mma_3xtf32" rows carry a second bound, three TF32 products per f32
    # product at the card's dense TF32 peak
    f32, bf16 = torch.float32, torch.bfloat16
    tf32_peak = next(v for key, v in TF32_PEAKS.items()
                     if key in torch.cuda.get_device_name(0))
    for B, T, D, dt in ((1, 2048, 64, f32), (4, 2048, 64, f32),  # noqa: N806
                        (1, 2048, 64, bf16), (1, 512, 256, f32),
                        (1, 512, 256, bf16)):
        sc = 1.0 / math.sqrt(D)
        q, k, v, do = (torch.randn((B, H, T, D), generator=g, device=dev)
                       .to(dt) for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v, scale=sc)
        esz = q.element_size()
        pairs = B * H * T * (T + 1) // 2
        peak = bf16_peak if dt == bf16 else f32_peak
        io = B * H * T * D * esz  # one [B, H, T, D] tensor
        shape = f"B={B} T={T} H={H} D={D} {str(dt)[6:]}"
        if D == 64:
            ref, lse_ref = flash_attention_plain(q, k, v, scale=sc)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            _, rel_lse = rel_err(lse, lse_ref)
            tol = TOL_FLASH_BF16 if dt == bf16 else TOL_FLASH_F32
            if not torch.isfinite(out).all() or max(rel, rel_lse) > tol:
                fail(f"flash_attention_fwd {shape}: max|err| {err:.3g} "
                     f"(rel {rel:.3g}, lse rel {rel_lse:.3g} > {tol})")
            del ref, lse_ref
            ms = timed(lambda: flash_attention_fwd(q, k, v, scale=sc))
            plain_ms = timed(lambda: flash_attention_plain(q, k, v, scale=sc),
                             reps=5, warmup=1)
            lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=sc))
            b_ms, b_by = bound(4 * io + B * H * T * 4, 4 * pairs * D, peak)
            rows.append(dict(kernel="flash_attention_fwd", shape=shape,
                             max_abs_err=err, rel_err=rel, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms))
        dsum = (do.float() * out.float()).sum(-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, dsum, scale=sc)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dsum, scale=sc)
        ref = flash_attention_bwd_plain(q, k, v, out, lse, do, scale=sc)
        torch.cuda.synchronize()
        tol = TOL_BWD_BF16 if dt == bf16 else TOL_BWD_F32
        route = flash_attention_bwd_route(dt, D)
        if dt == f32 and D == 64 and route != "mma_3xtf32":
            fail(f"flash_attention_bwd {shape}: takes {route}, not "
                 "mma_3xtf32")
        errs = [rel_err(a, b) for a, b in zip((dq, dk, dv), ref)]
        for name, (err, rel), got in zip(("dq", "dk", "dv"), errs,
                                         (dq, dk, dv)):
            if not torch.isfinite(got).all() or rel > tol:
                fail(f"flash_attention_bwd {name} {shape}: max|err| "
                     f"{err:.3g} (rel {rel:.3g} > {tol})")
        # f32 at B=1: the kernel's and the plain version's distance from an
        # f64 backward of the same inputs (dq, dk, dv; relative to max|f64|)
        vs_f64 = None
        if dt == f32 and B == 1:
            exact = _bwd_f64(q, k, v, do, lse, dsum, sc)
            vs_f64 = dict(kernel=[rel_err(a, b)[1] for a, b in
                                  zip((dq, dk, dv), exact)],
                          plain=[rel_err(a, b)[1] for a, b in
                                 zip(ref, exact)])
            del exact
        del ref
        again = (flash_attention_bwd_dq(q, k, v, do, lse, dsum, scale=sc),
                 *flash_attention_bwd_dkv(q, k, v, do, lse, dsum, scale=sc))
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
            fail(f"flash_attention_bwd {shape} ({route}): differs from run "
                 "to run")
        del again
        ms_dq = timed(lambda: flash_attention_bwd_dq(
            q, k, v, do, lse, dsum, scale=sc))
        ms_dkv = timed(lambda: flash_attention_bwd_dkv(
            q, k, v, do, lse, dsum, scale=sc))
        plain_ms = timed(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do, scale=sc), reps=5, warmup=1)
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=True, scale=sc)
        lib_ms = timed(lambda: torch.autograd.grad(
            o, (qg, kg, vg), do, retain_graph=True))
        del o, qg, kg, vg
        for kname, ms, nbytes, ops, err in (
                ("flash_attention_bwd_dq", ms_dq, 5 * io + 2 * B * H * T * 4,
                 6 * D * pairs, errs[0][0]),
                ("flash_attention_bwd_dkv", ms_dkv,
                 6 * io + 2 * B * H * T * 4, 8 * D * pairs,
                 max(errs[1][0], errs[2][0]))):
            b_ms, b_by = bound(nbytes, ops, peak)
            rows.append(dict(kernel=kname, shape=shape, max_abs_err=err,
                             rel_err=max(r for _, r in errs), ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms,
                             instance=route,
                             bound_3xtf32_ms=(3 * ops / tf32_peak * 1e3
                                              if route == "mma_3xtf32"
                                              else None),
                             rel_err_vs_f64=vs_f64))
        del q, k, v, do, out, lse, dsum, dq, dk, dv
        torch.cuda.empty_cache()
    rows += q4_layout_rows(peaks, bound, q4_weight)
    rows += pythia_attention_rows(peaks, bound)
    flat_ratios(rows)
    _build.reset_launch_counts()  # comparison launches do not count
    return rows


def _bwd_f64(q, k, v, do, lse, dsum, scale):
    """The causal flash backward (n_past 0, no ALiBi) in f64 from the same
    inputs, lse and dsum: the yardstick both K7/K8 and their plain version
    are held to in phase 2's f32 rows."""
    import torch

    f64 = torch.float64
    T = q.shape[2]  # noqa: N806
    live = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = torch.einsum("bhtd,bhsd->bhts", q.to(f64), k.to(f64)) * scale
    p = torch.where(live, torch.exp(s - lse.to(f64)[..., None]), 0.0)
    del s
    ds = p * (torch.einsum("bhtd,bhsd->bhts", do.to(f64), v.to(f64))
              - dsum.to(f64)[..., None]) * scale
    return (torch.einsum("bhts,bhsd->bhtd", ds, k.to(f64)),
            torch.einsum("bhts,bhtd->bhsd", ds, q.to(f64)),
            torch.einsum("bhts,bhtd->bhsd", p, do.to(f64)))


# Pythia-12B's matmuls (E=5120, F=20480, vocab 50688 padded to 51200):
# (name, K, O, bias)
PYTHIA_SHAPES = {"qkv": (5120, 15360, True), "wo": (5120, 5120, True),
                 "fc": (5120, 20480, True), "proj": (20480, 5120, True),
                 "lm_head": (5120, 51200, False)}
# GPT-J-6B's stacked matmuls (E=4096, F=16384; no bias on qkv and wo)
GPTJ_STACKED = {"qkv": (4096, 12288, False), "wo": (4096, 4096, False),
                "fc": (4096, 16384, True), "proj": (16384, 4096, True)}


# the kernels on the Q4 core (csrc/q4_core.cuh): K1, K11, K9 and K10
CORE_ROWS = ("q4_gemv_ps", "q4_mlp_ps", "q4_matmul_i", "q4_matmul_stacked")


def flat_ratios(rows):
    """Each K1, K11, K9 and K10 row's time over the card's flat read of the
    same weight bytes at n = 1 (``tools/read_designs.py:flat_ms``, this
    run; fc's plus proj's for K11)."""
    from vsim_tpu_torch.tools.read_designs import flat_ms

    flat = {}
    for r in rows:
        if r["kernel"] not in CORE_ROWS:
            continue
        for w in r["weights"]:
            if w not in flat:
                flat[w] = flat_ms(*w)
        r["flat_ms"] = sum(flat[w] for w in r["weights"])
        r["vs_flat"] = r["ms"] / r["flat_ms"]


def q4_layout_rows(peaks, bound, q4_weight):
    """K1, K2 (both plane contracts), K9, K10 and K11 against their plain
    versions at the shapes phase 7's engines give them."""
    import torch
    import torch.nn.functional as F  # noqa: N812

    from vsim_tpu_torch.ops.q4_cuda import (
        mlp_activation, q4_gemv_ps, q4_gemv_ps_plain, q4_matmul_i,
        q4_matmul_i_plain, q4_matmul_ps, q4_matmul_ps_plain,
        q4_matmul_stacked, q4_matmul_stacked_plain, q4_mlp_ps,
        q4_mlp_ps_plain)
    from vsim_tpu_torch.quant.q4 import Q4Tensor, dequantize_km

    bw, bf16_peak, f32_peak = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    rows = []

    def check(kname, shape, got, ref):
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not torch.isfinite(got).all() or rel > TOL_Q4:
            fail(f"{kname} {shape}: max|err| {err:.3g} (rel {rel:.3g} > "
                 f"{TOL_Q4})")
        return err, rel

    def row(kname, shape, err, rel, ms, plain_ms, lib_ms, nbytes, ops, peak,
            weights):
        b_ms, b_by = bound(nbytes, ops, peak)
        rows.append(dict(kernel=kname, shape=shape, max_abs_err=err,
                         rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, weights=weights))

    def stacked_weight(L, K, O, seed):  # noqa: N803
        w = q4_weight(K, O * L, seed)  # random bytes, reshaped per layer
        return Q4Tensor(w.packed.reshape(K // 2, L, O).transpose(0, 1)
                        .contiguous(),
                        w.scales.reshape(K // 32, L, O).transpose(0, 1)
                        .contiguous(), "i")

    def matmul_case(kname, sname, n, K, O, has_bias, xdt, fn, plain, lib_w,  # noqa: N803
                    make, round_planes, planes=None):
        """``round_planes``: bf16 planes (bf16 peak and yardstick) or f32;
        ``planes`` names them in the shape (K1's "gi": integer sums).  K9
        and K10 count the bf16 peak under both contracts: with bf16 x their
        products are exact bf16 tensor-core products either way."""
        w0 = make(0)
        ws = rotation(make, w0.nbytes)
        ws[0] = w0
        x = torch.randn((n, K), generator=g, device=dev).to(xdt)
        bias = torch.randn((O,), generator=g, device=dev) if has_bias else None
        planes = planes or ("bf16" if round_planes else "f32")
        shape = (f"pythia-12b {sname} n={n} {K}->{O} x={str(xdt)[6:]} "
                 f"planes={planes}")
        got = fn(x, w0, bias)
        err, rel = check(kname, shape, got, plain(x, w0, bias))
        if not torch.equal(got, fn(x, w0, bias)):
            fail(f"{kname} {shape}: differs from run to run")
        cyc = itertools.cycle(ws)
        ms = timed(lambda: fn(x, next(cyc), bias))
        plain_ms = timed(lambda: plain(x, w0, bias), reps=5, warmup=1)
        wdt = torch.bfloat16 if round_planes else torch.float32
        lib_ms = timed(lambda: torch.matmul(
            x.to(wdt), dequantize_km(lib_w(next(cyc)), wdt)), reps=5,
            warmup=1)
        nbytes = (w0.nbytes // (w0.packed.shape[0] if w0.packed.dim() == 3
                                else 1)
                  + x.numel() * x.element_size() + n * O * 4
                  + (O * 4 if has_bias else 0))
        row(kname, shape, err, rel, ms, plain_ms, lib_ms, nbytes,
            2 * n * K * O, bf16_peak if round_planes or kname in (
                "q4_matmul_i", "q4_matmul_stacked") else f32_peak, [(K, O)])

    # K1 (the gi engine's decode and 8-token prefill; fc at 2 and 4 rows
    # too), and K2: f32 planes for bf16 x (the f32xf engine's decode,
    # 8-token prefill and, at 100 rows, its prefill MLP too) and at 100 rows
    # under both contracts (the prefill of 100 tokens; gi rounds the planes
    # past 8 rows)
    cases = ([("q4_gemv_ps", s, n, True) for n in (1, 8)
              for s in PYTHIA_SHAPES]
             + [("q4_gemv_ps", "fc", n, True) for n in (2, 4)]
             + [("q4_matmul_ps", s, n, False) for n in (1, 8)
                for s in ("qkv", "wo", "lm_head")]
             + [("q4_matmul_ps", s, 100, r) for r in (True, False)
                for s in PYTHIA_SHAPES])
    for kname, sname, n, round_planes in cases:
        K, O, has_bias = PYTHIA_SHAPES[sname]  # noqa: N806
        if kname == "q4_gemv_ps":
            fn, plain = q4_gemv_ps, q4_gemv_ps_plain
        else:
            fn, plain = (functools.partial(f, round_planes=round_planes)
                         for f in (q4_matmul_ps, q4_matmul_ps_plain))
        matmul_case(
            kname, sname, n, K, O, has_bias, torch.bfloat16,
            lambda x, w, b, f=fn: f(x, w.packed, w.scales, b),
            lambda x, w, b, f=plain: f(x, w.packed, w.scales, b),
            lambda w: w, lambda i, K=K, O=O: q4_weight(K, O, 7 * K + O + i),
            round_planes, "gi" if kname == "q4_gemv_ps" else None)

    # K9 at the lm heads of the stacked engine: Pythia-12B and GPT-J
    for model, K, O, has_bias in (("pythia-12b", 5120, 51200, False),  # noqa: N806
                                  ("gpt-j-6b", 4096, 51200, True)):
        def make(i, K=K, O=O):  # noqa: N803
            w = q4_weight(K, O, 11 * K + O + i)
            return Q4Tensor(w.packed, w.scales, "i")
        matmul_case(
            "q4_matmul_i", "lm_head", 1, K, O, has_bias, torch.bfloat16,
            lambda x, w, b: q4_matmul_i(x, w.packed, w.scales, b),
            lambda x, w, b: q4_matmul_i_plain(x, w.packed, w.scales, b),
            lambda w: w, make, False)
        rows[-1]["shape"] = rows[-1]["shape"].replace("pythia-12b", model)

    # K10 on layer L-1 of a stacked weight (L=2 at full width; layer 0
    # checked too): each matmul of a Pythia-12B and a GPT-J layer at n=1, fc
    # at 8, 100 and 128 rows, under both plane contracts
    L = 2  # noqa: N806
    il_last = torch.tensor(L - 1, dtype=torch.int32, device=dev)
    il_first = torch.tensor(0, dtype=torch.int32, device=dev)
    cases = ([(s, 1) for s in ("qkv", "wo", "fc", "proj")]
             + [("fc", n) for n in (8, 100, 128)])
    for model, shapes in (("pythia-12b", PYTHIA_SHAPES),
                          ("gpt-j-6b", GPTJ_STACKED)):
        for round_planes, (sname, n) in itertools.product((False, True),
                                                          cases):
            K, O, has_bias = shapes[sname]  # noqa: N806

            def fn(x, w, b, il=il_last, r=round_planes):
                return q4_matmul_stacked(x, w.packed, w.scales, il, b, r)

            def plain(x, w, b, il=il_last, r=round_planes):
                return q4_matmul_stacked_plain(x, w.packed, w.scales, il, b, r)

            w0 = stacked_weight(L, K, O, 13 * K + O)
            x0 = torch.randn((n, K), generator=g, device=dev).to(torch.bfloat16)
            check("q4_matmul_stacked", f"{model} {sname} n={n} il=0",
                  q4_matmul_stacked(x0, w0.packed, w0.scales, il_first, None,
                                    round_planes),
                  q4_matmul_stacked_plain(x0, w0.packed, w0.scales, il_first,
                                          None, round_planes))
            matmul_case(
                "q4_matmul_stacked", sname + f" il={L - 1} of {L}", n, K, O,
                has_bias, torch.bfloat16, fn, plain,
                lambda w: Q4Tensor(w.packed[L - 1], w.scales[L - 1], "i"),
                lambda i, K=K, O=O: (w0 if i == 0 else stacked_weight(
                    L, K, O, 13 * K + O + i)), round_planes)
            rows[-1]["shape"] = rows[-1]["shape"].replace("pythia-12b", model)
            del w0
            torch.cuda.empty_cache()

    # K11: Pythia-12B (gelu_exact, n=1 and 8), GPT-J (gelu_tanh), relu
    # small, with bf16 x and with f32 x (three bf16 pieces)
    lib_act = {"gelu_exact": F.gelu, "relu": F.relu,
               "gelu_tanh": lambda h: F.gelu(h, approximate="tanh")}
    bf16 = torch.bfloat16
    for model, E, Fd, act, n, xdt in (  # noqa: N806
            ("pythia-12b", 5120, 20480, "gelu_exact", 1, bf16),
            ("pythia-12b", 5120, 20480, "gelu_exact", 8, bf16),
            ("gpt-j-6b", 4096, 16384, "gelu_tanh", 1, bf16),
            ("small", 512, 1024, "relu", 4, bf16),
            ("small", 512, 1024, "relu", 4, torch.float32)):
        def make(i, E=E, Fd=Fd):  # noqa: N803
            return (q4_weight(E, Fd, 17 * E + i), q4_weight(Fd, E, 19 * E + i))

        pair0 = make(0)
        nb = pair0[0].nbytes + pair0[1].nbytes
        pairs = rotation(make, nb)
        pairs[0] = pair0
        x = torch.randn((n, E), generator=g, device=dev).to(xdt)
        bfc = torch.randn((Fd,), generator=g, device=dev) * 0.1
        bproj = torch.randn((E,), generator=g, device=dev)

        def run(p, plain=False):
            f = q4_mlp_ps_plain if plain else q4_mlp_ps
            return f(x, p[0].packed, p[0].scales, bfc, p[1].packed,
                     p[1].scales, bproj, act)

        shape = f"{model} E={E} F={Fd} {act} n={n}" + (
            "" if xdt == bf16 else " x=float32")
        got = run(pair0)
        err, rel = check("q4_mlp_ps", shape, got, run(pair0, plain=True))
        if not torch.equal(got, run(pair0)):
            fail(f"q4_mlp_ps {shape}: two runs differ")
        # the activation the kernel computes against torch's, as a check of
        # the plain version's polynomial at these h
        h = torch.randn((n, Fd), device=dev) * 3
        if (mlp_activation(h, act) - lib_act[act](h)).abs().max() > 1e-5:
            fail(f"mlp_activation {act} differs from torch's")
        cyc = itertools.cycle(pairs)
        ms = timed(lambda: run(next(cyc)))
        plain_ms = timed(lambda: run(pair0, plain=True), reps=5, warmup=1)

        def library(p):
            hh = torch.matmul(x.float(), dequantize_km(p[0])) + bfc
            return torch.matmul(lib_act[act](hh), dequantize_km(p[1])) + bproj

        lib_ms = timed(lambda: library(next(cyc)), reps=5, warmup=1)
        nbytes = nb + x.numel() * x.element_size() + (Fd + E) * 4 + n * E * 4
        row("q4_mlp_ps", shape, err, rel, ms, plain_ms, lib_ms, nbytes,
            4 * n * E * Fd, f32_peak, [(E, Fd), (Fd, E)])
        del pairs, pair0
        torch.cuda.empty_cache()
    return rows


def pythia_attention_rows(peaks, bound):
    """K3 and K4 at the shapes phase 7 gives them (Pythia-12B: H=40,
    D=128, bf16 compute): K3 over the int8 and the int4 (Dp=64) cache of all
    36 layers, on the last, at the decode lengths of the three prompts; K4
    over each prompt's own k/v.  Then K4 at head dims its shared memory pads:
    codegen-2b's D=80 (H=32) and D=72, at T=300."""
    import torch

    from vsim_tpu_torch.ops.attention import (flash_attention_fwd,
                                              flash_attention_plain)
    from vsim_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                     decode_attention_q,
                                                     kv_int)

    _, bf16_peak, _ = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    L, B, H, S, D = 36, 1, 40, 2048, 128  # noqa: N806
    il, scale, rows = L - 1, 1.0 / math.sqrt(D), []

    def side(kv):
        Dp = D // 2 if kv == "int4" else D  # noqa: N806
        lo, hi, vdt = ((0, 256, torch.uint8) if kv == "int4"
                       else (-127, 128, torch.int8))
        vals = torch.randint(lo, hi, (L, B, H, S, Dp), generator=g,
                             device=dev, dtype=vdt)
        sc = (torch.rand((L, B, H, S), generator=g, device=dev)
              * 0.05).to(torch.bfloat16)
        return vals, sc

    q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    for kv in ("int8", "int4"):
        k_store, v_store = side(kv), side(kv)
        Dp = k_store[0].shape[-1]  # noqa: N806
        for n_past in (7, 363, 1500):
            npv = torch.full((B,), n_past, dtype=torch.int32, device=dev)
            shape = (f"pythia-12b {kv} L={L} il={il} B={B} H={H} D={D} "
                     f"S={S} n_past={n_past}")
            got = decode_attention_q(q, k_store, v_store, il, npv,
                                     scale=scale)
            ref = decode_attention_plain(q, k_store, v_store, il, npv,
                                         scale=scale)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            if not torch.isfinite(got).all() or rel > TOL_DECODE:
                fail(f"decode_attention_q {shape}: max|err| {err:.3g} (rel "
                     f"{rel:.3g} > {TOL_DECODE})")
            if not torch.equal(got, decode_attention_q(
                    q, k_store, v_store, il, npv, scale=scale)):
                fail(f"decode_attention_q {shape}: differs from run to run")
            ms = timed(lambda: decode_attention_q(q, k_store, v_store, il,
                                                  npv, scale=scale), reps=50)
            plain_ms = timed(lambda: decode_attention_plain(
                q, k_store, v_store, il, npv, scale=scale), reps=5, warmup=1)
            nk = n_past + 1
            kd, vd = ((kv_int(st[0][il, :, :, :nk])
                       * st[1][il, :, :, :nk].float()[..., None]).to(
                           torch.bfloat16) for st in (k_store, v_store))
            lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None, :], kd, vd, scale=scale), reps=50)
            b_ms, b_by = bound(2 * B * H * nk * (Dp + 2) + B * H * D * (2 + 4),
                               4 * B * H * nk * D, bf16_peak)
            rows.append(dict(kernel="decode_attention_q", shape=shape,
                             max_abs_err=err, rel_err=rel, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms))
        del k_store, v_store
        torch.cuda.empty_cache()

    for T, Hf, Df, name in ((8, H, D, "pythia-12b"),  # noqa: N806
                            (100, H, D, "pythia-12b"),
                            (300, H, D, "pythia-12b"),
                            (300, 32, 80, "codegen-2b"), (300, 32, 72, "")):
        sc = 1.0 / math.sqrt(Df)
        qt, k, v = (torch.randn((1, Hf, T, Df), generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(3))
        shape = f"{name + ' ' if name else ''}T={T} H={Hf} D={Df} bfloat16"
        got, lse = flash_attention_fwd(qt, k, v, scale=sc)
        ref, lse_ref = flash_attention_plain(qt, k, v, scale=sc)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        _, rel_lse = rel_err(lse, lse_ref)
        if not torch.isfinite(got).all() or max(rel, rel_lse) > TOL_FLASH_BF16:
            fail(f"flash_attention_fwd {shape}: max|err| {err:.3g} (rel "
                 f"{rel:.3g}, lse rel {rel_lse:.3g} > {TOL_FLASH_BF16})")
        if not torch.equal(got, flash_attention_fwd(qt, k, v, scale=sc)[0]):
            fail(f"flash_attention_fwd {shape}: differs from run to run")
        ms = timed(lambda: flash_attention_fwd(qt, k, v, scale=sc))
        plain_ms = timed(lambda: flash_attention_plain(qt, k, v, scale=sc),
                         reps=5, warmup=1)
        lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, k, v, is_causal=True, scale=sc))
        b_ms, b_by = bound(4 * Hf * T * Df * 2 + Hf * T * 4,
                           4 * Hf * T * (T + 1) // 2 * Df, bf16_peak)
        rows.append(dict(kernel="flash_attention_fwd", shape=shape,
                         max_abs_err=err, rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
    return rows


# ---------------------------------------------------------------------------
# phase 2, the lab: K12-K14 through the five lab entry points
# ---------------------------------------------------------------------------

# GPT-J-6B's Q4 weights (name, K, O): the lm head's vocabulary padded to 51200
GPTJ_SHAPES = (("qkv", 4096, 12288), ("wo", 4096, 4096), ("fc", 4096, 16384),
               ("proj", 16384, 4096), ("lm_head", 4096, 51200))
LAB_KERNELS = ("q4_lab_gemv", "q4_lab_dma", "pair_bitcast", "q4_batch_lab",
               "attn_lab")
# attn_lab's configurations: (model, B, kv_len): the TPU tool's default,
# phase 4's slot count and context, Pythia-12B's B=1 chat at full context
ATTN_LAB_CASES = (("gpt-j-6b", 32, 128), ("gpt-j-6b", 8, 2048),
                  ("pythia-12b", 1, 2048))


def phase_labs(peaks):
    """The lab's path: the eight tools' ``run`` as a user calls them, each
    holding every variant against its plain version (and K12/K13/K15/K16
    against a second run, bit for bit) before timing it.  K12 under every
    math and layout at GPT-J-6B's five weight shapes at n = 1 and 8, K13
    and K1/K2/K9 at every Q4 weight shape of GPT-J-6B and Pythia-12B at
    n = 1, the tools' defaults, and K14; K12's "v2" beside K10 and K9 on
    GPT-J-6B's stacked groups at n = 1 and 8; K15 and K13's batch touches
    at GPT-J-6B's four shapes at n = 64 and 128 and Pythia-12B's at 64; K16
    beside K3 at ``ATTN_LAB_CASES``.  Returns (rows, launch counts of the
    path)."""
    import torch

    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.tools import (attn_lab, batch_lab, decode_lab,
                                      gi_sweep, kernel_lab, pair_lab,
                                      pair_probe, pair_sweep)

    rows = []
    seconds = collections.Counter()  # by tool
    clock = [time.perf_counter()]

    def tag(label, got):
        for r in got:
            r["shape"] = f"{label} {r['shape']}"
            r["bound_ms"], r["bound_by"] = lab_bound(peaks, r["nbytes"],
                                                     r["ops"], r["peak"])
        rows.extend(got)
        now = time.perf_counter()
        seconds[got[0]["tool"]] += now - clock[0]
        clock[0] = now

    _build.reset_launch_counts()
    for sname, K, O in GPTJ_SHAPES:  # noqa: N806
        for n in (1, 8):
            tag(f"gpt-j-6b {sname}", kernel_lab.run(n, (O, K)))
            tag(f"gpt-j-6b {sname}", pair_lab.run(n, (O, K)))
            tag(f"gpt-j-6b {sname}", pair_sweep.run(n, (O, K), ("pairC",)))
        tag(f"gpt-j-6b {sname}", gi_sweep.run(1, (O, K)))
    for sname, (K, O, _) in PYTHIA_SHAPES.items():  # noqa: N806
        tag(f"pythia-12b {sname}", kernel_lab.run(1, (O, K), ("dma", "cur")))
        tag(f"pythia-12b {sname}", gi_sweep.run(1, (O, K)))
    for tool in (kernel_lab, pair_lab, pair_sweep):
        tag(f"{tool.__name__.rsplit('.', 1)[1]} default", tool.run())
    for stage in pair_probe.STAGES:
        tag("pair_probe", pair_probe.run(stage))
    for n in (1, 8):
        tag("gpt-j-6b stacked", decode_lab.run(n))
    for n in (64, 128):
        tag("gpt-j-6b batch", batch_lab.run(n, batch_lab.SHAPES["gptj"]))
    tag("pythia-12b batch", batch_lab.run(64, batch_lab.SHAPES["pythia12b"]))
    for model, b, kv_len in ATTN_LAB_CASES:
        tag("attn_lab", attn_lab.run(model, b, kv_len))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("lab path, seconds by tool: " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}), flush=True)
    launches = dict(_build.launch_counts)
    missing = [k for k in LAB_KERNELS if not launches.get(k)]
    if missing:
        fail(f"the lab path launched no {missing}")
    lab_plan_checks(rows)
    k12_flat_ratios(rows)
    _build.reset_launch_counts()
    return rows, launches


# K12's times under its earlier FMA design (a GEMV of f32 multiply-adds
# with K split through HBM partials), recorded in PERF.md section 6 (rows
# 13, 16-19, 23-26; an NVIDIA H100 80GB HBM3 at 700 W): (tool, variant,
# shape label, n) -> ms, printed beside this run's
K12_OLD_MS = {
    **{("kernel_lab", m, "gpt-j-6b fc", 1): ms for m, ms in (
        ("i32", 0.0372), ("u16", 0.0272), ("f32x", 0.0311), ("f32f", 0.0260),
        ("f32xf", 0.0273), ("i32f", 0.0315))},
    **{("pair_lab", m, "gpt-j-6b fc", 1): ms for m, ms in (
        ("f32b", 0.0371), ("pairA", 0.0327), ("pairB", 0.0310))},
    **{("pair_lab", m, "pair_lab default", 32): ms for m, ms in (
        ("f32b", 0.515), ("pairA", 0.523), ("pairB", 0.505))},
    ("pair_sweep", "pairC", "gpt-j-6b fc", 1): 0.0324,
    ("pair_sweep", "pairA", "pair_sweep default", 8): 0.183,
    ("pair_sweep", "pairC", "pair_sweep default", 8): 0.169,
    ("kernel_lab", "u16", "kernel_lab default", 16): 0.0351,
    ("kernel_lab", "res", "gpt-j-6b fc", 1): 0.134,
    ("kernel_lab", "res", "gpt-j-6b fc", 8): 0.303,
    ("kernel_lab", "w32", "gpt-j-6b fc", 1): 0.0355,
    ("kernel_lab", "w32", "gpt-j-6b fc", 8): 0.0676,
    ("kernel_lab", "ps", "gpt-j-6b fc", 1): 0.0319,
    ("kernel_lab", "ps", "gpt-j-6b fc", 8): 0.0673,
    ("decode_lab", "v2", "gpt-j-6b stacked", 1): 0.0302,
    ("decode_lab", "v2", "gpt-j-6b stacked", 8): 0.0608,
    ("pair_probe", "pairA", "pair_probe", 8): 0.0074,
}


def k12_flat_ratios(rows):
    """Each K12 row's time over the card's flat read of the same weight
    bytes at n = 1 (``tools/read_designs.py:flat_ms``, this run)."""
    from vsim_tpu_torch.tools.read_designs import flat_ms

    flat = {}
    for r in rows:
        if r["kernel"] != "q4_lab_gemv":
            continue
        w = (r["K"], r["O"])
        if w not in flat:
            flat[w] = flat_ms(*w)
        r["flat_ms"] = flat[w]
        r["vs_flat"] = r["ms"] / flat[w]


def k12_lines(rows):
    """K12 at GPT-J-6B's fc (decode_lab: w_fc) and the tools' defaults:
    this run's ms, its ratio to the flat read and to the bound, and the FMA
    design's recorded time in brackets where PERF.md holds one."""
    lines = []
    for r in rows:
        if r["kernel"] != "q4_lab_gemv":
            continue
        old = next((ms for (tool, v, lab, n), ms in K12_OLD_MS.items()
                    if (r["tool"], r["variant"], r["n"]) == (tool, v, n)
                    and r["shape"].startswith(lab + " ")
                    and r.get("group", "w_fc") == "w_fc"), None)
        if old is None and not (r["shape"].startswith("gpt-j-6b fc ")
                                and r["n"] in (1, 8)):
            continue
        lines.append(
            f"  K12 {r['shape']}: {r['ms']:.4f} ms"
            + ("" if old is None else f" [{old}]")
            + f", {r['vs_flat']:.2f}x flat, {r['ms'] / r['bound_ms']:.2f}x "
            f"bound ({r['bound_by']})")
    return lines


def lab_plan_checks(rows):
    """K16 splits Pythia-12B's B=1 x 2048 heads over a cluster of more than
    one block, and K15's 2d geometry fills a wave at GPT-J-6B's wo and proj
    (O = 4096) at n = 64."""
    import torch

    from vsim_tpu_torch.ops.q4_batch_lab import BATCH_WARPS, batch_tile_o

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for r in rows:
        if (r["tool"] == "attn_lab" and r["model"] == "pythia-12b"
                and r["plan"] is not None and r["plan"][1] < 2):
            fail(f"attn_lab {r['variant']} at Pythia-12B B=1: plan "
                 f"{tuple(r['plan'])}, a cluster of one")
        if (r["tool"] == "batch_lab" and r["plan"] is not None
                and r["geometry"] == "2d" and r["n"] == 64 and r["O"] == 4096
                and r["shape"].startswith("gpt-j-6b ")):
            nt, c = r["plan"]
            blocks = -(-r["O"] // (BATCH_WARPS * batch_tile_o(nt))) * c
            if blocks < sms:
                fail(f"batch_lab {r['shape']}: plan {tuple(r['plan'])} "
                     f"launches {blocks} blocks on {sms} SMs")


def launch_floor_ms():
    """An empty kernel's device ms a call (tools/read_designs.py)."""
    from vsim_tpu_torch.tools.read_designs import launch_floor_ms as floor

    return floor("cuda")


def graph_launch_floor_ms():
    """An empty kernel's device ms a launch inside a replayed CUDA graph
    (tools/read_designs.py)."""
    from vsim_tpu_torch.tools.read_designs import graph_launch_floor_ms as f

    return f("cuda")


def launch_floor_lines(rows, floor_ms):
    """K6's and K14's rows beside an empty kernel's time: what a redesign
    of either has left to take."""
    lines = [f"  launch floor: an empty kernel {floor_ms * 1e3:.2f} us a call "
             "(timing.timed)"]
    for r in rows:
        if r["kernel"] in ("scatter_rows", "pair_bitcast"):
            lines.append(f"    {r['kernel']} {r['shape']}: {r['ms'] * 1e3:.2f} "
                         f"us, bound {r['bound_ms'] * 1e3:.2f} us, "
                         f"{r['ms'] / floor_ms:.2f}x the floor")
    return lines


def lab_bound(peaks, nbytes, ops, peak):
    """(the least ms the card could take, "bytes" or "operations"); ``peak``
    names the operations' type: "bf16", "tf32" (K12's f32 maths, exact
    TF32 tensor-core products) or "f32"."""
    import torch

    bw, bf16_peak, f32_peak = peaks
    t_b = nbytes / bw * 1e3
    if peak == "tf32":
        name = torch.cuda.get_device_name(0)
        rate = next(v for key, v in TF32_PEAKS.items() if key in name)
    else:
        rate = bf16_peak if peak == "bf16" else f32_peak
    t_o = ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def lab_summary(rows, peaks):
    """Lines: each math's GB/s by GPT-J-6B shape at n = 1 and 8; each Q4
    weight shape's K13 rate (both layouts) and K9's, K1's and
    K2's share of it at n = 1."""
    from vsim_tpu_torch.ops.q4_lab import LAB_MATHS

    def pick(label, tool, variant, n):
        for r in rows:
            if (r["shape"].startswith(label + " ") and r["tool"] == tool
                    and r["variant"] == variant and r["n"] == n):
                return r
        return None

    lines = []
    for n in (1, 8):
        for math in ("dma",) + LAB_MATHS:
            tool = ("pair_sweep" if math == "pairC" else "pair_lab"
                    if math in ("f32b", "pairA", "pairB") else "kernel_lab")
            rates = []
            for sname, _, _ in GPTJ_SHAPES:
                r = pick(f"gpt-j-6b {sname}", tool, math, n)
                rates.append(f"{sname} {r['gbs']:.0f}")
            lines.append(f"  lab {math} n={n} GB/s: " + ", ".join(rates))
    for n in (1, 8):
        for v in ("res", "w32", "ps"):
            rates = []
            for sname, _, _ in GPTJ_SHAPES:
                r = pick(f"gpt-j-6b {sname}", "kernel_lab", v, n)
                rates.append(f"{sname} {r['gbs']:.0f} ({r['vs_dma']:.2f}x "
                             "dma)")
            lines.append(f"  lab K12 {v} n={n} GB/s: " + ", ".join(rates))
    stacked = [r for r in rows if r["tool"] == "decode_lab"]
    for n, v in dict.fromkeys((r["n"], r["variant"]) for r in stacked):
        calls = [f"{r['group']} {r['ms'] * 1e3:.1f} ({r['gbs']:.0f} GB/s)"
                 for r in stacked if (r["n"], r["variant"]) == (n, v)]
        lines.append(f"  decode_lab {v} n={n} us a call: " + ", ".join(calls))
    for label, n in (("gpt-j-6b", 64), ("gpt-j-6b", 128),
                     ("pythia-12b", 64)):
        batch = [r for r in rows if r["tool"] == "batch_lab" and r["n"] == n
                 and r["shape"].startswith(label + " ")]
        for v in dict.fromkeys(r["variant"] for r in batch):
            rates = [f"{r['K']}->{r['O']} {r['gbs']:.0f} ({r['ms']:.4f} ms, "
                     f"{r['ms'] / r['bound_ms']:.1f}x bound"
                     + ("" if r["library_ms"] is None else
                        f", {r['ms'] / r['library_ms']:.2f}x library")
                     + ("" if r.get("plan") is None else
                        f", plan {tuple(r['plan'])}") + ")"
                     for r in batch if r["variant"] == v]
            lines.append(f"  batch_lab {label} {v} n={n} GB/s: "
                         + ", ".join(rates))
    for r in rows:
        if r["tool"] == "attn_lab":
            lines.append(f"  attn_lab {r['model']} B={r['B']} S={r['S']} "
                         f"{r['variant']}: {r['ms']:.3f} ms a pass of "
                         f"{r['L']} layers, {r['gbs']:.0f} GB/s on KV, bound "
                         f"{r['bound_ms']:.3f} ({r['ms'] / r['bound_ms']:.2f}x), "
                         f"library {r['library_ms']:.3f} "
                         f"({r['ms'] / r['library_ms']:.2f}x)"
                         + ("" if r.get("plan") is None else
                            f", plan {tuple(r['plan'])} (threads, cluster)")
                         + ("" if r.get("vpu3d_err") is None else
                            f", max|err| {r['max_abs_err']:.3g} against its "
                            f"plain version, {r['vpu3d_err']:.3g} against "
                            "vpu3d's"))
    shapes = ([("gpt-j-6b", s, K, O) for s, K, O in GPTJ_SHAPES]
              + [("pythia-12b", s, K, O)
                 for s, (K, O, _) in PYTHIA_SHAPES.items()])
    for model, sname, K, O in shapes:  # noqa: N806
        label = f"{model} {sname}"
        di, dp = (pick(label, t, "dma", 1) for t in ("kernel_lab", "gi_sweep"))
        k9, k2, k1 = (pick(label, t, v, 1) for t, v in (
            ("kernel_lab", "cur"), ("gi_sweep", "gi"), ("gi_sweep", "giw")))
        lines.append(
            f"  K13 rate {label} {K}->{O}: K13 i {di['gbs']:.0f} GB/s, "
            f"ps {dp['gbs']:.0f} GB/s ({di['gbs'] / (peaks[0] / 1e9):.2f} "
            f"of nominal); K9 {k9['vs_dma']:.2f}, K1 {k1['vs_dma']:.2f}, "
            f"K2 {k2['vs_dma']:.2f} of it")
    return lines


# ---------------------------------------------------------------------------
# phase 3: InferenceEngine at full width
# ---------------------------------------------------------------------------

INFERENCE_KERNELS = ("q4_gemv_ps", "q4_matmul_ps", "decode_attention",
                     "flash_attention", "scatter_rows")
SERVING_KERNELS = ("q4_gemv_ps", "flash_attention", "decode_attention_fresh",
                   "scatter_rows")


def step_times(step, reps: int = 10):
    """Median host ms of ``step()`` (its enqueue; a graph's ``replay()``)
    and median wall ms to its end, each step alone after a synchronize."""
    import torch

    enq, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = time.perf_counter()
        step()
        b = time.perf_counter()
        torch.cuda.synchronize()
        enq.append(b - a)
        wall.append(time.perf_counter() - a)
    enq.sort()
    wall.sort()
    return enq[reps // 2] * 1e3, wall[reps // 2] * 1e3


def decode_step_report(step):
    """An engine's decode step (a ``GraphedStep`` whose graph is captured)
    replayed and the same step run eagerly (``step.fn``), each on the
    engine's live state: the kernel launches of one step, host ms, wall ms,
    device busy ms and idle share, device ms by kernel and by STEP_KERNELS
    group (torch.profiler), and the replay's device ms a step from CUDA
    events around replays held back to back (``timing.timed``).  The host
    clocks run before this report's profiler sessions: after a session a
    graph's launch took ~1 ms of host time, in a fresh process ~0.05 ms
    (``decode_profile``), so phase 3's replay host time is the one read
    before any session of the run."""
    from vsim_tpu_torch.ops import _build

    if step.graph is None:
        fail("decode step report: the step has no captured graph")
    modes = (("eager", step.fn), ("graphed", step))
    out = {}
    for mode, fn in modes:
        _build.reset_launch_counts()
        fn()
        launches = dict(_build.launch_counts)
        host_ms, wall_ms = step_times(fn)
        out[mode] = dict(launches_per_step=launches, host_ms=host_ms,
                         wall_ms=wall_ms)
    for mode, fn in modes:
        busy, by_kernel, by_group, ordered = step_device_profile(fn)
        wall_ms = out[mode]["wall_ms"]
        out[mode].update(
            device_busy_ms=busy,
            device_idle_share=None if busy is None else 1 - busy / wall_ms,
            device_ms_by_kernel=by_kernel, device_ms_by_group=by_group,
            ordered=ordered)
    if out["graphed"]["launches_per_step"] != out["eager"][
            "launches_per_step"]:
        fail(f"a replay counts {out['graphed']['launches_per_step']} "
             f"launches, an eager step {out['eager']['launches_per_step']}")
    out["graphed"]["device_ms_events"] = timed(step, reps=10)
    return out


def row_write_check(label, report, n_layer):
    """A one-token step of InferenceEngine over an int8/int4 cache writes
    its row through K6's one-layer instance: one launch a layer, replayed
    and eager, and fewer of PyTorch's gather/scatter kernels a step than
    layers (the index route of the write launched 8 a layer).  Drops the
    report's kernel order and records the index kernels a step."""
    for mode in ("eager", "graphed"):
        per_step = report[mode]["launches_per_step"]
        if per_step.get("scatter_rows", 0) != n_layer:
            fail(f"{label} {mode} step: K6 launched "
                 f"{per_step.get('scatter_rows', 0)} times, not once a layer "
                 f"({n_layer})")
        ordered = report[mode].pop("ordered")
        index = None if ordered is None else len(ordered["index_kernels"]) / 3
        report[mode]["index_kernels_per_step"] = index
        if index is not None and index >= n_layer:
            fail(f"{label} {mode} step: {index} gather/scatter kernels a "
                 "step, the index route of the row write")


def k6_step_line(label, rep, n_layer):
    """K6's device time a launch in a one-token step (one launch a layer),
    replayed and eager, and the gather/scatter kernels left a step."""
    parts = []
    for mode in ("graphed", "eager"):
        r = rep[mode]
        ms = (r["device_ms_by_group"] or {}).get("scatter_rows")
        parts.append(f"{mode} {'null' if ms is None else f'{ms / n_layer * 1e3:.2f}'}"
                     f" us a launch ({r['launches_per_step']['scatter_rows']} a "
                     f"step), {r['index_kernels_per_step']} gather/scatter "
                     "kernels a step")
    return f"  {label}: K6 one-layer " + "; ".join(parts)


def step_line(label, rep):
    """One line a decode step: graphed against eager."""
    g, e = rep["graphed"], rep["eager"]

    def f(x, fmt=".3f"):
        return "null" if x is None else format(x, fmt)

    return (f"  {label}: graphed host {f(g['host_ms'])} ms (replay), wall "
            f"{f(g['wall_ms'])}, device busy {f(g['device_busy_ms'])} "
            f"(idle {f(g['device_idle_share'], '.2f')}), events "
            f"{f(g['device_ms_events'])} ms a step; eager host "
            f"{f(e['host_ms'])}, wall {f(e['wall_ms'])}, busy "
            f"{f(e['device_busy_ms'])} (idle "
            f"{f(e['device_idle_share'], '.2f')}); graphed by group "
            + json.dumps({k: None if v is None else round(v, 4) for k, v in
                          (g["device_ms_by_group"] or {}).items()}))


def eager_check(label, make_eager, prompt, want, sampled_prompt,
                want_sampled):
    """One prompt through an engine with the graph off: its greedy stream
    and a seeded sampled one must equal the replayed engine's token for
    token.  Returns the eager run's numbers."""
    from vsim_tpu_torch.engine.sampling import SamplingParams

    eng = make_eager()
    r = eng.generate(prompt, len(want), SamplingParams(greedy=True))
    if r.token_ids != want:
        fail(f"{label}: eager greedy stream {r.token_ids[:12]}... differs "
             f"from the replayed one {want[:12]}...")
    s = eng.generate(sampled_prompt, len(want_sampled),
                     SamplingParams(seed=42)).token_ids
    if s != want_sampled:
        fail(f"{label}: eager sampled stream {s[:12]}... differs from the "
             f"replayed one {want_sampled[:12]}...")
    tm = r.timings
    return dict(prefill_ms=tm["prefill_s"] * 1e3,
                decode_ms_per_token=tm["decode_s"] * 1e3 / (tm["tokens"] - 1),
                greedy_equal=True, sampled_equal=True)


def phase_model(peaks):
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import iter_tensors, random_q4_params
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
    greedy = SamplingParams(greedy=True)
    results, streams, sampled = {}, {}, {}
    _build.reset_launch_counts()
    for kv, eng in engines.items():
        for n, prompt in prompts.items():
            r = eng.generate(prompt, 64, greedy)
            if len(r.token_ids) != 64 or not all(
                    0 <= t < cfg.n_vocab for t in r.token_ids):
                fail(f"{kv} prompt {n}: bad tokens {r.token_ids[:8]}...")
            tm = r.timings
            streams[kv, n] = r.token_ids
            results[f"{kv} prompt={n}"] = dict(
                prefill_ms=tm["prefill_s"] * 1e3,
                decode_ms_per_token=tm["decode_s"] * 1e3 / (tm["tokens"] - 1),
                tokens_per_s=tm["tokens_per_s"])
        # a seeded sampled request replays the same tokens twice
        runs = [eng.generate(prompts[8], 32, SamplingParams(seed=42)).token_ids
                for _ in range(2)]
        if len(runs[0]) != 32 or runs[0] != runs[1]:
            fail(f"{kv} sampled request: {runs[0][:8]}... then "
                 f"{runs[1][:8]}...")
        sampled[kv] = runs[0]
        results[f"{kv} sampled"] = dict(tokens=runs[0][:8])
    launches = dict(_build.launch_counts)
    for name in INFERENCE_KERNELS:
        if launches.get(name, 0) == 0:
            fail(f"InferenceEngine never launched {name}: {launches}")
    for kv, eng in engines.items():  # one prompt with the graph off
        results[f"{kv} eager prompt=100"] = eager_check(
            f"gpt-j {kv}", lambda: InferenceEngine(
                cfg, eng.params, kv_dtype=kv, cuda_graph=False),
            prompts[100], streams[kv, 100], prompts[8], sampled[kv])
        torch.cuda.empty_cache()

    # the decode step after a 300-token prompt, alone, under each KV dtype
    steps = {}
    for kv, eng in engines.items():
        logits = eng.prefill(prompts[300])
        _, _, step = eng.start(prompts[300], logits[:, -1], greedy)
        report = decode_step_report(step)
        row_write_check(f"gpt-j {kv}", report, cfg.n_layer)
        report.update(bound_ms_per_token=bound_ms,
                      weight_bytes_per_step=step_bytes)
        steps[kv] = report
    return dict(setup_s=setup_s, weight_gb=weight_gb, requests=results,
                step=steps["int8"], step_int4=steps["int4"]), launches, cfg, p


# ---------------------------------------------------------------------------
# phase 4: ServingEngine at full width
# ---------------------------------------------------------------------------


def serve_scenario(srv, prompts, n_pred):
    """12 requests submitted at once and a 13th after two chunks of 8
    steps: (wall s, the finished requests in id order, monitor stats)."""
    import torch

    from vsim_tpu_torch import monitor

    monitor.reset()
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
    return wall, [srv._results[i] for i in sorted(srv._results)], \
        monitor.stats()


def phase_serving(cfg, params):
    import torch

    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.ops import _build

    rng = torch.Generator().manual_seed(1)
    lens = torch.randint(8, 301, (13,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.n_vocab, (n,), generator=rng).tolist()
               for n in lens]
    n_pred = [64 if i % 2 == 0 else 32 for i in range(13)]
    out, launches = {}, {}
    for kv in ("int8", "int4"):
        srv = ServingEngine(cfg, params, max_batch=8, kv_dtype=kv)
        warmup_s = srv.warmup()  # captures the step's graph
        _build.reset_launch_counts()
        wall, reqs, st = serve_scenario(srv, prompts, n_pred)
        launches[kv] = run_counts = dict(_build.launch_counts)
        for name in SERVING_KERNELS:
            if run_counts.get(name, 0) == 0:
                fail(f"ServingEngine ({kv}) never launched {name}: "
                     f"{run_counts}")
        if len(reqs) != 13:
            fail(f"serving {kv}: {len(reqs)} of 13 requests finished")
        for r, n in zip(reqs, n_pred):
            if len(r.generated) != n or not all(
                    0 <= t < cfg.n_vocab for t in r.generated):
                fail(f"serving {kv} request {r.request_id}: "
                     f"{len(r.generated)} tokens of {n}")
        chunk_calls, chunk_s = st["serve/step_chunk"].calls, \
            st["serve/step_chunk"].wall_s
        admit_calls, admit_s = (st["serve/admit"].calls,
                                st["serve/admit"].wall_s)
        n_tok = sum(len(r.generated) for r in reqs)

        # the same traffic with the graph off: the same streams
        eager = ServingEngine(cfg, params, max_batch=8, kv_dtype=kv,
                              cuda_graph=False)
        eager.warmup()
        e_wall, e_reqs, e_st = serve_scenario(eager, prompts, n_pred)
        if [r.generated for r in e_reqs] != [r.generated for r in reqs]:
            bad = [r.request_id for r, e in zip(reqs, e_reqs)
                   if r.generated != e.generated]
            fail(f"serving {kv}: requests {bad} differ between the replayed "
                 "and the eager engine")
        e_chunk = e_st["serve/step_chunk"]
        del eager
        torch.cuda.empty_cache()

        # one B=8 decode step alone, every slot live at its own n_past
        for p in prompts[:8]:
            srv.submit(p[:100], 4, stop_tokens=())
        srv._admit()
        B = srv.max_batch  # noqa: N806
        step = srv._load_chunk(64, [True] * B, [10 ** 6] * B, ())
        step()  # the ring grew: a new capture
        report = decode_step_report(step)
        for mode in ("eager", "graphed"):
            report[mode].pop("ordered")
        g = report["graphed"]["device_ms_by_group"]
        out[kv] = dict(
            warmup_s=warmup_s, wall_s=wall, requests=len(reqs),
            generated_tokens=n_tok, tokens_per_s=n_tok / wall,
            ttft_ms=[(r.first_token_s - r.submitted_s) * 1e3 for r in reqs],
            chunks=chunk_calls,
            ms_per_chunk_step=chunk_s * 1e3 / (chunk_calls * 8),
            admit_ms_total=admit_s * 1e3, admissions=admit_calls,
            eager=dict(wall_s=e_wall, tokens_per_s=n_tok / e_wall,
                       ms_per_chunk_step=e_chunk.wall_s * 1e3
                       / (e_chunk.calls * 8), streams_equal=True),
            step_b8=report,
            step_b8_k5_device_ms=g and g["decode_attention"],
            step_b8_k6_device_ms=g and g["scatter_rows"],
            step_b8_k1_device_ms=g and g["q4_core"])
        del srv
        torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# phase 5: card against CPU
# ---------------------------------------------------------------------------


class PartTimer:
    """Seconds of each part of phase 5, by device: the CPU side is most of
    the phase, and its parts are what a cut of depth or tokens shortens."""

    def __init__(self):
        self.seconds = collections.Counter()

    def __call__(self, part: str, dev: str, fn):
        a = time.perf_counter()
        out = fn()
        self.seconds[f"{part} {dev}"] += time.perf_counter() - a
        return out


def phase_card_vs_cpu(clock: PartTimer):
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
        streams[dev] = clock("gpt-j f32 stream", dev, lambda: InferenceEngine(
            cfg, params, kv_dtype="int8", device=dev).generate(
                prompt, 8, SamplingParams(greedy=True)).token_ids)
    if streams["cuda"] != streams["cpu"]:
        fail(f"f32 greedy streams differ: card {streams['cuda']} "
             f"cpu {streams['cpu']}")
    out["f32_greedy_tokens"] = streams["cuda"]
    # serving: 4 prompts on 3 slots (one waits for a slot), 6 tokens each.
    # Random weights give the odd near-tie, where card and CPU f32 sums may
    # pick different tokens (range(300, 320) has a top-2 logit margin of
    # 3e-4 of max|logit| at its third step): every greedy step of these
    # prompts has a margin above 2e-3 on the CPU.
    prompts = [prompt, list(range(7, 10)), list(range(1000, 1020)), [42]]
    served = {}
    for dev in ("cuda", "cpu"):
        res = clock("gpt-j serving", dev, lambda: ServingEngine(
            cfg, params, max_batch=3, kv_dtype="int8", device=dev).run(
                prompts, 6, stop_tokens=(), chunk_steps=4))
        served[dev] = [res[i].generated for i in sorted(res)]
    eng = InferenceEngine(cfg, params, kv_dtype="int8", device="cuda")
    single = [eng.generate(p, 6, SamplingParams(greedy=True)).token_ids
              for p in prompts]
    if not served["cuda"] == served["cpu"] == single:
        fail(f"f32 serving streams differ: card {served['cuda']} cpu "
             f"{served['cpu']} card InferenceEngine {single}")
    out["f32_serving_tokens"] = served["cuda"]
    cfg = base.replace(compute_dtype="bfloat16")
    logits = {}
    for dev in ("cuda", "cpu"):
        logits[dev] = torch.from_numpy(clock(
            "gpt-j bf16 logits", dev, lambda: InferenceEngine(
                cfg, params, kv_dtype="int8", device=dev).generate(
                    prompt, 1, return_logits=True).logits))
    if not torch.isfinite(logits["cuda"]).all():
        fail("bf16 logits on the card are not finite")
    err, rel = rel_err(logits["cuda"], logits["cpu"])
    if rel > TOL_LOGITS_BF16:
        fail(f"bf16 logits card vs cpu: max|err| {err:.3g} (rel {rel:.3g} > "
             f"{TOL_LOGITS_BF16})")
    out["bf16_logits_max_abs_err"] = err
    out["bf16_logits_rel_err"] = rel
    return out


# f32 greedy steps of this prompt at Pythia-12B width, depth 2, seed-1
# weights: every top-2 logit margin on the CPU is at least 8e-3 of
# max|logit|, for each engine
PYTHIA_PROMPT = [50, 1201, 7, 40000, 333, 9, 2024, 11]
# the gi engine's bf16 logits: more than 8 tokens, so that its prefill takes
# K2's tensor-core instance (K1 takes n <= 8 rows)
PYTHIA_LOGITS_PROMPT = {"gi": PYTHIA_PROMPT + [3000, 17, 29, 4242]}


def phase_pythia_card_vs_cpu(clock: PartTimer):
    """Pythia-12B width at depth 2, card vs CPU, for phase 7's three
    engines: f32 greedy streams identical, bf16 prompt logits within
    TOL_LOGITS_BF16.  An 8-token prompt takes K11 and K10 in the prefill
    too; the gi engine's 12-token logits prompt K2 on the tensor cores."""
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params
    from vsim_tpu_torch.ops.q4_cuda import set_dequant_math

    base = PRESETS["pythia-12b"].replace(n_layer=2, n_ctx=64)
    params = random_q4_params(base, seed=1, device="cpu")
    out = {}
    for name, (kw, math_name, _) in PYTHIA_ENGINES.items():
        prompt = PYTHIA_LOGITS_PROMPT.get(name, PYTHIA_PROMPT)
        set_dequant_math(math_name)
        try:
            streams, logits = {}, {}
            for dev in ("cuda", "cpu"):
                cfg = base.replace(compute_dtype="float32")
                streams[dev] = clock(
                    f"pythia-12b {name} f32 stream", dev,
                    lambda: InferenceEngine(
                        cfg, params, kv_dtype="int8", device=dev,
                        **kw).generate(PYTHIA_PROMPT, 6, SamplingParams(
                            greedy=True)).token_ids)
                cfg = base.replace(compute_dtype="bfloat16")
                logits[dev] = torch.from_numpy(clock(
                    f"pythia-12b {name} bf16 logits", dev,
                    lambda: InferenceEngine(
                        cfg, params, kv_dtype="int8", device=dev,
                        **kw).generate(prompt, 1, return_logits=True).logits))
        finally:
            set_dequant_math("gi")
        if streams["cuda"] != streams["cpu"]:
            fail(f"pythia-12b {name} f32 greedy streams differ: card "
                 f"{streams['cuda']} cpu {streams['cpu']}")
        if not torch.isfinite(logits["cuda"]).all():
            fail(f"pythia-12b {name} bf16 logits on the card are not finite")
        err, rel = rel_err(logits["cuda"], logits["cpu"])
        if rel > TOL_LOGITS_BF16:
            fail(f"pythia-12b {name} bf16 logits card vs cpu: max|err| "
                 f"{err:.3g} (rel {rel:.3g} > {TOL_LOGITS_BF16})")
        out[name] = dict(f32_greedy_tokens=streams["cuda"],
                         bf16_logits_prompt_tokens=len(prompt),
                         bf16_logits_max_abs_err=err, bf16_logits_rel_err=rel)
    torch.cuda.empty_cache()
    return out


def phase_train_card_vs_cpu(clock: PartTimer):
    """Three f32 training steps at Pythia-410M width, depth 2, on the card
    and on the CPU from the same init and batch."""
    import torch

    from vsim_tpu_torch.engine.train import float_leaves, make_train_step
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import init_params

    cfg = PRESETS["pythia-410m"].replace(n_layer=2, n_ctx=256)
    ids = torch.randint(0, cfg.n_vocab, (2, 257),
                        generator=torch.Generator().manual_seed(3))
    runs = {}
    for dev in ("cuda", "cpu"):
        a = time.perf_counter()
        params = init_params(cfg, seed=2, device=dev)
        init_fn, step_fn = make_train_step(cfg)
        state = init_fn(params)
        losses, grads = [], {}
        for i in range(3):
            _, state, loss = step_fn(params, state, ids.to(dev))
            losses.append(float(loss))
            if i == 0:
                for name, t in float_leaves(params).items():
                    if t.grad is None:
                        fail(f"training on {dev}: no gradient for {name}")
                    grads[name] = t.grad.detach().cpu()
        runs[dev] = losses, grads
        del params, state
        clock.seconds[f"pythia-410m training {dev}"] += time.perf_counter() - a
    (l_gpu, g_gpu), (l_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    if not all(math.isfinite(x) for x in l_gpu):
        fail(f"training losses on the card: {l_gpu}")
    rel0 = abs(l_gpu[0] - l_cpu[0]) / abs(l_cpu[0])
    if rel0 > TOL_TRAIN_LOSS0:
        fail(f"step-0 loss card {l_gpu[0]} vs cpu {l_cpu[0]} (rel {rel0:.3g})")
    top = max(g.abs().max().item() for g in g_cpu.values())
    grad_rel = {}
    for name, ref in g_cpu.items():
        scale = ref.abs().max().item()
        err = (g_gpu[name] - ref).abs().max().item()
        grad_rel[name] = err / max(scale, 1e-30)
        if err > TOL_TRAIN_GRAD * scale + 1e-6 * top:
            fail(f"step-0 gradient {name}: card vs cpu max|err| {err:.3g}, "
                 f"max|grad| {scale:.3g}")
    rels = [abs(a - b) / abs(b) for a, b in zip(l_gpu[1:], l_cpu[1:])]
    if max(rels) > TOL_TRAIN_LOSS:
        fail(f"training losses card {l_gpu} vs cpu {l_cpu}")
    return dict(losses_card=l_gpu, losses_cpu=l_cpu, loss0_rel_err=rel0,
                loss_rel_err=rels, grad_rel_err_max=max(grad_rel.values()),
                grad_rel_err=grad_rel)


# ---------------------------------------------------------------------------
# phase 6: training and perplexity at full size
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def _kernel_class(name: str) -> str:
    if "flash_bwd_dq" in name:
        return "K7 dq"
    if "flash_bwd_dkv" in name:
        return "K8 dk/dv"
    if "flash_fwd" in name:
        return "K4 forward"
    if any(w in name.lower() for w in ("gemm", "cutlass", "xmma")):
        return "matmuls (cuBLAS)"
    return "other PyTorch kernels"


def phase_training(peaks):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vsim_tpu_torch.engine.evaluate import perplexity
    from vsim_tpu_torch.engine.train import float_leaves, make_train_step
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import init_params, random_q4_params
    from vsim_tpu_torch.ops import _build

    cfg = PRESETS["pythia-410m"]
    L, E, T = cfg.n_layer, cfg.n_embd, cfg.n_ctx  # noqa: N806
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    init_fn, step_fn = make_train_step(cfg)
    state = init_fn(params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in float_leaves(params).values())
    B = 4  # noqa: N806
    ids = torch.randint(0, cfg.n_vocab, (B, T + 1),
                        generator=torch.Generator().manual_seed(0)).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, launches = [], [], []
    for _ in range(5):
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        a = time.perf_counter()
        _, state, loss = step_fn(params, state, ids)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - a)
        launches.append(dict(_build.launch_counts))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"training losses {losses}: not finite or not falling")
    for i, counts in enumerate(launches):
        for name in TRAIN_KERNELS:
            if counts.get(name, 0) != L:
                fail(f"training step {i}: {name} launched "
                     f"{counts.get(name, 0)} times, not {L}: {counts}")
    step_med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tokens = B * T
    # model FLOPs: 6 per weight and token in the matmuls (lm head included,
    # embedding gather not), attention 12 D per visible (query, key) pair
    # and layer (forward q.k and p.v, backward four products)
    mm_params = L * (4 * E * E + 2 * E * cfg.n_ff) + cfg.n_vocab * E
    pairs = B * cfg.n_head * T * (T + 1) // 2
    flops = 6 * mm_params * tokens + 12 * cfg.head_dim * pairs * L
    # where one step's device time goes (torch.profiler; None if it records
    # no device activity)
    by_class, by_name = collections.Counter(), collections.Counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, state, loss = step_fn(params, state, ids)
        torch.cuda.synchronize()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = (ev.time_range.end - ev.time_range.start) / 1e3
            by_class[_kernel_class(ev.name)] += ms
            by_name[ev.name[:60]] += ms
    train = dict(
        batch=B, seq=T, tokens_per_step=tokens, params=n_params,
        setup_s=setup_s, losses=losses, step_s=step_s,
        step_ms_median=step_med * 1e3, tokens_per_s=tokens / step_med,
        peak_memory_gb=peak_gb, model_flops_per_step=flops,
        model_flop_share_f32_peak=flops / step_med / peaks[2],
        launches_per_step=launches[0],
        device_ms_by_class=dict(by_class) or None,
        device_ms_top_kernels=dict(by_name.most_common(10)) or None)
    del params, state, ids, prof
    torch.cuda.empty_cache()

    q4 = random_q4_params(cfg, seed=0)
    stream = torch.randint(0, cfg.n_vocab, (4096,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    _build.reset_launch_counts()
    a = time.perf_counter()
    ppl = perplexity(cfg, q4, stream, window=T)
    ppl_s = time.perf_counter() - a
    ppl_launches = dict(_build.launch_counts)
    if not math.isfinite(ppl["ppl"]) or ppl["tokens"] != 4095:
        fail(f"perplexity {ppl}")
    if ppl_launches.get("flash_attention", 0) == 0:
        fail(f"perplexity never launched flash_attention: {ppl_launches}")
    del q4
    torch.cuda.empty_cache()
    total = collections.Counter()
    for counts in launches:
        total.update(counts)
    total.update(ppl_launches)
    ppl.update(seconds=ppl_s, windows=len(range(0, len(stream) - 1, T - 1)),
               launches=ppl_launches)
    return dict(train=train, perplexity=ppl), total


# ---------------------------------------------------------------------------
# phase 7: Pythia-12B at full width through three engines
# ---------------------------------------------------------------------------

# engine: (InferenceEngine options, dequant math, the kernels it must launch)
PYTHIA_ENGINES = {
    "stacked": (dict(unroll_layers=False), "gi",
                ("q4_matmul_stacked", "q4_matmul_i", "decode_attention",
                 "flash_attention", "scatter_rows")),
    "f32xf": ({}, "f32xf", ("q4_mlp_ps", "q4_matmul_ps", "decode_attention",
                            "flash_attention", "scatter_rows")),
    "gi": ({}, "gi", ("q4_gemv_ps", "q4_matmul_ps", "decode_attention",
                      "flash_attention", "scatter_rows")),
}


def q4_step_bytes(params) -> int:
    """The Q4 weight bytes one decode step reads: every layer's matmuls
    (one layer of a stacked weight for each Q4Layer) and the lm head."""
    from vsim_tpu_torch.ops.matmul import Q4Layer
    from vsim_tpu_torch.quant.q4 import Q4Tensor

    def nbytes(t):
        if isinstance(t, Q4Layer):
            return t.stacked.nbytes // t.stacked.packed.shape[0]
        return t.nbytes if isinstance(t, Q4Tensor) else 0

    return sum(nbytes(t) for lp in params["layers"] for t in lp.values()) \
        + params["lm_head"].nbytes


def stacked_last_layer_check(params):
    """K10 on the last layer of the stacked engine's own weights (the
    largest layer offset in the stack), each matmul at n=1 under both
    plane contracts, against its plain version: (max|err|, rel) worst."""
    import torch

    from vsim_tpu_torch.ops.q4_cuda import (q4_matmul_stacked,
                                            q4_matmul_stacked_plain)

    lp = params["layers"][-1]
    g = torch.Generator(device="cuda")
    g.manual_seed(35)
    worst = (0.0, 0.0)
    for wname, bname in (("w_qkv", "b_qkv"), ("wo", "bo"), ("w_fc", "b_fc"),
                         ("w_proj", "b_proj")):
        w, b = lp[wname], lp.get(bname)
        if int(w.il) != len(params["layers"]) - 1:
            fail(f"stacked {wname}: the last layer's index is {int(w.il)}")
        b = None if b is None else b.to(torch.float32).contiguous()
        K = w.stacked.packed.shape[1] * 2  # noqa: N806
        x = torch.randn((1, K), generator=g, device="cuda").to(torch.bfloat16)
        for r in (False, True):
            args = (x, w.stacked.packed, w.stacked.scales, w.il, b, r)
            got, ref = q4_matmul_stacked(*args), q4_matmul_stacked_plain(*args)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            if not torch.isfinite(got).all() or rel > TOL_Q4:
                fail(f"q4_matmul_stacked {wname} last layer planes="
                     f"{'bf16' if r else 'f32'}: max|err| {err:.3g} (rel "
                     f"{rel:.3g} > {TOL_Q4})")
            worst = max(worst, (err, rel))
    return worst


# device kernels of the redesigned ops, by the names the profiler reports:
# K3 or K5 (the one a path runs: phase 4's serving step K5, phase 7's K3)
# and K2's three instances and its split reduce
STEP_KERNELS = {"decode_attention": ("decode_split_kernel",
                                     "decode_combine_kernel"),
                "q4_matmul_ps": ("ps_gemv_kernel", "ps_mma_kernel",
                                 "matmul_ps_kernel",
                                 "ps_split_reduce_kernel"),
                # K1 and K11 (both launches): csrc/q4_core.cuh
                "q4_core": ("q4_core_kernel",),
                # K9 and K10: csrc/q4_matmul_i.cu
                "q4_i": ("q4_i_kernel",),
                # K6: csrc/kv_scatter_rows.cu (every layer's rows after
                # the serving step; one layer's in InferenceEngine's step)
                "scatter_rows": ("scatter_rows_kernel",),
                # PyTorch's gather and scatter_ (the sampler's, and the
                # index route a one-token row write took before K6)
                "index_kernels": ("scatter_gather_elementwise",)}


def step_device_profile(step, steps: int = 3):
    """Device busy ms (the union of kernel and copy intervals), device ms by
    kernel and by each group of STEP_KERNELS of one step, from
    torch.profiler over ``steps`` steps, and each group's kernels' ms in
    the order they started; (None, None, None, None) where the profiler
    records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vsim_tpu_torch.decode_profile import busy_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    intervals, by_name = [], collections.Counter()
    by_group = dict.fromkeys(STEP_KERNELS, 0.0)
    started = {group: [] for group in STEP_KERNELS}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            s, e = ev.time_range.start, ev.time_range.end
            intervals.append((s, e))
            by_name[ev.name[:60]] += (e - s) / 1e3 / steps
            for group, names in STEP_KERNELS.items():
                if any(k in ev.name for k in names):
                    by_group[group] += (e - s) / 1e3 / steps
                    started[group].append((s, (e - s) / 1e3))
    if not intervals:
        return None, None, None, None
    return (busy_us(intervals) / 1e3 / steps, dict(by_name.most_common(12)),
            by_group, {k: [ms for _, ms in sorted(v)]
                       for k, v in started.items()})


def k9_k10_step_ms(ordered, per_step, steps: int = 3):
    """K10's and K9's device ms a step of the stacked engine from the
    "q4_i" kernels in launch order (one kernel serves both): each step
    launches K10 per_step["q4_matmul_stacked"] times, then K9 once for the
    lm head; (None, None) when the trace holds another count."""
    k10 = per_step.get("q4_matmul_stacked", 0)
    m = k10 + per_step.get("q4_matmul_i", 0)
    if not ordered or m != k10 + 1 or len(ordered) != m * steps:
        return None, None
    k9 = sum(ordered[m - 1::m]) / steps
    return sum(ordered) / steps - k9, k9


def phase_pythia(peaks):
    """Pythia-12B (GPT-NeoX, 36 layers, E=5120, F=20480, exact GELU) at full
    width, random Q4 weights from seed 0, bf16 compute, int8 KV, n_ctx 2048,
    through the stacked-layer engine (K10, K9), the default engine under
    the f32xf math (K11, K2) and under gi (K1, K2)."""
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params
    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.ops.q4_cuda import set_dequant_math

    cfg = PRESETS["pythia-12b"].replace(compute_dtype="bfloat16")
    L = cfg.n_layer  # noqa: N806
    t0 = time.perf_counter()
    params = random_q4_params(cfg, seed=0)
    engines = {"stacked": InferenceEngine(cfg, params, kv_dtype="int8",
                                          unroll_layers=False)}
    # the f32xf and gi engines share one plane-split load
    engines["f32xf"] = engines["gi"] = InferenceEngine(cfg, params,
                                                       kv_dtype="int8")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # before any counted run: comparison launches do not count
    last_err, last_rel = stacked_last_layer_check(engines["stacked"].params)
    rng = torch.Generator().manual_seed(7)
    prompts = {n: torch.randint(0, cfg.n_vocab, (n,), generator=rng).tolist()
               for n in (8, 100, 300)}
    out = dict(setup_s=setup_s, engines={}, n_layer=L,
               k10_last_layer=dict(max_abs_err=last_err, rel_err=last_rel))
    launches = {}
    greedy = SamplingParams(greedy=True)
    for name, (kw, math_name, kernels) in PYTHIA_ENGINES.items():
        eng = engines[name]
        step_bytes = q4_step_bytes(eng.params)
        set_dequant_math(math_name)
        try:
            _build.reset_launch_counts()
            requests, streams = {}, {}
            for n, prompt in prompts.items():
                r = eng.generate(prompt, 64, greedy)
                if len(r.token_ids) != 64 or not all(
                        0 <= t < cfg.n_vocab for t in r.token_ids):
                    fail(f"pythia-12b {name} prompt {n}: bad tokens "
                         f"{r.token_ids[:8]}...")
                tm = r.timings
                streams[n] = r.token_ids
                requests[f"prompt={n}"] = dict(
                    prefill_ms=tm["prefill_s"] * 1e3,
                    decode_ms_per_token=tm["decode_s"] * 1e3
                    / (tm["tokens"] - 1), tokens=r.token_ids[:8])
            sampled = eng.generate(prompts[8], 16,
                                   SamplingParams(seed=42)).token_ids
            launches[name] = run = dict(_build.launch_counts)
            for k in kernels:
                if run.get(k, 0) == 0:
                    fail(f"pythia-12b {name} engine never launched {k}: {run}")
            # one prompt with the graph off (the f32xf and gi engines
            # share their params)
            requests["eager prompt=100"] = eager_check(
                f"pythia-12b {name}", lambda: InferenceEngine(
                    cfg, eng.params, kv_dtype="int8", cuda_graph=False,
                    **kw), prompts[100], streams[100], prompts[8], sampled)
            torch.cuda.empty_cache()

            # the decode step after a 300-token prompt, alone
            logits = eng.prefill(prompts[300])
            _, _, step = eng.start(prompts[300], logits[:, -1], greedy)
            report = decode_step_report(step)
            per_step = report["graphed"]["launches_per_step"]
            ordered_q4_i = {m: (report[m]["ordered"] or {}).get("q4_i")
                            for m in ("eager", "graphed")}
            row_write_check(f"pythia-12b {name}", report, L)
            want = {"stacked": {"q4_matmul_stacked": 4 * L,
                                "q4_matmul_i": 1},
                    "f32xf": {"q4_mlp_ps": L, "q4_matmul_ps": 2 * L + 1},
                    "gi": {"q4_gemv_ps": 4 * L + 1}}[name]
            for k, v in want.items():
                if per_step.get(k, 0) != v:
                    fail(f"pythia-12b {name}: {k} launched "
                         f"{per_step.get(k, 0)} times a step, not {v}")
            for mode in ("eager", "graphed"):
                ordered = ordered_q4_i[mode]
                k10_ms, k9_ms = (k9_k10_step_ms(ordered, per_step)
                                 if ordered else (None, None))
                report[mode].update(k10_device_ms=k10_ms, k9_device_ms=k9_ms)
        finally:
            set_dequant_math("gi")
        bound_ms = step_bytes / peaks[0] * 1e3
        out["engines"][name] = dict(
            math=math_name, requests=requests,
            weight_bytes_per_step=step_bytes, bound_ms_per_token=bound_ms,
            step=report)
        torch.cuda.empty_cache()
    del engines
    torch.cuda.empty_cache()
    total = collections.Counter()
    for counts in launches.values():
        total.update(counts)
    return out, launches, total


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
    "flash_attention_bwd_dq": ("vsim_tpu_torch/csrc/flash_attention_bwd.cu",
                               "vsim_tpu/ops/attention.py:196",
                               "B=4 T=2048 H=16 D=64 float32"),
    "flash_attention_bwd_dkv": ("vsim_tpu_torch/csrc/flash_attention_bwd.cu",
                                "vsim_tpu/ops/attention.py:236",
                                "B=4 T=2048 H=16 D=64 float32"),
    "q4_matmul_i": ("vsim_tpu_torch/csrc/q4_matmul_i.cu",
                    "vsim_tpu/ops/pallas_q4.py:110",
                    "pythia-12b lm_head n=1 5120->51200"),
    "q4_matmul_stacked": ("vsim_tpu_torch/csrc/q4_matmul_i.cu",
                          "vsim_tpu/ops/pallas_q4.py:953",
                          "pythia-12b fc il=1 of 2 n=1 5120->20480 "
                          "x=bfloat16 planes=f32"),
    "q4_mlp_ps": ("vsim_tpu_torch/csrc/q4_mlp_ps.cu",
                  "vsim_tpu/ops/pallas_q4.py:679",
                  "pythia-12b E=5120 F=20480 gelu_exact n=1"),
    "q4_lab_gemv": ("vsim_tpu_torch/csrc/q4_lab.cu", "tools/kernel_lab.py:489",
                    "gpt-j-6b fc u16 n=1 4096->16384"),
    "q4_lab_dma": ("vsim_tpu_torch/csrc/q4_lab.cu", "tools/kernel_lab.py:489",
                   "gpt-j-6b fc dma n=1 4096->16384"),
    "pair_bitcast": ("vsim_tpu_torch/csrc/q4_lab.cu", "tools/pair_probe.py:53",
                     "pair_probe probe bitcast KH=256 O=256"),
    "q4_batch_lab": ("vsim_tpu_torch/csrc/q4_batch_lab.cu",
                     "tools/batch_lab.py:174",
                     "gpt-j-6b batch 2d/f32x n=64 4096->16384"),
    "attn_lab": ("vsim_tpu_torch/csrc/attn_lab.cu", "tools/attn_lab.py:159",
                 "attn_lab gpt-j-6b vpu3d L=28 B=32 H=16 D=256 S=128"),
}
ROW_KERNEL = {"q4_gemv_ps": "q4_gemv_ps", "q4_matmul_ps": "q4_matmul_ps",
              "decode_attention_q": "decode_attention",
              "flash_attention_fwd": "flash_attention",
              "decode_attention_fresh": "decode_attention_fresh",
              "scatter_rows": "scatter_rows",
              "flash_attention_bwd_dq": "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv": "flash_attention_bwd_dkv",
              "q4_matmul_i": "q4_matmul_i",
              "q4_matmul_stacked": "q4_matmul_stacked",
              "q4_mlp_ps": "q4_mlp_ps", "q4_lab_gemv": "q4_lab_gemv",
              "q4_lab_dma": "q4_lab_dma", "pair_bitcast": "pair_bitcast",
              "q4_batch_lab": "q4_batch_lab", "attn_lab": "attn_lab"}


def sass_check():
    """Every instance of K9/K10's kernel in the built library runs the
    tensor cores (HMMA) and converts no integer to a float (or back)
    between its first and last HMMA, where its loop runs; every instance of
    K15's and of K12's runs HMMA (``tools/sass_ops.py`` on
    ``build/kernels``): {function: opcode counts}, one dict a kernel."""
    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.tools import sass_ops

    found = {fn: got for fn, got in sass_ops.count_lib(
        _build._lib_path("q4_matmul_i")).items() if "q4_i_kernel" in fn}
    if not found:
        fail("sass: no q4_i_kernel instance in the K9/K10 library")
    for fn, got in found.items():
        if not got["ops"]["HMMA"] or sass_ops.convert_in_mma_span(got):
            fail(f"sass {fn}: HMMA {got['ops']['HMMA']}, conversions at "
                 f"{got['convert_at']} inside the HMMA span {got['hmma']}")
    batch = {fn: got for fn, got in sass_ops.count_lib(
        _build._lib_path("q4_batch_lab")).items() if "batch_kernel" in fn}
    if len(batch) != len(BATCH_INSTANCES):
        fail(f"sass: {len(batch)} instances of K15's kernel, not "
             f"{len(BATCH_INSTANCES)}")
    for fn, got in batch.items():
        if not got["ops"]["HMMA"]:
            fail(f"sass {fn}: K15 runs no HMMA")
    lab = {fn: got for fn, got in sass_ops.count_lib(
        _build._lib_path("q4_lab")).items() if "lab_gemv_kernel" in fn}
    if len(lab) != K12_INSTANCES:
        fail(f"sass: {len(lab)} instances of K12's kernel, not "
             f"{K12_INSTANCES}")
    for fn, got in lab.items():
        if not got["ops"]["HMMA"]:
            fail(f"sass {fn}: K12 runs no HMMA")
    return ({fn: got["ops"] for fn, got in found.items()},
            {fn: got["ops"] for fn, got in batch.items()},
            {fn: got["ops"] for fn, got in lab.items()})


# K12's instances (csrc/q4_lab.cu): ten maths on the "i" layout and f32x on
# "w32", "ps" and "res", each at 1, 2 and 4 n-tiles
K12_INSTANCES = (10 + 3) * 3
# K15's instances: (n-tiles, math, band) of csrc/q4_batch_lab.cu
BATCH_INSTANCES = [(nt, m, b) for nt in (1, 2, 4, 8, 16) for m in range(3)
                   for b in (0, 1)]


def batch_sass_lines(batch):
    """One line a math: the opcodes of K15's 2d instances at 8 and 16
    n-tiles (n = 64 and 128), read from the mangled template arguments."""
    from vsim_tpu_torch.ops.q4_batch_lab import BATCH_MATHS

    lines = []
    for m, name in enumerate(BATCH_MATHS):
        parts = []
        for fn, ops in batch.items():
            got = re.search(r"batch_kernelILi(\d+)ELi(\d)ELb(\d)E", fn)
            if got and int(got[2]) == m and got[3] == "0" and got[1] in (
                    "8", "16"):
                parts.append(f"nt {got[1]}: " + ", ".join(
                    f"{op} {c}" for op, c in ops.items() if c))
        lines.append(f"  sass K15 2d {name}: " + "; ".join(sorted(parts)))
    return lines


def kernel_line(rows, launches):
    """One entry per kernel, at the representative shape named in
    KERNEL_META (every shape is in build/chip_smoke.json); ``launches``
    sums the launch counts of the driven paths."""
    out = []
    for name, (src, replaces, shape) in KERNEL_META.items():
        # attn_lab's einsum rows ran no kernel; any other name must be known
        mine = [r for r in rows if r["kernel"] is not None
                and ROW_KERNEL[r["kernel"]] == name]
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
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "vsim_tpu_torch")):
        fail("vsim_tpu_torch/ is missing: run from a checkout of the repo")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
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
    sass, sass_batch, sass_lab = sass_check()
    hmma = sorted(ops["HMMA"] for ops in sass.values())
    print(f"sass: {len(sass)} instances of K9/K10's kernel, HMMA "
          f"{hmma[0]}-{hmma[-1]} each, no I2F/I2FP/F2I between the first "
          f"and last HMMA; {len(sass_batch)} of K15's and {len(sass_lab)} of "
          "K12's, HMMA in each", flush=True)
    for line in batch_sass_lines(sass_batch):
        print(line, flush=True)
    t0 = time.perf_counter()
    rows = phase_kernels(peaks)
    print(f"kernel phase: {len(rows)} cases pass in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for r in rows:  # the redesigned kernels, with their ratio to the library
        if r["kernel"] in CORE_ROWS:
            print(f"  {r['kernel']} {r['shape']}: {r['ms']:.4g} ms, bound "
                  f"{r['bound_ms']:.2g}, flat read {r['flat_ms']:.4g} "
                  f"({r['vs_flat']:.2f}x), plain {r['plain_ms']:.4g}, "
                  f"library {r['library_ms']:.4g} "
                  f"({r['ms'] / r['library_ms']:.2f}x)", flush=True)
        if r["kernel"] in ("decode_attention_q", "flash_attention_fwd",
                           "decode_attention_fresh", "q4_matmul_ps",
                           "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"):
            extra = "" if r.get("instance") is None else (
                f" [{r['instance']}"
                + ("" if r["bound_3xtf32_ms"] is None
                   else f", 3xTF32 bound {r['bound_3xtf32_ms']:.3g}")
                + ("" if r["rel_err_vs_f64"] is None else ", vs f64 "
                   + json.dumps({k: [float(f"{x:.2e}") for x in v] for k, v
                                 in r["rel_err_vs_f64"].items()})) + "]")
            print(f"  {r['kernel']} {r['shape']}: {r['ms']:.4g} ms, bound "
                  f"{r['bound_ms']:.2g}, plain {r['plain_ms']:.4g}, library "
                  f"{r['library_ms']:.4g} ({r['ms'] / r['library_ms']:.2f}x)"
                  f"{extra}", flush=True)
    t0 = time.perf_counter()
    lab_rows, lab_launches = phase_labs(peaks)
    print(f"lab phase: {len(lab_rows)} cases pass in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in lab_summary(lab_rows, peaks) + k12_lines(lab_rows):
        print(line, flush=True)
    rows += lab_rows
    floor_ms = launch_floor_ms()
    for line in launch_floor_lines(rows, floor_ms):
        print(line, flush=True)
    t0 = time.perf_counter()
    model, launches, cfg, params = phase_model(peaks)
    print(f"InferenceEngine in {time.perf_counter() - t0:.1f} s "
          f"(GPT-J-6B, bound {model['step']['bound_ms_per_token']:.3f} ms "
          "a token)", flush=True)
    for k, v in model["requests"].items():
        print(f"  {k}: {json.dumps(v)}", flush=True)
    for kv, rep in (("int8", model["step"]), ("int4", model["step_int4"])):
        print(step_line(f"{kv} step at n_past 300", rep), flush=True)
        print(k6_step_line(kv, rep, cfg.n_layer), flush=True)
    t0 = time.perf_counter()
    serving, serve_launches = phase_serving(cfg, params)
    del params
    graph_floor_ms = graph_launch_floor_ms()
    print(f"ServingEngine in {time.perf_counter() - t0:.1f} s", flush=True)
    for k, v in serving.items():
        print(f"  {k}: graphed {v['tokens_per_s']:.1f} tokens/s, "
              f"{v['ms_per_chunk_step']:.2f} ms a chunk step, TTFT "
              f"{min(v['ttft_ms']):.1f}-{max(v['ttft_ms']):.1f} ms; eager "
              f"{v['eager']['tokens_per_s']:.1f} tokens/s, "
              f"{v['eager']['ms_per_chunk_step']:.2f} ms a chunk step; "
              "streams equal", flush=True)
        print(step_line(f"{k} B=8 step", v["step_b8"]), flush=True)
        k6 = v["step_b8_k6_device_ms"]
        print(f"  {k}: K6 {'null' if k6 is None else f'{k6 * 1e3:.2f}'} us "
              f"in the replayed step, an empty kernel "
              f"{graph_floor_ms * 1e3:.2f} us a launch in a graph "
              f"({floor_ms * 1e3:.2f} us alone); K5 "
              f"{v['step_b8_k5_device_ms']} ms, K1 "
              f"{v['step_b8_k1_device_ms']} ms", flush=True)
    t0 = time.perf_counter()
    clock = PartTimer()
    vs_cpu = phase_card_vs_cpu(clock)
    vs_cpu["training"] = phase_train_card_vs_cpu(clock)
    vs_cpu["pythia-12b"] = phase_pythia_card_vs_cpu(clock)
    vs_cpu["seconds"] = {k: round(v, 1) for k, v in clock.seconds.items()}
    cpu_s = sum(v for k, v in clock.seconds.items() if k.endswith(" cpu"))
    print(f"card vs cpu, seconds by part (CPU side {cpu_s:.1f} s): "
          f"{json.dumps(vs_cpu['seconds'])}", flush=True)
    print(f"card vs cpu in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(vs_cpu)}", flush=True)
    t0 = time.perf_counter()
    training, train_launches = phase_training(peaks)
    print(f"training and perplexity in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(training)}", flush=True)
    t0 = time.perf_counter()
    pythia, pythia_launches, pythia_total = phase_pythia(peaks)
    print(f"Pythia-12B engines in {time.perf_counter() - t0:.1f} s "
          f"(setup {pythia['setup_s']:.1f} s), K10 on the last layer: "
          f"{json.dumps(pythia['k10_last_layer'])}", flush=True)
    for k, v in pythia["engines"].items():
        print(f"  {k}: {json.dumps(v['requests'])}", flush=True)
        print(step_line(f"{k} step at n_past 300", v["step"]), flush=True)
        print(k6_step_line(k, v["step"], pythia["n_layer"]), flush=True)
        g = v["step"]["graphed"]
        print(f"  {k}: K10 {g['k10_device_ms']} ms, K9 {g['k9_device_ms']} "
              f"ms of the replayed step's {g['device_busy_ms']} device ms; "
              f"bound {v['bound_ms_per_token']:.3f} ms", flush=True)

    total = collections.Counter(launches)
    for counts in serve_launches.values():
        total.update(counts)
    total.update(train_launches)
    total.update(pythia_total)
    total.update(lab_launches)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernel_rows=rows, model=model,
                       launches_inference=launches, serving=serving,
                       launches_serving=serve_launches, card_vs_cpu=vs_cpu,
                       training=training, pythia=pythia,
                       launches_pythia=pythia_launches,
                       launches_labs=lab_launches,
                       timings_unheld=UNHELD[0], ptxas=reports,
                       sass_k9_k10=sass, sass_k15=sass_batch,
                       sass_k12=sass_lab,
                       launch_floor_ms=floor_ms,
                       graph_launch_floor_ms=graph_floor_ms), f,
                  indent=1)
    print(f"chip_smoke: all phases pass in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernel_line(rows, total)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
