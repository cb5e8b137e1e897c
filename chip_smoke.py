#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vsim_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure.  The full-size random weights of phases 3
(GPT-J-6B, shared by 4, 10 and 11), 6 and 7 (Pythia-12B, shared by 9 and
10) are drawn on the card from their seed (``rng="device"``); phase 9's
other architectures keep numpy's draw, as phase 10's strict CodeGen-2B f32
run needs (on the card's draw its stream meets a top-2 margin of 8.8e-5 at
token 42, a near-tie that equality cannot tell from a fault):
  1. print the card's name and power limit (nvidia-smi) and build the
     kernels from csrc/ (one nvcc per library, all at once, into build/;
     the lab's three build beside phase 2 and are waited for after it);
     then, after phase 2,
     every instance of K9/K10's kernel must run HMMA and convert nothing
     between its first and last HMMA, and every instance of K15's must run
     HMMA, and so must every instance of K12's and of K2's TF32 kernel
     (tools/sass_ops.py on the build; K15's opcode counts printed by math);
  2. kernels: each of K1-K6 at GPT-J-6B shapes (K2 at 1 and 8 rows under
     both plane contracts and at 9-128 rows with bf16 planes; its TF32
     instance, f32 planes past 8 rows, with f32 x at 16 and 128 rows there
     and at Pythia-12B's shapes with bf16 x at 100 rows and f32 x at 20 and
     100, each beside its TF32 and f32 FMA bounds: k2_tf32_rows, also
     ``chip_smoke.py --k2-tf32`` alone; K5 on the B=8 ragged step, on
     phase 4's timed step and at B=1), K4 and K7/K8 (the flash
     backward) also at the Pythia-410M shapes of phase 6 (B=4 training,
     B=1 perplexity; f32 and bf16), K4 at every f32 shape of K7/K8 (each
     f32 K4 row on "mma_3xtf32", its 3xTF32 bound beside its f32 FMA one:
     k4_row) and K7/K8 at GPT-J's, in bf16 also at
     T=2048 for D = 80, 128 and 256 (each bf16 row on "mma_bf16", every
     element within 2^-8 of max|plain| and at most 2% of them differing
     from the plain version), in f32 at T=2048 for D = 256, 80 and 96
     (every f32 row on "mma_3xtf32", beside an f64 backward); K1-K4 and
     K9-K11 at the
     Pythia-12B shapes phase 7 gives them (K1 at 1 and 8 rows, K2 at 1 and
     8 rows with f32 planes and at 100 with bf16 planes, K3 on layer 35 of
     a 36-layer int8 and int4 cache, K4 at the prompt lengths; K3 at the
     batched benchmark's shapes: GPT-J-6B B=128 int4 S=512 at n_past 8 and
     200, GPT-NeoX-20B's H=64 D=96 at B=8 with f32 q, int8 and int4; K9 and K11 at GPT-J's
     too; K1's 9-32-row instance at GPT-J's qkv and fc at 16 and 32 rows,
     each beside K2 with bf16 planes on the same rows; K10 at every stacked shape of both models at n = 1 and fc at 8,
     100 and 128 rows under both plane contracts; K1, K11, K9 and K10 with
     their ratio to the flat read of their bytes); K4 also at codegen-2b's
     D=80 and at D=72, K3 and K5 with f32 q (round_q=False) at its D=80,
     H=32; K6's two instances (every layer of the B=8 serving
     cache, and one layer at B=1 of GPT-J-6B's and Pythia-12B's, as the
     graphed one-token step calls it, and at B=128 of the batched
     benchmark's int4 step at S=512), byte for byte; each against its
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
     B=32 x 128 and B=8 x 2048 and Pythia-12B at B=1 x 2048;
     gi_batch_probe runs K1 at 16 and 32 rows beside K2 at GPT-J-6B's qkv,
     fc and proj, and attn_gate_probe K3 beside the einsum route at the
     zoo's six head dims, int8 and int4 (each checked against its plain
     version first; the probes must launch K1, K2 and K3); prints each
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
  5. card against CPU, each part's seconds printed (the CPU halves run in
     a child process, ``chip_smoke.py --cpu-refs``, from the end of the
     build on, beside the earlier phases): GPT-J width at depth
     1, f32 greedy streams must be identical (InferenceEngine, 3 tokens,
     and ServingEngine, 3 prompts on 2 slots, card vs CPU vs the card's
     InferenceEngine, 2 tokens), the batched engine's tokens (12 rows, a
     distinct prompt each, ``_prefill`` + ``_decode_many``, 2 steps,
     replayed from a graph on the card) identical, bf16 return_logits
     must agree within the stated tolerance; SpeculativeEngine at the same widths, f32, int8 KV,
     with NgramDrafter(3, 4) and with a ModelDrafter of pythia-70m's widths
     at depth 2 (gamma 4): each stream (3 tokens) equal on the card and
     the CPU and equal to the card's InferenceEngine greedy stream;
     Pythia-410M width at depth 2, three f32 training steps: losses and
     every leaf's step-0 gradient must agree; Pythia-12B width at depth 1
     through phase 7's three engines: f32 greedy streams (2 tokens)
     identical, bf16 logits within the tolerance (the gi engine's from a
     12-token prompt, whose prefill takes K2's tensor cores); BLOOM-560m's,
     GPT-2's and CodeGen-2B's widths at depth 2 (biases and GPT-2's
     positions filled with seeded values): f32 greedy streams (4 tokens)
     identical, bf16 logits within the tolerance;
  6. training: Pythia-410M at full width and depth, dense f32 weights from
     seed 0, make_train_step with the default AdamW, 5 steps on one seeded
     batch of 4 x 2049 tokens: finite losses, the last below the first, and
     K4, K7 and K8 launched once per layer in every step (at f32 the
     profiled step's K4 kernel "mma_3xtf32"'s); the same at
     bf16 compute (K7/K8 on "mma_bf16"), and GPT-J-6B's widths at depth 2
     at bf16 compute, 3 steps on 1 x 2049 tokens; GPT-J-6B's and
     CodeGen-2B's widths at depth 2 at f32 compute, 3 steps on 1 x 2049
     tokens (K7/K8 on the padded "mma_3xtf32" instances, D = 256 and 80);
     then
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
     engine's own weights is held against its plain version; after it, the
     chat CLI's engine (f32 compute, the config's f32 KV, gi) on the same
     params: the prefill of 20 and 100 tokens (every matmul K2's TF32
     instance), host ms, device busy ms and K2's device ms, beside K4's
     row at each prefill's attention shape (H=40, D=128, f32);
  8. the loading path: Pythia-12B's width at depth 4 (random Q4 params from
     seed 0) written as a reference ggml Q4_0 file (gptneox, ~1.11 GB, a
     byte-level vocab of 50688 entries) under build/, ggml_to_kmajor's host
     GB/s over its Q4 payloads, load_ggml_model's Q4 leaves byte-identical
     to the source, then AutoInference (bf16, int8 KV, the file's vocab as its
     tokenizer): a greedy text request twice, a seeded sampled one and
     return_logits, each equal bit for bit to an InferenceEngine on the
     source params, and the chat CLI (exit 0); K1-K4 and K6 must launch;
  9. the other architectures at full width, random Q4 weights on the card
     (biases and GPT-2's positions filled), bf16 compute, graphed engines,
     one model on the card at a time: BLOOM-7b1 (ALiBi, the 250,880-row
     lm head; first K1 on that head, K2 on the fused qkv with its bias,
     K3, K5 and K4 with its slopes held against their plain versions) with
     int8 KV, GPT-2 and CodeGen-2B (D = 80) with int8 and int4 KV, each
     through InferenceEngine as phase 3 (prompts of 8, 100 and 300 tokens,
     32 new tokens, a seeded sampled request twice, one prompt and the
     sampled request again with the graph off, K1, K3, K4 and K6
     launched, ids inside the vocab; the step after a 300-token prompt,
     K6 once a layer, beside the Q4 weight-byte bound); BLOOM-7b1 and
     Pythia-12B (phase 7's gi engine's params, shared, run right after
     phase 7) through a graphed ServingEngine (int8, 8 slots) under phase
     4's traffic, K1, K4, K5 and K6 launched, tokens/s and TTFT; its first
     4 prompts (16 new tokens each) then run through it and through an
     engine with the graph off: the same streams;
 10. speculative decoding at full width (SpeculativeEngine and the
     ServingEngine drafter hook, each replayed from its captured graph;
     the same tokens bit for bit with the graph off: an engine's first 16
     tokens, the serving engine's 4 prompts as in phase 9): GPT-J-6B
     (phase 3's params, right after phase 4) with NgramDrafter(3, 4) on a
     repeating prompt, 64 tokens, and the verify cycle alone after a
     300-token prompt (decode_step_report); the GPT-J-6B ServingEngine
     with NgramDrafter(3, 4) under phase 4's traffic; Pythia-12B (right
     after phase 7) with a ModelDrafter of pythia-70m's widths (its K5/K6
     steps), 48 tokens; each against the plain engine's stream by the
     split rule (``split_check``: equal up to the first position where the
     plain step's top-2 margin is no larger than the largest verify-plain
     logit gap measured before it, teacher-forced by ``route_gaps``; at
     D % 128 == 0 the plain step rounds q to bf16 and the verify does
     not); CodeGen-2B (phase 9's params) at f32 compute, where neither
     route rounds q: the speculative streams of two prompts must equal the
     plain greedy streams token for token.  Prints ms/token and tokens a
     cycle beside the plain engine's, and spec serving tokens/s beside
     phase 4's.
 11. tensor, sequence and pipeline parallelism (parallel/), last: K10,
     K9, K5, K6 and K4 first held against their plain versions at the
     shapes one rank of GPT-J-6B gives them at tp = 2 and 4; then the
     ranks, this script re-run as ``chip_smoke.py --rank JOB`` with the
     VSIM_* variables set, one process a rank: two on card 0 over gloo
     (steps eager: gloo's collectives go through the host) and, where the
     machine has four cards, four over NCCL (a card a rank, the serving
     step replayed from its graph; otherwise the phase prints that it did
     not run and why).  Each run: (a) GPT-J width at depth 2, f32, int8
     KV: the TP prefill's and the sequence-parallel forward's logits
     within 1e-4 of max|logit| of one card's, TP serving streams equal to
     one card's ServingEngine's, a 2-stage pipeline equal to
     forward_nocache bit for bit; (b) GPT-J-6B at full width (phase 3's
     seed-0 weights, bf16, int8 KV), ServingEngine(mesh=...) on 8 slots
     under phase 4's traffic (over gloo, eager, 16 new tokens a request):
     tokens/s, ms a chunk step, TTFT, each rank's
     launches (K10, K9, K5, K6 and K4 all > 0, every rank's tokens the
     same), and the streams held to phase 4's by ``split_check`` against
     the TP-to-one-card logit gap teacher-forced along them (also the gap
     of one card's stacked engine, the TP path's kernels at whole shapes).
     A rank that fails fails the phase.  ``chip_smoke.py --parallel`` runs
     phase 11 alone (after phase 4's int8 traffic, for its streams).
 12. mini-Pythia (run right after phase 6), the quantization-quality path
     through vsim_tpu_torch/tools/{train_small,kv_ppl}.py: the recipe of
     tools/train_small.py trained for MINI_STEPS steps (its schedule sized
     to them; K4 bf16, K7/K8 "mma_bf16", once a layer a step), saved and
     loaded back, the ppl table (f32, bf16, q4, q4_act_quant) over the
     first MINI_EVAL_TOKENS held-out bytes, kv_ppl at 16 windows x 512
     (K10, K9 and, over the int8 / int4 caches, K6 and K3; each step
     replayed from a CUDA graph), each kv dtype card vs CPU on 2 windows
     x 64 positions (summed NLL within TOL_KV_NLL), then K4, K7/K8, K3,
     K6, K10 and K9 against their plain versions at the phase's shapes.
     It fails unless the last step's loss is <= 2 nats, the f32 ppl <=
     e^2, Q4's <= 1.05x f32's, each cache's ppl within MINI_KV_RATIO of
     the float32 cache's, and each run launched its kernels.  Then
     tools/ref_baseline.py's export of the trained checkpoint to ggml f32
     and Q4_0 (read back: the lm head equal to the trained one and to the
     Q4 codec's bytes) and its ``ours_nll`` on 2 held-out windows of 256
     (finite, Q4 within 1.05x f32); the reference binary's steps are
     reported as not run where its tree (``reference/`` in the checkout)
     is absent.
     ``chip_smoke.py --minipythia`` runs it alone.
 13. the batched benchmark's headline path (run right after phase 10's
     GPT-J-6B parts, on phase 3's params): ``vsim_tpu_torch.bench``'s
     measuring function on GPT-J-6B, int4 KV, n_ctx 512, B=128, its loop
     pair cut to HEADLINE_STEPS steps and HEADLINE_REPS reps, each step
     replayed from the engine's batched graph; its JSON line printed;
     K2, K3, K4 and K6 launched; then one more batched run whose tokens
     must lie in the vocabulary, and its step alone, replayed and eager
     (``decode_step_report``): K2 4 a layer + 1, K3 and K6 once a layer,
     the same in both modes, device ms by kernel.
``chip_smoke.py --bwd-bf16`` runs phase 2's bf16 K7/K8 rows and phase 6's
bf16 training runs alone, their instance checks off, to take the same
numbers on an earlier tree; ``--bwd-f32`` likewise phase 2's f32 K7/K8 rows
at head dims other than 64 and 128 and phase 6's f32 runs at GPT-J-6B's and
CodeGen-2B's widths; ``--fwd-f32`` K4's f32 rows (phase 2's, and
phase 7's f32 prefill's at H=40, D=128) and phase 6's three f32 training
runs; ``--k2-tf32`` K2's TF32 rows, the f32xf
engine's stream margin (``f32xf_margin``) and phase 7's f32 prefill.
Each path's launch counts are set to 0 just before it runs and read just
after (the lab's too: K12-K16 launch only there).  Prints each phase's
seconds (phases 9 and 10 by part), the run's total seconds, a JSON line {"kernels": [...]} (K1-K16) and, last, the device line.
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
# phase 8's AutoInference looks no tokenizer up over the network: offline, a
# transformers that is installed raises, and the model file's vocab is used
os.environ["HF_HUB_OFFLINE"] = "1"
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
# K7/K8: bf16 gradients are rounded to bf16 at the store; f32 ones take each
# product as three TF32 products of split operands ("mma_3xtf32" at every
# head dim: ~1e-6 of max|plain| in tests/test_torch_flash_bwd.py's
# emulation, where one TF32 product misses 1e-4)
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



def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_peaks(name: str):
    """The card's peaks from the package's table (vsim_tpu_torch/
    device.py:PEAKS)."""
    from vsim_tpu_torch import device

    try:
        return device.card_peaks(name)
    except ValueError as e:
        fail(str(e))


def card_tf32_peak(name: str) -> float:
    from vsim_tpu_torch.device import TF32_PEAKS

    return next(v for key, v in TF32_PEAKS.items() if key in name)


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def random_q4_weight(K, O, seed):  # noqa: N803
    """A plane-split Q4 weight [K/2, O] on the card: random bytes and bf16
    scales in [0, 0.01) from ``seed``."""
    import torch

    from vsim_tpu_torch.quant.q4 import Q4Tensor

    gg = torch.Generator(device="cuda")
    gg.manual_seed(seed)
    packed = torch.randint(0, 256, (K // 2, O), generator=gg, device="cuda",
                           dtype=torch.uint8)
    scales = (torch.rand((K // 32, O), generator=gg, device="cuda")
              * 0.01).to(torch.bfloat16)
    return Q4Tensor(packed, scales, "ps")


def phase_kernels(peaks):
    import torch

    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.ops.decode_attention import (
        decode_attention_fresh, decode_attention_fresh_plain,
        decode_attention_plain, decode_attention_q, kv_int, scatter_rows,
        scatter_rows_plain)
    from vsim_tpu_torch.ops.q4_cuda import (q4_gemv_ps, q4_gemv_ps_plain,
                                            q4_matmul_ps, q4_matmul_ps_plain)
    from vsim_tpu_torch.quant.q4 import dequantize_km

    bw, bf16_peak, f32_peak = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []

    def bound(nbytes, ops, peak):
        t_b, t_o = nbytes / bw * 1e3, ops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    q4_weight = random_q4_weight
    shapes = [(name, *shape) for name, shape in GPTJ_MATMULS.items()]
    # (kernel, n, x dtype, K2's plane contract): K1 at decode and serving
    # batches; K2's GEMV at n = 1 and 8 under both contracts (f32xf, i32 /
    # f32x), its bf16-product tensor cores at 9-128 rows (gi's contract for
    # bf16 x); its TF32 instance (f32 planes past 8 rows): k2_tf32_rows
    bf16 = torch.bfloat16
    q4_cases = ([("q4_gemv_ps", n, bf16, None) for n in (1, 8)]
                + [("q4_matmul_ps", n, bf16, r) for n in (1, 8)
                   for r in (False, True)]
                + [("q4_matmul_ps", n, bf16, True) for n in (9, 16, 32, 64,
                                                             128)])
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
            wdt = bf16 if round_planes in (None, True) else torch.float32
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

    def k3_row(kv, k_store, v_store, q, n_past, round_q):
        """K3 on layer 1 of a 2-layer cache at one n_past, against its plain
        version, timed beside it and SDPA over the dequantized keys."""
        B, H, D = q.shape  # noqa: N806
        S, Dp = k_store[0].shape[3:]  # noqa: N806
        scale = 1.0 / math.sqrt(D)
        kw = dict(scale=scale, round_q=round_q)
        npv = torch.full((B,), n_past, dtype=torch.int32, device=dev)
        got = decode_attention_q(q, k_store, v_store, 1, npv, **kw)
        ref = decode_attention_plain(q, k_store, v_store, 1, npv, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        shape = (f"{kv} B={B} H={H} D={D} S={S} n_past={n_past}"
                 + ("" if round_q else " q=float32"))
        if not torch.isfinite(got).all() or rel > TOL_DECODE:
            fail(f"decode_attention_q {shape}: max|err| {err:.3g} (rel "
                 f"{rel:.3g} > {TOL_DECODE})")
        if not torch.equal(got, decode_attention_q(q, k_store, v_store, 1,
                                                   npv, **kw)):
            fail(f"decode_attention_q {shape}: differs from run to run")
        ms = timed(lambda: decode_attention_q(q, k_store, v_store, 1, npv,
                                              **kw), reps=50)
        plain_ms = timed(lambda: decode_attention_plain(
            q, k_store, v_store, 1, npv, **kw), reps=5, warmup=1)
        nk = n_past + 1
        kd = (kv_int(k_store[0][1, :, :, :nk])
              * k_store[1][1, :, :, :nk].float()[..., None]).to(torch.bfloat16)
        vd = (kv_int(v_store[0][1, :, :, :nk])
              * v_store[1][1, :, :, :nk].float()[..., None]).to(torch.bfloat16)
        qb = q.to(torch.bfloat16)[:, :, None, :]
        lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
            qb, kd, vd, scale=scale), reps=50)
        q_bytes = 2 if round_q else 4  # q as the kernel reads it, out f32
        nbytes = 2 * B * H * nk * (Dp + 2) + B * H * D * (q_bytes + 4)
        b_ms, b_by = bound(nbytes, 4 * B * H * nk * D, bf16_peak)
        return dict(kernel="decode_attention_q", shape=shape,
                    max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

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
            rows.append(k3_row(kv, k_store, v_store, q, n_past, True))
    # K3 with f32 q (round_q=False: the einsum route's numerics, which the
    # model keeps where D % 128 != 0) at codegen-2b's decode shape, int8
    H, D = 32, 80  # noqa: N806
    scale = 1.0 / math.sqrt(D)
    gg = torch.Generator(device=dev)
    gg.manual_seed(3)
    k_store, v_store = ((torch.randint(-127, 128, (L, B, H, S, D),
                                       generator=gg, device=dev,
                                       dtype=torch.int8),
                         (torch.rand((L, B, H, S), generator=gg, device=dev)
                          * 0.05).to(torch.bfloat16)) for _ in range(2))
    q = torch.randn((B, H, D), generator=gg, device=dev)
    rows.append(k3_row("int8", k_store, v_store, q, 1500, False))
    # K3 at the batched benchmark's shapes (vsim_tpu_torch/bench.py): the
    # GPT-J-6B headline step, B=128, int4, S = n_ctx 512, at n_past 8 (its
    # first step) and 200; GPT-NeoX-20B's H=64, D=96 at B=8 with f32 q
    # (D % 128 != 0), int8 and int4 (bench_matrix's gpt-neox-20b-b8)
    for kv, Bk, Hk, Dk, n_list, round_q in (
            ("int4", 128, 16, 256, (8, 200), True),
            ("int8", 8, 64, 96, (100,), False),
            ("int4", 8, 64, 96, (100,), False)):
        Dp = Dk // 2 if kv == "int4" else Dk  # noqa: N806
        vdt = torch.uint8 if kv == "int4" else torch.int8
        lo, hi = (0, 256) if kv == "int4" else (-127, 128)
        k_store, v_store = ((torch.randint(lo, hi, (L, Bk, Hk, 512, Dp),
                                           generator=gg, device=dev,
                                           dtype=vdt),
                             (torch.rand((L, Bk, Hk, 512), generator=gg,
                                         device=dev) * 0.05).to(
                                 torch.bfloat16)) for _ in range(2))
        q = torch.randn((Bk, Hk, Dk), generator=gg, device=dev)
        for n_past in n_list:
            rows.append(k3_row(kv, k_store, v_store, q, n_past, round_q))
        del k_store, v_store
    H, D = 16, 256  # noqa: N806
    scale = 1.0 / math.sqrt(D)

    # K5 (fresh-mode decode attention) and K6 (the all-layer row writer):
    # one ragged serving step at B=8, each row at its own n_past (2048 = S
    # is the inactive-slot sentinel: K5 reads all S rows, K6 writes none);
    # K5 also at phase 4's timed step (slots at n_past 38 and 100) and at B=1
    def fresh_row(kv, n_list, side, round_q=True):
        Bf = len(n_list)  # noqa: N806
        npv = torch.tensor(n_list, dtype=torch.int32, device=dev)
        Dp = D // 2 if kv == "int4" else D  # noqa: N806
        k_store, v_store = side((L, Bf, H, S, Dp)), side((L, Bf, H, S, Dp))
        fresh = (*side((Bf, H, Dp)), *side((Bf, H, Dp)))
        q = torch.randn((Bf, H, D), generator=g, device=dev)
        shape = (f"{kv} B={Bf} H={H} D={D} S={S} n_past={n_list}"
                 + ("" if round_q else " q=float32"))
        kw = dict(scale=scale, round_q=round_q)

        def run():
            return decode_attention_fresh(q, k_store, v_store, 1, npv, fresh,
                                          **kw)

        got = run()
        ref = decode_attention_fresh_plain(q, k_store, v_store, 1, npv, fresh,
                                           **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not torch.isfinite(got).all() or rel > TOL_DECODE:
            fail(f"decode_attention_fresh {shape}: max|err| {err:.3g} "
                 f"(rel {rel:.3g} > {TOL_DECODE})")
        if not torch.equal(got, run()):
            fail(f"decode_attention_fresh {shape}: differs from run to run")
        ms = timed(run, reps=50)
        plain_ms = timed(lambda: decode_attention_fresh_plain(
            q, k_store, v_store, 1, npv, fresh, **kw), reps=5, warmup=1)
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
        q_bytes = 2 if round_q else 4  # q as the kernel reads it, out f32
        nbytes = (2 * H * rows_read * (Dp + 2) + Bf * H * D * (q_bytes + 4))
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
        if kv == "int8":  # f32 q (round_q=False) at codegen-2b's D=80, H=32
            H, D = 32, 80  # noqa: N806
            scale = 1.0 / math.sqrt(D)
            fresh_row(kv, [1500], side, round_q=False)
            H, D = 16, 256  # noqa: N806
            scale = 1.0 / math.sqrt(D)
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
    # and at the batched benchmark's step: GPT-J-6B, int4, B=128, S=512,
    # every row at n_past 200, the last of 28 layers
    Bk, Sk = 128, 512  # noqa: N806

    def side4(shape):
        vals = torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)
        sc = (torch.rand(shape[:-1], generator=g, device=dev)
              * 0.05).to(torch.bfloat16)
        return vals, sc

    k_store, v_store = (side4((28, Bk, H, Sk, D // 2)) for _ in range(2))
    new = (*side4((Bk, H, D // 2)), *side4((Bk, H, D // 2)))
    npk = torch.full((Bk,), 200, dtype=torch.int32, device=dev)
    k6_rows(k_store, v_store, new, npk, 27, list(range(Bk)),
            f"one-layer gpt-j-6b int4 il=27 of 28 B={Bk} H={H} Dp={D // 2} "
            f"S={Sk} n_past=200")
    del k_store, v_store, new
    torch.cuda.empty_cache()

    # K4: prefill flash attention, H=16, D=256
    for dt in (torch.bfloat16, torch.float32):
        for T in (16, 512):  # noqa: N806
            q, k, v = (torch.randn((1, H, T, D), generator=g, device=dev)
                       .to(dt) for _ in range(3))
            rows.append(k4_row(peaks, q, k, v, f"T={T} H={H} D={D} "
                                                f"{str(dt)[6:]}"))
            del q, k, v

    rows += flash_bwd_rows(peaks, bound, g, FLASH_BWD_SHAPES)
    rows += q4_layout_rows(peaks, bound, q4_weight)
    rows += k2_tf32_rows(peaks)
    rows += pythia_attention_rows(peaks, bound)
    flat_ratios(rows)
    _build.reset_launch_counts()  # comparison launches do not count
    return rows


def k4_instance(dtype, head_dim: int) -> str:
    """K4's instance on the card (``flash_attention_fwd_route``); a tree
    without the route function ran f32 on its FMA tiles ("fma")."""
    import torch

    from vsim_tpu_torch.ops import attention

    route = getattr(attention, "flash_attention_fwd_route", None)
    if route is not None:
        return route(dtype, head_dim)
    return "mma_bf16" if dtype == torch.bfloat16 else "fma"


def k4_row(peaks, q, k, v, shape: str, strict: bool = True):
    """K4 on q, k, v ([B, H, T, D], S = T, n_past 0, no ALiBi) against its
    plain version (out and lse within TOL_FLASH_BF16 / TOL_FLASH_F32 of
    max|plain|, the same bits from run to run), timed beside the plain
    version and scaled_dot_product_attention.  Two bounds: ``bound_ms``
    (bytes, or 4 D FLOP a visible pair at the dtype's peak: bf16, or f32
    on the FMA units) and, for f32, ``bound_3xtf32_ms`` (the bytes, or
    three TF32 products per f32 product at the dense TF32 peak).  With
    ``strict`` an f32 call must take "mma_3xtf32"."""
    import torch

    from vsim_tpu_torch.ops.attention import (flash_attention_fwd,
                                              flash_attention_plain)

    B, H, T, D = q.shape  # noqa: N806
    dt, sc = q.dtype, 1.0 / math.sqrt(D)
    f32 = dt == torch.float32
    instance = k4_instance(dt, D)
    if strict and f32 and instance != "mma_3xtf32":
        fail(f"flash_attention_fwd {shape}: takes {instance}, not "
             "mma_3xtf32")
    out, lse = flash_attention_fwd(q, k, v, scale=sc)
    ref, lse_ref = flash_attention_plain(q, k, v, scale=sc)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    _, rel_lse = rel_err(lse, lse_ref)
    del ref, lse_ref
    tol = TOL_FLASH_F32 if f32 else TOL_FLASH_BF16
    if not torch.isfinite(out).all() or max(rel, rel_lse) > tol:
        fail(f"flash_attention_fwd {shape}: max|err| {err:.3g} (rel "
             f"{rel:.3g}, lse rel {rel_lse:.3g} > {tol})")
    again, lse2 = flash_attention_fwd(q, k, v, scale=sc)
    if not (torch.equal(out, again) and torch.equal(lse, lse2)):
        fail(f"flash_attention_fwd {shape}: differs from run to run")
    del out, lse, again, lse2
    ms = timed(lambda: flash_attention_fwd(q, k, v, scale=sc))
    plain_ms = timed(lambda: flash_attention_plain(q, k, v, scale=sc),
                     reps=5, warmup=1)
    lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sc))
    bw, bf16_peak, f32_peak = peaks
    ops = 4 * D * B * H * T * (T + 1) // 2
    b_ms = (4 * B * H * T * D * q.element_size() + B * H * T * 4) / bw * 1e3
    o_ms = ops / (f32_peak if f32 else bf16_peak) * 1e3
    tf32_peak = card_tf32_peak(torch.cuda.get_device_name(0))
    return dict(kernel="flash_attention_fwd", shape=shape, max_abs_err=err,
                rel_err=rel, rel_err_lse=rel_lse, ms=ms, plain_ms=plain_ms,
                bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations",
                library_ms=lib_ms, instance=instance,
                bound_3xtf32_ms=(max(b_ms, 3 * ops / tf32_peak * 1e3)
                                 if f32 else None), rel_err_vs_f64=None)


# K7/K8 (and K4 at D = 64 and at every f32 shape) against their plain
# versions at the shapes of the training and perplexity paths (Pythia-410M:
# H=16, T=S=2048, D=64, f32 and bf16; training B=4, perplexity B=1), at
# GPT-J's (T=S=512, D=256, f32 and bf16) and, at T=S=2048, at GPT-J's
# training width (H=16, D=256) and CodeGen-2B's (H=32, D=80) in both dtypes,
# Pythia-12B's (H=40, D=128) in bf16 and GPT-NeoX-20B's (H=64, D=96) in
# f32: (B, H, T, D, dtype name)
FLASH_BWD_SHAPES = ((1, 16, 2048, 64, "float32"), (4, 16, 2048, 64, "float32"),
                    (1, 16, 2048, 64, "bfloat16"),
                    (4, 16, 2048, 64, "bfloat16"),
                    (1, 16, 512, 256, "float32"),
                    (1, 16, 512, 256, "bfloat16"),
                    (1, 32, 2048, 80, "bfloat16"),
                    (1, 40, 2048, 128, "bfloat16"),
                    (1, 16, 2048, 256, "bfloat16"),
                    (1, 16, 2048, 256, "float32"),
                    (1, 32, 2048, 80, "float32"),
                    (1, 64, 2048, 96, "float32"))
# the "mma_bf16" rows' checks beside TOL_BWD_BF16: every element of dq, dk
# and dv within 2^-8 of its max|plain| of the plain version, at most 2% of
# their bf16 elements differing from the plain version's (the instance's
# hi + lo split moves 0.2-0.6% in tests/test_torch_flash_bwd.py's exact
# emulation, hi alone ~40%)
TOL_BWD_BF16_ELEM = 2.0 ** -8
MAX_BWD_BF16_DIFF_SHARE = 0.02


def flash_bwd_rows(peaks, bound, g, shapes, strict: bool = True):
    """K7/K8 against the plain backward at ``shapes`` (FLASH_BWD_SHAPES),
    and K4 (``k4_row``) at D = 64 and at every f32 shape.  The yardsticks are
    scaled_dot_product_attention and its backward (dq, dk and dv in one
    call, so both rows carry it; the plain time is likewise that of the
    whole plain backward).  Each row names its instance; the "mma_3xtf32"
    rows carry a second bound, three TF32 products per f32 product at the
    card's dense TF32 peak; f32 rows at B=1 their distance and the plain
    version's from an f64 backward; bf16 rows the share of their elements
    that differ from the plain version's, each of dq, dk, dv and all
    together.  Every row must hold its tolerance and give the same bits
    from run to run; with ``strict`` every row must also take its instance
    (bf16 "mma_bf16", f32 "mma_3xtf32") and a bf16 row hold its element and
    share checks (``--bwd-bf16`` and ``--bwd-f32`` run this on an earlier
    tree with ``strict`` off)."""
    import torch

    from vsim_tpu_torch.ops.attention import (flash_attention_bwd_dkv,
                                              flash_attention_bwd_dq,
                                              flash_attention_bwd_plain,
                                              flash_attention_bwd_route,
                                              flash_attention_fwd)

    dev = torch.device("cuda")
    _, bf16_peak, f32_peak = peaks
    f32, bf16 = torch.float32, torch.bfloat16
    tf32_peak = card_tf32_peak(torch.cuda.get_device_name(0))
    rows = []
    for B, H, T, D, dname in shapes:  # noqa: N806
        dt = getattr(torch, dname)
        sc = 1.0 / math.sqrt(D)
        q, k, v, do = (torch.randn((B, H, T, D), generator=g, device=dev)
                       .to(dt) for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v, scale=sc)
        esz = q.element_size()
        pairs = B * H * T * (T + 1) // 2
        peak = bf16_peak if dt == bf16 else f32_peak
        io = B * H * T * D * esz  # one [B, H, T, D] tensor
        shape = f"B={B} T={T} H={H} D={D} {dname}"
        if D == 64 or dt == f32:
            rows.append(k4_row(peaks, q, k, v, shape, strict))
        dsum = (do.float() * out.float()).sum(-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, dsum, scale=sc)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dsum, scale=sc)
        ref = flash_attention_bwd_plain(q, k, v, out, lse, do, scale=sc)
        torch.cuda.synchronize()
        tol = TOL_BWD_BF16 if dt == bf16 else TOL_BWD_F32
        route = flash_attention_bwd_route(dt, D)
        want = {f32: "mma_3xtf32", bf16: "mma_bf16"}[dt]
        if strict and route != want:
            fail(f"flash_attention_bwd {shape}: takes {route}, not {want}")
        errs = [rel_err(a, b) for a, b in zip((dq, dk, dv), ref)]
        for name, (err, rel), got in zip(("dq", "dk", "dv"), errs,
                                         (dq, dk, dv)):
            if not torch.isfinite(got).all() or rel > tol:
                fail(f"flash_attention_bwd {name} {shape}: max|err| "
                     f"{err:.3g} (rel {rel:.3g} > {tol})")
        differ = None
        if dt == bf16:
            counts = [(a != b).sum().item() for a, b in zip((dq, dk, dv),
                                                            ref)]
            differ = dict(dq=counts[0] / dq.numel(),
                          dk=counts[1] / dk.numel(),
                          dv=counts[2] / dv.numel(),
                          all=sum(counts) / (dq.numel() + 2 * dk.numel()))
            worst = max(r for _, r in errs)
            if strict and (worst > TOL_BWD_BF16_ELEM
                           or differ["all"] > MAX_BWD_BF16_DIFF_SHARE):
                fail(f"flash_attention_bwd {shape} ({route}): an element "
                     f"{worst:.3g} of max|plain| from the plain version "
                     f"(limit {TOL_BWD_BF16_ELEM:.3g}), {differ} of the bf16 "
                     f"elements differ (limit {MAX_BWD_BF16_DIFF_SHARE})")
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
                             rel_err_vs_f64=vs_f64, bf16_differ=differ))
        del q, k, v, do, out, lse, dsum, dq, dk, dv
        torch.cuda.empty_cache()
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
# GPT-J-6B's decode/prefill matmuls, the lm head (with its bias) too
GPTJ_MATMULS = {**GPTJ_STACKED, "lm_head": (4096, 51200, True)}
# K2's TF32 instance (f32 planes at 9-128 rows): (model, matmul, n, x dtype)
# -- GPT-J-6B's five matmuls with f32 x at 16 and 128 rows, Pythia-12B's at
# 100 rows of bf16 x (the f32xf engine's prefill) and at 20 and 100 rows of
# f32 x (the chat CLI's default f32 compute: its prefill)
K2_TF32_CASES = ([("gpt-j-6b", s, n, "float32") for n in (16, 128)
                  for s in GPTJ_MATMULS]
                 + [("pythia-12b", s, 100, "bfloat16") for s in PYTHIA_SHAPES]
                 + [("pythia-12b", s, n, "float32") for n in (20, 100)
                    for s in PYTHIA_SHAPES])


def k2_tf32_rows(peaks):
    """K2's f32-plane instance at 9-128 rows at the shapes of
    K2_TF32_CASES: against its plain version and a second run of itself
    (bit for bit), timed beside ``dequantize_km`` + ``torch.matmul`` in f32;
    its bound the larger of the bytes and the TF32 products (one a product
    for bf16 x, two for f32 x) at the card's TF32 peak, the f32 FMA bound
    (2 n K O at the f32 peak) beside it.  Uses only what K2 has had since
    its first port, so it runs on an earlier tree as well
    (``chip_smoke.py --k2-tf32``)."""
    import torch

    from vsim_tpu_torch.ops.q4_cuda import q4_matmul_ps, q4_matmul_ps_plain
    from vsim_tpu_torch.quant.q4 import dequantize_km

    bw, _, f32_peak = peaks
    name = torch.cuda.get_device_name(0)
    tf32_peak = card_tf32_peak(name)
    g = torch.Generator(device="cuda")
    g.manual_seed(20)
    rows = []
    for model, sname, n, xname in K2_TF32_CASES:
        K, O, has_bias = (GPTJ_MATMULS if model == "gpt-j-6b"  # noqa: N806
                          else PYTHIA_SHAPES)[sname]
        w0 = random_q4_weight(K, O, 23 * K + O)
        ws = rotation(lambda i, K=K, O=O: random_q4_weight(K, O, 23 * K + O + i),
                      w0.nbytes)
        ws[0] = w0
        x = torch.randn((n, K), generator=g, device="cuda").to(
            getattr(torch, xname))
        bias = (torch.randn((O,), generator=g, device="cuda")
                if has_bias else None)
        shape = f"{model} {sname} n={n} {K}->{O} x={xname} planes=f32"
        got = q4_matmul_ps(x, w0.packed, w0.scales, bias, False)
        ref = q4_matmul_ps_plain(x, w0.packed, w0.scales, bias, False)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not torch.isfinite(got).all() or rel > TOL_Q4:
            fail(f"q4_matmul_ps {shape}: max|err| {err:.3g} (rel {rel:.3g} "
                 f"> {TOL_Q4})")
        if not torch.equal(got, q4_matmul_ps(x, w0.packed, w0.scales, bias,
                                             False)):
            fail(f"q4_matmul_ps {shape}: differs from run to run")
        cyc = itertools.cycle(ws)

        def run_kernel():
            w = next(cyc)
            return q4_matmul_ps(x, w.packed, w.scales, bias, False)

        ms = timed(run_kernel)
        plain_ms = timed(lambda: q4_matmul_ps_plain(
            x, w0.packed, w0.scales, bias, False), reps=5, warmup=1)
        lib_ms = timed(lambda: torch.matmul(
            x.to(torch.float32), dequantize_km(next(cyc), torch.float32)),
            reps=5, warmup=1)
        nbytes = (w0.nbytes + x.numel() * x.element_size() + n * O * 4
                  + (O * 4 if has_bias else 0))
        ops = 2 * n * K * O
        products = 1 if xname == "bfloat16" else 2
        t_b = nbytes / bw * 1e3
        t_tf32, t_fma = products * ops / tf32_peak * 1e3, ops / f32_peak * 1e3
        rows.append(dict(
            kernel="q4_matmul_ps", shape=shape, max_abs_err=err, rel_err=rel,
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_b, t_tf32),
            bound_by="bytes" if t_b >= t_tf32 else "operations",
            library_ms=lib_ms, fma_bound_ms=max(t_b, t_fma),
            weights=[(K, O)]))
        del ws, w0
        torch.cuda.empty_cache()
    return rows


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
    # too), and K2: f32 planes for bf16 x (the f32xf engine's decode and
    # 8-token prefill) and bf16 planes at 100 rows (the gi engine's prefill
    # of 100 tokens: gi rounds the planes past 8 rows); f32 planes past 8
    # rows: k2_tf32_rows
    cases = ([("q4_gemv_ps", s, n, True) for n in (1, 8)
              for s in PYTHIA_SHAPES]
             + [("q4_gemv_ps", "fc", n, True) for n in (2, 4)]
             + [("q4_matmul_ps", s, n, False) for n in (1, 8)
                for s in ("qkv", "wo", "lm_head")]
             + [("q4_matmul_ps", s, 100, True) for s in PYTHIA_SHAPES])
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

    # K1's 9-32-row instance at GPT-J-6B's qkv and fc (tools/
    # gi_batch_probe.py's shapes), each beside K2 on the same rows with the
    # bf16 planes the router's gi route gives it there
    for sname in ("qkv", "fc"):
        K, O, _ = GPTJ_STACKED[sname]  # noqa: N806
        for n in (16, 32):
            for kname in ("q4_gemv_ps", "q4_matmul_ps"):
                if kname == "q4_gemv_ps":
                    fn, plain = q4_gemv_ps, q4_gemv_ps_plain
                else:
                    fn, plain = (functools.partial(f, round_planes=True)
                                 for f in (q4_matmul_ps, q4_matmul_ps_plain))
                matmul_case(
                    kname, sname, n, K, O, False, torch.bfloat16,
                    lambda x, w, b, f=fn: f(x, w.packed, w.scales, b),
                    lambda x, w, b, f=plain: f(x, w.packed, w.scales, b),
                    lambda w: w,
                    lambda i, K=K, O=O: q4_weight(K, O, 5 * K + O + i),
                    True, "gi" if kname == "q4_gemv_ps" else None)
                rows[-1]["shape"] = rows[-1]["shape"].replace("pythia-12b",
                                                              "gpt-j-6b")
            rows[-2]["k2_ms"] = rows[-1]["ms"]

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
    """The lab's path: the ten tools' ``run`` as a user calls them, each
    holding every variant against its plain version (and K12/K13/K15/K16
    against a second run, bit for bit) before timing it.  K12 under every
    math and layout at GPT-J-6B's five weight shapes at n = 1 and 8, K13
    and K1/K2/K9 at every Q4 weight shape of GPT-J-6B and Pythia-12B at
    n = 1, the tools' defaults, and K14; K12's "v2" beside K10 and K9 on
    GPT-J-6B's stacked groups at n = 1 and 8; K15 and K13's batch touches
    at GPT-J-6B's four shapes at n = 64 and 128 and Pythia-12B's at 64; K16
    beside K3 at ``ATTN_LAB_CASES``; the root probes: K1's 9-32-row
    instance beside K2 at GPT-J-6B's three shapes at ``GI_PROBE_NS``
    (gi_batch_probe) and K3 beside the einsum route at the zoo's six head
    dims, int8 and int4 (attn_gate_probe, its defaults).  Returns (rows,
    launch counts of the path)."""
    import torch

    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.tools import (attn_gate_probe, attn_lab, batch_lab,
                                      decode_lab, gi_batch_probe, gi_sweep,
                                      kernel_lab, pair_lab, pair_probe,
                                      pair_sweep)

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
    # the root probes: K1 (9-32 rows) beside K2 at GPT-J-6B's shapes, and
    # K3 beside the einsum route at every head dim of the zoo
    before = collections.Counter(_build.launch_counts)
    tag("gpt-j-6b", [probe_row(r) for r in gi_batch_probe.run(
        gi_batch_probe.SHAPES["gptj"], GI_PROBE_NS)])
    tag("attn_gate", [gate_row(r) for r in attn_gate_probe.run()])
    probes = collections.Counter(_build.launch_counts)
    probes.subtract(before)
    for kname in ("q4_gemv_ps", "q4_matmul_ps", "decode_attention"):
        if probes[kname] <= 0:
            fail(f"the root probes launched no {kname}")
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


GI_PROBE_NS = (16, 32)  # gi_batch_probe's rows past K1's n <= 8 instance


def probe_row(r):
    """A tools/gi_batch_probe.py row as a lab row (``tag``'s keys)."""
    O, K = r["shape"]  # noqa: N806
    n = r["n"]
    return dict(r, tool="gi_batch_probe", K=K, O=O,
                shape=f"{r['variant']} n={n} {K}->{O}",
                nbytes=O * K // 2 + O * K // 32 * 2 + n * K * 2 + n * O * 4,
                ops=2 * n * K * O, peak="bf16")


def gate_row(r):
    """A tools/attn_gate_probe.py row (its K3 pass) as a lab row."""
    L, B, H, D, S = (r[k] for k in "LBHDS")  # noqa: N806
    return dict(r, tool="attn_gate_probe", kernel="decode_attention_q",
                variant="kernel", n=B, ms=r["kernel_ms"],
                gbs=r["kernel_gbs"], plain_ms=None, library_ms=None,
                shape=f"{r['model']} {r['kv']} L={L} B={B} H={H} D={D} "
                      f"S={S} n_past={S - 2}",
                # the cache rows s <= n_past, q read and out written
                nbytes=r["nbytes"] * (S - 1) // S + L * B * H * D * 6,
                ops=4 * L * B * H * (S - 1) * D, peak="f32")


def probe_lines(rows):
    """The root probes' lines: K1 and K2 by GPT-J-6B shape and n (ms, GB/s,
    x bound, K1 over K2), K3 and the einsum by zoo row."""
    lines = []
    for r in rows:
        if r["tool"] == "gi_batch_probe":
            lines.append(
                f"  gi_batch_probe {r['shape']}: {r['ms']:.4f} ms, "
                f"{r['gbs']:.0f} GB/s, {r['ms'] / r['bound_ms']:.2f}x bound, "
                f"plain {r['plain_ms']:.3f}, library {r['library_ms']:.4f}, "
                f"{r['vs_k2']:.2f}x K2")
        elif r["tool"] == "attn_gate_probe":
            lines.append(
                f"  attn_gate_probe {r['shape']}: K3 {r['ms']:.4f} ms "
                f"({r['gbs']:.0f} GB/s, {r['ms'] / r['bound_ms']:.2f}x bound), "
                f"einsum {r['einsum_ms']:.4f} ms "
                f"({r['einsum_gbs']:.0f} GB/s), einsum / K3 "
                f"{r['einsum_ms'] / r['ms']:.2f}x")
    return lines


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
        rate = card_tf32_peak(name)
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
    params = random_q4_params(cfg, seed=0, rng="device")
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
# phase 13: the batched benchmark's headline path
# ---------------------------------------------------------------------------

HEADLINE_B = 128
# the benchmark's loop pair cut from (96, 192) steps and 3 reps
HEADLINE_STEPS, HEADLINE_REPS = (32, 64), 2


def phase_headline(params):
    """Phase 13: ``vsim_tpu_torch.bench``'s measuring function on GPT-J-6B
    (phase 3's params, shared), int4 KV, n_ctx 512, B=128, at cut loop
    lengths; then one more batched run whose tokens [32, B] must all lie in
    the vocabulary, and its step alone (``decode_step_report``): K2 4 a
    layer + 1, K3 and K6 once a layer, replayed as eager.  Returns (the
    numbers, the launches of the measured run)."""
    import torch

    from vsim_tpu_torch import bench
    from vsim_tpu_torch.models.init import param_bytes
    from vsim_tpu_torch.ops import _build

    args = bench.parse_args(
        ["--model", "gpt-j-6b", "--batch", str(HEADLINE_B), "--kv", "int4",
         "--n-ctx", "512", "--decode-chunk", str(HEADLINE_STEPS[0]),
         "--tokens", str(HEADLINE_STEPS[1])])
    t0 = time.perf_counter()
    cfg, eng, _ = bench.build(args, params=params)
    wbytes = param_bytes(eng.params)
    _build.reset_launch_counts()
    line = bench.measure(args, cfg, eng, wbytes, reps=HEADLINE_REPS,
                         extras=False)
    launches = dict(_build.launch_counts)
    measure_s = time.perf_counter() - t0
    if not (math.isfinite(line["value"]) and line["value"] > 0):
        fail(f"phase 13: the bench's value {line['value']}")
    for name in ("q4_matmul_ps", "decode_attention", "scatter_rows",
                 "flash_attention"):
        if launches.get(name, 0) == 0:
            fail(f"phase 13: the batched run never launched {name}: "
                 f"{launches}")

    B, dev = HEADLINE_B, eng.device  # noqa: N806
    prompt = list(range(1, args.prompt_len + 1))
    cache = eng.new_cache(B)
    logits, _ = eng._prefill(torch.tensor([prompt] * B, device=dev), cache)
    tok = logits[:, -1].argmax(-1)
    del logits
    last = torch.full((B, bench.WINDOW), -1, dtype=torch.long, device=dev)
    n = HEADLINE_STEPS[0]
    toks = eng._decode_many(tok, cache, len(prompt), last, n, bench.GREEDY)
    if toks.shape != (n, B) or not bool(((toks >= 0)
                                         & (toks < cfg.n_vocab)).all()):
        fail(f"phase 13: batched tokens {list(toks.shape)} outside the "
             "vocabulary")
    st = eng._state(bench.WINDOW, B, cache, n)
    report = decode_step_report(eng._step(bench.GREEDY, st))
    st.cache = None
    row_write_check("phase 13 B=128", report, cfg.n_layer)
    want = {"q4_matmul_ps": 4 * cfg.n_layer + 1,
            "decode_attention": cfg.n_layer, "scatter_rows": cfg.n_layer}
    for mode in ("eager", "graphed"):
        if report[mode]["launches_per_step"] != want:
            fail(f"phase 13 B=128 {mode} step launches "
                 f"{report[mode]['launches_per_step']}, not {want}")
    del cache, eng
    torch.cuda.empty_cache()
    return dict(bench=line, step=report, measure_s=measure_s,
                tokens_first_row=toks[:, 0].tolist()), launches


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


def serve_traffic(n_vocab: int):
    """Phase 4's traffic: 13 seeded prompts of 8-300 tokens, 64 or 32 new
    tokens each."""
    import torch

    rng = torch.Generator().manual_seed(1)
    lens = torch.randint(8, 301, (13,), generator=rng).tolist()
    prompts = [torch.randint(0, n_vocab, (n,), generator=rng).tolist()
               for n in lens]
    return prompts, [64 if i % 2 == 0 else 32 for i in range(13)]


def phase_serving(cfg, params):
    import torch

    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.ops import _build

    prompts, n_pred = serve_traffic(cfg.n_vocab)
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
            step_b8_k1_device_ms=g and g["q4_core"],
            streams=[r.generated for r in reqs])
        del srv
        torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# phase 5: card against CPU
# ---------------------------------------------------------------------------


class PartTimer:
    """Seconds of each part of phase 5, by device: the CPU side is most of
    its work (in a child process, ``CpuChild``), and its parts are what a cut
    of depth or tokens shortens."""

    def __init__(self):
        self.seconds = collections.Counter()

    def __call__(self, part: str, dev: str, fn):
        a = time.perf_counter()
        out = fn()
        self.seconds[f"{part} {dev}"] += time.perf_counter() - a
        return out


# The CPU halves of phase 5 run in a child process (``chip_smoke.py
# --cpu-refs``, no card visible) on VS_CPU_THREADS threads, started once the
# kernels are built; the card halves run at phase 5's place and are held
# against the child's results there.
VS_CPU_THREADS = 4

# f32 greedy steps at GPT-J-6B's width, depth 1, seed-1 weights.  Random
# weights give the odd near-tie, where card and CPU f32 sums may pick
# different tokens: every greedy step of these prompts has a top-2 logit
# margin of at least 3.3e-3 of max|logit| on the CPU (3.36e-3 at the third
# step of GPTJ_PROMPT's stream, 1.35e-2 and more in serving).
GPTJ_PROMPT = list(range(100, 112))
# serving: 3 prompts on 2 slots (one waits for a slot), 2 tokens each
GPTJ_SERVE_PROMPTS = [GPTJ_PROMPT, list(range(7, 10)),
                      list(range(1000, 1020))]


def gptj_runs(dev: str, clock: PartTimer):
    """Phase 5's runs at GPT-J-6B's width, depth 1, seed-1 weights, int8
    KV, on one device: the f32 greedy stream (3 tokens), the served streams,
    the bf16 prompt logits and the speculative streams (``spec_runs``).  On
    the card also each serving prompt's InferenceEngine stream and the plain
    stream the speculative ones must equal."""
    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params

    base = PRESETS["gpt-j-6b"].replace(n_layer=1, n_ctx=64)
    params = random_q4_params(base, seed=1, device="cpu")
    greedy = SamplingParams(greedy=True)
    cfg = base.replace(compute_dtype="float32")
    out = {}
    out["f32 stream"] = clock("gpt-j f32 stream", dev, lambda: InferenceEngine(
        cfg, params, kv_dtype="int8", device=dev).generate(
            GPTJ_PROMPT, 3, greedy).token_ids)
    res = clock("gpt-j serving", dev, lambda: ServingEngine(
        cfg, params, max_batch=2, kv_dtype="int8", device=dev).run(
            GPTJ_SERVE_PROMPTS, 2, stop_tokens=(), chunk_steps=2))
    out["serving"] = [res[i].generated for i in sorted(res)]
    if dev == "cuda":
        eng = InferenceEngine(cfg, params, kv_dtype="int8", device=dev)
        out["single"] = [eng.generate(p, 2, greedy).token_ids
                         for p in GPTJ_SERVE_PROMPTS]
    out["batched"] = clock("gpt-j batched", dev, lambda: batched_tokens(
        cfg, params, dev))
    bf16 = base.replace(compute_dtype="bfloat16")
    out["bf16 logits"] = clock(
        "gpt-j bf16 logits", dev, lambda: InferenceEngine(
            bf16, params, kv_dtype="int8", device=dev).generate(
                GPTJ_PROMPT, 1, return_logits=True).logits)
    out["speculative"] = spec_runs(dev, clock, base, params)
    return out


# the batched engine at GPT-J-6B's width, depth 1: 12 rows, a distinct
# 8-token prompt each, through _prefill + _decode_many (2 steps)
GPTJ_BATCH_PROMPTS = [[(997 * b + 31 * i + 5) % 50400 for i in range(8)]
                      for b in range(12)]


def batched_tokens(cfg, params, dev: str):
    """The first token of each row (from the prefill) and the tokens [2,
    B] of two batched steps (replayed from a graph on the card), f32
    greedy, int8 KV."""
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams

    eng = InferenceEngine(cfg, params, kv_dtype="int8", device=dev)
    B = len(GPTJ_BATCH_PROMPTS)  # noqa: N806
    cache = eng.new_cache(B)
    logits, _ = eng._prefill(torch.tensor(GPTJ_BATCH_PROMPTS, device=dev),
                             cache)
    tok = logits[:, -1].argmax(-1)
    last = torch.full((B, 64), -1, dtype=torch.long, device=dev)
    toks = eng._decode_many(tok, cache, 8, last, 2,
                            SamplingParams(greedy=True))
    return [tok.tolist()] + toks.tolist()


# f32 speculative streams at GPT-J width, depth 1, seed-1 weights: SPEC_PROMPT
# is one 6-token pattern twice.  The plain greedy steps' top-2 margins on the
# CPU are 5.4e-2, 2.3e-2 and 6.9e-3 of max|logit|, the verify forwards' 4.1e-3
# and more (D = 256: the plain step rounds q to bf16 and the verify does not,
# so a near-tie could part them); both drafters' CPU streams equal the plain
# one.
SPEC_PROMPT = [4242, 17, 999, 30000, 5, 123] * 2


def spec_runs(dev: str, clock: PartTimer, base, params):
    """SpeculativeEngine at ``base``'s widths, f32, int8 KV, with
    NgramDrafter(3, 4) and with a ModelDrafter of pythia-70m's widths at
    depth 2 (seed 2, gamma 4) on one device: each 3-token stream and its
    cycles; on the card also InferenceEngine's greedy stream."""
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine, engine_params
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.engine.speculative import (ModelDrafter,
                                                   NgramDrafter,
                                                   SpeculativeEngine)
    from vsim_tpu_torch.models.init import random_q4_params

    cfg = base.replace(compute_dtype="float32", kv_dtype="int8")
    dcfg = pythia_drafter_cfg(cfg).replace(n_layer=2, n_ctx=base.n_ctx)
    dparams = random_q4_params(dcfg, seed=2, device="cpu")
    n_tok = 3
    out = {}
    if dev == "cuda":
        out["plain"] = InferenceEngine(
            cfg, params, kv_dtype="int8", device=dev).generate(
                SPEC_PROMPT, n_tok, SamplingParams(greedy=True)).token_ids
    # the device's params laid out once, shared by both drafters' engines
    laid = clock("gpt-j spec params", dev, lambda: engine_params(
        cfg, params, torch.device(dev)))
    for name, make in (("ngram", lambda: NgramDrafter(3, 4)),
                       ("model", lambda: ModelDrafter(dcfg, dparams,
                                                      gamma=4))):
        res = clock(f"gpt-j spec {name}", dev, lambda: SpeculativeEngine(
            cfg, laid, make(), device=dev).generate(SPEC_PROMPT, n_tok))
        out[name] = (res.token_ids, res.cycles)
    return out


# f32 greedy steps of these prompts at depth 2, seed-1 weights with
# fill_vectors(seed 1): every top-2 logit margin of the 4 steps on the CPU is
# at least 4.3e-3 of max|logit| (bloom-560m 8.7e-3, gpt2 4.3e-3 at its fourth
# step, codegen-2b 3.9e-2).  Not at depth 1: there bloom-560m's fourth step
# has a margin of 5.0e-4.
ARCH_CPU_PROMPTS = {"bloom-560m": [1, 2500, 77, 250000, 13, 42, 9000, 7],
                    "gpt2": [464, 2068, 7586, 21831, 18045, 625, 262, 16931],
                    "codegen-2b": [50, 1201, 7, 40000, 333, 9, 2024, 11]}


def archs_runs(dev: str, clock: PartTimer):
    """BLOOM-560m's widths (its 250,880-token vocab, ALiBi, embedding LN),
    GPT-2's (learned positions, the padded vocab) and CodeGen-2B's (D = 80,
    interleaved RoPE on 64 of 80 dims) at depth 2, biases and positions
    filled, on one device: {name: (f32 greedy stream of 4 tokens, bf16
    prompt logits)}."""
    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params

    out = {}
    for name, prompt in ARCH_CPU_PROMPTS.items():
        base = PRESETS[name].replace(n_layer=2, n_ctx=64)
        params = fill_vectors(base, random_q4_params(base, seed=1,
                                                     device="cpu"), 1)
        cfg = base.replace(compute_dtype="float32")
        stream = clock(f"{name} f32 stream", dev, lambda: InferenceEngine(
            cfg, params, kv_dtype="int8", device=dev).generate(
                prompt, 4, SamplingParams(greedy=True)).token_ids)
        cfg = base.replace(compute_dtype="bfloat16")
        logits = clock(f"{name} bf16 logits", dev, lambda: InferenceEngine(
            cfg, params, kv_dtype="int8", device=dev).generate(
                prompt, 1, return_logits=True).logits)
        out[name] = (stream, logits)
    return out


# f32 greedy steps of this prompt at Pythia-12B width, depth 1, seed-1
# weights: every top-2 logit margin of the 2 steps on the CPU is at least
# 5.5e-3 of max|logit|, for each engine (3 run, since phase 11 was added)
PYTHIA_PROMPT = [50, 1201, 7, 40000, 333, 9, 2024, 11]
# the gi engine's bf16 logits: more than 8 tokens, so that its prefill takes
# K2's tensor-core instance (K1 takes n <= 8 rows)
PYTHIA_LOGITS_PROMPT = {"gi": PYTHIA_PROMPT + [3000, 17, 29, 4242]}


def pythia_runs(dev: str, clock: PartTimer):
    """Pythia-12B width at depth 1 for phase 7's three engines, on one
    device: {engine: (f32 greedy stream of 2 tokens, bf16 prompt logits)}.
    An 8-token prompt takes K11 and K10 in the prefill too; the gi engine's
    12-token logits prompt K2 on the tensor cores."""
    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params
    from vsim_tpu_torch.ops.q4_cuda import set_dequant_math

    base = PRESETS["pythia-12b"].replace(n_layer=1, n_ctx=64)
    params = random_q4_params(base, seed=1, device="cpu")
    out = {}
    for name, (kw, math_name, _) in PYTHIA_ENGINES.items():
        prompt = PYTHIA_LOGITS_PROMPT.get(name, PYTHIA_PROMPT)
        set_dequant_math(math_name)
        try:
            cfg = base.replace(compute_dtype="float32")
            stream = clock(
                f"pythia-12b {name} f32 stream", dev,
                lambda: InferenceEngine(
                    cfg, params, kv_dtype="int8", device=dev,
                    **kw).generate(PYTHIA_PROMPT, 2, SamplingParams(
                        greedy=True)).token_ids)
            cfg = base.replace(compute_dtype="bfloat16")
            logits = clock(
                f"pythia-12b {name} bf16 logits", dev,
                lambda: InferenceEngine(
                    cfg, params, kv_dtype="int8", device=dev,
                    **kw).generate(prompt, 1, return_logits=True).logits)
        finally:
            set_dequant_math("gi")
        out[name] = (stream, logits)
    return out


def train_runs(dev: str, clock: PartTimer):
    """Three f32 training steps at Pythia-410M width, depth 2, from the
    same init and batch on one device: (losses, step-0 gradients on the
    CPU)."""
    import torch

    from vsim_tpu_torch.engine.train import float_leaves, make_train_step
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import init_params

    cfg = PRESETS["pythia-410m"].replace(n_layer=2, n_ctx=256)
    ids = torch.randint(0, cfg.n_vocab, (2, 257),
                        generator=torch.Generator().manual_seed(3))
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
    clock.seconds[f"pythia-410m training {dev}"] += time.perf_counter() - a
    return losses, grads


VS_CPU_RUNS = (("gpt-j", gptj_runs), ("training", train_runs),
               ("pythia-12b", pythia_runs), ("archs", archs_runs))


def cpu_refs_main(path: str) -> None:
    """``chip_smoke.py --cpu-refs PATH``: every run of VS_CPU_RUNS on the
    CPU (the kernels' plain versions) on VS_CPU_THREADS threads, saved to
    PATH with each part's seconds (``CpuChild``)."""
    import torch

    torch.set_num_threads(VS_CPU_THREADS)
    clock = PartTimer()
    runs = {key: fn("cpu", clock) for key, fn in VS_CPU_RUNS}
    torch.save(dict(runs=runs, seconds=dict(clock.seconds)), path + ".tmp")
    os.replace(path + ".tmp", path)


class CpuChild:
    """A child process of this script (``args``, then the path it saves its
    results to), started at construction with no card visible and
    VS_CPU_THREADS threads; ``result()`` waits for it and fails the check if
    it failed.  It is killed if this process exits first.  Its log is
    build/<tag>.log."""

    def __init__(self, tag: str, args, timeout_s: float = 900):
        import atexit

        d = os.path.join(HERE, "build")
        os.makedirs(d, exist_ok=True)
        self.tag = tag
        self.path = os.path.join(d, f"{tag}.pt")
        self.log_path = os.path.join(d, f"{tag}.log")
        if os.path.exists(self.path):
            os.remove(self.path)
        self.deadline = time.monotonic() + timeout_s
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *args, self.path],
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=self.log, stderr=subprocess.STDOUT)
        atexit.register(self.stop)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()

    def result(self):
        import torch

        try:
            rc = self.proc.wait(timeout=max(self.deadline - time.monotonic(),
                                            1))
        except subprocess.TimeoutExpired:
            rc = None
        self.stop()
        if rc != 0:
            with open(self.log_path) as f:
                tail = f.read()[-3000:]
            fail(f"{self.tag} ({' '.join(self.proc.args[2:])}) "
                 f"{'timed out' if rc is None else f'exited {rc}'}:\n{tail}")
        return torch.load(self.path, weights_only=False)


def check_logits(label, card, cpu):
    """Fail unless the card's bf16 logits are finite and within
    TOL_LOGITS_BF16 of the CPU's; returns (max|err|, rel)."""
    import numpy as np
    import torch

    card, cpu = (torch.from_numpy(np.asarray(x)) for x in (card, cpu))
    if not torch.isfinite(card).all():
        fail(f"{label} bf16 logits on the card are not finite")
    err, rel = rel_err(card, cpu)
    if rel > TOL_LOGITS_BF16:
        fail(f"{label} bf16 logits card vs cpu: max|err| {err:.3g} (rel "
             f"{rel:.3g} > {TOL_LOGITS_BF16})")
    return err, rel


def gptj_compare(card, cpu):
    if card["f32 stream"] != cpu["f32 stream"]:
        fail(f"f32 greedy streams differ: card {card['f32 stream']} "
             f"cpu {cpu['f32 stream']}")
    if not card["serving"] == cpu["serving"] == card["single"]:
        fail(f"f32 serving streams differ: card {card['serving']} cpu "
             f"{cpu['serving']} card InferenceEngine {card['single']}")
    if card["batched"] != cpu["batched"]:
        fail(f"f32 batched tokens [1 + 2, 12] differ: card {card['batched']}"
             f" cpu {cpu['batched']}")
    err, rel = check_logits("gpt-j", card["bf16 logits"], cpu["bf16 logits"])
    spec_c, spec_p = card["speculative"], cpu["speculative"]
    want = spec_c["plain"]
    spec = dict(plain_tokens=want)
    for name in ("ngram", "model"):
        (got_c, cycles), (got_p, _) = spec_c[name], spec_p[name]
        if not got_c == got_p == want:
            fail(f"speculative {name} f32: card {got_c} cpu {got_p} card "
                 f"InferenceEngine {want}")
        spec[name] = dict(tokens=got_c, cycles=cycles)
    return dict(f32_greedy_tokens=card["f32 stream"],
                f32_serving_tokens=card["serving"],
                f32_batched_tokens=card["batched"],
                bf16_logits_max_abs_err=err, bf16_logits_rel_err=rel,
                speculative=spec)


def train_compare(card, cpu):
    (l_gpu, g_gpu), (l_cpu, g_cpu) = card, cpu
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


def streams_logits_compare(label, card, cpu, prompts=None):
    """{name: (stream, logits)} on both devices: streams identical, bf16
    logits within TOL_LOGITS_BF16."""
    out = {}
    for name, (s_card, l_card) in card.items():
        s_cpu, l_cpu = cpu[name]
        if s_card != s_cpu:
            fail(f"{label}{name} f32 greedy streams differ: card {s_card} "
                 f"cpu {s_cpu}")
        err, rel = check_logits(f"{label}{name}", l_card, l_cpu)
        out[name] = dict(f32_greedy_tokens=s_card)
        if prompts is not None:
            out[name]["bf16_logits_prompt_tokens"] = len(
                prompts.get(name, PYTHIA_PROMPT))
        out[name].update(bf16_logits_max_abs_err=err,
                         bf16_logits_rel_err=rel)
    return out


def phase_card_vs_cpu(clock: PartTimer, cpu_refs: CpuChild):
    """Phase 5: the card halves of VS_CPU_RUNS, then the CPU halves from
    ``cpu_refs`` (waited for), each held against the other: f32 greedy and
    served streams identical, bf16 logits within TOL_LOGITS_BF16, the
    training steps within TOL_TRAIN_*."""
    import torch

    card = {}
    for key, fn in VS_CPU_RUNS:
        card[key] = fn("cuda", clock)
        torch.cuda.empty_cache()
    a = time.perf_counter()
    refs = cpu_refs.result()
    clock.seconds["cpu side, waited for"] += time.perf_counter() - a
    clock.seconds.update(refs["seconds"])
    cpu = refs["runs"]
    out = gptj_compare(card["gpt-j"], cpu["gpt-j"])
    out["training"] = train_compare(card["training"], cpu["training"])
    out["pythia-12b"] = streams_logits_compare(
        "pythia-12b ", card["pythia-12b"], cpu["pythia-12b"],
        PYTHIA_LOGITS_PROMPT)
    out["archs"] = streams_logits_compare("", card["archs"], cpu["archs"])
    return out


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


def train_run(label, cfg, B, steps, peak, strict: bool = True):  # noqa: N803
    """``steps`` AdamW steps of make_train_step on dense weights from seed 0
    (drawn on the card) and one seeded batch of B x (n_ctx + 1) tokens:
    finite losses, the last below the first, K4, K7 and K8 launched once a
    layer in every step
    (with ``strict``, K7/K8 on "mma_bf16" at bf16 compute and on
    "mma_3xtf32" at f32, and at f32 the profiled step's K4 kernel K4's
    "mma_3xtf32" instance); step ms the
    median of steps 2 on (synced), tokens/s, peak memory, the model-FLOP
    share of ``peak``, and one more step's device ms by kernel class
    (torch.profiler; None if it records no device activity).  Returns (the
    run's numbers, each step's launch counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vsim_tpu_torch.engine.train import float_leaves, make_train_step
    from vsim_tpu_torch.models.init import init_params
    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.ops.attention import flash_attention_bwd_route

    L, E, T = cfg.n_layer, cfg.n_embd, cfg.n_ctx  # noqa: N806
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, rng="device")
    init_fn, step_fn = make_train_step(cfg)
    state = init_fn(params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in float_leaves(params).values())
    route = flash_attention_bwd_route(getattr(torch, cfg.compute_dtype),
                                      cfg.head_dim)
    want = {"bfloat16": "mma_bf16", "float32": "mma_3xtf32"}[cfg.compute_dtype]
    if strict and route != want:
        fail(f"{label}: K7/K8 take {route}, not {want}")
    ids = torch.randint(0, cfg.n_vocab, (B, T + 1),
                        generator=torch.Generator().manual_seed(0)).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, launches = [], [], []
    for _ in range(steps):
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        a = time.perf_counter()
        _, state, loss = step_fn(params, state, ids)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - a)
        launches.append(dict(_build.launch_counts))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"{label}: losses {losses}: not finite or not falling")
    for i, counts in enumerate(launches):
        for name in TRAIN_KERNELS:
            if counts.get(name, 0) != L:
                fail(f"{label} step {i}: {name} launched "
                     f"{counts.get(name, 0)} times, not {L}: {counts}")
    step_med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tokens = B * T
    # model FLOPs: 6 per weight and token in the matmuls (lm head included,
    # embedding gather not), attention 12 D per visible (query, key) pair
    # and layer (forward q.k and p.v, backward four products)
    mm_params = L * (4 * E * E + 2 * E * cfg.n_ff) + cfg.n_vocab * E
    pairs = B * cfg.n_head * T * (T + 1) // 2
    flops = 6 * mm_params * tokens + 12 * cfg.head_dim * pairs * L
    by_class, by_name = collections.Counter(), collections.Counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, state, loss = step_fn(params, state, ids)
        torch.cuda.synchronize()
    k4_kernels = set()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = (ev.time_range.end - ev.time_range.start) / 1e3
            by_class[_kernel_class(ev.name)] += ms
            by_name[ev.name[:60]] += ms
            if "flash_fwd" in ev.name:
                k4_kernels.add(ev.name)
    # at f32 the profiled step's K4 is the "mma_3xtf32" instance
    if (strict and cfg.compute_dtype == "float32" and by_class
            and not any("flash_fwd_3xtf32" in n for n in k4_kernels)):
        fail(f"{label}: no K4 launch of flash_fwd_3xtf32 in the profiled "
             f"step: {sorted(k4_kernels)}")
    run = dict(
        compute_dtype=cfg.compute_dtype, n_layer=L, head_dim=cfg.head_dim,
        bwd_instance=route, batch=B, seq=T, tokens_per_step=tokens,
        params=n_params, setup_s=setup_s, losses=losses, step_s=step_s,
        step_ms_median=step_med * 1e3, tokens_per_s=tokens / step_med,
        peak_memory_gb=peak_gb, model_flops_per_step=flops,
        model_flop_share_of_peak=flops / step_med / peak,
        launches_per_step=launches[0],
        k4_kernels=sorted(k4_kernels),
        device_ms_by_class=dict(by_class) or None,
        device_ms_top_kernels=dict(by_name.most_common(10)) or None)
    del params, state, ids, prof
    torch.cuda.empty_cache()
    return run, launches


# phase 6's bf16 runs: (label, preset, replace(), B, steps).  GPT-J-6B's
# widths at depth 2: dense AdamW training of all 28 layers needs ~96 GB
# (f32 weights, gradients and two moments, 16 bytes a parameter), depth 2
# ~13 GB
BF16_TRAIN_RUNS = (("pythia-410m bf16", "pythia-410m", {}, 4, 5),
                   ("gpt-j-6b widths depth 2 bf16", "gpt-j-6b",
                    {"n_layer": 2}, 1, 3))


# phase 6's f32 runs at head dims other than 64 and 128 (K7/K8's padded
# "mma_3xtf32" instances: D = 256 and 80), as BF16_TRAIN_RUNS: dense AdamW
# at depth 2 needs ~13 GB at GPT-J-6B's widths, ~7 GB at CodeGen-2B's
F32_TRAIN_RUNS = (("gpt-j-6b widths depth 2 f32", "gpt-j-6b",
                   {"n_layer": 2}, 1, 3),
                  ("codegen-2b widths depth 2 f32", "codegen-2b",
                   {"n_layer": 2}, 1, 3))


def dtype_training(peaks, dtype: str, strict: bool = True):
    """Phase 6's runs at ``dtype`` compute (BF16_TRAIN_RUNS or
    F32_TRAIN_RUNS), each through train_run, its model-FLOP share of that
    dtype's peak.  Returns ({label: numbers}, summed launches);
    ``chip_smoke.py --bwd-bf16`` / ``--bwd-f32`` run them on an earlier
    tree with ``strict`` off."""
    from vsim_tpu_torch.models.config import PRESETS

    runs, peak = ((BF16_TRAIN_RUNS, peaks[1]) if dtype == "bfloat16"
                  else (F32_TRAIN_RUNS, peaks[2]))
    out, total = {}, collections.Counter()
    for label, name, replace, B, steps in runs:  # noqa: N806
        cfg = PRESETS[name].replace(compute_dtype=dtype, **replace)
        out[label], launches = train_run(label, cfg, B, steps, peak, strict)
        for counts in launches:
            total.update(counts)
    return out, total


def training_lines(runs):
    """One line a training run of ``dtype_training``."""
    out = []
    for label, r in runs.items():
        by = r["device_ms_by_class"]
        out.append(
            f"  {label} ({r['n_layer']} layers, D={r['head_dim']}, "
            f"B={r['batch']} x {r['seq'] + 1}, K7/K8 {r['bwd_instance']}): "
            f"step {r['step_ms_median']:.1f} ms (median of steps 2-"
            f"{len(r['step_s'])}), {r['tokens_per_s']:.0f} tokens/s, peak "
            f"{r['peak_memory_gb']:.1f} GB, losses "
            f"{[round(x, 4) for x in r['losses']]}; device ms by class "
            + ("null" if by is None else json.dumps(
                {k: round(v, 2) for k, v in sorted(by.items())})))
    return out


def phase_training(peaks):
    import torch

    from vsim_tpu_torch.engine.evaluate import perplexity
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params
    from vsim_tpu_torch.ops import _build

    cfg = PRESETS["pythia-410m"]
    T = cfg.n_ctx  # noqa: N806
    train, launches = train_run("training", cfg, 4, 5, peaks[2])
    train["model_flop_share_f32_peak"] = train.pop("model_flop_share_of_peak")
    bf16, bf16_launches = dtype_training(peaks, "bfloat16")
    f32, f32_launches = dtype_training(peaks, "float32")

    q4 = random_q4_params(cfg, seed=0, rng="device")
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
    total = collections.Counter(bf16_launches)
    total.update(f32_launches)
    for counts in launches:
        total.update(counts)
    total.update(ppl_launches)
    ppl.update(seconds=ppl_s, windows=len(range(0, len(stream) - 1, T - 1)),
               launches=ppl_launches)
    return dict(train=train, train_bf16=bf16, train_f32=f32,
                perplexity=ppl), total


# ---------------------------------------------------------------------------
# phase 12: mini-Pythia, the quantization-quality path
# ---------------------------------------------------------------------------

# tools/train_small.py's recipe (vsim_tpu_torch/tools/train_small.py) cut to
# MINI_STEPS steps, its schedule sized to them; the ppl table over the first
# MINI_EVAL_TOKENS held-out bytes; kv_ppl at MINI_KV = (windows, bytes); the
# card against the CPU's plain versions at MINI_VS_CPU = (windows, positions).
# 300 steps (600 before phase 13 took their time, 400 before the root
# probes took theirs; 600 steps ended at loss 1.212 on an H100, 400 at 1.498,
# 200 of 400 at 1.670: under the 2-nat gate)
MINI_STEPS = 300
MINI_EVAL_TOKENS = 50_000
MINI_KV = (16, 512)
MINI_VS_CPU = (2, 64)
# the last step's loss and the held-out f32 ppl at most 2 nats; each
# cache's ppl over the float32 cache's, Q4's over dense f32; the card's
# summed NLL within TOL_KV_NLL of the CPU's, relative
MINI_MAX_LOSS = 2.0
MINI_MAX_PPL = math.exp(2.0)
MINI_KV_RATIO = {"bfloat16": 1.001, "int8": 1.005, "int4": 1.06}
MINI_Q4_RATIO = 1.05
TOL_KV_NLL = 1e-3


def minipythia_kernel_rows(peaks, cfg, qparams):
    """K4, K7/K8, K3, K10 and K9 against their plain versions at the
    shapes phase 12 gives them: K4 (bf16) and K7/K8 ("mma_bf16") at the
    recipe's batch (B=16, H=8, T = S = 512, D=64) and K4 ("mma_3xtf32") at a
    perplexity window (B=1, T=512), through ``flash_bwd_rows`` and
    ``k4_row``; K3 over int8 and int4 caches of kv_ppl's shape (L=8, B=16,
    H=8, S=512, f32 q as at f32 compute) on the last layer at the last
    position, and K6's one-layer write of a step's rows there; K10 on the last layer of each trained Q4 layer weight and K9
    on the trained lm head at kv_ppl's n = 16 rows of f32 x."""
    import torch

    from vsim_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                     decode_attention_q,
                                                     kv_int, scatter_rows,
                                                     scatter_rows_plain)
    from vsim_tpu_torch.ops.q4_cuda import (q4_matmul_i, q4_matmul_i_plain,
                                            q4_matmul_stacked,
                                            q4_matmul_stacked_plain)
    from vsim_tpu_torch.quant.q4 import dequantize_km

    bw, bf16_peak, f32_peak = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(24)

    def bound(nbytes, ops, peak):
        t_b, t_o = nbytes / bw * 1e3, ops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    W, T = MINI_KV  # noqa: N806
    L, H, D = cfg.n_layer, cfg.n_head, cfg.head_dim  # noqa: N806
    rows = flash_bwd_rows(peaks, bound, g, ((16, H, T, D, "bfloat16"),))
    q, k, v = (torch.randn((1, H, T, D), generator=g, device=dev)
               for _ in range(3))
    rows.append(k4_row(peaks, q, k, v, f"minipythia B=1 T={T} H={H} D={D} "
                       "float32"))

    il, n_past, scale = L - 1, T - 1, 1.0 / math.sqrt(D)
    npv = torch.full((W,), n_past, dtype=torch.int32, device=dev)
    qd = torch.randn((W, H, D), generator=g, device=dev)
    for kv in ("int8", "int4"):
        Dp = D // 2 if kv == "int4" else D  # noqa: N806
        lo, hi, vdt = ((0, 256, torch.uint8) if kv == "int4"
                       else (-127, 128, torch.int8))
        k_store, v_store = ((torch.randint(lo, hi, (L, W, H, T, Dp),
                                           generator=g, device=dev,
                                           dtype=vdt),
                             (torch.rand((L, W, H, T), generator=g,
                                         device=dev) * 0.05).to(
                                 torch.bfloat16)) for _ in range(2))
        shape = (f"minipythia {kv} L={L} il={il} B={W} H={H} D={D} S={T} "
                 f"n_past={n_past} f32 q")
        got = decode_attention_q(qd, k_store, v_store, il, npv, scale=scale,
                                 round_q=False)
        ref = decode_attention_plain(qd, k_store, v_store, il, npv,
                                     scale=scale, round_q=False)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not torch.isfinite(got).all() or rel > TOL_DECODE:
            fail(f"decode_attention_q {shape}: max|err| {err:.3g} (rel "
                 f"{rel:.3g} > {TOL_DECODE})")
        ms = timed(lambda: decode_attention_q(qd, k_store, v_store, il, npv,
                                              scale=scale, round_q=False))
        plain_ms = timed(lambda: decode_attention_plain(
            qd, k_store, v_store, il, npv, scale=scale, round_q=False),
            reps=5, warmup=1)
        kd, vd = ((kv_int(st[0][il]) * st[1][il].float()[..., None])
                  for st in (k_store, v_store))
        lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
            qd[:, :, None, :], kd, vd, scale=scale))
        nk = n_past + 1
        b_ms, b_by = bound(2 * W * H * nk * (Dp + 2) + W * H * D * (4 + 4),
                           4 * W * H * nk * D, f32_peak)
        rows.append(dict(kernel="decode_attention_q", shape=shape,
                         max_abs_err=err, rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
        # K6's one-layer write of kv_ppl's step: this step's rows into
        # layer il at slot n_past, byte for byte against its plain version
        new = (torch.randint(lo, hi, (W, H, Dp), generator=g, device=dev,
                             dtype=vdt),
               (torch.rand((W, H), generator=g, device=dev) * 0.05).to(
                   torch.bfloat16),
               torch.randint(lo, hi, (W, H, Dp), generator=g, device=dev,
                             dtype=vdt),
               (torch.rand((W, H), generator=g, device=dev) * 0.05).to(
                   torch.bfloat16))
        k_ref, v_ref = (tuple(t.clone() for t in st)
                        for st in (k_store, v_store))
        scatter_rows(k_store, v_store, new, npv, il)
        scatter_rows_plain(k_ref, v_ref, new, npv, il)
        torch.cuda.synchronize()
        shape = (f"minipythia {kv} one layer L={L} il={il} B={W} H={H} "
                 f"S={T} Dp={Dp} n_past={n_past}")
        if not all(torch.equal(x, y) for x, y in zip((*k_store, *v_store),
                                                     (*k_ref, *v_ref))):
            fail(f"scatter_rows {shape}: differs from its plain version")
        del k_ref, v_ref
        ms = timed(lambda: scatter_rows(k_store, v_store, new, npv, il),
                   reps=50)
        plain_ms = timed(lambda: scatter_rows_plain(k_store, v_store, new,
                                                    npv, il), reps=5, warmup=1)
        ix = (torch.arange(W, device=dev)[:, None],
              torch.arange(H, device=dev)[None, :], npv.long()[:, None])

        def index_put():
            for (vals, sc), (rq, rs) in ((k_store, new[:2]), (v_store, new[2:])):
                vals[il].index_put_(ix, rq)
                sc[il].index_put_(ix, rs)

        lib_ms = timed(index_put, reps=50)
        b_ms, b_by = bound(2 * 2 * W * H * (Dp + 2), 0, bf16_peak)
        rows.append(dict(kernel="scatter_rows", shape=shape, max_abs_err=0.0,
                         rel_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, layers=1))
        del k_store, v_store, kd, vd

    ilt = torch.tensor(L - 1, dtype=torch.int32, device=dev)
    weights = [("q4_matmul_stacked", name, w, ilt)
               for name, w in qparams["layers"].items() if hasattr(w, "packed")]
    weights.append(("q4_matmul_i", "lm_head", qparams["lm_head"], None))
    for kname, name, w, il_t in weights:
        K, O = w.in_features, w.out_features  # noqa: N806
        x = torch.randn((W, K), generator=g, device=dev)
        if il_t is None:
            fn = lambda: q4_matmul_i(x, w.packed, w.scales)  # noqa: E731
            plain = lambda: q4_matmul_i_plain(x, w.packed, w.scales)  # noqa: E731
            lw = w
        else:
            fn = lambda: q4_matmul_stacked(  # noqa: E731
                x, w.packed, w.scales, il_t)
            plain = lambda: q4_matmul_stacked_plain(  # noqa: E731
                x, w.packed, w.scales, il_t)
            lw = w.layer(L - 1)
        shape = f"minipythia {name} n={W} {K}->{O} x=float32 planes=f32"
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not torch.isfinite(got).all() or rel > TOL_Q4:
            fail(f"{kname} {shape}: max|err| {err:.3g} (rel {rel:.3g} > "
                 f"{TOL_Q4})")
        if not torch.equal(got, fn()):
            fail(f"{kname} {shape}: differs from run to run")
        ms = timed(fn, reps=50)
        plain_ms = timed(plain, reps=5, warmup=1)
        lib_ms = timed(lambda: torch.matmul(x, dequantize_km(
            lw, torch.float32)), reps=5, warmup=1)
        b_ms, b_by = bound(K * O // 2 + K // 32 * O * 2 + W * K * 4
                           + W * O * 4, 2 * W * K * O, bf16_peak)
        rows.append(dict(kernel=kname, shape=shape, max_abs_err=err,
                         rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms))
    return rows


def recipe_step_profile(cfg, params, train_b):
    """One more recipe step on the trained params under torch.profiler,
    with a fresh optimizer: its first update has lr 0, so the weights do
    not move.  Its wall ms (synced), device busy ms and device ms by kernel
    class (``_kernel_class``); None where the profiler records no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vsim_tpu_torch.engine.train import make_train_step
    from vsim_tpu_torch.tools import train_small as ts

    init_fn, step_fn = make_train_step(cfg, ts.recipe_optimizer(MINI_STEPS))
    state = init_fn(params)
    ids = torch.from_numpy(ts.draw_batches(train_b, 1, 16, cfg.n_ctx)[0])
    ids = ids.cuda().long()
    torch.cuda.synchronize()
    by_class = collections.Counter()
    a = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(params, state, ids)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - a) * 1e3
    kernels = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_class[_kernel_class(ev.name)] += (
                ev.time_range.end - ev.time_range.start) / 1e3
            kernels += 1
    return dict(wall_ms=wall_ms, device_kernels=kernels,
                device_busy_ms=sum(by_class.values()) if by_class else None,
                device_ms_by_class=dict(by_class) or None)


def _launch_gate(label, counts, want):
    """Fail unless each kernel of ``want`` launched exactly as often as it
    says (an int) or at least once (None)."""
    for name, n in want.items():
        got = counts.get(name, 0)
        if (n is None and got == 0) or (n is not None and got != n):
            fail(f"phase 12 {label}: {name} launched {got} times, not "
                 f"{'at least once' if n is None else n}: {counts}")


def minipythia_vs_cpu_ids(eval_b):
    """The card-vs-CPU check's tokens: the first MINI_VS_CPU = (windows,
    positions) of kv_ppl's MINI_KV windows over the held-out bytes."""
    import torch

    from vsim_tpu_torch.tools import kv_ppl

    n_win, n_pos = MINI_VS_CPU
    return torch.from_numpy(kv_ppl.eval_windows(eval_b, *MINI_KV))[
        :n_win, :n_pos]


def minipythia_cpu_main(ckpt: str, path: str) -> None:
    """``chip_smoke.py --minipythia-cpu CKPT PATH``: phase 12's checkpoint
    loaded on the CPU and quantized as on the card, then each kv dtype's
    summed NLL over ``minipythia_vs_cpu_ids`` through the plain versions on
    VS_CPU_THREADS threads, saved to PATH with its seconds (``CpuChild``)."""
    import torch

    from vsim_tpu_torch.convert.store import load_params
    from vsim_tpu_torch.tools import kv_ppl
    from vsim_tpu_torch.tools import train_small as ts

    torch.set_num_threads(VS_CPU_THREADS)
    a = time.perf_counter()
    cfg, params = load_params(ckpt, device="cpu")
    qparams = ts.quantize_params(params)
    ids = minipythia_vs_cpu_ids(ts.build_corpus()[1])
    runs = {name: kv_ppl.kv_nll(cfg, qparams, ids, name)
            for name in kv_ppl.KV_DTYPES}
    torch.save(dict(runs=runs, seconds=time.perf_counter() - a),
               path + ".tmp")
    os.replace(path + ".tmp", path)


def phase_minipythia(peaks):
    """Phase 12: tools/train_small.py's recipe trained on the card for
    MINI_STEPS steps through the port's tool, saved and loaded back, the
    ppl table (f32, bf16, q4, q4_act_quant) over MINI_EVAL_TOKENS held-out
    bytes, kv_ppl at MINI_KV, then each kv dtype card vs CPU at MINI_VS_CPU
    (the CPU side in a child, ``minipythia_cpu_main``, from the save on),
    and the path's kernels at its shapes (``minipythia_kernel_rows``).
    Each of the three runs' launch counts is set to 0 just before it and
    read just after; training must launch K4, K7 and K8 once a layer a
    step, the evaluation K4, kv_ppl K10 once a layer weight, K9 once and
    (int8, int4) K6 and K3 once a layer a forward step.  Returns (numbers, rows,
    summed launches of the three runs)."""
    import numpy as np
    import torch

    from vsim_tpu_torch.convert.store import load_params, save_params
    from vsim_tpu_torch.engine.train import float_leaves
    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.tools import kv_ppl
    from vsim_tpu_torch.tools import train_small as ts

    t_start = time.perf_counter()
    cfg, W, T = ts.CFG, *MINI_KV  # noqa: N806
    L = cfg.n_layer  # noqa: N806
    train_b, eval_b = ts.build_corpus()
    corpus_s = time.perf_counter() - t_start
    launches = {}

    _build.reset_launch_counts()
    params, stats = ts.train(cfg, train_b, MINI_STEPS, log=None)
    launches["train"] = dict(_build.launch_counts)
    _launch_gate("training", launches["train"],
                 {k: L * MINI_STEPS for k in TRAIN_KERNELS})
    profiled = recipe_step_profile(cfg, params, train_b)
    losses = stats["losses"]
    last = losses[MINI_STEPS - 1]
    if not all(math.isfinite(x) for x in losses.values()) or not (
            losses[0] > 5.0 and last <= MINI_MAX_LOSS):
        fail(f"phase 12: losses {losses}: not from ~ln 256 to <= "
             f"{MINI_MAX_LOSS}")

    path = os.path.join(HERE, "build", "minipythia_smoke")
    a = time.perf_counter()
    save_params(path, cfg, params)
    cfg_l, loaded = load_params(path)
    save_load_s = time.perf_counter() - a
    if cfg_l != cfg:
        fail(f"phase 12: the checkpoint's config {cfg_l} is not {cfg}")
    for name, t in float_leaves(params).items():
        got = loaded
        for part in name.split("/"):
            got = got[part]
        if not torch.equal(got, t.detach()):
            fail(f"phase 12: leaf {name} differs after save and load")
    del params
    # the card-vs-CPU check's CPU side, beside the rest of the phase
    cpu_side = CpuChild("phase12_cpu", ["--minipythia-cpu", path])
    qparams = ts.quantize_params(loaded)

    _build.reset_launch_counts()
    toks = eval_b[:MINI_EVAL_TOKENS].astype(np.int64)
    ev = ts.eval_rows(cfg, loaded, toks, qparams=qparams, log=None)
    launches["eval"] = dict(_build.launch_counts)
    _launch_gate("evaluation", launches["eval"], {"flash_attention": None})
    table = ts.ppl_table(ev)
    if not all(math.isfinite(r["ppl"]) for r in ev.values()) or (
            ev["f32"]["ppl"] > MINI_MAX_PPL
            or ev["q4"]["ppl"] > MINI_Q4_RATIO * ev["f32"]["ppl"]):
        fail(f"phase 12: ppl table {table}: f32 above {MINI_MAX_PPL:.3f} "
             f"or q4 above {MINI_Q4_RATIO} x f32")

    ids = torch.from_numpy(kv_ppl.eval_windows(eval_b, W, T)).cuda()
    _build.reset_launch_counts()
    kv = kv_ppl.kv_rows(cfg, qparams, ids, log=None)
    launches["kv_ppl"] = dict(_build.launch_counts)
    n_q4 = sum(hasattr(w, "packed") for w in qparams["layers"].values())
    fwd = (T - 1) * len(kv_ppl.KV_DTYPES)
    _launch_gate("kv_ppl", launches["kv_ppl"], {
        "q4_matmul_stacked": fwd * L * n_q4, "q4_matmul_i": fwd,
        "decode_attention": 2 * (T - 1) * L, "scatter_rows": 2 * (T - 1) * L})
    kv_tab = kv_ppl.kv_table(kv)
    base = kv["float32"]["ppl"]
    for name, ratio in MINI_KV_RATIO.items():
        if not math.isfinite(kv[name]["ppl"]) or kv[name]["ppl"] > (
                ratio * base):
            fail(f"phase 12: {name} cache ppl {kv[name]['ppl']:.4f} above "
                 f"{ratio} x the float32 cache's {base:.4f}")

    # card vs CPU on the trained weights (comparison launches: not counted)
    a = time.perf_counter()
    sub = minipythia_vs_cpu_ids(eval_b).cuda()
    card = {name: kv_ppl.kv_nll(cfg, qparams, sub, name)
            for name in kv_ppl.KV_DTYPES}
    vs_cpu_s = time.perf_counter() - a

    a = time.perf_counter()
    ref = ref_baseline_part(path, cfg, loaded, eval_b)
    ref["seconds"] = time.perf_counter() - a

    a = time.perf_counter()
    rows = minipythia_kernel_rows(peaks, cfg, qparams)
    rows_s = time.perf_counter() - a

    a = time.perf_counter()
    cpu_res = cpu_side.result()
    vs_cpu_wait_s = time.perf_counter() - a
    vs_cpu = {}
    for name, (nll, n) in card.items():
        cpu, _ = cpu_res["runs"][name]
        rel = abs(nll - cpu) / abs(cpu)
        vs_cpu[name] = dict(card=nll, cpu=cpu, positions=n, rel=rel)
        if not rel <= TOL_KV_NLL:
            fail(f"phase 12: {name} cache, summed NLL card {nll} vs CPU "
                 f"{cpu}: rel {rel:.3g} > {TOL_KV_NLL}")
    del loaded, qparams, ids
    torch.cuda.empty_cache()
    total = collections.Counter()
    for counts in launches.values():
        total.update(counts)
    out = dict(steps=MINI_STEPS, train=stats, corpus_s=corpus_s,
               save_load_s=save_load_s, eval_tokens=MINI_EVAL_TOKENS,
               eval=ev, ppl_table=table, kv_windows=W, kv_win_len=T,
               kv=kv, kv_table=kv_tab, card_vs_cpu=vs_cpu,
               profiled_step=profiled, card_vs_cpu_s=vs_cpu_s,
               cpu_side_s=cpu_res["seconds"], cpu_side_wait_s=vs_cpu_wait_s,
               kernel_rows_s=rows_s, ref_baseline=ref,
               launches=launches, seconds=time.perf_counter() - t_start)
    return out, rows, dict(total)


MINI_REF_WINDOWS = (2, 256)  # ref_baseline's windows in phase 12


def ref_baseline_part(path, cfg, params, eval_b):
    """Phase 12's part of tools/ref_baseline.py on the trained checkpoint at
    ``path``: its export to ggml f32 and Q4_0 files (the f32 file read back
    equal to the trained leaves, the Q4 file's lm head equal to the Q4
    codec's bytes) and ``ours_nll`` on the card over MINI_REF_WINDOWS of
    held-out bytes (finite, Q4 within MINI_Q4_RATIO of f32).  The binary's
    steps need the reference tree inside the checkout (``reference/``, built
    under ``build/ref_smoke``); where it is absent they are reported as not
    run (an absent input, not a failure)."""
    import numpy as np

    from vsim_tpu_torch.convert.ggml_file import read_ggml
    from vsim_tpu_torch.quant.q4 import quantize_q4_0_np, to_ggml_q4_0_bytes
    from vsim_tpu_torch.tools import ref_baseline as rb

    gdir = os.path.join(HERE, "build", "ref_smoke")
    os.makedirs(gdir, exist_ok=True)
    f32_bin, q4_bin = (os.path.join(gdir, f"mini_{k}.bin")
                       for k in ("f32", "q4"))
    exported = rb.export_checkpoint(path, f32_bin, q4_bin)
    if exported["n_layer"] != cfg.n_layer:
        fail(f"phase 12: the export's config {exported} is not {cfg}")
    _, _, t32 = read_ggml(f32_bin, "gptneox")
    _, _, tq4 = read_ggml(q4_bin, "gptneox")
    lm = params["lm_head"].detach().cpu().float().numpy()
    if not np.array_equal(t32["embed_out.weight"].to_numpy(), lm):
        fail("phase 12: the exported f32 lm head differs from the trained")
    want = to_ggml_q4_0_bytes(*quantize_q4_0_np(lm, scale_dtype="float32"))
    if not np.array_equal(tq4["embed_out.weight"].raw, want):
        fail("phase 12: the exported Q4_0 lm head is not the codec's bytes")
    windows = rb.eval_windows(eval_b, *MINI_REF_WINDOWS)
    ours = rb.ours_nll(path, windows, "cuda")
    if not all(math.isfinite(ours[k]) for k in ("f32", "q4_0",
                                                  "q4_0_act_quant")) or (
            ours["q4_0"] > MINI_Q4_RATIO * ours["f32"]):
        fail(f"phase 12: ref_baseline's ours_nll {ours}")
    tree = os.path.join(HERE, "reference")
    if os.path.isdir(tree):
        binary = rb.build_binary(tree, os.path.join(gdir, "ref_build"))
        perf = rb.perf_run(binary, q4_bin, windows[0][:8], 16, 1)
    else:
        perf = f"not run: reference tree {tree} not found"
    return dict(files_mb=[round(os.path.getsize(f) / 1e6, 3)
                          for f in (f32_bin, q4_bin)],
                windows=list(MINI_REF_WINDOWS), ours_nll=ours,
                binary_perf=perf)


def minipythia_lines(mp):
    """Phase 12's lines: the step, the losses, both tables, the card-vs-CPU
    gaps, the seconds and the launches."""
    tr = mp["train"]
    return [
        f"mini-Pythia (phase 12) in {mp['seconds']:.1f} s: {mp['steps']} "
        f"recipe steps (B={tr['batch']} x {tr['tokens_per_step'] // tr['batch']}"
        f") in {tr['train_s']:.1f} s, step {tr['step_ms']:.2f} ms (mean of "
        f"steps 2-{mp['steps']}; the first {tr['first_step_s']:.2f} s), "
        f"{tr['tokens_per_s']:.0f} tokens/s; corpus {mp['corpus_s']:.1f} s, "
        f"save + load {mp['save_load_s']:.1f} s, card vs CPU: the card "
        f"{mp['card_vs_cpu_s']:.1f} s, the CPU {mp['cpu_side_s']:.1f} s in a "
        f"child (waited {mp['cpu_side_wait_s']:.1f} s), kernel rows "
        f"{mp['kernel_rows_s']:.1f} s",
        "  losses " + json.dumps({str(k): round(v, 4)
                                  for k, v in tr["losses"].items()}),
        f"  ppl table ({mp['eval_tokens']} held-out bytes): "
        + json.dumps(mp["ppl_table"]) + "; seconds " + json.dumps(
            {k: round(r["seconds"], 1) for k, r in mp["eval"].items()}),
        f"  kv table ({mp['kv_windows']} x {mp['kv_win_len']}): "
        + json.dumps(mp["kv_table"]) + "; seconds " + json.dumps(
            {k: round(r["seconds"], 1) for k, r in mp["kv"].items()}),
        "  card vs CPU, summed NLL rel gap: " + json.dumps(
            {k: float(f"{r['rel']:.3e}") for k, r in mp["card_vs_cpu"].items()}),
        "  launches: " + json.dumps(mp["launches"]),
        "  one recipe step profiled: " + json.dumps(mp["profiled_step"]),
        f"  ref_baseline ({mp['ref_baseline']['seconds']:.1f} s): export "
        f"{mp['ref_baseline']['files_mb']} MB (f32, Q4_0), ours_nll on "
        f"{mp['ref_baseline']['windows']} windows "
        + json.dumps(mp["ref_baseline"]["ours_nll"]) + "; the binary: "
        + json.dumps(mp["ref_baseline"]["binary_perf"]),
    ]


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
                                 "ps_tf32_kernel",
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


def f32_prefill(cfg, params):
    """The chat CLI's engine (``api/chat.py``: the config's f32 compute and
    KV, the gi math) on Pythia-12B's params: the prefill of 20 and 100
    tokens, each timed (host clock, synced; median of 3 after a warm-up),
    its device busy ms and K2's device ms (torch.profiler over one prefill)
    and its launches; every matmul of it takes K2's f32-plane instance.
    Each prompt's numbers carry K4's row at its attention's shape
    (``f32_prefill_k4_rows``).  ({prompt: numbers}, the launches of the
    counted prefills)."""
    import statistics

    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.ops import _build

    k4 = f32_prefill_k4_rows(cfg)
    eng = InferenceEngine(cfg.replace(compute_dtype="float32"), params)
    rng = torch.Generator().manual_seed(20)
    out = {}
    _build.reset_launch_counts()
    for T in (20, 100):  # noqa: N806
        prompt = torch.randint(0, cfg.n_vocab, (T,), generator=rng).tolist()
        before = dict(_build.launch_counts)
        logits = eng.prefill(prompt)
        torch.cuda.synchronize()
        counts = {k: v - before.get(k, 0)
                  for k, v in _build.launch_counts.items()
                  if v - before.get(k, 0)}
        if (tuple(logits.shape) != (1, T, cfg.n_vocab)
                or not torch.isfinite(logits).all()):
            fail(f"pythia-12b f32 prefill of {T}: logits {logits.shape}, "
                 "not all finite")
        if not counts.get("q4_matmul_ps"):
            fail(f"pythia-12b f32 prefill of {T} launched no K2: {counts}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.prefill(prompt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        busy, by_name, by_group, _ = step_device_profile(
            lambda p=prompt: eng.prefill(p), steps=1)
        out[f"prompt={T}"] = dict(
            prefill_ms=statistics.median(times), prefill_ms_runs=times,
            device_busy_ms=busy,
            k2_device_ms=None if by_group is None else by_group["q4_matmul_ps"],
            device_ms_by_kernel=by_name, launches=counts,
            k4=k4[f"prompt={T}"])
    launches = dict(_build.launch_counts)
    del eng
    torch.cuda.empty_cache()
    return out, launches


def f32_prefill_k4_rows(cfg, strict: bool = True):
    """K4 (``k4_row``) at the f32 prefill's attention shapes: B=1, the
    config's heads and head dim, T = S = 20 and 100, f32.  {prompt: row}."""
    import torch

    peaks = card_peaks(torch.cuda.get_device_name(0))
    g = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    for T in (20, 100):  # noqa: N806
        q, k, v = (torch.randn((1, cfg.n_head, T, cfg.head_dim), generator=g,
                               device="cuda") for _ in range(3))
        rows[f"prompt={T}"] = k4_row(
            peaks, q, k, v, f"prefill T={T} H={cfg.n_head} D={cfg.head_dim} "
            "float32", strict)
    return rows


def k4_line(r):
    """One line of a ``k4_row``."""
    tf = r.get("bound_3xtf32_ms")
    return (f"  K4 {r['shape']} [{r['instance']}]: {r['ms']:.4g} ms, bound "
            f"{r['bound_ms']:.3g} ({r['bound_by']})"
            + ("" if tf is None else f", 3xTF32 bound {tf:.3g}")
            + f", plain {r['plain_ms']:.4g}, SDPA {r['library_ms']:.4g} "
            f"({r['ms'] / r['library_ms']:.2f}x), rel err {r['rel_err']:.2g}"
            f" (lse {r['rel_err_lse']:.2g})")


def f32xf_margin(cfg, params):
    """Phase 7's f32xf engine (bf16 compute, int8 KV, the f32xf math) on
    phase 7's 100-token prompt: its greedy stream's first four tokens, and,
    at each of the first three (teacher-forced along that stream), the
    top-2 margin of the logits with K2's plain version in the prefill's
    9-128-row matmuls (K2's TF32 instance on the card) and max|TF32 -
    plain| over those logits (the decode steps take the same kernels on
    both sides).  The plain margin above the gap where the TF32 and plain
    argmax differ would be a fault of K2's TF32 instance."""
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.models.transformer import forward
    from vsim_tpu_torch.ops import matmul
    from vsim_tpu_torch.ops.q4_cuda import (q4_matmul_ps_plain,
                                            set_dequant_math)

    eng = InferenceEngine(cfg, params, kv_dtype="int8")
    rng = torch.Generator().manual_seed(7)  # phase 7's prompts, in order
    prompt = [torch.randint(0, cfg.n_vocab, (n,), generator=rng).tolist()
              for n in (8, 100, 300)][1]
    kernel = matmul.q4_matmul_ps

    def plain_past_8(x, packed, scales, bias, round_planes):
        fn = q4_matmul_ps_plain if x.shape[0] > 8 else kernel
        return fn(x, packed, scales, bias, round_planes)

    logits = {}
    set_dequant_math("f32xf")
    try:
        stream = eng.generate(prompt, 4,
                              SamplingParams(greedy=True)).token_ids
        for route, fn in (("tf32", kernel), ("plain", plain_past_8)):
            matmul.q4_matmul_ps = fn
            try:
                eng.cache = eng.new_cache()
                lg = [eng.prefill(prompt)[0, -1]]
                for i in range(2):
                    npv = torch.tensor([len(prompt) + i], dtype=torch.int32,
                                       device=eng.device)
                    tok = torch.tensor([[stream[i]]], device=eng.device)
                    out, _ = forward(eng.cfg, eng.params, tok, eng.cache,
                                     npv, write_first=True,
                                     slopes=eng.slopes)
                    lg.append(out[0, -1])
            finally:
                matmul.q4_matmul_ps = kernel
            logits[route] = torch.stack(lg).float()
    finally:
        set_dequant_math("gi")
    del eng
    torch.cuda.empty_cache()
    top2 = logits["plain"].topk(2, dim=-1).values
    return dict(stream=stream,
                plain_top2_margin=(top2[:, 0] - top2[:, 1]).tolist(),
                tf32_plain_gap=(logits["tf32"] - logits["plain"]).abs()
                .amax(dim=-1).tolist(),
                max_abs_logit=logits["plain"].abs().amax().item(),
                argmax_tf32=logits["tf32"].argmax(dim=-1).tolist(),
                argmax_plain=logits["plain"].argmax(dim=-1).tolist())


def f32_prefill_lines(prefill):
    """One line a prompt of ``f32_prefill``'s numbers."""
    return [line for k, v in prefill.items() for line in (
        f"  f32 compute (the chat CLI's engine) prefill {k}: "
        f"{v['prefill_ms']:.2f} ms (runs "
        + ", ".join(f"{t:.2f}" for t in v["prefill_ms_runs"])
        + f"), device busy {v['device_busy_ms']} ms, K2 "
        f"{v['k2_device_ms']} ms; launches {json.dumps(v['launches'])}",
        k4_line(v["k4"]))]


def phase_pythia(peaks):
    """Pythia-12B (GPT-NeoX, 36 layers, E=5120, F=20480, exact GELU) at full
    width, random Q4 weights from seed 0, bf16 compute, int8 KV, n_ctx 2048,
    through the stacked-layer engine (K10, K9), the default engine under
    the f32xf math (K11, K2) and under gi (K1, K2); then the chat CLI's
    f32-compute engine's prefill on the same params (``f32_prefill``)."""
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
    params = random_q4_params(cfg, seed=0, rng="device")
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
    out["f32_prefill"], launches["f32 prefill"] = f32_prefill(
        cfg, engines["gi"].params)
    # the gi and f32xf engines' params serve phases 9 and 10 after this
    kept = cfg, engines["gi"].params
    del engines
    torch.cuda.empty_cache()
    total = collections.Counter()
    for counts in launches.values():
        total.update(counts)
    return out, launches, total, kept



# ---------------------------------------------------------------------------
# phase 8: the model-loading path (ggml file -> AutoInference -> chat)
# ---------------------------------------------------------------------------

LOAD_MODEL = "OpenAssistant/oasst-sft-1-pythia-12b"  # a gptneox registry entry
# 44 byte tokens: the prefill's matmuls take K2 (9-128 rows), its attention K4
LOAD_PROMPT = "The quick brown fox jumps over the lazy dog."
LOAD_KERNELS = ("q4_gemv_ps", "q4_matmul_ps", "decode_attention",
                "flash_attention", "scatter_rows")


def byte_vocab(n: int):
    """A synthetic byte-level vocab of n entries: the 256 single bytes,
    then b"<i>" for each id i past them."""
    return [bytes([i]) for i in range(256)] + [
        f"<{i}>".encode() for i in range(256, n)]


def write_reference_ggml(path, cfg, params, vocab):
    """A gptneox ggml Q4_0 file, in the reference's names and order, of the
    port's stacked CPU params: every Q4 weight's nibbles and (bf16) scales
    as they are, widened to the stream's f32."""
    import numpy as np
    import torch

    from vsim_tpu_torch import native
    from vsim_tpu_torch.convert.ggml_file import (FTYPE_F32, FTYPE_Q4_0,
                                                  GGML_NAME_MAPS, GGMLTensor,
                                                  write_ggml)

    names = GGML_NAME_MAPS["gptneox"]
    tensors = []

    def add(slot, t, i=None):
        name = names[slot].format(i=i)
        if hasattr(t, "packed"):  # a Q4Tensor, K-major
            scales = t.scales.view(torch.int16).numpy().view(np.uint16)
            tensors.append(GGMLTensor(
                name, (t.out_features, t.in_features), FTYPE_Q4_0,
                native.kmajor_to_ggml(t.packed.numpy(), scales)))
        else:
            a = np.ascontiguousarray(t.numpy(), np.float32)
            tensors.append(GGMLTensor(name, a.shape, FTYPE_F32,
                                      a.view(np.uint8).reshape(-1)))

    layers = params["layers"]
    add("wte", params["wte"])
    for i in range(cfg.n_layer):
        for slot in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "wq", "bq", "wk",
                     "bk", "wv", "bv", "wo", "bo", "w_fc", "b_fc", "w_proj",
                     "b_proj"):
            v = layers[slot]
            add(slot, v.layer(i) if hasattr(v, "packed") else v[i], i)
    add("ln_f_w", params["ln_f_w"])
    add("ln_f_b", params["ln_f_b"])
    add("lm_head", params["lm_head"])
    hparams = dict(n_vocab=cfg.n_vocab, n_embd=cfg.n_embd, n_head=cfg.n_head,
                   n_layer=cfg.n_layer, n_rot=cfg.n_rot,
                   use_parallel_residual=int(cfg.parallel_residual), ftype=2)
    write_ggml(path, "gptneox", hparams, vocab, tensors)


def phase_loading():
    """Pythia-12B's width at depth 4, random Q4 params from seed 0, written
    as a reference ggml Q4_0 file and run from it: ``load_ggml_model``'s Q4
    leaves byte-identical to the source; ``AutoInference`` (bf16 compute as
    phase 7's, int8 KV, its tokenizer the file's vocab) against an
    InferenceEngine on the source params and the file's config, bit for
    bit: a greedy text request twice, a seeded sampled one,
    ``return_logits``; then the chat CLI (the config's f32 compute and f32
    KV)."""
    import contextlib
    import importlib.util
    import io
    import tempfile

    import numpy as np
    import torch

    from vsim_tpu_torch import native
    from vsim_tpu_torch.api import chat
    from vsim_tpu_torch.api.interface import AutoInference, VocabTokenizer
    from vsim_tpu_torch.convert.ggml_file import (FTYPE_Q4_0, load_ggml_model,
                                                  read_ggml)
    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params
    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.quant.q4 import Q4Tensor

    base = PRESETS["pythia-12b"].replace(n_layer=4)
    out = {}
    t0 = time.perf_counter()
    src = random_q4_params(base, seed=0, device="cpu")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        path = os.path.join(tmp, "pythia-12b-depth4-q4_0.bin")
        write_reference_ggml(path, base, src, byte_vocab(base.n_vocab))
        file_bytes = os.path.getsize(path)
        out.update(file_bytes=file_bytes, write_s=time.perf_counter() - t0)

        # the hot host transform alone, over every Q4 payload of the file
        _, _, tensors = read_ggml(path, "gptneox")
        q4 = [t for t in tensors.values() if t.ftype == FTYPE_Q4_0]
        a = time.perf_counter()
        for t in q4:
            native.ggml_to_kmajor(t.raw, *t.shape)
        kmajor_s = time.perf_counter() - a
        out.update(ggml_to_kmajor_s=kmajor_s, ggml_to_kmajor_gb_s=sum(
            t.raw.size for t in q4) / kmajor_s / 1e9)
        del tensors, q4

        # the loader's Q4 leaves: nibbles and bf16 scales as written
        a = time.perf_counter()
        cfg, loaded, _ = load_ggml_model(path, "gptneox", n_ctx=2048)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - a
        out.update(load_ggml_model_s=load_s,
                   load_ggml_model_gb_s=file_bytes / load_s / 1e9)
        n_q4 = 0
        for key, leaf, want in ([(k, loaded[k], src[k]) for k in
                                 ("wte", "lm_head")]
                                + [(f"layers/{k}", loaded["layers"][k], v)
                                   for k, v in src["layers"].items()]):
            if isinstance(want, Q4Tensor):
                n_q4 += 1
                if not (torch.equal(leaf.packed.cpu(), want.packed) and
                        torch.equal(leaf.scales.cpu().view(torch.int16),
                                    want.scales.view(torch.int16))):
                    fail(f"loading: {key} differs from the written weight")
        del loaded
        torch.cuda.empty_cache()

        _build.reset_launch_counts()
        a = time.perf_counter()
        ai = AutoInference(LOAD_MODEL, model_path=path, kv_dtype="int8",
                           compute_dtype="bfloat16")
        torch.cuda.synchronize()
        out.update(auto_inference_s=time.perf_counter() - a,
                   transformers=importlib.util.find_spec(
                       "transformers") is not None)
        out["auto_inference_gb_s"] = file_bytes / out["auto_inference_s"] / 1e9
        if not isinstance(ai.tokenizer, VocabTokenizer):
            fail(f"loading: the tokenizer is {type(ai.tokenizer).__name__}, "
                 "not the file's vocab")
        cfg = cfg.replace(compute_dtype="bfloat16")
        if ai.config != cfg:
            fail(f"loading: AutoInference's config {ai.config} is not the "
                 f"file's {cfg}")
        ids = ai.tokenizer.encode(LOAD_PROMPT)
        if ids != list(LOAD_PROMPT.encode()):
            fail(f"loading: VocabTokenizer gave {ids[:8]}... for bytes")
        sp = dict(top_k=40, top_p=0.9, temperature=0.9, repeat_penalty=1.3,
                  repeat_last_n=64, seed=7)
        got = {label: ai.generate(LOAD_PROMPT, 16, greedy=True,
                                  stop_tokens=())
               for label in ("greedy first", "greedy second")}
        got["sampled seed 7"] = ai.generate(LOAD_PROMPT, 16, stop_tokens=(),
                                            **sp)
        lg = ai.return_logits(ids)
        del ai
        torch.cuda.empty_cache()
        shown = io.StringIO()
        a = time.perf_counter()
        with contextlib.redirect_stdout(shown):
            rc = chat.main(["--model-path", path, "-p", "Hello", "-t", "8"])
        if rc != 0:
            fail(f"loading: chat exited {rc}")
        out.update(chat_s=time.perf_counter() - a,
                   chat_chars=len(shown.getvalue()))
        launches = dict(_build.launch_counts)
        for name in LOAD_KERNELS:
            if launches.get(name, 0) == 0:
                fail(f"loading: the path never launched {name}: {launches}")

    # the same requests through an InferenceEngine on the source params
    ref = InferenceEngine(cfg, src, n_ctx=cfg.n_ctx, kv_dtype="int8")
    requests = {}
    for label, res in got.items():
        sampling = SamplingParams(**(sp if label.startswith("sampled")
                                     else dict(greedy=True)))
        want = ref.generate(ids, 16, sampling).token_ids
        if res["generated_token_ids"] != want or \
                res["token_ids"][:len(ids)] != ids:
            fail(f"loading: {label}: AutoInference "
                 f"{res['generated_token_ids']} != the engine's {want}")
        tm = res["timings"]
        requests[label] = dict(
            prefill_ms=tm["prefill_s"] * 1e3,
            decode_ms_per_token=tm["decode_s"] * 1e3 / (tm["tokens"] - 1),
            tokens=want)
    lg_ref = ref.generate(ids, 0, return_logits=True).logits
    if lg.shape != (len(ids), cfg.n_vocab) or not np.isfinite(lg).all() \
            or not np.array_equal(lg, lg_ref):
        fail("loading: return_logits differs from the engine's")
    del ref
    torch.cuda.empty_cache()
    out.update(requests=requests, q4_leaves=n_q4, n_layer=base.n_layer,
               seconds=time.perf_counter() - t0)
    return out, launches


# ---------------------------------------------------------------------------
# phase 9: BLOOM, GPT-2 and CodeGen at full width, Pythia-12B serving
# ---------------------------------------------------------------------------

# K1, K3, K4 and K6 on an InferenceEngine's path; K1, K4, K5 and K6 on a
# ServingEngine's (SERVING_KERNELS)
ARCH_KERNELS = ("q4_gemv_ps", "decode_attention", "flash_attention",
                "scatter_rows")
# (preset, the KV dtypes of its InferenceEngines, whether it also serves)
ARCH_RUNS = (("bloom-7b1", ("int8",), True),
             ("gpt2", ("int8", "int4"), False),
             ("codegen-2b", ("int8", "int4"), False))


def fill_vectors(cfg, params, seed: int):
    """Seeded small values in the bias vectors the architecture has and in
    GPT-2's position table (random_q4_params leaves them 0), so that the
    kernels' bias inputs and the position lookup carry data."""
    import torch

    layers = params["layers"]
    dev = layers["b_fc"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    names = ["b_fc", "b_proj"] + (["bq", "bk", "bv"] if cfg.qkv_bias
                                  else []) + (["bo"] if cfg.attn_out_bias
                                              else [])
    for t in [layers[k] for k in names] + (
            [params["wpe"]] if cfg.learned_pos else []):
        t.copy_(torch.randn(t.shape, generator=g, device=dev) * 0.02)
    return params


def arch_params(name: str, seed: int = 0, **replace):
    """A preset's config (bf16 compute unless ``replace`` says otherwise)
    and random Q4 params on the card with filled vectors."""
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params

    cfg = PRESETS[name].replace(**dict(dict(compute_dtype="bfloat16"),
                                       **replace))
    return cfg, fill_vectors(cfg, random_q4_params(cfg, seed=seed), seed)


def bloom_kernel_checks(cfg, params):
    """The kernels at the shapes BLOOM-7b1's path gives them that phase 2
    does not hold: K1 over the 250,880-column lm head at n = 1, K2 on the
    fused qkv weight with its bias at 100 rows (a prefill), K3 (B = 1) and
    K5 (B = 8) with its ALiBi slopes at H = 32, D = 128 over int8 caches,
    and K4 with them at T = 300; each against its plain version:
    {case: (max|err|, rel)}."""
    import torch

    from vsim_tpu_torch.models.transformer import alibi_slopes
    from vsim_tpu_torch.ops.attention import (flash_attention_fwd,
                                              flash_attention_plain)
    from vsim_tpu_torch.ops.decode_attention import (
        decode_attention_fresh, decode_attention_fresh_plain,
        decode_attention_plain, decode_attention_q)
    from vsim_tpu_torch.ops.matmul import ps_round_planes
    from vsim_tpu_torch.ops.q4_cuda import (get_dequant_math, q4_gemv_ps,
                                            q4_gemv_ps_plain, q4_matmul_ps,
                                            q4_matmul_ps_plain)

    g = torch.Generator(device="cuda").manual_seed(9)
    H, D, S = cfg.n_head, cfg.head_dim, 2048  # noqa: N806
    slopes = alibi_slopes(H, "cuda")
    out = {}

    def check(case, got, ref, tol):
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not torch.isfinite(got).all() or rel > tol:
            fail(f"bloom {case}: max|err| {err:.3g} (rel {rel:.3g} > {tol})")
        out[case] = (err, rel)

    lm = params["lm_head"]
    x = torch.randn((1, cfg.n_embd), generator=g, device="cuda").to(
        torch.bfloat16)
    check(f"K1 lm_head n=1 {cfg.n_embd}->{lm.out_features}",
          q4_gemv_ps(x, lm.packed, lm.scales),
          q4_gemv_ps_plain(x, lm.packed, lm.scales), TOL_Q4)
    lp = params["layers"][0]
    w, b = lp["w_qkv"], lp["b_qkv"].to(torch.float32).contiguous()
    x = torch.randn((100, cfg.n_embd), generator=g, device="cuda").to(
        torch.bfloat16)
    r = ps_round_planes(100, x.dtype, get_dequant_math())
    check("K2 qkv+bias n=100", q4_matmul_ps(x, w.packed, w.scales, b, r),
          q4_matmul_ps_plain(x, w.packed, w.scales, b, r), TOL_Q4)

    def side(B):  # noqa: N803
        vals = torch.randint(-127, 128, (2, B, H, S, D), generator=g,
                             device="cuda", dtype=torch.int8)
        sc = (torch.rand((2, B, H, S), generator=g, device="cuda")
              * 0.05).to(torch.bfloat16)
        return vals, sc

    kw = dict(scale=D ** -0.5, slopes=slopes, round_q=True)
    k, v = side(1), side(1)
    q = torch.randn((1, H, D), generator=g, device="cuda")
    npv = torch.tensor([1500], dtype=torch.int32, device="cuda")
    check("K3 alibi B=1 n_past=1500", decode_attention_q(q, k, v, 1, npv, **kw),
          decode_attention_plain(q, k, v, 1, npv, **kw), TOL_DECODE)
    k, v = side(8), side(8)
    q = torch.randn((8, H, D), generator=g, device="cuda")
    npv = torch.tensor([0, 1, 127, 300, 1024, 1500, 2047, 2048],
                       dtype=torch.int32, device="cuda")
    rows = (torch.randint(-127, 128, (8, H, D), generator=g, device="cuda",
                          dtype=torch.int8),
            torch.rand((8, H), generator=g, device="cuda").to(torch.bfloat16),
            torch.randint(-127, 128, (8, H, D), generator=g, device="cuda",
                          dtype=torch.int8),
            torch.rand((8, H), generator=g, device="cuda").to(torch.bfloat16))
    check("K5 alibi B=8", decode_attention_fresh(q, k, v, 1, npv, rows, **kw),
          decode_attention_fresh_plain(q, k, v, 1, npv, rows, **kw),
          TOL_DECODE)
    del k, v
    q, kk, vv = (torch.randn((1, H, 300, D), generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    fkw = dict(n_past=0, scale=D ** -0.5, slopes=slopes)
    check("K4 alibi T=300", flash_attention_fwd(q, kk, vv, **fkw)[0],
          flash_attention_plain(q, kk, vv, **fkw)[0], TOL_FLASH_BF16)
    torch.cuda.empty_cache()
    return out


def arch_inference(label, cfg, params, kvs, peaks, n_tok: int = 32):
    """Graphed InferenceEngines (one a KV dtype, sharing one load): prompts
    of 8, 100 and 300 tokens (``n_tok`` new tokens, greedy) and a seeded
    sampled request twice, with ARCH_KERNELS launched; one prompt and the
    sampled request again with the graph off; the step after a 300-token
    prompt (decode_step_report, K6 once a layer).  Returns (numbers,
    launches by KV dtype, the engines' params)."""
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.ops import _build

    greedy = SamplingParams(greedy=True)
    rng = torch.Generator().manual_seed(3)
    prompts = {n: torch.randint(0, cfg.n_vocab, (n,), generator=rng).tolist()
               for n in (8, 100, 300)}
    out, launches, p = {}, {}, params
    for kv in kvs:
        eng = InferenceEngine(cfg, p, kv_dtype=kv)
        p = eng.params
        step_bytes = q4_step_bytes(p)
        _build.reset_launch_counts()
        requests, streams = {}, {}
        for n, prompt in prompts.items():
            r = eng.generate(prompt, n_tok, greedy)
            if len(r.token_ids) != n_tok or not all(
                    0 <= t < cfg.n_vocab for t in r.token_ids):
                fail(f"{label} {kv} prompt {n}: bad tokens "
                     f"{r.token_ids[:8]}...")
            tm = r.timings
            streams[n] = r.token_ids
            requests[f"prompt={n}"] = dict(
                prefill_ms=tm["prefill_s"] * 1e3,
                decode_ms_per_token=tm["decode_s"] * 1e3 / (tm["tokens"] - 1))
        runs = [eng.generate(prompts[8], 16, SamplingParams(seed=42)).token_ids
                for _ in range(2)]
        if len(runs[0]) != 16 or runs[0] != runs[1] or not all(
                0 <= t < cfg.n_vocab for t in runs[0]):
            fail(f"{label} {kv} sampled request: {runs[0][:8]}... then "
                 f"{runs[1][:8]}...")
        launches[kv] = run = dict(_build.launch_counts)
        for k in ARCH_KERNELS:
            if run.get(k, 0) == 0:
                fail(f"{label} {kv} InferenceEngine never launched {k}: {run}")
        requests["eager prompt=100"] = eager_check(
            f"{label} {kv}", lambda: InferenceEngine(
                cfg, p, kv_dtype=kv, cuda_graph=False), prompts[100],
            streams[100], prompts[8], runs[0])
        torch.cuda.empty_cache()
        logits = eng.prefill(prompts[300])
        _, _, step = eng.start(prompts[300], logits[:, -1], greedy)
        report = decode_step_report(step)
        row_write_check(f"{label} {kv}", report, cfg.n_layer)
        out[kv] = dict(requests=requests, step=report,
                       weight_bytes_per_step=step_bytes,
                       bound_ms_per_token=step_bytes / peaks[0] * 1e3)
        del eng, step
        torch.cuda.empty_cache()
    return out, launches, p


def serve_eager_check(label, srv, make_eager, prompts):
    """The first 4 of phase 4's prompts, 16 new tokens each, through the
    graphed engine ``srv`` (idle after its run) and an engine with the
    graph off: the same streams.  Returns the eager run's tokens/s."""
    import torch

    def run(eng):  # run() also returns the requests of the earlier run
        a = time.perf_counter()
        out = eng.run(prompts[:4], 16, stop_tokens=())
        torch.cuda.synchronize()
        return [out[i].generated for i in sorted(out)[-4:]], \
            time.perf_counter() - a

    want, _ = run(srv)
    eager = make_eager()
    eager.warmup()
    got, wall = run(eager)
    if got != want:
        fail(f"{label}: the eager engine's streams {[g[:6] for g in got]} "
             f"differ from the replayed one's {[w[:6] for w in want]}")
    del eager
    torch.cuda.empty_cache()
    return sum(len(g) for g in got) / wall


def arch_serving(label, cfg, params):
    """A graphed ServingEngine (int8 KV, 8 slots) under phase 4's traffic,
    SERVING_KERNELS launched; then ``serve_eager_check``: (numbers,
    launches)."""
    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.ops import _build

    prompts, n_pred = serve_traffic(cfg.n_vocab)
    srv = ServingEngine(cfg, params, max_batch=8, kv_dtype="int8")
    warmup_s = srv.warmup()
    _build.reset_launch_counts()
    wall, reqs, st = serve_scenario(srv, prompts, n_pred)
    launches = dict(_build.launch_counts)
    for k in SERVING_KERNELS:
        if launches.get(k, 0) == 0:
            fail(f"{label} ServingEngine never launched {k}: {launches}")
    if len(reqs) != 13 or any(
            len(r.generated) != n or not all(0 <= t < cfg.n_vocab
                                             for t in r.generated)
            for r, n in zip(reqs, n_pred)):
        fail(f"{label} serving: a request has the wrong tokens or count")
    eager_tps = serve_eager_check(
        f"{label} serving", srv, lambda: ServingEngine(
            cfg, params, max_batch=8, kv_dtype="int8", cuda_graph=False),
        prompts)
    del srv
    n_tok = sum(len(r.generated) for r in reqs)
    chunk = st["serve/step_chunk"]
    ttft = sorted((r.first_token_s - r.submitted_s) * 1e3 for r in reqs)
    return dict(warmup_s=warmup_s, wall_s=wall, tokens=n_tok,
                tokens_per_s=n_tok / wall, ttft_ms_min=ttft[0],
                ttft_ms_median=ttft[6], ttft_ms_max=ttft[-1],
                ms_per_chunk_step=chunk.wall_s * 1e3 / (chunk.calls * 8),
                eager_tokens_per_s=eager_tps, streams_equal=True), launches


def phase_archs(peaks, clock: PartTimer):
    """Phase 9's BLOOM-7b1, GPT-2 and CodeGen-2B runs, one model on the card
    at a time; CodeGen-2B's params also serve phase 10's f32 run (returned
    with its config)."""
    import torch

    out, launches = {}, {}
    keep = None
    for name, kvs, serves in ARCH_RUNS:
        t0 = time.perf_counter()
        cfg, params = arch_params(name)
        res = dict(setup_s=time.perf_counter() - t0)
        if name == "bloom-7b1":
            from vsim_tpu_torch.engine.generate import engine_params
            params = engine_params(cfg, params, params["ln_f_w"].device)
            res["kernel_checks"] = bloom_kernel_checks(cfg, params)
        res["inference"], inf_launches, params = arch_inference(
            name, cfg, params, kvs, peaks)
        for kv, counts in inf_launches.items():
            launches[f"{name} {kv}"] = counts
        if serves:
            res["serving"], launches[f"{name} serving"] = arch_serving(
                name, cfg, params)
        res["seconds"] = time.perf_counter() - t0
        clock.seconds[name] += res["seconds"]
        out[name] = res
        if name == "codegen-2b":
            keep = cfg, params
        del params
        torch.cuda.empty_cache()
    return out, launches, keep


# ---------------------------------------------------------------------------
# phase 10: speculative decoding at full width
# ---------------------------------------------------------------------------

SPEC_ENGINE_KERNELS = ("q4_gemv_ps", "flash_attention")  # K1 verify, K4
SPEC_DRAFTER_KERNELS = ("decode_attention_fresh", "scatter_rows")  # K5, K6
SPEC_SERVING_KERNELS = ("q4_matmul_ps", "flash_attention")  # K2 40 rows, K4


def route_gaps(cfg, params, slopes, prompts, streams, gamma: int,
               write_first: bool, n_ctx: int):
    """The plain step's logits and the verify's, teacher-forced along the
    plain ``streams`` (every row prefilled alone at its prompt's length,
    then stepped together at ragged n_past; a finished row at the
    sentinel): the plain route one token a step (``write_first``: the
    InferenceEngine's write-then-K3 step, else the serving step's deferred
    K5/K6 one), the verify route gamma + 1 tokens a forward, as the
    speculative cycle runs it.  Returns per row (margins, gaps): index
    k - 1 holds, for token k >= 1, the top-2 margin of the plain logits
    that give it and max|verify - plain| over those logits (token 0 comes
    from the prefill on both routes), the largest |plain logit| of the row
    and the top-2 margin of the prefill's last logits (token 0's)."""
    import torch

    from vsim_tpu_torch.models.transformer import forward, init_cache

    dev, B, G = params["ln_f_w"].device, len(prompts), gamma + 1  # noqa: N806
    cache = init_cache(cfg, B, n_ctx=n_ctx, device=dev)
    margins0 = []
    for b, prompt in enumerate(prompts):
        one = init_cache(cfg, 1, n_ctx=len(prompt), device=dev)
        lg, _ = forward(cfg, params, torch.tensor([prompt], device=dev), one,
                        0, fresh_kv=True, slopes=slopes)
        top2 = lg[0, -1].topk(2).values
        margins0.append(float(top2[0] - top2[1]))
        for side in ("k", "v"):
            for d, s in zip(*(t if isinstance(t, tuple) else (t,)
                              for t in (cache[side], one[side]))):
                d[:, b, :, :len(prompt)] = s[:, 0]
    vcache = {side: tuple(t.clone() for t in c) if isinstance(c, tuple)
              else c.clone() for side, c in cache.items()}
    lens = torch.tensor([len(s) for s in streams])
    L = int(lens.max())  # noqa: N806
    toks = torch.zeros((B, L + G), dtype=torch.long)
    for b, s in enumerate(streams):
        toks[b, :len(s)] = torch.tensor(s)
    toks = toks.to(dev)
    n0 = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    plain = torch.zeros((B, L, cfg.n_vocab), device=dev)
    verify = torch.zeros_like(plain)
    for s in range(L - 1):
        npv = torch.where(s < lens - 1, n0 + s, n_ctx).to(dev, torch.int32)
        lg, _ = forward(cfg, params, toks[:, s:s + 1], cache, npv,
                        write_first=write_first, slopes=slopes)
        plain[:, s + 1] = lg[:, 0]
    for s in range(0, L - 1, G):
        npv = torch.where(s < lens - 1, n0 + s, n_ctx).to(dev, torch.int32)
        lg, _ = forward(cfg, params, toks[:, s:s + G], vcache, npv,
                        slopes=slopes)
        k = min(G, L - 1 - s)
        verify[:, s + 1:s + 1 + k] = lg[:, :k]
    top2 = plain.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).tolist()
    gap = (verify - plain).abs().amax(dim=-1).tolist()
    scale = plain.abs().amax(dim=(1, 2)).tolist()
    n = lens.tolist()
    return ([margin[b][1:n[b]] for b in range(B)],
            [gap[b][1:n[b]] for b in range(B)], scale, margins0)


def split_check(label, got, want, margins, gaps, scales, margins0=None):
    """Speculative streams ``got`` against the plain ones ``want``: each
    equal up to its first differing token k, and there the plain step's
    top-2 margin no larger than the largest |verify - plain| logit gap
    measured at tokens 1..k of any row (teacher-forced along the plain
    streams, so the gap at k is the two routes' own difference there: a
    split at token 1 has no token before it).  At D % 128 == 0 the plain
    step's decode kernel rounds q to bf16 and the verify's einsum does not,
    so the routes may part at a near-tie; a split at a margin above the
    gap fails.  At bf16 the einsum route also rounds the dequantized keys
    and the probabilities to bf16 where the kernels keep f32, and over a
    full-depth random-weight model the gap grows to a large share of
    max|logit| (``gap_rel_max``, reported): the bf16 rule then bounds
    little, the graphed-vs-eager and f32 checks bound the rest.  Token 0
    comes from a prefill on both sides and must match, except where
    ``margins0`` is given (serving: the two runs admit a request beside
    other requests, so its prefill's rows are batched differently): a
    split there is held to the largest gap of the run with the prefill's
    margin.  Returns what was compared."""
    rel = max(x / s for gp, s in zip(gaps, scales) for x in gp)
    splits, compared = [], 0
    for b, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            fail(f"{label}: row {b} has {len(g)} tokens, the plain {len(w)}")
        k = next((i for i, (x, y) in enumerate(zip(g, w)) if x != y), None)
        compared += len(w) if k is None else k
        if k is None:
            continue
        if k == 0 and margins0 is None:
            fail(f"{label}: row {b} differs at the prefill's token")
        bound = max(x for gp in gaps for x in (gp[:k] if k else gp))
        margin = margins[b][k - 1] if k else margins0[b]
        splits.append(dict(row=b, token=k, margin=margin, gap_upto=bound,
                           gap_at=gaps[b][k - 1] if k else None))
        if margin > bound:
            fail(f"{label}: row {b} splits from the plain stream at token "
                 f"{k}, where the plain margin {margin:.4g} exceeds the "
                 f"largest route gap up to it {bound:.4g}")
    return dict(compared_tokens=compared, rows=len(want),
                gap_max=max(x for gp in gaps for x in gp), gap_rel_max=rel,
                margin_min=min(x for m in margins for x in m), splits=splits)


def repeat_prompt(n_vocab: int, seed: int, period: int = 12,
                  times: int = 4):
    """A seeded prompt that repeats one pattern: random-weight greedy
    streams fall into loops, and the n-gram drafter then finds its
    matches."""
    import torch

    rng = torch.Generator().manual_seed(seed)
    return torch.randint(0, n_vocab, (period,), generator=rng).tolist() * times


def spec_run(label, cfg, params, make_drafter, prompt, n_tok, plain_eng,
             check_split=True, report_prompt=None):
    """One speculative engine against the plain one on ``prompt``, each
    timed after a 2-token request has captured its graph: the graphed
    stream, the eager one's first 16 tokens (equal bit for bit), the plain
    stream, and the split rule (or, ``check_split=False``, equality with the plain
    stream, reported with the margins).  ``report_prompt``: the verify
    cycle alone after it (decode_step_report).  Returns (numbers,
    launches of the graphed run)."""
    import torch

    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.engine.speculative import SpeculativeEngine
    from vsim_tpu_torch.ops import _build

    greedy = SamplingParams(greedy=True)
    plain_eng.generate(prompt, 2, greedy)  # its step captured: not timed
    plain = plain_eng.generate(prompt, n_tok, greedy)
    spec = SpeculativeEngine(cfg, params, make_drafter())
    _build.reset_launch_counts()
    spec.generate(prompt, 2)  # the cycle captured
    res = spec.generate(prompt, n_tok)
    launches = dict(_build.launch_counts)
    # the eager cycle runs 7-30x slower: its first 16 tokens are compared
    eager = SpeculativeEngine(cfg, spec.params, make_drafter(),
                              cuda_graph=False).generate(prompt,
                                                         min(n_tok, 16))
    if eager.token_ids != res.token_ids[:len(eager.token_ids)]:
        fail(f"{label}: the eager stream {eager.token_ids[:12]}... differs "
             f"from the replayed one {res.token_ids[:12]}...")
    if not all(0 <= t < cfg.n_vocab for t in res.token_ids):
        fail(f"{label}: a token outside the vocab")
    margins, gaps, scales, _ = route_gaps(cfg, spec.params, spec.slopes,
                                          [prompt], [plain.token_ids],
                                          spec.gamma, True, spec.n_ctx)
    if not check_split and res.token_ids != plain.token_ids:
        k = next(i for i, (x, y) in enumerate(zip(res.token_ids,
                                                   plain.token_ids)) if x != y)
        fail(f"{label}: the speculative stream parts from the plain one at "
             f"token {k} (plain margin "
             f"{margins[0][k - 1] if k else float('nan'):.4g})")
    split = split_check(label, [res.token_ids], [plain.token_ids], margins,
                        gaps, scales)
    tm, pt = res.timings, plain.timings
    out = dict(tokens=len(res.token_ids), cycles=res.cycles,
               tokens_per_cycle=res.tokens_per_cycle,
               ms_per_token=tm["decode_s"] * 1e3 / (tm["tokens"] - 1),
               eager_ms_per_token=eager.timings["decode_s"] * 1e3
               / (eager.timings["tokens"] - 1),
               plain_ms_per_token=pt["decode_s"] * 1e3 / (pt["tokens"] - 1),
               eager_equal=True, split=split)
    if report_prompt is not None:
        step = spec.start(report_prompt)
        rep = decode_step_report(step)
        for mode in ("eager", "graphed"):
            rep[mode].pop("ordered")
        out["cycle"] = rep
    del spec
    torch.cuda.empty_cache()
    return out, launches


def spec_serving(cfg, params, plain_streams):
    """The GPT-J-6B ServingEngine with NgramDrafter(3, 4) under phase 4's
    traffic, graphed (then ``serve_eager_check``), against phase 4's int8
    plain streams by the split rule (the route gaps at B = 8, two batches
    of rows, through the serving step's route): (numbers, launches)."""
    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.engine.speculative import NgramDrafter
    from vsim_tpu_torch.ops import _build

    cfg = cfg.replace(kv_dtype="int8")
    prompts, n_pred = serve_traffic(cfg.n_vocab)

    def engine(graphed):
        return ServingEngine(cfg, params, max_batch=8, kv_dtype="int8",
                             cuda_graph=graphed, drafter=NgramDrafter(3, 4))

    srv = engine(True)
    srv.warmup()
    _build.reset_launch_counts()
    wall, reqs, st = serve_scenario(srv, prompts, n_pred)
    launches = dict(_build.launch_counts)
    streams = [r.generated for r in reqs]
    cycles, emitted = srv.spec_cycles, srv.spec_emitted
    for k in SPEC_SERVING_KERNELS:
        if launches.get(k, 0) == 0:
            fail(f"speculative serving never launched {k}: {launches}")
    eager_tps = serve_eager_check("speculative serving", srv,
                                  lambda: engine(False), prompts)
    slopes, gparams = srv.slopes, srv.params
    del srv
    if any(len(s) != n for s, n in zip(streams, n_pred)):
        fail("speculative serving: a request has the wrong token count")
    margins, gaps, scales, margins0 = [], [], [], []
    for lo in (0, 8):
        m, g, sc, m0 = route_gaps(cfg, gparams, slopes, prompts[lo:lo + 8],
                                  plain_streams[lo:lo + 8], 4, False,
                                  cfg.n_ctx)
        margins += m
        gaps += g
        scales += sc
        margins0 += m0
    split = split_check("speculative serving", streams, plain_streams,
                        margins, gaps, scales, margins0)
    n_tok = sum(len(s) for s in streams)
    spec = st["serve/spec_step"]
    return dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                eager_tokens_per_s=eager_tps,
                spec_cycles=cycles, spec_emitted=emitted,
                ms_per_spec_step=spec.wall_s * 1e3 / spec.calls,
                eager_equal=True, split=split, streams=streams), launches


def pythia_drafter_cfg(target):
    """pythia-70m's widths with the target's vocab, bf16, int8 KV."""
    from vsim_tpu_torch.models.config import PRESETS

    return PRESETS["pythia-70m"].replace(
        n_vocab=target.n_vocab, compute_dtype=target.compute_dtype,
        kv_dtype="int8")


def phase_spec_gptj(cfg, params):
    """Phase 10's GPT-J-6B engine run on phase 3's params (bf16, int8 KV):
    SpeculativeEngine with NgramDrafter(3, 4) on a repeating prompt (64 new
    tokens), then the verify cycle's report after a 300-token prompt."""
    import torch

    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.speculative import NgramDrafter

    cfg = cfg.replace(kv_dtype="int8")
    plain = InferenceEngine(cfg, params, kv_dtype="int8")
    rng = torch.Generator().manual_seed(0)
    long_prompt = torch.randint(0, cfg.n_vocab, (300,), generator=rng).tolist()
    out, launches = spec_run(
        "gpt-j ngram", cfg, params, lambda: NgramDrafter(3, 4),
        repeat_prompt(cfg.n_vocab, 5), 64, plain, report_prompt=long_prompt)
    for k in SPEC_ENGINE_KERNELS:
        if launches.get(k, 0) == 0:
            fail(f"gpt-j SpeculativeEngine never launched {k}")
    return out, launches


def phase_spec_pythia(cfg, params):
    """Phase 10's Pythia-12B run on phase 7's params: a ModelDrafter of
    pythia-70m's widths (seed 5, gamma 4), 48 new tokens."""
    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.speculative import ModelDrafter
    from vsim_tpu_torch.models.init import random_q4_params

    dcfg = pythia_drafter_cfg(cfg)
    dparams = random_q4_params(dcfg, seed=5)
    plain = InferenceEngine(cfg, params, kv_dtype="int8")
    out, launches = spec_run(
        "pythia-12b model drafter", cfg.replace(kv_dtype="int8"), params,
        lambda: ModelDrafter(dcfg, dparams, gamma=4),
        repeat_prompt(cfg.n_vocab, 6, period=16, times=2), 48, plain)
    for k in SPEC_ENGINE_KERNELS + SPEC_DRAFTER_KERNELS:
        if launches.get(k, 0) == 0:
            fail(f"pythia-12b SpeculativeEngine never launched {k}")
    return out, launches


def phase_spec_codegen_f32(cfg, params):
    """Phase 10's strict run: CodeGen-2B (D = 80, neither route rounds q)
    with f32 compute and int8 KV, NgramDrafter(3, 4): on two prompts the
    speculative stream must equal the plain greedy stream token for token;
    each prompt's smallest top-2 margin is printed."""
    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.speculative import NgramDrafter

    cfg = cfg.replace(compute_dtype="float32", kv_dtype="int8")
    plain = InferenceEngine(cfg, params, kv_dtype="int8")
    out, launches = {}, {}
    for i, prompt in enumerate((repeat_prompt(cfg.n_vocab, 7),
                                repeat_prompt(cfg.n_vocab, 8, period=40,
                                              times=1))):
        out[f"prompt {i}"], launches[f"prompt {i}"] = spec_run(
            f"codegen-2b f32 prompt {i}", cfg, params,
            lambda: NgramDrafter(3, 4), prompt, 48, plain, check_split=False)
    return out, launches


def arch_lines(archs, clock: PartTimer):
    """Phase 9's lines: its seconds by part, then by model each engine's
    ms a token beside its bound, its step after a 300-token prompt and
    the serving runs."""
    lines = [f"phase 9 (BLOOM-7b1, GPT-2, CodeGen-2B, Pythia-12B serving) in "
             f"{sum(clock.seconds.values()):.1f} s: "
             + json.dumps({k: round(v, 1) for k, v in clock.seconds.items()})]
    for name, res in archs.items():
        if "kernel_checks" in res:
            lines.append(f"  {name} kernels vs plain (max|err|, rel): "
                         + json.dumps({k: [float(f"{x:.3g}") for x in v]
                                       for k, v in
                                       res["kernel_checks"].items()}))
        for kv, r in res.get("inference", {}).items():
            reqs = r["requests"]
            lines.append(
                f"  {name} {kv}: ms a token "
                + ", ".join(f"{k} {v['decode_ms_per_token']:.3f}"
                            for k, v in reqs.items() if "eager" not in k)
                + ", eager prompt=100 "
                f"{reqs['eager prompt=100']['decode_ms_per_token']:.3f}; "
                f"bound {r['bound_ms_per_token']:.3f} ms "
                f"({r['weight_bytes_per_step'] / 1e9:.3f} GB of Q4 a step); "
                "greedy and sampled streams equal with the graph off")
            lines.append(step_line(f"{name} {kv} step at n_past 300",
                                   r["step"]))
            lines.append("    by kernel " + json.dumps(
                {k: round(v, 4) for k, v in
                 (r["step"]["graphed"]["device_ms_by_kernel"] or {}).items()}))
        if "serving" in res:
            v = res["serving"]
            lines.append(
                f"  {name} serving (int8, 8 slots, 13 requests): "
                f"{v['tokens_per_s']:.1f} tokens/s graphed, "
                f"{v['eager_tokens_per_s']:.1f} eager (streams equal), "
                f"{v['ms_per_chunk_step']:.2f} ms a chunk step, TTFT "
                f"{v['ttft_ms_min']:.1f}/{v['ttft_ms_median']:.1f}/"
                f"{v['ttft_ms_max']:.1f} ms (min/median/max)")
    return lines


def spec_lines(spec, clock: PartTimer, serving):
    """Phase 10's lines: its seconds by part, each run's ms a token and
    tokens a cycle beside the plain engine's, the split rule's numbers,
    the verify cycle's step, the speculative serving run beside phase 4's."""
    lines = [f"phase 10 (speculative decoding) in "
             f"{sum(clock.seconds.values()):.1f} s: "
             + json.dumps({k: round(v, 1) for k, v in clock.seconds.items()})]
    for label, r in spec.items():
        sp = r["split"]
        split = (f"compared {sp['compared_tokens']} tokens of "
                 f"{sp['rows']} row(s), largest verify-plain logit gap "
                 f"{sp['gap_max']:.4g} ({sp['gap_rel_max']:.3g} of "
                 "max|logit|), smallest plain margin "
                 f"{sp['margin_min']:.4g}, splits "
                 + json.dumps([{k: (round(v, 5) if isinstance(v, float)
                                    else v) for k, v in x.items()}
                               for x in sp["splits"]]))
        if "spec_cycles" in r:
            lines.append(
                f"  {label} (NgramDrafter(3, 4), phase 4's traffic): "
                f"{r['tokens_per_s']:.1f} tokens/s graphed, "
                f"{r['eager_tokens_per_s']:.1f} eager (streams equal); phase "
                f"4's plain int8 {serving['int8']['tokens_per_s']:.1f}; "
                f"{r['spec_emitted'] / r['spec_cycles']:.2f} tokens a step "
                f"over the active slots ({r['spec_cycles']} steps), "
                f"{r['ms_per_spec_step']:.2f} ms a step; {split}")
            continue
        lines.append(
            f"  {label}: {r['ms_per_token']:.3f} ms a token graphed "
            f"({r['eager_ms_per_token']:.3f} eager, equal), "
            f"{r['tokens_per_cycle']:.2f} tokens a cycle ({r['cycles']} "
            f"cycles, {r['tokens']} tokens); plain engine "
            f"{r['plain_ms_per_token']:.3f} ms a token; {split}")
        if "cycle" in r:
            rep = r["cycle"]
            lines.append(step_line(f"{label} verify cycle at n_past 300",
                                   rep))
            lines.append("    by kernel " + json.dumps(
                {k: round(v, 4) for k, v in
                 (rep["graphed"]["device_ms_by_kernel"] or {}).items()}))
    return lines


# ---------------------------------------------------------------------------
# phase 11: tensor, sequence and pipeline parallelism (parallel/)
# ---------------------------------------------------------------------------

# what tensor-parallel serving launches on each rank: K10 (the layers), K9
# (the lm head's rows), K5 + K6 (the deferred step over the rank's heads),
# K4 (admission prefill)
PARALLEL_KERNELS = ("q4_matmul_stacked", "q4_matmul_i",
                    "decode_attention_fresh", "scatter_rows",
                    "flash_attention")
# phase 5's depth-2 prompts at GPT-J width (seed-1 weights, f32, int8 KV):
# every greedy step's top-2 margin is >= 1.09e-3 of max|logit| on the CPU
PARALLEL_PROMPTS = [list(range(100, 112)), list(range(7, 10)),
                    list(range(1000, 1020))]
TOL_TP = 1e-4  # TP / SP logits vs one card's, of max|logit|: sum order
# sharded speculative serving: K10 / K9 in the verify (40 rows), K4 at
# admission; the verify attends through PyTorch's einsum
SPEC_PARALLEL_KERNELS = ("q4_matmul_stacked", "q4_matmul_i",
                         "flash_attention")
SPEC_TP_TOKENS = 8  # a request's tokens in phase 11's speculative run


def shard_kernel_rows(peaks):
    """K10, K9, K5, K6 and K4 against their plain versions at the shapes
    one rank of GPT-J-6B's tensor-parallel serving gives them, tp = 2 and
    4: K10 at K/tp (wo, proj) and O/tp (qkv, fc) on 8 rows in bf16, f32
    planes (the gi math), fc with its bias slice; K9 on the lm head's
    51200/tp rows; K5 and K6 over H/tp heads at B=8 (ragged n_past, the
    sentinel included); K4 at admission (8 rows x 300 tokens).  Timed as
    phase 2's rows, each beside phase 2's library call at the shard's
    shape: ``dequantize_km`` + ``torch.matmul`` (K10, K9), SDPA (K5 over
    the dequantized cache and the fresh row, K4 causal), ``index_put_`` of
    the rows that land (K6)."""
    import torch

    from vsim_tpu_torch.ops.attention import (flash_attention_fwd,
                                              flash_attention_plain)
    from vsim_tpu_torch.ops.decode_attention import (
        decode_attention_fresh, decode_attention_fresh_plain, kv_int,
        scatter_rows, scatter_rows_plain)
    from vsim_tpu_torch.ops.q4_cuda import (q4_matmul_i, q4_matmul_i_plain,
                                            q4_matmul_stacked,
                                            q4_matmul_stacked_plain)
    from vsim_tpu_torch.quant.q4 import Q4Tensor, dequantize_km

    bw, bf16_peak, f32_peak = peaks
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    rows = []

    def bound(nbytes, ops, peak):
        t_b, t_o = nbytes / bw * 1e3, ops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def weight(L, K, O, seed):  # noqa: N803
        gg = torch.Generator(device=dev)
        gg.manual_seed(seed)
        lead = (L,) if L else ()
        return (torch.randint(0, 256, (*lead, K // 2, O), generator=gg,
                              device=dev, dtype=torch.uint8),
                (torch.rand((*lead, K // 32, O), generator=gg, device=dev)
                 * 0.01).to(torch.bfloat16))

    def check(kname, shape, got, ref, tol):
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not torch.isfinite(got).all() or rel > tol:
            fail(f"{kname} {shape}: max|err| {err:.3g} (rel {rel:.3g} > "
                 f"{tol})")
        return err, rel

    def row(kname, shape, err, rel, fn, plain, lib, nbytes, ops, peak):
        b_ms, b_by = bound(nbytes, ops, peak)
        rows.append(dict(kernel=kname, shape=shape, max_abs_err=err,
                         rel_err=rel, ms=timed(fn, reps=50),
                         plain_ms=timed(plain, reps=3, warmup=1),
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=timed(lib, reps=5, warmup=1)))

    def lib_matmul(x, packed, scales):  # f32 planes, as the kernels' rows
        return torch.matmul(x.to(torch.float32), dequantize_km(
            Q4Tensor(packed, scales, "i"), torch.float32))

    n, L, S, D, B = 8, 2, 2048, 256, 8  # noqa: N806
    n_list = [0, 1, 127, 128, 300, 1500, 2047, 2048]
    for tp in (2, 4):
        ilt = torch.tensor(1, dtype=torch.int32, device=dev)
        for sname, K, O, has_bias in (  # noqa: N806
                ("qkv", 4096, 12288 // tp, False),
                ("wo", 4096 // tp, 4096, False),
                ("fc", 4096, 16384 // tp, True),
                ("proj", 16384 // tp, 4096, False)):
            w0 = weight(L, K, O, K + O + tp)
            nb = w0[0].numel() // L + w0[1].numel() // L * 2
            ws = rotation(lambda i: weight(L, K, O, K + O + tp + i), nb * L)
            ws[0] = w0
            x = torch.randn((n, K), generator=g, device=dev).to(
                torch.bfloat16)
            bias = (torch.randn((O,), generator=g, device=dev)
                    if has_bias else None)
            shape = (f"gpt-j tp={tp} {sname} il=1 of 2 n={n} {K}->{O} "
                     "x=bfloat16 planes=f32")
            got = q4_matmul_stacked(x, *w0, ilt, bias, False)
            err, rel = check("q4_matmul_stacked", shape, got,
                             q4_matmul_stacked_plain(x, *w0, ilt, bias,
                                                     False), TOL_Q4)
            cyc = itertools.cycle(ws)
            row("q4_matmul_stacked", shape, err, rel,
                lambda: q4_matmul_stacked(x, *next(cyc), ilt, bias, False),
                lambda: q4_matmul_stacked_plain(x, *w0, ilt, bias, False),
                lambda: lib_matmul(x, *(t[1] for t in next(cyc))),
                nb + n * K * 2 + n * O * 4 + (O * 4 if has_bias else 0),
                2 * n * K * O, bf16_peak)
        K, O = 4096, 51200 // tp  # noqa: N806
        w0 = weight(0, K, O, 7 + tp)
        nb = w0[0].numel() + w0[1].numel() * 2
        ws = rotation(lambda i: weight(0, K, O, 7 + tp + i), nb)
        ws[0] = w0
        x = torch.randn((n, K), generator=g, device=dev).to(torch.bfloat16)
        bias = torch.randn((O,), generator=g, device=dev)
        shape = f"gpt-j tp={tp} lm_head n={n} {K}->{O} x=bfloat16"
        err, rel = check("q4_matmul_i", shape, q4_matmul_i(x, *w0, bias),
                         q4_matmul_i_plain(x, *w0, bias), TOL_Q4)
        cyc = itertools.cycle(ws)
        row("q4_matmul_i", shape, err, rel,
            lambda: q4_matmul_i(x, *next(cyc), bias),
            lambda: q4_matmul_i_plain(x, *w0, bias),
            lambda: lib_matmul(x, *next(cyc)),
            nb + n * K * 2 + n * O * 4 + O * 4, 2 * n * K * O, bf16_peak)
        del ws, w0

        H = 16 // tp  # noqa: N806

        def side(shape):
            return (torch.randint(-127, 128, shape, generator=g, device=dev,
                                  dtype=torch.int8),
                    (torch.rand(shape[:-1], generator=g, device=dev)
                     * 0.05).to(torch.bfloat16))

        npv = torch.tensor(n_list, dtype=torch.int32, device=dev)
        k_store, v_store = side((2, B, H, S, D)), side((2, B, H, S, D))
        fresh = (*side((B, H, D)), *side((B, H, D)))
        q = torch.randn((B, H, D), generator=g, device=dev)
        kw = dict(scale=D ** -0.5, round_q=True)
        shape = f"gpt-j tp={tp} int8 B={B} H={H} D={D} S={S} n_past={n_list}"
        err, rel = check("decode_attention_fresh", shape,
                         decode_attention_fresh(q, k_store, v_store, 1, npv,
                                                fresh, **kw),
                         decode_attention_fresh_plain(q, k_store, v_store, 1,
                                                      npv, fresh, **kw),
                         TOL_DECODE)
        read = sum(min(x, S) for x in n_list) + B

        # phase 2's yardstick: SDPA over the dequantized layer and the
        # fresh row as one more key, masked to rows < n_past[b] and it
        def deq(vals, sc):
            return kv_int(vals) * sc.float()[..., None]

        kd = torch.cat([deq(k_store[0][1], k_store[1][1]),
                        deq(*fresh[:2])[:, :, None]], dim=2).to(torch.bfloat16)
        vd = torch.cat([deq(v_store[0][1], v_store[1][1]),
                        deq(*fresh[2:])[:, :, None]], dim=2).to(torch.bfloat16)
        s_idx = torch.arange(S + 1, device=dev)
        mask = ((s_idx[None, :] < npv[:, None])
                | (s_idx[None, :] == S))[:, None, None, :]
        qb = q.to(torch.bfloat16)[:, :, None, :]
        row("decode_attention_fresh", shape, err, rel,
            lambda: decode_attention_fresh(q, k_store, v_store, 1, npv,
                                           fresh, **kw),
            lambda: decode_attention_fresh_plain(q, k_store, v_store, 1, npv,
                                                 fresh, **kw),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qb, kd, vd, attn_mask=mask, scale=kw["scale"]),
            2 * H * read * (D + 2) + B * H * D * (2 + 4), 4 * H * read * D,
            bf16_peak)
        del k_store, v_store, kd, vd
        Lc = 28  # noqa: N806
        k_store, v_store = side((Lc, B, H, S, D)), side((Lc, B, H, S, D))
        new = (*side((Lc, B, H, D)), *side((Lc, B, H, D)))
        k_ref, v_ref = (tuple(t.clone() for t in st)
                        for st in (k_store, v_store))
        scatter_rows(k_store, v_store, new, npv)
        scatter_rows_plain(k_ref, v_ref, new, npv)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((*k_store, *v_store),
                                                     (*k_ref, *v_ref))):
            fail(f"scatter_rows gpt-j tp={tp}: differs from its plain "
                 "version")
        del k_ref, v_ref
        lv = torch.tensor([b for b, x in enumerate(n_list) if x < S],
                          device=dev)
        live = lv.numel()
        sel = [t[:, lv] for t in new]
        ix = (torch.arange(Lc, device=dev)[:, None, None], lv[None, :, None],
              torch.arange(H, device=dev)[None, None, :],
              npv.long()[lv][None, :, None])

        def index_put():  # phase 2's yardstick: the rows that land
            for (vals, sc), (rq, rs) in ((k_store, sel[:2]),
                                         (v_store, sel[2:])):
                vals.index_put_(ix, rq)
                sc.index_put_(ix, rs)

        row("scatter_rows", f"gpt-j tp={tp} int8 L={Lc} B={B} H={H} Dp={D} "
            f"S={S} ({live} rows land)", 0.0, 0.0,
            lambda: scatter_rows(k_store, v_store, new, npv),
            lambda: scatter_rows_plain(k_store, v_store, new, npv),
            index_put,
            2 * 2 * Lc * live * H * (D + 2), 0, bf16_peak)
        del k_store, v_store, new, sel
        torch.cuda.empty_cache()
        T = 300  # noqa: N806
        qt, k, v = (torch.randn((B, H, T, D), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(3))
        shape = f"gpt-j tp={tp} B={B} T={T} H={H} D={D} bfloat16"
        got, _ = flash_attention_fwd(qt, k, v, scale=D ** -0.5)
        err, rel = check("flash_attention_fwd", shape, got,
                         flash_attention_plain(qt, k, v, scale=D ** -0.5)[0],
                         TOL_FLASH_BF16)
        row("flash_attention_fwd", shape, err, rel,
            lambda: flash_attention_fwd(qt, k, v, scale=D ** -0.5),
            lambda: flash_attention_plain(qt, k, v, scale=D ** -0.5),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, k, v, is_causal=True, scale=D ** -0.5),
            4 * B * H * T * D * 2 + B * H * T * 4,
            4 * B * H * T * (T + 1) // 2 * D, bf16_peak)
    return rows


def forced_logits(cfg, params, slopes, prompts, streams, n_tok: int,
                  heads: int, mesh=None, chunk: int = 1):
    """The serving step's logits teacher-forced along ``streams`` (their
    first ``n_tok`` tokens; every row prefilled alone at its prompt's
    length, then stepped together at ragged n_past through the deferred
    K5/K6 route, or ``chunk`` tokens a forward as the speculative verify
    runs them; a finished row at the sentinel), under ``mesh`` when given
    (a rank's shard, ``heads`` of them): logits [B, n_tok, V], index k the
    logits that give token k >= 1, and each row's prefill margin (token
    0's)."""
    import torch

    from vsim_tpu_torch.models.transformer import forward, init_cache
    from vsim_tpu_torch.parallel import context as pctx

    dev, B = params["ln_f_w"].device, len(prompts)  # noqa: N806
    S = cfg.n_ctx  # noqa: N806
    margins0 = []
    with pctx.use_mesh(mesh):
        cache = init_cache(cfg, B, device=dev, heads=heads)
        for b, prompt in enumerate(prompts):
            one = init_cache(cfg, 1, n_ctx=len(prompt), device=dev,
                             heads=heads)
            lg, _ = forward(cfg, params, torch.tensor([prompt], device=dev),
                            one, 0, fresh_kv=True, slopes=slopes)
            top2 = lg[0, -1].topk(2).values
            margins0.append(float(top2[0] - top2[1]))
            for side in ("k", "v"):
                for d, s in zip(*(t if isinstance(t, tuple) else (t,)
                                  for t in (cache[side], one[side]))):
                    d[:, b, :, :len(prompt)] = s[:, 0]
        lens = torch.tensor([min(len(s), n_tok) for s in streams])
        toks = torch.zeros((B, n_tok + chunk), dtype=torch.long)
        for b, s in enumerate(streams):
            toks[b, :lens[b]] = torch.tensor(s[:n_tok])
        toks = toks.to(dev)
        n0 = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
        out = torch.zeros((B, n_tok, cfg.n_vocab), device=dev)
        for s in range(0, n_tok - 1, chunk):
            npv = torch.where(s < lens - 1, n0 + s, S).to(dev, torch.int32)
            lg, _ = forward(cfg, params, toks[:, s:s + chunk], cache, npv,
                            slopes=slopes)
            k = min(chunk, n_tok - 1 - s)
            out[:, s + 1:s + 1 + k] = lg[:, :k]
    return out, margins0


def forced_split(label, streams, want, batches, ref, got, n_forced):
    """``split_check`` of ``streams`` against ``want`` with the gaps
    between teacher-forced logits ``got`` and the reference ``ref`` (per
    batch of rows from ``batches``: ``forced_logits``' (logits, prefill
    margins)), the margins ``ref``'s."""
    margins, gaps, scales, margins0 = [], [], [], []
    for (pl, m0), (tl, _), lo in zip(ref, got, batches):
        top2 = pl.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).tolist()
        gap = (tl - pl).abs().amax(dim=-1).tolist()
        n = [min(len(x), n_forced) for x in want[lo:lo + len(m0)]]
        margins += [margin[b][1:n[b]] for b in range(len(n))]
        gaps += [gap[b][1:n[b]] for b in range(len(n))]
        scales += pl.abs().amax(dim=(1, 2)).tolist()
        margins0 += m0
    return split_check(label, streams, want, margins, gaps, scales, margins0)


def first_splits(streams, want):
    """Teacher-force as far as the furthest split needs (8 at least)."""
    firsts = [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                   None) for g, w in zip(streams, want)]
    return max([8] + [k + 1 for k in firsts if k is not None])


def parallel_depth2(mesh):
    """Phase 11 (a), on every rank: GPT-J-6B's width at depth 2, seed-1
    weights, f32 compute, int8 KV.  The TP prefill's logits (K4, K10, K9
    at shard shapes) against one card's, the TP ServingEngine's greedy
    streams against one card's ServingEngine, sequence parallelism against
    ``forward_nocache`` and, at a T the model axis does not divide, an SP
    prefill against one card's, a prefill whose ``wo`` is held whole (a K
    split would cut a Q4 block: CodeGen's D = 80, tp heads, E = 80 * tp)
    against one card's, and a 2-stage ``pipeline_forward_nocache`` bit for
    bit against ``forward_nocache`` on each microbatch; rank 0 computes
    the one-card references and fails the phase on a miss."""
    import torch

    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params
    from vsim_tpu_torch.models.transformer import (forward, forward_nocache,
                                                   init_cache)
    from vsim_tpu_torch.parallel import context as pctx
    from vsim_tpu_torch.parallel import distributed
    from vsim_tpu_torch.parallel.mesh import make_mesh
    from vsim_tpu_torch.parallel.pipeline import (pipeline_forward_nocache,
                                                  stage_params)
    from vsim_tpu_torch.parallel.sharding import shard_params

    dev, rank = mesh.device, distributed.process_index()
    tp = mesh.size("model")
    cfg = PRESETS["gpt-j-6b"].replace(n_layer=2, n_ctx=64,
                                      compute_dtype="float32",
                                      kv_dtype="int8")
    params = random_q4_params(cfg, seed=1, device=dev)
    local = shard_params(params, mesh)
    ids = torch.tensor([PARALLEL_PROMPTS[0]], device=dev)
    out = {}

    def rel_to(got, ref, what):
        err = float((got - ref).abs().max() / ref.abs().max())
        if not math.isfinite(err) or err > TOL_TP:
            fail(f"{what}: {err:.3g} of max|logit| > {TOL_TP}")
        return err

    with pctx.use_mesh(mesh):
        got, _ = forward(cfg, local, ids, init_cache(
            cfg, 1, device=dev, heads=cfg.n_head // tp), 0, fresh_kv=True)
    if rank == 0:
        ref, _ = forward(cfg, params, ids, init_cache(cfg, 1, device=dev), 0,
                         fresh_kv=True)
        out["tp_prefill_rel_err"] = rel_to(got, ref, f"tp={tp} prefill")

    srv = ServingEngine(cfg, params, max_batch=2, mesh=mesh)
    res = srv.run(PARALLEL_PROMPTS, 4, stop_tokens=(), chunk_steps=4)
    streams = [res[i].generated for i in sorted(res)]
    out["graphed"] = srv._make_graph is not None
    out["serving_streams"] = streams
    if rank == 0:
        one = ServingEngine(cfg, params, max_batch=2, device=dev)
        res = one.run(PARALLEL_PROMPTS, 4, stop_tokens=(), chunk_steps=4)
        want = [res[i].generated for i in sorted(res)]
        if streams != want:
            fail(f"tp={tp} serving streams {streams} != one card's {want}")
    del srv

    ids2 = torch.tensor([PARALLEL_PROMPTS[0], PARALLEL_PROMPTS[2][:12]],
                        device=dev)
    with pctx.use_mesh(mesh, rules={"seq": "model"}):
        got, _ = forward(cfg, local, ids2, None, 0)
    if rank == 0:
        out["sp_rel_err"] = rel_to(got, forward_nocache(cfg, params, ids2),
                                   f"tp={tp} sequence parallel")
    # an SP prefill at T = 13 (tp = 2, 4 do not divide it): the residual
    # stream's tokens padded to a multiple of the axis, the pad rows
    # dropped before attention
    odd = torch.tensor([PARALLEL_PROMPTS[2][:13], PARALLEL_PROMPTS[2][7:]],
                       device=dev)
    with pctx.use_mesh(mesh, rules={"seq": "model"}):
        got, _ = forward(cfg, local, odd, init_cache(
            cfg, 2, device=dev, heads=cfg.n_head // tp), 0, fresh_kv=True)
    if rank == 0:
        ref, _ = forward(cfg, params, odd, init_cache(cfg, 2, device=dev), 0,
                         fresh_kv=True)
        out["sp_odd_t"] = odd.shape[1]
        out["sp_odd_rel_err"] = rel_to(
            got, ref, f"tp={tp} SP prefill at T = {odd.shape[1]}")
    # wo held whole: K = 80 * tp splits its packed bytes over the ranks,
    # not its 32-row scale blocks (GSPMD gathers; the port gathers wo's
    # input over the heads and runs the whole product)
    wcfg = PRESETS["codegen-2b"].replace(
        n_layer=2, n_ctx=64, n_embd=80 * tp, n_head=tp, n_ff=320 * tp,
        compute_dtype="float32", kv_dtype="int8")
    wparams = random_q4_params(wcfg, seed=2, device=dev)
    wlocal = shard_params(wparams, mesh)
    if wlocal["layers"]["wo"] is not wparams["layers"]["wo"]:
        fail(f"tp={tp}: wo at K = {wcfg.n_embd} was split, not held whole")
    with pctx.use_mesh(mesh):
        got, _ = forward(wcfg, wlocal, ids, init_cache(
            wcfg, 1, device=dev, heads=1), 0, fresh_kv=True)
    if rank == 0:
        ref, _ = forward(wcfg, wparams, ids, init_cache(wcfg, 1, device=dev),
                         0, fresh_kv=True)
        out["whole_wo_rel_err"] = rel_to(got, ref,
                                         f"tp={tp} prefill, wo held whole")
    del wparams, wlocal

    pmesh = make_mesh((2, distributed.process_count() // 2),
                      axis_names=("pipe", "data"), device=dev)
    ids3 = torch.stack([ids2, ids2.flip(0)])  # [M=2, mB=2, T=12]
    got = pipeline_forward_nocache(cfg, stage_params(params, 2, pmesh), ids3,
                                   pmesh)
    if rank == 0:
        want = torch.stack([forward_nocache(cfg, params, i) for i in ids3])
        if not torch.equal(got, want):
            fail("2-stage pipeline differs from forward_nocache: max|err| "
                 f"{float((got - want).abs().max()):.3g}")
        out["pipeline_bit_equal"] = True
    return out


def serve_run(srv, prompts, n_pred, label, kernels):
    """``serve_scenario`` on a sharded engine: its numbers, this rank's
    launches (each of ``kernels`` at least once, or the phase fails) and
    the streams."""
    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.parallel import distributed

    _build.reset_launch_counts()
    wall, reqs, st = serve_scenario(srv, prompts, n_pred)
    launches = dict(_build.launch_counts)
    for k in kernels:
        if launches.get(k, 0) == 0:
            fail(f"rank {distributed.process_index()}: {label} never "
                 f"launched {k}: {launches}")
    streams = [r.generated for r in reqs]
    n_tok = sum(len(x) for x in streams)
    return dict(wall_s=wall, generated_tokens=n_tok,
                tokens_per_s=n_tok / wall,
                ttft_ms=[(r.first_token_s - r.submitted_s) * 1e3
                         for r in reqs], launches=launches,
                streams=streams), st


# gloo's TP serving steps eagerly (~0.3 s a chunk step of 8 slots at
# GPT-J-6B's width on one card): there phase 4's prompts take TP_EAGER_TOKENS
# new tokens each, held against the first TP_EAGER_TOKENS of phase 4's
# streams (every row has split by its 8th token in the runs so far)
TP_EAGER_TOKENS = 16


def parallel_full_width(mesh, cfg, params, plain_streams):
    """Phase 11 (b), on every rank: GPT-J-6B at full width (seed-0 random
    Q4 weights, phase 3's), bf16, int8 KV, ``ServingEngine(mesh=...)`` on 8
    slots under phase 4's traffic (over gloo, TP_EAGER_TOKENS new tokens a
    request): tokens/s, ms a chunk step, TTFT and
    this rank's launches.  Then the TP step's and one card's serving step
    teacher-forced along phase 4's int8 streams (rank 0 runs the one-card
    step on the unrolled params phase 4 served from): the streams must
    equal phase 4's up to a split whose one-card top-2 margin is at most
    the measured TP-to-one-card logit gap (``split_check``)."""
    import torch

    from vsim_tpu_torch.engine.generate import engine_params
    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.parallel import distributed

    dev, rank = mesh.device, distributed.process_index()
    t0 = time.perf_counter()
    srv = ServingEngine(cfg, params, max_batch=8, mesh=mesh)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    warmup_s = srv.warmup()
    prompts, n_pred = serve_traffic(cfg.n_vocab)
    if distributed.backend() == "gloo":
        n_pred = [TP_EAGER_TOKENS] * len(prompts)
        plain_streams = [x[:TP_EAGER_TOKENS] for x in plain_streams]
    out, st = serve_run(srv, prompts, n_pred, "TP serving", PARALLEL_KERNELS)
    chunk = st["serve/step_chunk"]
    streams = out["streams"]
    out.update(setup_s=setup_s, warmup_s=warmup_s,
               ms_per_chunk_step=chunk.wall_s * 1e3 / (chunk.calls * 8),
               graphed=srv._make_graph is not None)
    n_forced = first_splits(streams, plain_streams)
    tp_params, slopes, heads = srv.params, srv.slopes, srv.heads
    del srv
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plain, stacked = [], []
    if rank == 0:  # one card: the unrolled params phase 4 served from, and
        # the stacked ones (the TP path's kernels at whole shapes)
        for unroll, dst in ((True, plain), (False, stacked)):
            one = engine_params(cfg, params, dev, unroll_layers=unroll)
            for lo in (0, 8):
                dst.append(forced_logits(cfg, one, None, prompts[lo:lo + 8],
                                         plain_streams[lo:lo + 8], n_forced,
                                         cfg.n_head))
            del one
    tp = [forced_logits(cfg, tp_params, slopes, prompts[lo:lo + 8],
                        plain_streams[lo:lo + 8], n_forced, heads, mesh)
          for lo in (0, 8)]
    out["forced_tokens"] = n_forced
    out["forced_s"] = time.perf_counter() - t0
    if rank == 0:
        # the two differences apart: TP against one card's stacked engine
        # (the all-reduces' sum order), that engine against phase 4's
        out["gap_scale"] = max(p.abs().max().item() for p, _ in plain)
        out["gap_tp_vs_stacked"] = max((t - st).abs().max().item() for
                                       (t, _), (st, _) in zip(tp, stacked))
        out["gap_stacked_vs_plain"] = max((st - p).abs().max().item() for
                                          (st, _), (p, _) in zip(stacked,
                                                                 plain))
        out["split"] = forced_split(f"tp={mesh.size('model')} serving",
                                    streams, plain_streams, (0, 8), plain,
                                    tp, n_forced)
    return out


def parallel_data_serving(mesh, cfg, params, plain_streams):
    """Phase 11 (c), on every rank: GPT-J-6B at full width (phase 3's
    weights), bf16, int8 KV, ``ServingEngine(mesh=)`` with 2 ranks on the
    data axis: each data rank holds 4 of the 8 slots and replays its step
    from its graph (over gloo too where the model axis is 1: the exchange
    of a chunk's ring runs outside the graph), under phase 4's traffic:
    tokens/s, ms a chunk step, TTFT, this rank's launches and the
    exchange's ms a chunk.  Then the step teacher-forced along phase 4's
    streams in blocks of a data rank's rows against one card's (rank 0,
    phase 4's unrolled params): the streams must equal phase 4's up to a
    split whose one-card top-2 margin is at most the measured gap."""
    import torch

    from vsim_tpu_torch.engine.generate import engine_params
    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.parallel import distributed

    dev, rank = mesh.device, distributed.process_index()
    label = f"data={mesh.size('data')} x model={mesh.size('model')} serving"
    t0 = time.perf_counter()
    srv = ServingEngine(cfg, params, max_batch=8, mesh=mesh)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    warmup_s = srv.warmup()
    prompts, n_pred = serve_traffic(cfg.n_vocab)
    out, st = serve_run(srv, prompts, n_pred, label, PARALLEL_KERNELS)
    replayed = bool(srv._steps) and all(
        step.graph is not None for step in srv._steps.values())
    if not replayed:
        fail(f"rank {rank}: {label}: the step was not replayed from a graph")
    chunk = st["serve/step_chunk"]
    exch = st["serve/step_chunk/serve/exchange"]
    out.update(setup_s=setup_s, warmup_s=warmup_s, replayed=replayed,
               slots=[srv.first, srv.rows],
               ms_per_chunk_step=chunk.wall_s * 1e3 / (chunk.calls * 8),
               exchange_ms_per_chunk=exch.wall_s * 1e3 / exch.calls,
               exchanges=exch.calls)
    n_forced = first_splits(out["streams"], plain_streams)
    rows = srv.rows
    batches = range(0, len(prompts), rows)
    dp_params, slopes, heads = srv.params, srv.slopes, srv.heads
    del srv
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = [forced_logits(cfg, dp_params, slopes, prompts[lo:lo + rows],
                         plain_streams[lo:lo + rows], n_forced, heads, mesh)
           for lo in batches]
    if rank == 0:
        one = engine_params(cfg, params, dev)
        ref = [forced_logits(cfg, one, None, prompts[lo:lo + rows],
                             plain_streams[lo:lo + rows], n_forced,
                             cfg.n_head) for lo in batches]
        del one
        out["split"] = forced_split(label, out["streams"], plain_streams,
                                    batches, ref, got, n_forced)
    out["forced_tokens"] = n_forced
    out["forced_s"] = time.perf_counter() - t0
    return out


def parallel_spec_serving(mesh, cfg, params, spec_streams):
    """Phase 11 (d), on every rank: GPT-J-6B ``ServingEngine(mesh=,
    drafter=NgramDrafter(3, 4))`` over the model axis (eager over gloo,
    replayed over NCCL) on phase 10's serving prompts at
    ``SPEC_TP_TOKENS`` tokens each: tokens a step, ``serve/spec_step`` ms,
    this rank's launches.  Then its verify (gamma + 1 tokens a forward)
    teacher-forced along phase 10's one-card speculative streams (their
    first ``SPEC_TP_TOKENS``) against one card's verify (rank 0): the
    streams must equal those up to a split that ``split_check`` accepts."""
    import torch

    from vsim_tpu_torch.engine.generate import engine_params
    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.engine.speculative import NgramDrafter
    from vsim_tpu_torch.parallel import distributed

    dev, rank = mesh.device, distributed.process_index()
    n = SPEC_TP_TOKENS
    label = f"tp={mesh.size('model')} speculative serving"
    srv = ServingEngine(cfg, params, max_batch=8, mesh=mesh,
                        drafter=NgramDrafter(3, 4))
    warmup_s = srv.warmup()
    prompts, _ = serve_traffic(cfg.n_vocab)
    out, st = serve_run(srv, prompts, [n] * len(prompts), label,
                        SPEC_PARALLEL_KERNELS)
    spec = st["serve/spec_step"]
    out.update(warmup_s=warmup_s, spec_cycles=srv.spec_cycles,
               spec_emitted=srv.spec_emitted,
               tokens_per_step=srv.spec_emitted / srv.spec_cycles,
               ms_per_spec_step=spec.wall_s * 1e3 / spec.calls,
               replayed=srv._make_graph is not None and all(
                   step.graph is not None
                   for step in srv._spec_steps.values()))
    want = [x[:n] for x in spec_streams]
    G = srv.drafter.gamma + 1  # noqa: N806
    sp_params, slopes, heads = srv.params, srv.slopes, srv.heads
    del srv
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = [forced_logits(cfg, sp_params, slopes, prompts[lo:lo + 8],
                         want[lo:lo + 8], n, heads, mesh, chunk=G)
           for lo in (0, 8)]
    if rank == 0:
        one = engine_params(cfg, params, dev)
        ref = [forced_logits(cfg, one, None, prompts[lo:lo + 8],
                             want[lo:lo + 8], n, cfg.n_head, chunk=G)
               for lo in (0, 8)]
        del one
        out["split"] = forced_split(label, out["streams"], want, (0, 8), ref,
                                    got, n)
    out["forced_s"] = time.perf_counter() - t0
    return out


def rank_main(job_path: str) -> None:
    """One rank of phase 11 (``chip_smoke.py --rank JOB``, started by
    ``run_ranks`` with the ``VSIM_*`` variables set): joins the group,
    runs (a)-(d) on this rank's card and writes its results: (a) and (b)
    (TP serving) and (d) (speculative serving) with every rank on the
    model axis, (c) with 2 ranks on the data axis."""
    import torch

    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params
    from vsim_tpu_torch.parallel import distributed

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(backend=job["backend"], timeout_s=600)
    mesh = distributed.global_mesh((1, -1))
    rank = distributed.process_index()
    out = dict(rank=rank, world=distributed.process_count(),
               backend=distributed.backend(), device=str(mesh.device))
    t0 = time.perf_counter()
    out["depth2"] = parallel_depth2(mesh)
    out["depth2_s"] = time.perf_counter() - t0
    cfg = PRESETS["gpt-j-6b"].replace(compute_dtype="bfloat16",
                                      kv_dtype="int8")
    params = random_q4_params(cfg, seed=0, device=mesh.device,
                              rng="device")
    t0 = time.perf_counter()
    out["full"] = parallel_full_width(mesh, cfg, params, job["plain_streams"])
    out["full_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["data"] = parallel_data_serving(distributed.global_mesh((2, -1)),
                                        cfg, params, job["plain_streams"])
    out["data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["spec"] = parallel_spec_serving(mesh, cfg, params,
                                        job["spec_streams"])
    out["spec_s"] = time.perf_counter() - t0
    with open(os.path.join(job["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.barrier("phase 11 done", timeout_s=600)
    distributed.shutdown()


def run_ranks(world: int, backend, plain_streams, spec_streams,
              timeout_s: float = 600):
    """Start ``world`` ranks of this script (``--rank``), one process
    each, over ``backend`` (None: the port's rule, NCCL with a card a
    rank); fail, killing the others, when a rank fails or the timeout
    passes.  Returns each rank's results."""
    import socket

    d = os.path.join(HERE, "build", f"phase11_{world}")
    os.makedirs(d, exist_ok=True)
    job = os.path.join(d, "job.json")
    with open(job, "w") as f:
        json.dump(dict(dir=d, backend=backend, plain_streams=plain_streams,
                       spec_streams=spec_streams), f)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, VSIM_COORDINATOR=f"localhost:{port}",
                   VSIM_NUM_PROCESSES=str(world), VSIM_PROCESS_ID=str(r))
        logs.append(open(os.path.join(d, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", job],
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(d, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            fail(f"phase 11 rank {r} of {world} ({backend or 'nccl'}) exited "
                 f"{p.returncode}:\n{tail}")
    out = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out.append(json.load(f))
    for run in ("full", "data", "spec"):
        if any(o[run]["streams"] != out[0][run]["streams"] for o in out):
            fail(f"phase 11 ({world} ranks, {run}): the ranks retired "
                 "different tokens")
    return out


def phase_parallel(peaks, plain_streams, spec_streams, nccl_only=False):
    """Phase 11: the shard-shape kernel rows, then two ranks on card 0
    over gloo (TP and speculative serving at (1, 2), eager: gloo's
    collectives go through the host; serving at (2, 1), each rank's step
    replayed) and, with four cards or more, four ranks over NCCL (a card
    each; (1, 4) TP and speculative serving and (2, 2) serving, every
    step captured and replayed); ``nccl_only``: the NCCL run alone.
    Returns (numbers, kernel rows, launches of the serving runs summed
    over ranks)."""
    import torch

    t0 = time.perf_counter()
    rows = [] if nccl_only else shard_kernel_rows(peaks)
    out = dict(kernel_rows_s=time.perf_counter() - t0)
    launches = collections.Counter()
    runs = [] if nccl_only else [("gloo tp=2", 2, "gloo")]
    if torch.cuda.device_count() >= 4:
        runs.append(("nccl tp=4", 4, None))
    else:
        out["nccl tp=4"] = (f"not run: {torch.cuda.device_count()} card(s); "
                            "NCCL takes a card a rank, four are needed")
    for label, world, backend in runs:
        t0 = time.perf_counter()
        ranks = run_ranks(world, backend, plain_streams, spec_streams)
        out[label] = dict(seconds=time.perf_counter() - t0, ranks=ranks)
        for r in ranks:
            for run in ("full", "data", "spec"):
                launches.update(r[run]["launches"])
    return out, rows, dict(launches)


def parallel_lines(par):
    """What phase 11 prints: per run, the depth-2 checks, serving's
    numbers, the TP-to-one-card gap and each rank's launches."""
    lines = [f"  shard-shape kernel rows in {par['kernel_rows_s']:.1f} s"]
    for label, run in par.items():
        if isinstance(run, str):
            lines.append(f"  {label}: {run}")
            continue
        if not isinstance(run, dict):
            continue
        r0 = run["ranks"][0]
        d2, full = r0["depth2"], r0["full"]
        lines.append(
            f"  {label} ({r0['backend']}, {len(run['ranks'])} ranks, "
            f"{run['seconds']:.1f} s; step "
            f"{'replayed from its graph' if full['graphed'] else 'eager'}): "
            f"depth 2 f32: prefill {d2['tp_prefill_rel_err']:.2g}, SP "
            f"{d2['sp_rel_err']:.2g}, SP prefill at T = {d2['sp_odd_t']} "
            f"{d2['sp_odd_rel_err']:.2g}, wo held whole (CodeGen D = 80) "
            f"{d2['whole_wo_rel_err']:.2g} of max|logit| (<= {TOL_TP}), "
            "serving streams = one card's, 2-stage pipeline = "
            f"forward_nocache bit for bit ({r0['depth2_s']:.1f} s)")
        sp = full["split"]
        lines.append(
            f"  {label} GPT-J-6B bf16 int8 KV, 8 slots, "
            f"{full['generated_tokens']} tokens: "
            f"{full['tokens_per_s']:.1f} tokens/s, "
            f"{full['ms_per_chunk_step']:.2f} ms a chunk step, TTFT "
            f"{min(full['ttft_ms']):.0f}-{max(full['ttft_ms']):.0f} ms "
            f"(setup {full['setup_s']:.1f} s, warmup {full['warmup_s']:.1f} "
            f"s); vs phase 4's streams: {sp['compared_tokens']} tokens "
            f"equal, {len(sp['splits'])} splits, TP-to-one-card gap "
            f"{sp['gap_max']:.4g} ({sp['gap_rel_max']:.3g} of max|logit|) "
            f"over {full['forced_tokens']} forced tokens; of it TP vs one "
            f"card's stacked engine {full['gap_tp_vs_stacked']:.4g}, that "
            f"engine vs phase 4's {full['gap_stacked_vs_plain']:.4g} (max|"
            f"logit| {full['gap_scale']:.3g})")
        dp, sp = r0["data"], r0["spec"]
        lines.append(
            f"  {label} {dp['split']['rows']} requests, data = 2 ranks "
            f"({r0['data_s']:.1f} s; each rank's step "
            f"{'replayed from its graph' if dp['replayed'] else 'eager'}): "
            f"{dp['tokens_per_s']:.1f} tokens/s, "
            f"{dp['ms_per_chunk_step']:.2f} ms a chunk step, TTFT "
            f"{min(dp['ttft_ms']):.0f}-{max(dp['ttft_ms']):.0f} ms, the "
            f"exchange {dp['exchange_ms_per_chunk']:.3f} ms a chunk "
            f"({dp['exchanges']} chunks); vs phase 4's streams: "
            f"{dp['split']['compared_tokens']} tokens equal, "
            f"{len(dp['split']['splits'])} splits, gap "
            f"{dp['split']['gap_max']:.4g} over {dp['forced_tokens']} "
            "forced tokens")
        lines.append(
            f"  {label} speculative serving, NgramDrafter(3, 4), "
            f"{SPEC_TP_TOKENS} tokens a request ({r0['spec_s']:.1f} s; step "
            f"{'replayed' if sp['replayed'] else 'eager'}): "
            f"{sp['tokens_per_step']:.3f} tokens a step over the active "
            f"slots ({sp['spec_emitted']} in {sp['spec_cycles']} steps), "
            f"{sp['ms_per_spec_step']:.1f} ms a serve/spec_step, "
            f"{sp['tokens_per_s']:.1f} tokens/s; vs phase 10's one-card "
            f"streams: {sp['split']['compared_tokens']} tokens equal, "
            f"{len(sp['split']['splits'])} splits, verify gap "
            f"{sp['split']['gap_max']:.4g} ({sp['split']['gap_rel_max']:.3g}"
            " of max|logit|)")
        for r in run["ranks"]:
            for run_name in ("full", "data", "spec"):
                lines.append(
                    f"    rank {r['rank']} ({r['device']}) {run_name} "
                    "launches: " + json.dumps(
                        {k: r[run_name]["launches"].get(k, 0)
                         for k in PARALLEL_KERNELS}))
    return lines


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
    K15's, of K12's and of K2's TF32 kernel runs HMMA (``tools/sass_ops.py``
    on ``build/kernels``): {function: opcode counts}, one dict a kernel."""
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
    k2 = {fn: got for fn, got in sass_ops.count_lib(
        _build._lib_path("q4_matmul_ps")).items() if "ps_tf32_kernel" in fn}
    if len(k2) != K2_TF32_INSTANCES:
        fail(f"sass: {len(k2)} instances of K2's TF32 kernel, not "
             f"{K2_TF32_INSTANCES}")
    for fn, got in k2.items():
        if not got["ops"]["HMMA"]:
            fail(f"sass {fn}: K2's TF32 instance runs no HMMA")
    return ({fn: got["ops"] for fn, got in found.items()},
            {fn: got["ops"] for fn, got in batch.items()},
            {fn: got["ops"] for fn, got in lab.items()},
            {fn: got["ops"] for fn, got in k2.items()})


# K2's TF32 instances (csrc/q4_matmul_ps.cu:ps_tf32_kernel): row tiles 16,
# 32, 64 and 128, bf16 and f32 x
K2_TF32_INSTANCES = 4 * 2
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

    from vsim_tpu_torch.device import card_label

    smi = card_label()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = _build.build_all([name for name in _build.SOURCES
                                if name not in _build.LAB_SOURCES]
                               + ["read_designs"])
    print(f"built kernels in {time.perf_counter() - t0:.1f} s, by library "
          + json.dumps({k: round(v, 1) for k, v in sorted(
              _build.build_seconds.items(), key=lambda kv: -kv[1])})
          + f" (the lab's {', '.join(_build.LAB_SOURCES)} building beside "
          "phase 2)", flush=True)
    labs = _build.start_builds(_build.LAB_SOURCES)
    # phase 5's CPU side, from here on beside the card
    cpu_refs = CpuChild("phase5_cpu", ["--cpu-refs"])
    t0 = time.perf_counter()
    rows = phase_kernels(peaks)
    print(f"kernel phase: {len(rows)} cases pass in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for r in rows:  # the redesigned kernels, with their ratio to the library
        if r["kernel"] in CORE_ROWS:
            k2 = ("" if r.get("k2_ms") is None else
                  f", K2 {r['k2_ms']:.4g} ({r['ms'] / r['k2_ms']:.2f}x)")
            print(f"  {r['kernel']} {r['shape']}: {r['ms']:.4g} ms, bound "
                  f"{r['bound_ms']:.2g}, flat read {r['flat_ms']:.4g} "
                  f"({r['vs_flat']:.2f}x), plain {r['plain_ms']:.4g}, "
                  f"library {r['library_ms']:.4g} "
                  f"({r['ms'] / r['library_ms']:.2f}x){k2}", flush=True)
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
                                 in r["rel_err_vs_f64"].items()}))
                + ("" if r.get("bf16_differ") is None else ", differing "
                   + json.dumps({k: float(f"{x:.3e}") for k, x
                                 in r["bf16_differ"].items()})) + "]")
            if r.get("fma_bound_ms") is not None:
                extra += f" [TF32; f32 FMA bound {r['fma_bound_ms']:.3g}]"
            print(f"  {r['kernel']} {r['shape']}: {r['ms']:.4g} ms, bound "
                  f"{r['bound_ms']:.2g}, plain {r['plain_ms']:.4g}, library "
                  f"{r['library_ms']:.4g} ({r['ms'] / r['library_ms']:.2f}x)"
                  f"{extra}", flush=True)
    t0 = time.perf_counter()
    reports.update(_build.finish_builds(labs))
    print(f"lab kernels built {time.perf_counter() - t0:.1f} s after phase 2 "
          "(each library's seconds from then: " + json.dumps(
              {k: round(_build.build_seconds[k], 1) for k in labs}) + ")",
          flush=True)
    sass, sass_batch, sass_lab, sass_k2 = sass_check()
    hmma = sorted(ops["HMMA"] for ops in sass.values())
    print(f"sass: {len(sass)} instances of K9/K10's kernel, HMMA "
          f"{hmma[0]}-{hmma[-1]} each, no I2F/I2FP/F2I between the first "
          f"and last HMMA; {len(sass_batch)} of K15's, {len(sass_lab)} of "
          f"K12's and {len(sass_k2)} of K2's TF32 kernel, HMMA in each "
          f"(K2: {sorted(ops['HMMA'] for ops in sass_k2.values())})",
          flush=True)
    for line in batch_sass_lines(sass_batch):
        print(line, flush=True)
    t0 = time.perf_counter()
    lab_rows, lab_launches = phase_labs(peaks)
    print(f"lab phase: {len(lab_rows)} cases pass in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in (lab_summary(lab_rows, peaks) + k12_lines(lab_rows)
                 + probe_lines(lab_rows)):
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
    # phase 10's GPT-J-6B runs, on phase 3's params
    p10 = PartTimer()
    spec, spec_launches = {}, {}
    spec["gpt-j-6b ngram"], spec_launches["gpt-j-6b ngram"] = p10(
        "gpt-j-6b ngram", "cuda", lambda: phase_spec_gptj(cfg, params))
    spec["gpt-j-6b serving"], spec_launches["gpt-j-6b serving"] = p10(
        "gpt-j-6b serving", "cuda", lambda: spec_serving(
            cfg, params, serving["int8"]["streams"]))
    # phase 13, on phase 3's params
    t0 = time.perf_counter()
    headline, headline_launches = phase_headline(params)
    print(f"batched bench (phase 13) in {time.perf_counter() - t0:.1f} s "
          f"(measure {headline['measure_s']:.1f} s): GPT-J-6B int4 KV, "
          f"B={HEADLINE_B}, loops of {HEADLINE_STEPS} steps x "
          f"{HEADLINE_REPS}", flush=True)
    print(json.dumps(headline["bench"]), flush=True)
    print(step_line(f"B={HEADLINE_B} step", headline["step"]), flush=True)
    print(f"  B={HEADLINE_B} step: launches "
          f"{json.dumps(headline['step']['graphed']['launches_per_step'])}, "
          "graphed device ms by kernel " + json.dumps(
              {k: round(v, 4) for k, v in (headline["step"]["graphed"][
                  "device_ms_by_kernel"] or {}).items()}), flush=True)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    clock = PartTimer()
    vs_cpu = phase_card_vs_cpu(clock, cpu_refs)
    vs_cpu["seconds"] = {k: round(v, 1) for k, v in clock.seconds.items()}
    cpu_s = sum(v for k, v in clock.seconds.items() if k.endswith(" cpu"))
    print(f"card vs cpu, seconds by part (CPU side {cpu_s:.1f} s in a "
          f"{VS_CPU_THREADS}-thread process beside the earlier phases): "
          f"{json.dumps(vs_cpu['seconds'])}", flush=True)
    print(f"card vs cpu in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(vs_cpu)}", flush=True)
    t0 = time.perf_counter()
    training, train_launches = phase_training(peaks)
    print(f"training and perplexity in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(training)}", flush=True)
    for line in training_lines({**training["train_bf16"],
                                **training["train_f32"]}):
        print(line, flush=True)
    mini, mini_rows, mini_launches = phase_minipythia(peaks)
    for line in minipythia_lines(mini) + kernel_row_lines(mini_rows):
        print(line, flush=True)
    rows += mini_rows
    t0 = time.perf_counter()
    pythia, pythia_launches, pythia_total, (p_cfg, p_params) = \
        phase_pythia(peaks)
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
    for line in f32_prefill_lines(pythia["f32_prefill"]):
        print(line, flush=True)

    # phase 9's Pythia-12B serving and phase 10's Pythia-12B run, on phase
    # 7's params
    p9 = PartTimer()
    archs = {}
    archs["pythia-12b"], arch_launches = {}, {}
    archs["pythia-12b"]["serving"], arch_launches["pythia-12b serving"] = p9(
        "pythia-12b serving", "cuda", lambda: arch_serving(
            "pythia-12b", p_cfg, p_params))
    spec["pythia-12b model drafter"], \
        spec_launches["pythia-12b model drafter"] = p10(
        "pythia-12b model drafter", "cuda",
        lambda: phase_spec_pythia(p_cfg, p_params))
    del p_params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    loading, load_launches = phase_loading()
    print(f"loading path in {time.perf_counter() - t0:.1f} s: a "
          f"{loading['file_bytes'] / 1e9:.3f} GB ggml Q4_0 file (Pythia-12B "
          f"width, {loading['n_layer']} layers) written in "
          f"{loading['write_s']:.1f} s; ggml_to_kmajor "
          f"{loading['ggml_to_kmajor_gb_s']:.2f} GB/s on the host; "
          f"load_ggml_model {loading['load_ggml_model_s']:.2f} s "
          f"({loading['load_ggml_model_gb_s']:.2f} GB/s), "
          f"{loading['q4_leaves']} Q4 leaves byte-identical; AutoInference "
          f"{loading['auto_inference_s']:.2f} s "
          f"({loading['auto_inference_gb_s']:.2f} GB/s); chat "
          f"{loading['chat_s']:.1f} s; launches {json.dumps(load_launches)}",
          flush=True)
    for k, v in loading["requests"].items():
        print(f"  {k}: prefill {v['prefill_ms']:.1f} ms, "
              f"{v['decode_ms_per_token']:.3f} ms a token, equal to the "
              f"engine's on the source params: {v['tokens'][:8]}...",
              flush=True)

    t0 = time.perf_counter()
    more, more_launches, (c_cfg, c_params) = phase_archs(peaks, p9)
    archs.update(more)
    arch_launches.update(more_launches)
    strict, strict_launches = p10(
        "codegen-2b f32", "cuda",
        lambda: phase_spec_codegen_f32(c_cfg, c_params))
    for k in strict:
        spec[f"codegen-2b f32 {k}"] = strict[k]
        spec_launches[f"codegen-2b f32 {k}"] = strict_launches[k]
    del c_params
    torch.cuda.empty_cache()
    for line in arch_lines(archs, p9):
        print(line, flush=True)
    for line in spec_lines(spec, p10, serving):
        print(line, flush=True)

    # phase 11, last: its ranks are processes of their own on the card(s)
    t0 = time.perf_counter()
    parallel, par_rows, par_launches = phase_parallel(
        peaks, serving["int8"]["streams"],
        spec["gpt-j-6b serving"]["streams"])
    print(f"parallel (phase 11) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in parallel_lines(parallel):
        print(line, flush=True)
    rows += par_rows

    total = collections.Counter(launches)
    total.update(par_launches)
    for counts in serve_launches.values():
        total.update(counts)
    for counts in arch_launches.values():
        total.update(counts)
    for counts in spec_launches.values():
        total.update(counts)
    total.update(train_launches)
    total.update(mini_launches)
    total.update(pythia_total)
    total.update(lab_launches)
    total.update(load_launches)
    total.update(headline_launches)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernel_rows=rows, model=model,
                       launches_inference=launches, serving=serving,
                       launches_serving=serve_launches, card_vs_cpu=vs_cpu,
                       training=training, minipythia=mini,
                       launches_minipythia=mini_launches, pythia=pythia,
                       launches_pythia=pythia_launches,
                       launches_labs=lab_launches, loading=loading,
                       launches_loading=load_launches, archs=archs,
                       launches_archs=arch_launches, speculative=spec,
                       launches_speculative=spec_launches,
                       parallel=parallel, launches_parallel=par_launches,
                       headline=headline,
                       launches_headline=headline_launches,
                       timings_unheld=UNHELD[0], ptxas=reports,
                       sass_k9_k10=sass, sass_k15=sass_batch,
                       sass_k12=sass_lab, sass_k2_tf32=sass_k2,
                       launch_floor_ms=floor_ms,
                       graph_launch_floor_ms=graph_floor_ms), f,
                  indent=1)
    print(f"chip_smoke: all phases pass in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernel_line(rows, total)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def main_parallel(nccl_only: bool = False) -> None:
    """``chip_smoke.py --parallel [nccl]``: phase 11 alone (the four-card
    run; ``nccl``: its NCCL run alone), after phase 4's int8 traffic on one
    card, plain and with phase 10's ``NgramDrafter(3, 4)``, for the streams
    it is held to.  Prints the same lines as the whole check's phase 11."""
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from vsim_tpu_torch.engine.serving import ServingEngine
    from vsim_tpu_torch.engine.speculative import NgramDrafter
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params
    from vsim_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = PRESETS["gpt-j-6b"].replace(compute_dtype="bfloat16")
    params = random_q4_params(cfg, seed=0, rng="device")
    streams = []
    for drafter in (None, NgramDrafter(3, 4)):
        srv = ServingEngine(cfg, params, max_batch=8, kv_dtype="int8",
                            drafter=drafter)
        srv.warmup()
        prompts, n_pred = serve_traffic(cfg.n_vocab)
        _, reqs, _ = serve_scenario(srv, prompts, n_pred)
        streams.append([r.generated for r in reqs])
        del srv
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parallel, rows, launches = phase_parallel(card_peaks(name), *streams,
                                              nccl_only=nccl_only)
    print(f"parallel (phase 11) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in parallel_lines(parallel):
        print(line, flush=True)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke_parallel.json"),
              "w") as f:
        json.dump(dict(card=smi, parallel=parallel, kernel_rows=rows,
                       launches=launches), f, indent=1)
    print(f"chip_smoke --parallel: pass in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def kernel_row_lines(rows):
    """One line a kernel row: ms beside its bound, plain and library ms."""
    return [f"  {r['kernel']} {r['shape']}: {r['ms']:.4g} ms, bound "
            f"{r['bound_ms']:.3g} ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4g}, library {r['library_ms']:.4g} "
            f"({r['ms'] / r['library_ms']:.2f}x), rel err {r['rel_err']:.2g}"
            for r in rows]


def main_minipythia() -> None:
    """``chip_smoke.py --minipythia``: the kernels built, then phase 12
    alone; its lines and one JSON line of its numbers."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from vsim_tpu_torch.ops import _build

    from vsim_tpu_torch.device import card_label

    smi = card_label()
    print(smi, flush=True)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    mini, rows, launches = phase_minipythia(peaks)
    for line in minipythia_lines(mini) + kernel_row_lines(rows):
        print(line, flush=True)
    print(json.dumps({"minipythia": mini, "kernel_rows": rows,
                      "launches": launches}))
    print(f"chip_smoke --minipythia: pass in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main_k2_tf32() -> None:
    """``chip_smoke.py --k2-tf32``: K2's f32-plane rows (k2_tf32_rows),
    the f32xf engine's stream margin (f32xf_margin) and the chat CLI
    engine's f32 prefill on Pythia-12B's seed-0 params alone, for a
    comparison with an earlier tree (this script copied into it)."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.models.init import random_q4_params
    from vsim_tpu_torch.ops import _build

    from vsim_tpu_torch.device import card_label

    smi = card_label()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    rows = k2_tf32_rows(peaks)
    for r in rows:
        print(f"  {r['shape']}: {r['ms']:.4g} ms, bound {r['bound_ms']:.3g} "
              f"(f32 FMA {r['fma_bound_ms']:.3g}), plain {r['plain_ms']:.4g}, "
              f"library {r['library_ms']:.4g} "
              f"({r['ms'] / r['library_ms']:.2f}x), rel err "
              f"{r['rel_err']:.2g}", flush=True)
    cfg = PRESETS["pythia-12b"].replace(compute_dtype="bfloat16")
    params = random_q4_params(cfg, seed=0, rng="device")
    margin = f32xf_margin(cfg, params)
    print(f"f32xf 100-token stream {margin['stream']}: per token, plain "
          f"top-2 margin {margin['plain_top2_margin']}, TF32-plain logit gap "
          f"{margin['tf32_plain_gap']} (max|logit| "
          f"{margin['max_abs_logit']:.4g}), argmax TF32 "
          f"{margin['argmax_tf32']}, plain {margin['argmax_plain']}",
          flush=True)
    prefill, _ = f32_prefill(cfg, params)
    for line in f32_prefill_lines(prefill):
        print(line, flush=True)
    print(json.dumps({"k2_tf32_rows": rows, "f32_prefill": prefill,
                      "f32xf_margin": margin}))
    print(f"chip_smoke --k2-tf32: pass in {time.perf_counter() - t0:.1f} s",
          flush=True)


def main_bwd(dtype: str) -> None:
    """``chip_smoke.py --bwd-bf16`` / ``--bwd-f32``: phase 2's K7/K8 rows of
    that dtype (f32: at head dims other than 64 and 128) and phase 6's
    training runs at that compute alone, their instance checks off, so
    that the same numbers can be taken on an earlier tree (this script
    copied into it)."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from vsim_tpu_torch.ops import _build

    from vsim_tpu_torch.device import card_label

    smi = card_label()
    print(smi, flush=True)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(["flash_attention", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv"])
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def bound(nbytes, ops, peak):
        t_b, t_o = nbytes / peaks[0] * 1e3, ops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    shapes = [s for s in FLASH_BWD_SHAPES if s[4] == dtype
              and (dtype == "bfloat16" or s[3] not in (64, 128))]
    rows = flash_bwd_rows(peaks, bound, g, shapes, strict=False)
    for r in rows:
        print(f"  {r['kernel']} {r['shape']}: {r['ms']:.4g} ms, bound "
              f"{r['bound_ms']:.2g}"
              + ("" if r["bound_3xtf32_ms"] is None
                 else f", 3xTF32 bound {r['bound_3xtf32_ms']:.3g}")
              + f", plain {r['plain_ms']:.4g}, library "
              f"{r['library_ms']:.4g} ({r['ms'] / r['library_ms']:.2f}x) "
              f"[{r.get('instance')}], max|err| {r['max_abs_err']:.3g} (rel "
              f"{r['rel_err']:.3g})"
              + ("" if r["rel_err_vs_f64"] is None else ", vs f64 "
                 + json.dumps(r["rel_err_vs_f64"])), flush=True)
    train, _ = dtype_training(peaks, dtype, strict=False)
    for line in training_lines(train):
        print(line, flush=True)
    tag = {"bfloat16": "bf16", "float32": "f32"}[dtype]
    print(json.dumps({f"bwd_{tag}_rows": rows, f"train_{tag}": train}))
    print(f"chip_smoke --bwd-{tag}: pass in {time.perf_counter() - t0:.1f} s",
          flush=True)


def main_fwd_f32() -> None:
    """``chip_smoke.py --fwd-f32``: K4's f32 rows alone -- phase 2's (T=16
    and 512 at H=16, D=256, and every f32 shape of FLASH_BWD_SHAPES) and
    phase 7's f32 prefill's (Pythia-12B's H=40, D=128 at T=20 and 100) --
    and phase 6's three f32 training runs (Pythia-410M whole, GPT-J-6B's
    and CodeGen-2B's widths at depth 2), their instance checks off, so that
    the same numbers can be taken on an earlier tree (this script copied
    into it)."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from vsim_tpu_torch.models.config import PRESETS
    from vsim_tpu_torch.ops import _build

    from vsim_tpu_torch.device import card_label

    smi = card_label()
    print(smi, flush=True)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(["flash_attention", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv"])
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    rows = []
    for B, H, T, D, dname in ((1, 16, 16, 256, "float32"),  # noqa: N806
                              (1, 16, 512, 256, "float32"),
                              *(s for s in FLASH_BWD_SHAPES
                                if s[4] == "float32")):
        q, k, v = (torch.randn((B, H, T, D), generator=g, device="cuda")
                   for _ in range(3))
        rows.append(k4_row(peaks, q, k, v, f"B={B} T={T} H={H} D={D} {dname}",
                           strict=False))
        del q, k, v
        torch.cuda.empty_cache()
    rows += f32_prefill_k4_rows(PRESETS["pythia-12b"], strict=False).values()
    for r in rows:
        print(k4_line(r), flush=True)
    pythia, _ = train_run("pythia-410m f32", PRESETS["pythia-410m"], 4, 5,
                          peaks[2], strict=False)
    train, _ = dtype_training(peaks, "float32", strict=False)
    train = {"pythia-410m f32": pythia, **train}
    for line in training_lines(train):
        print(line, flush=True)
    print(json.dumps({"k4_f32_rows": rows, "train_f32": train}))
    print(f"chip_smoke --fwd-f32: pass in {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--cpu-refs"]:
        cpu_refs_main(sys.argv[2])
    elif sys.argv[1:2] == ["--minipythia-cpu"]:
        minipythia_cpu_main(sys.argv[2], sys.argv[3])
    elif sys.argv[1:] == ["--k2-tf32"]:
        main_k2_tf32()
    elif sys.argv[1:] == ["--minipythia"]:
        main_minipythia()
    elif sys.argv[1:] == ["--bwd-bf16"]:
        main_bwd("bfloat16")
    elif sys.argv[1:] == ["--bwd-f32"]:
        main_bwd("float32")
    elif sys.argv[1:] == ["--fwd-f32"]:
        main_fwd_f32()
    elif sys.argv[1:2] == ["--parallel"] and sys.argv[2:] in ([], ["nccl"]):
        main_parallel(nccl_only=sys.argv[2:] == ["nccl"])
    else:
        main()
