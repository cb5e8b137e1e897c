"""The card's side of speculative decoding and of the BLOOM / GPT-2 /
CodeGen serving paths, at small shapes.

Marked ``cuda``: each test skips without a CUDA device (decided in the
fixture, never at import).  On a machine with the card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda_spec.py -q

  * K3 and K5 with BLOOM's ALiBi slopes at BLOOM-7b1's H = 32, D = 128,
    int8 and int4 caches, against their plain versions within 1e-3 of
    max|plain| (chip_smoke.py's TOL_DECODE);
  * K4 with the same slopes at D = 128, T = 300, bf16 (1e-2) and f32
    (1e-4);
  * the verify step's ragged T = gamma + 1 cache write
    (models/transformer.py:_kv_write) on the card, byte for byte against
    the same write on the CPU, for int8, int4 and f32 caches, rows that run
    past the cache's end and the inactive-slot sentinel included;
  * SpeculativeEngine (both drafters) and the speculative ServingEngine
    replayed from captured graphs against the same engines with
    ``cuda_graph=False``: the same tokens, and the cycle's kernels counted
    per replay.
"""

import math

import pytest
import torch

from vsim_tpu_torch.engine.serving import ServingEngine
from vsim_tpu_torch.engine.speculative import (
    ModelDrafter,
    NgramDrafter,
    SpeculativeEngine,
)
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import random_q4_params
from vsim_tpu_torch.models.transformer import (
    _kv_write,
    alibi_slopes,
    init_cache,
)
from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.attention import flash_attention_fwd, flash_attention_plain
from vsim_tpu_torch.ops.decode_attention import (
    decode_attention_fresh,
    decode_attention_fresh_plain,
    decode_attention_plain,
    decode_attention_q,
)

pytestmark = pytest.mark.cuda

H_BLOOM, D_BLOOM = 32, 128  # BLOOM-7b1's heads and head dim


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _kv_side(dev, g, kv, shape):
    lo, hi, vdt = ((0, 256, torch.uint8) if kv == "int4"
                   else (-127, 128, torch.int8))
    vals = torch.randint(lo, hi, shape, generator=g, device=dev, dtype=vdt)
    sc = (torch.rand(shape[:-1], generator=g, device=dev) * 0.05).to(
        torch.bfloat16)
    return vals, sc


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_decode_attention_alibi_bloom_width(dev, kv):
    """K3 at B = 1 (the graphed one-token step) and K5 at B = 8 (the
    serving step, the sentinel row included) with BLOOM's slopes."""
    L, S = 2, 2048  # noqa: N806
    H, D = H_BLOOM, D_BLOOM  # noqa: N806
    Dp = D // 2 if kv == "int4" else D  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(7)
    slopes = alibi_slopes(H, dev)
    for B, n_past in ((1, [1500]), (8, [0, 1, 127, 300, 1024, 1500, 2047,  # noqa: N806
                                        2048])):
        k, v = (_kv_side(dev, g, kv, (L, B, H, S, Dp)) for _ in range(2))
        q = torch.randn((B, H, D), generator=g, device=dev)
        npv = torch.tensor(n_past, dtype=torch.int32, device=dev)
        kw = dict(scale=D ** -0.5, slopes=slopes, round_q=True)
        if B == 1:
            got = decode_attention_q(q, k, v, 1, npv, **kw)
            ref = decode_attention_plain(q, k, v, 1, npv, **kw)
        else:
            rows = (*_kv_side(dev, g, kv, (B, H, Dp)),
                    *_kv_side(dev, g, kv, (B, H, Dp)))
            got = decode_attention_fresh(q, k, v, 1, npv, rows, **kw)
            ref = decode_attention_fresh_plain(q, k, v, 1, npv, rows, **kw)
        assert torch.isfinite(got).all()
        assert _rel(got, ref) < 1e-3, (B, kv)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
def test_flash_attention_alibi_d128(dev, dtype, tol):
    """K4 as a BLOOM prefill of 300 tokens gives it: causal, n_past 0,
    ALiBi slopes of 32 heads."""
    B, H, T, D = 1, H_BLOOM, 300, D_BLOOM  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(300)
    q, k, v = (torch.randn((B, H, T, D), generator=g, device=dev).to(dtype)
               for _ in range(3))
    kw = dict(n_past=0, scale=1 / math.sqrt(D), slopes=alibi_slopes(H, dev))
    out, lse = flash_attention_fwd(q, k, v, **kw)
    ref, lse_ref = flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(out).all()
    assert _rel(out, ref) < tol
    assert _rel(lse, lse_ref) < 1e-4


def _cache_bytes(cache):
    out = []
    for side in ("k", "v"):
        t = cache[side]
        for x in (t if isinstance(t, tuple) else (t,)):
            out.append(x.contiguous().view(torch.uint8).cpu())
    return out


@pytest.mark.parametrize("kv", ["int8", "int4", "float32"])
def test_ragged_verify_write_card_vs_cpu(dev, kv):
    """The verify's write of gamma + 1 = 5 rows a slot at ragged n_past:
    slots at 0, mid-cache, 2 rows before the end (3 rows dropped) and the
    sentinel S (all dropped), twice into one layer (the second write lands
    on the first's rows)."""
    cfg = ModelConfig("bloom", 1000, 64, 256, 4, 2, 512, alibi=True)
    B, T, S = 4, 5, 64  # noqa: N806
    g = torch.Generator().manual_seed(11)
    caches = {d: init_cache(cfg, B, n_ctx=S, dtype=kv, device=d)
              for d in ("cpu", dev)}
    for il, n_past in ((1, [0, 20, S - 2, S]), (1, [3, 22, S - 4, S])):
        new = torch.randn((B, T, cfg.n_head, cfg.head_dim), generator=g)
        npv = torch.tensor(n_past, dtype=torch.int32)
        for d, cache in caches.items():
            for side in ("k", "v"):
                _kv_write(cache[side], new.to(d), il, npv.to(d))
    got, want = (_cache_bytes(caches[d]) for d in (dev, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert any(x.any() for x in want)


def _tiny():
    cfg = ModelConfig("gptj", 1000, 128, 512, 2, 2, 1024, n_rot=64,
                      rotary_interleaved=True, shared_layernorm=True,
                      qkv_bias=False, attn_out_bias=False,
                      final_logit_bias=True, activation="gelu_tanh",
                      compute_dtype="bfloat16", kv_dtype="int8")
    return cfg, random_q4_params(cfg, seed=1, device="cuda")


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_spec_replay_equals_eager_on_card(dev, kind):
    cfg, params = _tiny()
    dcfg = cfg.replace(n_layer=1)
    dparams = random_q4_params(dcfg, seed=2, device="cuda")
    prompt = [5, 17, 301, 44, 5, 17, 301, 44, 5, 17]
    runs = {}
    for graphed in (True, False):
        drafter = (NgramDrafter(3, 4) if kind == "ngram"
                   else ModelDrafter(dcfg, dparams, gamma=4))
        eng = SpeculativeEngine(cfg, params, drafter, cycles_per_chunk=3,
                                cuda_graph=graphed)
        _build.reset_launch_counts()
        res = eng.generate(prompt, 30)
        runs[graphed] = (res.token_ids, res.cycles, dict(_build.launch_counts))
        assert all((s.graph is not None) == graphed
                   for s in eng._steps.values())
    assert runs[True] == runs[False]
    counts = runs[True][2]
    assert counts["q4_gemv_ps"] > 0 and counts["flash_attention"] > 0
    if kind == "model":  # the drafter's one-token steps: K5, then K6
        assert counts["decode_attention_fresh"] > 0
        assert counts["scatter_rows"] > 0


def test_spec_serving_replay_equals_eager_on_card(dev):
    cfg, params = _tiny()
    prompts = [[5, 17, 301, 44, 5, 17, 301], [9, 8], [4, 5, 6, 4, 5, 6],
               [11], [3, 14, 15, 92, 3, 14]]
    runs = {}
    for graphed in (True, False):
        srv = ServingEngine(cfg, params, max_batch=2, cuda_graph=graphed,
                            drafter=NgramDrafter(2, 4))
        srv.warmup()
        _build.reset_launch_counts()
        out = srv.run(prompts, 12, stop_tokens=())
        runs[graphed] = ([out[i].generated for i in sorted(out)],
                         srv.spec_cycles, srv.spec_emitted)
        assert all((s.graph is not None) == graphed
                   for s in srv._spec_steps.values())
    assert runs[True] == runs[False]
