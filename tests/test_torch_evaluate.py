"""Port vs JAX package: perplexity, logit delta, fake quantization and the
act-quant forward (engine/evaluate.py, quant/q4.py:fake_quantize,
ops/matmul.py:q4_matmul_act_quant) on a tiny GPT-NeoX, f32, dense and Q4
params from both packages' ``init_params`` (the same bytes).

Tolerances: NLL, ppl and logits rtol 1e-5 / atol 1e-5 (f32, only the order
of sums differs; the JAX side pads its last window, the port too);
fake_quantize exact (the same f32 operations in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.engine import evaluate as jeval
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.models.transformer import forward as j_forward
from vsim_tpu.quant.q4 import fake_quantize as j_fake_quantize
from vsim_tpu_torch.engine import evaluate as peval
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import init_params
from vsim_tpu_torch.models.transformer import forward
from vsim_tpu_torch.quant.q4 import fake_quantize

NEOX_TINY = dict(arch="gptneox", n_vocab=128, n_ctx=16, n_embd=64, n_head=4,
                 n_layer=2, n_ff=128, n_rot=8)


@pytest.fixture(scope="module")
def models():
    jc, pc = JConfig(**NEOX_TINY), ModelConfig(**NEOX_TINY)
    out = {}
    for quantize in (False, True):
        out[quantize] = (j_init_params(jc, seed=5, quantize=quantize),
                         init_params(pc, seed=5, quantize=quantize,
                                     device="cpu"))
    return jc, pc, out


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n_tok,window", [(40, 0), (15, 16), (23, 8)])
def test_perplexity_matches_jax(models, quantize, n_tok, window):
    """Windows of 16 (n_ctx) or 8 tokens; 40 and 23 tokens end in a ragged
    last window, 15 fit in one."""
    jc, pc, trees = models
    jp, pp = trees[quantize]
    toks = np.random.default_rng(n_tok).integers(0, 128, n_tok).tolist()
    ref = jeval.perplexity(jc, jp, toks, window=window)
    got = peval.perplexity(pc, pp, toks, window=window)
    # windows share their edge token, so every token but the first is a
    # target once
    assert got["tokens"] == ref["tokens"] == n_tok - 1
    np.testing.assert_allclose(got["nll"], ref["nll"], rtol=1e-5)
    np.testing.assert_allclose(got["ppl"], ref["ppl"], rtol=1e-5)


def test_logit_delta_matches_jax(models):
    jc, pc, trees = models
    toks = list(range(1, 13))
    ref = jeval.logit_delta(jc, trees[False][0], jc, trees[True][0], toks)
    got = peval.logit_delta(pc, trees[False][1], pc, trees[True][1], toks)
    assert got["max_abs"] > 0
    for key in ("max_abs", "mean_abs"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-6)
    assert got["argmax_match"] == ref["argmax_match"]
    same = peval.logit_delta(pc, trees[False][1], pc, trees[False][1], toks)
    assert same["max_abs"] == 0.0 and same["argmax_match"] == 1.0


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_fake_quantize_exact(scale_dtype):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((6, 128)) * 0.3).astype(np.float32)
    w[1, :32] = 0.0  # an all-zero block: d = 0
    w[2, :32] = np.arange(32) * 0.5 - 8.0  # exact halves of d = 8/7
    w[3, 32:64] = 7.0 * np.float32(0.1) * np.sign(rng.standard_normal(32))
    ref = np.asarray(j_fake_quantize(jnp.asarray(w), jnp.dtype(scale_dtype)))
    got = fake_quantize(torch.from_numpy(w), getattr(torch, scale_dtype))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got[1, :32].any()


@pytest.mark.parametrize("quantize", [False, True])
def test_act_quant_forward_matches_jax(models, quantize):
    """cfg.act_quant Q4_0-quantizes the activations before every weight
    matmul, as the JAX forward does; the logits differ from the plain mode."""
    _, _, trees = models
    jp, pp = trees[quantize]
    jc = JConfig(**NEOX_TINY, act_quant=True)
    pc = ModelConfig(**NEOX_TINY, act_quant=True)
    ids = np.random.default_rng(7).integers(0, 128, (2, 12))
    ref = np.asarray(jax.jit(lambda p, i: j_forward(jc, p, i, None, 0)[0])(
        jp, jnp.asarray(ids, jnp.int32)))
    got, _ = forward(pc, pp, torch.from_numpy(ids), None, 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    plain, _ = forward(ModelConfig(**NEOX_TINY), pp, torch.from_numpy(ids),
                       None, 0)
    assert np.abs(plain.numpy() - ref).max() > 1e-3
