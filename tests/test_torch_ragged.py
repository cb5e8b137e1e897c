"""Port vs JAX package: the ragged serving step.

  * (a) the plain version of K5 (``decode_attention_fresh_plain``) against
    the JAX fresh-mode decode kernel in interpret mode, int8 and int4 KV,
    D in {64, 256}, ragged n_past with 0 and the sentinel S, with and
    without ALiBi: within 1e-5 of max|ref| (both round q to bf16; only the
    f32 sum order differs);
  * (b) the plain version of K6 (``scatter_rows_plain``) against the JAX
    writer kernel ``scatter_rows_inplace`` in interpret mode: bit for bit,
    a sentinel row writing nothing;
  * the ragged ``_kv_write`` against the JAX one: bit for bit, with rows
    wholly and partly past the cache dropped;
  * (c) a ragged ``forward`` on the tiny GPT-J config at f32 compute:
    logits within 1e-4 of max|logit|, the updated cache equal after
    dequantization to 1e-5.  An int8/int4 cache may differ by one
    quantization step where the two packages' f32 k/v (different sum
    orders) straddle a rounding boundary: at most 0.1% of the entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.models.transformer import _kv_quantize as j_quantize8
from vsim_tpu.models.transformer import _kv_quantize4 as j_quantize4
from vsim_tpu.models.transformer import _kv_write as j_kv_write
from vsim_tpu.models.transformer import alibi_slopes as j_alibi
from vsim_tpu.models.transformer import forward as j_forward
from vsim_tpu.models.transformer import init_cache as j_init_cache
from vsim_tpu.ops.decode_attention import (
    decode_attention_int8,
    scatter_rows_inplace,
    set_decode_kernel,
)
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.models.transformer import _kv_quantize as p_quantize8
from vsim_tpu_torch.models.transformer import _kv_quantize4 as p_quantize4
from vsim_tpu_torch.models.transformer import _kv_read, _kv_write
from vsim_tpu_torch.models.transformer import alibi_slopes as p_alibi
from vsim_tpu_torch.models.transformer import forward, init_cache
from vsim_tpu_torch.ops.decode_attention import (
    decode_attention_fresh,
    decode_attention_plain,
    scatter_rows,
    scatter_rows_plain,
)
from vsim_tpu_torch.quant.q4 import tensor_from_np

GPTJ_TINY = dict(arch="gptj", n_vocab=1000, n_ctx=128, n_embd=512, n_head=2,
                 n_layer=2, n_ff=1024, n_rot=64, rotary_interleaved=True,
                 shared_layernorm=True, qkv_bias=False, attn_out_bias=False,
                 final_logit_bias=True, activation="gelu_tanh")


def _to_torch(a):
    """A JAX array as a CPU tensor (bf16 through its bits)."""
    return tensor_from_np(np.asarray(a)).clone()


def _to_np(t):
    """A tensor's bytes for comparison (bf16 as its int16 bits)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _cache_pair(kv, L, B, H, S, D, seed):  # noqa: N803
    """One random int8/int4 cache side, as JAX arrays and as tensors."""
    rng = np.random.default_rng(seed)
    if kv == "int4":
        vals = rng.integers(0, 256, (L, B, H, S, D // 2), dtype=np.uint8)
    else:
        vals = rng.integers(-127, 128, (L, B, H, S, D), dtype=np.int8)
    sc = jnp.asarray(rng.random((L, B, H, S), dtype=np.float32) * 0.05,
                     jnp.bfloat16)
    jside = (jnp.asarray(vals), sc)
    return jside, tuple(_to_torch(a) for a in jside)


def _fresh_rows(kv, B, H, D, seed):  # noqa: N803
    """This step's k/v rows quantized by both packages (bytes must agree)."""
    rng = np.random.default_rng(seed)
    jq, pq = (j_quantize4, p_quantize4) if kv == "int4" else (j_quantize8,
                                                              p_quantize8)
    jrows, prows = [], []
    for _ in range(2):  # k, v
        x = rng.standard_normal((B, H, 1, D)).astype(np.float32)
        jv, js = jq(jnp.asarray(x), jnp.bfloat16)
        pv, ps = pq(torch.from_numpy(x), torch.bfloat16)
        np.testing.assert_array_equal(np.asarray(jv), pv.numpy())
        np.testing.assert_array_equal(_to_np(_to_torch(js)), _to_np(ps))
        jrows += [jv[:, :, 0], js[:, :, 0]]
        prows += [pv[:, :, 0], ps[:, :, 0]]
    return tuple(jrows), tuple(prows)


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("alibi", [False, True])
def test_fresh_plain_matches_jax_kernel(kv, D, alibi):
    L, B, H, S = 2, 4, 2, 128  # noqa: N806
    (jk, pk), (jv, pv) = (_cache_pair(kv, L, B, H, S, D, s) for s in (1, 2))
    jrows, prows = _fresh_rows(kv, B, H, D, 3)
    n_past = np.asarray([0, 5, 70, S], np.int32)  # S: the sentinel
    q = np.random.default_rng(4).standard_normal((B, 1, H, D)).astype(
        np.float32)
    scale = D ** -0.5
    js, ps = (j_alibi(H), p_alibi(H)) if alibi else (None, None)
    for il in range(L):
        ref = np.asarray(decode_attention_int8(
            jnp.asarray(q), jk, jv, jnp.int32(il), jnp.asarray(n_past),
            kv_len=S, scale=scale, slopes=js, interpret=True,
            fresh_rows=jrows))[:, 0]
        got = decode_attention_fresh(
            torch.from_numpy(q[:, 0]), pk, pv, il, torch.from_numpy(n_past),
            prows, scale=scale, slopes=ps).numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # the deferred order equals write-then-attend (K3's plain version) for
    # every row the writer does not drop
    rows_l = tuple(torch.stack([r] * L) for r in prows)
    scatter_rows_plain(pk, pv, rows_l, torch.from_numpy(n_past))
    live = n_past < S
    for il in range(L):
        after = decode_attention_plain(
            torch.from_numpy(q[:, 0]), pk, pv, il, torch.from_numpy(n_past),
            scale=scale, slopes=ps).numpy()
        ref = np.asarray(decode_attention_int8(
            jnp.asarray(q), jk, jv, jnp.int32(il), jnp.asarray(n_past),
            kv_len=S, scale=scale, slopes=js, interpret=True,
            fresh_rows=jrows))[:, 0]
        np.testing.assert_allclose(after[live], ref[live], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_scatter_rows_plain_matches_jax_writer(kv):
    L, B, H, S, D = 3, 4, 2, 128, 64  # noqa: N806
    (jk, pk), (jv, pv) = (_cache_pair(kv, L, B, H, S, D, s) for s in (5, 6))
    rng = np.random.default_rng(7)
    Dp = D // 2 if kv == "int4" else D  # noqa: N806
    lo, hi, dt = (0, 256, np.uint8) if kv == "int4" else (-127, 128, np.int8)
    def scales():
        return jnp.asarray(rng.random((L, B, H), dtype=np.float32),
                           jnp.bfloat16)

    jrows = (jnp.asarray(rng.integers(lo, hi, (L, B, H, Dp), dtype=dt)),
             scales(),
             jnp.asarray(rng.integers(lo, hi, (L, B, H, Dp), dtype=dt)),
             scales())
    prows = tuple(_to_torch(r) for r in jrows)
    n_past = np.asarray([0, 77, S - 1, S], np.int32)  # S writes nothing
    before = [_to_np(t).copy() for t in (*pk, *pv)]
    jk2, jv2 = scatter_rows_inplace(jk, jv, jrows, jnp.asarray(n_past),
                                    interpret=True)
    scatter_rows(pk, pv, prows, torch.from_numpy(n_past))  # CPU: plain
    for j, p in zip((*jk2, *jv2), (*pk, *pv)):
        np.testing.assert_array_equal(_to_np(_to_torch(j)), _to_np(p))
    # the sentinel row kept its bytes; every other row changed at its slot
    for b4, p in zip(before, (*pk, *pv)):
        np.testing.assert_array_equal(b4[:, 3], _to_np(p)[:, 3])
    assert (_to_np(pk[0])[:, 1, :, 77] == _to_np(prows[0])[:, 1]).all()


@pytest.mark.parametrize("kv", ["int8", "float32"])
def test_ragged_kv_write_matches_jax(kv):
    L, B, H, S, D, T = 2, 4, 2, 16, 8, 3  # noqa: N806
    kw = dict(arch="gptneox", n_vocab=32, n_ctx=S, n_embd=H * D, n_head=H,
              n_layer=L, n_ff=16, n_rot=0, kv_dtype=kv)
    jc = j_init_cache(JConfig(**kw), B)["k"]
    pc = init_cache(ModelConfig(**kw), B, device="cpu")["k"]
    rng = np.random.default_rng(8)
    # rows: in range, at the end, partly past the end, the sentinel
    n_past = np.asarray([0, S - T, S - 1, S], np.int32)
    for il in range(L):
        new = rng.standard_normal((B, T, H, D)).astype(np.float32)
        jc = j_kv_write(jc, jnp.asarray(new), jnp.int32(il),
                        jnp.asarray(n_past), True, B, T)
        _kv_write(pc, torch.from_numpy(new), il, torch.from_numpy(n_past))
    jside = jc if isinstance(jc, tuple) else (jc,)
    pside = pc if isinstance(pc, tuple) else (pc,)
    for j, p in zip(jside, pside):
        np.testing.assert_array_equal(_to_np(_to_torch(j)), _to_np(p))
    assert not _to_np(pside[0])[:, 3].any()  # the sentinel row wrote nothing


@pytest.fixture(scope="module")
def jax_params():
    params = j_init_params(JConfig(**GPTJ_TINY), seed=0, quantize=True,
                           std=0.05)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("kv", ["int8", "int4", "float32"])
def test_ragged_forward_matches_jax(jax_params, kv):
    """Prefill 3 rows, then two ragged steps: rows at their own lengths,
    one of them behind its prefill (it overwrites), one at the sentinel."""
    jc = JConfig(**GPTJ_TINY, kv_dtype=kv)
    cfg = ModelConfig(**GPTJ_TINY, kv_dtype=kv)
    params = params_from_numpy(cfg, jax_params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, jax_params)
    S = cfg.n_ctx  # noqa: N806
    prompt = np.random.default_rng(9).integers(0, 1000, (3, 10))
    steps = [(np.asarray([3, 17, 999]), np.asarray([10, 6, S], np.int32)),
             (np.asarray([42, 8, 1]), np.asarray([11, 7, S], np.int32))]

    set_decode_kernel("on")
    try:
        jcache = j_init_cache(jc, 3)
        _, jcache = j_forward(jc, jparams, jnp.asarray(prompt, jnp.int32),
                              jcache, 0, fresh_kv=True)
        refs = []
        for tok, npv in steps:
            logits, jcache = j_forward(jc, jparams,
                                       jnp.asarray(tok[:, None], jnp.int32),
                                       jcache, jnp.asarray(npv))
            refs.append(np.asarray(logits))
    finally:
        set_decode_kernel("auto")

    cache = init_cache(cfg, 3, device="cpu")
    _, cache = forward(cfg, params, torch.from_numpy(prompt), cache, 0,
                       fresh_kv=True)
    for (tok, npv), ref in zip(steps, refs):
        logits, cache = forward(cfg, params, torch.from_numpy(tok[:, None]),
                                cache, torch.from_numpy(npv))
        assert logits.shape == ref.shape and np.isfinite(logits).all()
        assert np.abs(logits.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    for side in ("k", "v"):
        jside = jcache[side]
        pside = (tuple(_to_torch(a) for a in jside) if isinstance(jside, tuple)
                 else _to_torch(jside))
        for il in range(cfg.n_layer):
            want = _kv_read(pside, il, S, torch.float32).numpy()
            got = _kv_read(cache[side], il, S, torch.float32).numpy()
            off = np.abs(got - want) > 1e-5 * (1 + np.abs(want))
            if kv == "float32":
                assert not off.any()
                continue
            step = _to_torch(jside[1][il]).float().numpy()[..., None]
            assert off.mean() <= 1e-3
            assert (np.abs(got - want) <= 1.01 * step)[off].all()
