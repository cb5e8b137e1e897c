"""Port vs JAX tool: ``vsim_tpu_torch/tools/kv_ppl.py`` against the loop of
``tools/kv_ppl.py`` (written out here: the JAX tool is a command line
only), on the tiny GPT-NeoX of tests/test_torch_train_small.py with its
Q4_0 weights, W = 2 windows of T = 16 held-out bytes.

Tolerances on the summed NLL: rtol 1e-5 over the float32 and bfloat16
caches (f32 compute; sums in another order), 1e-4 over int8 and int4,
where an entry that lies at a rounding boundary of the cache's quantizer
can round the other way in the other framework (ROADMAP.md §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_small import CORPUS_BYTES, jts, tiny
from vsim_tpu.models.transformer import forward as j_forward
from vsim_tpu.models.transformer import init_cache as j_init_cache
from vsim_tpu_torch.tools import kv_ppl as pkv
from vsim_tpu_torch.tools import train_small as pts

W, T = 2, 16
RTOL = {"float32": 1e-5, "bfloat16": 1e-5, "int8": 1e-4, "int4": 1e-4}


@pytest.fixture(scope="module")
def setup():
    """(eval bytes, the JAX Q4 params, the JAX config, the port's Q4
    params, the port's config)."""
    _, eval_b = pts.build_corpus(CORPUS_BYTES)
    jc, jp, pc, pp = tiny("float32", seed=5)
    return eval_b, jts.quantize_params(jp), jc, pts.quantize_params(pp), pc


def jax_kv_nll(cfg0, qparams, ids_np, kv):
    """tools/kv_ppl.py:77-99 for one kv dtype: (summed NLL, positions)."""
    cfg = cfg0.replace(compute_dtype="float32", kv_dtype=kv)
    ids = jnp.asarray(ids_np, jnp.int32)
    n_win = ids.shape[0]

    @jax.jit
    def step(cache, tok, n_past):
        logits, cache = j_forward(cfg, qparams, tok[:, None], cache, n_past)
        return cache, logits[:, 0]

    nll, n = 0.0, 0
    cache = j_init_cache(cfg, n_win, n_ctx=ids.shape[1])
    cache, logits = step(cache, ids[:, 0], jnp.int32(0))
    for t in range(1, ids.shape[1]):
        lse = jax.nn.log_softmax(logits, axis=-1)
        nll += float(-jnp.take_along_axis(
            lse, ids[:, t][:, None], axis=1).sum())
        n += n_win
        cache, logits = step(cache, ids[:, t], jnp.int32(t))
    return nll, n


def test_eval_windows_match_the_jax_tool(setup):
    eval_b = setup[0]
    got = pkv.eval_windows(eval_b, W, T)
    starts = np.linspace(0, len(eval_b) - T, W).astype(np.int64)
    want = np.stack([np.asarray(eval_b[s: s + T], np.int32) for s in starts])
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert starts[-1] == len(eval_b) - T  # spread over the whole eval set
    with pytest.raises(ValueError):
        pkv.eval_windows(eval_b[:W * T - 1], W, T)


@pytest.mark.parametrize("kv", pkv.KV_DTYPES)
def test_kv_nll_matches_jax_loop(setup, kv):
    eval_b, jq, jc, pq, pc = setup
    ids = pkv.eval_windows(eval_b, W, T)
    want, n_want = jax_kv_nll(jc, jq, ids, kv)
    got, n = pkv.kv_nll(pc, pq, torch.from_numpy(ids), kv)
    assert n == n_want == W * (T - 1)
    np.testing.assert_allclose(got, want, rtol=RTOL[kv])


def test_kv_table():
    rows = {kv: dict(nll=float(i + 10), positions=10, ppl=float(np.exp(
        (i + 10) / 10))) for i, kv in enumerate(pkv.KV_DTYPES)}
    table = pkv.kv_table(rows)
    assert table["kv_float32"] == round(np.exp(1.0), 4)
    assert table["delta_kv_int4_vs_f32"] == round(
        table["kv_int4"] - table["kv_float32"], 4)
    assert len(table) == 4 + 3
