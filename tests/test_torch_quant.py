"""Port vs JAX package: Q4_0 byte formats, repacks and seeded init.

Every comparison here is exact (bytes, or bit patterns of the scales): the
port keeps the JAX package's formats so weights carry across unchanged.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vsim_tpu.models import init as jinit
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.quant import q4 as jq4
from vsim_tpu_torch.models import init as pinit
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.quant import q4 as pq4

SCALE_DTYPES = [
    (np.dtype(ml_dtypes.bfloat16), torch.bfloat16),
    (np.dtype(np.float32), torch.float32),
    (np.dtype(np.float16), torch.float16),
]


def _bits(a) -> np.ndarray:
    """Raw bytes of a numpy array, a torch tensor (any dtype) or a JAX
    array, for exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8).reshape(-1)


def _assert_same(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _weights(seed=0, shape=(96, 256)):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[0, :32] = 0.0  # an all-zero block: d == 0
    w[1, 5] = 7.5 * np.abs(w[1, :32]).max()  # a block with a dominant value
    return w


@pytest.mark.parametrize("jdt,tdt", SCALE_DTYPES)
def test_quantize_np_bit_identical(jdt, tdt):
    w = _weights()
    jp, js = jq4.quantize_q4_0_np(w, scale_dtype=jdt)
    pp, ps = pq4.quantize_q4_0_np(w, scale_dtype=tdt)
    _assert_same(pp, jp)
    _assert_same(ps, js)
    # the torch quantizer agrees with the numpy one
    t = pq4.quantize_q4_0(torch.from_numpy(w), scale_dtype=tdt)
    _assert_same(t.packed, np.ascontiguousarray(jp.T))
    _assert_same(t.scales, np.ascontiguousarray(js.T))


@pytest.mark.parametrize("jdt,tdt", SCALE_DTYPES)
def test_from_dense_np_bit_identical(jdt, tdt):
    w = _weights(1, (2, 64, 128))  # a leading (layer) axis
    j = jq4.Q4Tensor.from_dense_np(w, scale_dtype=jdt)
    p = pq4.Q4Tensor.from_dense_np(w, scale_dtype=tdt, device="cpu")
    assert p.shape == tuple(j.shape) == (2, 64, 128)
    _assert_same(p.packed, j.packed)
    _assert_same(p.scales, j.scales)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plane_split_and_dequantize_exact(dtype):
    w = _weights(2, (64, 512))
    j = jq4.Q4Tensor.from_dense_np(w)
    p = pq4.Q4Tensor.from_dense_np(w, device="cpu")
    jps, pps = jq4.to_plane_split(j), pq4.to_plane_split(p)
    assert pps.layout == "ps"
    _assert_same(pps.packed, jps.packed)
    _assert_same(pps.scales, jps.scales)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for jw, pw in ((j, p), (jps, pps)):
        _assert_same(pq4.dequantize_km(pw, tdt), jq4.dequantize_km(jw, jdt))
    # both layouts dequantize to the same matrix
    _assert_same(pq4.dequantize_km(pps), pq4.dequantize_km(p))


def test_plane_split_rejects_partial_groups():
    p = pq4.Q4Tensor.from_dense_np(_weights(3, (8, 32)), device="cpu")
    with pytest.raises(ValueError, match="K % 64"):
        pq4.to_plane_split(p)


def test_q4_take_rows_and_pad_out_exact():
    w = _weights(4, (50, 128))
    j = jq4.Q4Tensor.from_dense_np(w)
    p = pq4.Q4Tensor.from_dense_np(w, device="cpu")
    ids = np.asarray([[3, 0, 49], [7, 7, 1]], np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        _assert_same(pq4.q4_take_rows(p, torch.from_numpy(ids).long(), tdt),
                     jq4.q4_take_rows(j, jnp.asarray(ids), jdt))
    jp, pp = j.pad_out(64), p.pad_out(64)
    assert pp.out_features == 64
    _assert_same(pp.packed, jp.packed)
    _assert_same(pp.scales, jp.scales)


def _cfg_pair(**kw):
    base = dict(arch="gptj", n_vocab=96, n_ctx=32, n_embd=64, n_head=2,
                n_layer=2, n_ff=128, n_rot=16, rotary_interleaved=True,
                shared_layernorm=True, qkv_bias=False, attn_out_bias=False,
                final_logit_bias=True, activation="gelu_tanh")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _assert_trees_same(jtree, ptree):
    """A JAX params tree (numpy leaves) and a port tree hold the same bytes."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ptree)
        for k in jtree:
            _assert_trees_same(jtree[k], ptree[k])
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ptree)
        for a, b in zip(jtree, ptree):
            _assert_trees_same(a, b)
    elif isinstance(jtree, jq4.Q4Tensor):
        assert ptree.layout == jtree.layout
        _assert_same(ptree.packed, jtree.packed)
        _assert_same(ptree.scales, jtree.scales)
    else:
        _assert_same(ptree, jtree)


def test_random_q4_params_identical():
    jc, pc = _cfg_pair()
    j = jinit.random_q4_params(jc, seed=5)
    p = pinit.random_q4_params(pc, seed=5, device="cpu")
    _assert_trees_same(j, p)


@pytest.mark.parametrize("quantize", [True, False])
def test_init_params_identical(quantize):
    jc, pc = _cfg_pair(arch="bloom", alibi=True, parallel_residual=False,
                       shared_layernorm=False, final_logit_bias=False,
                       n_rot=0, rotary_interleaved=False)
    j = jinit.init_params(jc, seed=3, quantize=quantize)
    p = pinit.init_params(pc, seed=3, quantize=quantize, device="cpu")
    _assert_trees_same(j, p)


def test_fuse_qkv_and_params_from_numpy():
    jc, pc = _cfg_pair()
    j = jinit.init_params(jc, seed=7, quantize=True)
    p = params_from_numpy(pc, jax.tree.map(np.asarray, j), device="cpu")
    _assert_trees_same(j, p)
    jf = jinit.fuse_qkv_params(jc, j)
    pf = pinit.fuse_qkv_params(pc, p)
    assert "wq" in p["layers"]  # the caller's tree is left as it was
    _assert_same(pf["layers"]["w_qkv"].packed, jf["layers"]["w_qkv"].packed)
    _assert_same(pf["layers"]["w_qkv"].scales, jf["layers"]["w_qkv"].scales)
    # the engine-load repack: per-layer plane-split weights, same bytes as
    # the JAX package's to_plane_split of each layer
    prep = pinit.prepare_unrolled_params(pf)
    for il in range(pc.n_layer):
        one = jq4.Q4Tensor(packed=jf["layers"]["w_fc"].packed[il],
                           scales=jf["layers"]["w_fc"].scales[il])
        _assert_same(prep["layers"]["w_fc"][il].packed,
                     jq4.to_plane_split(one).packed)
    assert prep["lm_head"].layout == "ps"
    assert pinit.param_bytes(prep) == pinit.param_bytes(pf)


def test_params_from_numpy_dense():
    """A dense (training) tree carries across byte for byte and equals the
    port's own init; the dense fuse_qkv branch interleaves like the JAX
    package's."""
    jc, pc = _cfg_pair(arch="gptneox", rotary_interleaved=False,
                       shared_layernorm=False, qkv_bias=True,
                       attn_out_bias=True, final_logit_bias=False,
                       activation="gelu_exact")
    j = jinit.init_params(jc, seed=11, quantize=False)
    p = params_from_numpy(pc, jax.tree.map(np.asarray, j), device="cpu")
    _assert_trees_same(j, p)
    _assert_trees_same(j, pinit.init_params(pc, seed=11, device="cpu"))
    assert p["layers"]["wq"].dtype == torch.float32
    jf = jinit.fuse_qkv_params(jc, j)
    pf = pinit.fuse_qkv_params(pc, p)
    _assert_same(pf["layers"]["w_qkv"], jf["layers"]["w_qkv"])
    _assert_same(pf["layers"]["b_qkv"], jf["layers"]["b_qkv"])
