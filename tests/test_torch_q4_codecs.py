"""The port's Q4 codecs and bulk host transforms vs the JAX package's, byte
for byte: ``vsim_tpu_torch.quant.q4`` (the Q4_0 / Q4_1 quantizers and
dequantizers, the ggml stream codecs, ``Q4Tensor.from_row_major``) against
``vsim_tpu.quant.q4``, and ``vsim_tpu_torch.native`` against
``vsim_tpu.native``, at odd O, several K % 32 == 0 and the three scale
dtypes.  bf16 arrays are compared through their uint16 bits.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vsim_tpu import native as j_native
from vsim_tpu.quant import q4 as jq
from vsim_tpu_torch import native
from vsim_tpu_torch.quant import q4

SHAPES = [(7, 32), (33, 96), (65, 256)]
SCALES = {"bfloat16": (np.dtype(ml_dtypes.bfloat16), torch.bfloat16),
          "float16": (np.float16, torch.float16),
          "float32": (np.float32, torch.float32)}


def _w(O, K, seed=0):  # noqa: N803
    w = np.random.default_rng(seed).standard_normal((O, K)).astype(np.float32)
    w[1, :32] = 0.0  # an all-zero block: d == 0, every nibble 8
    return w


def _bits(a) -> np.ndarray:
    """An array's bytes as a comparable array (bf16 through uint16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) \
            if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _eq(got, want):
    got, want = _bits(got), _bits(want)
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("O,K", SHAPES)
def test_quantize_q4_0_and_histogram(O, K, scale):  # noqa: N803
    w = _w(O, K)
    jdt, tdt = SCALES[scale]
    jp, js, jh = jq.quantize_q4_0_with_hist_np(w, scale_dtype=jdt)
    p, s, h = q4.quantize_q4_0_with_hist_np(w, scale_dtype=tdt)
    _eq(p, jp)
    _eq(s, js)
    np.testing.assert_array_equal(h, jh)
    assert h.sum() == O * K
    _eq(q4.dequantize_q4_0_np(p, s), jq.dequantize_q4_0_np(jp, js))


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("O,K", SHAPES)
def test_ggml_q4_0_stream(O, K, scale):  # noqa: N803
    w = _w(O, K, seed=1)
    jdt, tdt = SCALES[scale]
    jp, js = jq.quantize_q4_0_np(w, scale_dtype=np.float32)
    raw = q4.to_ggml_q4_0_bytes(*q4.quantize_q4_0_np(w, torch.float32))
    _eq(raw, jq.to_ggml_q4_0_bytes(jp, js))
    p, s = q4.from_ggml_q4_0_bytes(raw, O, K, tdt)
    jp2, js2 = jq.from_ggml_q4_0_bytes(raw, O, K, jdt)
    _eq(p, jp2)
    _eq(s, js2)
    # a bf16 / f16 scale goes back into the stream widened to f32
    _eq(q4.to_ggml_q4_0_bytes(p, s), jq.to_ggml_q4_0_bytes(jp2, js2))


@pytest.mark.parametrize("O,K", SHAPES)
def test_q4_1(O, K):  # noqa: N803
    w = _w(O, K, seed=2)
    got = q4.quantize_q4_1_np(w)
    want = jq.quantize_q4_1_np(w)
    for g, r in zip(got, want):
        _eq(g, r)
    _eq(q4.dequantize_q4_1_np(*got), jq.dequantize_q4_1_np(*want))
    raw = q4.to_ggml_q4_1_bytes(*got)
    _eq(raw, jq.to_ggml_q4_1_bytes(*want))
    for g, r in zip(q4.from_ggml_q4_1_bytes(raw, O, K),
                    jq.from_ggml_q4_1_bytes(raw, O, K)):
        _eq(g, r)


@pytest.mark.parametrize("scale", list(SCALES))
def test_from_row_major_and_dequantize(scale):
    jdt, tdt = SCALES[scale]
    w = _w(2 * 33, 96, seed=3).reshape(2, 33, 96)  # a stacked weight
    jp, js = jq.quantize_q4_0_np(w.reshape(-1, 96), scale_dtype=jdt)
    jp, js = jp.reshape(2, 33, 48), js.reshape(2, 33, 3)
    p, s = q4.quantize_q4_0_np(w.reshape(-1, 96), tdt)
    t = q4.Q4Tensor.from_row_major(p.reshape(2, 33, 48), s.reshape(2, 33, 3),
                                   device="cpu")
    jt = jq.Q4Tensor.from_row_major(jp, js)
    assert t.packed.is_contiguous() and t.scales.is_contiguous()
    _eq(t.packed, np.asarray(jt.packed))
    _eq(t.scales, np.asarray(jt.scales))
    _eq(q4.dequantize_q4_0(t),
        np.asarray(jq.dequantize_q4_0(jt, jnp.float32)))


@pytest.mark.parametrize("O,K", SHAPES)
def test_native_quantize_dequantize(O, K):  # noqa: N803
    w = _w(O, K, seed=4)
    got = native.q4_quantize(w, with_hist=True)
    want = j_native.q4_quantize(w, with_hist=True)
    for g, r in zip(got, want):
        _eq(g, r)
    p, s = native.q4_quantize(w)
    _eq(p, want[0])
    _eq(s, want[1])
    _eq(native.q4_dequantize(p, s), j_native.q4_dequantize(p, s))


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("O,K", SHAPES)
def test_native_ggml_kmajor(O, K, scale):  # noqa: N803
    jdt, tdt = SCALES[scale]
    w = _w(O, K, seed=5)
    raw = jq.to_ggml_q4_0_bytes(*jq.quantize_q4_0_np(w, np.float32))
    pk, sk = native.ggml_to_kmajor(raw, O, K, tdt)
    jpk, jsk = j_native.ggml_to_kmajor(raw, O, K, scale_dtype=jdt)
    _eq(pk, jpk)
    _eq(sk, jsk)
    _eq(native.kmajor_to_ggml(pk, sk), j_native.kmajor_to_ggml(jpk, jsk))
    if scale == "float32":
        _eq(native.kmajor_to_ggml(pk, sk), raw)


def test_native_f16_widening():
    h = np.random.default_rng(6).standard_normal(4096).astype(np.float16)
    h[:6] = [6e-8, np.inf, -np.inf, 0.0, 65504, -0.0]  # subnormal, specials
    _eq(native.f16_to_f32(h), j_native.f16_to_f32(h))
