"""K1-K6 on the card against their plain PyTorch versions, at small shapes.

Marked ``cuda``: each test skips without a CUDA device (decided in the
fixture, never at import).  On a machine with the card and no JAX
(``--noconftest`` skips tests/conftest.py, which imports jax):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances relative to max|plain|, as in chip_smoke.py: 1e-4 for the Q4
matmuls and 1e-3 for decode attention, fresh mode included (only the f32
sum and exp order differ), 1e-2 for bf16 flash output (rounded to bf16);
the row writer K6 is exact.
"""

import math

import pytest
import torch

from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.attention import flash_attention_fwd, flash_attention_plain
from vsim_tpu_torch.ops.decode_attention import (
    decode_attention_fresh,
    decode_attention_fresh_plain,
    decode_attention_plain,
    decode_attention_q,
    scatter_rows,
    scatter_rows_plain,
)
from vsim_tpu_torch.ops.q4_cuda import (
    q4_gemv_ps,
    q4_gemv_ps_plain,
    q4_matmul_ps,
    q4_matmul_ps_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _weight(K, O, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (K // 2, O), generator=g, device=dev,
                           dtype=torch.uint8)
    scales = (torch.rand((K // 32, O), generator=g, device=dev) * 0.01).to(
        torch.bfloat16)
    return packed, scales


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("K,O", [(512, 1024), (2048, 4100)])
def test_q4_gemv_ps(dev, n, K, O):
    packed, scales = _weight(K, O, dev, n)
    x = torch.randn((n, K), device=dev).to(torch.bfloat16)
    bias = torch.randn((O,), device=dev)
    before = _build.launch_counts["q4_gemv_ps"]
    got = q4_gemv_ps(x, packed, scales, bias)
    assert _build.launch_counts["q4_gemv_ps"] == before + 1
    assert _rel(got, q4_gemv_ps_plain(x, packed, scales, bias)) < 1e-4


@pytest.mark.parametrize("n", [9, 33, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q4_matmul_ps(dev, n, dtype):
    packed, scales = _weight(1024, 320, dev, n)
    x = torch.randn((n, 1024), device=dev).to(dtype)
    got = q4_matmul_ps(x, packed, scales, None)
    assert _rel(got, q4_matmul_ps_plain(x, packed, scales, None)) < 1e-4


def test_q4_kernels_reject_what_they_cannot_take(dev):
    packed, scales = _weight(96, 64, dev, 0)  # K % 64 != 0
    x = torch.randn((1, 96), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        q4_gemv_ps(x, packed, scales)
    packed, scales = _weight(128, 64, dev, 0)
    with pytest.raises(ValueError, match="x dtype"):
        q4_gemv_ps(x.new_zeros((1, 128), dtype=torch.float32), packed, scales)


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", [64, 256])
def test_decode_attention_q(dev, kv, D):
    L, B, H, S = 2, 3, 4, 300  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(D)
    Dp = D // 2 if kv == "int4" else D  # noqa: N806
    lo, hi, vdt = ((0, 256, torch.uint8) if kv == "int4"
                   else (-127, 128, torch.int8))

    def side():
        vals = torch.randint(lo, hi, (L, B, H, S, Dp), generator=g,
                             device=dev, dtype=vdt)
        sc = (torch.rand((L, B, H, S), generator=g, device=dev) * 0.05).to(
            torch.bfloat16)
        return vals, sc

    k, v = side(), side()
    q = torch.randn((B, H, D), generator=g, device=dev)
    n_past = torch.tensor([0, 70, 299], dtype=torch.int32, device=dev)
    slopes = torch.linspace(0.01, 0.1, H, device=dev)
    for sl in (None, slopes):
        got = decode_attention_q(q, k, v, 1, n_past, scale=D ** -0.5,
                                 slopes=sl)
        ref = decode_attention_plain(q, k, v, 1, n_past, scale=D ** -0.5,
                                     slopes=sl)
        assert _rel(got, ref) < 1e-3


def _kv_side(dev, g, kv, shape):
    """Random int8 or plane-packed int4 values of ``shape`` and bf16
    scales of ``shape[:-1]``."""
    lo, hi, vdt = ((0, 256, torch.uint8) if kv == "int4"
                   else (-127, 128, torch.int8))
    vals = torch.randint(lo, hi, shape, generator=g, device=dev, dtype=vdt)
    sc = (torch.rand(shape[:-1], generator=g, device=dev) * 0.05).to(
        torch.bfloat16)
    return vals, sc


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", [64, 256])
def test_decode_attention_fresh(dev, kv, D):
    L, B, H, S = 2, 4, 4, 300  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(D + 1)
    Dp = D // 2 if kv == "int4" else D  # noqa: N806
    k, v = (_kv_side(dev, g, kv, (L, B, H, S, Dp)) for _ in range(2))
    rows = (*_kv_side(dev, g, kv, (B, H, Dp)),
            *_kv_side(dev, g, kv, (B, H, Dp)))
    q = torch.randn((B, H, D), generator=g, device=dev)
    n_past = torch.tensor([0, 1, 299, 300], dtype=torch.int32, device=dev)
    slopes = torch.linspace(0.01, 0.1, H, device=dev)
    before = _build.launch_counts["decode_attention_fresh"]
    for sl in (None, slopes):
        got = decode_attention_fresh(q, k, v, 1, n_past, rows,
                                     scale=D ** -0.5, slopes=sl)
        ref = decode_attention_fresh_plain(q, k, v, 1, n_past, rows,
                                           scale=D ** -0.5, slopes=sl)
        assert torch.isfinite(got).all()
        assert _rel(got, ref) < 1e-3
    assert _build.launch_counts["decode_attention_fresh"] == before + 2


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", [20, 256])  # Dp % 16 != 0: the byte copy
def test_scatter_rows(dev, kv, D):
    L, B, H, S = 3, 4, 2, 200  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(D + 2)
    Dp = D // 2 if kv == "int4" else D  # noqa: N806
    k, v = (_kv_side(dev, g, kv, (L, B, H, S, Dp)) for _ in range(2))
    rows = (*_kv_side(dev, g, kv, (L, B, H, Dp)),
            *_kv_side(dev, g, kv, (L, B, H, Dp)))
    n_past = torch.tensor([0, 77, S - 1, S], dtype=torch.int32, device=dev)
    k_ref, v_ref = (tuple(t.clone() for t in side) for side in (k, v))
    before = _build.launch_counts["scatter_rows"]
    scatter_rows(k, v, rows, n_past)
    scatter_rows_plain(k_ref, v_ref, rows, n_past)
    assert _build.launch_counts["scatter_rows"] == before + 1
    for got, ref in zip((*k, *v), (*k_ref, *v_ref)):
        assert torch.equal(got, ref)
    assert torch.equal(k[0][:, 1, :, 77], rows[0][:, 1])


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("T,n_past", [(5, 0), (100, 37)])
def test_flash_attention_fwd(dev, dtype, tol, T, n_past):
    B, H, D = 2, 3, 96  # noqa: N806
    S = n_past + T  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(T)
    q = torch.randn((B, H, T, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, H, S, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, H, S, D), generator=g, device=dev).to(dtype)
    slopes = torch.linspace(0.01, 0.1, H, device=dev)
    out, lse = flash_attention_fwd(q, k, v, n_past=n_past,
                                   scale=1 / math.sqrt(D), slopes=slopes)
    ref, lse_ref = flash_attention_plain(q, k, v, n_past=n_past,
                                         scale=1 / math.sqrt(D), slopes=slopes)
    assert _rel(out, ref) < tol
    assert _rel(lse, lse_ref) < 1e-4
