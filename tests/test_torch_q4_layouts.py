"""Port vs JAX package: the plain versions of K9 (q4_matmul_i), K10
(q4_matmul_stacked) and K2 (q4_matmul_ps) against the Pallas kernels they
replace, run in interpret mode, under each dequant math.

  * K9 against ``pallas_q4_matmul`` (acc_dtype f32, as ``q4_matmul`` calls
    it: f32 planes under every math);
  * K10 against ``pallas_q4_matmul_stacked`` (acc_dtype bf16: bf16 planes
    and x under i32/f32x, f32 under f32xf/gi) for every layer of a stack;
  * K2 against ``pallas_q4_matmul_ps`` for bf16 and f32 x, n in {1, 8, 16}:
    the port's router sends each case where the JAX package sends it (K1
    for bf16 x at n <= 8 under gi, K2 with ``ps_round_planes`` otherwise).

Tolerance 2e-5 of max|ref|: both sides round at the same places, so only the
order of the f32 sums differs.  The JAX math is set only inside try/finally.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.ops import pallas_q4 as jpq
from vsim_tpu.quant import q4 as jq4
from vsim_tpu_torch.ops import q4_cuda
from vsim_tpu_torch.ops.matmul import (
    Q4Layer,
    ps_round_planes,
    q4_matmul,
    stacked_round_planes,
)
from vsim_tpu_torch.ops.q4_cuda import (
    q4_matmul_i,
    q4_matmul_ps,
    q4_matmul_stacked,
)
from vsim_tpu_torch.quant import q4 as pq4

MATHS = ["i32", "f32x", "f32xf", "gi"]
DTYPES = ["float32", "bfloat16"]
K, O = 1024, 512  # noqa: N806
L = 3


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= 2e-5 * np.abs(ref).max(), (err, np.abs(ref).max())


def _dense(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _both(dense):
    """The same interleaved Q4 weight in both packages."""
    return (jq4.Q4Tensor.from_dense_np(dense),
            pq4.Q4Tensor.from_dense_np(dense, device="cpu"))


def _x(n, dtype, seed):
    x = (np.random.default_rng(seed).standard_normal((n, K)) * 2).astype(
        np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _with_math(name, fn):
    jpq.set_dequant_math(name)
    q4_cuda.set_dequant_math(name)
    try:
        return fn()
    finally:
        jpq.set_dequant_math("gi")
        q4_cuda.set_dequant_math("gi")


@pytest.fixture(scope="module")
def stacked():
    return _both(_dense((L, O, K), seed=1))


@pytest.mark.parametrize("n", [1, 5, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_i_layout_plain_matches_pallas(n, dtype):
    jw, pw = _both(_dense((O, K), seed=2))
    xj, xp = _x(n, dtype, seed=n)
    b = np.random.default_rng(3).standard_normal(O).astype(np.float32)
    ref = np.asarray(jpq.pallas_q4_matmul(xj, jw, interpret=True)) + b
    got = q4_matmul_i(xp, pw.packed, pw.scales, torch.from_numpy(b))
    _close(got, ref)
    assert np.abs(ref).max() > 10  # the tolerance is tested at scale
    # the router sends an interleaved weight at n <= 128 to K9
    routed = q4_matmul(xp, pw, bias=torch.from_numpy(b), compute_dtype=dtype)
    assert torch.equal(routed, got)


@pytest.mark.parametrize("math_name", MATHS)
@pytest.mark.parametrize("il", range(L))
@pytest.mark.parametrize("dtype", DTYPES)
def test_stacked_plain_matches_pallas(stacked, math_name, il, dtype):
    jw, pw = stacked
    n = 3
    xj, xp = _x(n, dtype, seed=10 + il)
    ref = _with_math(math_name, lambda: np.asarray(
        jpq.pallas_q4_matmul_stacked(xj, jw, jnp.int32(il), interpret=True)))
    rnd = stacked_round_planes(math_name)
    ilt = torch.tensor(il, dtype=torch.int32)
    got = q4_matmul_stacked(xp, pw.packed, pw.scales, ilt, None, rnd)
    _close(got, ref)
    routed = _with_math(math_name, lambda: q4_matmul(
        xp, Q4Layer(pw, ilt), compute_dtype=dtype))
    assert torch.equal(routed, got)
    # the bf16 contract is a different result, not a reordering
    other = q4_matmul_stacked(xp, pw.packed, pw.scales, ilt, None, not rnd)
    assert not torch.equal(other, got)


@pytest.mark.parametrize("math_name", MATHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 8, 16])
def test_ps_route_matches_pallas_under_each_math(math_name, dtype, n):
    jw, pw = _both(_dense((O, K), seed=4))
    jw, pw = jq4.to_plane_split(jw), pq4.to_plane_split(pw)
    xj, xp = _x(n, dtype, seed=20 + n)
    b = (np.random.default_rng(5).standard_normal(O) * 3).astype(np.float32)
    ref = _with_math(math_name, lambda: np.asarray(jpq.pallas_q4_matmul_ps(
        xj, jw, bias=jnp.asarray(b), interpret=True)))
    bt = torch.from_numpy(b)
    routed = _with_math(math_name, lambda: q4_matmul(
        xp, pw, bias=bt, compute_dtype=dtype))
    _close(routed, ref)
    k1 = math_name == "gi" and dtype == "bfloat16" and n <= 8
    if not k1:  # K2 under the math's plane contract
        rnd = ps_round_planes(n, xp.dtype, math_name)
        assert rnd == (math_name in ("i32", "f32x")
                       or (math_name == "gi" and dtype == "bfloat16"))
        assert torch.equal(
            q4_matmul_ps(xp, pw.packed, pw.scales, bt, round_planes=rnd),
            routed)


def test_set_dequant_math_rejects_unknown():
    with pytest.raises(ValueError, match="unknown dequant math"):
        q4_cuda.set_dequant_math("bf16")
    assert q4_cuda.get_dequant_math() == "gi"
