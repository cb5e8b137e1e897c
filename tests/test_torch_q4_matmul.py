"""Port vs JAX package: the plain versions of K1 (q4_gemv_ps) and K2
(q4_matmul_ps) against the Pallas kernels they replace, run in interpret
mode, and the q4_matmul routes on the CPU.

Two contracts (ops/pallas_q4.py:611-612, :541-547):
  * bf16 x: n <= 8 takes the grouped-integer math (K1), n > 8 the bf16
    planes (K2) — both against pallas_q4_matmul_ps(..., interpret=True);
  * f32 x: unrounded f32 planes (K2) — against x @ dequantize_km(w).
Tolerance rtol=1e-5, atol=1e-3 at max|y| of about 100: only the order of
the f32 sums differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.ops.pallas_q4 import pallas_q4_matmul_ps
from vsim_tpu.quant import q4 as jq4
from vsim_tpu_torch.ops.matmul import q4_matmul
from vsim_tpu_torch.ops.q4_cuda import (q4_gemv_ps, q4_matmul_ps,
                                        q4_matmul_ps_splits)
from vsim_tpu_torch.quant import q4 as pq4

TOL = dict(rtol=1e-5, atol=1e-3)


def _weights(O, K, seed):
    """The same plane-split weight in both packages."""
    w = np.random.default_rng(seed).standard_normal((O, K)).astype(np.float32)
    j = jq4.to_plane_split(jq4.Q4Tensor.from_dense_np(w))
    p = pq4.to_plane_split(pq4.Q4Tensor.from_dense_np(w, device="cpu"))
    return j, p


def _inputs(n, K, O, seed, with_bias):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, K)) * 2).astype(np.float32)
    b = (rng.standard_normal(O) * 10).astype(np.float32) if with_bias else None
    return x, b


def _jax(x, jw, b, dtype):
    return np.asarray(pallas_q4_matmul_ps(
        jnp.asarray(x, dtype), jw, interpret=True,
        bias=None if b is None else jnp.asarray(b)))


# (K, O): K/2 % 256 == 0 keeps the gi math; O=512 takes the whole-O "giw"
# kernel, O=16896 (256*O > 4M) the 2-D "gi_bias" grid the lm head uses
@pytest.mark.parametrize("K,O", [(1024, 512), (512, 16896)])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("with_bias", [False, True])
def test_gemv_plain_matches_pallas_gi(K, O, n, with_bias):
    jw, pw = _weights(O, K, seed=K + O)
    x, b = _inputs(n, K, O, seed=n, with_bias=with_bias)
    ref = _jax(x, jw, b, jnp.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = q4_gemv_ps(xb, pw.packed, pw.scales,
                     None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (n, O)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert np.abs(ref).max() > 10  # the tolerance is tested at scale
    # the matmul router sends bf16 x with n <= 8 through K1
    routed = q4_matmul(xb, pw, bias=None if b is None else torch.from_numpy(b),
                       compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(routed.numpy(), got.numpy())


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("with_bias", [False, True])
def test_matmul_plain_matches_pallas_bf16_planes(n, with_bias):
    K, O = 1024, 512  # noqa: N806
    jw, pw = _weights(O, K, seed=11)
    x, b = _inputs(n, K, O, seed=n + 1, with_bias=with_bias)
    ref = _jax(x, jw, b, jnp.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = q4_matmul_ps(xb, pw.packed, pw.scales,
                       None if b is None else torch.from_numpy(b), True)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    routed = q4_matmul(xb, pw, bias=None if b is None else torch.from_numpy(b),
                       compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(routed.numpy(), got.numpy())


@pytest.mark.parametrize("n", [1, 16, 128])
def test_matmul_plain_f32_matches_unrounded_oracle(n):
    K, O = 1024, 512  # noqa: N806
    jw, pw = _weights(O, K, seed=13)
    x, b = _inputs(n, K, O, seed=n + 2, with_bias=True)
    ref = np.asarray(jnp.asarray(x) @ jq4.dequantize_km(jw, jnp.float32)) + b
    got = q4_matmul_ps(torch.from_numpy(x), pw.packed, pw.scales,
                       torch.from_numpy(b), False)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    routed = q4_matmul(torch.from_numpy(x), pw, bias=torch.from_numpy(b))
    np.testing.assert_array_equal(routed.numpy(), got.numpy())


@pytest.mark.parametrize("layout", ["i", "ps"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_above_128_rows_matches_xla(layout, dtype):
    """n > 128 (and interleaved weights) dequantize and matmul, as the JAX
    package's XLA path does (ops/matmul.py:_xla_q4_matmul)."""
    from vsim_tpu.ops.matmul import q4_matmul as jq4_matmul

    K, O, n = 256, 96, 130  # noqa: N806
    w = np.random.default_rng(3).standard_normal((O, K)).astype(np.float32)
    jw = jq4.Q4Tensor.from_dense_np(w)
    pw = pq4.Q4Tensor.from_dense_np(w, device="cpu")
    if layout == "ps":
        jw, pw = jq4.to_plane_split(jw), pq4.to_plane_split(pw)
    x, b = _inputs(n, K, O - 10, seed=4, with_bias=True)  # a padded bias
    ref = np.asarray(jq4_matmul(jnp.asarray(x, dtype), jw,
                                bias=jnp.asarray(b), impl="xla",
                                compute_dtype=jnp.dtype(dtype)))
    got = q4_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), pw,
                    bias=torch.from_numpy(b), compute_dtype=dtype)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("n", [1, 8, 9, 32, 100])
@pytest.mark.parametrize("K,O", [(4096, 4096), (5120, 15360), (5120, 51200),
                                 (16384, 4096), (128, 4100)])
def test_q4_matmul_ps_splits(n, K, O):  # noqa: N803
    """K2's split of K depends on the shapes alone (no data, so no host
    sync; both plane contracts: the bf16 and the TF32 tensor-core instances
    hold as many blocks an SM), and its splits, as the kernel cuts them
    (csrc/q4_matmul_ps.cu: groups G·s/splits .. G·(s+1)/splits), cover the
    K/64 groups exactly once, each split a whole, non-empty run of groups."""
    G = K // 64  # noqa: N806
    splits = q4_matmul_ps_splits(n, K, O, 132)
    assert splits == q4_matmul_ps_splits(n, K, O, 132)
    assert 1 <= splits <= G
    bounds = [(G * s // splits, G * (s + 1) // splits) for s in range(splits)]
    covered = [g for b, e in bounds for g in range(b, e)]
    assert covered == list(range(G)) and all(b < e for b, e in bounds)
    # one wave of blocks that fills the 132 SMs where K allows
    per_sm = 2 if n <= 32 else 1
    blocks = -(-O // (1024 if n <= 8 else 128)) * splits
    assert blocks <= per_sm * 132 or splits == 1
    assert blocks > per_sm * 132 - -(-O // (1024 if n <= 8 else 128)) \
        or splits == G


def test_dense_weight_route():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    w = rng.standard_normal((32, 64)).astype(np.float32)
    got = q4_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (3, 4, 32)
    np.testing.assert_allclose(got.numpy(), x @ w.T, rtol=1e-5, atol=1e-5)
