"""Port vs JAX package: the plain version of K11 (q4_mlp_ps, the fused
fc + activation + proj) against ``pallas_q4_mlp_ps`` in interpret mode, and
the model's MLP route on the CPU.

E=512, F=1024 as tests/test_kernels.py:test_fused_mlp_ps_parity, for the
three activations, n in {1, 8}, with and without biases, f32 and bf16 x.
Tolerance 2e-5 of max|ref|: x, planes and h stay f32 on both sides and the
exact GELU is the same A&S 7.1.26 polynomial, so only the order of the f32
sums differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.ops.pallas_q4 import pallas_q4_mlp_ps
from vsim_tpu.quant import q4 as jq4
from vsim_tpu_torch.models import transformer
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.ops import q4_cuda
from vsim_tpu_torch.ops.q4_cuda import mlp_activation, q4_mlp_ps
from vsim_tpu_torch.quant import q4 as pq4

E, F = 512, 1024  # noqa: N806


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(13)
    out = {}
    for name, shape in (("fc", (F, E)), ("proj", (E, F))):
        dense = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        out[name] = (jq4.to_plane_split(jq4.Q4Tensor.from_dense_np(dense)),
                     pq4.to_plane_split(pq4.Q4Tensor.from_dense_np(
                         dense, device="cpu")))
    out["b_fc"] = (rng.standard_normal(F) * 0.1).astype(np.float32)
    out["b_proj"] = (rng.standard_normal(E) * 0.1).astype(np.float32)
    return out


@pytest.mark.parametrize("act", ["gelu_tanh", "relu", "gelu_exact"])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_plain_matches_pallas(weights, act, n, with_bias, dtype):
    (jfc, pfc), (jproj, pproj) = weights["fc"], weights["proj"]
    bfc = weights["b_fc"] if with_bias else None
    bproj = weights["b_proj"] if with_bias else None
    x = np.random.default_rng(n).standard_normal((n, E)).astype(np.float32)
    ref = np.asarray(pallas_q4_mlp_ps(
        jnp.asarray(x, dtype), jfc, None if bfc is None else jnp.asarray(bfc),
        jproj, None if bproj is None else jnp.asarray(bproj), act=act,
        interpret=True))
    got = q4_mlp_ps(torch.from_numpy(x).to(getattr(torch, dtype)), pfc.packed,
                    pfc.scales, None if bfc is None else torch.from_numpy(bfc),
                    pproj.packed, pproj.scales,
                    None if bproj is None else torch.from_numpy(bproj), act)
    assert got.dtype == torch.float32 and got.shape == (n, E)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 2e-5 * np.abs(ref).max(), err


def test_erf_poly_gelu_close_to_erf():
    """The A&S polynomial GELU stays within 2e-6 of torch's erf GELU."""
    h = torch.linspace(-8, 8, 4001)
    err = (mlp_activation(h, "gelu_exact")
           - torch.nn.functional.gelu(h)).abs().max().item()
    assert err < 2e-6, err
    with pytest.raises(ValueError, match="activation"):
        mlp_activation(h, "silu")


@pytest.mark.parametrize("math_name,n,fused", [
    ("gi", 1, False), ("f32xf", 1, True), ("i32", 8, True),
    ("f32xf", 9, False)])
def test_mlp_route(weights, monkeypatch, math_name, n, fused):
    """models/transformer.py:mlp takes K11 off the gi math at n <= 8 rows
    with plane-split weights, the two-matmul route otherwise."""
    (_, pfc), (_, pproj) = weights["fc"], weights["proj"]
    cfg = ModelConfig("gptneox", 64, 16, E, 4, 1, F, activation="gelu_exact")
    lp = {"w_fc": pfc, "w_proj": pproj,
          "b_fc": torch.from_numpy(weights["b_fc"]),
          "b_proj": torch.from_numpy(weights["b_proj"])}
    calls = []
    real = transformer.q4_mlp_ps
    monkeypatch.setattr(transformer, "q4_mlp_ps",
                        lambda *a: calls.append(1) or real(*a))
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, n, E)).astype(np.float32))
    q4_cuda.set_dequant_math(math_name)
    try:
        y = transformer.mlp(cfg, lp, h)
    finally:
        q4_cuda.set_dequant_math("gi")
    assert len(calls) == int(fused) and y.shape == h.shape
    ref = q4_mlp_ps(h[0], pfc.packed, pfc.scales, lp["b_fc"], pproj.packed,
                    pproj.scales, lp["b_proj"], "gelu_exact")
    # at f32 the two routes differ only by erf (polynomial vs torch's)
    np.testing.assert_allclose(y[0].numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4 * ref.abs().max().item())
