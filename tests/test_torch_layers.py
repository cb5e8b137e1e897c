"""Port vs JAX package: LayerNorm, GELUs and RoPE (NeoX and GPT-J, partial
n_rot).  Same numpy inputs through both; f32 to 1e-6, bf16 to one bf16
rounding step (the two frameworks round the same f32 value, but the f32
value itself may differ in its last bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.ops import layers as jlayers
from vsim_tpu.ops import rope as jrope
from vsim_tpu_torch.ops import layers as players
from vsim_tpu_torch.ops import rope as prope


def _np(t):
    return t.detach().to(torch.float32).numpy()


TOLS = {"float32": dict(rtol=1e-6, atol=1e-6),
        "bfloat16": dict(rtol=8e-3, atol=8e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    ref = jlayers.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w),
                             jnp.asarray(b), 1e-5)
    got = players.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               **TOLS[dtype])


@pytest.mark.parametrize("name", ["gelu_tanh", "gelu_exact", "gelu_new",
                                  "relu", "silu"])
def test_activations(name):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    ref = jlayers.get_activation(name)(jnp.asarray(x))
    got = players.get_activation(name)(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_unknown_activation():
    with pytest.raises(ValueError, match="unknown activation"):
        players.get_activation("swish9")


@pytest.mark.parametrize("interleaved,n_rot,D", [
    (False, 16, 64), (False, 64, 64), (True, 64, 256), (True, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(interleaved, n_rot, D, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, D)).astype(np.float32)
    pos = (np.arange(7, dtype=np.int32)[None] + np.asarray([[0], [100]],
                                                          np.int32))
    ref = jrope.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos), n_rot,
                           interleaved=interleaved)
    got = prope.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(pos), n_rot,
                           interleaved=interleaved)
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               **TOLS[dtype])
    # dims past n_rot pass through untouched
    np.testing.assert_array_equal(
        _np(got)[..., n_rot:],
        _np(torch.from_numpy(x).to(getattr(torch, dtype)))[..., n_rot:])
