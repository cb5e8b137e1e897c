"""Port vs JAX package: the plain versions of K3 (decode attention over the
quantized cache) and K4 (flash attention forward) against the Pallas
kernels they replace, run in interpret mode, and against the oracles.

Tolerances: plain K3 vs the JAX kernel 1e-5 (both round q to bf16; only the
f32 sum order differs); vs the oracle, which keeps q in f32, 2e-2 as in
tests/test_decode_attention.py.  K4 at f32 1e-5; at bf16 one bf16 step of
the output (p rounds to bf16 before p.v in both).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.transformer import _kv_write as j_kv_write
from vsim_tpu.models.transformer import alibi_slopes as j_alibi
from vsim_tpu.models.transformer import init_cache as j_init_cache
from vsim_tpu.ops.attention import (
    _flash_bhtd,
    attention_reference as j_attention_reference,
    flash_attention as j_flash_attention,
)
from vsim_tpu.ops.decode_attention import (
    decode_attention_int8,
    decode_attention_oracle as j_decode_oracle,
)
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.transformer import _kv_write as p_kv_write
from vsim_tpu_torch.models.transformer import alibi_slopes as p_alibi
from vsim_tpu_torch.models.transformer import init_cache as p_init_cache
from vsim_tpu_torch.ops.attention import attention_reference, flash_attention_fwd
from vsim_tpu_torch.ops.decode_attention import (
    decode_attention_oracle,
    decode_attention_q,
    decode_split_plan,
)
from vsim_tpu_torch.quant.q4 import tensor_from_np


def _caches(L, B, H, S, D, n_fill, kv_dtype, seed=0):
    """The same quantized cache written by both packages' _kv_write; the
    port's must hold the JAX package's bytes."""
    kw = dict(arch="gptneox", n_vocab=32, n_ctx=S, n_embd=H * D, n_head=H,
              n_layer=L, n_ff=16, n_rot=0, kv_dtype=kv_dtype)
    jc = j_init_cache(JConfig(**kw), B)
    pc = p_init_cache(ModelConfig(**kw), B, device="cpu")
    rng = np.random.default_rng(seed)
    jk, jv = jc["k"], jc["v"]
    for il in range(L):
        nk = rng.standard_normal((B, n_fill, H, D)).astype(np.float32)
        nv = rng.standard_normal((B, n_fill, H, D)).astype(np.float32)
        jk = j_kv_write(jk, jnp.asarray(nk), jnp.int32(il), jnp.int32(0),
                        False, B, n_fill)
        jv = j_kv_write(jv, jnp.asarray(nv), jnp.int32(il), jnp.int32(0),
                        False, B, n_fill)
        p_kv_write(pc["k"], torch.from_numpy(nk), il, 0)
        p_kv_write(pc["v"], torch.from_numpy(nv), il, 0)
    for js, ps in ((jk, pc["k"]), (jv, pc["v"])):
        for ja, pa in zip(js, ps):
            np.testing.assert_array_equal(
                tensor_from_np(np.asarray(ja)).view(torch.int16).numpy()
                if pa.dtype == torch.bfloat16 else np.asarray(ja),
                pa.view(torch.int16).numpy()
                if pa.dtype == torch.bfloat16 else pa.numpy())
    return (jk, jv), (pc["k"], pc["v"])


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("n_past", [0, 5, 63])
def test_decode_attention_plain_matches_kernel(kv_dtype, D, n_past):
    L, B, H, S = 2, 2, 2, 128  # noqa: N806
    (jk, jv), (pk, pv) = _caches(L, B, H, S, D, n_past + 1, kv_dtype)
    q = np.random.default_rng(42).standard_normal((B, 1, H, D)).astype(
        np.float32)
    scale = D ** -0.5
    # layer 0 without ALiBi, layer 1 (an offset into the stacked cache) with
    for il, slopes in ((0, None), (1, j_alibi(H))):
        ps = None if slopes is None else p_alibi(H)
        ref = np.asarray(decode_attention_int8(
            jnp.asarray(q), jk, jv, jnp.int32(il), jnp.int32(n_past),
            kv_len=S, scale=scale, slopes=slopes, interpret=True))
        got = decode_attention_q(
            torch.from_numpy(q[:, 0]), pk, pv, il,
            torch.full((B,), n_past, dtype=torch.int32), scale=scale,
            slopes=ps)
        np.testing.assert_allclose(got.numpy(), ref[:, 0], rtol=1e-5,
                                   atol=1e-5)
        oracle = np.asarray(j_decode_oracle(
            jnp.asarray(q), jk, jv, il, n_past, kv_len=S, scale=scale,
            slopes=slopes))
        p_oracle = decode_attention_oracle(
            torch.from_numpy(q), pk, pv, il, n_past, scale=scale,
            slopes=ps)
        np.testing.assert_allclose(p_oracle.numpy(), oracle, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), oracle[:, 0], rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("B,H,S,n_sm,want", [
    (1, 16, 2048, 132, (128, 16)),   # GPT-J B=1: 256 blocks
    (1, 40, 2048, 132, (256, 8)),    # Pythia-12B B=1: 320 blocks
    (8, 16, 2048, 132, (1024, 2)),
    (1, 4, 300, 132, (64, 5)),       # S too short for 132 blocks
    (3, 4, 300, 16, (256, 2)),
    (1, 1, 1, 132, (64, 1)),
    (2, 32, 4096, 132, (1024, 4)),
])
def test_decode_split_plan(B, H, S, n_sm, want):  # noqa: N803
    """K3's split plan depends on the shapes alone (no n_past, so no host
    sync), covers [0, S) exactly once in tile multiples, and fills the card
    where S allows."""
    assert list(inspect.signature(decode_split_plan).parameters) == [
        "B", "H", "S", "n_sm"]
    c, n_split = decode_split_plan(B, H, S, n_sm)
    assert (c, n_split) == want == decode_split_plan(B, H, S, n_sm)
    assert c % 64 == 0 and c & (c - 1) == 0
    covered = [s for i in range(n_split) for s in range(i * c,
                                                        min(i * c + c, S))]
    assert covered == list(range(S))  # once each, and no split is empty
    if B * H * -(-S // 64) >= n_sm:
        assert B * H * n_split >= n_sm


def test_decode_attention_ragged_n_past():
    L, B, H, S, D = 1, 3, 2, 128, 64  # noqa: N806
    (jk, jv), (pk, pv) = _caches(L, B, H, S, D, 100, "int8", seed=1)
    q = np.random.default_rng(1).standard_normal((B, 1, H, D)).astype(
        np.float32)
    n_past = np.asarray([3, 57, 99], np.int32)
    ref = np.asarray(decode_attention_int8(
        jnp.asarray(q), jk, jv, jnp.int32(0), jnp.asarray(n_past), kv_len=S,
        scale=D ** -0.5, interpret=True))
    got = decode_attention_q(torch.from_numpy(q[:, 0]), pk, pv, 0,
                             torch.from_numpy(n_past), scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), ref[:, 0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_past,alibi", [(0, False), (32, False), (32, True)])
def test_flash_plain_matches_kernel(dtype, n_past, alibi):
    B, H, T, D = 1, 2, 64, 64  # noqa: N806
    S = n_past + T  # noqa: N806
    rng = np.random.default_rng(n_past + alibi)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    js = j_alibi(H) if alibi else None
    ps = p_alibi(H) if alibi else None
    ref = np.asarray(j_flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        n_past=n_past, slopes=js, interpret=True), np.float32)
    scale = D ** -0.5

    def head_major(a):  # [B, T, H, D] -> [B, H, T, D], the port's layout
        return torch.from_numpy(a).to(tdt).transpose(1, 2).contiguous()

    out, lse = flash_attention_fwd(head_major(q), head_major(k),
                                   head_major(v), n_past=n_past, scale=scale,
                                   slopes=ps)
    assert out.dtype == tdt
    got = out.transpose(1, 2).to(torch.float32)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    # lse, kept for the training slice's backward
    _, jlse = _flash_bhtd(
        jnp.asarray([n_past], jnp.int32),
        (jnp.zeros((H, 1)) if js is None else js.reshape(H, 1)),
        jnp.swapaxes(jnp.asarray(q, jdt), 1, 2),
        jnp.swapaxes(jnp.asarray(k, jdt), 1, 2),
        jnp.swapaxes(jnp.asarray(v, jdt), 1, 2), scale=scale, causal=True,
        alibi=alibi, block_q=T, block_s=S, interpret=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=1e-5, atol=1e-5)
    # both references agree with the plain kernel version at f32
    if dtype == "float32":
        jref = np.asarray(j_attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_past=n_past,
            slopes=js))
        pref = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), n_past=n_past,
                                   slopes=ps)
        np.testing.assert_allclose(pref.numpy(), jref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), jref, rtol=1e-5, atol=1e-5)
