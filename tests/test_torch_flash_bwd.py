"""Port vs JAX package: the flash-attention backward.

``flash_attention_bwd_plain`` (the plain version of K7/K8) and the gradients
of ``FlashAttention`` (torch autograd through the port's flash entry) against
``jax.vjp`` of ``vsim_tpu.ops.attention.flash_attention`` with its Pallas
forward and backward kernels in interpret mode, on the same numpy q/k/v/do.

Tolerances: f32 2e-4 (rtol and atol), as tests/test_attention.py holds the
Pallas gradients to their oracle; bf16 one bf16 step at max|grad| (both
sides compute in f32 from the same bf16 inputs and round once at the store,
so a rounding may flip by one step).

The split numerics of K7/K8's tensor-core instance ("mma_3xtf32", f32 at D =
64 and 128) are held here too, on the CPU: ``tf32_round`` splits each
operand into big + small TF32 halves, and the backward with its five
products emulated as the kernel's three TF32 products (summed in f64) stays
within 1e-5 of max|``_bwd_plain``|, while one TF32 product per f32 product
misses the card's 1e-4 tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.models.transformer import alibi_slopes as j_alibi
from vsim_tpu.ops.attention import _flash_bhtd, _flash_bwd_bhtd
from vsim_tpu.ops.attention import flash_attention as j_flash_attention
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import init_params
from vsim_tpu_torch.models.transformer import alibi_slopes as p_alibi
from vsim_tpu_torch.models.transformer import forward
from vsim_tpu_torch.ops.attention import (
    NEG_INF,
    _bwd_inputs,
    _bwd_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_bwd_route,
    flash_attention_plain,
    tf32_round,
)

# (B, H, T, n_past, S, alibi); the last has S > n_past + T, so key rows
# 64..191 are seen by no query and get zero gradient
CASES = [(1, 2, 64, 0, 64, False), (2, 4, 128, 0, 128, True),
         (1, 2, 64, 128, 192, False), (2, 2, 64, 128, 192, True),
         (1, 4, 64, 0, 192, False)]
D = 64


def _inputs(B, H, T, S, seed):  # noqa: N803
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    do = rng.standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v, do


@functools.lru_cache(maxsize=None)
def _jax_grads(B, H, T, n_past, S, alibi, dtype):  # noqa: N803
    """JAX dq, dk, dv [B, T/S, H, D] f32 for one case (both tests use them)."""
    q, k, v, do = _inputs(B, H, T, S, seed=T + S + alibi)
    jdt = jnp.dtype(dtype)
    slopes = j_alibi(H) if alibi else None

    def f(q, k, v):
        return j_flash_attention(q, k, v, n_past=n_past, slopes=slopes,
                                 interpret=True)

    out, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do, jdt))
    return [np.asarray(g, np.float32) for g in grads]


def _head_major(a, dt):  # [B, T, H, D] -> [B, H, T, D], the port's layout
    return torch.from_numpy(a).to(dt).transpose(1, 2).contiguous()


def _assert_close(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    else:
        step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got - ref).max() <= step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,n_past,S,alibi", CASES)
def test_bwd_plain_matches_pallas(dtype, B, H, T,  # noqa: N803
                                  n_past, S, alibi):
    q, k, v, do = _inputs(B, H, T, S, seed=T + S + alibi)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = _jax_grads(B, H, T, n_past, S, alibi, dtype)
    # the JAX forward's out and lse, so only the backward is compared
    js = j_alibi(H).reshape(H, 1) if alibi else jnp.zeros((H, 1))
    jout, jlse = _flash_bhtd(
        jnp.asarray([n_past], jnp.int32), js,
        *(jnp.swapaxes(jnp.asarray(a, jdt), 1, 2) for a in (q, k, v)),
        scale=D ** -0.5, causal=True, alibi=alibi, block_q=T, block_s=S,
        interpret=True)
    out = torch.from_numpy(np.array(jout, np.float32)).to(tdt)
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    args = [_head_major(a, tdt) for a in (q, k, v)]
    grads = flash_attention_bwd_plain(
        *args, out, lse, _head_major(do, tdt), n_past=n_past,
        scale=D ** -0.5, slopes=p_alibi(H) if alibi else None)
    for g, a, r in zip(grads, args, ref):
        assert g.dtype == a.dtype and g.shape == a.shape
        _assert_close(g.transpose(1, 2).float().numpy(), r, dtype)
    # flash_attention_bwd goes through the K7/K8 wrappers, which run the
    # plain version on CPU tensors
    again = flash_attention_bwd(*args, out, lse, _head_major(do, tdt),
                                n_past=n_past, scale=D ** -0.5,
                                slopes=p_alibi(H) if alibi else None)
    for g, h in zip(grads, again):
        assert torch.equal(g, h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,n_past,S,alibi", CASES)
def test_flash_attention_function_grads(dtype, B, H, T,  # noqa: N803
                                        n_past, S, alibi):
    q, k, v, do = _inputs(B, H, T, S, seed=T + S + alibi)
    tdt = getattr(torch, dtype)
    ref = _jax_grads(B, H, T, n_past, S, alibi, dtype)
    args = [_head_major(a, tdt).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*args, n_past=n_past, scale=D ** -0.5,
                          slopes=p_alibi(H) if alibi else None)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    # the incoming gradient arrives through a transpose, as in the model
    out.transpose(1, 2).backward(torch.from_numpy(do).to(tdt))
    for a, r in zip(args, ref):
        assert a.grad.dtype == tdt
        _assert_close(a.grad.transpose(1, 2).float().numpy(), r, dtype)
    if S > n_past + T:  # keys no query sees: exactly zero
        for a in args[1:]:
            assert not a.grad[:, :, n_past + T:].any()


def test_bwd_plain_fully_masked_rows_match_pallas():
    """Rows whose lse is NEG_INF (they saw no key) get p = 0, not
    exp(NEG_INF - NEG_INF) = 1: zero dq, and nothing from them in dk/dv,
    as in the Pallas backward kernels fed the same lse and dsum."""
    B, H, T, S = 1, 2, 64, 64  # noqa: N806
    q, k, v, do = _inputs(B, H, T, S, seed=5)
    rng = np.random.default_rng(6)
    lse = rng.standard_normal((B, H, T)).astype(np.float32) + 4.0
    lse[:, :, [0, 7, 40]] = NEG_INF
    out = rng.standard_normal((B, H, T, D)).astype(np.float32)
    args = [np.swapaxes(a, 1, 2) for a in (q, k, v, do)]
    dsum = (args[3] * out).sum(-1)
    ref = _flash_bwd_bhtd(
        jnp.asarray([0], jnp.int32), jnp.zeros((H, 1)),
        *(jnp.asarray(a) for a in args),
        jnp.broadcast_to(jnp.asarray(lse)[..., None], (B, H, T, 128)),
        jnp.broadcast_to(jnp.asarray(dsum)[..., None], (B, H, T, 128)),
        scale=D ** -0.5, causal=True, alibi=False, block_q=32, block_s=32,
        interpret=True)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    got = flash_attention_bwd_plain(t[0], t[1], t[2], torch.from_numpy(out),
                                    torch.from_numpy(lse), t[3],
                                    scale=D ** -0.5)
    assert not got[0][:, :, [0, 7, 40]].any()
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-4)


def test_cache_free_forward_runs_flash_attention_function():
    """Every layer's attention output in the cache-free forward carries a
    FlashAttention grad_fn, so the q/k/v branch gets its gradient."""
    cfg = ModelConfig(arch="gptneox", n_vocab=128, n_ctx=64, n_embd=64,
                      n_head=2, n_layer=3, n_ff=128, n_rot=16)
    params = init_params(cfg, seed=0, device="cpu")
    wq = params["layers"]["wq"].requires_grad_()
    logits, _ = forward(cfg, params, torch.arange(20)[None], None, 0)
    names, seen, todo = [], set(), [logits.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    assert names.count("FlashAttentionBackward") == cfg.n_layer
    logits.sum().backward()
    assert wq.grad is not None and wq.grad.abs().amax(dim=(1, 2)).min() > 0


# K7/K8's f32 gradient tolerance on the card (chip_smoke.py TOL_BWD_F32,
# tests/test_torch_cuda_kernels.py), relative to max|plain|
TOL_BWD_F32 = 1e-4


def test_tf32_split_reproduces_x():
    """big = tf32_round(x) and small = tf32_round(x - big) are TF32 (13 low
    mantissa bits zero) and big + small is x to 2^-21 relative; ties round
    away from zero, as cvt.rna."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(100_000), rng.standard_normal(1000) * 1e-30,
        rng.standard_normal(1000) * 1e30]).astype(np.float32))
    big = tf32_round(x)
    small = tf32_round(x - big)
    for h in (big, small):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    err = ((big.double() + small.double()) - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11])
    assert tf32_round(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                         1 + 2 ** -9]


def _tf32_einsum(eq, a, b, terms):
    """einsum(eq, a, b) as the kernel's TF32 products, each summed in f64:
    big·big alone (terms=1), or small·big + big·small + big·big (3)."""
    ab, bb = tf32_round(a), tf32_round(b)
    out = torch.einsum(eq, ab.double(), bb.double())
    if terms == 3:
        a_s, b_s = tf32_round(a - ab), tf32_round(b - bb)
        out = (torch.einsum(eq, a_s.double(), bb.double())
               + torch.einsum(eq, ab.double(), b_s.double()) + out)
    return out.float()


def _bwd_tf32(q, k, v, do, lse, dsum, *, scale, terms):
    """``_bwd_plain`` (n_past 0, no ALiBi) with its five products emulated
    by ``_tf32_einsum``; the elementwise steps as the plain version's."""
    T, S = q.shape[2], k.shape[2]  # noqa: N806
    s = _tf32_einsum("bhtd,bhsd->bhts", q, k, terms) * scale
    live = (torch.arange(S)[None, :] <= torch.arange(T)[:, None]) \
        & (lse[..., None] != NEG_INF)
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    dp = _tf32_einsum("bhtd,bhsd->bhts", do, v, terms)
    ds = p * (dp - dsum[..., None]) * scale
    return (_tf32_einsum("bhts,bhsd->bhtd", ds, k, terms),
            _tf32_einsum("bhts,bhtd->bhsd", ds, q, terms),
            _tf32_einsum("bhts,bhtd->bhsd", p, do, terms))


@functools.lru_cache(maxsize=None)
def _split_case(B, H, T, D_):  # noqa: N803
    """(rel err of the 3-term emulation, of the 1-term one), each a list
    over dq, dk, dv, relative to max|_bwd_plain| on numpy inputs."""
    rng = np.random.default_rng(D_ + T)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, H, T, D_)).astype(np.float32)) for _ in range(4))
    scale = D_ ** -0.5
    out, lse = flash_attention_plain(q, k, v, scale=scale)
    do, dsum = _bwd_inputs(out, do, q.dtype)
    ref = _bwd_plain(q, k, v, do, lse, dsum, n_past=0, scale=scale,
                     slopes=None)
    rels = []
    for terms in (3, 1):
        got = _bwd_tf32(q, k, v, do, lse, dsum, scale=scale, terms=terms)
        rels.append([((a - r).abs().max() / r.abs().max()).item()
                     for a, r in zip(got, ref)])
    return rels


@pytest.mark.parametrize("D_", [64, 128])
def test_bwd_3xtf32_emulation_within_1e5(D_):
    """The kernel's split: three TF32 products per f32 product keep dq, dk
    and dv within 1e-5 of max|plain| at (B, H, T) = (2, 3, 100)."""
    three, _ = _split_case(2, 3, 100, D_)
    assert max(three) <= 1e-5, three


@pytest.mark.parametrize("D_", [64, 128])
def test_bwd_1xtf32_emulation_misses_tolerance(D_):
    """One TF32 product per f32 product misses the card's f32 tolerance on
    at least one of dq, dk, dv at the same shapes, so the card check
    refuses a kernel that drops the small terms."""
    _, one = _split_case(2, 3, 100, D_)
    assert max(one) > TOL_BWD_F32, one


@pytest.mark.parametrize("dtype,D_,route", [
    (torch.float32, 64, "mma_3xtf32"), (torch.float32, 128, "mma_3xtf32"),
    (torch.float32, 80, "fma"), (torch.float32, 256, "fma"),
    (torch.float32, 32, "fma"), (torch.bfloat16, 64, "fma"),
    (torch.bfloat16, 128, "fma"), (torch.bfloat16, 256, "fma")])
def test_flash_attention_bwd_route(dtype, D_, route):
    assert flash_attention_bwd_route(dtype, D_) == route
