"""K4's f32 instance ("mma_3xtf32") emulated on the CPU.

On the card K4 takes each f32 product of its two products -- s = q·kᵀ and
o = p·v, p unrounded -- as three TF32 tensor-core products of operands split
into big + small halves: small·big + big·small + big·big, the dropped
small·small below 2^-20 of |a| |b|.  Its split (``csrc/common.cuh:
split_tf32_trunc``) is cheaper than K7/K8's: big is x cut to TF32 by a mask,
small = x − big is passed whole, and the tensor cores read its top 19 bits,
cutting it to TF32 too; ``tf32_trunc`` below is that cut (rounding small
instead would only come closer).  Here both products are emulated that
way, each summed in f64 (the kernel's own sums are f32, and their order is
the card's business: chip_smoke.py and tests/test_torch_cuda_kernels.py
hold it to 1e-4 of max|plain|), and the elementwise steps are the plain
version's.  The three-term forward stays within 1e-5 of
max|``flash_attention_plain``| in out and lse, with n_past > 0 and ALiBi;
one TF32 product a product lands at least 10x farther away; a head dim
zero-padded to the next instance's (72 to 80) changes no product.
``flash_attention_plain`` itself is held to the JAX kernel in interpret mode
by tests/test_torch_attention.py.
"""

import functools

import numpy as np
import pytest
import torch

from vsim_tpu_torch.models.transformer import alibi_slopes
from vsim_tpu_torch.ops.attention import (
    NEG_INF,
    flash_attention_fwd_route,
    flash_attention_plain,
)

TOL_3X = 1e-5  # the three-term emulation, relative to max|plain|


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` cut to TF32 (its 13 low mantissa bits cleared)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_einsum(eq, a, b, terms):
    """einsum(eq, a, b) as the kernel's TF32 products, summed in f64:
    big·big alone (terms=1), or small·big + big·small + big·big (3), big =
    tf32_trunc(x) and small = tf32_trunc(x − big)."""
    ab, bb = tf32_trunc(a), tf32_trunc(b)
    out = torch.einsum(eq, ab.double(), bb.double())
    if terms == 3:
        a_s, b_s = tf32_trunc(a - ab), tf32_trunc(b - bb)
        out = (torch.einsum(eq, a_s.double(), bb.double())
               + torch.einsum(eq, ab.double(), b_s.double()) + out)
    return out.float()


def _fwd_tf32(q, k, v, *, n_past, scale, slopes, terms):
    """``flash_attention_plain`` with its two products emulated by
    ``_tf32_einsum``: (out, lse)."""
    T, S = q.shape[2], k.shape[2]  # noqa: N806
    s = _tf32_einsum("bhtd,bhsd->bhts", q, k, terms) * scale
    s_idx = torch.arange(S)
    if slopes is not None:
        s = s + slopes[None, :, None, None] * s_idx.to(torch.float32)
    mask = s_idx[None, :] <= (n_past + torch.arange(T))[:, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    pv = _tf32_einsum("bhts,bhsd->bhtd", p, v, terms)
    live = l > 0
    out = torch.where(live, pv / torch.where(live, l, 1.0), 0.0)
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)),
                      NEG_INF)
    return out, lse[..., 0]


def _inputs(B, H, T, S, D, seed):  # noqa: N803
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, n, D))
                             .astype(np.float32)) for n in (T, S, S)]


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@functools.lru_cache(maxsize=None)
def _split_case(D, n_past, alibi):  # noqa: N803
    """(rel errs of the 3-term emulation, of the 1-term one), each [out,
    lse] relative to max|plain|, at B=2, H=2, T=96, S = n_past + T + 5 (key
    rows no query sees)."""
    B, H, T = 2, 2, 96  # noqa: N806
    S = n_past + T + 5  # noqa: N806
    q, k, v = _inputs(B, H, T, S, D, seed=D + n_past + alibi)
    kw = dict(n_past=n_past, scale=D ** -0.5,
              slopes=alibi_slopes(H) if alibi else None)
    ref = flash_attention_plain(q, k, v, **kw)
    return [[_rel(a, r) for a, r in zip(_fwd_tf32(q, k, v, terms=terms,
                                                  **kw), ref)]
            for terms in (3, 1)]


CASES = [(64, 0, False), (64, 37, True), (80, 37, True), (256, 0, False),
         (256, 37, True)]


def test_tf32_trunc_split_reproduces_x():
    """big = tf32_trunc(x) and small = x − big: big is TF32, small exact,
    and big + tf32_trunc(small) is x to 2^-20 relative."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(100_000), rng.standard_normal(1000) * 1e-30,
        rng.standard_normal(1000) * 1e30]).astype(np.float32))
    big = tf32_trunc(x)
    small = x - big
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(big + small, x)
    err = ((big.double() + tf32_trunc(small).double()) - x.double()).abs()
    assert (err <= 2.0 ** -20 * x.double().abs()).all()


@pytest.mark.parametrize("D,n_past,alibi", CASES)
def test_fwd_3xtf32_emulation_within_1e5(D, n_past, alibi):  # noqa: N803
    """Three TF32 products per f32 product keep out and lse within 1e-5 of
    max|plain|."""
    three, _ = _split_case(D, n_past, alibi)
    assert max(three) <= TOL_3X, three


@pytest.mark.parametrize("D,n_past,alibi", CASES)
def test_fwd_1xtf32_emulation_10x_farther(D, n_past, alibi):  # noqa: N803
    """One TF32 product per f32 product lands at least 10x farther from the
    plain version than three do, so the small terms are what keeps K4 at
    f32."""
    three, one = _split_case(D, n_past, alibi)
    assert max(one) >= 10 * max(three), (one, three)


def test_fwd_3xtf32_padded_head_dim_changes_no_product():
    """The instance zeros the head dim's columns [D, DPAD) in shared memory:
    at D = 72 padded to 80, the 3-term emulation on zero-padded q, k, v
    gives zero output columns past 72 and, in the first 72, the unpadded
    emulation's out and lse (both summed in f64)."""
    B, H, T, D, DPAD, n_past = 2, 2, 96, 72, 80, 21  # noqa: N806
    q, k, v = _inputs(B, H, T, n_past + T, D, seed=72)
    kw = dict(n_past=n_past, scale=D ** -0.5, slopes=alibi_slopes(H))
    out, lse = _fwd_tf32(q, k, v, terms=3, **kw)

    def pad(x):
        return torch.nn.functional.pad(x, (0, DPAD - D))

    pout, plse = _fwd_tf32(pad(q), pad(k), pad(v), terms=3, **kw)
    assert pout.shape[-1] == DPAD and not pout[..., D:].any()
    np.testing.assert_allclose(pout[..., :D].numpy(), out.numpy(), rtol=1e-6,
                               atol=1e-12)
    assert torch.equal(plse, lse)
    ref, lse_ref = flash_attention_plain(q, k, v, **kw)
    assert _rel(pout[..., :D], ref) <= TOL_3X
    assert _rel(plse, lse_ref) <= TOL_3X


def test_fwd_3xtf32_rows_without_keys():
    """A row that sees no key (n_past = -3: the first three) gets out 0 and
    lse -FLT_MAX in the emulation, as in the plain version."""
    q, k, v = _inputs(1, 2, 16, 16, 64, seed=3)
    kw = dict(n_past=-3, scale=0.125, slopes=None)
    out, lse = _fwd_tf32(q, k, v, terms=3, **kw)
    ref, lse_ref = flash_attention_plain(q, k, v, **kw)
    assert not out[:, :, :3].any() and (lse[:, :, :3] == NEG_INF).all()
    assert (lse_ref[:, :, :3] == NEG_INF).all()
    assert _rel(out, ref) <= TOL_3X
    assert _rel(lse[:, :, 3:], lse_ref[:, :, 3:]) <= TOL_3X


@pytest.mark.parametrize("dtype,D,route", [
    (torch.float32, 64, "mma_3xtf32"), (torch.float32, 72, "mma_3xtf32"),
    (torch.float32, 80, "mma_3xtf32"), (torch.float32, 96, "mma_3xtf32"),
    (torch.float32, 128, "mma_3xtf32"), (torch.float32, 256, "mma_3xtf32"),
    (torch.float32, 1, "mma_3xtf32"), (torch.bfloat16, 64, "mma_bf16"),
    (torch.bfloat16, 72, "mma_bf16"), (torch.bfloat16, 256, "mma_bf16")])
def test_flash_attention_fwd_route(dtype, D, route):  # noqa: N803
    assert flash_attention_fwd_route(dtype, D) == route


@pytest.mark.parametrize("D", [0, 257])
def test_flash_attention_fwd_route_refuses_head_dims(D):  # noqa: N803
    with pytest.raises(ValueError):
        flash_attention_fwd_route(torch.float32, D)
