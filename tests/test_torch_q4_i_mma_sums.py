"""The sums K9 and K10 (csrc/q4_matmul_i.cu) compute on the tensor cores,
emulated on the CPU and held against the JAX package.

The kernel runs K1's core in the interleaved ("i") layout, where packed
byte c of a column holds elements 2c and 2c + 1 under scale row c / 16, so
a Q4 group is 16 packed rows (32 values of K).  Two contracts:

  * f32 planes (K9 always; K10 under the f32xf and gi maths): every product
    (v - 8) * x is exact (bf16 x, or f32 x as three bf16 pieces x = b1 + b2
    + b3, the smallest first), a fresh f32 sum covers each group, and the
    group's scale multiplies that sum afterwards;
  * bf16 planes (K10 under i32 and f32x): each plane round_bf16((v - 8) s)
    (a correctly rounded bf16 product, the kernel's mul.rn.bf16x2), x
    rounded to bf16, and one f32 sum over all of K.

``emulate_i`` does the same in f32 (only the order inside a group's sum,
or of the one sum, differs from the MMA's) and is held within TOL_Q4 = 1e-4
of max|ref| (chip_smoke.py's tolerance for the Q4 kernels) against
``pallas_q4_matmul_stacked`` and ``pallas_q4_matmul``, run in interpret
mode, under each of the four dequant maths, on seeded inputs that include
the worst cases: every nibble 0 or 15, and |x| spread over 2^-20 .. 2^20;
K = 32 * 9 (an odd number of groups: the kernel's last unit of two groups
holds one), n from 1 to 128, the first and the last layer of a stack.
The rounding is checked exhaustively, and ``i_plan`` is held to one wave
of clusters with the most blocks at every Q4 weight shape of GPT-J-6B and
Pythia-12B.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.ops import pallas_q4 as jpq
from vsim_tpu.quant import q4 as jq4
from vsim_tpu_torch.ops.matmul import stacked_round_planes
from vsim_tpu_torch.ops.q4_cuda import (CORE_MAX_CLUSTER, CORE_WARPS,
                                        I_TILES, i_plan, i_tile_o,
                                        q4_matmul_i, q4_matmul_stacked)

from test_torch_q4_mma_sums import split3

TOL_Q4 = 1e-4
QK = 32
K, O, L = 32 * 9, 256, 3  # noqa: N816
MATHS = ["i32", "f32x", "f32xf", "gi"]
# (every byte, |x| spread over 2^-20 .. 2^20, x dtype)
CASES = [(None, False, "bfloat16"), (None, True, "float32"),
         (0x00, True, "bfloat16"), (0xFF, True, "float32")]


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def emulate_i(x, packed, scales, round_planes, bias=None):
    """The kernel's sums for x [n, K] and one "i" weight [K/2, O]."""
    n, k = x.shape
    g = k // QK
    v = (torch.stack([packed & 0x0F, packed >> 4], dim=1).reshape(k, -1)
         .to(torch.float32) - 8.0)  # [K, O]: element 2c, 2c + 1 of row c
    s = scales.to(torch.float32)  # [G, O]
    if round_planes:
        w = _bf16(v * s.repeat_interleave(QK, dim=0))
        y = torch.matmul(_bf16(x), w)
    else:
        pieces = ([x.to(torch.float32)] if x.dtype == torch.bfloat16
                  else split3(x))
        vg = v.reshape(g, QK, -1)  # [G, 32, O]
        frag = None
        for b in reversed(pieces):  # the smallest piece first
            part = torch.bmm(b.reshape(n, g, QK).transpose(0, 1).contiguous(),
                             vg)  # [G, n, O]
            frag = part if frag is None else frag + part
        y = (s[:, None, :] * frag).sum(0)
    return y if bias is None else y + bias


def _stack(seed, fill):
    """One stacked "i" weight [L, K/2, O] in both packages."""
    rng = np.random.default_rng(seed)
    packed = (np.full((L, K // 2, O), fill, np.uint8) if fill is not None
              else rng.integers(0, 256, (L, K // 2, O), dtype=np.uint8))
    scales = torch.from_numpy(
        (rng.random((L, K // QK, O)) * 0.02).astype(np.float32)).to(
            torch.bfloat16)
    jw = jq4.Q4Tensor(jnp.asarray(packed),
                      jnp.asarray(scales.to(torch.float32).numpy())
                      .astype(jnp.bfloat16), layout="i")
    return jw, torch.from_numpy(packed), scales


def _x(n, seed, spread):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, K)).astype(np.float32)
    if spread:  # |x| from 2^-20 to 2^20
        x = (np.sign(x) * (1 + rng.random((n, K)))
             * np.exp2(rng.integers(-20, 20, (n, K)))).astype(np.float32)
    return x


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert np.isfinite(got.numpy()).all()
    assert err <= TOL_Q4 * np.abs(ref).max(), (err, np.abs(ref).max())


def _with_math(name, fn):
    jpq.set_dequant_math(name)
    try:
        return fn()
    finally:
        jpq.set_dequant_math("gi")


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("n", [1, 3, 8, 9, 100, 128])
@pytest.mark.parametrize("math_name", MATHS)
def test_k10_sums_match_pallas(math_name, n, case):
    """K10 on layers 0 and L - 1, its contract from the math, against
    ``pallas_q4_matmul_stacked`` (acc_dtype bf16)."""
    fill, spread, dtype = CASES[case]
    jw, packed, scales = _stack(20 + case, fill)
    x = _x(n, 30 + n + case, spread)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    rnd = stacked_round_planes(math_name)
    for il in (0, L - 1):
        ref = _with_math(math_name, lambda: jpq.pallas_q4_matmul_stacked(
            jnp.asarray(x, dtype), jw, jnp.int32(il), interpret=True))
        _close(emulate_i(xt, packed[il], scales[il], rnd), ref)


@pytest.mark.parametrize("case", [0, 3])
@pytest.mark.parametrize("n", [1, 9, 128])
@pytest.mark.parametrize("math_name", MATHS)
def test_k9_sums_match_pallas(math_name, n, case):
    """K9: f32 planes under every math (``q4_matmul`` calls
    ``pallas_q4_matmul`` with acc_dtype f32), the bias added after the
    sums, against ``pallas_q4_matmul``."""
    fill, spread, dtype = CASES[case]
    jw, packed, scales = _stack(40 + case, fill)
    jw = jq4.Q4Tensor(jw.packed[1], jw.scales[1], layout="i")
    x = _x(n, 50 + n, spread)
    b = np.random.default_rng(5).standard_normal(O).astype(np.float32)
    ref = _with_math(math_name, lambda: np.asarray(jpq.pallas_q4_matmul(
        jnp.asarray(x, dtype), jw, interpret=True)) + b)
    got = emulate_i(torch.from_numpy(x).to(getattr(torch, dtype)),
                    packed[1], scales[1], False, torch.from_numpy(b))
    _close(got, ref)


@pytest.mark.parametrize("round_planes", [False, True])
def test_plain_versions_match_the_emulation(round_planes):
    """The wrappers on CPU tensors (their plain versions) against the
    emulated kernel sums, K = 32 * odd, both contracts, f32 x."""
    _, packed, scales = _stack(60, None)
    xt = torch.from_numpy(_x(5, 61, True))
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(O)
                         .astype(np.float32))
    il = torch.tensor(L - 1, dtype=torch.int32)
    ref = emulate_i(xt, packed[L - 1], scales[L - 1], round_planes, b)
    _close(q4_matmul_stacked(xt, packed, scales, il, b, round_planes), ref)
    if not round_planes:
        _close(q4_matmul_i(xt, packed[L - 1], scales[L - 1], b), ref)


def _bf16_rne(p):
    """f64 values rounded to bf16 to nearest even, as f64: 8 significant
    bits, subnormal steps of 2^-133 below 2^-126, inf past the largest
    finite bf16.  Exact for these products (each fits an f64)."""
    _, e = np.frexp(p)
    step = np.exp2(np.maximum(e.astype(np.float64) - 8, -133))
    r = np.round(p / step) * step  # np.round: half to even
    return np.where(np.abs(r) >= 2.0 ** 128, np.copysign(np.inf, p), r)


def test_bf16_plane_rounding_exhaustive():
    """For every finite bf16 s and every nibble v: the correctly rounded
    bf16 product of (v - 8) and s (what mul.rn.bf16x2 gives) equals
    round_bf16(f32((v - 8) s)), the plain version's plane, bit for bit:
    the f32 product is exact, so its one rounding is the same."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[(bits & 0x7F80) != 0x7F80]  # finite bf16 only
    s32 = (bits << 16).view(np.float32)
    v = np.arange(16, dtype=np.float32) - 8.0
    with np.errstate(over="ignore"):  # |s| near bf16's largest: inf
        p32 = v[:, None] * s32[None, :]  # f32 products
    plane = torch.from_numpy(p32).to(torch.bfloat16).view(torch.int16)
    exact = _bf16_rne(v[:, None].astype(np.float64)
                      * s32[None, :].astype(np.float64))
    want = torch.from_numpy(exact.astype(np.float32)).to(
        torch.bfloat16).view(torch.int16)  # exact in bf16: no rounding
    assert torch.equal(plane, want)
    assert p32.size == 16 * 65280


SHAPES = [(4096, 12288), (4096, 4096), (4096, 16384), (16384, 4096),
          (4096, 51200), (5120, 15360), (5120, 5120), (5120, 20480),
          (20480, 5120), (5120, 51200)]


# n <= 8 at every shape; prefill rows at the stacked ones (the lm head
# takes the last position only)
PLAN_CASES = ([(n, k, o) for n in (1, 8) for k, o in SHAPES]
              + [(n, k, o) for n in (100, 128) for k, o in SHAPES
                 if o != 51200])


@pytest.mark.parametrize("n,K,O", PLAN_CASES)  # noqa: N803
@pytest.mark.parametrize("blocks_per_sm", [2, 3])
def test_i_plan_one_wave(n, K, O, blocks_per_sm):  # noqa: N803
    """At every Q4 weight shape of GPT-J-6B and Pythia-12B, on an H100's
    132 SMs holding 2 or 3 blocks each: the fewest n-tiles that hold n,
    every cluster resident at once (one wave), at least 1.5 blocks an SM
    (or the most blocks one wave holds, when that is fewer), the busiest
    warp's units of 64 values of K times the blocks within 10% of the
    ideal, and at most 8 blocks a cluster: the partial sums meet in shared
    memory and never reach HBM.  Past 8 rows each warp takes its own
    columns (wc = 4)."""
    sm = 132

    def max_clusters(nt, c):
        return blocks_per_sm * sm // c

    nt, wc, c = i_plan(n, K, O, sm, max_clusters)
    assert nt == min(t for t in I_TILES if 8 * t >= n)
    assert nt == 1 or wc == CORE_WARPS
    tiles, units = -(-O // i_tile_o(nt)), -(-K // 64)
    clusters, splits = -(-tiles // wc), CORE_WARPS // wc * c
    assert 1 <= c <= CORE_MAX_CLUSTER and clusters <= max_clusters(nt, c)
    most = max(clusters * d for d in range(1, CORE_MAX_CLUSTER + 1)
               if clusters <= max_clusters(nt, d))
    assert 2 * clusters * c >= min(3 * sm, 2 * most)
    work = -(-units // splits) * clusters * c * CORE_WARPS
    assert tiles * units <= work <= 1.1 * tiles * units
