"""The sums K2's f32-plane instance (csrc/q4_matmul_ps.cu:ps_tf32_kernel)
computes on the tensor cores, emulated on the CPU and held against the JAX
package.

At 9-128 rows with f32 planes every weight (v - 8) * s is exact in TF32
(v - 8 has at most 3 significant bits, a bf16 scale 8), so one TF32
``mma.sync`` product of bf16 x, or two of f32 x split into big + small TF32
halves (small first), reproduce the f32 products; each m16n8k8 step sums 8
of them into a fresh f32 fragment a 64-value group (32 lo-plane K-values,
then 32 hi), which is added to the split's accumulator, a block walks its
split's groups in order, and split partials meet in
``ps_split_reduce_kernel``'s order.  ``emulate_tf32`` does the same in f32
(only the order inside a step's 8 products differs from the MMA's) and is
held within TOL_Q4 = 1e-4 of max|ref| (chip_smoke.py's tolerance for the Q4
kernels) against ``pallas_q4_matmul_ps``'s f32-plane contract run in
interpret mode (f32 x; bf16 x under the f32xf math).  The plan
(``q4_matmul_ps_splits``) is held to one wave at every Q4 weight shape of
GPT-J-6B and Pythia-12B.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.ops import pallas_q4 as jpq
from vsim_tpu.ops.pallas_q4 import pallas_q4_matmul_ps
from vsim_tpu.quant import q4 as jq4
from vsim_tpu_torch.ops.q4_cuda import _ps_planes, q4_matmul_ps_splits

TOL_Q4 = 1e-4
QK = 32
SM = 132  # the H100's SMs


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero, on the bits
    (csrc/common.cuh:tf32_rna: add half a 10-bit ulp, clear 13 bits)."""
    u = x.to(torch.float32).contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((u + np.uint32(0x1000))
                             & np.uint32(0xFFFFE000)).view(np.float32))


def split_tf32(x: torch.Tensor):
    """f32 x as big + small TF32 values (common.cuh:split_tf32)."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def reduce_lanes(splits: int) -> int:
    return 8 if splits >= 8 else 4 if splits >= 4 else 2 if splits >= 2 else 1


def emulate_tf32(x, packed, scales, bias, splits):
    """The instance's sums: per split, its groups in order, each group's 8
    steps (4 of the lo plane, 4 of the hi), each step's 8 products summed and
    added to a fresh f32 fragment (f32 x: the small half's step first, then
    the big's), which is added to the split's accumulator; then the reduce
    pass (lane j sums splits j, j + P, ... from 0, the bias plus the lanes
    in order) or, unsplit, the bias added."""
    n, K = x.shape  # noqa: N806
    half, G = K // 2, K // 64  # noqa: N806
    lo, hi = _ps_planes(packed, scales)  # [K/2, O] f32, exact
    O = lo.shape[1]  # noqa: N806
    w = torch.cat([lo.reshape(G, 4, 8, O), hi.reshape(G, 4, 8, O)], dim=1)
    pieces = ([x.to(torch.float32)] if x.dtype == torch.bfloat16
              else list(reversed(split_tf32(x))))  # small, then big
    steps = []  # per piece: [G, 8, n, O], a step's 8 products summed
    for p in pieces:
        xc = torch.cat([p[:, :half].reshape(n, G, 4, 8),
                        p[:, half:].reshape(n, G, 4, 8)], dim=2)
        steps.append(torch.einsum("ngck,gcko->gcno", xc, w))
    partial = []
    for s in range(splits):
        acc = torch.zeros((n, O), dtype=torch.float32)
        for g in range(G * s // splits, G * (s + 1) // splits):
            part = torch.zeros((n, O), dtype=torch.float32)
            for c in range(8):
                for st in steps:
                    part = part + st[g, c]
            acc = acc + part
        partial.append(acc)
    b = torch.zeros(O) if bias is None else bias
    if splits == 1:
        return partial[0] + b if bias is not None else partial[0]
    lanes = reduce_lanes(splits)
    out = b.expand(n, O)
    for j in range(lanes):
        lane = torch.zeros((n, O), dtype=torch.float32)
        for k in range(j, splits, lanes):
            lane = lane + partial[k]
        out = out + lane
    return out


def _weight(K, O, seed):  # noqa: N803
    """The same plane-split weight in both packages: random bytes, bf16
    scales."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (K // 2, O), dtype=np.uint8)
    scales = torch.from_numpy(
        (rng.random((K // QK, O)) * 0.02).astype(np.float32)).to(
            torch.bfloat16)
    jw = jq4.Q4Tensor(jnp.asarray(packed),
                      jnp.asarray(scales.to(torch.float32).numpy())
                      .astype(jnp.bfloat16), layout="ps")
    return jw, torch.from_numpy(packed), scales


def _bf16_values():
    """Every finite bf16 value, as f32."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[((bits >> 7) & 0xFF) != 0xFF]
    return torch.from_numpy((bits << 16).view(np.float32))


def test_every_weight_exact_in_tf32():
    """Every nibble times every finite bf16 scale, (v - 8) * s in f32 as the
    kernel's dequant computes it: the exact product where finite (f64
    agrees) and a TF32 value, which RNA rounding leaves as it is."""
    s = _bf16_values()
    v = torch.arange(16, dtype=torch.float32) - 8.0
    w = (v[:, None] * s[None, :]).reshape(-1)
    assert torch.equal(tf32_rna(w), w)
    exact = v.double()[:, None] * s.double()[None, :]
    finite = torch.isfinite(w)
    assert torch.equal(w.double()[finite], exact.reshape(-1)[finite])
    # overflow only where the exact product lies past f32's range
    assert (exact.reshape(-1)[~finite].abs()
            > torch.finfo(torch.float32).max).all()


def test_split_tf32_of_f32_x():
    """f32 x with |x| from 2^-20 to 2^20: big and small are TF32 values,
    |small| <= 2^-11 |x| and x - big - small <= 2^-22 |x| (sums in f64)."""
    rng = np.random.default_rng(0)
    sign = rng.integers(0, 2, 200_000, dtype=np.uint32) << 31
    exp = rng.integers(127 - 20, 127 + 21, 200_000, dtype=np.uint32) << 23
    mant = rng.integers(0, 1 << 23, 200_000, dtype=np.uint32)
    x = torch.from_numpy((sign | exp | mant).view(np.float32))
    big, small = split_tf32(x)
    assert torch.equal(tf32_rna(big), big)
    assert torch.equal(tf32_rna(small), small)
    xd = x.double()
    assert (small.double().abs() <= 2.0 ** -11 * xd.abs()).all()
    residual = xd - big.double() - small.double()
    assert (residual.abs() <= 2.0 ** -22 * xd.abs()).all()
    # the big half alone leaves up to 2^-11 of |x|: f32 x needs the second
    rel_big = (xd - big.double()).abs() / xd.abs()
    assert (rel_big <= 2.0 ** -11).all() and rel_big.max() > 2.0 ** -12


# K = 1344: 21 groups, which the planned splits at 16 tiles (8 or 16 of
# them) do not divide; O = 2048: 16 128-column tiles
@pytest.mark.parametrize("n", [9, 16, 33, 100, 128])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tf32_sums_match_pallas_f32_planes(n, with_bias, dtype):
    """The emulated sums, under the plan's split and unsplit, against the
    Pallas f32-plane kernel (_kernel_ps / _kernel_ps_bias, f32xf)."""
    K, O = 1344, 2048  # noqa: N806
    jw, packed, scales = _weight(K, O, n)
    rng = np.random.default_rng(100 + n)
    x = rng.standard_normal((n, K)).astype(np.float32)
    b = (rng.standard_normal(O).astype(np.float32) * 10 if with_bias
         else None)
    jpq.set_dequant_math("f32xf")  # bf16 x against f32 planes
    try:
        ref = np.asarray(pallas_q4_matmul_ps(
            jnp.asarray(x, dtype), jw, interpret=True,
            bias=None if b is None else jnp.asarray(b)))
    finally:
        jpq.set_dequant_math("gi")
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    bt = None if b is None else torch.from_numpy(b)
    planned = q4_matmul_ps_splits(n, K, O, SM)
    assert 1 < planned < K // 64
    for splits in (planned, 1):
        got = emulate_tf32(xt, packed, scales, bt, splits).numpy()
        err = np.abs(got - ref).max()
        assert np.isfinite(got).all() and err <= TOL_Q4 * np.abs(ref).max()


@pytest.mark.parametrize("K,O", [  # noqa: N803
    (4096, 12288), (4096, 4096), (4096, 16384), (16384, 4096), (4096, 51200),
    (5120, 15360), (5120, 5120), (5120, 20480), (20480, 5120), (5120, 51200)])
@pytest.mark.parametrize("n", [9, 16, 20, 32, 33, 64, 100, 128])
def test_tf32_plan_one_wave(K, O, n):  # noqa: N803
    """At every Q4 weight shape of GPT-J-6B and Pythia-12B: the 128-column
    tiles times the splits fit the blocks the instance holds at once (two
    an SM up to 32 rows, one past), and one more split would not, unless
    every group is its own split already."""
    splits = q4_matmul_ps_splits(n, K, O, SM)
    tiles, per_sm = -(-O // 128), 2 if n <= 32 else 1
    assert 1 <= splits <= K // 64
    assert tiles * splits <= per_sm * SM or splits == 1
    assert tiles * (splits + 1) > per_sm * SM or splits == K // 64
