"""K15's order of sums (csrc/q4_batch_lab.cu) emulated in PyTorch on the
CPU, against tools/batch_lab.py's run_2d and run_band in interpret mode.

The kernel's products are exact (bf16 x times a bf16 plane, each plane
``batch_planes``' value under the math), each 64-value group (32 rows of
each plane) is summed into an f32 accumulator, and the splits meet in a
fixed order:

  2d    rank r of a cluster of C takes groups r, r + C, ...; rank 0 starts
        from corr (bnos); the ranks' partials are summed in rank order;
  band  band b of B takes a run of groups; the partials are summed in band
        order after corr (bnos) or 0.

Checked, each at splits 1, 3 and 8:
  * all three maths at n = 9, 16, 64 and 128 (K = 512, O = 256) against
    the tool's ``make_fn`` (run_2d at block_kh 64, run_band at 256; bnos
    with the tool's own corr), compiled with XLA's excess precision off, at
    ``TOL_BATCH``;
  * every math's plane for every finite bf16 scale and every nibble equals
    the product rounded once to bf16 (bnos v·s, f32x and bsub (v − 8)·s):
    what mul.rn.bf16x2 and cvt.rn.bf16x2 make in the kernel;
  * the 2d and band plans at GPT-J-6B's and Pythia-12B's shapes fit in one
    wave, and ``check_batch_plan`` refuses an over-full plan.
"""

import functools
import importlib
import types

import numpy as np
import pytest
import torch

from vsim_tpu_torch.ops import q4_batch_lab as bl

K, O = 512, 256
NS = (9, 16, 64, 128)
SPLITS = (1, 3, 8)
NO_EXCESS = {"xla_allow_excess_precision": False}
BLOCK_KH = {"2d": 64, "band": 256}
SM = 132


def _bf16_np(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _case(n, seed=0):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (K // 2, O), dtype=np.uint8)
    scales = _bf16_np(rng.standard_normal((K // 32, O)) * 0.3)
    x = _bf16_np(rng.standard_normal((n, K)))
    return packed, scales, x


@pytest.fixture(scope="module")
def jx():
    """tools.batch_lab with ``pl.pallas_call`` in interpret mode, and a
    cache of its outputs by (geometry, math, n)."""
    names = ("jax", "jax.numpy", "jax.experimental.pallas", "tools.batch_lab")
    m = types.SimpleNamespace(**{n.split(".")[-1]: importlib.import_module(n)
                                 for n in names})
    shim = types.SimpleNamespace(**{k: getattr(m.pallas, k)
                                    for k in dir(m.pallas)
                                    if not k.startswith("__")})
    shim.pallas_call = functools.partial(m.pallas.pallas_call, interpret=True)
    saved = m.batch_lab.pl
    m.batch_lab.pl = shim
    m.cache = {}
    yield m
    m.batch_lab.pl = saved


def _jax(jx, geometry, math_, n):
    key = (geometry, math_, n)
    if key not in jx.cache:
        jnp = jx.numpy
        packed, scales, x = _case(n)
        w = types.SimpleNamespace(packed=jnp.asarray(packed),
                                  scales=jnp.asarray(scales, jnp.bfloat16))
        fn = jx.batch_lab.make_fn(f"{geometry}/{math_}", w, n, K, O,
                                  BLOCK_KH[geometry], 2048, 64)
        arg = jnp.asarray(x, jnp.bfloat16)
        jx.cache[key] = np.array(jx.jax.jit(fn).lower(arg).compile(
            compiler_options=NO_EXCESS)(arg), np.float32)
    return jx.cache[key]


def emulate(x, packed, scales, math_, geometry, splits):
    """K15's sums: a group's exact products summed once into f32, added to
    its split's f32 accumulator; the splits' partials in order."""
    n, k = x.shape
    groups = k // 64
    w = bl.batch_planes(packed, scales, math_).double()
    xd = x.double()

    def group(g):
        rows = torch.cat([torch.arange(g * 32, g * 32 + 32),
                          k // 2 + torch.arange(g * 32, g * 32 + 32)])
        return (xd[:, rows] @ w[rows]).float()

    corr = bl.batch_corr(x, scales) if math_ == "bnos" else None
    zero = torch.zeros((n, packed.shape[1]))
    if geometry == "2d":
        parts = []
        for r in range(splits):
            acc = corr.clone() if corr is not None and r == 0 else zero.clone()
            for g in range(r, groups, splits):
                acc = acc + group(g)
            parts.append(acc)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out
    out = corr.clone() if corr is not None else zero.clone()
    for b in range(splits):
        acc = zero.clone()
        for g in range(groups * b // splits, groups * (b + 1) // splits):
            acc = acc + group(g)
        out = out + acc
    return out


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("math_", bl.BATCH_MATHS)
@pytest.mark.parametrize("geometry", bl.GEOMETRIES)
def test_sums_match_jax(jx, geometry, math_, n, splits):
    packed, scales, x = _case(n)
    ref = _jax(jx, geometry, math_, n)
    got = emulate(torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(packed),
                  torch.from_numpy(scales).to(torch.bfloat16), math_,
                  geometry, splits)
    err = np.abs(got.numpy() - ref).max()
    assert err <= bl.TOL_BATCH * np.abs(ref).max(), (err, np.abs(ref).max())


def _rne_bf16(v64):
    """f64 values (exact products) rounded once to bf16, as f32: to f32
    first (exact for these products, inf past its range), then round to
    nearest even on the bits."""
    with np.errstate(over="ignore"):
        u = v64.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("math_", bl.BATCH_MATHS)
def test_planes_for_every_finite_bf16_scale(math_):
    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[((bits >> 7) & 0xFF) != 0xFF]  # every finite bf16
    s = (bits << 16).view(np.float32)
    rows = np.arange(32)
    packed = ((rows % 16) | (((rows + 5) % 16) << 4)).astype(np.uint8)
    packed = np.repeat(packed[:, None], s.size, axis=1)  # [32, O]: K = 64
    scales = np.stack([s, s])  # [2, O]
    got = bl.batch_planes(torch.from_numpy(packed),
                          torch.from_numpy(scales).to(torch.bfloat16), math_)
    v = np.concatenate([rows % 16, (rows + 5) % 16]).astype(np.float64)
    v = v if math_ == "bnos" else v - 8
    want = _rne_bf16(v[:, None] * s.astype(np.float64)[None, :])
    assert torch.equal(got, torch.from_numpy(want))


def _fits(nt, c, per_sm=2):
    """Clusters of c blocks an H100-sized card holds at once."""
    return per_sm * SM // c


SHAPES = [(64, 4096, 12288), (64, 4096, 4096), (64, 4096, 16384),
          (64, 16384, 4096), (128, 4096, 16384), (128, 16384, 4096),
          (64, 5120, 15360), (64, 5120, 5120), (64, 5120, 20480),
          (64, 20480, 5120)]


@pytest.mark.parametrize("n,k,o", SHAPES)
def test_plans_fit_one_wave(n, k, o):
    nt, c = bl.batch_2d_plan(n, k, o, SM, _fits)
    assert nt == bl.batch_tiles(n) and 8 * nt >= n
    tiles = -(-o // (bl.BATCH_WARPS * bl.batch_tile_o(nt)))
    assert tiles <= _fits(nt, c)  # every cluster at once: one wave
    bl.check_batch_plan("2d", (nt, c), n, k, o, _fits)
    if o <= 5120:  # wo, proj: the cluster fills the card
        assert tiles * c >= SM
    bands = bl.band_plan(n, k, o, SM, _fits(nt, 1))
    assert 1 <= bands <= min(k // 64, _fits(nt, 1))
    bl.check_batch_plan("band", (nt, bands), n, k, o, _fits)


def test_an_over_full_plan_is_refused():
    nt = bl.batch_tiles(64)
    with pytest.raises(ValueError, match="over-full"):
        bl.check_batch_plan("2d", (nt, 8), 64, 4096, 16384, _fits)
    bl.check_batch_plan("2d", (nt, 1), 64, 4096, 1 << 20, _fits)  # waves
    with pytest.raises(ValueError, match="over-full"):
        bl.check_batch_plan("band", (nt, _fits(nt, 1) + 1), 64, 1 << 20,
                            4096, _fits)
    with pytest.raises(ValueError, match="over-full"):
        bl.check_batch_plan("band", (nt, 65), 64, 4096, 4096, _fits)
    with pytest.raises(ValueError, match="n-tiles"):
        bl.check_batch_plan("2d", (4, 1), 64, 4096, 4096, _fits)
