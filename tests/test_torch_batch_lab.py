"""Port vs JAX package: the batch lab (vsim_tpu_torch/ops/q4_batch_lab.py
and K13's batch touches in ops/q4_lab.py) against tools/batch_lab.py, each
run as the tool defines it, in interpret mode (``pl`` of the tool's module
is swapped for a namespace whose ``pallas_call`` passes ``interpret=True``)
and compiled with XLA's excess precision off (the bodies round bsub's and
bnos's bf16 products, which XLA's CPU backend may otherwise keep in f32).

  * K15's plain version under f32x, bsub and bnos in both geometries against
    the tool's ``make_fn`` (``run_2d`` at block_kh 64, ``run_band`` at 256;
    bnos with the tool's own ``corr``), n = 9 and 16, K = 512, O = 256:
    max|port − JAX| <= 1e-5 max|JAX|;
  * the planes, read out of ``run_2d`` with one-hot rows of x, bit for bit;
    bsub's bit-identical to f32x's;
  * K13's "2d" and "band" touches exact, and the shapes the TPU bodies
    cannot add (band with block_kh < 256, fewer than 8 rows of x) raising
    on both sides;
  * the tool's ``--check`` against the f32 oracle, and its entry point.

The tests marked ``cuda`` hold K15 and the touches against their plain
versions on the card (and against a second run, bit for bit), K15 also
under every plan its planners could pick (``q4_batch_lab_planned``: 2d at
each n-tile count that holds n under clusters of 1–8, band at 1, 2, 3 and
K/64 bands), check that the 2d plans fill a wave at GPT-J-6B's wo and
proj and that an over-full plan is refused, and skip without one; they
need no JAX:

    python -m pytest --noconftest tests/test_torch_batch_lab.py -q -m cuda
"""

import functools
import importlib
import types

import numpy as np
import pytest
import torch

from vsim_tpu_torch.ops import q4_batch_lab as bl
from vsim_tpu_torch.ops import q4_lab
from vsim_tpu_torch.tools import batch_lab as t_batch_lab

K, O = 512, 256
TOL = 1e-5
NO_EXCESS = {"xla_allow_excess_precision": False}
BLOCK_KH = {"2d": 64, "band": 256}


@pytest.fixture
def jx(monkeypatch):
    """JAX, Pallas and tools.batch_lab, its ``pl`` swapped for a namespace
    whose ``pallas_call`` runs in interpret mode."""
    names = ("jax", "jax.numpy", "jax.experimental.pallas",
             "jax.experimental.pallas.tpu", "tools.batch_lab")
    m = types.SimpleNamespace(**{n.split(".")[-1]: importlib.import_module(n)
                                 for n in names})
    m.jnp = m.numpy
    shim = types.SimpleNamespace(**{k: getattr(m.pallas, k)
                                    for k in dir(m.pallas)
                                    if not k.startswith("__")})
    shim.pallas_call = functools.partial(m.pallas.pallas_call, interpret=True)
    monkeypatch.setattr(m.batch_lab, "pl", shim)
    return m


def _run(jx, fn, *args):
    return np.array(jx.jax.jit(fn).lower(*args).compile(
        compiler_options=NO_EXCESS)(*args), np.float32)


def _bf16_np(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _weight(k=K, seed=0):
    """(plane-split packed u8 [K/2, O], bf16 scales as f32 [K/32, O])."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (k // 2, O), dtype=np.uint8)
    scales = _bf16_np(rng.standard_normal((k // 32, O)) * 0.3)
    return packed, scales


def _x(n, k=K, seed=1):
    return _bf16_np(np.random.default_rng(seed).standard_normal((n, k)))


def _torch(packed, scales, x):
    return (torch.from_numpy(packed),
            torch.from_numpy(scales).to(torch.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _jax_make_fn(jx, variant, x, packed, scales, block_kh):
    """The tool's own function (make_fn: the kernel and, for bnos, its
    correction outside) on numpy inputs."""
    jnp = jx.jnp
    n, k = x.shape
    w = types.SimpleNamespace(packed=jnp.asarray(packed),
                              scales=jnp.asarray(scales, jnp.bfloat16))
    fn = jx.batch_lab.make_fn(variant, w, n, k, O, block_kh, 2048, 64)
    return _run(jx, fn, jnp.asarray(x, jnp.bfloat16))


@pytest.mark.parametrize("n", [9, 16])
@pytest.mark.parametrize("math_", bl.BATCH_MATHS)
@pytest.mark.parametrize("geometry", bl.GEOMETRIES)
def test_batch_lab_matches_jax(jx, geometry, math_, n):
    packed, scales = _weight()
    x = _x(n)
    ref = _jax_make_fn(jx, f"{geometry}/{math_}", x, packed, scales,
                       BLOCK_KH[geometry])
    p, s, xt = _torch(packed, scales, x)
    corr = bl.batch_corr(xt, s) if math_ == "bnos" else None
    got = bl.q4_batch_lab(xt, p, s, math_, geometry, corr)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("math_", bl.BATCH_MATHS)
def test_batch_planes_match_jax_bodies(jx, math_):
    """One-hot rows of x read each weight out of run_2d exactly (corr 0):
    the port's planes equal them bit for bit."""
    jnp = jx.jnp
    packed, scales = _weight(seed=2)
    eye = np.eye(K, dtype=np.float32)
    fn = functools.partial(jx.batch_lab.run_2d, variant=math_, block_o=128,
                           block_kh=64)
    ref = _run(jx, fn, jnp.asarray(eye, jnp.bfloat16), jnp.asarray(packed),
               jnp.asarray(scales, jnp.bfloat16),
               jnp.zeros((K, O), jnp.float32))
    p, s, _ = _torch(packed, scales, eye)
    assert torch.equal(bl.batch_planes(p, s, math_), torch.from_numpy(ref))


def test_bsub_is_bit_identical_to_f32x():
    packed, scales = _weight(seed=3)
    p, s, _ = _torch(packed, scales, _x(1))
    assert torch.equal(bl.batch_planes(p, s, "bsub"),
                       bl.batch_planes(p, s, "f32x"))


@pytest.mark.parametrize("k", [512, 1024])
@pytest.mark.parametrize("n", [8, 9, 16])
@pytest.mark.parametrize("layout", ["2d", "band"])
def test_batch_touch_matches_jax(jx, layout, n, k):
    """K13's "2d" and "band" touches against the tool's dma variants,
    exactly (both sides add left to right over the k tiles), and its
    checksum of every byte."""
    packed, scales = _weight(k=k, seed=5)
    x = _x(n, k=k, seed=6)
    ref = _jax_make_fn(jx, f"{layout}/dma", x, packed, scales,
                       BLOCK_KH[layout])
    p, s, xt = _torch(packed, scales, x)
    touch, checksum = q4_lab.q4_lab_dma(xt, p, s, layout, BLOCK_KH[layout])
    assert torch.equal(touch, torch.from_numpy(ref))
    assert not touch[8:].any()
    bits = scales.astype(np.float32).view(np.uint32) >> 16
    assert torch.equal(checksum, torch.from_numpy(np.stack([
        packed.astype(np.int64).sum(0), bits.astype(np.int64).sum(0)])
        .astype(np.int32)))


@pytest.mark.parametrize("layout,n,block_kh", [("band", 8, 64),
                                               ("band", 16, 128),
                                               ("band", 4, 256),
                                               ("2d", 4, 64)])
def test_batch_touch_raises_where_the_tpu_body_cannot_add(jx, layout, n,
                                                          block_kh):
    packed, scales = _weight(seed=7)
    x = _x(n, seed=8)
    with pytest.raises((TypeError, ValueError)):
        _jax_make_fn(jx, f"{layout}/dma", x, packed, scales, block_kh)
    p, s, xt = _torch(packed, scales, x)
    with pytest.raises(ValueError, match="cannot add"):
        q4_lab.q4_lab_dma(xt, p, s, layout, block_kh)


def test_batch_lab_raises_on_what_it_does_not_take():
    packed, scales = _weight()
    p, s, x = _torch(packed, scales, _x(16))
    with pytest.raises(ValueError, match="rows"):
        bl.q4_batch_lab(torch.zeros((129, K), dtype=torch.bfloat16), p, s,
                        "f32x", "2d")
    with pytest.raises(ValueError, match="corr"):
        bl.q4_batch_lab(x, p, s, "bnos", "2d")
    with pytest.raises(ValueError, match="corr"):
        bl.q4_batch_lab(x, p, s, "f32x", "band", bl.batch_corr(x, s))
    with pytest.raises(ValueError, match="math"):
        bl.q4_batch_lab(x, p, s, "gi", "2d")
    with pytest.raises(ValueError, match="geometry"):
        bl.q4_batch_lab(x, p, s, "f32x", "3d")
    with pytest.raises(ValueError, match="multiple of 64"):
        bl.q4_batch_lab(x[:, :480], p[:240], s[:15], "f32x", "2d")


@pytest.mark.parametrize("n,k,o", [(64, 4096, 16384), (128, 16384, 4096),
                                   (1, 512, 256), (64, 20480, 5120)])
def test_band_plan_fits_the_weight(n, k, o):
    b = bl.band_plan(n, k, o, 132)
    assert 1 <= b <= min(k // 64, 2 * 132)


def test_check_against_the_f32_oracle():
    """``--check``: f32x and bsub within bf16 rounding of the oracle, bnos
    lossier (it rounds v·s and cancels the −8 outside)."""
    rel = t_batch_lab.check(device="cpu")
    assert set(rel) == {f"{g}/{m}" for g in bl.GEOMETRIES
                        for m in bl.BATCH_MATHS}
    assert rel["2d/f32x"] == rel["2d/bsub"] and rel["2d/f32x"] < 1e-2
    assert rel["2d/bnos"] > rel["2d/f32x"]


def test_batch_lab_entry_point_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--shape", "256,512", "--batch", "9"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_batch_lab.main(args)
    rows = t_batch_lab.main(args + ["--device", "cpu"])
    assert len(rows) == len(t_batch_lab.VARIANTS)
    assert all(r["ms"] is None and r["max_abs_err"] == 0.0 for r in rows)
    with pytest.raises(ValueError, match="unknown variants"):
        t_batch_lab.run(9, shapes=[(256, 512)], variants=("2d/gi",),
                        device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 9, 16, 64, 128])
@pytest.mark.parametrize("math_", bl.BATCH_MATHS)
@pytest.mark.parametrize("geometry", bl.GEOMETRIES)
def test_batch_lab_on_card(card, geometry, math_, n):
    rng = np.random.default_rng(n)
    o = 272  # not a multiple of the 128-column tile
    packed = rng.integers(0, 256, (K // 2, o), dtype=np.uint8)
    scales = _bf16_np(rng.standard_normal((K // 32, o)) * 0.3)
    p, s, x = (t.to(card) for t in _torch(packed, scales, _x(n)))
    corr = bl.batch_corr(x, s) if math_ == "bnos" else None
    got = bl.q4_batch_lab(x, p, s, math_, geometry, corr)
    ref = bl.q4_batch_lab_plain(x, p, s, math_, geometry, corr)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= bl.TOL_BATCH * ref.abs().max()
    assert torch.equal(got, bl.q4_batch_lab(x, p, s, math_, geometry, corr))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,n", [("2d", 8), ("2d", 64), ("band", 16),
                                      ("band", 128)])
def test_batch_touch_on_card(card, layout, n):
    packed, scales = _weight(k=1024, seed=5)
    p, s, x = (t.to(card) for t in _torch(packed, scales,
                                          _x(n, k=1024, seed=6)))
    got = q4_lab.q4_lab_dma(x, p, s, layout, BLOCK_KH[layout])
    ref = q4_lab.q4_lab_dma_plain(x, p, s, layout, BLOCK_KH[layout])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(
        got, q4_lab.q4_lab_dma(x, p, s, layout, BLOCK_KH[layout])))


def _plans(geometry, n, k):
    """Every plan a planner could pick for n rows and K = k: 2d, each
    instance that holds n under clusters of 1-8; band, 1..K/64 bands."""
    tiles = [t for t in bl.BATCH_TILES if 8 * t >= n]
    if geometry == "2d":
        return [(t, c) for t in tiles
                for c in range(1, bl.BATCH_MAX_CLUSTER + 1)]
    return [(t, b) for t in tiles[:2] for b in (1, 2, 3, k // 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 9, 64, 128])
@pytest.mark.parametrize("math_", bl.BATCH_MATHS)
@pytest.mark.parametrize("geometry", bl.GEOMETRIES)
def test_batch_lab_every_plan_on_card(card, geometry, math_, n):
    """K15 under every plan of ``_plans``, forced through
    ``q4_batch_lab_planned`` (K = 1024, O = 272: a ragged last tile):
    within TOL_BATCH of the plain version, the same bits run to run."""
    k, o = 1024, 272
    rng = np.random.default_rng(7 + n)
    packed = rng.integers(0, 256, (k // 2, o), dtype=np.uint8)
    scales = _bf16_np(rng.standard_normal((k // 32, o)) * 0.3)
    p, s, x = (t.to(card) for t in _torch(packed, scales, _x(n, k=k)))
    corr = bl.batch_corr(x, s) if math_ == "bnos" else None
    ref = bl.q4_batch_lab_plain(x, p, s, math_, geometry, corr)
    for plan in _plans(geometry, n, k):
        got = bl.q4_batch_lab_planned(x, p, s, math_, geometry, corr, plan)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        assert err <= bl.TOL_BATCH * ref.abs().max().item(), (plan, err)
        assert torch.equal(got, bl.q4_batch_lab_planned(
            x, p, s, math_, geometry, corr, plan)), plan


@pytest.mark.cuda
def test_batch_lab_plans_on_card(card):
    """The planners' picks on this card fill one wave at GPT-J-6B's wo and
    proj at n = 64, and an over-full forced plan is refused."""
    index = card.index or 0
    for k, o in [(4096, 4096), (16384, 4096)]:
        nt, c = bl._plan(index, 0, "2d", 64, k, o)
        tiles = -(-o // (bl.BATCH_WARPS * bl.batch_tile_o(nt)))
        assert tiles * c >= bl._sm_count(index)
        assert tiles <= bl._max_clusters(index, 0, False, nt, c)
    nt = bl.batch_tiles(64)
    x = torch.zeros((64, 4096), dtype=torch.bfloat16, device=card)
    p = torch.zeros((2048, 1 << 16), dtype=torch.uint8, device=card)
    s = torch.zeros((128, 1 << 16), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="over-full"):
        bl.q4_batch_lab_planned(x, p, s, "f32x", "2d", None, (nt, 8))
