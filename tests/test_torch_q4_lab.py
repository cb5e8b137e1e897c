"""Port vs JAX package: the Q4 dequant lab, K12-K14 (vsim_tpu_torch/ops/
q4_lab.py), against the Pallas probes of tools/ they replace, each run as
the tool defines it, in interpret mode (``pl`` of the tool's module is
swapped for a namespace whose ``pallas_call`` passes ``interpret=True``).

  * K12 under every math against kernel_lab.variant_matmul, pair_lab.
    variant_matmul and pair_sweep.pair_matmul (block_o 128, block_kh 64),
    and pair_probe's k_pairA: max|port − JAX| <= 1e-5 max|JAX| (only the
    order of the f32 sums differs);
  * the dequantized planes of each math, read out of the JAX function with
    one-hot rows of x, bit-identical to ``lab_planes``; the groups that
    compute one function bit-identical to each other;
  * K13's touch output (exact: both sides add left to right over the k
    tiles in grid order) and checksum (exact integers) against
    kernel_lab's "dma" and gi_sweep.giw_dma, for both layouts, and the
    block_kh the TPU body cannot shape raising on both sides;
  * K14 against pair_probe's k_bitcast, exactly;
  * K12's other operand layouts under f32x against kernel_lab.res_matmul,
    w32_matmul and ps_matmul and decode_lab.v2_matmul (a stacked weight
    of 3 layers, layer 1 read from a device index), at 1e-5 of max|JAX|,
    with the port's own ``pack_w32`` and plane-split repack equal to the
    tools' byte for byte.

Every JAX call is compiled with XLA's excess precision off: the Pallas
bodies round the planes to bf16 before the TPU's matrix unit takes them,
but by default XLA's CPU backend may keep a bf16 elementwise result in f32
where it fuses it into the dot (it does so at n = 1 for u16 and the pair
maths: 1.7e-3 of max|out| away from the rounded function), which is not
what the body computes.  O = K = 256 here.  The tests marked ``cuda``
hold the kernels against their plain versions on the card, and skip
without one; JAX and the TPU tools are imported by a fixture, so they run
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_q4_lab.py -q -m cuda

K12's plan (``lab_plan``) is held to one wave of clusters at the lab's
shapes, and every math's weight under every finite bf16 scale to be exact
in the operand type the kernel gives the tensor cores (bf16 or TF32).
"""

import functools
import importlib
import itertools
import types

import numpy as np
import pytest
import torch

from vsim_tpu_torch.ops import q4_lab
from vsim_tpu_torch.ops.q4_cuda import CORE_MAX_CLUSTER, CORE_WARPS
from vsim_tpu_torch.quant.q4 import Q4Tensor, tensor_from_np, to_plane_split
from vsim_tpu_torch.tools import decode_lab as t_decode_lab
from vsim_tpu_torch.tools import gi_sweep as t_gi_sweep
from vsim_tpu_torch.tools import kernel_lab as t_kernel_lab
from vsim_tpu_torch.tools import lab as t_lab
from vsim_tpu_torch.tools import pair_lab as t_pair_lab
from vsim_tpu_torch.tools import pair_probe as t_pair_probe
from vsim_tpu_torch.tools import pair_sweep as t_pair_sweep
from vsim_tpu_torch.tools import read_designs as t_read_designs

O = K = 256
BLOCK_O, BLOCK_KH = 128, 64
TOL = 1e-5
NO_EXCESS = {"xla_allow_excess_precision": False}
# (the tool whose Pallas body defines the math, the math)
CASES = ([("kernel_lab", m) for m in ("i32", "u16", "f32x", "f32f", "f32xf",
                                      "i32f")]
         + [("pair_lab", m) for m in ("f32b", "pairA", "pairB")]
         + [("pair_sweep", m) for m in ("pairA", "pairC")])
TOOLS = {"kernel_lab": t_kernel_lab, "gi_sweep": t_gi_sweep,
         "pair_lab": t_pair_lab, "pair_sweep": t_pair_sweep}


@pytest.fixture
def jx(monkeypatch):
    """JAX, Pallas and the TPU tools, with each tool's ``pl`` swapped for a
    namespace whose ``pallas_call`` runs in interpret mode."""
    names = ("jax", "jax.numpy", "jax.experimental.pallas",
             "jax.experimental.pallas.tpu", "tools.gi_sweep",
             "tools.kernel_lab", "tools.pair_lab", "tools.pair_probe",
             "tools.pair_sweep", "tools.decode_lab")
    m = types.SimpleNamespace(**{n.split(".")[-1]: importlib.import_module(n)
                                 for n in names})
    m.jnp, m.pltpu = m.numpy, m.tpu
    shim = types.SimpleNamespace(**{k: getattr(m.pallas, k)
                                    for k in dir(m.pallas)
                                    if not k.startswith("__")})
    shim.pallas_call = functools.partial(m.pallas.pallas_call, interpret=True)
    for mod in (m.kernel_lab, m.pair_lab, m.pair_sweep, m.gi_sweep,
                m.decode_lab):
        monkeypatch.setattr(mod, "pl", shim)
    return m


def _run(jx, fn, *args, **static):
    """``fn(*args, **static)`` compiled with XLA's excess precision off."""
    f = functools.partial(fn, **static)
    return jx.jax.jit(f).lower(*args).compile(
        compiler_options=NO_EXCESS)(*args)


def _bf16_np(a):
    """f32 values that bf16 holds exactly (rounded through torch)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _weight(seed=0):
    """(packed u8 [K/2, O], bf16 scales as f32 [K/32, O]) from numpy."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (K // 2, O), dtype=np.uint8)
    scales = _bf16_np(rng.standard_normal((K // 32, O)) * 0.3)
    return packed, scales


def _x(n, seed=1):
    return _bf16_np(np.random.default_rng(seed).standard_normal((n, K)))


def _jax_gemv(jx, tool, math, x, packed, scales, xs):
    """The tool's own function on numpy inputs, f32 [n, O] out."""
    jnp = jx.jnp
    xj = jnp.asarray(x, jnp.bfloat16)
    pj, sj = jnp.asarray(packed), jnp.asarray(scales, jnp.bfloat16)
    tiles = dict(variant=math, block_o=BLOCK_O, block_kh=BLOCK_KH)
    if tool == "kernel_lab":
        y = _run(jx, jx.kernel_lab.variant_matmul, xj[:, 0::2], xj[:, 1::2],
                 pj, sj, **tiles)
    elif tool == "pair_lab":
        y = _run(jx, jx.pair_lab.variant_matmul, xj, pj, sj, **tiles)
    else:
        y = _run(jx, jx.pair_sweep.pair_matmul, xj,
                 jnp.asarray(xs, jnp.bfloat16), pj, sj, **tiles)
    return np.asarray(y, np.float32)


def _torch(packed, scales, x=None):
    p = torch.from_numpy(packed)
    s = torch.from_numpy(scales).to(torch.bfloat16)
    return p, s, (None if x is None else torch.from_numpy(x).to(torch.bfloat16))


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("tool,math", CASES)
def test_lab_gemv_matches_jax(jx, tool, math, n):
    packed, scales = _weight()
    x = _x(n)
    # the caller's block sums, as pair_matmul takes them (pairC reads them)
    xs = np.asarray(jx.pair_sweep.block_sums(
        jx.jnp.asarray(x, jx.jnp.bfloat16)), np.float32)
    ref = _jax_gemv(jx, tool, math, x, packed, scales, xs)
    p, s, xt = _torch(packed, scales, x)
    xst = torch.from_numpy(xs).to(torch.bfloat16) if math == "pairC" else None
    got = q4_lab.q4_lab_gemv(xt, p, s, math, xst)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("tool,math", CASES)
def test_lab_planes_match_jax_bodies(jx, tool, math):
    """One-hot rows of x read each weight out of the JAX function exactly
    (1·w plus zeros); pairC's with zero block sums, so without the
    correction.  The port's planes, interleaved to [K, O], equal them bit
    for bit."""
    packed, scales = _weight(seed=2)
    eye = np.eye(K, dtype=np.float32)
    xs = np.zeros((K, K // 32), np.float32)
    ref = _jax_gemv(jx, tool, math, eye, packed, scales, xs)
    p, s, _ = _torch(packed, scales)
    we, wo = q4_lab.lab_planes(p, s, math)
    got = torch.stack([we, wo], dim=1).reshape(K, O)
    assert torch.equal(got, torch.from_numpy(ref))


@pytest.mark.parametrize("group", q4_lab.SAME_FUNCTION)
def test_same_function_groups_bit_identical(group):
    packed, scales = _weight(seed=3)
    p, s, _ = _torch(packed, scales)
    first = q4_lab.lab_planes(p, s, group[0])
    for math in group[1:]:
        planes = q4_lab.lab_planes(p, s, math)
        assert all(torch.equal(a, b) for a, b in zip(first, planes)), math


def test_pairb_is_pairA_with_the_nibbles_swapped():
    packed, scales = _weight(seed=4)
    p, s, _ = _torch(packed, scales)
    swapped = ((p & 0x0F) << 4) | (p >> 4)
    assert all(torch.equal(a, b) for a, b in zip(
        q4_lab.lab_planes(p, s, "pairB"), q4_lab.lab_planes(swapped, s,
                                                            "pairA")))


def _ps_repack(packed):
    el = np.stack([packed & 0x0F, packed >> 4], axis=1).reshape(K, O)
    return (el[:K // 2] | (el[K // 2:] << 4)).astype(np.uint8)


@pytest.mark.parametrize("block_kh", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("layout", ["i", "ps"])
def test_lab_dma_matches_jax(jx, layout, n, block_kh):
    packed, scales = _weight(seed=5)
    if layout == "ps":
        packed = _ps_repack(packed)
    x = _x(n, seed=6)
    jnp = jx.jnp
    xj = jnp.asarray(x, jnp.bfloat16)
    pj, sj = jnp.asarray(packed), jnp.asarray(scales, jnp.bfloat16)
    p, s, xt = _torch(packed, scales, x)
    try:
        if layout == "i":
            ref = _run(jx, jx.kernel_lab.variant_matmul, xj[:, 0::2],
                       xj[:, 1::2], pj, sj, variant="dma", block_o=BLOCK_O,
                       block_kh=block_kh)
        else:
            ref = _run(jx, jx.gi_sweep.giw_dma, xj, pj, sj,
                       block_kh=block_kh)
    except TypeError:  # the TPU body cannot add the tile's scale rows
        with pytest.raises(ValueError, match="cannot add"):
            q4_lab.q4_lab_dma(xt, p, s, layout, block_kh)
        return
    touch, checksum = q4_lab.q4_lab_dma(xt, p, s, layout, block_kh)
    assert torch.equal(touch, torch.from_numpy(np.asarray(ref, np.float32)))
    bits = scales.astype(np.float32).view(np.uint32) >> 16
    assert torch.equal(checksum, torch.from_numpy(np.stack([
        packed.astype(np.int64).sum(0), bits.astype(np.int64).sum(0)])
        .astype(np.int32)))


def _layout_case(jx, layout, n):
    """(JAX out, port out, (port weight, JAX weight) where repacked) for
    K12's ``layout`` on numpy inputs."""
    jnp = jx.jnp
    packed, scales = _weight(seed=8)
    x = _x(n, seed=9)
    xj = jnp.asarray(x, jnp.bfloat16)
    sj = jnp.asarray(scales, jnp.bfloat16)
    p, s, xt = _torch(packed, scales, x)
    il = None
    if layout == "res":
        ref = _run(jx, jx.kernel_lab.res_matmul, xj[:, 0::2], xj[:, 1::2],
                   jnp.asarray(packed), sj, block_o=BLOCK_O, chunk=BLOCK_KH)
        w, pair = p, None
    elif layout == "w32":
        wj = jx.kernel_lab.pack_w32(packed)
        ref = _run(jx, jx.kernel_lab.w32_matmul, xj[:, 0::2], xj[:, 1::2],
                   jnp.asarray(wj), sj, block_o=BLOCK_O,
                   block_kh=BLOCK_KH // 4, interpret=True)
        w = q4_lab.pack_w32(p)
        pair = (w, wj)
    elif layout == "ps":
        pj = jx.kernel_lab.pack_ps(packed)
        ref = _run(jx, jx.kernel_lab.ps_matmul, xj, jnp.asarray(pj), sj,
                   block_o=BLOCK_O, block_kh=BLOCK_KH, interpret=True)
        w = to_plane_split(Q4Tensor(p, s, "i")).packed
        pair = (w, pj)
    else:  # a stack of 3 layers, layer 1
        rng = np.random.default_rng(10)
        stack = rng.integers(0, 256, (3, K // 2, O), dtype=np.uint8)
        sstack = _bf16_np(rng.standard_normal((3, K // 32, O)) * 0.3)
        ref = _run(jx, jx.decode_lab.v2_matmul, jnp.asarray([1], jnp.int32),
                   xj, jnp.asarray(stack), jnp.asarray(sstack, jnp.bfloat16),
                   block_o=BLOCK_O, block_kh=BLOCK_KH)
        w, s, _ = _torch(stack, sstack)
        il, pair = torch.tensor([1], dtype=torch.int32), None
    got = q4_lab.q4_lab_gemv_layout(xt, w, s, layout, il)
    return np.asarray(ref, np.float32), got, pair


@pytest.mark.parametrize("n", [1, 8, 16])
@pytest.mark.parametrize("layout", q4_lab.GEMV_LAYOUTS)
def test_lab_gemv_layouts_match_jax(jx, layout, n):
    ref, got, pair = _layout_case(jx, layout, n)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())
    if pair is not None:  # the port's repack is the tool's, byte for byte
        assert np.array_equal(pair[0].numpy(), np.asarray(pair[1]))


def test_lab_gemv_layouts_compute_f32x():
    """Each layout is the "i" weight's f32x function, repacked or stacked
    (the layer index clamped to the stack, as the kernel reads it)."""
    packed, scales = _weight(seed=11)
    p, s, x = _torch(packed, scales, _x(4, seed=12))
    ref = q4_lab.q4_lab_gemv_plain(x, p, s, "f32x")
    ps = to_plane_split(Q4Tensor(p, s, "i")).packed
    stack = torch.stack([torch.zeros_like(p), p])
    sstack = torch.stack([torch.zeros_like(s), s])
    for layout, w, sc, il in (("res", p, s, None),
                              ("w32", q4_lab.pack_w32(p), s, None),
                              ("ps", ps, s, None),
                              ("v2", stack, sstack,
                               torch.tensor([1], dtype=torch.int32)),
                              ("v2", stack, sstack,
                               torch.tensor([7], dtype=torch.int32))):
        got = q4_lab.q4_lab_gemv_layout(x, w, sc, layout, il)
        assert (got - ref).abs().max() <= 1e-6 * ref.abs().max(), layout
    assert torch.equal(q4_lab.unpack_w32(q4_lab.pack_w32(p)), p)


def test_lab_gemv_layouts_raise_on_what_they_do_not_take():
    packed, scales = _weight()
    p, s, x = _torch(packed, scales, _x(8))
    with pytest.raises(ValueError, match="layout"):
        q4_lab.q4_lab_gemv_layout(x, p, s, "i")
    with pytest.raises(ValueError, match="il"):
        q4_lab.q4_lab_gemv_layout(x, p, s, "res",
                                  torch.tensor([0], dtype=torch.int32))
    with pytest.raises(ValueError, match="il"):
        q4_lab.q4_lab_gemv_layout(x, p[None], s[None], "v2")
    with pytest.raises(ValueError, match="weight"):
        q4_lab.q4_lab_gemv_layout(x, p, s, "w32")
    with pytest.raises(ValueError, match="rows"):
        q4_lab.q4_lab_gemv_layout(torch.zeros((33, K), dtype=torch.bfloat16),
                                  p, s, "ps")
    with pytest.raises(ValueError, match="il must be"):
        q4_lab.q4_lab_gemv_layout(x, p[None], s[None], "v2", 0)


def _probe_call(jx, kernel, out_shape, *args):
    """pair_probe's pallas_call (pair_probe.py:53-58, :80-85), interpreted."""
    vmem = jx.pallas.BlockSpec(memory_space=jx.pltpu.VMEM)
    fn = jx.pallas.pallas_call(
        kernel, out_shape=jx.jax.ShapeDtypeStruct(out_shape,
                                                  jx.jnp.float32),
        in_specs=[vmem] * len(args), out_specs=vmem, interpret=True)
    return np.asarray(_run(jx, fn, *args), np.float32)


def test_pair_bitcast_matches_jax(jx):
    p = np.random.default_rng(0).integers(0, 256, (256, 256), dtype=np.uint8)
    ref = _probe_call(jx, jx.pair_probe.k_bitcast, (512, 256),
                      jx.jnp.asarray(p))
    got = q4_lab.pair_bitcast(torch.from_numpy(p))
    assert torch.equal(got, torch.from_numpy(ref))
    assert torch.equal(got[0::2], torch.from_numpy(p & 0x0F).float() + 128)


def test_pair_probe_pairA_matches_jax(jx):
    rng = np.random.default_rng(0)
    p = rng.integers(0, 256, (256, 256), dtype=np.uint8)
    x = _bf16_np(rng.standard_normal((8, 512)))
    ref = _probe_call(jx, jx.pair_probe.k_pairA, (8, 256),
                      jx.jnp.asarray(x, jx.jnp.bfloat16), jx.jnp.asarray(p))
    pt = torch.from_numpy(p)
    got = q4_lab.q4_lab_gemv(torch.from_numpy(x).to(torch.bfloat16), pt,
                             q4_lab.unit_scales(pt), "pairA")
    err = np.abs(got.numpy() - ref).max()
    assert err <= TOL * np.abs(ref).max(), err


def test_wrappers_raise_on_what_they_do_not_take():
    packed, scales = _weight()
    p, s, x = _torch(packed, scales, _x(8))
    with pytest.raises(ValueError, match="cannot add"):
        q4_lab.q4_lab_dma(x, p, s, "i", 64)  # 4 scale rows, 8 output rows
    for bad in (48, 24, 0, 256):  # not dividing K/2, not whole groups
        with pytest.raises(ValueError, match="block_kh"):
            q4_lab.q4_lab_dma(x, p, s, "i", bad)
    with pytest.raises(ValueError, match="layout"):
        q4_lab.q4_lab_dma(x, p, s, "w32", 128)
    x33 = torch.zeros((33, K), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rows"):
        q4_lab.q4_lab_gemv(x33, p, s, "i32")
    with pytest.raises(ValueError, match="rows"):
        q4_lab.q4_lab_dma(x33, p, s, "i", 128)
    with pytest.raises(ValueError, match="math"):
        q4_lab.q4_lab_gemv(x, p, s, "i8f")
    with pytest.raises(ValueError, match="xs"):
        q4_lab.q4_lab_gemv(x, p, s, "pairC")
    with pytest.raises(ValueError, match="xs"):
        q4_lab.q4_lab_gemv(x, p, s, "pairA", q4_lab.block_sums(x))


@pytest.mark.parametrize("KH,O", [(2048, 4096), (8192, 4096),  # noqa: N803
                                  (2048, 51200), (10240, 5120), (128, 256)])
def test_launch_plans_cover_the_weight(KH, O):  # noqa: N803
    blocks = q4_lab.dma_blocks(KH, O, 132)
    assert 1 <= blocks <= min(4 * 132, -(-O // 512) * KH)
    for n, layout in itertools.product((1, 8, 9, 32), ("i", "res")):
        nt, wc, c = q4_lab.lab_plan(n, 2 * KH, O, layout, 132,
                                    lambda nt, c: 2 * 132 // c)
        splits = CORE_WARPS // wc * c  # of K's units of 64 values
        assert 8 * nt >= n and 1 <= splits <= max(CORE_WARPS, KH // 32)


# the lab's weights: GPT-J-6B's five Q4 shapes, pair_lab's and pair_sweep's
# 50432 x 4096 (K, O)
LAB_SHAPES = [(4096, 12288), (4096, 4096), (4096, 16384), (16384, 4096),
              (4096, 51200), (4096, 50432)]


@pytest.mark.parametrize("n", [1, 8, 16, 32])
@pytest.mark.parametrize("K,O", LAB_SHAPES)  # noqa: N803
@pytest.mark.parametrize("layout", ["i", "res"])
@pytest.mark.parametrize("blocks_per_sm", [1, 2])
def test_lab_plan_one_wave(n, K, O, layout, blocks_per_sm):  # noqa: N803
    """K12's plan on an H100's 132 SMs holding 1 or 2 blocks each: the
    fewest n-tiles that hold n, every cluster resident at once (one wave)
    where any plan allows it, at least 1.5 blocks an SM or the most blocks
    one wave holds, the busiest warp's units of 64 values of K times the
    blocks within 10% of the ideal, at most 8 blocks a cluster (partial
    sums in shared memory, never in HBM); past 8 rows every warp takes its
    own columns; "res" never splits K across the grid (a cluster of one)."""
    sm = 132

    def max_clusters(nt, c):
        return blocks_per_sm * sm // c

    nt, wc, c = q4_lab.lab_plan(n, K, O, layout, sm, max_clusters)
    assert nt == min(t for t in q4_lab.LAB_TILES if 8 * t >= n)
    assert nt == 1 or wc == CORE_WARPS
    assert layout != "res" or c == 1
    tiles, units = -(-O // q4_lab.lab_tile_o(nt, layout)), -(-K // 64)
    clusters, splits = -(-tiles // wc), CORE_WARPS // wc * c
    allowed = range(1, 2) if layout == "res" else range(1, CORE_MAX_CLUSTER + 1)
    fit = [d for d in allowed if clusters <= max_clusters(nt, d)]
    if not fit:  # more column tiles than one wave holds: waves of c = 1
        assert (wc, c) == (max((1, 2, 4) if nt == 1 else (4,)), 1)
        return
    assert c in fit
    most = max(clusters * d for d in fit)
    assert 2 * clusters * c >= min(3 * sm, 2 * most)
    work = -(-units // splits) * clusters * c * CORE_WARPS
    assert tiles * units <= work <= 1.1 * tiles * units


def _finite_bf16_scales():
    """Every finite bf16 value (both signs, zero and subnormals), f32."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[(bits & 0x7F80) != 0x7F80]
    return (bits << 16).view(np.float32)


def _tf32(a):
    """f32 rounded to TF32 as the kernel's tf32_rna: half an ulp of the
    10-bit mantissa added to the magnitude, the 13 low bits cleared."""
    return ((a.view(np.uint32) + 0x1000) & 0xFFFFE000).view(np.float32)


@pytest.mark.parametrize("math", q4_lab.LAB_MATHS)
def test_lab_weights_exact_in_the_operand_type(math):
    """For every bf16 scale whose weights are finite and every nibble, each
    math's weight (``lab_planes``, the plain version's) is exact in what
    the kernel feeds the tensor cores: bf16 for the bf16 maths, TF32 for
    f32xf and i32f,
    and for f32f the sum of two TF32 terms (big = its TF32 rounding,
    small = the rest, itself exact in TF32).  So every product of a bf16 x
    and a weight is exact, and K12 differs from its plain version in the
    order of its f32 sums alone."""
    s = _finite_bf16_scales()
    packed = (np.arange(16, dtype=np.uint8) * 0x11)[:, None].repeat(
        s.size, axis=1)  # row r: both nibbles r
    scales = torch.from_numpy(s[None]).to(torch.bfloat16)  # exact
    we, wo = q4_lab.lab_planes(torch.from_numpy(packed), scales, math)
    w = torch.cat([we, wo]).numpy()
    finite = np.isfinite(w).all(axis=0)  # f32f's 2^23 s overflows first
    assert finite[np.abs(s) < 2.0 ** 100].all()
    w = w[:, finite]
    if math in q4_lab.F32_MATHS:
        np.testing.assert_array_equal(_tf32(w), w)
    else:
        bf = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(bf, w)


def test_lab_scales_are_bf16():
    """The lab's weights carry bf16 scales (the tools' weight makers), and
    K12 refuses any other: no scale reaches the kernel that would need the
    split of an inexact TF32 weight."""
    assert t_lab.lab_weight(64, 16, 0, "cpu").scales.dtype == torch.bfloat16
    assert t_decode_lab.stacked_weight(2, 64, 16, 0, "cpu")[1].dtype == \
        torch.bfloat16
    packed, scales = _weight()
    p, s, x = _torch(packed, scales, _x(1))
    with pytest.raises(ValueError, match="scales must be bf16"):
        q4_lab.q4_lab_gemv(x, p, s.float(), "f32xf")
    with pytest.raises(ValueError, match="scales must be bf16"):
        q4_lab.q4_lab_gemv_layout(x, p, s.float(), "res")


@pytest.mark.parametrize("tool", sorted(TOOLS) + ["pair_probe"])
def test_lab_entry_points_need_a_card_or_cpu(tool, monkeypatch):
    mod = t_pair_probe if tool == "pair_probe" else TOOLS[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [] if tool == "pair_probe" else ["--shape", "256,128",
                                            "--batch", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)
    rows = mod.main(args + ["--device", "cpu"])
    assert rows and all(r["ms"] is None and r["max_abs_err"] == 0.0
                        for r in rows)


def test_decode_lab_entry_point_needs_a_card_or_cpu(monkeypatch):
    """v2 held against cur (one function) and each against its plain
    version, on a 3-layer stack of every group at a small shape."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--n", "2", "--shape", "256,128", "--layers", "3"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_decode_lab.main(args)
    rows = t_decode_lab.main(args + ["--device", "cpu"])
    assert len(rows) == len(t_decode_lab.SHAPES) * len(t_decode_lab.VARIANTS)
    assert all(r["ms"] is None and r["max_abs_err"] == 0.0 for r in rows)


def test_read_designs_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_read_designs.main([])
    with pytest.raises(ValueError, match="CUDA card"):
        t_read_designs.run_shape(K, O, "cpu")


def test_lab_entry_points_raise_on_failure():
    with pytest.raises(ValueError, match="unknown variants"):
        t_kernel_lab.run(2, (256, 128), ("dma", "i8f"), "cpu")
    with pytest.raises(ValueError, match="unknown variants"):
        t_decode_lab.run(1, ("wo",), ("v3",), "cpu", (256, 128), 2)
    with pytest.raises(ValueError, match="at most 8|rows"):
        t_gi_sweep.run(16, (256, 128), ("giw",), "cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 16, 32])
@pytest.mark.parametrize("math", q4_lab.LAB_MATHS)
def test_lab_gemv_on_card(card, math, n):
    packed, scales = _weight()
    p, s, x = (t.to(card) for t in _torch(packed, scales, _x(n)))
    xs = q4_lab.block_sums(x) if math == "pairC" else None
    got = q4_lab.q4_lab_gemv(x, p, s, math, xs)
    ref = q4_lab.q4_lab_gemv_plain(x, p, s, math, xs)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= q4_lab.TOL_LAB * ref.abs().max()
    assert torch.equal(got, q4_lab.q4_lab_gemv(x, p, s, math, xs))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,block_kh,n", [("i", 128, 8), ("i", 16, 3),
                                               ("ps", 32, 8), ("ps", 128, 4),
                                               ("i", 128, 32), ("ps", 32, 32)])
def test_lab_dma_on_card(card, layout, block_kh, n):
    packed, scales = _weight(seed=5)
    p, s, x = (t.to(card) for t in _torch(packed, scales, _x(n)))
    got = q4_lab.q4_lab_dma(x, p, s, layout, block_kh)
    ref = q4_lab.q4_lab_dma_plain(x, p, s, layout, block_kh)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(
        got, q4_lab.q4_lab_dma(x, p, s, layout, block_kh)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 16, 32])
@pytest.mark.parametrize("layout", q4_lab.GEMV_LAYOUTS)
def test_lab_gemv_layouts_on_card(card, layout, n):
    packed, scales = _weight(seed=8)
    p, s, x = (t.to(card) for t in _torch(packed, scales, _x(n)))
    il = None
    if layout == "w32":
        p = q4_lab.pack_w32(p)
    elif layout == "ps":
        p = to_plane_split(Q4Tensor(p, s, "i")).packed
    elif layout == "v2":
        p, s = torch.stack([p.flip(0), p]), torch.stack([s.flip(0), s])
        il = torch.tensor([1], dtype=torch.int32, device=card)
    got = q4_lab.q4_lab_gemv_layout(x, p, s, layout, il)
    ref = q4_lab.q4_lab_gemv_layout_plain(x, p, s, layout, il)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= q4_lab.TOL_LAB * ref.abs().max()
    assert torch.equal(got, q4_lab.q4_lab_gemv_layout(x, p, s, layout, il))


# forced plans (nt, wc, cluster) with n rows each takes: K12's every
# geometry, K split over warps and clusters of 2-8 blocks
LAB_PLANS = [((1, 1, 1), 5), ((1, 2, 2), 8), ((1, 4, 8), 1), ((1, 1, 3), 3),
             ((2, 4, 1), 13), ((2, 4, 3), 16), ((4, 4, 2), 29),
             ((4, 4, 8), 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("plan,n", LAB_PLANS)
@pytest.mark.parametrize("math", ["u16", "f32f", "i32f", "pairB", "pairC"])
@pytest.mark.parametrize("K,O", [(288, 260), (512, 256)])  # noqa: N803
def test_lab_gemv_plans_on_card(card, plan, n, math, K, O):  # noqa: N803
    """Every kind of plan, at K = 32 * odd (the last unit half empty) with
    O = 260 (4-byte loads, masked columns) and at K = 512, O = 256 (16-byte
    loads): within the tolerance, bit-identical run to run."""
    g = torch.Generator(device=card).manual_seed(K + n)
    p = torch.randint(0, 256, (K // 2, O), generator=g, device=card,
                      dtype=torch.uint8)
    s = (torch.randn((K // 32, O), generator=g, device=card) * 0.3).to(
        torch.bfloat16)
    x = torch.randn((n, K), generator=g, device=card).to(torch.bfloat16)
    xs = q4_lab.block_sums(x) if math == "pairC" else None
    got = q4_lab.q4_lab_gemv_planned(x, p, s, math, "i", xs=xs, plan=plan)
    ref = q4_lab.q4_lab_gemv_plain(x, p, s, math, xs)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= q4_lab.TOL_LAB * ref.abs().max()
    assert torch.equal(got, q4_lab.q4_lab_gemv_planned(
        x, p, s, math, "i", xs=xs, plan=plan))


@pytest.mark.cuda
@pytest.mark.parametrize("plan,n", LAB_PLANS)
@pytest.mark.parametrize("layout", ["w32", "ps", "v2", "res"])
def test_lab_gemv_layout_plans_on_card(card, plan, n, layout):
    packed, scales = _weight(seed=9)
    p, s, x = (t.to(card) for t in _torch(packed, scales, _x(n)))
    il = None
    if layout == "w32":
        p = q4_lab.pack_w32(p)
    elif layout == "ps":
        p = to_plane_split(Q4Tensor(p, s, "i")).packed
    elif layout == "v2":
        p, s = torch.stack([p.flip(0), p]), torch.stack([s.flip(0), s])
        il = torch.tensor([1], dtype=torch.int32, device=card)
    else:  # res: K whole across the grid, a cluster of one
        plan = (*plan[:2], 1)
    got = q4_lab.q4_lab_gemv_planned(x, p, s, "f32x", layout, il=il,
                                     plan=plan)
    ref = q4_lab.q4_lab_gemv_layout_plain(x, p, s, layout, il)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= q4_lab.TOL_LAB * ref.abs().max()
    assert torch.equal(got, q4_lab.q4_lab_gemv_planned(
        x, p, s, "f32x", layout, il=il, plan=plan))


@pytest.mark.cuda
def test_lab_gemv_v2_refuses_a_host_layer_index(card):
    packed, scales = _weight()
    p, s, x = (t.to(card) for t in _torch(packed, scales, _x(1)))
    with pytest.raises(ValueError, match="il must be"):
        q4_lab.q4_lab_gemv_layout(x, p[None], s[None], "v2",
                                  torch.tensor([0], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("span", t_read_designs.SPANS)
def test_read_designs_exact_on_card(card, span):
    packed, scales = _weight(seed=7)
    p, s, x = (t.to(card) for t in _torch(packed, scales, _x(1)))
    checksum = torch.empty((2, O), dtype=torch.int32, device=card)
    t_read_designs.read_spans(p, s, checksum, span)
    assert torch.equal(checksum, q4_lab.q4_lab_dma_plain(x, p, s, "i", 64)[1])
    totals = torch.empty(2, dtype=torch.int64, device=card)
    t_read_designs.read_flat(p, s, totals)
    bits = scales.astype(np.float32).view(np.uint32) >> 16  # bf16 patterns
    assert totals.tolist() == [int(packed.sum()), int(bits.sum())]


@pytest.mark.cuda
def test_pair_bitcast_on_card(card):
    p = torch.randint(0, 256, (256, 256), dtype=torch.uint8).to(card)
    assert torch.equal(q4_lab.pair_bitcast(p), q4_lab.pair_bitcast_plain(p))


def test_tensor_from_np_keeps_scale_bits():
    """The tests hand bf16 scales over as f32 values bf16 holds exactly."""
    _, scales = _weight()
    s = tensor_from_np(torch.from_numpy(scales).to(torch.bfloat16)
                       .view(torch.int16).numpy().view(np.uint16))
    assert torch.equal(s.float(), torch.from_numpy(scales))
