"""The sums K1 (csrc/q4_gemv_ps.cu) and K11 (csrc/q4_mlp_ps.cu) compute on
the tensor cores, emulated on the CPU and held against the JAX package.

The two kernels share csrc/q4_core.cuh: every product (v - 8) * x is exact
(bf16 x, or f32 x and h as three bf16 pieces x = b1 + b2 + b3), a fresh f32
sum covers each 32-row group of each plane, and the group's scale
multiplies that sum afterwards.  ``emulate_core`` below does the same in
f32 (only the order inside a group's sum differs from the MMA's) and is
held within TOL_Q4 = 1e-4 of max|ref| (chip_smoke.py's tolerance for the
Q4 kernels) against ``pallas_q4_matmul_ps`` (its grouped-integer
``_kernel_ps_giw``) and ``pallas_q4_mlp_ps``, run in interpret mode, on
seeded inputs that include the worst cases: every nibble 0 or 15, and |x|
spread over 2^-20 .. 2^20.  The three-piece split is exact for every
normal f32 from 2^-110 up to bf16's largest finite value; below, the
residual is under bf16's smallest subnormal step.  ``core_plan`` is held to
one wave of clusters with the most blocks at every Q4 weight shape of
GPT-J-6B and Pythia-12B.  K1's 9-32-row instance is emulated in its own
order (``emulate_rows``: n-tiles of 8 rows, each rank of the cluster
summing its groups in turn, the ranks' partials summed in rank order, the
bias last) against the Pallas giw kernel with its n <= 8 gate lifted, and
its plan (``k1_rows_plan``) is held to one wave that takes each of the K/64
groups once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.ops.pallas_q4 import (_pallas_q4_matmul_ps_giw,
                                    pallas_q4_matmul_ps, pallas_q4_mlp_ps)
from vsim_tpu.quant import q4 as jq4
from vsim_tpu_torch.ops.q4_cuda import (CORE_MAX_CLUSTER, CORE_TILE_O,
                                        CORE_WARPS, K1_ROWS_TILE_O,
                                        core_plan, k1_rows_plan,
                                        mlp_activation)

TOL_Q4 = 1e-4
QK = 32


def split3(x: torch.Tensor):
    """f32 x as three bf16-valued f32 pieces, largest first, each rounded to
    nearest even from what the earlier pieces left (the kernel's split3)."""
    pieces, rest = [], x.to(torch.float32)
    for _ in range(3):
        b = rest.to(torch.bfloat16).to(torch.float32)
        pieces.append(b)
        rest = rest - b
    return pieces


def emulate_core(x, packed, scales, bias=None, act=None):
    """The core's sums: per plane and 32-row group, sum over the group of
    (v - 8) * piece, the smallest piece first, in f32; then
    out = sum_g s_lo[g] lo_g + s_hi[g] hi_g, the bias, the activation."""
    n, K = x.shape  # noqa: N806
    half, G = K // 2, K // 64  # noqa: N806
    pieces = ([x.to(torch.float32)] if x.dtype == torch.bfloat16
              else split3(x))
    s = scales.to(torch.float32)
    frag = []
    for pl, v in enumerate(((packed & 0x0F), (packed >> 4))):
        w = (v.to(torch.float32) - 8.0).reshape(G, QK, -1)  # [G, 32, O]
        f = None
        for b in reversed(pieces):
            xp = b[:, pl * half:(pl + 1) * half].reshape(n, G, QK)
            part = torch.bmm(xp.transpose(0, 1).contiguous(), w)  # [G, n, O]
            f = part if f is None else f + part
        frag.append(f)
    y = (s[:G, None, :] * frag[0] + s[G:2 * G, None, :] * frag[1]).sum(0)
    if bias is not None:
        y = y + bias
    return y if act is None else mlp_activation(y, act)


def _weight(K, O, seed, fill=None):  # noqa: N803
    """The same plane-split weight in both packages: random bytes (or every
    byte ``fill``), bf16 scales."""
    rng = np.random.default_rng(seed)
    packed = (np.full((K // 2, O), fill, np.uint8) if fill is not None
              else rng.integers(0, 256, (K // 2, O), dtype=np.uint8))
    scales = torch.from_numpy(
        (rng.random((K // QK, O)) * 0.02).astype(np.float32)).to(
            torch.bfloat16)
    jw = jq4.Q4Tensor(jnp.asarray(packed),
                      jnp.asarray(scales.to(torch.float32).numpy())
                      .astype(jnp.bfloat16), layout="ps")
    return jw, torch.from_numpy(packed), scales


def _x(n, K, seed, spread):  # noqa: N803
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, K)).astype(np.float32)
    if spread:  # |x| from 2^-20 to 2^20
        x = (np.sign(x) * (1 + rng.random((n, K)))
             * np.exp2(rng.integers(-20, 20, (n, K)))).astype(np.float32)
    return x


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    err = np.abs(got.numpy() - ref).max()
    assert np.isfinite(got.numpy()).all() and err <= TOL_Q4 * np.abs(ref).max()


@pytest.mark.parametrize("fill", [None, 0x00, 0xFF])
@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("n", [1, 8])
def test_k1_sums_match_pallas_giw(fill, spread, n):
    """K1: bf16 x, no split; against the grouped-integer Pallas kernel
    (K/2 % 256 == 0 and a whole-O tile: ``_kernel_ps_giw``)."""
    K, O = 1024, 512  # noqa: N806
    jw, packed, scales = _weight(K, O, 3 + n, fill)
    x = _x(n, K, n, spread)
    b = np.random.default_rng(5).standard_normal(O).astype(np.float32)
    ref = pallas_q4_matmul_ps(jnp.asarray(x, jnp.bfloat16), jw,
                              bias=jnp.asarray(b), interpret=True)
    got = emulate_core(torch.from_numpy(x).to(torch.bfloat16), packed, scales,
                       torch.from_numpy(b))
    _close(got, ref)


@pytest.mark.parametrize("fill,spread,dtype,act", [
    (None, False, "float32", "gelu_exact"),
    (None, True, "float32", "gelu_tanh"),
    (0x00, True, "float32", "relu"),
    (0xFF, True, "float32", "gelu_exact"),
    (0xFF, False, "bfloat16", "gelu_tanh"),
    (None, True, "bfloat16", "relu"),
])
@pytest.mark.parametrize("n", [1, 8])
def test_k11_sums_match_pallas_mlp(fill, spread, dtype, act, n):
    """K11: f32 x split in three, bf16 x whole; h = act(fc + bfc) kept in
    f32 and split in three for proj; against ``pallas_q4_mlp_ps``."""
    E, F = 512, 1024  # noqa: N806
    jfc, pfc, sfc = _weight(E, F, 7, fill)
    jproj, pproj, sproj = _weight(F, E, 8, fill)
    rng = np.random.default_rng(9)
    bfc = (rng.standard_normal(F) * 0.1).astype(np.float32)
    bproj = rng.standard_normal(E).astype(np.float32)
    x = _x(n, E, 10 + n, spread)
    ref = pallas_q4_mlp_ps(jnp.asarray(x, dtype), jfc, jnp.asarray(bfc),
                           jproj, jnp.asarray(bproj), act=act, interpret=True)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    h = emulate_core(xt, pfc, sfc, torch.from_numpy(bfc), act)
    got = emulate_core(h, pproj, sproj, torch.from_numpy(bproj))
    _close(got, ref)


def _f32(bits):
    return torch.tensor(np.array(bits, np.uint32).view(np.float32))


def _residual(x):
    b1, b2, b3 = (p.to(torch.float64) for p in split3(x))
    return x.to(torch.float64) - (b1 + b2 + b3)


def test_split3_exact_on_random_f32():
    """Every bit of a random f32 with |x| from 2^-20 to 2^20 lands in one of
    the three pieces (sums in f64, exact here)."""
    rng = np.random.default_rng(0)
    sign = rng.integers(0, 2, 200_000, dtype=np.uint32) << 31
    exp = rng.integers(127 - 20, 127 + 21, 200_000, dtype=np.uint32) << 23
    mant = rng.integers(0, 1 << 23, 200_000, dtype=np.uint32)
    x = _f32(sign | exp | mant)
    assert torch.equal(_residual(x), torch.zeros_like(x, dtype=torch.float64))
    b1, b2, b3 = split3(x)
    assert (b2.abs() <= b1.abs() * 2.0 ** -8).all()
    assert (b3.abs() <= b2.abs() * 2.0 ** -8).all()


def test_split3_edges():
    """Exact at the edges of the normal range the kernels see: zeros,
    powers of two, all-ones significands, ties that round to even, 2^-110
    and bf16's largest finite value; below 2^-110 the residual stays under
    bf16's smallest subnormal step (2^-133)."""
    exact = [0x00000000, 0x80000000, 0x3F800000, 0xBF800000, 0x3F800001,
             0x3FFFFFFF, 0x3F808000, 0x3F818000, 0x3F800080, 0x3F8080FF,
             0x35800000, 0x49800000, 0x497FFFFF, 0xC97FFFFF, 0x08800001,
             0x08FFFFFF, 0x7F7F0000, 0xFF7F0000, 0x7F7F7FFF]
    assert torch.equal(_residual(_f32(exact)),
                       torch.zeros(len(exact), dtype=torch.float64))
    tiny = _f32([0x00000001, 0x007FFFFF, 0x00800001, 0x02FFFFFF, 0x80400001])
    assert (_residual(tiny).abs() <= 2.0 ** -133).all()


@pytest.mark.parametrize("K,O", [  # noqa: N803
    (4096, 12288), (4096, 4096), (4096, 16384), (16384, 4096), (4096, 51200),
    (5120, 15360), (5120, 5120), (5120, 20480), (20480, 5120), (5120, 51200)])
@pytest.mark.parametrize("blocks_per_sm", [2, 3])
def test_core_plan_one_wave(K, O, blocks_per_sm):  # noqa: N803
    """At every Q4 weight shape of GPT-J-6B and Pythia-12B, on an H100's 132
    SMs holding 2 or 3 blocks each: every cluster resident at once (one
    wave, no ragged second one), at least 1.5 blocks an SM, the busiest
    warp's 32-row groups times the blocks within 10% of the ideal (every
    warp the same number of groups, every block four warps on columns of
    the weight), and at most 8 blocks a cluster: the partial sums meet in
    shared memory and never reach HBM."""
    sm = 132

    def max_clusters(c):
        return blocks_per_sm * sm // c

    wc, c = core_plan(K, O, sm, max_clusters)
    tiles, groups = -(-O // CORE_TILE_O), K // 64
    clusters, splits = -(-tiles // wc), CORE_WARPS // wc * c
    assert 1 <= c <= CORE_MAX_CLUSTER and clusters <= max_clusters(c)
    assert 2 * clusters * c >= 3 * sm
    work = -(-groups // splits) * clusters * c * CORE_WARPS
    assert tiles * groups <= work <= 1.1 * tiles * groups


def emulate_rows(x, packed, scales, bias, cluster):
    """K1's 9-32-row instance (csrc/q4_gemv_ps.cu, rows::kernel): x in
    n-tiles of 8 rows (2 up to 16 rows, else 4; rows past n zero); rank r
    of the cluster takes groups r, r + C, ... in turn, each adding s_lo *
    lo + s_hi * hi (the group's fresh f32 sums of exact products) to its
    partial; the partials are summed in rank order, then the bias."""
    n, K = x.shape  # noqa: N806
    half, G = K // 2, K // 64  # noqa: N806
    nt = 2 if n <= 16 else 4
    xp = torch.zeros((8 * nt, K), dtype=torch.float32)
    xp[:n] = x.to(torch.float32)
    s = scales.to(torch.float32)
    vlo = (packed & 0x0F).to(torch.float32) - 8.0
    vhi = (packed >> 4).to(torch.float32) - 8.0
    tiles = []
    for t in range(nt):
        xt = xp[8 * t:8 * t + 8]
        parts = []
        for r in range(cluster):
            acc = torch.zeros((8, packed.shape[1]), dtype=torch.float32)
            for g in range(r, G, cluster):
                rows = slice(32 * g, 32 * g + 32)
                lo = xt[:, rows] @ vlo[rows]
                hi = xt[:, half + 32 * g:half + 32 * g + 32] @ vhi[rows]
                acc = acc + s[g] * lo
                acc = acc + s[G + g] * hi
            parts.append(acc)
        y = parts[0]
        for p in parts[1:]:
            y = y + p
        tiles.append(y if bias is None else y + bias)
    return torch.cat(tiles)[:n]


@pytest.mark.parametrize("fill,spread", [(None, False), (None, True),
                                         (0xFF, True), (0x00, False)])
@pytest.mark.parametrize("n,cluster", [(9, 1), (16, 3), (24, 5), (32, 8)])
def test_k1_rows_sums_match_pallas_giw(fill, spread, n, cluster):
    """bf16 x at 9-32 rows against ``_pallas_q4_matmul_ps_giw`` (the TPU
    kernel the JAX tool runs past its n <= 8 gate), under clusters that
    divide the 8 groups or not; the bias added last."""
    K, O = 512, 256  # noqa: N806
    jw, packed, scales = _weight(K, O, 30 + n, fill)
    x = _x(n, K, 40 + n, spread)
    b = np.random.default_rng(6).standard_normal(O).astype(np.float32)
    ref = _pallas_q4_matmul_ps_giw(
        jnp.asarray(x, jnp.bfloat16), jw.packed, jw.scales,
        jnp.asarray(b).reshape(1, O), block_kh=256, ochunk=O,
        interpret=True, has_bias=True)
    got = emulate_rows(torch.from_numpy(x).to(torch.bfloat16), packed,
                       scales, torch.from_numpy(b), cluster)
    _close(got, ref)


def rows_kernel_groups(rank, C, groups):  # noqa: N803
    """The groups rank ``rank`` of a C-block cluster computes in
    rows::kernel's double-buffered loop (csrc/q4_gemv_ps.cu): ``gb`` from
    the rank in steps of 2C, ``g1 = gb + C`` beside it while in range."""
    seen, gb = [], rank
    while gb < groups:
        seen.append(gb)
        if gb + C < groups:
            seen.append(gb + C)
        gb += 2 * C
    return seen


def test_rows_kernel_groups_cover_each_group_once_for_any_cluster():
    for groups in (1, 5, 8, 63, 64, 80, 256, 320):
        for c in range(1, CORE_MAX_CLUSTER + 1):
            ranks = [rows_kernel_groups(r, c, groups) for r in range(c)]
            assert sorted(g for gs in ranks for g in gs) == list(range(groups))
            assert max(map(len, ranks)) == -(-groups // c)


@pytest.mark.parametrize("K,O", [  # noqa: N803
    (4096, 12288), (4096, 4096), (4096, 16384), (16384, 4096), (4096, 51200),
    (5120, 15360), (5120, 5120), (5120, 20480), (20480, 5120), (5120, 51200)])
@pytest.mark.parametrize("n", [9, 16, 17, 32])
def test_k1_rows_plan_one_wave_each_group_once(K, O, n):  # noqa: N803
    """At every Q4 weight shape of GPT-J-6B and Pythia-12B, on an H100's 132
    SMs holding two blocks of the instance each: 2 n-tiles up to 16 rows,
    else 4; every cluster resident at once; the kernel's loop over the plan's
    C ranks covers the K/64 groups once, every rank busy and the busiest
    rank's groups times the blocks within 10% of the ideal (the weight's
    groups spread evenly); at most 8 blocks a cluster."""
    sm = 132

    def max_clusters(nt, c):
        assert nt in (2, 4)
        return 2 * sm // c

    nt, c = k1_rows_plan(n, K, O, sm, max_clusters)
    assert nt == (2 if n <= 16 else 4)
    assert 1 <= c <= CORE_MAX_CLUSTER
    tiles = -(-O // K1_ROWS_TILE_O)
    clusters = -(-tiles // CORE_WARPS)
    assert clusters <= max_clusters(nt, c)
    groups = K // 64
    ranks = [rows_kernel_groups(r, c, groups) for r in range(c)]
    assert sorted(g for gs in ranks for g in gs) == list(range(groups))
    assert min(map(len, ranks)) >= 1
    work = max(map(len, ranks)) * clusters * c * CORE_WARPS
    assert tiles * groups <= work <= 1.1 * tiles * groups


def test_k1_rows_plan_refuses_rows_outside_its_domain():
    with pytest.raises(ValueError):
        k1_rows_plan(8, 4096, 4096, 132, lambda nt, c: 264 // c)
    with pytest.raises(ValueError):
        k1_rows_plan(33, 4096, 4096, 132, lambda nt, c: 264 // c)
