"""K1-K11 on the card against their plain PyTorch versions, at small shapes.

Marked ``cuda``: each test skips without a CUDA device (decided in the
fixture, never at import).  On a machine with the card and no JAX
(``--noconftest`` skips tests/conftest.py, which imports jax):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances relative to max|plain|, as in chip_smoke.py: 1e-4 for the Q4
matmuls (K1, K2, K9, K10) and the fused MLP (K11; K1, K2 and K11 are also
bit-identical from run to run) and 1e-3 for decode attention, fresh mode
included (only the f32 sum and exp order differ), 1e-2 for bf16 flash
output and gradients (rounded to bf16), 1e-4 for f32 flash gradients (sum
order; K7/K8's f32 products at D = 64 and 128 are three TF32 products each,
~1e-6 of max|plain| in the CPU emulation of tests/test_torch_flash_bwd.py,
where one TF32 product misses 1e-4); K7/K8's bf16 gradients at D % 16 == 0
(bf16 products, p and ds as hi + lo bf16 halves) also within 2^-8 of
max|plain| element by element, with at most 2% of the bf16 elements
differing from the plain version's (hi alone moves ~40%, in the same
emulation); the row writer K6 is exact.
"""

import math

import pytest
import torch

from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_bwd_route,
    flash_attention_fwd,
    flash_attention_fwd_route,
    flash_attention_plain,
)
from vsim_tpu_torch.ops.decode_attention import (
    decode_attention_fresh,
    decode_attention_fresh_plain,
    decode_attention_plain,
    decode_attention_q,
    decode_split_plan,
    scatter_rows,
    scatter_rows_plain,
)
from vsim_tpu_torch.ops.q4_cuda import (
    q4_gemv_ps,
    q4_gemv_ps_plain,
    q4_matmul_i,
    q4_matmul_i_plain,
    q4_matmul_ps,
    q4_matmul_ps_plain,
    q4_matmul_stacked,
    q4_matmul_stacked_plain,
    q4_mlp_ps,
    q4_mlp_ps_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _nearer_own_contract(got, x, packed, scales, bias, round_planes):
    """K2's output is nearer the plain version of its own plane contract
    than the other's (bf16 against f32 planes)."""
    own = q4_matmul_ps_plain(x, packed, scales, bias, round_planes)
    other = q4_matmul_ps_plain(x, packed, scales, bias, not round_planes)
    return _rel(got, own) < _rel(got, other)


def _weight(K, O, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (K // 2, O), generator=g, device=dev,
                           dtype=torch.uint8)
    scales = (torch.rand((K // 32, O), generator=g, device=dev) * 0.01).to(
        torch.bfloat16)
    return packed, scales


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("K,O", [(512, 1024), (2048, 4100), (64, 1028),
                                 (1344, 1028)])
def test_q4_gemv_ps(dev, n, K, O):
    """K1 at every n; K = 64 is one group a plane, K = 1344 21 groups (no
    split divides them), O = 1028 and 4100 no multiple of a 16- or
    128-column tile (4-byte loads, a ragged last tile); with and without a
    bias, one launch a call, the same bits from run to run (the partials
    meet in shared memory in a fixed order)."""
    packed, scales = _weight(K, O, dev, n)
    x = torch.randn((n, K), device=dev).to(torch.bfloat16)
    for bias in (None, torch.randn((O,), device=dev)):
        before = _build.launch_counts["q4_gemv_ps"]
        got = q4_gemv_ps(x, packed, scales, bias)
        assert _build.launch_counts["q4_gemv_ps"] == before + 1
        ref = q4_gemv_ps_plain(x, packed, scales, bias)
        assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
        assert torch.equal(got, q4_gemv_ps(x, packed, scales, bias))


@pytest.mark.parametrize("plan", [(1, 1), (1, 3), (1, 8), (2, 1), (2, 5),
                                  (4, 1), (4, 2)])
@pytest.mark.parametrize("K,O", [(1344, 1028), (4096, 2048)])
def test_q4_gemv_ps_plans(dev, plan, K, O):
    """Every kind of split the plan can pick, at n = 1 and 8: warps on one
    column tile or several, clusters of 1-8 blocks, splits that divide the
    groups or not (21 groups; 64 groups over 24 splits); each plan sums in
    its own order, within the tolerance, the same bits run to run."""
    from vsim_tpu_torch.ops.q4_cuda import q4_gemv_ps_planned

    packed, scales = _weight(K, O, dev, sum(plan))
    bias = torch.randn((O,), device=dev)
    for n in (1, 8):
        x = torch.randn((n, K), device=dev).to(torch.bfloat16)
        got = q4_gemv_ps_planned(x, packed, scales, bias, plan)
        ref = q4_gemv_ps_plain(x, packed, scales, bias)
        assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
        assert torch.equal(got, q4_gemv_ps_planned(x, packed, scales, bias,
                                                   plan))


@pytest.mark.parametrize("n", [9, 12, 16, 17, 24, 31, 32])
@pytest.mark.parametrize("K,O", [(512, 1024), (1344, 1028), (64, 1028),
                                 (2048, 4100)])
def test_q4_gemv_ps_9_to_32_rows(dev, n, K, O):
    """K1's 9-32-row instance (2 or 4 n-tiles of 8 rows): O = 1024, and O
    = 1028 / 4100 no multiple of its 64-column warp tile or of 8 (4-byte
    loads, a ragged last tile); 21 groups; with and without a bias, one
    launch a call under K1's name, the same bits run to run."""
    packed, scales = _weight(K, O, dev, 100 + n)
    x = torch.randn((n, K), device=dev).to(torch.bfloat16)
    for bias in (None, torch.randn((O,), device=dev)):
        before = _build.launch_counts["q4_gemv_ps"]
        got = q4_gemv_ps(x, packed, scales, bias)
        assert _build.launch_counts["q4_gemv_ps"] == before + 1
        ref = q4_gemv_ps_plain(x, packed, scales, bias)
        assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
        assert torch.equal(got, q4_gemv_ps(x, packed, scales, bias))


@pytest.mark.parametrize("plan", [(2, 1), (2, 3), (2, 8), (4, 1), (4, 5),
                                  (4, 8)])
@pytest.mark.parametrize("K,O", [(1344, 1028), (4096, 2048)])
def test_q4_gemv_ps_rows_plans(dev, plan, K, O):
    """Every (nt, cluster) of the 9-32-row instance, at the least and most
    rows each n-tile count holds, each within the tolerance and the same
    bits run to run."""
    from vsim_tpu_torch.ops.q4_cuda import q4_gemv_ps_planned

    packed, scales = _weight(K, O, dev, sum(plan))
    bias = torch.randn((O,), device=dev)
    nt = plan[0]
    for n in (8 * nt - 7, 8 * nt):
        x = torch.randn((n, K), device=dev).to(torch.bfloat16)
        got = q4_gemv_ps_planned(x, packed, scales, bias, plan)
        ref = q4_gemv_ps_plain(x, packed, scales, bias)
        assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
        assert torch.equal(got, q4_gemv_ps_planned(x, packed, scales, bias,
                                                   plan))


def test_q4_gemv_ps_refuses_more_than_32_rows(dev):
    packed, scales = _weight(128, 64, dev, 0)
    with pytest.raises(ValueError, match=r"1\.\.32"):
        q4_gemv_ps(torch.zeros((33, 128), device=dev, dtype=torch.bfloat16),
                   packed, scales)


def test_router_keeps_9_to_32_rows_on_k2(dev):
    """K1 takes 9-32 rows when called, but the router's gi route stays at n
    <= 8 (GEMV_MAX_ROWS): 16 rows of bf16 x launch K2, 8 rows K1."""
    from vsim_tpu_torch.ops.matmul import q4_matmul
    from vsim_tpu_torch.quant.q4 import Q4Tensor

    packed, scales = _weight(512, 1024, dev, 7)
    w = Q4Tensor(packed, scales, "ps")
    for n, kernel in ((16, "q4_matmul_ps"), (32, "q4_matmul_ps"),
                      (8, "q4_gemv_ps")):
        x = torch.randn((n, 512), device=dev).to(torch.bfloat16)
        before = dict(_build.launch_counts)
        q4_matmul(x, w, compute_dtype=torch.bfloat16)
        after = dict(_build.launch_counts)
        changed = {k for k in after if after[k] != before.get(k, 0)}
        assert changed == {kernel}, (n, changed)


def test_k1_compare_this_tree_against_itself(dev, tmp_path):
    """tools/k1_compare.py, which holds K1's n <= 8 instance against
    another checkout's build bit for bit, finds no word differing when the
    other checkout is this one."""
    from vsim_tpu_torch.tools import k1_compare

    rows = k1_compare.compare(k1_compare.ROOT, shapes=((1024, 1024),),
                              ns=(1, 8), build_dir=str(tmp_path))
    assert len(rows) == 4
    assert all(r["differ"] == 0 and r["finite"] for r in rows)


def test_q4_gemv_ps_unaligned_x(dev):
    """x that starts off a 16-byte boundary (a row of a larger tensor) is
    taken as it is by the wrapper."""
    packed, scales = _weight(512, 256, dev, 5)
    big = torch.randn((2, 513), device=dev).to(torch.bfloat16)
    x = big.reshape(-1)[1:513].reshape(1, 512)
    assert x.data_ptr() % 16
    assert _rel(q4_gemv_ps(x, packed, scales),
                q4_gemv_ps_plain(x, packed, scales)) < 1e-4


@pytest.mark.parametrize("n", [1, 3, 8, 9, 16, 17, 31, 32, 33, 64, 100, 128])
@pytest.mark.parametrize("round_planes", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("O", [1024, 4100])
def test_q4_matmul_ps(dev, n, round_planes, dtype, O):  # noqa: N803
    """K2's three instances (the GEMV at n <= 8, the tensor cores at 9-128
    rows: bf16 products with bf16 planes, TF32 ones with f32 planes) under
    both plane contracts, bf16 and f32 x, with and without a bias; every
    row tile (16, 32, 64, 128) full and part-filled; O = 4100 is a ragged
    tile that cp.async cannot copy (O % 16 != 0).  One launch count a call,
    the same bits from run to run (split partials reduced in order), nearer
    its own plane contract than the other."""
    K = 2048  # noqa: N806
    packed, scales = _weight(K, O, dev, n + O)
    x = torch.randn((n, K), device=dev).to(dtype)
    for bias in (None, torch.randn((O,), device=dev)):
        before = _build.launch_counts["q4_matmul_ps"]
        got = q4_matmul_ps(x, packed, scales, bias, round_planes)
        assert _build.launch_counts["q4_matmul_ps"] == before + 1
        ref = q4_matmul_ps_plain(x, packed, scales, bias, round_planes)
        assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
        assert torch.equal(got, q4_matmul_ps(x, packed, scales, bias,
                                             round_planes))
        assert _nearer_own_contract(got, x, packed, scales, bias,
                                    round_planes)


@pytest.mark.parametrize("n", [1, 8, 9, 16, 17, 31, 33, 64, 100, 128])
@pytest.mark.parametrize("dtype,round_planes", [(torch.float32, True),
                                                (torch.bfloat16, False),
                                                (torch.float32, False)])
def test_q4_matmul_ps_plane_contract(dev, n, dtype, round_planes):
    """K2's contracts beyond "bf16 planes for bf16 x": f32 x rounded with
    its planes (i32/f32x), bf16 or f32 x against f32 planes (f32xf, and f32
    compute under gi): within the tolerance of its own contract, nearer it
    than the other, which differs beyond the tolerance."""
    packed, scales = _weight(1024, 320, dev, n + 1)
    x = torch.randn((n, 1024), device=dev).to(dtype)
    bias = torch.randn((320,), device=dev)
    got = q4_matmul_ps(x, packed, scales, bias, round_planes)
    ref = q4_matmul_ps_plain(x, packed, scales, bias, round_planes)
    assert _rel(got, ref) < 1e-4
    assert torch.equal(got, q4_matmul_ps(x, packed, scales, bias,
                                         round_planes))
    other = q4_matmul_ps_plain(x, packed, scales, bias, not round_planes)
    assert _rel(other, ref) > 1e-4  # the contracts differ beyond the tolerance
    assert _rel(got, ref) < _rel(got, other)


@pytest.mark.parametrize("n", [9, 33, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("round_planes", [False, True])
def test_q4_matmul_ps_splits_on_card(dev, n, dtype, round_planes):
    """Every split the plan can pick at 9-128 rows: 1 to all 21 groups of K
    = 1344 (splits that divide the groups and ones that do not), each within
    the tolerance and the same bits run to run; a split past K/64 raises."""
    from vsim_tpu_torch.ops.q4_cuda import q4_matmul_ps_planned

    K, O = 1344, 1028  # noqa: N806
    packed, scales = _weight(K, O, dev, 3 * n)
    x = torch.randn((n, K), device=dev).to(dtype)
    bias = torch.randn((O,), device=dev)
    ref = q4_matmul_ps_plain(x, packed, scales, bias, round_planes)
    for splits in range(1, K // 64 + 1):
        got = q4_matmul_ps_planned(x, packed, scales, bias, round_planes,
                                   splits)
        assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4, splits
        assert torch.equal(got, q4_matmul_ps_planned(
            x, packed, scales, bias, round_planes, splits))
        assert _nearer_own_contract(got, x, packed, scales, bias,
                                    round_planes)
    with pytest.raises(RuntimeError):
        q4_matmul_ps_planned(x, packed, scales, bias, round_planes,
                             K // 64 + 1)


@pytest.mark.parametrize("n", [20, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("round_planes", [False, True])
def test_q4_matmul_ps_long_k_unsplit(dev, n, dtype, round_planes):
    """Pythia-12B proj's K = 20480 (320 groups) in one split: every group's
    tensor-core sum meets the accumulator in f32, so the error stays within
    the tolerance however many groups a block walks."""
    from vsim_tpu_torch.ops.q4_cuda import q4_matmul_ps_planned

    packed, scales = _weight(20480, 512, dev, n)
    x = torch.randn((n, 20480), device=dev).to(dtype)
    got = q4_matmul_ps_planned(x, packed, scales, None, round_planes, 1)
    ref = q4_matmul_ps_plain(x, packed, scales, None, round_planes)
    assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
    assert torch.equal(got, q4_matmul_ps_planned(x, packed, scales, None,
                                                 round_planes, 1))
    assert _nearer_own_contract(got, x, packed, scales, None, round_planes)


@pytest.mark.parametrize("n", [9, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("round_planes", [False, True])
def test_q4_matmul_ps_unaligned_x(dev, n, dtype, round_planes):
    """x that starts off a 16-byte boundary (a view one value into a larger
    tensor) takes the tensor cores' plain loads of x."""
    packed, scales = _weight(1024, 512, dev, n)
    big = torch.randn((n * 1024 + 1,), device=dev).to(dtype)
    x = big[1:].reshape(n, 1024)
    assert x.data_ptr() % 16
    got = q4_matmul_ps(x, packed, scales, None, round_planes)
    ref = q4_matmul_ps_plain(x, packed, scales, None, round_planes)
    assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
    assert torch.equal(got, q4_matmul_ps(x.clone(), packed, scales, None,
                                         round_planes))
    assert _nearer_own_contract(got, x, packed, scales, None, round_planes)


@pytest.mark.parametrize("n", [16, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q4_matmul_ps_scales_near_smallest_normal(dev, n, dtype):
    """f32 planes whose bf16 scales lie in bf16's smallest normal binade
    (2^-126 to 2^-125): each weight stays exact in TF32 there, and the
    TF32 instance holds the tolerance."""
    packed, _ = _weight(1024, 512, dev, n)
    g = torch.Generator(device=dev).manual_seed(n)
    scales = (2.0 ** -126 * (1 + torch.rand((32, 512), generator=g,
                                            device=dev))).to(torch.bfloat16)
    assert (scales.float() >= 2.0 ** -126).all()
    x = torch.randn((n, 1024), generator=g, device=dev).to(dtype)
    got = q4_matmul_ps(x, packed, scales, None, False)
    ref = q4_matmul_ps_plain(x, packed, scales, None, False)
    assert ref.abs().max() > 0
    assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
    assert torch.equal(got, q4_matmul_ps(x, packed, scales, None, False))
    assert _nearer_own_contract(got, x, packed, scales, None, False)


I_ROWS = [1, 2, 3, 4, 5, 7, 8, 9, 16, 33, 64, 100, 128]


@pytest.mark.parametrize("n", I_ROWS)
@pytest.mark.parametrize("K,O", [(512, 1024), (2048, 4100), (288, 1028)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q4_matmul_i(dev, n, K, O, dtype):
    """K9 at every instance's n (1-8 on K1's geometry, 9-128 on 2-16
    n-tiles of x staged in shared memory); K = 288 is 9 groups (32 * odd:
    the last unit of two groups holds one), O = 4100 and 1028 no multiple
    of 16 (4-byte loads, a ragged last tile); with and without a bias, one
    launch a call, the same bits from run to run."""
    packed, scales = _weight(K, O, dev, n + 2)
    x = torch.randn((n, K), device=dev).to(dtype)
    for bias in (None, torch.randn((O,), device=dev)):
        before = _build.launch_counts["q4_matmul_i"]
        got = q4_matmul_i(x, packed, scales, bias)
        assert _build.launch_counts["q4_matmul_i"] == before + 1
        ref = q4_matmul_i_plain(x, packed, scales, bias)
        assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
        assert torch.equal(got, q4_matmul_i(x, packed, scales, bias))


def _stacked(L, K, O, dev, seed):  # noqa: N803
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (L, K // 2, O), generator=g, device=dev,
                           dtype=torch.uint8)
    scales = (torch.rand((L, K // 32, O), generator=g, device=dev)
              * 0.01).to(torch.bfloat16)
    return packed, scales


@pytest.mark.parametrize("n", I_ROWS)
@pytest.mark.parametrize("round_planes", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,O", [(1024, 2048), (288, 4100)])
def test_q4_matmul_stacked(dev, n, round_planes, dtype, K, O):  # noqa: N803
    """K10 under both plane contracts, bf16 and f32 x, on the first and the
    last layer and on indices past either end (clamped on the device); one
    launch a call, the same bits from run to run, and the contracts differ
    beyond the tolerance."""
    L = 3  # noqa: N806
    packed, scales = _stacked(L, K, O, dev, n)
    x = torch.randn((n, K), device=dev).to(dtype)
    bias = torch.randn((O,), device=dev)
    for il, layer in ((0, 0), (L - 1, L - 1), (-5, 0), (L + 4, L - 1)):
        ilt = torch.tensor(il, dtype=torch.int32, device=dev)
        before = _build.launch_counts["q4_matmul_stacked"]
        got = q4_matmul_stacked(x, packed, scales, ilt, bias, round_planes)
        assert _build.launch_counts["q4_matmul_stacked"] == before + 1
        ref = q4_matmul_i_plain(x, packed[layer], scales[layer], bias,
                                round_planes)
        assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
        assert torch.equal(got, q4_matmul_stacked(x, packed, scales, ilt,
                                                  bias, round_planes))
        if 0 <= il < L:
            assert _rel(got, q4_matmul_stacked_plain(
                x, packed, scales, ilt, bias, round_planes)) < 1e-4
    other = q4_matmul_i_plain(x, packed[0], scales[0], bias, not round_planes)
    assert _rel(other, q4_matmul_i_plain(x, packed[0], scales[0], bias,
                                         round_planes)) > 1e-4
    with pytest.raises(ValueError, match="int32"):
        q4_matmul_stacked(x, packed, scales, 1)


@pytest.mark.parametrize("plan", [(1, 1, 1), (1, 1, 3), (1, 1, 8), (1, 2, 1),
                                  (1, 2, 5), (1, 4, 1), (1, 4, 2), (2, 4, 1),
                                  (4, 4, 3), (8, 4, 8), (16, 4, 1),
                                  (16, 4, 2), (16, 4, 7)])
@pytest.mark.parametrize("K,O", [(1376, 1028), (4096, 2048)])
@pytest.mark.parametrize("round_planes", [False, True])
def test_q4_matmul_i_plans(dev, plan, K, O, round_planes):  # noqa: N803
    """Every kind of plan, at the fewest rows and the most its n-tiles
    hold: warps on one column tile or several, clusters of 1-8 blocks,
    splits that divide the units or not (K = 1376 is 43 groups, 22 units;
    64 units over 24 splits), more n-tiles than the rows need; within the
    tolerance, the same bits run to run."""
    from vsim_tpu_torch.ops.q4_cuda import q4_matmul_i_planned

    nt = plan[0]
    packed, scales = _stacked(2, K, O, dev, sum(plan))
    ilt = torch.tensor(1, dtype=torch.int32, device=dev)
    bias = torch.randn((O,), device=dev)
    for n in (1, 8 * nt):
        x = torch.randn((n, K), device=dev).to(torch.bfloat16)
        got = q4_matmul_i_planned(x, packed, scales, ilt, bias, round_planes,
                                  plan)
        ref = q4_matmul_i_plain(x, packed[1], scales[1], bias, round_planes)
        assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
        assert torch.equal(got, q4_matmul_i_planned(
            x, packed, scales, ilt, bias, round_planes, plan))
    if nt < 16:  # more rows than the plan's n-tiles hold: refused
        with pytest.raises(RuntimeError, match="CUDA error"):
            q4_matmul_i_planned(torch.zeros((8 * nt + 1, K), device=dev,
                                            dtype=torch.bfloat16), packed,
                                scales, ilt, bias, round_planes, plan)


@pytest.mark.parametrize("n", [1, 100])
def test_q4_matmul_i_unaligned_x(dev, n):
    """x that starts off a 16-byte boundary (rows of a larger tensor) is
    taken as it is by K9 and K10."""
    packed, scales = _weight(512, 256, dev, 5)
    big = torch.randn((n + 1, 513), device=dev).to(torch.bfloat16)
    x = big.reshape(-1)[1:1 + n * 512].reshape(n, 512)
    assert x.data_ptr() % 16
    ref = q4_matmul_i_plain(x, packed, scales)
    assert _rel(q4_matmul_i(x, packed, scales), ref) < 1e-4
    ilt = torch.tensor(0, dtype=torch.int32, device=dev)
    assert _rel(q4_matmul_stacked(x, packed[None], scales[None], ilt),
                ref) < 1e-4


def test_q4_matmul_refuses_a_gradient_it_cannot_carry(dev):
    """The Q4 kernels have no backward: a route that would launch one for
    an x that needs a gradient raises instead of dropping it."""
    from vsim_tpu_torch.ops.matmul import q4_matmul
    from vsim_tpu_torch.quant.q4 import Q4Tensor

    packed, scales = _weight(512, 256, dev, 0)
    x = torch.randn((4, 512), device=dev, requires_grad=True)
    for layout in ("i", "ps"):
        with pytest.raises(ValueError, match="no backward"):
            q4_matmul(x, Q4Tensor(packed, scales, layout))
    y = q4_matmul(x.detach(), Q4Tensor(packed, scales, "i"))
    assert y.shape == (4, 256)


def test_fused_mlp_refuses_a_gradient_it_cannot_carry(dev):
    """K11 has no backward either: mlp() off the gi math sends n <= 8 rows
    with plane-split weights to it, and an h that needs a gradient (or a
    bias that does) raises there instead of leaving y without a grad_fn."""
    from vsim_tpu_torch.models.config import ModelConfig
    from vsim_tpu_torch.models.transformer import mlp
    from vsim_tpu_torch.ops.q4_cuda import set_dequant_math
    from vsim_tpu_torch.quant.q4 import Q4Tensor

    E, F = 256, 512  # noqa: N806
    pfc, sfc = _weight(E, F, dev, 1)
    pproj, sproj = _weight(F, E, dev, 2)
    bfc = torch.zeros((F,), device=dev)
    args = (pfc, sfc, bfc, pproj, sproj, None, "gelu_exact")
    x = torch.randn((2, E), device=dev)
    with pytest.raises(ValueError, match="no backward"):
        q4_mlp_ps(x.requires_grad_(), *args)
    with pytest.raises(ValueError, match="no backward"):
        q4_mlp_ps(x.detach(), pfc, sfc, bfc.requires_grad_(), *args[3:])
    cfg = ModelConfig(arch="gptneox", n_vocab=64, n_ctx=16, n_embd=E,
                      n_head=2, n_layer=1, n_ff=F, activation="gelu_exact")
    lp = {"w_fc": Q4Tensor(pfc, sfc, "ps"), "w_proj": Q4Tensor(pproj, sproj,
                                                               "ps")}
    h = torch.randn((1, 2, E), device=dev, requires_grad=True)
    set_dequant_math("f32xf")
    try:
        with pytest.raises(ValueError, match="no backward"):
            mlp(cfg, lp, h)
        y = mlp(cfg, lp, h.detach())
    finally:
        set_dequant_math("gi")
    assert y.shape == (1, 2, E) and torch.isfinite(y).all()


@pytest.mark.parametrize("act", ["gelu_tanh", "relu", "gelu_exact"])
@pytest.mark.parametrize("n", [1, 3, 5, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q4_mlp_ps(dev, act, n, dtype):
    """K11 with bf16 x (one piece) and f32 x (three bf16 pieces; h is f32
    and split the same way), with and without biases, one launch count a
    call, the same bits from run to run."""
    E, F = 512, 1024  # noqa: N806
    pfc, sfc = _weight(E, F, dev, n + 3)
    pproj, sproj = _weight(F, E, dev, n + 4)
    x = torch.randn((n, E), device=dev).to(dtype)
    for bfc, bproj in ((None, None), (torch.randn((F,), device=dev),
                                      torch.randn((E,), device=dev))):
        before = _build.launch_counts["q4_mlp_ps"]
        got = q4_mlp_ps(x, pfc, sfc, bfc, pproj, sproj, bproj, act)
        assert _build.launch_counts["q4_mlp_ps"] == before + 1
        ref = q4_mlp_ps_plain(x, pfc, sfc, bfc, pproj, sproj, bproj, act)
        assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4
        # bit-identical from run to run: fixed sum orders, no atomics
        again = q4_mlp_ps(x, pfc, sfc, bfc, pproj, sproj, bproj, act)
        assert torch.equal(got, again)
    with pytest.raises(ValueError, match="F %"):
        q4_mlp_ps(x, pfc[:, :960].contiguous(), sfc[:, :960].contiguous(),
                  None, pproj[:480].contiguous(), sproj[:30].contiguous(),
                  None, act)


def test_q4_mlp_ps_wide_f32(dev):
    """K11 with f32 x of a wide dynamic range (|x| from 2^-20 to 2^20): the
    three-piece split keeps every product exact, so only the f32 sums
    differ from the plain version."""
    E, F = 1024, 2048  # noqa: N806
    pfc, sfc = _weight(E, F, dev, 11)
    pproj, sproj = _weight(F, E, dev, 12)
    g = torch.Generator(device=dev).manual_seed(3)
    mag = torch.exp2(torch.randint(-20, 21, (4, E), generator=g, device=dev)
                     .float())
    x = torch.randn((4, E), generator=g, device=dev) * mag
    got = q4_mlp_ps(x, pfc, sfc, None, pproj, sproj, None, "gelu_tanh")
    ref = q4_mlp_ps_plain(x, pfc, sfc, None, pproj, sproj, None, "gelu_tanh")
    assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4


def test_q4_kernels_reject_what_they_cannot_take(dev):
    packed, scales = _weight(96, 64, dev, 0)  # K % 64 != 0
    x = torch.randn((1, 96), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        q4_gemv_ps(x, packed, scales)
    packed, scales = _weight(128, 64, dev, 0)
    with pytest.raises(ValueError, match="x dtype"):
        q4_gemv_ps(x.new_zeros((1, 128), dtype=torch.float32), packed, scales)


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_decode_attention_q(dev, kv, D):
    """K3's split-S at the edges of its plan: ragged n_past on 0, a split
    boundary - 1, the boundary and S - 1 (int4 D=80 has Dp = 40, loaded 8
    bytes a lane), with and without ALiBi, one launch a call, and the same
    bits from run to run (an in-order combine, no atomics)."""
    L, B, H, S = 2, 4, 4, 700  # noqa: N806
    c, n_split = decode_split_plan(
        B, H, S, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert n_split > 1
    g = torch.Generator(device=dev).manual_seed(D)
    Dp = D // 2 if kv == "int4" else D  # noqa: N806
    k, v = (_kv_side(dev, g, kv, (L, B, H, S, Dp)) for _ in range(2))
    q = torch.randn((B, H, D), generator=g, device=dev)
    n_past = torch.tensor([0, c - 1, c, S - 1], dtype=torch.int32,
                          device=dev)
    slopes = torch.linspace(0.01, 0.1, H, device=dev)
    for sl in (None, slopes):
        before = _build.launch_counts["decode_attention"]
        got = decode_attention_q(q, k, v, 1, n_past, scale=D ** -0.5,
                                 slopes=sl)
        assert _build.launch_counts["decode_attention"] == before + 1
        ref = decode_attention_plain(q, k, v, 1, n_past, scale=D ** -0.5,
                                     slopes=sl)
        assert torch.isfinite(got).all()
        assert _rel(got, ref) < 1e-3
        again = decode_attention_q(q, k, v, 1, n_past, scale=D ** -0.5,
                                   slopes=sl)
        assert torch.equal(got, again)


def _kv_side(dev, g, kv, shape):
    """Random int8 or plane-packed int4 values of ``shape`` and bf16
    scales of ``shape[:-1]``."""
    lo, hi, vdt = ((0, 256, torch.uint8) if kv == "int4"
                   else (-127, 128, torch.int8))
    vals = torch.randint(lo, hi, shape, generator=g, device=dev, dtype=vdt)
    sc = (torch.rand(shape[:-1], generator=g, device=dev) * 0.05).to(
        torch.bfloat16)
    return vals, sc


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_decode_attention_fresh(dev, kv, D):
    """K5's split-S at the edges of its plan: ragged n_past on 0 (the fresh
    row alone), 1, a split boundary - 1, the boundary, S - 1 and S (the
    inactive-slot sentinel, all S rows), with and without ALiBi (the fresh
    row's at position n_past), one launch a call, and the same bits from run
    to run (an in-order combine, no atomics)."""
    L, B, H, S = 2, 6, 4, 700  # noqa: N806
    c, n_split = decode_split_plan(
        B, H, S, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert n_split > 1
    g = torch.Generator(device=dev).manual_seed(D + 1)
    Dp = D // 2 if kv == "int4" else D  # noqa: N806
    k, v = (_kv_side(dev, g, kv, (L, B, H, S, Dp)) for _ in range(2))
    rows = (*_kv_side(dev, g, kv, (B, H, Dp)),
            *_kv_side(dev, g, kv, (B, H, Dp)))
    q = torch.randn((B, H, D), generator=g, device=dev)
    n_past = torch.tensor([0, 1, c - 1, c, S - 1, S], dtype=torch.int32,
                          device=dev)
    slopes = torch.linspace(0.01, 0.1, H, device=dev)
    for sl in (None, slopes):
        kw = dict(scale=D ** -0.5, slopes=sl)
        before = _build.launch_counts["decode_attention_fresh"]
        got = decode_attention_fresh(q, k, v, 1, n_past, rows, **kw)
        assert _build.launch_counts["decode_attention_fresh"] == before + 1
        ref = decode_attention_fresh_plain(q, k, v, 1, n_past, rows, **kw)
        assert torch.isfinite(got).all()
        assert _rel(got, ref) < 1e-3
        assert torch.equal(got, decode_attention_fresh(q, k, v, 1, n_past,
                                                       rows, **kw))


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", [64, 80, 96])
def test_decode_attention_f32_q(dev, kv, D):
    """K3 and K5 with ``round_q=False`` (q read in f32, the einsum route's
    numerics the model keeps where D % 128 != 0) against their plain
    versions under the same flag, the same bits from run to run, and not
    the bf16-q instance's output."""
    L, B, H, S = 2, 4, 4, 700  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(D + 2)
    Dp = D // 2 if kv == "int4" else D  # noqa: N806
    k, v = (_kv_side(dev, g, kv, (L, B, H, S, Dp)) for _ in range(2))
    rows = (*_kv_side(dev, g, kv, (B, H, Dp)),
            *_kv_side(dev, g, kv, (B, H, Dp)))
    q = torch.randn((B, H, D), generator=g, device=dev)
    n_past = torch.tensor([0, 63, 64, S - 1], dtype=torch.int32, device=dev)
    kw = dict(scale=D ** -0.5, slopes=torch.linspace(0.01, 0.1, H,
                                                     device=dev))
    for fn, plain, args in (
            (decode_attention_q, decode_attention_plain, ()),
            (decode_attention_fresh, decode_attention_fresh_plain, (rows,))):
        got = fn(q, k, v, 1, n_past, *args, round_q=False, **kw)
        ref = plain(q, k, v, 1, n_past, *args, round_q=False, **kw)
        assert torch.isfinite(got).all()
        assert _rel(got, ref) < 1e-3
        assert torch.equal(got, fn(q, k, v, 1, n_past, *args, round_q=False,
                                   **kw))
        assert not torch.equal(got, fn(q, k, v, 1, n_past, *args, **kw))


def test_decode_attention_refuses_a_gradient_it_cannot_carry(dev):
    """K3 and K5 have no backward: a q (or fresh-row scale) that needs a
    gradient raises on the card instead of leaving the output without a
    grad_fn; the plain versions on the CPU stay differentiable."""
    L, B, H, S, D = 1, 2, 2, 64, 64  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(3)
    k, v = (_kv_side(dev, g, "int8", (L, B, H, S, D)) for _ in range(2))
    rows = (*_kv_side(dev, g, "int8", (B, H, D)),
            *_kv_side(dev, g, "int8", (B, H, D)))
    n_past = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        decode_attention_q(q, k, v, 0, n_past, scale=0.125)
    with pytest.raises(ValueError, match="no backward"):
        decode_attention_fresh(q, k, v, 0, n_past, rows, scale=0.125)
    grad_rows = (rows[0], rows[1].clone().requires_grad_(), *rows[2:])
    with pytest.raises(ValueError, match="no backward"):
        decode_attention_fresh(q.detach(), k, v, 0, n_past, grad_rows,
                               scale=0.125)
    assert decode_attention_q(q.detach(), k, v, 0, n_past,
                              scale=0.125).shape == (B, H, D)
    cpu = [t.cpu() for t in (*k, *v, *rows, n_past)]
    qc = q.detach().cpu().requires_grad_()
    out = decode_attention_fresh(qc, tuple(cpu[:2]), tuple(cpu[2:4]), 0,
                                 cpu[8], tuple(cpu[4:8]), scale=0.125)
    out.square().sum().backward()
    assert qc.grad is not None and qc.grad.abs().max() > 0


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", [20, 256])  # Dp % 16 != 0: the byte copy
@pytest.mark.parametrize("H", [2, 16])
def test_scatter_rows(dev, kv, D, H):
    L, B, S = 3, 4, 200  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(D + 2)
    Dp = D // 2 if kv == "int4" else D  # noqa: N806
    k, v = (_kv_side(dev, g, kv, (L, B, H, S, Dp)) for _ in range(2))
    rows = (*_kv_side(dev, g, kv, (L, B, H, Dp)),
            *_kv_side(dev, g, kv, (L, B, H, Dp)))
    n_past = torch.tensor([0, 77, S - 1, S], dtype=torch.int32, device=dev)
    k_ref, v_ref = (tuple(t.clone() for t in side) for side in (k, v))
    before = _build.launch_counts["scatter_rows"]
    scatter_rows(k, v, rows, n_past)
    scatter_rows_plain(k_ref, v_ref, rows, n_past)
    assert _build.launch_counts["scatter_rows"] == before + 1
    for got, ref in zip((*k, *v), (*k_ref, *v_ref)):
        assert torch.equal(got, ref)
    assert torch.equal(k[0][:, 1, :, 77], rows[0][:, 1])


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D,H", [(20, 2), (256, 16), (128, 40)])
@pytest.mark.parametrize("il", [0, 2])
def test_scatter_rows_one_layer(dev, kv, D, H, il):
    """The graphed one-token step's write: layer il byte for byte as the
    plain version's, every other layer untouched, n_past = S and < 0
    writing nothing."""
    L, B, S = 3, 5, 200  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(D + H + il)
    Dp = D // 2 if kv == "int4" else D  # noqa: N806
    k, v = (_kv_side(dev, g, kv, (L, B, H, S, Dp)) for _ in range(2))
    rows = (*_kv_side(dev, g, kv, (B, H, Dp)), *_kv_side(dev, g, kv, (B, H, Dp)))
    n_past = torch.tensor([0, 77, S - 1, S, -2], dtype=torch.int32,
                          device=dev)
    k_ref, v_ref = (tuple(t.clone() for t in side) for side in (k, v))
    k_before, v_before = (tuple(t.clone() for t in side) for side in (k, v))
    before = _build.launch_counts["scatter_rows"]
    scatter_rows(k, v, rows, n_past, il)
    scatter_rows_plain(k_ref, v_ref, rows, n_past, il)
    assert _build.launch_counts["scatter_rows"] == before + 1
    untouched = [i for i in range(L) if i != il]
    for got, ref, b4 in zip((*k, *v), (*k_ref, *v_ref),
                            (*k_before, *v_before)):
        assert torch.equal(got, ref)
        assert torch.equal(got[untouched], b4[untouched])
        assert torch.equal(got[:, 3:], b4[:, 3:])
    assert torch.equal(k[0][il, 1, :, 77], rows[0][1])
    assert torch.equal(v[1][il, 2, :, S - 1], rows[3][2])


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("D", [64, 72, 80, 96, 128, 256])
@pytest.mark.parametrize("T", [1, 63, 65, 300])
def test_flash_attention_fwd(dev, dtype, tol, D, T):
    """K4 at the edges of both instances (``flash_attention_fwd_route``:
    "mma_bf16", "mma_3xtf32"): head dims padded in shared memory (72 to
    80), query counts around a tile, n_past = 0 with S = T and n_past > 0
    with key rows no query sees (S > n_past + T), ALiBi, lse, one launch a
    call, and the same bits from run to run; n_past = -5 leaves the first
    five rows no key: out 0 and lse -FLT_MAX there."""
    B, H = 2, 3  # noqa: N806
    want = {torch.bfloat16: "mma_bf16", torch.float32: "mma_3xtf32"}[dtype]
    assert flash_attention_fwd_route(dtype, D) == want
    g = torch.Generator(device=dev).manual_seed(D * T)
    slopes = torch.linspace(0.01, 0.1, H, device=dev)
    for n_past, extra in ((0, 0), (17, 9), (-5, 8)):
        S = max(n_past, 0) + T + extra  # noqa: N806
        q = torch.randn((B, H, T, D), generator=g, device=dev).to(dtype)
        k = torch.randn((B, H, S, D), generator=g, device=dev).to(dtype)
        v = torch.randn((B, H, S, D), generator=g, device=dev).to(dtype)
        kw = dict(n_past=n_past, scale=1 / math.sqrt(D), slopes=slopes)
        before = _build.launch_counts["flash_attention"]
        out, lse = flash_attention_fwd(q, k, v, **kw)
        assert _build.launch_counts["flash_attention"] == before + 1
        ref, lse_ref = flash_attention_plain(q, k, v, **kw)
        assert out.dtype == dtype and torch.isfinite(out).all()
        assert _rel(out, ref) < tol
        blind = max(0, min(-n_past, T))  # rows that see no key
        assert not out[:, :, :blind].any()
        assert (lse[:, :, :blind] == NEG_INF).all()
        if blind < T:
            assert _rel(lse[:, :, blind:], lse_ref[:, :, blind:]) < 1e-4
        again, lse2 = flash_attention_fwd(q, k, v, **kw)
        assert torch.equal(out, again) and torch.equal(lse, lse2)


def _bf16_checks(got, ref):
    """"mma_bf16"'s element and share checks (chip_smoke.py phase 2): no
    element of dq, dk, dv more than 2^-8 of its max|plain| from the plain
    version, and at most 2% of all their bf16 elements differing from it."""
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 2.0 ** -8
    differ = sum((a != b).sum().item() for a, b in zip(got, ref))
    assert differ <= 0.02 * sum(b.numel() for b in ref)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("D", [64, 80, 96, 128, 256, 112, 72])
@pytest.mark.parametrize("T,n_past,S,alibi", [(100, 0, 100, False),
                                              (70, 37, 107, True),
                                              (40, 0, 130, True),
                                              (300, 0, 300, False),
                                              (300, 0, 300, True),
                                              (200, 100, 300, True)])
def test_flash_attention_bwd(dev, dtype, tol, D, T, n_past, S, alibi):
    """K7/K8 against the plain backward, on all three instances
    (``flash_attention_bwd_route``): "mma_3xtf32" for f32 at every D (64
    and 128 in their own kernels; 80, 96, 256, and 112 and 72 zero-padded
    to 128 and 80, in the padded ones), "mma_bf16" for bf16 at D % 16 == 0
    (112 padded to 128 in shared memory), "fma" for bf16 at 72.  (40, 0,
    130) has key rows no query sees (S > n_past + T), which must come back
    as zeros; the last three span several blocks and streamed tiles a
    side.  "mma_bf16" also holds the element and share checks of
    chip_smoke.py's phase 2."""
    B, H = 2, 3  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(D + T)
    q = torch.randn((B, H, T, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, H, S, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, H, S, D), generator=g, device=dev).to(dtype)
    do = torch.randn((B, H, T, D), generator=g, device=dev).to(dtype)
    slopes = torch.linspace(0.01, 0.1, H, device=dev) if alibi else None
    kw = dict(n_past=n_past, scale=1 / math.sqrt(D), slopes=slopes)
    route = flash_attention_bwd_route(dtype, D)
    assert route == ("mma_3xtf32" if dtype == torch.float32 else "mma_bf16"
                     if D % 16 == 0 else "fma")
    out, lse = flash_attention_fwd(q, k, v, **kw)
    before = dict(_build.launch_counts)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert _build.launch_counts[name] == before.get(name, 0) + 1
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for a, b in zip(got, ref):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert _rel(a, b) < tol
    if route == "mma_bf16":
        _bf16_checks(got, ref)
    for a in got[1:]:
        assert not a[:, :, n_past + T:].any()
    # bit-identical from run to run: two passes, no atomics
    again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # rows that saw no key (lse = NEG_INF) give p = 0, never exp(0) = 1
    lse[:, :, [0, T // 2]] = NEG_INF
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    assert not got[0][:, :, [0, T // 2]].any()
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all() and _rel(a, b) < tol
    if route == "mma_bf16":
        _bf16_checks(got, ref)


def test_flash_attention_bwd_refuses_a_missing_instance(dev):
    """The launcher refuses an instance that does not exist for (dtype,
    D): "mma_bf16" for f32 or for a head dim not a multiple of 16,
    "mma_3xtf32" for bf16, "fma" for f32 (its f32 tiles are gone); it never
    substitutes another."""
    from vsim_tpu_torch.ops.attention import _INSTANCES, _BWD_DQ_ARGS

    for dtype, D, inst in ((torch.float32, 64, "mma_bf16"),  # noqa: N806
                           (torch.bfloat16, 72, "mma_bf16"),
                           (torch.bfloat16, 64, "mma_3xtf32"),
                           (torch.float32, 256, "fma")):
        q, k, v, do = (torch.randn((1, 1, 32, D), device=dev).to(dtype)
                       for _ in range(4))
        lse, dsum = (torch.zeros((1, 1, 32), device=dev) for _ in range(2))
        dq = torch.empty_like(q)
        p = _build.ptr
        err = _build.function("flash_attention_bwd_dq",
                              "flash_attention_bwd_dq_launch",
                              _BWD_DQ_ARGS)(
            p(q), p(k), p(v), p(do), p(lse), p(dsum), p(dq), p(None),
            int(dtype == torch.bfloat16), _INSTANCES[inst], 1, 1, 32, 32, D,
            0, 0.125, _build.stream_ptr(dev))
        assert err != 0, (dtype, D, inst)


def test_flash_attention_function_on_card(dev):
    """Gradients through the differentiable entry reach q, k and v."""
    q, k, v = (torch.randn((1, 2, 50, 64), device=dev, requires_grad=True)
               for _ in range(3))
    out = flash_attention(q, k, v, scale=0.125)
    out.square().sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and t.grad.abs().max() > 0
