"""The kernels tensor-parallel serving runs, on the card, at the shapes one
rank of GPT-J-6B gives them (tp = 2 and 4), against their plain PyTorch
versions; and the gloo rule of ``ServingEngine(mesh=...)``.

Marked ``cuda``: each test skips without a CUDA device (decided in the
fixture).  On the card, without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_parallel.py -q

K10 (stacked, 8 rows, bf16 x, both plane contracts) at wo / proj's K/tp
and qkv / fc's O/tp, K9 on the lm head's 51200/tp rows (1e-4 of
max|plain|); K5 over H/tp heads at ragged n_past, the sentinel included
(1e-3); K6's all-layer write over H/tp heads (exact).
"""

import datetime

import pytest
import torch
import torch.distributed as dist

from vsim_tpu_torch.engine.serving import ServingEngine
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import random_q4_params
from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.decode_attention import (
    decode_attention_fresh,
    decode_attention_fresh_plain,
    scatter_rows,
    scatter_rows_plain,
)
from vsim_tpu_torch.ops.q4_cuda import (
    q4_matmul_i,
    q4_matmul_i_plain,
    q4_matmul_stacked,
    q4_matmul_stacked_plain,
)
from vsim_tpu_torch.parallel.mesh import Mesh

pytestmark = pytest.mark.cuda

TP = [2, 4]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _weight(lead, K, O, dev, seed):  # noqa: N803
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(0, 256, (*lead, K // 2, O), generator=g,
                          device=dev, dtype=torch.uint8),
            (torch.rand((*lead, K // 32, O), generator=g, device=dev)
             * 0.01).to(torch.bfloat16))


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("name", ["qkv", "wo", "fc", "proj"])
@pytest.mark.parametrize("round_planes", [False, True])
def test_k10_at_gptj_shard_shapes(dev, tp, name, round_planes):
    K, O = {"qkv": (4096, 12288 // tp), "wo": (4096 // tp, 4096),  # noqa: N806
            "fc": (4096, 16384 // tp), "proj": (16384 // tp, 4096)}[name]
    packed, scales = _weight((2,), K, O, dev, K + O)
    x = torch.randn((8, K), device=dev).to(torch.bfloat16)
    il = torch.tensor(1, dtype=torch.int32, device=dev)
    bias = torch.randn((O,), device=dev) if name == "fc" else None
    before = _build.launch_counts["q4_matmul_stacked"]
    got = q4_matmul_stacked(x, packed, scales, il, bias, round_planes)
    assert _build.launch_counts["q4_matmul_stacked"] == before + 1
    ref = q4_matmul_stacked_plain(x, packed, scales, il, bias, round_planes)
    assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("n", [1, 8])
def test_k9_at_gptj_lm_head_shard(dev, tp, n):
    packed, scales = _weight((), 4096, 51200 // tp, dev, tp)
    x = torch.randn((n, 4096), device=dev).to(torch.bfloat16)
    bias = torch.randn((51200 // tp,), device=dev)
    got = q4_matmul_i(x, packed, scales, bias)
    ref = q4_matmul_i_plain(x, packed, scales, bias)
    assert torch.isfinite(got).all() and _rel(got, ref) < 1e-4


def _side(g, dev, shape):
    return (torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8),
            (torch.rand(shape[:-1], generator=g, device=dev) * 0.05).to(
                torch.bfloat16))


N_PAST = [0, 1, 127, 128, 300, 1500, 2047, 2048]


@pytest.mark.parametrize("tp", TP)
def test_k5_over_shard_heads(dev, tp):
    B, H, S, D = 8, 16 // tp, 2048, 256  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(tp)
    k, v = _side(g, dev, (2, B, H, S, D)), _side(g, dev, (2, B, H, S, D))
    rows = (*_side(g, dev, (B, H, D)), *_side(g, dev, (B, H, D)))
    q = torch.randn((B, H, D), generator=g, device=dev)
    npv = torch.tensor(N_PAST, dtype=torch.int32, device=dev)
    kw = dict(scale=D ** -0.5, round_q=True)
    got = decode_attention_fresh(q, k, v, 1, npv, rows, **kw)
    ref = decode_attention_fresh_plain(q, k, v, 1, npv, rows, **kw)
    assert torch.isfinite(got).all() and _rel(got, ref) < 1e-3


@pytest.mark.parametrize("tp", TP)
def test_k6_over_shard_heads(dev, tp):
    L, B, H, S, D = 28, 8, 16 // tp, 256, 256  # noqa: N806
    g = torch.Generator(device=dev).manual_seed(10 + tp)
    k, v = _side(g, dev, (L, B, H, S, D)), _side(g, dev, (L, B, H, S, D))
    new = (*_side(g, dev, (L, B, H, D)), *_side(g, dev, (L, B, H, D)))
    npv = torch.tensor([0, 5, 77, 128, 200, 254, 255, 256],
                       dtype=torch.int32, device=dev)
    k_ref, v_ref = (tuple(t.clone() for t in st) for st in (k, v))
    scatter_rows(k, v, new, npv)
    scatter_rows_plain(k_ref, v_ref, new, npv)
    for got, ref in zip((*k, *v), (*k_ref, *v_ref)):
        assert torch.equal(got, ref)


def test_graphed_tp_engine_on_gloo_raises(dev, tmp_path):
    """``cuda_graph=True`` over a gloo group raises: gloo's collectives go
    through the host, which a graph cannot capture."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        world = dist.group.WORLD
        mesh = Mesh(("data", "model"), (1, 2), groups=(world, world),
                    device=dev)
        cfg = ModelConfig(arch="gptneox", n_vocab=256, n_ctx=32,
                          n_embd=128, n_head=8, n_layer=2, n_ff=256, n_rot=8)
        params = random_q4_params(cfg, device=dev)
        with pytest.raises(ValueError, match="gloo"):
            ServingEngine(cfg, params, mesh=mesh, cuda_graph=True)
    finally:
        dist.destroy_process_group()
