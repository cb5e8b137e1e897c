"""Port vs JAX package: the attention lab (vsim_tpu_torch/ops/attn_lab.py,
K16) against tools/attn_lab.py:variant_call, run in interpret mode (``pl``
of the tool's module is swapped for a namespace whose ``pallas_call``
passes ``interpret=True``) and compiled with XLA's excess precision off
(mxu rounds p·vs to bf16 in the body).

  * K16's plain version under vpu3d and mxu against ``variant_call`` with
    the tool's block_s = min(128, S), L = 2, B = 3, H = 4, S = 256, D = 64,
    layer 1 read from a device index, ragged n_past at the tile edges
    ([0, 127, 128]) and inside them ([5, 200, 255]): 1e-5 of max|JAX| for
    both (the plain version walks the body's tiles in order, so mxu's
    rounding of p·vs sees the same running max);
  * vpu3d against the port's K3 plain version (the same function) at 1e-5;
  * the tool's entry point, on the CPU at a cut depth.

The tests marked ``cuda`` hold K16 against its plain version on the card at
ragged n_past including S − 1 (and against a second run, bit for bit),
under every plan (4- and 8-warp blocks, clusters 1–8,
``attn_lab_planned``) at head widths 64, 72, 128 and 256, hold mxu at GPT-J-6B's widths over six caches to 1e-5 of its
plain version and ten times nearer it than vpu3d's, check the planner's
picks (one block a head at one tile, more at Pythia-12B's 40 heads over
2048 rows), and refuse a layer index or n_past left on the CPU; they need
no JAX:

    python -m pytest --noconftest tests/test_torch_attn_lab.py -q -m cuda
"""

import functools
import importlib
import types

import numpy as np
import pytest
import torch

from vsim_tpu_torch.ops import attn_lab as al
from vsim_tpu_torch.ops.decode_attention import decode_attention_plain
from vsim_tpu_torch.tools import attn_lab as t_attn_lab

L, B, H, S, D = 2, 3, 4, 256, 64
TOL = 1e-5
NO_EXCESS = {"xla_allow_excess_precision": False}
N_PAST = ([0, 127, 128], [5, 200, 255])


@pytest.fixture
def jx(monkeypatch):
    names = ("jax", "jax.numpy", "jax.experimental.pallas", "tools.attn_lab")
    m = types.SimpleNamespace(**{n.split(".")[-1]: importlib.import_module(n)
                                 for n in names})
    m.jnp = m.numpy
    shim = types.SimpleNamespace(**{k: getattr(m.pallas, k)
                                    for k in dir(m.pallas)
                                    if not k.startswith("__")})
    shim.pallas_call = functools.partial(m.pallas.pallas_call, interpret=True)
    monkeypatch.setattr(m.attn_lab, "pl", shim)
    return m


def _bf16_np(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _inputs(seed=0, s=S):
    """q (bf16 values as f32), int8 caches and bf16 scales (as f32), numpy."""
    rng = np.random.default_rng(seed)
    q = _bf16_np(rng.standard_normal((B, H, D)))
    kq = rng.integers(-127, 127, (L, B, H, s, D), dtype=np.int8)
    vq = rng.integers(-127, 127, (L, B, H, s, D), dtype=np.int8)
    ks = _bf16_np(0.01 + rng.random((L, B, H, s)) * 0.1)
    vs = _bf16_np(0.01 + rng.random((L, B, H, s)) * 0.1)
    return q, kq, ks, vq, vs


def _torch(q, kq, ks, vq, vs, device="cpu"):
    bf = torch.bfloat16
    return tuple(t.to(device) for t in (
        torch.from_numpy(q).to(bf), torch.from_numpy(kq),
        torch.from_numpy(ks).to(bf), torch.from_numpy(vq),
        torch.from_numpy(vs).to(bf)))


def _jax(jx, variant, q, kq, ks, vq, vs, il, n_past):
    jnp = jx.jnp
    bf = jnp.bfloat16
    fn = functools.partial(jx.attn_lab.variant_call, variant=variant,
                           scale=D ** -0.5, block_s=min(128, S))
    args = (jnp.asarray([il], jnp.int32), jnp.asarray(n_past, jnp.int32),
            jnp.asarray(q, bf), jnp.asarray(kq), jnp.asarray(ks, bf),
            jnp.asarray(vq), jnp.asarray(vs, bf))
    return np.array(jx.jax.jit(fn).lower(*args).compile(
        compiler_options=NO_EXCESS)(*args), np.float32)


@pytest.mark.parametrize("n_past", N_PAST)
@pytest.mark.parametrize("variant", al.ATTN_VARIANTS)
def test_attn_lab_matches_jax(jx, variant, n_past):
    inp = _inputs()
    ref = _jax(jx, variant, *inp, 1, n_past)
    got = al.attn_lab(*_torch(*inp), torch.tensor([1], dtype=torch.int32),
                      torch.tensor(n_past, dtype=torch.int32), variant,
                      D ** -0.5)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("n_past", N_PAST)
def test_vpu3d_is_k3s_function(n_past):
    q, kq, ks, vq, vs = _torch(*_inputs(seed=1))
    npt = torch.tensor(n_past, dtype=torch.int32)
    got = al.attn_lab(q, kq, ks, vq, vs, torch.tensor([1], dtype=torch.int32),
                      npt, "vpu3d", D ** -0.5)
    ref = decode_attention_plain(q, (kq, ks), (vq, vs), 1, npt,
                                 scale=D ** -0.5)
    assert (got - ref).abs().max() <= TOL * ref.abs().max()


def test_mxu_rounds_p_vs_where_vpu3d_does_not():
    inp = _torch(*_inputs(seed=2))
    il = torch.tensor([0], dtype=torch.int32)
    npt = torch.tensor([255, 255, 255], dtype=torch.int32)
    a = al.attn_lab(*inp, il, npt, "vpu3d", D ** -0.5)
    b = al.attn_lab(*inp, il, npt, "mxu", D ** -0.5)
    assert not torch.equal(a, b)
    assert (a - b).abs().max() <= 1e-2 * a.abs().max()


def test_attn_lab_raises_on_what_it_does_not_take():
    q, kq, ks, vq, vs = _torch(*_inputs())
    il = torch.tensor([0], dtype=torch.int32)
    npt = torch.tensor([1, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        al.attn_lab(q, kq, ks, vq, vs, il, npt, "xla", 0.1)
    with pytest.raises(ValueError, match="il"):
        al.attn_lab(q, kq, ks, vq, vs, 0, npt, "vpu3d", 0.1)
    with pytest.raises(ValueError, match="n_past"):
        al.attn_lab(q, kq, ks, vq, vs, il, npt.long(), "vpu3d", 0.1)
    with pytest.raises(ValueError, match="bf16"):
        al.attn_lab(q.float(), kq, ks, vq, vs, il, npt, "vpu3d", 0.1)
    with pytest.raises(ValueError, match="int8"):
        al.attn_lab(q, kq.to(torch.uint8), ks, vq, vs, il, npt, "vpu3d", 0.1)


def test_attn_lab_entry_point_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--batch", "2", "--kv-len", "160", "--layers", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_attn_lab.main(args)
    rows = t_attn_lab.main(args + ["--device", "cpu", "--model",
                                   "pythia-70m"])
    assert [r["variant"] for r in rows] == list(t_attn_lab.VARIANTS)
    assert all(r["ms"] is None for r in rows)
    assert all(r["rel_err"] == 0.0 for r in rows if r["variant"] != "xla")
    with pytest.raises(ValueError, match="unknown variants"):
        t_attn_lab.run("pythia-70m", 2, 16, ("sdpa",), "cpu", layers=1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,n_past", [(256, [0, 127, 128]),
                                      (256, [5, 200, 255]),
                                      (2048, [2047, 1500, 128]),
                                      (100, [99, 0, 50])])
@pytest.mark.parametrize("variant", al.ATTN_VARIANTS)
def test_attn_lab_on_card(card, variant, s, n_past):
    inp = _torch(*_inputs(seed=3, s=s), device=card)
    il = torch.tensor([1], dtype=torch.int32, device=card)
    npt = torch.tensor(n_past, dtype=torch.int32, device=card)
    got = al.attn_lab(*inp, il, npt, variant, D ** -0.5)
    ref = al.attn_lab_plain(*inp, il, npt, variant, D ** -0.5)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= al.TOL_ATTN[variant] * ref.abs().max()
    assert torch.equal(got, al.attn_lab(*inp, il, npt, variant, D ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_mxu_kernel_keeps_its_rounding_on_card(card, seed):
    """At GPT-J-6B's head widths and 2048 keys, over several caches: mxu's
    kernel within 1e-5 of its plain version, and at least MXU_SEPARATION
    times nearer it than vpu3d's plain version (a kernel that skipped the
    rounding of p·vs would sit as near vpu3d's)."""
    c = t_attn_lab.make_cache(1, 8, 16, 2048, 256, seed, card)
    kv = (c["k_q"], c["k_s"], c["v_q"], c["v_s"])
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    q = torch.randn((8, 16, 256), generator=g, device=card).to(torch.bfloat16)
    il = torch.tensor([0], dtype=torch.int32, device=card)
    npt = torch.tensor([2047, 2046, 1500, 1024, 700, 255, 128, 0],
                       dtype=torch.int32, device=card)
    got = al.attn_lab(q, *kv, il, npt, "mxu", 256 ** -0.5)
    ref = al.attn_lab_plain(q, *kv, il, npt, "mxu", 256 ** -0.5)
    far = al.attn_lab_plain(q, *kv, il, npt, "vpu3d", 256 ** -0.5)
    err = (got - ref).abs().max().item()
    assert err <= al.TOL_ATTN["mxu"] * ref.abs().max().item()
    assert err * al.MXU_SEPARATION <= (got - far).abs().max().item()


@pytest.mark.cuda
def test_attn_lab_refuses_host_indices_on_card(card):
    inp = _torch(*_inputs(), device=card)
    il = torch.tensor([1], dtype=torch.int32)
    npt = torch.tensor([1, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="il must be contiguous on"):
        al.attn_lab(*inp, il, npt.to(card), "vpu3d", 0.1)
    with pytest.raises(ValueError, match="n_past must be contiguous on"):
        al.attn_lab(*inp, il.to(card), npt, "vpu3d", 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 72, 128, 256])
@pytest.mark.parametrize("threads", al.ATTN_THREADS)
@pytest.mark.parametrize("cluster", range(1, al.ATTN_MAX_CLUSTER + 1))
@pytest.mark.parametrize("variant", al.ATTN_VARIANTS)
def test_attn_lab_every_cluster_on_card(card, variant, cluster, threads, d):
    """Every plan the planner can pick (both block sizes, clusters 1-8),
    forced through ``attn_lab_planned``, at head widths with 16-byte rows
    (64, 128, 256)
    and without (72), over 1100 rows (nine tiles, the last partial) with
    n_past in the first tile, at a tile edge, at S − 1 and past whole
    ranks: within TOL_ATTN of the plain version, the same bits run to
    run."""
    c = t_attn_lab.make_cache(2, 4, 3, 1100, d, cluster, card)
    kv = (c["k_q"], c["k_s"], c["v_q"], c["v_s"])
    g = torch.Generator(device=card)
    g.manual_seed(d)
    q = torch.randn((4, 3, d), generator=g, device=card).to(torch.bfloat16)
    il = torch.tensor([1], dtype=torch.int32, device=card)
    npt = torch.tensor([5, 127, 1099, 300], dtype=torch.int32, device=card)
    plan = (threads, cluster)
    got = al.attn_lab_planned(q, *kv, il, npt, variant, d ** -0.5, plan)
    ref = al.attn_lab_plain(q, *kv, il, npt, variant, d ** -0.5)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= al.TOL_ATTN[variant] * ref.abs().max()
    assert torch.equal(got, al.attn_lab_planned(q, *kv, il, npt, variant,
                                                d ** -0.5, plan))


@pytest.mark.cuda
def test_attn_lab_plans_on_card(card):
    """The planner's picks on this card: one block a head at one tile, a
    cluster of more than one at Pythia-12B's B=1 x 2048 (40 heads)."""
    assert al.attn_lab_plan(card, 32, 16, 128, 256, "vpu3d")[1] == 1
    assert al.attn_lab_plan(card, 1, 40, 2048, 128, "mxu")[1] > 1
    with pytest.raises(ValueError, match="does not take"):
        inp = _torch(*_inputs(), device=card)
        al.attn_lab_planned(*inp, torch.tensor([1], dtype=torch.int32,
                                               device=card),
                            torch.tensor([1, 2, 3], dtype=torch.int32,
                                         device=card), "vpu3d", 0.1,
                            (128, 9))
