"""K16's cluster split (csrc/attn_lab.cu) emulated in PyTorch on the CPU,
against the in-order walk of the TPU body.

The kernel gives each (b, h) a cluster of C blocks; rank r owns a run of
ceil(tiles / C) key tiles.  Its steps, emulated here tile by tile:

  (a) the tiles' scores (mxu: the exact dot in f64, rounded once) and each
      tile's maximum;
  (b) each rank's maximum over its live tiles; the earlier ranks' maxima,
      then the rank's own tile maxima in order, give each tile's m_j;
  (c) p = exp(s − m_j), p·vs (bf16 for mxu), the tile's l_j and its
      value sum, and alpha_j = exp(m_{j−1} − m_j) (0 after no live tile);
  (d) each rank folds its tiles from zero (acc = alpha_j acc + pv_j), and
      the ranks meet in order, each earlier total scaled by the rank's
      alpha_j one by one, plus the rank's partial.

Checked at splits 1, 2, 3, 8 and 16 over S = 1100 (nine tiles, the last
partial) with n_past in the first tile (5), at a tile edge (127, 128), at
S − 1 and past whole ranks' ranges (300):

  * mxu's bf16(p·vs) of every live tile equals the in-order walk's bit for
    bit (so do vpu3d's f32 p·vs);
  * the output lies within ``TOL_ATTN`` of ``attn_lab_plain`` and of
    tools/attn_lab.py:variant_call, run in interpret mode as
    tests/test_torch_attn_lab.py runs it;
  * ``attn_plan`` takes one block a head at one tile, clusters of eight
    4-warp blocks at Pythia-12B's 40 heads over 2048 rows, one wave where
    one exists, never more tiles a block than the kernel holds, and raises
    where no cluster takes S.
"""

import functools
import importlib
import types

import numpy as np
import pytest
import torch

from vsim_tpu_torch.ops import attn_lab as al

L, B, H, S, D = 2, 5, 2, 1100, 64
N_PAST = [5, 127, 128, S - 1, 300]
SPLITS = (1, 2, 3, 8, 16)
NEG = al.NEG_INF
NO_EXCESS = {"xla_allow_excess_precision": False}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    q = bf16(rng.standard_normal((B, H, D)))
    kq = torch.from_numpy(rng.integers(-127, 127, (L, B, H, S, D),
                                       dtype=np.int8))
    vq = torch.from_numpy(rng.integers(-127, 127, (L, B, H, S, D),
                                       dtype=np.int8))
    ks = bf16(0.01 + rng.random((L, B, H, S)) * 0.1)
    vs = bf16(0.01 + rng.random((L, B, H, S)) * 0.1)
    return (q, kq, ks, vq, vs, torch.tensor([1], dtype=torch.int32),
            torch.tensor(N_PAST, dtype=torch.int32))


def _layer(q, kq, ks, vq, vs, il):
    lay = int(il.item())
    return (q.float(), kq[lay].float(), ks[lay].float(), vq[lay].float(),
            vs[lay].float())


def _tile_scores(qf, kq, ks, n_past, s0, s1, variant, scale):
    if variant == "mxu":
        s = torch.einsum("bhd,bhsd->bhs", qf.double(),
                         kq[:, :, s0:s1].double()).float()
    else:
        s = torch.einsum("bhd,bhsd->bhs", qf, kq[:, :, s0:s1])
    s = s * ks[:, :, s0:s1] * scale
    idx = torch.arange(s0, s1)
    return torch.where((idx[None, :] <= n_past[:, None].long())[:, None, :],
                       s, NEG)


def _p_vs(s, m, vs_t, variant):
    p = torch.where(s == NEG, 0.0, torch.exp(s - m[..., None]))
    pw = p * vs_t
    if variant == "mxu":
        pw = pw.to(torch.bfloat16).to(torch.float32)
    return p, pw


def _walk_pw(q, kq, ks, vq, vs, il, n_past, variant, scale):
    """The body's walk (attn_lab_plain's loop): each tile's p·vs."""
    qf, kq, ks, vq, vs = _layer(q, kq, ks, vq, vs, il)
    ts = min(al.BLOCK_S, S)
    m = torch.full((B, H), NEG)
    out = []
    for s0 in range(0, S, ts):
        s1 = min(s0 + ts, S)
        s = _tile_scores(qf, kq, ks, n_past, s0, s1, variant, scale)
        m = torch.maximum(m, s.amax(-1))
        out.append(_p_vs(s, m, vs[:, :, s0:s1], variant)[1])
    return out


def _split(q, kq, ks, vq, vs, il, n_past, variant, scale, splits):
    """K16's steps (a)-(d) at a cluster of ``splits`` blocks: (output,
    each tile's p·vs)."""
    qf, kq, ks, vq, vs = _layer(q, kq, ks, vq, vs, il)
    ts = min(al.BLOCK_S, S)
    tiles = al.key_tiles(S)
    per_rank = -(-tiles // splits)
    live = [(j * ts <= n_past.long())[:, None] for j in range(tiles)]  # [B, 1]
    # (a)
    scores = [_tile_scores(qf, kq, ks, n_past, j * ts, min(j * ts + ts, S),
                           variant, scale) for j in range(tiles)]
    tmax = [s.amax(-1) for s in scores]
    ranks = [range(r * per_rank, min(r * per_rank + per_rank, tiles))
             for r in range(splits)]
    # (b) each rank's max over its live tiles, the prefix over earlier ranks
    rank_max = []
    for own in ranks:
        mx = torch.full((B, H), NEG)
        for j in own:
            mx = torch.where(live[j], torch.maximum(mx, tmax[j]), mx)
        rank_max.append(mx)
    pw_all, alpha, parts = [None] * tiles, [None] * tiles, []
    for r, own in enumerate(ranks):
        m = torch.full((B, H), NEG)
        for e in range(r):
            m = torch.maximum(m, rank_max[e])
        acc, lsum = torch.zeros((B, H, D)), torch.zeros((B, H))
        for j in own:
            # (c)
            m_new = torch.maximum(m, tmax[j])
            alpha[j] = torch.where(m == NEG, 0.0, torch.exp(m - m_new))
            p, pw = _p_vs(scores[j], m_new, vs[:, :, j * ts:j * ts + ts],
                          variant)
            pw_all[j] = pw
            pv = torch.einsum("bhs,bhsd->bhd", pw, vq[:, :, j * ts:j * ts + ts])
            # (d) the rank's fold from zero; a dead tile is skipped
            acc = torch.where(live[j][..., None],
                              acc * alpha[j][..., None] + pv, acc)
            lsum = torch.where(live[j], alpha[j] * lsum + p.sum(-1), lsum)
            m = torch.where(live[j], m_new, m)
        parts.append((acc, lsum))
    total, l_tot = torch.zeros((B, H, D)), torch.zeros((B, H))
    for own, (acc, lsum) in zip(ranks, parts):
        for j in own:
            total = torch.where(live[j][..., None],
                                total * alpha[j][..., None], total)
            l_tot = torch.where(live[j], l_tot * alpha[j], l_tot)
        total, l_tot = total + acc, l_tot + lsum
    inv = torch.where(l_tot > 0, 1.0 / torch.where(l_tot > 0, l_tot, 1.0),
                      0.0)
    return total * inv[..., None], pw_all


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_out(inputs):
    """tools/attn_lab.py:variant_call in interpret mode, by variant.  The
    body reads whole tiles, past S into the block padding (NaN in interpret
    mode) where S % 128 != 0, so its cache is padded with zeros to whole
    tiles: the padded keys lie past every n_past, so the function is the
    one at S rows."""
    names = ("jax", "jax.numpy", "jax.experimental.pallas", "tools.attn_lab")
    m = types.SimpleNamespace(**{n.split(".")[-1]: importlib.import_module(n)
                                 for n in names})
    jnp = m.numpy
    shim = types.SimpleNamespace(**{k: getattr(m.pallas, k)
                                    for k in dir(m.pallas)
                                    if not k.startswith("__")})
    shim.pallas_call = functools.partial(m.pallas.pallas_call, interpret=True)
    saved = m.attn_lab.pl
    m.attn_lab.pl = shim
    try:
        q, kq, ks, vq, vs, il, n_past = inputs
        pad = al.key_tiles(S) * al.BLOCK_S - S
        kq, vq = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (kq, vq))
        ks, vs = (torch.nn.functional.pad(t.float(), (0, pad)) for t in (ks, vs))
        bf = jnp.bfloat16
        args = (jnp.asarray(il.numpy()), jnp.asarray(n_past.numpy()),
                jnp.asarray(q.float().numpy(), bf), jnp.asarray(kq.numpy()),
                jnp.asarray(ks.float().numpy(), bf), jnp.asarray(vq.numpy()),
                jnp.asarray(vs.float().numpy(), bf))
        out = {}
        for variant in al.ATTN_VARIANTS:
            fn = functools.partial(m.attn_lab.variant_call, variant=variant,
                                   scale=D ** -0.5, block_s=al.BLOCK_S)
            out[variant] = np.array(m.jax.jit(fn).lower(*args).compile(
                compiler_options=NO_EXCESS)(*args), np.float32)
        return out
    finally:
        m.attn_lab.pl = saved


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("variant", al.ATTN_VARIANTS)
def test_split_keeps_every_p_vs_of_the_walk(inputs, variant, splits):
    walk = _walk_pw(*inputs, variant, D ** -0.5)
    _, pw = _split(*inputs, variant, D ** -0.5, splits)
    n_past = inputs[-1].long()
    ts = min(al.BLOCK_S, S)
    for j, (a, b) in enumerate(zip(pw, walk)):
        live = j * ts <= n_past
        assert torch.equal(a[live], b[live]), (variant, splits, j)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("variant", al.ATTN_VARIANTS)
def test_split_matches_plain_and_jax(inputs, jax_out, variant, splits):
    got, _ = _split(*inputs, variant, D ** -0.5, splits)
    ref = al.attn_lab_plain(*inputs, variant, D ** -0.5)
    tol = al.TOL_ATTN[variant]
    assert (got - ref).abs().max() <= tol * ref.abs().max()
    jx = torch.from_numpy(jax_out[variant])
    assert (got - jx).abs().max() <= tol * jx.abs().max()
    # the rows whose whole ranks lie past n_past still come out right
    assert torch.isfinite(got).all() and got.abs().amax((1, 2)).min() > 0


def _fits(threads, c, sms=132):
    """Clusters of c blocks an H100-sized card holds at once: four 4-warp
    or two 8-warp blocks an SM."""
    return (4 if threads == 128 else 2) * sms // c


def test_attn_plan_picks_from_the_shapes():
    assert al.attn_plan(32, 16, 128, _fits) == (128, 1)  # one tile, one wave
    threads, c = al.attn_plan(1, 40, 2048, _fits)  # Pythia-12B B=1
    assert (threads, c) == (128, 8) and 40 * c >= 132
    for b, h, s in [(8, 16, 2048), (1, 40, 2048), (4, 8, 300), (2, 2, 32768),
                    (4, 40, 2048)]:
        threads, c = al.attn_plan(b, h, s, _fits)
        assert threads in al.ATTN_THREADS
        assert 1 <= c <= min(al.ATTN_MAX_CLUSTER, al.key_tiles(s))
        assert -(-al.key_tiles(s) // c) <= al.ATTN_MAX_TILES
        assert b * h <= _fits(threads, c)  # one wave where one exists
    with pytest.raises(ValueError, match="no cluster"):
        al.attn_plan(1, 1, 128 * al.ATTN_MAX_TILES * 8 + 1, _fits)
    with pytest.raises(ValueError, match="no cluster"):
        al.attn_plan(1, 1, 2048, lambda t, c: 0)
