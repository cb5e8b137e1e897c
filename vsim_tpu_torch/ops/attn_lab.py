"""The attention lab's decode attention (counterpart of tools/attn_lab.py).

K16 ``attn_lab`` (csrc/attn_lab.cu): one query a head, q [B, H, D] bf16,
over layer ``il`` of an int8 cache k_q, v_q [L, B, H, S, D] with bf16
scales [L, B, H, S], keys s <= n_past[b]; out [B, H, D] f32.  The layer
index (one int32) and ``n_past`` [B] live on the device, and the kernel
reads them: the wrapper never syncs with the host.  Two bodies
(``ATTN_VARIANTS``), attn_lab.py's ``_k_vpu3d`` (:41) and ``_k_mxu`` (:86),
both an online softmax over tiles of min(128, S) keys walked in order:

  vpu3d  all f32: the function of K3's int8 mode
  mxu    p·vs rounded to bf16 before the value product (the running max
         of the tiles so far sets p, so the tile order is part of the
         function); its scores are the exact dot rounded once to f32 (f64
         sums of exact terms), so kernel and plain version round the same
         p·vs at any order of the sums

The kernel is one launch a layer: each (b, h) is a cluster of blocks that
split the key tiles, keep the walk's running maxima exactly (each tile's
m_j from the earlier ranks' maxima, read through distributed shared
memory) and fold the tiles in order.  ``attn_plan`` picks the plan, the
block's threads (128 or 256) and the cluster size, from the shapes and the
card, never from ``n_past``; ``attn_lab_planned`` takes a forced one.

A CPU tensor goes through the plain PyTorch version, which follows the
body's tiles in order; a CUDA tensor launches the kernel or raises.  The
kernel has no backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from vsim_tpu_torch.ops import _build

ATTN_VARIANTS = ("vpu3d", "mxu")
BLOCK_S = 128  # the body's key tile (attn_lab.py: block_s=min(128, S))
MAX_D = 256
ATTN_MAX_CLUSTER = 8  # blocks a cluster (csrc/attn_lab.cu:kMaxCluster)
ATTN_MAX_TILES = 32  # key tiles a block may own (attn_lab.cu:kMaxTiles)
ATTN_THREADS = (128, 256)  # a block's threads: 4 or 8 warps
NEG_INF = float(torch.finfo(torch.float32).min)
# max|kernel − plain| / max|plain| on the card: both differ in the order of
# their f32 sums over keys only (mxu's scores, and so its p·vs, are the same
# on both sides)
TOL_ATTN = {"vpu3d": 1e-5, "mxu": 1e-5}
# mxu's kernel must sit at least this many times nearer its own plain
# version than vpu3d's: the two functions differ by the rounding of p·vs
MXU_SEPARATION = 10.0
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 8 + (_I,) * 5 + (ctypes.c_float, _I, _I, _I, _P)


def attn_lab_plain(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                   v_q: torch.Tensor, v_s: torch.Tensor, il: torch.Tensor,
                   n_past: torch.Tensor, variant: str,
                   scale: float) -> torch.Tensor:
    """The body's online softmax, tile by tile in order, for every (b, h)
    at once: a tile past n_past[b] is all masked, which leaves m, l and acc
    as the body's skip does."""
    if variant not in ATTN_VARIANTS:
        raise ValueError(f"unknown attention variant {variant!r}; known: "
                         f"{ATTN_VARIANTS}")
    L, B, H, S, D = k_q.shape  # noqa: N806
    lay = il.reshape(1).to(torch.long).clamp(0, L - 1)
    kq = torch.index_select(k_q, 0, lay)[0].to(torch.float32)
    ks = torch.index_select(k_s, 0, lay)[0].to(torch.float32)
    vq = torch.index_select(v_q, 0, lay)[0].to(torch.float32)
    vs = torch.index_select(v_s, 0, lay)[0].to(torch.float32)
    qf = q.to(torch.float32)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H), dtype=torch.float32, device=q.device)  # noqa: E741
    acc = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    ts = min(BLOCK_S, S)
    for s0 in range(0, S, ts):
        t = slice(s0, min(s0 + ts, S))
        if variant == "mxu":  # the exact dot, rounded once (as the kernel)
            s = torch.einsum("bhd,bhsd->bhs", qf.double(),
                             kq[:, :, t].double()).float()
        else:
            s = torch.einsum("bhd,bhsd->bhs", qf, kq[:, :, t])
        s = s * ks[:, :, t] * scale
        idx = torch.arange(s0, t.stop, device=q.device)
        mask = (idx[None, :] <= n_past[:, None].to(idx.dtype))[:, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(s == NEG_INF, 0.0, p)
        alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
        l = alpha * l + p.sum(-1)  # noqa: E741
        pw = p * vs[:, :, t]
        if variant == "mxu":
            pw = pw.to(torch.bfloat16).to(torch.float32)
        acc = acc * alpha[..., None] + torch.einsum("bhs,bhsd->bhd", pw,
                                                    vq[:, :, t])
        m = m_new
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    return acc * inv[..., None]


def _check(what, q, k_q, k_s, v_q, v_s, il, n_past, variant):
    if variant not in ATTN_VARIANTS:
        raise ValueError(f"{what}: unknown variant {variant!r}; known: "
                         f"{ATTN_VARIANTS}")
    if q.dim() != 3 or q.dtype != torch.bfloat16:
        raise ValueError(f"{what}: q must be bf16 [B, H, D]")
    B, H, D = q.shape  # noqa: N806
    if k_q.dim() != 5 or k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise ValueError(f"{what}: k_q and v_q must be int8 [L, B, H, S, D]")
    L, S = k_q.shape[0], k_q.shape[3]  # noqa: N806
    if tuple(k_q.shape) != (L, B, H, S, D) or v_q.shape != k_q.shape:
        raise ValueError(f"{what}: cache {tuple(k_q.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    for name, t in (("k_s", k_s), ("v_s", v_s)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (L, B, H, S):
            raise ValueError(f"{what}: {name} must be bf16 {(L, B, H, S)}")
    if D % 4 or D > MAX_D:
        raise ValueError(f"{what}: head dim {D} must be a multiple of 4 and "
                         f"at most {MAX_D}")
    if (not isinstance(il, torch.Tensor) or il.dtype != torch.int32
            or il.numel() != 1):
        raise ValueError(f"{what}: il must be a one-element int32 tensor")
    if (not isinstance(n_past, torch.Tensor) or n_past.dtype != torch.int32
            or tuple(n_past.shape) != (B,)):
        raise ValueError(f"{what}: n_past must be int32 [B]")


def key_tiles(S: int) -> int:  # noqa: N803
    """The body's key tiles of min(128, S) keys over a cache of S rows."""
    return -(-S // min(BLOCK_S, S))


def attn_plan(B: int, H: int, S: int,  # noqa: N803
              max_clusters: Callable[[int, int], int]) -> Tuple[int, int]:
    """K16's plan (threads, cluster) for B x H heads over S cache rows, from
    the shapes and the card alone (never n_past, so the wrapper never
    syncs).  Of the blocks of ``ATTN_THREADS`` and clusters c <= min(8,
    tiles) whose ranks own at most ``ATTN_MAX_TILES`` tiles: those whose
    B x H clusters all fit on the card at once (``max_clusters(threads,
    c)``) first, then the fewest tiles a rank (waves x tiles where none
    fits), then the more threads, then the smaller cluster.  A second wave
    costs more than its share (on an H100, GPT-J-6B's B=8 x 2048 ran slower
    at 8 blocks of 4 warps a head, two waves, than at 2, one); 4-warp
    blocks fit four an SM, so one-tile heads (GPT-J B=32 x 128, 512
    blocks) run in one wave; where both fit, 8-warp blocks keep more warps
    an SM.  Pythia-12B's 40 heads at S = 2048 take (128, 8): 320 blocks,
    two tiles each."""
    tiles = key_tiles(S)
    plans = []
    for threads in ATTN_THREADS:
        for c in range(1, min(ATTN_MAX_CLUSTER, tiles) + 1):
            per_rank = -(-tiles // c)
            fit = (max_clusters(threads, c) if per_rank <= ATTN_MAX_TILES
                   else 0)
            if fit > 0:
                waves = -(-(B * H) // fit)
                plans.append((waves > 1, waves * per_rank, -threads, c))
    if not plans:
        raise ValueError(f"attn_lab: no cluster of <= {ATTN_MAX_CLUSTER} "
                         f"blocks takes S={S} ({tiles} tiles; a block owns "
                         f"at most {ATTN_MAX_TILES})")
    _, _, threads, c = min(plans)
    return -threads, c


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, S: int, D: int, math: int,  # noqa: N803
                  threads: int, cluster: int) -> int:
    with torch.cuda.device(index):
        return _build.function("attn_lab", "attn_lab_max_clusters",
                               (_I,) * 5)(S, D, math, threads, cluster)


@functools.lru_cache(maxsize=None)
def _plan(index: int, B: int, H: int, S: int, D: int,  # noqa: N803
          math: int) -> Tuple[int, int]:
    return attn_plan(B, H, S,
                     functools.partial(_max_clusters, index, S, D, math))


def attn_lab_plan(device: torch.device, B: int, H: int, S: int,  # noqa: N803
                  D: int, variant: str) -> Tuple[int, int]:  # noqa: N803
    """The plan (threads, cluster) ``attn_lab`` takes on ``device`` (a CUDA
    card)."""
    return _plan(device.index or 0, B, H, S, D, ATTN_VARIANTS.index(variant))


def attn_lab(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
             v_q: torch.Tensor, v_s: torch.Tensor, il: torch.Tensor,
             n_past: torch.Tensor, variant: str, scale: float) -> torch.Tensor:
    """K16: the attention of q [B, H, D] over layer ``il`` (int32, one
    element, on q's device) of the cache, keys s <= n_past[b] → [B, H, D]
    f32, under ``variant``."""
    if q.device.type == "cpu":
        _check("attn_lab", q, k_q, k_s, v_q, v_s, il, n_past, variant)
        return attn_lab_plain(q, k_q, k_s, v_q, v_s, il, n_past, variant,
                              scale)
    return attn_lab_planned(q, k_q, k_s, v_q, v_s, il, n_past, variant,
                            scale, None)


def attn_lab_planned(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                     v_q: torch.Tensor, v_s: torch.Tensor, il: torch.Tensor,
                     n_past: torch.Tensor, variant: str, scale: float,
                     plan: Optional[Tuple[int, int]]) -> torch.Tensor:
    """K16 on the card under ``plan`` (threads, cluster), or ``attn_plan``'s
    when None: the card tests run every kind.  One launch."""
    what = "attn_lab"
    _check(what, q, k_q, k_s, v_q, v_s, il, n_past, variant)
    if q.device.type != "cuda":
        raise ValueError(f"{what}: q must be a CUDA or a CPU tensor")
    tensors = {"q": q, "k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s,
               "il": il, "n_past": n_past}
    for name, t in tensors.items():
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{q.device}, got {t.device}")
        if t.requires_grad:
            raise ValueError(f"{what}: the kernel has no backward, and {name} "
                             "needs a gradient")
    if k_q.data_ptr() % 4 or v_q.data_ptr() % 4:
        raise ValueError(f"{what}: the caches must be 4-byte aligned")
    L, B, H, S, D = k_q.shape  # noqa: N806
    math = ATTN_VARIANTS.index(variant)
    threads, cluster = plan or _plan(q.device.index or 0, B, H, S, D, math)
    if not (threads in ATTN_THREADS and 1 <= cluster <= ATTN_MAX_CLUSTER
            and -(-key_tiles(S) // cluster) <= ATTN_MAX_TILES):
        raise ValueError(f"{what}: plan {(threads, cluster)} does not take "
                         f"S={S} (threads {ATTN_THREADS}, 1..{ATTN_MAX_CLUSTER}"
                         f" blocks, at most {ATTN_MAX_TILES} tiles a block)")
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    p = _build.ptr
    _build.launch(what, "attn_lab_launch", _ARGS, p(q), p(k_q), p(k_s),
                  p(v_q), p(v_s), p(il), p(n_past), p(out), L, B, H, S, D,
                  float(scale), math, threads, cluster,
                  _build.stream_ptr(q.device))
    return out
