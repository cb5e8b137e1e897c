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

A CPU tensor goes through the plain PyTorch version, which follows the
body's tiles in order; a CUDA tensor launches the kernel or raises.  The
kernel has no backward.
"""

from __future__ import annotations

import ctypes

import torch

from vsim_tpu_torch.ops import _build

ATTN_VARIANTS = ("vpu3d", "mxu")
BLOCK_S = 128  # the body's key tile (attn_lab.py: block_s=min(128, S))
MAX_D = 256
NEG_INF = float(torch.finfo(torch.float32).min)
# max|kernel − plain| / max|plain| on the card: both differ in the order of
# their f32 sums over keys only (mxu's scores, and so its p·vs, are the same
# on both sides)
TOL_ATTN = {"vpu3d": 1e-5, "mxu": 1e-5}
# mxu's kernel must sit at least this many times nearer its own plain
# version than vpu3d's: the two functions differ by the rounding of p·vs
MXU_SEPARATION = 10.0
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 8 + (_I,) * 5 + (ctypes.c_float, _I, _P)


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


def attn_lab(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
             v_q: torch.Tensor, v_s: torch.Tensor, il: torch.Tensor,
             n_past: torch.Tensor, variant: str, scale: float) -> torch.Tensor:
    """K16: the attention of q [B, H, D] over layer ``il`` (int32, one
    element, on q's device) of the cache, keys s <= n_past[b] → [B, H, D]
    f32, under ``variant``."""
    what = "attn_lab"
    _check(what, q, k_q, k_s, v_q, v_s, il, n_past, variant)
    if q.device.type == "cpu":
        return attn_lab_plain(q, k_q, k_s, v_q, v_s, il, n_past, variant,
                              scale)
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
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    p = _build.ptr
    _build.launch(what, "attn_lab_launch", _ARGS, p(q), p(k_q), p(k_s),
                  p(v_q), p(v_s), p(il), p(n_past), p(out), L, B, H, S, D,
                  float(scale), ATTN_VARIANTS.index(variant),
                  _build.stream_ptr(q.device))
    return out
