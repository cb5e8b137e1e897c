"""K3 at every head dim of the zoo against the einsum route (port of
tools/attn_gate_probe.py).

    python -m vsim_tpu_torch.tools.attn_gate_probe [--check] [--batch 16]
        [--kvlen 512] [--device cpu]

The TPU tool asked whether its fused decode attention lowers at head dims
whose packed minor dim is not a multiple of 128 lanes (its ``D % 128`` gate
kept all but GPT-J off the kernel on int4 KV).  K3 ``decode_attention_q``
(csrc/decode_attention.cu) has no such gate: it takes every D up to 512
packed columns.  This tool measures it at the zoo's head dims against the
route the TPU fell back to.

``--check``: K3 against ``decode_attention_oracle`` (f32 q, the dequantized
cache, a materialized softmax) at B=4, S=256, L=2, layer 1, random n_past,
for every ``ZOO`` row, int8 and int4 KV, printing the relative error.  The
default mode, for every row at B=16 (``--batch``), S=512 (``--kvlen``),
n_past = S − 2, times the pass over the row's L = 4 layers two ways:

  kernel  K3 on every layer (bf16 q);
  einsum  ``_kv_read`` of keys and values (bf16), the masked f32 einsum
          softmax, then p (bf16) times the values: the JAX tool's
          ``one_layer_einsum``, the route of models/transformer.py's
          ``use_flash=False`` attention.

Before timing, each pass's K3 is held against its plain version
(``decode_attention_plain``) within 1e-3 of max|plain|.  A row prints the
JAX tool's keys (``model``, ``D``, ``H``, ``L``, ``kv``, ``B``, ``S``,
``kernel_ms``, ``kernel_gbs``, ``einsum_ms``, ``einsum_gbs``: ms a pass of
L layers and GB/s of the cache's bytes, values and bf16 scales of k and v)
and the card's: K3's bound (the cache bytes it reads over the memory rate)
and its error against its plain version.  The caches are random
quantized bytes (bytes and layout matter here, not values).  Runs on the
card; ``--device cpu`` runs the plain versions and times nothing.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from vsim_tpu_torch.device import DeviceLike, card_peaks, resolve_device
from vsim_tpu_torch.models.transformer import (_kv_quantize, _kv_quantize4,
                                               _kv_read)
from vsim_tpu_torch.ops.decode_attention import (decode_attention_oracle,
                                                 decode_attention_plain,
                                                 decode_attention_q)
from vsim_tpu_torch.timing import rel_err, timed

# (name, D, H, L): L cut to 4, as the JAX tool's (the rate a layer is what
# matters)
ZOO = [
    ("pythia-12b", 128, 40, 4),
    ("gpt-neox-20b", 96, 64, 4),
    ("codegen-2b", 80, 32, 4),
    ("gpt2", 64, 12, 4),
    ("bloom-560m", 64, 16, 4),
    ("gpt-j-6b", 256, 16, 4),
]
KVS = ("int8", "int4")
TOL = 1e-3  # of max|ref|: K3 splits the keys and sums exp in another order

Store = Tuple[torch.Tensor, torch.Tensor]


def make_cache(rng: np.random.Generator, L: int, B: int,  # noqa: N803
               H: int, S: int, D: int, kv: str,  # noqa: N803
               device) -> Store:
    """A cache quantized from N(0, 1) values drawn by ``rng``, as the JAX
    tool's ``make_cache``: (values [L, B, H, S, Dp], bf16 scales
    [L, B, H, S])."""
    x = torch.from_numpy(
        rng.standard_normal((L * B, H, S, D)).astype(np.float32))
    quant = _kv_quantize4 if kv == "int4" else _kv_quantize
    q, s = quant(x, torch.bfloat16)
    return (q.reshape(L, B, H, S, -1).to(device),
            s.reshape(L, B, H, S).to(device))


def make_cache_fast(g: torch.Generator, L: int, B: int,  # noqa: N803
                    H: int, S: int, D: int, kv: str,  # noqa: N803
                    device) -> Store:
    """Random already-quantized bytes and scales in [0.01, 0.03), made on
    ``device`` (the JAX tool's ``make_cache_fast``)."""
    if kv == "int4":
        q = torch.randint(0, 255, (L, B, H, S, D // 2), generator=g,
                          device=device, dtype=torch.uint8)
    else:
        q = torch.randint(0, 127, (L, B, H, S, D), generator=g,
                          device=device, dtype=torch.int8)
    s = (torch.rand((L, B, H, S), generator=g, device=device) * 0.02
         + 0.01).to(torch.bfloat16)
    return q, s


def cache_bytes(k_store: Store) -> int:
    """Bytes of the k and v caches: values and bf16 scales (the JAX tool's
    2 · (values + 2 · scales))."""
    return 2 * (k_store[0].numel() * k_store[0].element_size()
                + k_store[1].numel() * 2)


def check_one(D: int, H: int, kv: str, B: int = 4, S: int = 256,  # noqa: N803
              L: int = 2, device: DeviceLike = None) -> float:  # noqa: N803
    """K3 against the oracle on layer 1: max|err| over max|ref|."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    k_store = make_cache(rng, L, B, H, S, D, kv, dev)
    v_store = make_cache(rng, L, B, H, S, D, kv, dev)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(
        np.float32)).to(torch.bfloat16).to(dev)
    n_past = torch.from_numpy(rng.integers(1, S - 1, size=(B,)).astype(
        np.int32)).to(dev)
    scale = 1.0 / math.sqrt(D)
    ref = decode_attention_oracle(q, k_store, v_store, 1, n_past,
                                  scale=scale)
    got = decode_attention_q(q[:, 0], k_store, v_store, 1, n_past,
                             scale=scale)
    return rel_err(got, ref[:, 0])[1]


def check(device: DeviceLike = None) -> List[Dict]:
    """``check_one`` at every zoo row and KV dtype, printed; raises past
    ``TOL``."""
    rows = []
    for name, D, H, _ in ZOO:  # noqa: N806
        for kv in KVS:
            e = check_one(D, H, kv, device=device)
            print(f"{name:14s} D={D:3d} {kv}: relerr {e:.2e}", flush=True)
            if not e <= TOL:
                raise RuntimeError(f"attn_gate_probe --check {name} {kv}: "
                                   f"relerr {e:.3g} > {TOL}")
            rows.append(dict(model=name, D=D, H=H, kv=kv, rel_err=e))
    return rows


def einsum_layer(q: torch.Tensor, il: int, k_store: Store, v_store: Store,
                 n_past: torch.Tensor, S: int, scale: float  # noqa: N803
                 ) -> torch.Tensor:
    """The JAX tool's ``one_layer_einsum``: q [B, 1, H, D] → [B, 1, H, D]."""
    keys = _kv_read(k_store, il, S, torch.bfloat16)
    values = _kv_read(v_store, il, S, torch.bfloat16)
    s = torch.einsum("bthd,bhsd->bhts", q.float(), keys.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] <= n_past[:, None]
    s = torch.where(mask[:, None, None, :], s,
                    torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bthd", p.to(torch.bfloat16), values)


def bench_one(D: int, H: int, kv: str, L: int, B: int, S: int,  # noqa: N803
              device: DeviceLike = None) -> Dict:
    """Both passes over L layers at n_past = S − 2: {"kernel": {...},
    "einsum": {...}}, each with ms and gbs (None off the card)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    k_store = make_cache_fast(g, L, B, H, S, D, kv, dev)
    v_store = make_cache_fast(g, L, B, H, S, D, kv, dev)
    q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    n_past = torch.full((B,), S - 2, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(D)

    def kernel_pass():
        return [decode_attention_q(q, k_store, v_store, il, n_past,
                                   scale=scale) for il in range(L)]

    def plain_pass():
        return [decode_attention_plain(q, k_store, v_store, il, n_past,
                                       scale=scale) for il in range(L)]

    def einsum_pass():
        return [einsum_layer(q[:, None], il, k_store, v_store, n_past, S,
                             scale) for il in range(L)]

    got, ref = kernel_pass(), plain_pass()
    err = rel = 0.0
    for a, b in zip(got, ref):
        e, r = rel_err(a, b)
        err, rel = max(err, e), max(rel, r)
    if not all(torch.isfinite(a).all() for a in got) or rel > TOL:
        raise RuntimeError(f"attn_gate_probe D={D} H={H} {kv}: K3 rel err "
                           f"{rel:.3g} > {TOL} against its plain version")
    nbytes = cache_bytes(k_store)
    out = {"kernel": dict(ms=None, gbs=None), "einsum": dict(ms=None,
                                                            gbs=None)}
    extra = dict(max_abs_err=err, rel_err=rel, bound_ms=None, nbytes=nbytes)
    if on_card:
        for name, fn in (("kernel", kernel_pass), ("einsum", einsum_pass)):
            ms = timed(fn, reps=10, warmup=2)
            out[name] = dict(ms=ms, gbs=nbytes / (ms * 1e-3) / 1e9)
        # K3 reads rows s <= n_past (S − 1 of S) of k and v, q, writes out
        read = nbytes * (S - 1) // S + L * B * H * D * 2 + L * B * H * D * 4
        extra["bound_ms"] = read / card_peaks(
            torch.cuda.get_device_name(dev))[0] * 1e3
    out["extra"] = extra
    return out


def run(zoo: Sequence[tuple] = ZOO, kvs: Sequence[str] = KVS,
        batch: int = 16, kvlen: int = 512,
        device: DeviceLike = None) -> List[Dict]:
    """One row a (zoo row, KV dtype), printed as a JSON line as it is
    measured."""
    dev = resolve_device(device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rows = []
    for name, D, H, L in zoo:  # noqa: N806
        for kv in kvs:
            r = bench_one(D, H, kv, L, batch, kvlen, dev)
            extra = r.pop("extra")
            row = {"model": name, "D": D, "H": H, "L": L, "kv": kv,
                   "B": batch, "S": kvlen,
                   **{f"{k}_{kk}": vv for k, v in r.items()
                      for kk, vv in v.items()},
                   "kernel_bound_ms": extra["bound_ms"],
                   "max_abs_err": extra["max_abs_err"],
                   "rel_err": extra["rel_err"], "nbytes": extra["nbytes"],
                   "device": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--kvlen", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions and times nothing")
    args = ap.parse_args(argv)
    if args.check:
        check(args.device)
    else:
        run(batch=args.batch, kvlen=args.kvlen, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
