"""Decode-attention lab on the card (port of tools/attn_lab.py).

    python -m vsim_tpu_torch.tools.attn_lab [--batch 32] [--kv-len 128]
        [--model gpt-j-6b] [--variants xla,pallas,vpu3d,mxu] [--layers L]
        [--device cpu]

Times a whole L-layer pass of batch-B decode attention over an int8 cache
of ``--kv-len`` rows per variant, each layer's context fed to the next as
bf16 q, as the TPU tool chains them:

  xla     the port's plain einsum route (models/transformer.py: the layer
          dequantized to bf16, masked softmax, bf16 probabilities)
  pallas  K3 ``decode_attention_q`` (split-S, the main path's kernel)
  vpu3d   K16 ``attn_lab``, all-f32 body
  mxu     K16 ``attn_lab``, p·vs rounded to bf16

Model widths from the port's presets (``--layers`` cuts the depth, for a
run on the CPU); the cache is noise from a seed as the TPU tool fills it
(int8 in [−127, 127), scales 0.01 + U[0, 0.1) in bf16), n_past = kv_len − 2
for every row.  Each kernel is held against its plain version on the last
layer first (K16 also against a second run, bit for bit), and the einsum
route against K16's plain vpu3d at a bf16 tolerance; mxu must also lie
``MXU_SEPARATION`` times nearer its own plain version than vpu3d's.
Prints ms per pass, GB/s on the KV bytes (2·L·B·S·H·D, the TPU tool's
count), the plain version's ms and a library yardstick the port never
calls (SDPA over the layer's K/V dequantized to bf16 beforehand), and
K16's plan on the card (a block's threads, its cluster a head).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.models.config import PRESETS
from vsim_tpu_torch.models.transformer import _attend_plain, _kv_read
from vsim_tpu_torch.ops.attn_lab import (ATTN_VARIANTS, MXU_SEPARATION,
                                         TOL_ATTN, attn_lab, attn_lab_plain,
                                         attn_lab_plan)
from vsim_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                 decode_attention_q)
from vsim_tpu_torch.timing import rel_err, timed

VARIANTS = ("xla", "pallas") + ATTN_VARIANTS
# K3 against its plain version (chip_smoke.py's TOL_DECODE: the exp and
# sum orders differ); the einsum route against the f32 function: its keys,
# values and probabilities are rounded to bf16
TOL_K3 = 1e-3
TOL_XLA = 5e-2


def make_cache(L: int, B: int, H: int, S: int, D: int, seed: int,  # noqa: N803
               device) -> Dict[str, torch.Tensor]:
    """An int8 cache of noise: values in [−127, 127), scales 0.01 +
    U[0, 0.1) in bf16 (tools/attn_lab.py:208-218)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = {}
    for name in ("k", "v"):
        out[f"{name}_q"] = torch.randint(-127, 127, (L, B, H, S, D),
                                         generator=g, device=device,
                                         dtype=torch.int8)
        out[f"{name}_s"] = (0.01 + 0.1 * torch.rand(
            (L, B, H, S), generator=g, device=device)).to(torch.bfloat16)
    return out


def run(model: str = "gpt-j-6b", batch: int = 32, kv_len: int = 128,
        variants: Sequence[str] = VARIANTS, device: DeviceLike = None,
        layers: Optional[int] = None) -> List[Dict]:
    """One row a variant, printed as it is measured; raises on an unknown
    variant or a failed check."""
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {VARIANTS}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    cfg = PRESETS[model]
    L, H, D = layers or cfg.n_layer, cfg.n_head, cfg.head_dim  # noqa: N806
    B, S = batch, kv_len  # noqa: N806
    c = make_cache(L, B, H, S, D, 0, dev)
    kv = (c["k_q"], c["k_s"], c["v_q"], c["v_s"])
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    q0 = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    n_past = torch.full((B,), S - 2, dtype=torch.int32, device=dev)
    il_all = torch.arange(L, dtype=torch.int32, device=dev)
    scale = float(D) ** -0.5
    n_keys = S - 1  # keys s <= n_past = S - 2
    kv_bytes = 2 * L * B * S * H * D
    print(f"attn_lab: device={card} {model} L={L} H={H} D={D} B={B} "
          f"kv_len={S} ({kv_bytes / 1e9:.2f} GB of KV)", flush=True)

    def layer_fn(v, plain=False):
        """(q, il) -> [B, H, D] f32 of variant v at layer il."""
        if v == "xla":
            def f(q, il):
                keys = _kv_read((c["k_q"], c["k_s"]), il, S, torch.bfloat16)
                vals = _kv_read((c["v_q"], c["v_s"]), il, S, torch.bfloat16)
                return _attend_plain(q[:, None], keys, vals, n_past, None,
                                     torch.bfloat16)[:, 0].float()
        elif v == "pallas":
            k3 = decode_attention_plain if plain else decode_attention_q

            def f(q, il):
                return k3(q, (c["k_q"], c["k_s"]), (c["v_q"], c["v_s"]), il,
                          n_past, scale=scale)
        else:
            k16 = attn_lab_plain if plain else attn_lab

            def f(q, il):
                return k16(q, *kv, il_all[il:il + 1], n_past, v, scale)
        return f

    def a_pass(f):
        q = q0
        for il in range(L):
            q = f(q, il).to(torch.bfloat16)
        return q

    lib_ms = None
    if on_card:
        # the yardstick: SDPA over each layer's K/V dequantized to bf16
        # beforehand (the dequant is not timed)
        kd = (c["k_q"].to(torch.bfloat16) * c["k_s"][..., None])
        vd = (c["v_q"].to(torch.bfloat16) * c["v_s"][..., None])
        mask = (torch.arange(S, device=dev)[None, :]
                <= n_past[:, None])[:, None, None, :]

        def sdpa_pass():
            q = q0
            for il in range(L):
                q = torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None], kd[il], vd[il], attn_mask=mask,
                    scale=scale)[:, :, 0]
            return q

        lib_ms = timed(sdpa_pass, reps=5, warmup=1)
        del kd, vd
    rows: List[Dict] = []
    last = L - 1
    for v in [v for v in VARIANTS if v in variants]:
        f = layer_fn(v)
        got = f(q0, last)
        if v == "xla":
            ref = attn_lab_plain(q0, *kv, il_all[last:last + 1], n_past,
                                 "vpu3d", scale)
            tol = TOL_XLA
        else:
            ref = layer_fn(v, plain=True)(q0, last)
            tol = TOL_K3 if v == "pallas" else TOL_ATTN[v]
        err, rel = rel_err(got, ref)
        if not torch.isfinite(got).all() or rel > tol:
            raise RuntimeError(f"attn_lab {v} B={B} kv_len={S}: max|err| "
                               f"{err:.3g} (rel {rel:.3g} > {tol})")
        far = None
        if v == "mxu":  # nearer its own plain version than vpu3d's
            far, _ = rel_err(got, layer_fn("vpu3d", plain=True)(q0, last))
            if not err * MXU_SEPARATION <= far:
                raise RuntimeError(f"attn_lab mxu B={B} kv_len={S}: max|err| "
                                   f"{err:.3g} against its plain version, "
                                   f"{far:.3g} against vpu3d's")
        if v in ATTN_VARIANTS and not torch.equal(got, f(q0, last)):
            raise RuntimeError(f"attn_lab {v} B={B} kv_len={S}: differs from "
                               "run to run")
        ms = gbs = plain_ms = None
        if on_card:
            ms = timed(lambda: a_pass(f), reps=5, warmup=1)
            gbs = kv_bytes / (ms * 1e-3) / 1e9
            if v != "xla":
                pf = layer_fn(v, plain=True)
                plain_ms = timed(lambda: a_pass(pf), reps=2, warmup=1)
        # the bound's bytes: each row's keys up to n_past (values, scales),
        # q read and out written, every layer
        nbytes = L * B * H * (2 * n_keys * (D + 2) + D * 2 + D * 4)
        plan = (list(attn_lab_plan(dev, B, H, S, D, v))
                if on_card and v in ATTN_VARIANTS else None)
        row = dict(tool="attn_lab", variant=v, plan=plan,
                   kernel={"xla": None, "pallas": "decode_attention_q"}.get(
                       v, "attn_lab"),
                   shape=f"{model} {v} L={L} B={B} H={H} D={D} S={S} "
                         f"n_past={S - 2}",
                   model=model, L=L, B=B, H=H, D=D, S=S, ms=ms, gbs=gbs,
                   max_abs_err=err, rel_err=rel, vpu3d_err=far,
                   plain_ms=plain_ms,
                   library_ms=lib_ms, nbytes=nbytes,
                   ops=4 * L * B * H * n_keys * D, peak="f32", device=card)
        rows.append(row)
        print(format_row(row), flush=True)
    return rows


def format_row(r: Dict) -> str:
    head = f"  {r['variant']:7s} "
    err = f"max|err| {r['max_abs_err']:.2e} (rel {r['rel_err']:.2e})"
    if r.get("vpu3d_err") is not None:
        err += f" [{r['vpu3d_err']:.2e} from vpu3d's]"
    if r["ms"] is None:
        return head + f"ms not measured (on {r['device']})  {err}"
    plain = ("" if r["plain_ms"] is None
             else f"  plain {r['plain_ms']:.3f} ms")
    plan = ("" if r.get("plan") is None
            else f"  plan {tuple(r['plan'])} (threads, cluster)")
    return (head + f"{r['ms']:8.3f} ms a pass {r['gbs']:7.1f} GB/s on KV  "
            f"{err}{plain}  library {r['library_ms']:.3f} ms{plan}")


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--kv-len", type=int, default=128)
    ap.add_argument("--model", default="gpt-j-6b", choices=sorted(PRESETS))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the model's)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    return run(args.model, args.batch, args.kv_len, args.variants.split(","),
               args.device, args.layers)


if __name__ == "__main__":
    main()
