"""The reference binary's own baselines, tokens/s and the Q4 ppl delta,
beside the port's ppl on the same windows (port of tools/ref_baseline.py).

    python -m vsim_tpu_torch.tools.ref_baseline [--ckpt build/minipythia]
        [--windows 8] [--win-len 256] [--n-predict 100] [--skip-ppl]
        [--skip-binary] [--reference-tree DIR]
        [--out build/ref_baseline.json] [--device cpu]

The subject is the 25M byte-level GPT-NeoX that
``vsim_tpu_torch.tools.train_small`` trains (its default ``--out``).  The
JAX tool's steps:

1. export the checkpoint to ggml files the reference loader reads, f32 and
   Q4_0 (``export_checkpoint``: the port's ``convert/ggml_file.write_ggml``
   and ``quant/q4`` codecs; for one checkpoint the bytes are the JAX
   tool's);
2. the port's teacher-forced ppl (``ours_nll``: ``forward_nocache`` on the
   device, f32 compute; f32 weights, Q4_0 weights, Q4_0 weights with the
   reference's activation quantization) on held-out windows;
3. build the reference C binary from its tree (copied under
   ``build/ref_build``, X11 stubbed, ``make -f Makefile-ubuntu``);
4. perf: the golden sampling config (Makefile-ubuntu:26) on both files,
   T_PREDICT and T_SAMPLE parsed from its monitor report (``perf_run``,
   ``monitor_seconds``);
5. quality: the binary's teacher-forced NLL over the same windows through
   ``--return_logits -b 0`` (``window_nll``: printed line j scores token
   j + 1).

Writes ``build/ref_baseline.json`` (the root REF_BASELINE.json is the TPU
tools' record and is never written).  The binary steps need the reference
tree, ``reference/`` at the checkout's root (listed in .gitignore, so
never committed) unless ``--reference-tree`` names another; without it
the tool stops before them with a message naming the missing tree and
exits 2, after writing steps 1-2.  ``--skip-binary`` runs
steps 1-2 alone.  The binary runs on the host's CPU, one thread (the
golden value); ``ours_nll`` runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF = os.path.join(ROOT, "reference")
BUILD = os.path.join(ROOT, "build", "ref_build")
OUT = os.path.join(ROOT, "build", "ref_baseline.json")

XSTUB = """
void x11_open(int v) {(void)v;}
void x11_close(void) {}
void x11_update(void) {}
int  x11_checkevent(void) {return 0;}
void x11_softu(int id, void *p) {(void)id;(void)p;}
void x11_softu64_dist(double a, double b) {(void)a;(void)b;}
void x11_vector_add(double x, double y) {(void)x;(void)y;}
void x11_vector_clear(void) {}
void x11_vector_update(void) {}
void BGR_to_X(int id, void *p) {(void)id;(void)p;}
void FP_to_X(int id, void *f, int m) {(void)id;(void)f;(void)m;}
void BOX_to_X(int id, int r, int c, int n) {(void)id;(void)r;(void)c;(void)n;}
"""
LAYER_LEAVES = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "wq", "bq", "wk", "bk",
                "wv", "bv", "wo", "bo", "w_fc", "b_fc", "w_proj", "b_proj")


class MissingReference(FileNotFoundError):
    """The reference tree the binary builds from is not there."""


def build_binary(tree: str = REF, build: str = BUILD) -> str:
    """The reference binary, built once under ``build`` from a copy of
    ``tree`` with X11 stubbed out; raises ``MissingReference`` naming
    ``tree`` when it is absent."""
    binary = os.path.join(build, "vsim-ubuntu")
    if os.path.exists(binary):
        return binary
    if not os.path.isdir(tree):
        raise MissingReference(f"reference tree {tree} not found: the "
                               "binary steps are not run")
    shutil.rmtree(build, ignore_errors=True)
    shutil.copytree(tree, build)
    with open(os.path.join(build, "xstub.c"), "w") as f:
        f.write(XSTUB)
    mk = os.path.join(build, "Makefile-ubuntu")
    with open(mk) as f:
        text = f.read()
    text = text.replace("xdisp.o", "xstub.o").replace("-lX11 -lXext ", "")
    with open(mk, "w") as f:
        f.write(text)
    r = subprocess.run(["make", "-f", "Makefile-ubuntu"], cwd=build,
                       capture_output=True, timeout=600)
    if r.returncode != 0 or not os.path.exists(binary):
        raise RuntimeError(f"reference build failed: {r.stderr[-400:]!r}")
    return binary


def export_checkpoint(ckpt: str, out_f32: str, out_q4: str) -> Dict:
    """A dense checkpoint directory → reference ggml files (f32 and Q4_0);
    returns the checkpoint's config (its manifest's fields)."""
    from vsim_tpu_torch.convert.ggml_file import (FTYPE_F32, FTYPE_Q4_0,
                                                  GGML_NAME_MAPS, GGMLTensor,
                                                  write_ggml)
    from vsim_tpu_torch.convert.store import load_params
    from vsim_tpu_torch.quant.q4 import quantize_q4_0_np, to_ggml_q4_0_bytes

    with open(os.path.join(ckpt, "manifest.json")) as f:
        cfg = json.load(f)["config"]
    _, params = load_params(ckpt, device="cpu")

    def f32(t: torch.Tensor) -> np.ndarray:
        return t.detach().to(torch.float32).numpy()

    names = GGML_NAME_MAPS["gptneox"]
    L = cfg["n_layer"]  # noqa: N806
    lw = {k: f32(params["layers"][k]) for k in LAYER_LEAVES}
    slots = [("wte", f32(params["wte"]))]
    slots += [(k, lw[k][i], i) for i in range(L) for k in LAYER_LEAVES]
    slots += [(k, f32(params[k])) for k in ("ln_f_w", "ln_f_b", "lm_head")]

    def tensors(quantize: bool) -> List:
        out = []
        for rec in slots:
            slot, data = rec[0], np.asarray(rec[1], np.float32)
            name = (names[slot].format(i=rec[2]) if len(rec) == 3
                    else names[slot])
            if quantize and data.ndim == 2 and data.shape[-1] % 32 == 0:
                packed, scales = quantize_q4_0_np(data,
                                                  scale_dtype=torch.float32)
                out.append(GGMLTensor(name, data.shape, FTYPE_Q4_0,
                                      to_ggml_q4_0_bytes(packed, scales)))
            else:
                out.append(GGMLTensor(
                    name, data.shape, FTYPE_F32,
                    np.ascontiguousarray(data).view(np.uint8).reshape(-1)))
        return out

    vocab = [bytes([i]) for i in range(cfg["n_vocab"])]  # byte-level
    for path, quantize in ((out_f32, False), (out_q4, True)):
        hp = {"n_vocab": cfg["n_vocab"], "n_embd": cfg["n_embd"],
              "n_head": cfg["n_head"], "n_layer": L, "n_rot": cfg["n_rot"],
              "use_parallel_residual": int(cfg["parallel_residual"]),
              "ftype": 2 if quantize else 0}
        write_ggml(path, "gptneox", hp, vocab, tensors(quantize))
    return cfg


def run_binary(binary: str, model: str, prompt_ids: Sequence[int],
               extra: List[str], timeout: float = 1800) -> Tuple[str, float]:
    """(stdout, wall seconds) of one run of the binary on ``model``."""
    cmd = [binary, "gptneox", "-m", model,
           "--prompt", " ".join(str(t) for t in prompt_ids)] + extra
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd} exited {r.returncode}: "
                           f"{r.stderr[-500:]!r}")
    return r.stdout.decode(), time.time() - t0


def monitor_seconds(out: str, slot: str) -> float:
    """Thread-0 seconds of a monitor row (monitor.c's print_sep format)."""
    m = re.search(rf"^\s*{re.escape(slot)}\s*:\s*([0-9.]+)s", out, re.M)
    if not m:
        raise ValueError(f"monitor row {slot} not found")
    return float(m.group(1))


def perf_run(binary: str, model: str, prompt_ids: Sequence[int],
             n_predict: int, threads: int) -> Dict:
    """The golden-config generation (Makefile-ubuntu:26 sampling flags):
    tokens generated, T_PREDICT / T_SAMPLE, tokens/s, ms/token."""
    out, wall = run_binary(binary, model, prompt_ids, [
        "-s", "42", "-t", str(threads), "-n", str(n_predict),
        "--top_k", "20", "--top_p", "0.95", "--temp", "0.85",
        "--repeat_last_n", "64", "--repeat_penalty", "1.3"])
    m = re.search(r"<\|BEGIN>(.*?)<END\|>", out, re.DOTALL)
    n_stream = len(m.group(1).split()) if m else 0
    n_gen = max(n_stream - len(prompt_ids), 1)  # EOS may stop early
    t_predict = monitor_seconds(out, "T_PREDICT")
    t_sample = monitor_seconds(out, "T_SAMPLE")
    return {
        "tokens_generated": n_gen,
        "t_predict_s": t_predict,
        "t_sample_s": t_sample,
        "wall_s": round(wall, 2),
        # T_PREDICT covers every eval: the prompt batch and one eval a
        # generated token (vsim.cpp:806)
        "tokens_per_s": round(n_gen / t_predict, 3) if t_predict else None,
        "ms_per_token": round(1e3 * t_predict / n_gen, 2),
    }


def window_nll(binary: str, model: str, window: Sequence[int]
               ) -> Tuple[float, int]:
    """Teacher-forced NLL of ``window`` through ``--return_logits -b 0``:
    printed line j is the prediction after tokens[0..j], so it scores
    window[j + 1].  Returns (summed NLL, positions)."""
    out, _ = run_binary(binary, model, window,
                        ["--return_logits", "-b", "0", "--threads", "1"])
    lines = [ln for ln in out.splitlines()
             if ln.strip().startswith("logits:")]
    T = len(window)  # noqa: N806
    if len(lines) < T - 1:
        raise ValueError(f"{len(lines)} logits lines for a window of {T}")
    nll, n = 0.0, 0
    for j in range(T - 1):
        row = np.asarray([float(x) for x in
                          lines[j].replace("<END|>", "").split()[1:]],
                         np.float64)
        row -= row.max()
        logp = row - np.log(np.exp(row).sum())
        nll += -logp[window[j + 1]]
        n += 1
    return nll, n


def ours_nll(ckpt: str, windows: Sequence[Sequence[int]],
             device: DeviceLike = None) -> Dict:
    """The port's teacher-forced ppl on ``windows`` at f32 compute: f32
    weights, Q4_0 weights, and Q4_0 weights with activation quantization
    (the reference's matmul INIT phase, ggml.c:5030-5038)."""
    from vsim_tpu_torch.convert.store import load_params
    from vsim_tpu_torch.models.transformer import forward_nocache
    from vsim_tpu_torch.tools.train_small import quantize_params

    dev = resolve_device(device)
    cfg, params = load_params(ckpt, device=dev)
    cfg = cfg.replace(compute_dtype="float32")
    qparams = quantize_params(params)
    ids = torch.tensor(np.asarray(windows), dtype=torch.long, device=dev)
    tgt = np.asarray(windows)[:, 1:]

    def ppl(c, p):
        with torch.no_grad():
            logits = forward_nocache(c, p, ids)
        lg = logits.to("cpu", torch.float64).numpy()
        row = lg[:, :-1] - lg[:, :-1].max(-1, keepdims=True)
        logp = row - np.log(np.exp(row).sum(-1, keepdims=True))
        nll = -np.take_along_axis(logp, tgt[..., None], axis=-1)
        return float(np.exp(nll.mean()))

    out = {"f32": round(ppl(cfg, params), 4),
           "q4_0": round(ppl(cfg, qparams), 4),
           "q4_0_act_quant": round(ppl(cfg.replace(act_quant=True), qparams),
                                   4)}
    out["delta_q4_vs_f32"] = round(out["q4_0"] - out["f32"], 4)
    out["delta_q4aq_vs_f32"] = round(out["q4_0_act_quant"] - out["f32"], 4)
    return out


def eval_windows(eval_bytes: np.ndarray, count: int, win_len: int
                 ) -> List[List[int]]:
    """``count`` windows of held-out bytes, skipping any that holds byte 2
    (the reference's EOS, vsim.cpp:894), as the JAX tool picks them."""
    windows, pos = [], 0
    while len(windows) < count and pos + win_len < len(eval_bytes):
        w = [int(b) for b in eval_bytes[pos: pos + win_len]]
        pos += win_len
        if 2 not in w:
            windows.append(w)
    return windows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "build",
                                                   "minipythia"))
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--win-len", type=int, default=256)
    ap.add_argument("--n-predict", type=int, default=100)
    ap.add_argument("--skip-ppl", action="store_true")
    ap.add_argument("--skip-binary", action="store_true",
                    help="the export and ours_nll alone")
    ap.add_argument("--reference-tree", default=REF)
    ap.add_argument("--device", default=None,
                    help="ours_nll's device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.join(ROOT, "REF_BASELINE.json"):
        raise SystemExit("the root REF_BASELINE.json is the TPU tools' "
                         "record: write under build/")
    from vsim_tpu_torch.tools.train_small import build_corpus

    gdir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(gdir, exist_ok=True)
    f32_bin = os.path.join(gdir, "ref_mini_f32.bin")
    q4_bin = os.path.join(gdir, "ref_mini_q4.bin")
    cfg = export_checkpoint(args.ckpt, f32_bin, q4_bin)
    print(f"exported {f32_bin} ({os.path.getsize(f32_bin) / 1e6:.1f} MB), "
          f"{q4_bin} ({os.path.getsize(q4_bin) / 1e6:.1f} MB)", flush=True)
    _, eval_bytes = build_corpus()
    windows = eval_windows(eval_bytes, args.windows, args.win_len)
    dev = resolve_device(args.device)
    result = {
        "model": {"params": "25M trained byte-level GPT-NeoX "
                            "(vsim_tpu_torch/tools/train_small.py)",
                  **{k: cfg[k] for k in ("n_vocab", "n_embd", "n_head",
                                         "n_layer", "n_ff", "n_rot")}},
        "binary": "vsim-ubuntu (Makefile-ubuntu, X11 stubbed; the pure-CPU "
                  "build)",
        "golden_flags": "seed 42, top_k 20, top_p 0.95, temp 0.85, "
                        "repeat 64/1.3 (Makefile-ubuntu:26)",
        "windows": [len(windows), args.win_len],
    }
    if not args.skip_ppl:
        result["ppl_ours_same_windows"] = {
            **ours_nll(args.ckpt, windows, dev),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}
        print(f"ours, same windows: {result['ppl_ours_same_windows']}",
              flush=True)

    def write():
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}", flush=True)

    if args.skip_binary:
        write()
        return 0
    try:
        binary = build_binary(args.reference_tree)
    except MissingReference as e:
        write()
        print(f"ref_baseline: {e}", file=sys.stderr, flush=True)
        return 2
    prompt = windows[0][:8] if windows else [1, 3, 4, 5, 9, 7, 11, 13]
    result["perf"] = {}
    for tag, model in (("q4_0", q4_bin), ("f32", f32_bin)):
        r = perf_run(binary, model, prompt, args.n_predict, 1)
        result["perf"][f"{tag}_t1"] = r
        print(f"  {tag} threads=1: {r['tokens_per_s']} tok/s "
              f"({r['ms_per_token']} ms/tok)", flush=True)
    if not args.skip_ppl:
        ppl = {}
        for tag, model in (("f32", f32_bin), ("q4_0", q4_bin)):
            tot, n = 0.0, 0
            for w in windows:
                nll, cnt = window_nll(binary, model, w)
                tot += nll
                n += cnt
            ppl[tag] = {"ppl": round(float(np.exp(tot / n)), 4),
                        "nll": round(tot / n, 6), "positions": n}
        ppl["delta_q4_vs_f32"] = round(ppl["q4_0"]["ppl"]
                                       - ppl["f32"]["ppl"], 4)
        ppl["delta_pct"] = round(
            100 * (ppl["q4_0"]["ppl"] / ppl["f32"]["ppl"] - 1), 3)
        result["ppl_reference"] = ppl
    # keep rows another tool wrote (ref_baseline_12b's 12B perf row)
    if os.path.exists(args.out):
        with open(args.out) as f:
            old = json.load(f)
        for k, v in old.get("perf", {}).items():
            result["perf"].setdefault(k, v)
    write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
