"""Train a small byte-level GPT-NeoX with the port's trainer, then measure
its Q4_0 quantization perplexity table (port of tools/train_small.py).

The recipe is the JAX tool's, step for step:

  1. a byte corpus from the Python stdlib sources on disk (every 17th file
     of the sorted list held out for evaluation; ``site-packages`` and
     ``test`` directories skipped),
  2. a 25M-parameter GPT-NeoX (``CFG``: E 512, L 8, H 8, n_rot 16, bf16
     compute) from ``init_params(seed 0)``, trained by
     ``engine/train.py:make_train_step`` with the recipe's optimizer
     (``optax.chain(clip_by_global_norm(1.0), adamw(
     warmup_cosine_decay_schedule(...), weight_decay=0.01))``: torch's
     AdamW behind the clip and the schedule), on [B, T + 1] windows drawn
     by a seed-0 ``default_rng``.  The JAX tool forwards all T + 1 tokens
     and drops the last logit; ``cross_entropy_loss`` forwards the first
     T, whose logits a causal model gives alike, to the same targets,
  3. the dense checkpoint saved with ``convert/store.py`` (the JAX
     package's format: its ``load_params`` reads it unchanged),
  4. held-out perplexity in windows of n_ctx for f32 and bf16 compute, Q4_0
     weights, and Q4_0 weights with Q4_0 activations.

On the card the forward runs K4 (bf16 compute in training, f32 in the f32
and Q4 rows), the backward K7/K8.  The Q4 rows' 512-token windows take the
dequantize + matmul route (``ops/matmul.py``: past 128 rows).

Writes ``ppl.json`` (the table, as the JAX tool writes it) and
``train.json`` (steps, losses, step ms, tokens/s, each row's NLL and
seconds) into ``--out`` (default ``build/minipythia`` in the checkout).

Usage:
  python -m vsim_tpu_torch.tools.train_small --steps 3000
  python -m vsim_tpu_torch.tools.train_small --eval-only
  python -m vsim_tpu_torch.tools.train_small --device cpu --steps 2 \\
      --batch 2 --eval-tokens 2000 --out build/minipythia_cpu
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sysconfig
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from vsim_tpu_torch.convert.store import load_params, save_params
from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.engine.evaluate import perplexity
from vsim_tpu_torch.engine.train import make_train_step
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import init_params
from vsim_tpu_torch.quant.q4 import Q4Tensor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "build", "minipythia")

CFG = ModelConfig(
    arch="gptneox", n_vocab=256, n_ctx=512, n_embd=512, n_head=8,
    n_layer=8, n_ff=2048, n_rot=16, compute_dtype="bfloat16",
)


def build_corpus(max_bytes: int = 12_000_000):
    """(train bytes, eval bytes) as uint8 arrays from the Python stdlib on
    disk.  Every 17th file (sorted order) is held out for eval, so eval
    text is unseen files, not a tail split of seen ones."""
    stdlib = sysconfig.get_paths()["stdlib"]
    files = []
    for root, _, names in os.walk(stdlib):
        if "site-packages" in root or "test" in root.split(os.sep):
            continue
        for n in sorted(names):
            if n.endswith(".py"):
                files.append(os.path.join(root, n))
    files.sort()
    train, evl = [], []
    tb = eb = 0
    for i, fn in enumerate(files):
        try:
            with open(fn, "rb") as f:
                data = f.read()
        except OSError:
            continue
        if i % 17 == 0:
            if eb < max_bytes // 20:
                evl.append(data)
                eb += len(data)
        elif tb < max_bytes:
            train.append(data)
            tb += len(data)
    train_b = np.frombuffer(b"\n".join(train), np.uint8)
    eval_b = np.frombuffer(b"\n".join(evl), np.uint8)
    return train_b, eval_b


# -- the optimizer: optax.chain(clip_by_global_norm, adamw(schedule)) -------

def lr_schedule(steps: int, peak: float = 3e-4) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps=min(100,
    max(1, steps // 10)), decay_steps=max(steps, warmup + 1), end_value=
    peak / 10)`` as a function of the update count (0 for the first
    update), in float32 and in optax's order of operations."""
    f32 = np.float32
    warmup = min(100, max(1, steps // 10))
    decay = max(steps, warmup + 1) - warmup
    end = peak * 0.1
    alpha = end / peak

    def lr(count: int) -> float:
        if count < warmup:  # linear_schedule(0, peak, warmup)
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        c = min(f32(count - warmup), f32(decay))  # cosine_decay_schedule
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return float(f32(peak) * (f32(1 - alpha) * cos + f32(alpha)))

    return lr


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """``optax.clip_by_global_norm``, in place: every gradient becomes
    ``g / norm * max_norm`` where the global norm is at least ``max_norm``,
    and stays as it is below (``clip_grad_norm_`` divides by norm + 1e-6
    and would not match).  No host sync: the test runs on the device.
    Returns the norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class RecipeAdamW(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(1.0), adamw(schedule,
    weight_decay=0.01))`` as torch's AdamW: betas (0.9, 0.999), eps 1e-8
    and decoupled decay 0.01 of every leaf (optax's ``mask=None``).  Each
    step clips the gradients first, then takes the lr from ``schedule`` at
    the update count before its increment, so the first update has
    ``schedule(0)``."""

    def __init__(self, params, schedule: Callable[[int], float]):
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=0.01)
        self.schedule, self.count = schedule, 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RecipeAdamW takes no closure")
        clip_by_global_norm_([p.grad for g in self.param_groups
                              for p in g["params"] if p.grad is not None],
                             1.0)
        for group in self.param_groups:
            group["lr"] = self.schedule(self.count)
        self.count += 1
        return super().step()


def recipe_optimizer(steps: int, lr: float = 3e-4):
    """The recipe's optimizer factory for ``make_train_step``."""
    schedule = lr_schedule(steps, lr)
    return lambda leaves: RecipeAdamW(leaves, schedule)


def draw_batches(train_b: np.ndarray, steps: int, batch: int, T: int,  # noqa: N803
                 seed: int = 0) -> np.ndarray:
    """Every step's [batch, T + 1] window of the train bytes, uint8
    [steps, batch, T + 1], from ``default_rng(seed)`` in the JAX loop's
    order (one ``integers`` draw of ``batch`` starts a step)."""
    rng = np.random.default_rng(seed)
    out = np.empty((steps, batch, T + 1), np.uint8)
    for i in range(steps):
        starts = rng.integers(0, train_b.size - T - 1, batch)
        out[i] = np.stack([train_b[s:s + T + 1] for s in starts])
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg: ModelConfig, train_b: np.ndarray, steps: int, *,
          batch: int = 16, lr: float = 3e-4, device: DeviceLike = None,
          log: Optional[Callable[[str], None]] = print):
    """The recipe's training run: (params, stats).  The loss is read (a
    host sync) at step 0, every 200th step and the last, as the JAX loop
    logs it.  ``stats``: those losses, the first step's seconds (kernel
    builds included where a kernel is first used), the mean ms of the other
    steps (synced at the end), tokens/s counting the B x T tokens a step
    trains on, and the run's seconds."""
    dev = resolve_device(device)
    T = cfg.n_ctx  # noqa: N806
    t_start = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    init_fn, step_fn = make_train_step(cfg, recipe_optimizer(steps, lr))
    state = init_fn(params)
    ids_all = torch.from_numpy(draw_batches(train_b, steps, batch, T)).to(dev)
    losses: Dict[int, float] = {}
    _sync(dev)
    t0 = t1 = time.perf_counter()
    first_s = 0.0
    for i in range(steps):
        _, state, loss = step_fn(params, state, ids_all[i].long())
        if i % 200 == 0 or i == steps - 1:
            losses[i] = float(loss)
            if log:
                log(f"step {i:5d} loss {losses[i]:.4f} "
                    f"({time.perf_counter() - t0:.0f}s)")
        if i == 0:
            _sync(dev)
            t1 = time.perf_counter()
            first_s = t1 - t0
    _sync(dev)
    t_end = time.perf_counter()
    step_ms = (t_end - t1) / (steps - 1) * 1e3 if steps > 1 else None
    tokens = batch * T
    stats = dict(steps=steps, batch=batch, tokens_per_step=tokens,
                 losses=losses, first_step_s=first_s, step_ms=step_ms,
                 tokens_per_s=tokens / step_ms * 1e3 if step_ms else None,
                 train_s=t_end - t_start)
    return params, stats


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Dense trained tree -> Q4_0 tree (the set the reference quantizer
    takes: every 2-D ``.*weight`` incl. embeddings): each stacked [L, O, K]
    layer weight layer by layer, ``wte`` and ``lm_head``, through
    ``quantize_q4_0_np`` (bf16 scales), on the params' device."""
    def q4(t: torch.Tensor) -> Q4Tensor:
        w = t.detach().to("cpu", torch.float32).numpy()
        return Q4Tensor.from_dense_np(w, device=t.device)

    out = dict(params)
    layers = dict(params["layers"])
    for k, v in layers.items():
        if isinstance(v, torch.Tensor) and v.dim() == 3:
            qs = [q4(v[i]) for i in range(v.shape[0])]
            layers[k] = Q4Tensor(torch.stack([q.packed for q in qs]),
                                 torch.stack([q.scales for q in qs]))
    out["layers"] = layers
    for k in ("wte", "lm_head"):
        v = params[k]
        if isinstance(v, torch.Tensor) and v.dim() == 2:
            out[k] = q4(v)
    return out


EVAL_ROWS = ("f32", "bf16", "q4", "q4_act_quant")


def eval_rows(cfg: ModelConfig, params, tokens: np.ndarray,
              qparams=None, log: Optional[Callable[[str], None]] = print
              ) -> Dict[str, Dict[str, float]]:
    """``engine/evaluate.py:perplexity`` (windows of n_ctx) of each row of
    EVAL_ROWS: {row: {"nll", "tokens", "ppl", "seconds"}}.  bf16 is
    ``cfg``'s compute (the recipe's); the others f32."""
    qparams = quantize_params(params) if qparams is None else qparams
    f32 = cfg.replace(compute_dtype="float32")
    cases = {"f32": (f32, params), "bf16": (cfg, params),
             "q4": (f32, qparams),
             "q4_act_quant": (f32.replace(act_quant=True), qparams)}
    dev = next(iter(params["layers"].values())).device
    out = {}
    for name in EVAL_ROWS:
        c, p = cases[name]
        _sync(dev)
        t0 = time.perf_counter()
        r = perplexity(c, p, tokens)
        r["seconds"] = time.perf_counter() - t0
        out[name] = r
        if log:
            log(f"{name:14s} ppl={r['ppl']:.4f}  ({r['tokens']} toks, "
                f"{r['seconds']:.0f}s)")
    return out


def ppl_table(rows: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """The JAX tool's table: each row's ppl and the two deltas, to 4
    places."""
    table = {k: round(rows[k]["ppl"], 4) for k in EVAL_ROWS}
    table["delta_q4_vs_f32"] = round(table["q4"] - table["f32"], 4)
    table["delta_q4aq_vs_f32"] = round(table["q4_act_quant"] - table["f32"],
                                       4)
    return table


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--eval-tokens", type=int, default=200_000)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"device={device_name(dev)}", flush=True)
    train_b, eval_b = build_corpus()
    print(f"corpus: train={train_b.size / 1e6:.1f}MB "
          f"eval={eval_b.size / 1e6:.1f}MB", flush=True)
    log = lambda s: print(s, flush=True)  # noqa: E731

    cfg, stats = CFG, {}
    if args.eval_only:
        cfg_l, params = load_params(args.out, device=dev)
        cfg = cfg_l.replace(compute_dtype="bfloat16")
    else:
        params, stats = train(cfg, train_b, args.steps, batch=args.batch,
                              lr=args.lr, device=dev, log=log)
        save_params(args.out, cfg, params)
        print(f"saved to {args.out}; step {stats['step_ms']} ms, "
              f"{stats['tokens_per_s']} tokens/s, training "
              f"{stats['train_s']:.1f} s", flush=True)

    rows = eval_rows(cfg, params, eval_b[: args.eval_tokens].astype(np.int64),
                     log=log)
    table = ppl_table(rows)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "ppl.json"), "w") as f:
        json.dump(table, f, indent=1)
    with open(os.path.join(args.out, "train.json"), "w") as f:
        json.dump(dict(device=device_name(dev), **stats, eval=rows), f,
                  indent=1)
    print(json.dumps(table), flush=True)
    return table


if __name__ == "__main__":
    main()
