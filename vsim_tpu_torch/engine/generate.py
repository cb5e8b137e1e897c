"""Inference engine: prefill + token-at-a-time decode (port of
vsim_tpu/engine/generate.py).

Load-time transforms (``engine_params``, shared with the serving engine), as
in the JAX engine: pad a misaligned Q4 lm head to a multiple of 1024 (the
kernels' column tiles need aligned O; logits are sliced back to n_vocab),
fuse q/k/v into one head-interleaved weight, split the layers and repack
every weight with K % 64 == 0 to plane-split.

``generate`` prefills the whole prompt from an empty cache (attending over
its own full-precision k/v), then decodes in a Python loop with sampling on
the device.  It syncs to the host once per chunk of ``decode_chunk`` tokens,
never once per token; tokens computed past a stop token are discarded.
The JAX engine's recompile buckets (prompt padding to a power of two, kv
length buckets) and its lax.scan chunks have no counterpart: PyTorch runs
eagerly, so nothing recompiles.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from vsim_tpu_torch import monitor
from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.engine.sampling import SamplingParams, sample_torch
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import (
    fuse_qkv_params,
    params_to,
    prepare_unrolled_params,
)
from vsim_tpu_torch.models.transformer import forward, init_cache, per_layer
from vsim_tpu_torch.quant.q4 import Q4Tensor

LM_HEAD_ALIGN = 1024


def engine_params(cfg: ModelConfig, params, device: torch.device):
    """The engines' params on ``device``: lm head padded, qkv fused, every
    Q4 weight plane-split, layers split into a per-layer list.  An engine's
    params (layers already a list) are shared as they are."""
    params = params_to(params, device)
    if isinstance(params["layers"], list):
        return params
    lm = params.get("lm_head")
    if isinstance(lm, Q4Tensor) and lm.out_features % LM_HEAD_ALIGN:
        params = dict(params, lm_head=lm.pad_out(LM_HEAD_ALIGN))
        b = params.get("lm_head_b")
        if b is not None:
            pad = params["lm_head"].out_features - b.shape[-1]
            params["lm_head_b"] = F.pad(b.to(torch.float32), (0, pad))
    if cfg.fuse_qkv:
        params = fuse_qkv_params(cfg, params)
    params = prepare_unrolled_params(params)
    return dict(params, layers=per_layer(params["layers"], cfg.n_layer))


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[int]  # generated tokens (prompt excluded)
    prompt_ids: List[int]
    logits: Optional[np.ndarray] = None  # [len(prompt), V] with return_logits
    timings: Optional[dict] = None


class InferenceEngine:
    """Single-model inference on one device (the CUDA card by default)."""

    def __init__(self, cfg: ModelConfig, params, *, n_ctx: Optional[int] = None,
                 kv_dtype=None, device: DeviceLike = None,
                 decode_chunk: int = 64):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_ctx = n_ctx or cfg.n_ctx
        self.kv_dtype = kv_dtype or cfg.kv_dtype
        if decode_chunk < 1:
            raise ValueError("decode_chunk must be >= 1")
        self.decode_chunk = decode_chunk
        self.params = engine_params(cfg, params, self.device)

    def new_cache(self, batch: int = 1):
        return init_cache(self.cfg, batch, n_ctx=self.n_ctx,
                          dtype=self.kv_dtype, device=self.device)

    def generate(self, prompt_ids: Sequence[int], n_predict: int = 100,
                 sampling: Optional[SamplingParams] = None, *,
                 stop_tokens: Sequence[int] = (),
                 streaming_token_hook: Optional[Callable[[int], None]] = None,
                 return_logits: bool = False) -> GenerationResult:
        """Generate tokens for one prompt.  ``return_logits`` returns the
        full-vocab logits of every prompt position instead (greedy parity
        mode, vsim.cpp:827-873)."""
        sp = sampling or SamplingParams()
        prompt_ids = [int(t) for t in prompt_ids]
        n_prompt = len(prompt_ids)
        if n_prompt < 1:
            raise ValueError("empty prompt")
        if not all(0 <= t < self.cfg.n_vocab for t in prompt_ids):
            raise ValueError(f"prompt token outside [0, {self.cfg.n_vocab})")
        if n_prompt + n_predict > self.n_ctx:
            raise ValueError(f"prompt({n_prompt}) + n_predict({n_predict}) "
                             f"exceeds n_ctx={self.n_ctx}")
        cfg, dev = self.cfg, self.device

        t0 = time.perf_counter()
        cache = self.new_cache(batch=1)
        ids = torch.tensor([prompt_ids], dtype=torch.long, device=dev)
        with monitor.span("prefill"):
            logits, cache = forward(cfg, self.params, ids, cache, 0,
                                    fresh_kv=True)
            if return_logits:
                out = logits[0].cpu().numpy()
                return GenerationResult(
                    token_ids=[], prompt_ids=prompt_ids, logits=out,
                    timings={"prefill_s": time.perf_counter() - t0})
            last = logits[:, -1, :]
            if dev.type == "cuda":  # so prefill_s is the prefill's time
                torch.cuda.synchronize(dev)
        t_prefill = time.perf_counter()

        seed = sp.seed if sp.seed >= 0 else int(time.time())
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        W = max(sp.repeat_last_n, 1)  # noqa: N806
        window = ([-1] * W + prompt_ids)[-W:]
        last_tokens = torch.tensor([window], dtype=torch.long, device=dev)
        kw = dict(top_k=sp.top_k, top_p=sp.top_p, temperature=sp.temperature,
                  repeat_penalty=sp.repeat_penalty, greedy=sp.greedy)

        def sample(lg):
            nonlocal last_tokens
            tok = sample_torch(lg, last_tokens, gen, **kw)
            last_tokens = torch.cat([last_tokens[:, 1:], tok[:, None]], dim=1)
            return tok

        tok = sample(last)  # the first token comes from the prefill logits
        stop = set(int(t) for t in stop_tokens)
        generated: List[int] = []
        pending = [tok]  # device tokens of the chunk in flight
        n_past, n_dispatched = n_prompt, 1
        with monitor.span("decode"):
            while True:
                steps = min(self.decode_chunk, n_predict - n_dispatched,
                            self.n_ctx - 1 - n_past)
                for _ in range(max(steps, 0)):
                    logits, cache = forward(cfg, self.params, tok[:, None],
                                            cache, n_past)
                    tok = sample(logits[:, -1, :])
                    pending.append(tok)
                    n_past += 1
                    n_dispatched += 1
                host = torch.cat(pending).tolist()  # one sync per chunk
                pending = []
                done = steps <= 0
                for t in host:
                    generated.append(t)
                    if streaming_token_hook is not None:
                        streaming_token_hook(t)
                    if t in stop or len(generated) >= n_predict:
                        done = True
                        break
                if done:
                    break
        t_done = time.perf_counter()

        n_gen = len(generated)
        decode_s = t_done - t_prefill
        timings = {
            "prefill_s": t_prefill - t0,
            "decode_s": decode_s,
            "tokens": n_gen,
            "tokens_per_s": (n_gen - 1) / decode_s
            if n_gen > 1 and decode_s > 0 else float("nan"),
        }
        return GenerationResult(token_ids=generated, prompt_ids=prompt_ids,
                                timings=timings)
