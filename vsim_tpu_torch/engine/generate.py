"""Inference engine: prefill + token-at-a-time decode (port of
vsim_tpu/engine/generate.py).

Load-time transforms (``engine_params``, shared with the serving engine), as
in the JAX engine: pad a misaligned Q4 lm head to a multiple of 1024 (the
kernels' column tiles need aligned O; logits are sliced back to n_vocab),
fuse q/k/v into one head-interleaved weight, split the layers and repack
every weight with K % 64 == 0 to plane-split.  ``unroll_layers=False``
keeps the layers stacked in the interleaved layout instead (the JAX
engine's scan form: each layer's matmuls select their layer inside K10,
from an index built once here).

``generate`` prefills the whole prompt (attending over its own
full-precision k/v) into the engine's one batch-1 cache, made once, then
decodes in chunks of ``decode_chunk`` tokens.  A decode step
(``_decode_step``) keeps its state in static device buffers of B rows,
updated in place: the tokens, an int32 n_past (so the step writes its cache
rows and runs K3 with no Python int in it, ``forward(write_first=True)``),
the repeat window and a ring of the steps' tokens.  On the card the step is
captured once as a CUDA graph per dequant math, sampling setting, window,
KV dtype and B, after one eager step, and replayed (engine/graph.py): the
JAX engine's ``_decode_many`` chunk, one dispatch a step.  The host syncs
once per chunk, to read the ring; tokens computed past a stop token are
discarded.  ``cuda_graph=False`` runs the same step eagerly on the card;
the CPU always runs it eagerly.

The JAX engine's batched internals keep their names: ``_prefill`` runs
[B, T] prompts into a cache from ``new_cache(B)``, and ``_decode_many``
runs ``n_steps`` steps over B rows of that cache and returns their tokens
[n_steps, B] (the benchmarks drive these).  A graph holds the addresses of
the cache and the ring it was captured on: a call with a cache elsewhere
in memory, or with more steps than the ring holds, drops the graphs of
that (window, B) state and captures anew.  The JAX engine's recompile
buckets (prompt padding to a power of two, kv length buckets) and cache
donation have no counterpart.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import weakref
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from vsim_tpu_torch import monitor
from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.engine.graph import CudaGraph, GraphedStep
from vsim_tpu_torch.engine.sampling import SamplingParams, sample_torch
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import (
    fuse_qkv_params,
    params_to,
    prepare_unrolled_params,
)
from vsim_tpu_torch.models.transformer import (
    alibi_slopes,
    forward,
    init_cache,
    per_layer,
)
from vsim_tpu_torch.ops.q4_cuda import get_dequant_math
from vsim_tpu_torch.quant.q4 import Q4Tensor

LM_HEAD_ALIGN = 1024


def pad_and_fuse(cfg: ModelConfig, params):
    """The load-time transforms that keep the layers stacked: a misaligned
    Q4 lm head (and its bias) padded to a multiple of 1024, q/k/v fused
    when the config says so.  Returns a new dict (or ``params``)."""
    lm = params.get("lm_head")
    if isinstance(lm, Q4Tensor) and lm.out_features % LM_HEAD_ALIGN:
        params = dict(params, lm_head=lm.pad_out(LM_HEAD_ALIGN))
        b = params.get("lm_head_b")
        if b is not None:
            pad = params["lm_head"].out_features - b.shape[-1]
            params["lm_head_b"] = F.pad(b.to(torch.float32), (0, pad))
    if cfg.fuse_qkv:
        params = fuse_qkv_params(cfg, params)
    return params


def engine_params(cfg: ModelConfig, params, device: torch.device, *,
                  unroll_layers: bool = True, plane_split: bool = True):
    """The engines' params on ``device``: lm head padded, qkv fused and
    layers as a per-layer list of dicts, by default with every Q4 weight
    plane-split.  ``unroll_layers=False`` keeps each Q4 weight stacked in
    the interleaved layout, reached through a ``Q4Layer`` per layer (K10
    and, for the lm head, K9); ``plane_split=False`` keeps per-layer
    interleaved weights (K9).  An engine's params (layers already a list)
    are shared as they are."""
    params = params_to(params, device)
    if isinstance(params["layers"], list):
        return params
    params = pad_and_fuse(cfg, params)
    if unroll_layers:
        params = prepare_unrolled_params(params, plane_split=plane_split)
    return dict(params, layers=per_layer(params["layers"], cfg.n_layer))


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[int]  # generated tokens (prompt excluded)
    prompt_ids: List[int]
    logits: Optional[np.ndarray] = None  # [len(prompt), V] with return_logits
    timings: Optional[dict] = None


def sampling_kw(sp: SamplingParams) -> dict:
    """The sampling settings a captured step bakes in (the JAX engines'
    ``_STEP_STATIC``, vsim_tpu/engine/serving.py:75), as ``sample_torch``
    keywords."""
    return dict(top_k=sp.top_k, top_p=sp.top_p, temperature=sp.temperature,
                repeat_penalty=sp.repeat_penalty, greedy=sp.greedy)


def graph_maker(device: torch.device, cuda_graph: Optional[bool],
                generator: torch.Generator):
    """What ``GraphedStep`` captures with on ``device``: None (eager steps)
    on the CPU or with ``cuda_graph=False``; graphs are on by default on
    the card."""
    if cuda_graph is None:
        cuda_graph = device.type == "cuda"
    if not cuda_graph:
        return None
    if device.type != "cuda":
        raise ValueError("cuda_graph needs a CUDA device")
    return lambda: CudaGraph(generator)


@dataclasses.dataclass
class DecodeState:
    """A decode step's static device buffers, for one repeat window W and
    B rows, and the cache its steps run on."""

    tok: torch.Tensor  # [B] int64: the tokens the next step feeds
    n_past: torch.Tensor  # [B] int32: cache rows before them
    last: torch.Tensor  # [B, W] int64: the repeat windows, -1 padded
    ring: torch.Tensor  # [R, B] int64: the steps' tokens
    pos: torch.Tensor  # [1] int64: the ring slot of the next tokens
    cache: Optional[dict] = None  # set for the steps of one call
    cache_at: tuple = ()  # the addresses its graphs were captured on


def cache_addresses(cache) -> tuple:
    """The data pointers of a cache's tensors: where a captured step reads
    and writes it."""
    leaves = []
    for side in (cache["k"], cache["v"]):
        leaves += list(side) if isinstance(side, tuple) else [side]
    return tuple(t.data_ptr() for t in leaves)


class InferenceEngine:
    """Single-model inference on one device (the CUDA card by default)."""

    def __init__(self, cfg: ModelConfig, params, *, n_ctx: Optional[int] = None,
                 kv_dtype=None, device: DeviceLike = None,
                 decode_chunk: int = 64, unroll_layers: bool = True,
                 plane_split: bool = True,
                 cuda_graph: Optional[bool] = None):
        """``unroll_layers`` and ``plane_split`` as in the JAX engine
        (vsim_tpu/engine/generate.py:112-132): by default per-layer
        plane-split weights (K1/K2/K11); ``unroll_layers=False`` keeps the
        stacked interleaved weights and never plane-splits (K10, K9 for the
        lm head); ``plane_split=False`` gives per-layer interleaved weights
        (K9).  ``cuda_graph`` (default: on for a CUDA device) replays each
        decode step from a captured graph; False runs it eagerly."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_ctx = n_ctx or cfg.n_ctx
        self.kv_dtype = kv_dtype or cfg.kv_dtype
        if decode_chunk < 1:
            raise ValueError("decode_chunk must be >= 1")
        self.decode_chunk = decode_chunk
        self.params = engine_params(cfg, params, self.device,
                                    unroll_layers=unroll_layers,
                                    plane_split=plane_split)
        self.slopes = (alibi_slopes(cfg.n_head, self.device) if cfg.alibi
                       else None)
        self.generator = torch.Generator(device=self.device)
        self._make_graph = graph_maker(self.device, cuda_graph,
                                       self.generator)
        self.cache = None  # the decode cache, made at first use
        self._states: dict = {}  # (W, B) -> DecodeState
        # (math, sampling, W, kv dtype, B) -> GraphedStep
        self._steps: dict = {}

    def new_cache(self, batch: int = 1):
        return init_cache(self.cfg, batch, n_ctx=self.n_ctx,
                          dtype=self.kv_dtype, device=self.device)

    def _state(self, W: int, B: int = 1, cache=None,  # noqa: N803
               ring: Optional[int] = None) -> DecodeState:
        """The buffers of window W over B rows, set to run on ``cache``
        (the engine's own by default) with a ring of at least ``ring``
        rows (``decode_chunk`` by default).  A ring too short, or a cache
        at other addresses than the state's graphs were captured on, drops
        those graphs and their state: the next step captures anew."""
        cache = self.cache if cache is None else cache
        ring = ring or self.decode_chunk
        at = cache_addresses(cache)
        st = self._states.get((W, B))
        if st is not None and (st.ring.shape[0] < ring
                               or st.cache_at != at):
            self._steps = {k: v for k, v in self._steps.items()
                           if (k[2], k[4]) != (W, B)}
            st = None
        if st is None:
            dev = self.device
            st = self._states[(W, B)] = DecodeState(
                tok=torch.zeros(B, dtype=torch.long, device=dev),
                n_past=torch.zeros(B, dtype=torch.int32, device=dev),
                last=torch.full((B, W), -1, dtype=torch.long, device=dev),
                ring=torch.zeros((ring, B), dtype=torch.long, device=dev),
                pos=torch.zeros(1, dtype=torch.long, device=dev),
                cache_at=at)
        st.cache = cache
        return st

    def _decode_step(self, st: DecodeState, kw: dict) -> None:
        """One decode step on the static buffers: the forward at device
        n_past (rows written, then K3), sampling, the window shift, n_past
        + 1 and the tokens into ring slot ``pos``."""
        logits, _ = forward(self.cfg, self.params, st.tok[:, None],
                            st.cache, st.n_past, write_first=True,
                            slopes=self.slopes)
        tok = sample_torch(logits[:, -1, :], st.last, self.generator, **kw)
        st.last.copy_(torch.cat([st.last[:, 1:], tok[:, None]], dim=1))
        st.tok.copy_(tok)
        st.n_past.add_(1)
        st.ring.index_copy_(0, st.pos, tok[None])
        st.pos.add_(1).remainder_(st.ring.shape[0])

    def _step(self, sp: SamplingParams, st: DecodeState) -> GraphedStep:
        """The step of this dequant math, sampling setting, window, KV
        dtype and batch on ``st``: a graph captured under one math, or for
        one B, never replays under another."""
        kw = sampling_kw(sp)
        B, W = st.last.shape  # noqa: N806
        key = (get_dequant_math(), tuple(kw.values()), W, str(self.kv_dtype),
               B)
        step = self._steps.get(key)
        if step is None:
            # through a weak proxy: the engine's steps hold no reference
            # cycle, so a dropped engine frees its cache and graphs at once
            step = self._steps[key] = GraphedStep(
                functools.partial(InferenceEngine._decode_step,
                                  weakref.proxy(self), st, kw),
                self._make_graph)
        return step

    def _prefill(self, token_ids: torch.Tensor, cache) -> tuple:
        """Prompts [B, T] into ``cache`` (from ``new_cache(B)``) at n_past
        = 0, attending over their own full-precision k/v: (logits [B, T,
        n_vocab] f32, cache)."""
        return forward(self.cfg, self.params, token_ids, cache, 0,
                       fresh_kv=True, slopes=self.slopes)

    def _decode_many(self, tok: torch.Tensor, cache, n_past,
                     last: torch.Tensor, n_steps: int,
                     sampling: SamplingParams) -> torch.Tensor:
        """``n_steps`` decode steps over the B rows of ``cache``: ``tok``
        [B] are the tokens the first step feeds, at ``n_past`` (an int, or
        an int [B] tensor) cache rows; ``last`` [B, W] the repeat windows,
        updated in place.  Sampled steps draw from ``self.generator``.
        Returns the tokens [n_steps, B] (int64, on the host), read once
        after the last step."""
        B, W = last.shape  # noqa: N806
        if tok.shape != (B,):
            raise ValueError(f"tok must be [{B}], got {list(tok.shape)}")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if not isinstance(n_past, torch.Tensor) and \
                n_past + n_steps > self.n_ctx:
            raise ValueError(f"n_past({n_past}) + n_steps({n_steps}) "
                             f"exceeds n_ctx={self.n_ctx}")
        st = self._state(W, B, cache, n_steps)
        step = self._step(sampling, st)
        st.tok.copy_(tok)
        if isinstance(n_past, torch.Tensor):
            st.n_past.copy_(n_past)
        else:
            st.n_past.fill_(n_past)
        st.last.copy_(last)
        st.pos.zero_()
        try:
            for _ in range(n_steps):
                step()
            last.copy_(st.last)
            return st.ring[:n_steps].to("cpu", copy=True)
        finally:
            st.cache = None  # the caller's cache is the caller's to free

    def prefill(self, prompt_ids: List[int]) -> torch.Tensor:
        """The prompt into the decode cache (made at first use); returns
        the logits [1, T, n_vocab]."""
        if self.cache is None:
            self.cache = self.new_cache(batch=1)
        ids = torch.tensor([prompt_ids], dtype=torch.long, device=self.device)
        logits, _ = self._prefill(ids, self.cache)
        return logits

    def start(self, prompt_ids: List[int], last_logits: torch.Tensor,
              sp: SamplingParams) -> tuple:
        """Seed the generator, sample the first token from the prompt's
        last logits [1, V] and load the step's buffers for decoding after
        the prompt: (first token [1], state, step)."""
        seed = sp.seed if sp.seed >= 0 else int(time.time())
        self.generator.manual_seed(seed)
        W = max(sp.repeat_last_n, 1)  # noqa: N806
        window = torch.tensor([([-1] * W + prompt_ids)[-W:]],
                              dtype=torch.long, device=self.device)
        st = self._state(W)
        step = self._step(sp, st)
        tok = sample_torch(last_logits, window, self.generator,
                           **sampling_kw(sp))
        st.last.copy_(torch.cat([window[:, 1:], tok[:, None]], dim=1))
        st.tok.copy_(tok)
        st.n_past.fill_(len(prompt_ids))
        st.pos.zero_()
        return tok, st, step

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
        dev = self.device

        t0 = time.perf_counter()
        with monitor.span("prefill"):
            logits = self.prefill(prompt_ids)
            if return_logits:
                out = logits[0].cpu().numpy()
                return GenerationResult(
                    token_ids=[], prompt_ids=prompt_ids, logits=out,
                    timings={"prefill_s": time.perf_counter() - t0})
            last = logits[:, -1, :]
            if dev.type == "cuda":  # so prefill_s is the prefill's time
                torch.cuda.synchronize(dev)
        t_prefill = time.perf_counter()

        # the first token comes from the prefill logits
        first, st, step = self.start(prompt_ids, last, sp)
        stop = set(int(t) for t in stop_tokens)
        generated: List[int] = []
        n_past, n_dispatched = n_prompt, 1
        with monitor.span("decode"):
            while True:
                steps = max(min(self.decode_chunk, n_predict - n_dispatched,
                                self.n_ctx - 1 - n_past), 0)
                st.pos.zero_()
                for _ in range(steps):
                    step()
                n_past += steps
                n_dispatched += steps
                toks = st.ring[:steps, 0]  # one sync per chunk
                if first is not None:
                    toks, first = torch.cat([first, toks]), None
                done = steps <= 0
                for t in toks.tolist():
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
