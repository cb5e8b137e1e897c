"""Continuous-batching serving engine (port of vsim_tpu/engine/serving.py).

Many concurrent requests share one weights-resident model: each decode step
is one batched forward over ``max_batch`` slots, every slot at its own cache
length (ragged ``n_past``, models/transformer.py), so one sweep of the Q4
weights serves up to ``max_batch`` tokens.  The cache is one dense
head-major [L, max_batch, H, n_ctx, D] block, one slot per request.

  * ``submit()`` queues a request.
  * Admission claims a free slot for every queued request it can and
    prefills them together: only the admitted rows, at the longest admitted
    prompt, into a scratch cache of that length whose rows are then copied
    into the claimed slots.  Slots past a prompt's end hold padding that is
    never read: a decode step attends rows < n_past only.
  * ``step()`` / ``step_chunk(n)`` advance every active slot by one / up to
    n tokens.  The slot state (next token, n_past, repeat window, active
    mask, token budget) lives in static device buffers, updated in place.
    A chunk runs its steps with no host sync and brings its tokens back in
    one transfer at its end, from a device ring of tokens and active masks.
    Within a chunk a slot stops on the device when it emits a stop id that
    all active requests share (a fixed-width vector padded with -1,
    ``pad_stop_ids``) or spends its token budget; from then on it carries
    n_past = n_ctx, the write-nothing sentinel, and its token, n_past and
    window stay as they are.  Request-specific stop ids are honoured on the
    host.
  * On the card the step (``_serve_step``) is captured once as a CUDA
    graph per dequant math, after one eager step, and replayed
    (engine/graph.py): the JAX engine's ``_step_many`` chunk, one dispatch
    a step.  ``warmup()`` captures it; ``cuda_graph=False`` runs the step
    eagerly on the card, and the CPU always does.  Admission stays eager.
  * ``run()`` serves a list of prompts to completion.
  * With a ``drafter`` (an ``NgramDrafter``, engine/speculative.py; greedy
    sampling only) every step is speculative (``_spec_step``): the drafter
    proposes gamma tokens per slot from the slot's token history (a
    [max_batch, n_ctx + 1] device buffer whose last column is a sink for
    writes out of range), one ragged forward of gamma + 1 tokens a slot
    verifies them (inactive slots at the sentinel n_past), and each slot
    advances by its own accepted prefix + 1.  The host reads each step's
    tokens.  While an active slot has no room for a full gamma + 1
    advance, plain one-token steps run instead (they leave the history as
    it is, as the JAX engine's do).  ``step_chunk`` takes one speculative
    step and ``run`` steps one at a time.  The step is captured and
    replayed like ``_serve_step``.

Sharded serving: with ``mesh=`` (parallel/mesh.py, a ``data`` x ``model``
grid of ranks, each rank running this same host program over all
``max_batch`` slots, with the JAX engine's free list, so every rank admits
and retires the same requests) the params are padded and fused, sharded in
the stacked interleaved layout (parallel/sharding.py; a plane-split K
split would not be one) and kept stacked, so the step runs K10 for the
layers, K9 for the lm head rows, K5 + K6 over the rank's heads and K4 at
admission.  A weight the JAX specs replicate (a K split that would cut a
Q4 block, a vocabulary that does not divide) is held whole and run on its
gathered input (models/transformer.py).  Data rank r holds slots
[r * B / d, (r + 1) * B / d) and their device state (tokens, n_past,
repeat window, live mask, budget, ring, drafter history): a cache of
[L, B / d, H / tp, n_ctx, D].  Admission prefills the admitted requests
whose slots the rank holds; the model axis's collectives run inside each
model group, which shares those rows.  Once a chunk, after its device
work, the ring of this rank's slots is exchanged over the data axis
(``parallel/context.py:all_gather``; a speculative step's emitted tokens
once a step, admission's first tokens once an admission), and the host
reads every slot's tokens from it: the ``serve/exchange`` span.  A sampled
step draws one uniform for every slot on every rank and keeps its own
(``sample_torch(uniform=)``), so a seeded stream does not depend on the
data split.  The model's collectives give every rank of a model group the
whole logits, so they sample and accept alike.  Over NCCL the step is
captured and replayed as on one card (its first, eager call is the
collectives' warm-up), the speculative step too; over gloo a model axis
above 1 runs its collectives through the host, which a graph cannot
capture, so the step runs eagerly and ``cuda_graph=True`` raises.  The
exchange stays outside the captured step, so a mesh whose model axis is 1
replays its step from a graph over gloo as well.  What the JAX engine
cannot place raises ``ValueError``: heads that do not split over
``model``, ``max_batch`` that does not split over ``data``.

The JAX engine's recompile guards have no counterpart here: kv-length
buckets and admission padded to [max_batch, 16 * 2^k] with sentinel rows.
Monitor spans: ``serve/admit``, ``serve/step``, ``serve/step_chunk``,
``serve/spec_step``, ``serve/exchange``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch

from vsim_tpu_torch import monitor
from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.engine.generate import (
    engine_params,
    graph_maker,
    pad_and_fuse,
    sampling_kw,
)
from vsim_tpu_torch.engine.graph import GraphedStep
from vsim_tpu_torch.engine.sampling import SamplingParams, sample_torch
from vsim_tpu_torch.engine.speculative import NgramDrafter, accept
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import params_to
from vsim_tpu_torch.models.transformer import (
    alibi_slopes,
    forward,
    init_cache,
    per_layer,
)
from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.q4_cuda import get_dequant_math
from vsim_tpu_torch.parallel import context as pctx
from vsim_tpu_torch.parallel import sharding
from vsim_tpu_torch.parallel.mesh import AXIS_MODEL


def pad_stop_ids(ids: Sequence[int], width: int = 4) -> List[int]:
    """Stop ids padded with the -1 sentinel to ``width``, or to the next
    doubling of it that holds them all (vsim_tpu/engine/serving.py:
    _pad_stop_ids): a captured step keeps one static shape whatever number
    of stop ids the active requests share."""
    ids = [int(t) for t in ids]
    w = width
    while w < len(ids):
        w *= 2
    return ids + [-1] * (w - len(ids))


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_ids: List[int]
    n_predict: int
    stop_tokens: frozenset
    streaming_token_hook: Optional[Callable[[int], None]] = None
    # filled during serving
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_s: float = 0.0
    first_token_s: float = 0.0
    finished_s: float = 0.0


class ServingEngine:
    """Continuous batching over ``max_batch`` cache slots on one device
    (the CUDA card by default).  ``params`` may be another engine's
    already-transformed params; they are then shared, not copied."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 n_ctx: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None, seed: int = 0,
                 repeat_window: int = 64, kv_dtype=None,
                 device: DeviceLike = None,
                 cuda_graph: Optional[bool] = None, drafter=None,
                 mesh=None):
        """``cuda_graph`` (default: on for a CUDA device, off over a gloo
        mesh whose model axis is above 1) replays each serving step from a
        captured graph; False runs it eagerly.  ``drafter``: an
        ``NgramDrafter`` makes every step speculative (greedy sampling
        only).  ``mesh``: serve this rank's shard (its model-axis share of
        the stacked params and heads, its data-axis block of the slots, as
        the JAX engine's ``mesh=``); the device defaults to the mesh's."""
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if drafter is not None and not isinstance(drafter, NgramDrafter):
            raise ValueError(
                "ServingEngine drafts from the slots' token history only "
                "(NgramDrafter); a ModelDrafter would need a draft cache per "
                "slot: use SpeculativeEngine for one")
        self.mesh = mesh
        # this rank's slots [first, first + rows): a block of max_batch
        # over the mesh's data axis (all of them without one)
        self.rows, self.first = max_batch, 0
        if mesh is not None:
            cuda_graph = self._check_mesh(cfg, mesh, cuda_graph)
            self.rows, self.first = sharding.local_rows(max_batch, mesh)
            device = mesh.device if device is None else device
        with pctx.use_mesh(mesh):
            self._data = pctx.axis("batch")  # None: one rank on the axis
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.slopes = alibi_slopes(cfg.n_head, dev) if cfg.alibi else None
        self.heads = heads = cfg.n_head  # the heads this rank holds
        if mesh is None:
            self.params = engine_params(cfg, params, dev)
        else:
            if isinstance(params["layers"], list):
                raise ValueError("mesh= shards stacked params: pass the "
                                 "model's params, not an engine's")
            # pad and fuse the whole model, then shard; a shard is not
            # padded again (its lm head rows are 1/tp of a padded head)
            local = params_to(sharding.shard_params(
                pad_and_fuse(cfg, params), mesh), dev)
            self.params = dict(local, layers=per_layer(local["layers"],
                                                       cfg.n_layer))
            tp = mesh.size(AXIS_MODEL)
            self.heads = heads = cfg.n_head // tp
            if self.slopes is not None:
                self.slopes = self.slopes.narrow(
                    0, mesh.index(AXIS_MODEL) * heads, heads).contiguous()
        self.max_batch = max_batch
        self.n_ctx = n_ctx or cfg.n_ctx
        self.kv_dtype = kv_dtype or cfg.kv_dtype
        self.sampling = sp = sampling or SamplingParams(greedy=True)
        self._sample_kw = sampling_kw(sp)
        self.repeat_window = W = max(repeat_window, 1)  # noqa: N806

        R = self.rows  # noqa: N806
        self.cache = init_cache(cfg, R, n_ctx=self.n_ctx,
                                dtype=self.kv_dtype, device=dev, heads=heads)
        # device-resident state of this rank's slots, updated in place
        self.tokens = torch.zeros(R, dtype=torch.long, device=dev)
        self.n_past = torch.zeros(R, dtype=torch.int32, device=dev)
        self.last_tokens = torch.full((R, W), -1, dtype=torch.long,
                                      device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        # a chunk's inputs and outputs: the active mask and token budget
        # the chunk starts with, the shared stop ids, and the ring of each
        # step's tokens and active masks (rows grow with the longest chunk)
        self._live = torch.zeros(R, dtype=torch.bool, device=dev)
        self._remaining = torch.zeros(R, dtype=torch.int32, device=dev)
        self._stop_ids = torch.tensor(pad_stop_ids(()), dtype=torch.long,
                                      device=dev)
        self._ring_tok = self._ring_act = None
        self._ring_pos = torch.zeros(1, dtype=torch.long, device=dev)
        self._make_graph = graph_maker(dev, cuda_graph, self.generator)
        self._steps: Dict[str, GraphedStep] = {}  # dequant math -> step

        # speculative serving: the history, each step's emitted columns
        # and count per slot, the target forwards taken and tokens they gave
        self.drafter = drafter
        self.spec_cycles = self.spec_emitted = 0
        self._spec_steps: Dict[str, GraphedStep] = {}  # dequant math -> step
        if drafter is not None:
            if not sp.greedy:
                raise ValueError("speculative serving verifies against the "
                                 "greedy argmax: pass SamplingParams("
                                 "greedy=True)")
            G = drafter.gamma + 1  # noqa: N806
            self.history = torch.full((R, self.n_ctx + 1), -1,
                                      dtype=torch.long, device=dev)
            self._spec_out = torch.zeros((R, G + 1), dtype=torch.long,
                                         device=dev)

        # host-side bookkeeping
        self._free: List[int] = list(range(max_batch))
        self._active: Dict[int, Request] = {}  # slot -> request
        self._queue: List[Request] = []
        self._results: Dict[int, Request] = {}
        self._ids = itertools.count()

    @staticmethod
    def _check_mesh(cfg: ModelConfig, mesh,
                    cuda_graph: Optional[bool]) -> bool:
        """Refuse what sharded serving does not run; returns the graph
        setting (default: captured, but eager over gloo with a model axis
        above 1)."""
        sharding.check_heads(cfg.n_head, mesh)
        group = mesh.group(AXIS_MODEL)
        gloo = (mesh.size(AXIS_MODEL) > 1 and group is not None
                and torch.distributed.get_backend(group) == "gloo")
        if gloo and cuda_graph:
            raise ValueError("cuda_graph=True over a gloo group: gloo runs "
                             "its collectives through the host, which a "
                             "CUDA graph cannot capture; pass "
                             "cuda_graph=False (or use NCCL)")
        return False if gloo else cuda_graph

    def _forward(self, *args, **kw):
        """``forward`` under this engine's mesh (none on one device)."""
        with pctx.use_mesh(self.mesh):
            return forward(self.cfg, self.params, *args, slopes=self.slopes,
                           **kw)

    # ------------------------------------------------------------------
    # device work

    def _uniform(self, n: int, generator: torch.Generator
                 ) -> Optional[torch.Tensor]:
        """One uniform draw for each of ``n`` rows, on every rank alike
        (None for greedy sampling, which draws nothing)."""
        if self.sampling.greedy:
            return None
        return torch.rand(n, generator=generator, device=self.device)

    def _exchange(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` of this rank's slots (along ``dim``) → every slot's, over
        the data axis: the host reads what this returns."""
        if self._data is None:
            return x
        if self.device.type == "cuda":  # time the exchange alone
            torch.cuda.synchronize(self.device)
        with monitor.span("serve/exchange"):
            return pctx.all_gather(x, dim, self._data)

    def _prefill(self, ids: torch.Tensor, last: torch.Tensor,
                 windows: torch.Tensor, slots: Optional[torch.Tensor],
                 uniform: Optional[torch.Tensor]) -> torch.Tensor:
        """Prefill ids [n, T] from empty into a scratch cache, copy its
        rows into this rank's cache slots ``slots`` (none when None) and
        sample each row's first token from its logits at position
        ``last`` (at ``uniform``, drawn by the caller)."""
        n, T = ids.shape  # noqa: N806
        scratch = init_cache(self.cfg, n, n_ctx=T, dtype=self.kv_dtype,
                             device=self.device, heads=self.heads)
        logits, scratch = self._forward(ids, scratch, 0, fresh_kv=True)
        if slots is not None:
            for side in ("k", "v"):
                dst, src = self.cache[side], scratch[side]
                if not isinstance(dst, tuple):
                    dst, src = (dst,), (src,)
                for d, s in zip(dst, src):
                    d[:, slots, :, :T] = s
        sel = logits[torch.arange(n, device=self.device), last]
        return sample_torch(sel, windows, None, uniform=uniform,
                            **self._sample_kw)

    def _serve_step(self) -> None:
        """One batched decode step of this rank's slots on the static
        buffers: active slots advance (the deferred K5/K6 route at n_past,
        inactive ones at the sentinel), their token and active mask go into
        ring row ``_ring_pos``, and a slot that emits a shared stop id or
        spends its budget turns inactive.  A sampled step draws for every
        slot and keeps this rank's draws."""
        tokens, n_past, last = self.tokens, self.n_past, self.last_tokens
        active, remaining = self._live, self._remaining
        np_eff = torch.where(active, n_past, self.n_ctx)
        logits, _ = self._forward(tokens[:, None], self.cache, np_eff)
        u = self._uniform(self.max_batch, self.generator)
        nxt = sample_torch(logits[:, -1, :], last, None,
                           uniform=None if u is None
                           else u.narrow(0, self.first, self.rows),
                           **self._sample_kw)
        nxt = torch.where(active, nxt, tokens)
        self._ring_tok.index_copy_(0, self._ring_pos, nxt[None])
        self._ring_act.index_copy_(0, self._ring_pos, active[None])
        self._ring_pos.add_(1)
        left = torch.where(active, remaining - 1, remaining)
        hit_stop = (nxt[:, None] == self._stop_ids[None, :]).any(dim=1)
        last.copy_(torch.where(
            active[:, None], torch.cat([last[:, 1:], nxt[:, None]], dim=1),
            last))
        n_past.copy_(torch.where(active, n_past + 1, n_past))
        tokens.copy_(nxt)
        remaining.copy_(left)
        active.copy_(active & ~hit_stop & (left > 0))

    def _spec_step(self) -> None:
        """One speculative step of this rank's slots on the static buffers:
        drafts for every slot, one ragged forward over ``[token,
        d1..dgamma]`` (inactive
        slots at the sentinel n_past, so they write nothing), the accepted
        prefix and bonus token of each active slot into its history and
        ``_spec_out`` (the emitted columns, then their count), its token =
        the bonus token and n_past + a + 1."""
        tokens, n_past, active = self.tokens, self.n_past, self._live
        S = self.n_ctx  # noqa: N806
        drafts = self.drafter.propose(None, tokens, self.history[:, :S],
                                      n_past)
        verify_in = torch.cat([tokens[:, None], drafts], dim=1)
        np_eff = torch.where(active, n_past, S)
        logits, _ = self._forward(verify_in, self.cache, np_eff)
        a, emit = accept(drafts, torch.argmax(logits, dim=-1))
        j = torch.arange(drafts.shape[1] + 1, device=self.device)[None, :]
        ok = (j <= a[:, None]) & active[:, None]
        # out-of-range targets go to the sink column S
        hpos = torch.where(ok, n_past.long()[:, None] + 1 + j, S).clamp(
            max=S)
        self.history.scatter_(1, hpos, emit)
        n_emit = torch.where(active, a + 1, 0)
        self._spec_out.copy_(torch.cat([emit, n_emit[:, None]], dim=1))
        tokens.copy_(torch.where(active, emit.gather(1, a[:, None])[:, 0],
                                 tokens))
        n_past.add_(n_emit.to(torch.int32))

    def _spec_graphed(self) -> GraphedStep:
        """The speculative step of the current dequant math."""
        math_name = get_dequant_math()
        step = self._spec_steps.get(math_name)
        if step is None:  # through a weak proxy, as the plain step
            step = self._spec_steps[math_name] = GraphedStep(
                functools.partial(ServingEngine._spec_step,
                                  weakref.proxy(self)), self._make_graph)
        return step

    def _load_chunk(self, n_steps: int, active: Sequence[bool],
                    remaining: Sequence[int], stop_ids: Sequence[int]
                    ) -> GraphedStep:
        """Write a chunk's inputs into the static buffers, in place, and
        return the step of the current dequant math.  A longer ring or a
        wider stop vector than any before is a new buffer, so the captured
        steps are dropped and captured again at their next use."""
        dev = self.device
        stops = pad_stop_ids(stop_ids)
        if self._ring_tok is None or self._ring_tok.shape[0] < n_steps:
            shape = (max(n_steps, 8), self.rows)
            self._ring_tok = torch.zeros(shape, dtype=torch.long, device=dev)
            self._ring_act = torch.zeros(shape, dtype=torch.bool, device=dev)
            self._steps.clear()
        if len(stops) > self._stop_ids.shape[0]:
            self._stop_ids = torch.empty(len(stops), dtype=torch.long,
                                         device=dev)
            self._steps.clear()
        stops += [-1] * (self._stop_ids.shape[0] - len(stops))
        mine = slice(self.first, self.first + self.rows)
        self._live.copy_(torch.tensor(active[mine], dtype=torch.bool))
        self._remaining.copy_(torch.tensor(remaining[mine],
                                           dtype=torch.int32))
        self._stop_ids.copy_(torch.tensor(stops, dtype=torch.long))
        self._ring_pos.zero_()
        math_name = get_dequant_math()
        step = self._steps.get(math_name)
        if step is None:
            # through a weak proxy, as InferenceEngine's steps
            step = self._steps[math_name] = GraphedStep(
                functools.partial(ServingEngine._serve_step,
                                  weakref.proxy(self)), self._make_graph)
        return step

    def _run_steps(self, n_steps: int, active: Sequence[bool],
                   remaining: Sequence[int], stop_ids: Sequence[int]):
        """``n_steps`` batched decode steps, all on the device.  Returns the
        tokens [n_steps, rows] of this rank's slots and the active mask
        each step started with."""
        step = self._load_chunk(n_steps, active, remaining, stop_ids)
        for _ in range(n_steps):
            step()
        return self._ring_tok[:n_steps], self._ring_act[:n_steps]

    # ------------------------------------------------------------------

    def warmup(self) -> float:
        """Build the kernels and run the serving loop's device work once:
        one all-sentinel admission (a prefill of this rank's slots' rows
        whose cache rows go nowhere) and one all-inactive step (every slot at the
        sentinel n_past, so nothing is written), which on the card also
        captures the step's graph; with a drafter, one all-inactive
        speculative step too.  Slots, cache and the seeded generator are
        left as they were.  Returns its seconds."""
        t0 = time.perf_counter()
        dev, R = self.device, self.rows  # noqa: N806
        if dev.type == "cuda":
            _build.build_all()
        throwaway = torch.Generator(device=dev)
        throwaway.manual_seed(0)
        T = min(16, self.n_ctx)  # noqa: N806
        self._prefill(torch.zeros((R, T), dtype=torch.long, device=dev),
                      torch.full((R,), T - 1, device=dev),
                      torch.full((R, self.repeat_window), -1,
                                 dtype=torch.long, device=dev),
                      None, self._uniform(R, throwaway))
        state = self.generator.get_state()
        B = self.max_batch  # noqa: N806
        self._run_steps(1, [False] * B, [0] * B, ())
        self.generator.set_state(state)
        if self.drafter is not None:  # every slot inactive: no change
            self._live.zero_()
            self._spec_graphed()()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def submit(self, prompt_ids: Sequence[int], n_predict: int = 100, *,
               stop_tokens: Sequence[int] = (2,),  # reference EOS
               streaming_token_hook: Optional[Callable[[int], None]] = None
               ) -> int:
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError("empty prompt")
        if not all(0 <= t < self.cfg.n_vocab for t in ids):
            raise ValueError(f"prompt token outside [0, {self.cfg.n_vocab})")
        if len(ids) + n_predict > self.n_ctx:
            raise ValueError(f"prompt({len(ids)}) + n_predict({n_predict}) "
                             f"exceeds n_ctx={self.n_ctx}")
        req = Request(request_id=next(self._ids), prompt_ids=ids,
                      n_predict=n_predict,
                      stop_tokens=frozenset(int(t) for t in stop_tokens),
                      streaming_token_hook=streaming_token_hook,
                      submitted_s=time.perf_counter())
        self._queue.append(req)
        return req.request_id

    def _admit(self) -> None:
        """Claim free slots for queued requests and prefill them in one
        batched forward."""
        if not (self._queue and self._free):
            return
        with monitor.span("serve/admit"):
            self._admit_batch()

    def _admit_batch(self) -> None:
        admitted: List[Request] = []
        while self._queue and self._free:
            req = self._queue.pop(0)
            req.slot = self._free.pop(0)
            admitted.append(req)
        # the draws of every admitted request, on every rank; this rank
        # prefills the ones whose slots it holds (and its model group with
        # it: they share the data index), and the host reads every first
        # token from the exchange
        u = self._uniform(len(admitted), self.generator)
        own = [i for i, r in enumerate(admitted)
               if 0 <= r.slot - self.first < self.rows]
        if own:
            self._admit_rows([admitted[i] for i in own],
                             None if u is None else u[own])
        toks_host = self._exchange(self.tokens, 0).tolist()
        now = time.perf_counter()
        for r in admitted:
            self._active[r.slot] = r
            r.first_token_s = now
            self._emit(r, toks_host[r.slot])

    def _admit_rows(self, admitted: List[Request],
                    uniform: Optional[torch.Tensor]) -> None:
        """Prefill this rank's admitted requests together and set their
        slots' state (first token, n_past, window, drafter history)."""
        W, dev = self.repeat_window, self.device  # noqa: N806
        n = len(admitted)
        T = max(len(r.prompt_ids) for r in admitted)  # noqa: N806
        ids = torch.zeros((n, T), dtype=torch.long)
        windows = torch.full((n, W), -1, dtype=torch.long)
        for i, r in enumerate(admitted):
            ids[i, :len(r.prompt_ids)] = torch.tensor(r.prompt_ids)
            tail = r.prompt_ids[-W:]
            windows[i, W - len(tail):] = torch.tensor(tail)
        last = torch.tensor([len(r.prompt_ids) - 1 for r in admitted])
        slots = torch.tensor([r.slot - self.first for r in admitted],
                             device=dev)
        windows = windows.to(dev)
        toks = self._prefill(ids.to(dev), last.to(dev), windows, slots,
                             uniform)
        self.tokens[slots] = toks
        self.n_past[slots] = (last + 1).to(device=dev, dtype=torch.int32)
        self.last_tokens[slots] = torch.cat([windows[:, 1:], toks[:, None]],
                                            dim=1)
        if self.drafter is not None:
            # the drafter's history: the prompt, then the pending token at
            # position n_past (engine/speculative.py's history invariant)
            hist = torch.full((n, self.n_ctx + 1), -1, dtype=torch.long)
            for i, r in enumerate(admitted):
                hist[i, :len(r.prompt_ids)] = torch.tensor(r.prompt_ids)
            hist = hist.to(dev)
            hist.scatter_(1, (last + 1).to(dev)[:, None], toks[:, None])
            self.history[slots] = hist

    def _emit(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        if req.streaming_token_hook is not None:
            req.streaming_token_hook(tok)
        if tok in req.stop_tokens or len(req.generated) >= req.n_predict:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        req.done = True
        req.finished_s = time.perf_counter()
        self._results[req.request_id] = req
        if req.slot >= 0:
            del self._active[req.slot]
            self._free.append(req.slot)
            req.slot = -1

    def _advance(self, n_steps: int) -> List[int]:
        """Up to ``n_steps`` tokens for every active slot, one host
        transfer (after one exchange over the data axis); returns the
        request ids that finished."""
        B = self.max_batch  # noqa: N806
        active, remaining = [False] * B, [0] * B
        stop_common = None
        for slot, req in self._active.items():
            active[slot] = True
            remaining[slot] = max(req.n_predict - len(req.generated), 0)
            stop_common = (set(req.stop_tokens) if stop_common is None
                           else stop_common & req.stop_tokens)
        toks, actives = self._run_steps(n_steps, active, remaining,
                                        sorted(stop_common or ()))
        toks_h, act_h = self._exchange(torch.stack([toks, actives.long()]),
                                       2).tolist()
        finished = []
        for slot, req in list(self._active.items()):
            for j in range(n_steps):
                if not act_h[j][slot] or req.done:
                    break
                self._emit(req, toks_h[j][slot])
            if req.done:
                finished.append(req.request_id)
        return finished

    def _spec_advance(self) -> List[int]:
        """One speculative step: every active slot advances by its own
        accepted prefix + 1, one host transfer; plain one-token steps while
        a slot has no room for a full gamma + 1 advance.  Returns the
        request ids that finished."""
        G = self.drafter.gamma + 1  # noqa: N806
        if any(len(r.prompt_ids) + len(r.generated) + G > self.n_ctx
               for r in self._active.values()):
            return self._advance(1)
        active = [False] * self.rows
        for slot in self._active:
            if 0 <= slot - self.first < self.rows:
                active[slot - self.first] = True
        self._live.copy_(torch.tensor(active, dtype=torch.bool))
        self._spec_graphed()()
        emit = self._exchange(self._spec_out, 0).tolist()  # one host read
        self.spec_cycles += 1
        finished = []
        for slot, req in list(self._active.items()):
            row = emit[slot]
            for tok in row[:row[-1]]:
                self.spec_emitted += 1
                self._emit(req, tok)
                if req.done:
                    finished.append(req.request_id)
                    break
        return finished

    def step(self) -> List[int]:
        """Admit queued requests, advance all active slots one token (with
        a drafter: one speculative step).  Returns the request ids that
        finished this step."""
        self._admit()
        if not self._active:
            return []
        if self.drafter is not None:
            with monitor.span("serve/spec_step"):
                return self._spec_advance()
        with monitor.span("serve/step"):
            return self._advance(1)

    def step_chunk(self, n_steps: int = 8) -> List[int]:
        """Admit, then advance every active slot by up to ``n_steps`` tokens
        with one host round trip.  A slot may compute past a stop id of its
        own request within the chunk; those tokens are dropped.  With a
        drafter: one speculative step."""
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        self._admit()
        if not self._active:
            return []
        if self.drafter is not None:
            with monitor.span("serve/spec_step"):
                return self._spec_advance()
        with monitor.span("serve/step_chunk"):
            return self._advance(n_steps)

    def run(self, prompts: Sequence[Sequence[int]], n_predict: int = 100, *,
            stop_tokens: Sequence[int] = (2,),
            chunk_steps: int = 8) -> Dict[int, Request]:
        """Serve prompts to completion; returns every request finished
        since the last ``run`` by id.  With a drafter it steps one
        speculative step at a time."""
        for p in prompts:
            self.submit(p, n_predict, stop_tokens=stop_tokens)
        while self._queue or self._active:
            if chunk_steps > 1 and self.drafter is None:
                self.step_chunk(chunk_steps)
            else:
                self.step()
        out, self._results = self._results, {}
        return out
