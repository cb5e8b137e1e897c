"""Speculative decoding: draft, verify, accept (port of
vsim_tpu/engine/speculative.py).

A drafter proposes ``gamma`` tokens after the current one; the target
model scores ``[cur, d1..dgamma]`` in one ragged forward (T = gamma + 1)
and the longest prefix of drafts that matches the target's argmax is
accepted, plus the target's own next token (greedy verification).  A
decode step is bound by the Q4 weight bytes, and a verify of gamma + 1
rows reads the same bytes as a one-token step.

Two drafters:
  * ``ModelDrafter``: a small model with the target's tokenizer, run
    greedily for gamma one-token steps on its own KV cache at the target's
    ragged n_past (on the card a quantized cache takes the deferred K5/K6
    route, as the serving step does);
  * ``NgramDrafter``: prompt lookup, the tokens that followed the most
    recent earlier occurrence of the last ``m`` tokens in the history.

The streams are the plain greedy engine's only where both take one
attention route: the verify attends through the einsum over the cache with
f32 q, and at D % 128 == 0 the one-token step's decode kernel rounds q to
bf16 (models/transformer.py:attention), in the port as in the JAX package.

``SpeculativeEngine`` keeps a cycle's state in static device buffers (the
current token, an int32 n_past, the ``[1, n_ctx + 1]`` token history whose
last column is a sink for writes out of range, and a ring of each cycle's
emitted tokens and count), updates them in place with no host sync, and
on the card captures the cycle once as a CUDA graph per dequant math
(engine/graph.py) and replays it ``cycles_per_chunk`` times between host
reads: the JAX engine's ``lax.scan`` chunk.  The prompt is prefilled at its
own length on both models; the JAX engine's prompt padding and kv length
buckets have no counterpart.  KV rows past the accepted prefix hold stale
entries, masked by position and overwritten by later cycles.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import weakref
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from vsim_tpu_torch import monitor
from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.engine.generate import engine_params, graph_maker
from vsim_tpu_torch.engine.graph import GraphedStep
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.transformer import alibi_slopes, forward, init_cache
from vsim_tpu_torch.ops.q4_cuda import get_dequant_math


@dataclasses.dataclass
class SpecResult:
    token_ids: List[int]
    prompt_ids: List[int]
    timings: Optional[dict] = None
    # generated tokens per target forward, over the returned tokens
    cycles: int = 0
    tokens_per_cycle: float = 0.0


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------


class ModelDrafter:
    """Draft with a small model of the target's tokenizer: gamma greedy
    one-token steps.  Its cache tracks the target's n_past; on a partial
    acceptance its stale rows are masked and overwritten as the target's
    are.  ``SpeculativeEngine`` prepares ``params`` for the kernels and
    makes the cache."""

    def __init__(self, cfg: ModelConfig, params, gamma: int = 4):
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.cfg = cfg
        self.params = params
        self.gamma = gamma
        self.slopes = None

    def setup(self, device: torch.device) -> None:
        """Lay the params out for the engines on ``device`` (shared as they
        are when already laid out) and build the ALiBi slopes once."""
        self.params = engine_params(self.cfg, self.params, device)
        self.slopes = (alibi_slopes(self.cfg.n_head, device)
                       if self.cfg.alibi else None)

    def init_state(self, batch: int, n_ctx: int, device: torch.device):
        return init_cache(self.cfg, batch, n_ctx=n_ctx, device=device)

    def prefill(self, state, ids: torch.Tensor) -> None:
        """The prompt ids [B, T] into the draft cache, from empty."""
        forward(self.cfg, self.params, ids, state, 0, fresh_kv=True,
                slopes=self.slopes)

    def propose(self, state, cur: torch.Tensor, history: torch.Tensor,
                n_past: torch.Tensor) -> torch.Tensor:
        """gamma greedy drafts [B, gamma] from ``cur`` [B] at the int32
        n_past [B]; the draft cache is updated in place."""
        del history
        tok, drafts = cur, []
        for i in range(self.gamma):
            logits, _ = forward(self.cfg, self.params, tok[:, None], state,
                                n_past + i, slopes=self.slopes)
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            drafts.append(tok)
        return torch.stack(drafts, dim=1)


class NgramDrafter:
    """Prompt-lookup decoding: the continuation of the most recent earlier
    occurrence of the current ``m``-token suffix in the history.  No
    weights and no cache."""

    def __init__(self, m: int = 3, gamma: int = 4):
        if gamma < 1 or m < 1:
            raise ValueError("m and gamma must be >= 1")
        self.m = m
        self.gamma = gamma

    def setup(self, device: torch.device) -> None:
        pass

    def init_state(self, batch: int, n_ctx: int, device: torch.device):
        return None

    def prefill(self, state, ids: torch.Tensor) -> None:
        pass

    def propose(self, state, cur: torch.Tensor, history: torch.Tensor,
                n_past: torch.Tensor) -> torch.Tensor:
        """history [B, S] holds the tokens at positions < n_past[b] (-1
        elsewhere); ``cur`` [B] is the token at n_past[b].  The suffix is
        the last m - 1 history tokens and ``cur``; a suffix position below
        0 reads as -2, a match must end before n_past, the most recent one
        wins, and a proposal that is missing or out of range repeats
        ``cur``.  Returns drafts [B, gamma] int64."""
        del state
        B, S = history.shape  # noqa: N806
        m, gamma, dev = self.m, self.gamma, history.device
        hist = history.long()
        npl = n_past.long()[:, None]
        pos = torch.arange(m - 1, device=dev)[None, :] + (npl - (m - 1))
        sfx = torch.gather(hist, 1, pos.clamp(0, S - 1))
        sfx = torch.where(pos >= 0, sfx, -2)
        full = torch.cat([sfx, cur.long()[:, None]], dim=1)  # [B, m]
        p_idx = torch.arange(S, device=dev)
        win = (p_idx[:, None] + torch.arange(m, device=dev)[None, :]).clamp(
            0, S - 1)  # [S, m]
        windows = hist[:, win]  # [B, S, m]
        match = (windows == full[:, None, :]).all(dim=2)
        match &= (p_idx[None, :] + m - 1) < npl
        best = torch.where(match, p_idx[None, :], -1).amax(dim=1)  # [B]
        found = best >= 0
        prop_pos = best[:, None] + m + torch.arange(gamma, device=dev)
        prop = torch.gather(hist, 1, prop_pos.clamp(0, S - 1))
        ok = found[:, None] & (prop_pos < npl) & (prop_pos >= 0) & (prop >= 0)
        return torch.where(ok, prop, cur.long()[:, None])


def accept(drafts: torch.Tensor, targets: torch.Tensor):
    """Greedy verification of drafts [B, gamma] against the target's argmax
    [B, gamma + 1] at ``[cur, d1..dgamma]``: (a [B], the drafts accepted;
    emit [B, gamma + 1], d1..da then the bonus token t_a at column a, the
    columns past a unused)."""
    gamma = drafts.shape[1]
    match = (drafts == targets[:, :gamma]).long()
    a = torch.cumprod(match, dim=1).sum(dim=1)
    bonus = torch.gather(targets, 1, a[:, None])
    j = torch.arange(gamma + 1, device=drafts.device)[None, :]
    emit = torch.where(j < a[:, None], F.pad(drafts, (0, 1)), bonus)
    return a, emit


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpecState:
    """A cycle's static device buffers (batch 1)."""

    cur: torch.Tensor  # [1] int64: the token the next cycle feeds
    n_past: torch.Tensor  # [1] int32: finalized positions
    history: torch.Tensor  # [1, n_ctx + 1] int64, -1 padded, sink last
    # [cycles_per_chunk, 1, gamma + 2] int64: a cycle's emitted columns,
    # then how many of them it emitted
    ring: torch.Tensor
    pos: torch.Tensor  # [1] int64: the ring slot of the next cycle (wraps)


class SpeculativeEngine:
    """Greedy speculative decoding of one target model with one drafter on
    one device (the CUDA card by default)."""

    def __init__(self, cfg: ModelConfig, params, drafter, *,
                 n_ctx: Optional[int] = None, cycles_per_chunk: int = 8,
                 device: DeviceLike = None,
                 cuda_graph: Optional[bool] = None):
        """``params`` are laid out as the engines' (``engine_params``: the
        lm head padded, qkv fused, plane-split per-layer weights), the
        drafter's likewise; another engine's are shared.  ``cuda_graph``
        (default: on for a CUDA device) replays each cycle from a captured
        graph; False runs it eagerly."""
        if cycles_per_chunk < 1:
            raise ValueError("cycles_per_chunk must be >= 1")
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.n_ctx = n_ctx or cfg.n_ctx
        self.drafter = drafter
        self.gamma = drafter.gamma
        self.cycles_per_chunk = cycles_per_chunk
        self.params = engine_params(cfg, params, dev)
        self.slopes = alibi_slopes(cfg.n_head, dev) if cfg.alibi else None
        drafter.setup(dev)
        self._make_graph = graph_maker(dev, cuda_graph, None)
        self.cache = self.dstate = None  # made at first use
        G = self.gamma + 1  # noqa: N806
        self.state = SpecState(
            cur=torch.zeros(1, dtype=torch.long, device=dev),
            n_past=torch.zeros(1, dtype=torch.int32, device=dev),
            history=torch.full((1, self.n_ctx + 1), -1, dtype=torch.long,
                               device=dev),
            ring=torch.zeros((cycles_per_chunk, 1, G + 1), dtype=torch.long,
                             device=dev),
            pos=torch.zeros(1, dtype=torch.long, device=dev))
        self._steps: Dict[str, GraphedStep] = {}  # dequant math -> cycle

    def _cycle(self) -> None:
        """One draft → verify → accept cycle on the static buffers: the
        drafts, one target forward over ``[cur, d1..dgamma]`` at n_past,
        the accepted prefix and bonus token into the history and ring slot
        ``pos``, cur = the bonus token, n_past + a + 1."""
        st, S = self.state, self.n_ctx  # noqa: N806
        drafts = self.drafter.propose(self.dstate, st.cur,
                                      st.history[:, :S], st.n_past)
        verify_in = torch.cat([st.cur[:, None], drafts], dim=1)
        logits, _ = forward(self.cfg, self.params, verify_in, self.cache,
                            st.n_past, slopes=self.slopes)
        a, emit = accept(drafts, torch.argmax(logits, dim=-1))
        j = torch.arange(self.gamma + 1, device=self.device)[None, :]
        npl = st.n_past.long()[:, None]
        # out-of-range targets go to the sink column S
        hpos = torch.where(j <= a[:, None], npl + 1 + j, S).clamp(max=S)
        st.history.scatter_(1, hpos, emit)
        st.history.scatter_(1, npl.clamp(max=S), st.cur[:, None])
        st.ring.index_copy_(0, st.pos,
                            torch.cat([emit, (a + 1)[:, None]], dim=1)[None])
        st.pos.add_(1).remainder_(self.cycles_per_chunk)
        st.cur.copy_(emit.gather(1, a[:, None])[:, 0])
        st.n_past.add_((a + 1).to(torch.int32))

    def _step(self) -> GraphedStep:
        """The cycle of the current dequant math: a graph captured under
        one math never replays under another."""
        math_name = get_dequant_math()
        step = self._steps.get(math_name)
        if step is None:
            # through a weak proxy, as the other engines' steps
            step = self._steps[math_name] = GraphedStep(
                functools.partial(SpeculativeEngine._cycle,
                                  weakref.proxy(self)), self._make_graph)
        return step

    def start(self, prompt_ids: List[int]) -> GraphedStep:
        """Prefill both models from empty caches (made at first use), load
        the buffers for decoding after the prompt and return the cycle."""
        dev = self.device
        if self.cache is None:
            self.cache = init_cache(self.cfg, 1, n_ctx=self.n_ctx,
                                    device=dev)
            self.dstate = self.drafter.init_state(1, self.n_ctx, dev)
        n = len(prompt_ids)
        ids = torch.tensor([prompt_ids], dtype=torch.long, device=dev)
        logits, _ = forward(self.cfg, self.params, ids, self.cache, 0,
                            fresh_kv=True, slopes=self.slopes)
        self.drafter.prefill(self.dstate, ids)
        st = self.state
        st.cur.copy_(torch.argmax(logits[:, n - 1, :], dim=-1))
        st.n_past.fill_(n)
        st.history.fill_(-1)
        st.history[:, :n] = ids
        st.pos.zero_()
        return self._step()

    def generate(self, prompt_ids: Sequence[int], n_predict: int = 100, *,
                 stop_tokens: Sequence[int] = ()) -> SpecResult:
        """Greedy speculative generation for one prompt: the tokens of
        plain greedy decoding, in fewer target forwards (up to the route
        difference the module docstring names)."""
        prompt_ids = [int(t) for t in prompt_ids]
        n_prompt = len(prompt_ids)
        if n_prompt < 1:
            raise ValueError("empty prompt")
        if not all(0 <= t < self.cfg.n_vocab for t in prompt_ids):
            raise ValueError(f"prompt token outside [0, {self.cfg.n_vocab})")
        if n_prompt + n_predict > self.n_ctx:
            raise ValueError(f"prompt({n_prompt}) + n_predict({n_predict}) "
                             f"exceeds n_ctx={self.n_ctx}")
        G = self.gamma + 1  # noqa: N806
        st = self.state
        t0 = time.perf_counter()
        with monitor.span("spec/prefill"):
            step = self.start(prompt_ids)
            first = int(st.cur[0])  # the prefill's token, emitted first
        t_prefill = time.perf_counter()

        stop = set(int(t) for t in stop_tokens)
        out, emit_log = [first], []
        n_past = n_prompt
        with monitor.span("spec/draft+verify"):
            while len(out) < n_predict:
                # room: a chunk's worst case adds gamma + 1 rows a cycle
                room = self.n_ctx - 1 - n_past - G
                if room <= 0:
                    break
                # each cycle emits at least one token: no more cycles than
                # tokens still wanted (the JAX engine runs whole chunks)
                n_cycles = min(self.cycles_per_chunk, max(1, room // G),
                               n_predict - len(out))
                st.pos.zero_()
                for _ in range(n_cycles):
                    step()
                for row in st.ring[:n_cycles, 0].tolist():  # one host read
                    e = row[-1]
                    emit_log.append(e)
                    out.extend(row[:e])
                    n_past += e
                if stop and any(t in stop for t in out):
                    break
        t_done = time.perf_counter()

        out = out[:n_predict]
        if stop:
            for i, t in enumerate(out):
                if t in stop:
                    out = out[:i + 1]
                    break
        n_gen = len(out)
        # the verify forwards the returned tokens needed (the last chunk
        # may run past the budget); token 0 came from the prefill
        have, cycles = 1, 0
        for e in emit_log:
            if have >= n_gen:
                break
            have += e
            cycles += 1
        decode_s = t_done - t_prefill
        timings = {
            "prefill_s": t_prefill - t0,
            "decode_s": decode_s,
            "tokens": n_gen,
            "tokens_per_s": (n_gen - 1) / decode_s
            if n_gen > 1 and decode_s > 0 else float("nan"),
        }
        return SpecResult(
            token_ids=out, prompt_ids=prompt_ids, timings=timings,
            cycles=cycles,
            tokens_per_cycle=(n_gen - 1) / cycles if cycles else float("nan"))
