"""One decode step, run eagerly or replayed from a captured CUDA graph:
the port's counterpart of the JAX engines' one-dispatch chunks
(vsim_tpu/engine/generate.py:_decode_many, serving.py:_step_many).

A step function reads and writes only static device buffers (the token,
n_past, the repeat window, the cache, a ring of the chunk's tokens), in
place, so a graph captured once replays it with nothing from the host.
``GraphedStep`` runs its first call eagerly (the warm-up: nvcc builds,
ctypes loads and the kernels' cached launch plans all happen there), then
captures the step, and replays the graph on every later call.  On the CPU,
or with graphs off, every call runs the step eagerly.  A failed capture or
replay raises: there is no fallback to the eager step.

``_build.launch`` counts a kernel where the host calls its launcher, so a
captured kernel would be counted once, at capture.  ``GraphedStep`` takes
the capture's counts back out and adds them again on every replay, so the
counts say how often each kernel ran.
"""

from __future__ import annotations

import collections
import gc
from typing import Callable, Optional

import torch

from vsim_tpu_torch.ops import _build


class CudaGraph:
    """``torch.cuda.CUDAGraph`` with the step's sampler generator
    registered, so each replay draws from the generator's current seed and
    offset as an eager step would."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)

    def capture(self, fn: Callable[[], None]) -> None:
        """Capture ``fn`` with Python's cyclic collector run first and held
        off during: a graph freed by a collection inside another graph's
        capture invalidates that capture."""
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                fn()
        finally:
            if enabled:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


class GraphedStep:
    """Call to run one step: eagerly on the first call, and always when
    ``make_graph`` is None; else captured into the graph ``make_graph()``
    returns (a ``CudaGraph``, or a stand-in with ``capture(fn)`` and
    ``replay()``) after that first call, and replayed on every later one.
    ``launches`` holds the kernel launches of one captured step, added to
    ``_build.launch_counts`` per replay."""

    def __init__(self, fn: Callable[[], None],
                 make_graph: Optional[Callable[[], object]] = None):
        self.fn = fn
        self.make_graph = make_graph
        self.graph = None
        self.launches: collections.Counter = collections.Counter()

    def __call__(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            _build.launch_counts.update(self.launches)
            return
        self.fn()
        if self.make_graph is not None:
            self.capture(self.make_graph())

    def capture(self, graph) -> None:
        """Capture the step into ``graph``; its launches are taken out of
        the counts, where only replays add them."""
        before = collections.Counter(_build.launch_counts)
        try:
            graph.capture(self.fn)
        finally:
            self.launches = _build.launch_counts - before
            _build.launch_counts.clear()
            _build.launch_counts.update(before)
        self.graph = graph
