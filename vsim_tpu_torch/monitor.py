"""Per-phase span table (port of vsim_tpu/monitor.py).

A process-global registry of named, nestable spans with wall and CPU time
and call counts, reported as an indented table (the reference's
show_time_sep, monitor.c:196-262); ``record`` injects a duration measured
elsewhere (a device time from CUDA events, say) into the table, ``show``
prints it with the process's rusage, and ``torch_trace`` wraps a region in
a ``torch.profiler`` trace written to a directory as a Chrome trace (the
counterpart of ``jax_trace``).  Spans time the host: a span around device
work is a device time only if the work ends in a synchronize.
``chain_time`` gives a step's time by differencing chains of two lengths,
as the JAX package's does: on the card each chain is one CUDA graph timed
with CUDA events, on the CPU it runs eagerly under the host clock.

Spans the port opens: ``prefill`` and ``decode`` (engine/generate.py);
``serve/admit``, ``serve/step`` and ``serve/step_chunk``
(engine/serving.py, as in the JAX engine), and ``serve/spec_step`` and
``serve/exchange`` (the exchange over a mesh's data axis).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class SpanStat:
    name: str
    depth: int
    wall_s: float = 0.0
    cpu_s: float = 0.0
    calls: int = 0


class Monitor:
    def __init__(self):
        self._stats: Dict[str, SpanStat] = {}
        self._stack: List[str] = []
        self._lock = threading.Lock()
        self._t_start = time.perf_counter()

    def reset(self):
        with self._lock:
            self._stats.clear()
            self._stack.clear()
            self._t_start = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        depth = len(self._stack)
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        w0, c0 = time.perf_counter(), time.process_time()
        try:
            yield
        finally:
            w1, c1 = time.perf_counter(), time.process_time()
            self._stack.pop()
            with self._lock:
                st = self._stats.setdefault(path, SpanStat(name, depth))
                st.wall_s += w1 - w0
                st.cpu_s += c1 - c0
                st.calls += 1

    def record(self, name: str, wall_s: float, calls: int = 1,
               depth: int = 0) -> None:
        """Add an externally measured duration to the table under
        ``name``."""
        with self._lock:
            st = self._stats.setdefault(name, SpanStat(name, depth))
            st.wall_s += wall_s
            st.calls += calls

    def stats(self) -> Dict[str, SpanStat]:
        return dict(self._stats)

    def report(self, total: Optional[float] = None) -> str:
        """Indented table: seconds, CPU seconds, calls, % of total wall."""
        if total is None:
            total = time.perf_counter() - self._t_start
        lines = [f"{'span':<40} {'wall_s':>10} {'cpu_s':>10} "
                 f"{'calls':>7} {'%tot':>6}"]
        for path in sorted(self._stats):
            st = self._stats[path]
            pct = 100.0 * st.wall_s / total if total > 0 else 0.0
            label = "  " * st.depth + st.name
            lines.append(f"{label:<40} {st.wall_s:>10.4f} {st.cpu_s:>10.4f}"
                         f" {st.calls:>7d} {pct:>5.1f}%")
        lines.append(f"{'TOTAL':<40} {total:>10.4f}")
        return "\n".join(lines)

    def show(self) -> None:
        """Print the report and the process's rusage."""
        print(self.report())
        try:
            import resource
        except ImportError:  # not on every platform
            return
        ru = resource.getrusage(resource.RUSAGE_SELF)
        print(f"rusage: utime={ru.ru_utime:.2f}s stime={ru.ru_stime:.2f}s "
              f"maxrss={ru.ru_maxrss // 1024}MB")


_GLOBAL = Monitor()

span = _GLOBAL.span
reset = _GLOBAL.reset
report = _GLOBAL.report
show = _GLOBAL.show
stats = _GLOBAL.stats
record = _GLOBAL.record


def chain_time(step_fn, params, init, reps: int = 8, n_short: int = 2,
               n_long: int = 10, n_max: Optional[int] = None) -> float:
    """Median seconds a step of ``step_fn(params, carry) -> carry`` (a
    tuple of tensors), the JAX package's chain_time (vsim_tpu/monitor.py):
    the step chained ``n`` times, each carry the next step's input (so the
    steps run in order and none is elided), timed at ``n_short`` and
    ``n_long`` steps and differenced, which cancels the constant of a run.
    On the card each chain is captured once as a CUDA graph after one
    eager run, and each replay is timed with CUDA events: device time.  On
    the CPU the chain runs eagerly under the host clock.  The pair is
    guarded by ``timing.differenced``: while a long rep takes no longer
    than a short one the long chain is doubled (to at most ``n_max`` steps:
    a chain that moves a cache position must stay inside the cache), and a
    difference that never resolves raises ``timing.UnresolvedDifference`` (no time is
    returned).  ``init`` is read, not consumed; a step that writes one of
    its tensors in place (a cache) writes it again on every run.  Kernel
    launches made here are taken back out of the launch counts: they
    measure, they serve nothing."""
    import collections

    import torch

    from vsim_tpu_torch.engine.graph import CudaGraph
    from vsim_tpu_torch.ops import _build
    from vsim_tpu_torch.timing import differenced

    def chain(n):
        carry = tuple(init)
        for _ in range(n):
            carry = tuple(step_fn(params, carry))
        return carry

    cuda = any(isinstance(t, torch.Tensor) and t.is_cuda for t in init)
    saved = collections.Counter(_build.launch_counts)
    try:
        def t(n):
            if not cuda:
                chain(n)
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    chain(n)
                    times.append(time.perf_counter() - t0)
                return times
            chain(n)  # builds, plans, allocator warm-up
            graph = CudaGraph()
            graph.capture(lambda: chain(n))
            graph.replay()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            times = []
            for _ in range(reps):
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            return times

        def median(times):
            return sorted(times)[len(times) // 2]

        d = differenced(t, n_short, n_long, n_max, what="chain_time")
        return ((median(d["long_s"]) - median(d["short_s"]))
                / (d["n_long"] - d["n_short"]))
    finally:
        _build.launch_counts.clear()
        _build.launch_counts.update(saved)


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Trace a region with ``torch.profiler`` (host and, with a card, CUDA
    activity); on leaving it, write ``logdir/trace.json`` as a Chrome
    trace (chrome://tracing, Perfetto).  Yields the profiler, whose
    ``key_averages()`` hold the sums by operation after the region."""
    import torch

    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
