"""Per-phase span table (port of the span part of vsim_tpu/monitor.py).

A process-global registry of named, nestable spans with wall and CPU time
and call counts, reported as an indented table (the reference's
show_time_sep, monitor.c:196-262).  Spans time the host: a span around
device work is a device time only if the work ends in a synchronize.

Spans the port opens: ``prefill`` and ``decode`` (engine/generate.py);
``serve/admit``, ``serve/step`` and ``serve/step_chunk``
(engine/serving.py, as in the JAX engine).
"""

from __future__ import annotations

import contextlib
import dataclasses
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

    def stats(self) -> Dict[str, SpanStat]:
        return dict(self._stats)

    def report(self, total: Optional[float] = None) -> str:
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


_GLOBAL = Monitor()

span = _GLOBAL.span
reset = _GLOBAL.reset
report = _GLOBAL.report
stats = _GLOBAL.stats
