"""Kernel timing on the card, shared by chip_smoke.py and the lab tools.

``timed`` gives a call's device time from CUDA events around calls held
back to back behind a spin kernel; ``rotation`` makes enough copies of a
kernel's inputs that a timed loop reads them cold from device memory, as a
decode step does; ``rel_err`` is the error measure every check uses.
``differenced`` guards every time the port takes as the difference of a
long and a short loop (bench.py's step, monitor.chain_time,
tools/mini_tpu_bench.py): it returns only a resolved difference and raises
``UnresolvedDifference`` otherwise, so no caller prints noise as a rate.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

GROWS = 3  # times differenced() doubles the long loop before it gives up


class UnresolvedDifference(RuntimeError):
    """Some rep of the long loop took no longer than some rep of the short
    one, at every length tried: the difference is noise, not a time.
    ``tries`` holds each try's (n_short, n_long, short seconds, long
    seconds)."""

    def __init__(self, what: str, tries: List[tuple]):
        self.tries = tries
        shown = "; ".join(
            f"{ns} steps {[round(x, 6) for x in s]} s vs {nl} steps "
            f"{[round(x, 6) for x in lg]} s" for ns, nl, s, lg in tries)
        super().__init__(f"{what}: the long loop's reps did not all take "
                         f"longer than the short loop's after {len(tries)} "
                         f"tries ({shown}); no time is given")


def resolved(short_s: Sequence[float], long_s: Sequence[float]) -> bool:
    """Every long rep took longer than every short rep."""
    return min(long_s) > max(short_s)


def differenced(run: Callable[[int], List[float]], n_short: int,
                n_long: int, n_max: Optional[int] = None,
                what: str = "differenced time") -> Dict:
    """Each rep's seconds of ``run(n_short)`` and ``run(n_long)`` (``run(n)``
    returns one number a rep), once they are resolved: every long rep
    longer than every short rep.  While they are not, both are measured
    again with the long loop doubled (at most ``n_max`` steps), up to
    ``GROWS`` times; then ``UnresolvedDifference`` is raised with every
    try's seconds.  Returns {"n_short", "n_long", "short_s", "long_s",
    "tries"}: the lengths and reps of the resolved try, and how many tries
    it took."""
    if not 0 < n_short < n_long:
        raise ValueError(f"{what}: the long loop ({n_long}) must be longer "
                         f"than the short one ({n_short})")
    if n_max is not None and n_long > n_max:
        raise ValueError(f"{what}: the long loop ({n_long}) is past the "
                         f"most steps the caller allows ({n_max})")
    tries = []
    for i in range(GROWS + 1):
        short_s, long_s = run(n_short), run(n_long)
        tries.append((n_short, n_long, list(short_s), list(long_s)))
        if resolved(short_s, long_s):
            return dict(n_short=n_short, n_long=n_long, short_s=short_s,
                        long_s=long_s, tries=i + 1)
        n_long = 2 * n_long if n_max is None else min(2 * n_long, n_max)
    raise UnresolvedDifference(what, tries)

# Cycles per second that sizes timed()'s spin: at or above the SM clock
# (H100 boost 1.98 GHz), so the spin lasts at least as long as asked.
SPIN_HZ = 2.0e9
UNHELD = [0]  # timed() calls whose spin ended before the calls were queued


def timed(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call of fn(), from CUDA events around ``reps`` calls
    that the host enqueues while a spin kernel holds the stream, so they
    run back to back on the card.  Events around calls on a free stream
    would time the host's launches instead, which take longer than a small
    kernel runs.  The spin is sized from the host's own enqueue time; a
    call that waits on the host cannot be held, and its time then includes
    the host's gaps (counted in ``UNHELD``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - a
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for spin_s in (2 * host_s + 2e-3, 8 * host_s + 20e-3):
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()  # the spin still ran when all were queued
        torch.cuda.synchronize()
        if held:
            break
    else:
        UNHELD[0] += 1
    return start.elapsed_time(end) / reps


def rel_err(got, ref) -> tuple:
    """(max|got − ref|, that over max|ref|), in f32."""
    d = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return d, d / max(scale, 1e-30)


def rotation(make, nbytes: int):
    """Enough copies of the inputs that a timed loop cycles through more
    than the 50 MB L2 (the decode step reads each weight cold)."""
    n = max(1, math.ceil(200e6 / max(nbytes, 1)))
    return [make(i) for i in range(min(n, 16))]
