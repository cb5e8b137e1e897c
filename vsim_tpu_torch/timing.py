"""Kernel timing on the card, shared by chip_smoke.py and the lab tools.

``timed`` gives a call's device time from CUDA events around calls held
back to back behind a spin kernel; ``rotation`` makes enough copies of a
kernel's inputs that a timed loop reads them cold from device memory, as a
decode step does; ``rel_err`` is the error measure every check uses.
"""

from __future__ import annotations

import math
import time

import torch

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
