"""Pair-construction dequant maths on the card (port of tools/pair_lab.py).

    python -m vsim_tpu_torch.tools.pair_lab [--batch 32] [--shape 50432,4096]
        [--variants f32b,pairA,pairB] [--device cpu]

K12 (``q4_lab_gemv``) under f32b (the f32 magic with the folded offset,
then bf16), pairA (both bf16 weights of a byte from one 32-bit word
0x43004300 | lo | hi << 16) and pairB (the halves swapped: a probe of the
half order, which computes another function), beside K13's read rate
at the same shape; prints what tools/lab.py says.  The TPU lab's relerr
against the f32 oracle is its own: here every variant is held against its
plain version, the function it is meant to compute.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from vsim_tpu_torch.device import DeviceLike
from vsim_tpu_torch.tools.lab import run_variants, tool_main

VARIANTS = ("f32b", "pairA", "pairB")


def run(batch: int = 32, shape: Tuple[int, int] = (50432, 4096),
        variants: Sequence[str] = VARIANTS, device: DeviceLike = None) -> List[Dict]:
    O, K = shape  # noqa: N806
    return run_variants("pair_lab", O, K, batch, variants, device,
                        block_kh=min(512, K // 2))


def main(argv=None) -> List[Dict]:
    return tool_main(run, __doc__, 32, (50432, 4096), VARIANTS, argv)


if __name__ == "__main__":
    main()
