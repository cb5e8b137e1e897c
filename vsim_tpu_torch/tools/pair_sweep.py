"""pairA against pairC on the card (port of tools/pair_sweep.py).

    python -m vsim_tpu_torch.tools.pair_sweep [--batch 8] [--shape 50432,4096]
        [--variants pairA,pairC] [--device cpu]

K12 (``q4_lab_gemv``) under pairA, (128 + v - 136) s, and pairC, which
drops the subtract: w = (128 + v) s, and y = x w - 136 (xs s) with xs the
bf16 block sums of x (``q4_lab.block_sums``, as the TPU tool's
``block_sums``), beside K13's read rate; prints what tools/lab.py says.
The TPU's geometry sweep does not carry over.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from vsim_tpu_torch.device import DeviceLike
from vsim_tpu_torch.tools.lab import run_variants, tool_main

VARIANTS = ("pairA", "pairC")


def run(batch: int = 8, shape: Tuple[int, int] = (50432, 4096),
        variants: Sequence[str] = VARIANTS, device: DeviceLike = None) -> List[Dict]:
    O, K = shape  # noqa: N806
    return run_variants("pair_sweep", O, K, batch, variants, device,
                        block_kh=min(512, K // 2))


def main(argv=None) -> List[Dict]:
    return tool_main(run, __doc__, 8, (50432, 4096), VARIANTS, argv)


if __name__ == "__main__":
    main()
