"""The plane-split GEMVs against K13's read of the same bytes (port of
tools/gi_sweep.py).

    python -m vsim_tpu_torch.tools.gi_sweep [--batch 1] [--shape 16384,4096]
        [--variants dma,gi,giw] [--device cpu]

On the "ps" repack of a random weight: "dma" is K13 in the "ps" layout
(``_k_giw_dma``: whole-x touch, both scale planes, ``block_kh`` 256, the
TPU sweep's first geometry), "gi" K2 (``q4_matmul_ps``, bf16 planes) and
"giw" K1 (``q4_gemv_ps``, n <= 32).  Prints what tools/lab.py says.  The
TPU's geometry sweep does not carry over, and a failure raises instead of
being printed and passed over.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from vsim_tpu_torch.device import DeviceLike
from vsim_tpu_torch.tools.lab import run_variants, tool_main

VARIANTS = ("dma", "gi", "giw")
BLOCK_KH = 256


def run(batch: int = 1, shape: Tuple[int, int] = (16384, 4096),
        variants: Sequence[str] = VARIANTS, device: DeviceLike = None) -> List[Dict]:
    O, K = shape  # noqa: N806
    return run_variants("gi_sweep", O, K, batch, variants, device,
                        block_kh=min(BLOCK_KH, K // 2), dma_layout="ps")


def main(argv=None) -> List[Dict]:
    return tool_main(run, __doc__, 1, (16384, 4096), VARIANTS, argv)


if __name__ == "__main__":
    main()
