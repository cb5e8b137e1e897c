"""Q4 dequant-maths lab on the card (port of tools/kernel_lab.py).

    python -m vsim_tpu_torch.tools.kernel_lab [--batch 16] [--shape 4096,4096]
        [--variants dma,cur,i32,u16,f32x,f32f,f32xf,i32f,res,w32,ps]
        [--device cpu]

Times K12 (``q4_lab_gemv``) under the "i"-layout maths of the TPU lab and,
under f32x, its operand layouts "res" (``_k_res``: K never split), "w32"
(``_k_w32``: the word repack, ``pack_w32``) and "ps" (``_k_ps``: the
plane-split repack, raw x), K13 (``q4_lab_dma``, "i" layout, a read of
every byte) and, as "cur", K9
(``q4_matmul_i``, the main path's kernel for this layout), on a random
weight of shape O,K (``--shape``) and ``--batch`` rows of bf16 x; prints,
per variant, ms, GB/s of weight bytes, the ratio to K13's rate, max|err|
against the plain version and the library yardstick (tools/lab.py says
how).  The TPU's tile knobs, block sweeps and chained-dispatch timing do
not carry over; K13's touch output keeps the TPU's ``block_kh`` of 512.
The TPU lab's findings are the TPU's: this tool makes its own.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from vsim_tpu_torch.device import DeviceLike
from vsim_tpu_torch.tools.lab import run_variants, tool_main

VARIANTS = ("dma", "cur", "i32", "u16", "f32x", "f32f", "f32xf", "i32f",
            "res", "w32", "ps")
BLOCK_KH = 512  # the TPU lab's default tile (2048, 512): K13's touch


def run(batch: int = 16, shape: Tuple[int, int] = (4096, 4096),
        variants: Sequence[str] = VARIANTS, device: DeviceLike = None) -> List[Dict]:
    O, K = shape  # noqa: N806
    return run_variants("kernel_lab", O, K, batch, variants, device,
                        block_kh=min(BLOCK_KH, K // 2))


def main(argv=None) -> List[Dict]:
    return tool_main(run, __doc__, 16, (4096, 4096), VARIANTS, argv)


if __name__ == "__main__":
    main()
