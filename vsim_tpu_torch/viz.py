"""Activation / weight visualization (port of vsim_tpu/viz.py; the
reference's X11 display, xdisp.c, made headless).

``heatmap()`` and ``trace()`` render PNG files when matplotlib is
importable, else ASCII to stdout; ``top_tokens()`` prints a probability
bar chart for a sampling step.  They take tensors (any device) or arrays.
All entry points are no-ops on shape/type errors: visualization must
never break inference.  A PNG goes to ``path``, by default into the
temporary directory (``tempfile.gettempdir()``).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import numpy as np

_RAMP = " .:-=+*#%@"


def _to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _have_mpl() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _png_path(title: str, path: Optional[str]) -> str:
    return path or os.path.join(tempfile.gettempdir(),
                                f"vsim_viz_{title.replace(' ', '_')}.png")


def heatmap(x, title: str = "activations", path: Optional[str] = None,
            max_side: int = 2048) -> Optional[str]:
    """Render a 2-D activation/weight map (FP_to_X, xdisp.c:678).  Returns
    the PNG's path, or None for the ASCII fallback (printed)."""
    try:
        a = _to_np(x)
        a = a.reshape(a.shape[0], -1) if a.ndim != 2 else a
        a = a[:max_side, :max_side]
        if _have_mpl():
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            path = _png_path(title, path)
            fig, ax = plt.subplots(figsize=(6, 4), dpi=120)
            im = ax.imshow(a, aspect="auto", cmap="magma")
            ax.set_title(title)
            fig.colorbar(im, ax=ax)
            fig.tight_layout()
            fig.savefig(path)
            plt.close(fig)
            return path
        # ASCII fallback: downsample to a terminal-sized grid
        h, w = min(24, a.shape[0]), min(72, a.shape[1])
        ys = np.linspace(0, a.shape[0] - 1, h).astype(int)
        xs = np.linspace(0, a.shape[1] - 1, w).astype(int)
        g = a[np.ix_(ys, xs)]
        lo, hi = float(g.min()), float(g.max())
        rng = hi - lo if hi > lo else 1.0
        print(f"-- {title} [{a.shape[0]}x{a.shape[1]}]"
              f" min={lo:.3g} max={hi:.3g} --")
        for row in g:
            idx = ((row - lo) / rng * (len(_RAMP) - 1)).astype(int)
            print("".join(_RAMP[i] for i in idx))
        return None
    except Exception:  # visualization never breaks the caller
        return None


def trace(series: Sequence[float], title: str = "trace",
          path: Optional[str] = None) -> Optional[str]:
    """Accumulating 1-D trace (x11_vector_add, xdisp.c:167)."""
    try:
        y = _to_np(series).reshape(-1)
        if _have_mpl():
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            path = _png_path(title, path)
            fig, ax = plt.subplots(figsize=(6, 3), dpi=120)
            ax.plot(y)
            ax.set_title(title)
            fig.tight_layout()
            fig.savefig(path)
            plt.close(fig)
            return path
        lo, hi = float(y.min()), float(y.max())
        rng = hi - lo if hi > lo else 1.0
        bars = ((y - lo) / rng * 7).astype(int)
        blocks = "▁▂▃▄▅▆▇█"
        print(f"-- {title} n={y.size} min={lo:.3g} max={hi:.3g} --")
        print("".join(blocks[b] for b in bars[:120]))
        return None
    except Exception:  # visualization never breaks the caller
        return None


def top_tokens(logits, k: int = 10, decode=None) -> None:
    """Probability bar chart of the top-k tokens at one sampling step (the
    reference's softu64 distribution pane, xdisp.c:648)."""
    try:
        lg = _to_np(logits).reshape(-1)
        p = np.exp(lg - lg.max())
        p /= p.sum()
        top = np.argsort(-p)[:k]
        width = 40
        for t in top:
            label = decode([int(t)]) if decode is not None else str(int(t))
            bar = "#" * max(1, int(p[t] * width))
            print(f"{label[:16]:>16} {p[t]:6.3f} {bar}")
    except Exception:  # visualization never breaks the caller
        pass
