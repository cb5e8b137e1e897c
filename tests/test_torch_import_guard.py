"""The port stands alone: every module of ``vsim_tpu_torch`` imports in a
fresh interpreter where ``jax``, ``jaxlib`` and ``ml_dtypes`` cannot be
imported, and afterwards no module of the JAX package (``vsim_tpu``), and
no ``transformers`` (which the port imports only inside functions), is
loaded."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "ml_dtypes")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} may not be imported by the port")
        return None


sys.meta_path.insert(0, Block())
import vsim_tpu_torch

names = [m.name for m in pkgutil.walk_packages(vsim_tpu_torch.__path__,
                                               "vsim_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("vsim_tpu", "transformers") + BLOCKED)
print(len(names), loaded)
"""


def test_port_imports_without_jax_and_loads_nothing_of_it():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROGRAM], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, loaded = out.stdout.split(" ", 1)
    assert int(n) >= 50  # every module, the new convert/ and api/ ones too
    assert loaded.strip() == "[]"
