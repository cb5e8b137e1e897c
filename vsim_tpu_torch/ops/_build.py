"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Nothing
includes PyTorch's headers, so a build takes seconds.  Libraries go to
``build/kernels/`` at the repository root, named by a hash of the sources,
so an edited source is rebuilt at its first use.  ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Every kernel wrapper counts its launches in ``launch_counts`` under the
kernel's name in ``KERNELS`` (one per kernel launch, nowhere else), so a run
can show which kernels it went through.  A source may hold more than one
kernel: K3 and K5 are two modes of ``decode_attention.cu``, K7 and K8 the
two passes of ``flash_attention_bwd.cu`` (built as two libraries, each with
its own pass's instances: the source's whole build takes the longest of
any), K9 and K10 the single-weight and
the stacked-layer calls of the one kernel of ``q4_matmul_i.cu``, K12-K14 the three lab kernels
of ``q4_lab.cu``; K15 (``q4_batch_lab.cu``) and K16 (``attn_lab.cu``) are
the batch and attention labs'.  ``read_designs.cu`` holds the reads K13 is held against
(``tools/read_designs.py``); no path runs it, so it is built at its first
``load`` and not by ``build_all()``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# kernel (its launch-count name) -> the library it is built into: the
# csrc/<library>.cu, or a unit of UNITS
KERNELS = {"q4_gemv_ps": "q4_gemv_ps", "q4_matmul_ps": "q4_matmul_ps",
           "decode_attention": "decode_attention",
           "decode_attention_fresh": "decode_attention",
           "flash_attention": "flash_attention",
           "scatter_rows": "kv_scatter_rows",
           "flash_attention_bwd_dq": "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv": "flash_attention_bwd_dkv",
           "q4_matmul_i": "q4_matmul_i", "q4_matmul_stacked": "q4_matmul_i",
           "q4_mlp_ps": "q4_mlp_ps", "q4_lab_gemv": "q4_lab",
           "q4_lab_dma": "q4_lab", "pair_bitcast": "q4_lab",
           "q4_batch_lab": "q4_batch_lab", "attn_lab": "attn_lab"}
# library -> (its csrc/<source>.cu, the defines it is built with)
UNITS = {"flash_attention_bwd_dq": ("flash_attention_bwd",
                                    ("-DVSIM_BWD_PASS=0",)),
         "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                     ("-DVSIM_BWD_PASS=1",))}
SOURCES = tuple(dict.fromkeys(KERNELS.values()))
# the lab's libraries (K12-K16): no path but the lab's runs them
LAB_SOURCES = ("q4_lab", "q4_batch_lab", "attn_lab")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: collections.Counter = collections.Counter()
build_seconds: Dict[str, float] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _unit(name: str):
    return UNITS.get(name, (name, ()))


def _lib_path(name: str) -> Path:
    source, defines = _unit(name)
    h = hashlib.sha256()
    for p in [CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def start_builds(names: Iterable[str] = SOURCES) -> Dict[str, tuple]:
    """Start one ``nvcc`` for every named library that is not built yet,
    all at once; ``finish_builds`` waits for them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        source, defines = _unit(name)
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        log = open(tmp.with_suffix(".log"), "w+")
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, tmp,
                       out)
    return procs


def finish_builds(procs: Dict[str, tuple]) -> Dict[str, str]:
    """Wait for ``start_builds``' compiles.  Returns each library's ``ptxas
    -v`` report; raises if any build failed.  ``build_seconds`` gets each
    library's seconds from this call to its end."""
    t0 = time.perf_counter()
    pending = dict(procs)
    while pending:
        for name in [n for n, v in pending.items() if v[0].poll() is not None]:
            build_seconds[name] = time.perf_counter() - t0
            del pending[name]
        time.sleep(0.05)
    reports, failed = {}, []
    for name, (proc, log, tmp, out) in procs.items():
        log.seek(0)
        reports[name] = log.read()
        log.close()
        os.remove(log.name)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{reports[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named library that is not built yet, all in parallel.
    Returns each library's ``ptxas -v`` report; raises if any build
    fails."""
    return finish_builds(start_builds(names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        lib.vsim_cuda_error_string.restype = ctypes.c_char_p
        lib.vsim_cuda_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of library ``name`` with its C signature declared (every
    pointer and the stream as ``c_void_p``, so none is cut to 32 bits); the
    C function returns cudaGetLastError() as an int."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        msg = lib.vsim_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(kernel: str, symbol: str, argtypes, *args) -> None:
    """Call ``kernel``'s launcher, raise on a CUDA error, count the launch."""
    source = KERNELS[kernel]
    err = function(source, symbol, argtypes)(*args)
    check(load(source), err, symbol)
    launch_counts[kernel] += 1


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, or NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
