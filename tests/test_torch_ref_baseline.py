"""The reference-binary pair (vsim_tpu_torch/tools/ref_baseline.py and
ref_baseline_12b.py) against the JAX tools (tools/ref_baseline.py,
tools/ref_baseline_12b.py), with no reference binary: the ggml files both
export from one saved checkpoint are byte for byte equal, so is the random
12B-shaped file with ``CFG`` cut to a tiny shape on both sides;
``perf_run`` and ``window_nll`` read equal results from a stub executable
that prints what the binary prints (the ``<|BEGIN>...<END|>`` stream, the
monitor rows, the ``logits:`` lines); ``ours_nll`` agrees with the JAX
``ours_nll`` on the same windows (f32 compute, 1e-4 rel: the two
frameworks sum in other orders); the entry point never writes the root
REF_BASELINE.json; without the reference tree the binary's build is not
attempted (as tests/test_reference_binary.py skips).
"""

import hashlib
import importlib.util
import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

from vsim_tpu_torch.convert.store import save_params
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import init_params
from vsim_tpu_torch.tools import ref_baseline as prb
from vsim_tpu_torch.tools import ref_baseline_12b as prb12

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(arch="gptneox", n_vocab=256, n_ctx=32, n_embd=64, n_head=2,
            n_layer=2, n_ff=256, n_rot=16)
TINY_12B = dict(n_vocab=96, n_embd=64, n_head=2, n_layer=2, n_ff=128,
                n_rot=16, parallel_residual=1)


def load_jax_tool(name):
    """``tools/<name>.py`` of the JAX package as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jrb = load_jax_tool("ref_baseline")
jrb12 = load_jax_tool("ref_baseline_12b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny dense f32 checkpoint, saved by the port's store."""
    cfg = ModelConfig(**TINY)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    save_params(path, cfg, init_params(cfg, seed=3, device="cpu"))
    return path


def digest(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_export_is_byte_equal_to_the_jax_tools(ckpt, tmp_path):
    j = [str(tmp_path / f"j_{k}.bin") for k in ("f32", "q4")]
    p = [str(tmp_path / f"p_{k}.bin") for k in ("f32", "q4")]
    assert jrb.export_checkpoint(ckpt, *j) == prb.export_checkpoint(ckpt, *p)
    for a, b in zip(j, p):
        assert os.path.getsize(a) > 0 and digest(a) == digest(b)
    assert os.path.getsize(p[1]) < os.path.getsize(p[0])


def test_random_12b_file_is_byte_equal_to_the_jax_tools(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(jrb12, "CFG", TINY_12B)
    monkeypatch.setattr(prb12, "CFG", TINY_12B)
    a, b = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    assert jrb12.write_random_12b(a, seed=5) == prb12.write_random_12b(b,
                                                                       seed=5)
    assert digest(a) == digest(b)


STUB = """#!{python}
import sys
args = sys.argv[1:]
prompt = [int(t) for t in args[args.index("--prompt") + 1].split()]
if "--return_logits" in args:
    for j in range(len(prompt) + 1):  # the last line ends the stream
        row = [((7 * j + 13 * v + prompt[min(j, len(prompt) - 1)]) % 29)
               / 4.0 for v in range({vocab})]
        end = " <END|>" if j == len(prompt) else ""
        print("logits: " + " ".join(f"{{x:.3f}}" for x in row) + end)
else:
    n = int(args[args.index("-n") + 1])
    print("loading ...")
    print("<|BEGIN> " + " ".join(str(t) for t in prompt + list(range(n - 3)))
          + " <END|>")
    print("  T_PREDICT  :  2.480s   0.000s")
    print("  T_SAMPLE   :  0.031s   0.000s")
"""


@pytest.fixture
def stub(tmp_path):
    path = tmp_path / "vsim-stub"
    path.write_text(STUB.format(python=sys.executable, vocab=256))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_perf_run_reads_what_the_jax_tool_reads(stub):
    prompt = [1, 3, 4, 5, 9, 7, 11, 13]
    j = jrb.perf_run(stub, "model.bin", prompt, 20, 1)
    p = prb.perf_run(stub, "model.bin", prompt, 20, 1)
    j.pop("wall_s"), p.pop("wall_s")
    assert j == p
    assert p["tokens_generated"] == 17 and p["t_predict_s"] == 2.48
    assert prb.monitor_seconds("  T_SAMPLE   :  0.031s", "T_SAMPLE") == 0.031


def test_window_nll_reads_what_the_jax_tool_reads(stub):
    window = [int(b) for b in np.random.default_rng(0).integers(3, 256, 24)]
    j = jrb.window_nll(stub, "model.bin", window)
    p = prb.window_nll(stub, "model.bin", window)
    assert p[1] == len(window) - 1 and j == p


def windows(count, length, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, count * length * 4).astype(np.uint8)
    got = prb.eval_windows(data, count, length)
    assert len(got) == count and all(2 not in w for w in got)
    return got


def test_ours_nll_agrees_with_the_jax_tools(ckpt, monkeypatch):
    # the JAX tool imports its sibling as ``train_small``
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    w = windows(2, 24)
    j = jrb.ours_nll(ckpt, w)
    p = prb.ours_nll(ckpt, w, "cpu")
    assert set(j) == set(p)
    for k in ("f32", "q4_0", "q4_0_act_quant"):
        assert p[k] == pytest.approx(j[k], rel=1e-4), k


def test_main_writes_under_build_never_the_root_record(ckpt, tmp_path,
                                                       capsys):
    root = os.path.join(REPO, "REF_BASELINE.json")
    before = digest(root)
    out = tmp_path / "ref_baseline.json"
    missing = str(tmp_path / "no-reference")
    # the binary steps stop at the missing tree, after the export and ours
    assert prb.main(["--ckpt", ckpt, "--out", str(out), "--windows", "2",
                     "--win-len", "16", "--device", "cpu",
                     "--reference-tree", missing]) == 2
    err = capsys.readouterr().err
    assert f"reference tree {missing} not found" in err
    doc = json.loads(out.read_text())
    assert "perf" not in doc and doc["ppl_ours_same_windows"]["f32"] > 0
    assert (tmp_path / "ref_mini_q4.bin").exists()
    assert prb.main(["--ckpt", ckpt, "--out", str(out), "--windows", "1",
                     "--win-len", "16", "--device", "cpu",
                     "--skip-binary"]) == 0
    with pytest.raises(SystemExit):
        prb.main(["--ckpt", ckpt, "--out", root, "--skip-binary"])
    with pytest.raises(SystemExit):
        prb12.main(["--out", root])
    assert digest(root) == before


def test_the_binary_steps_skip_without_the_reference_tree(tmp_path):
    missing = str(tmp_path / "no-reference")
    with pytest.raises(prb.MissingReference, match=missing):
        prb.build_binary(missing, str(tmp_path / "build"))
    assert not os.path.exists(tmp_path / "build")
    assert prb12.main(["--reference-tree", missing, "--model",
                       str(tmp_path / "m.bin"), "--out",
                       str(tmp_path / "o.json")]) == 2
    assert not os.path.exists(tmp_path / "m.bin")


def test_the_binary_builds_from_the_reference_tree(tmp_path):
    """The real binary, where the reference tree is present at the
    checkout's root (``reference/``, the tool's default): build it, then score one window of an exported model."""
    if not os.path.isdir(prb.REF):
        pytest.skip("reference tree not available")
    binary = prb.build_binary(prb.REF, str(tmp_path / "build"))
    cfg = ModelConfig(**TINY)
    path = str(tmp_path / "ckpt")
    save_params(path, cfg, init_params(cfg, seed=3, device="cpu"))
    f32, q4 = str(tmp_path / "f32.bin"), str(tmp_path / "q4.bin")
    prb.export_checkpoint(path, f32, q4)
    nll, n = prb.window_nll(binary, f32, windows(1, 16)[0])
    assert n == 15 and np.isfinite(nll)
