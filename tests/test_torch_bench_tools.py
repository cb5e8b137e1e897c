"""The port's measuring scripts on the CPU (``--device cpu``, small
shapes): vsim_tpu_torch.bench and vsim_tpu_torch.tools.{serve_bench,
serve_profile, flash_bench, bench_matrix, mini_tpu_bench} run to their
output, with the JAX scripts' keys and configurations; ``use_flash=False``
takes the einsum in the port as in the JAX forward.  No test reads a
BENCH*.json record.
"""

import ast
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.models.transformer import forward as j_forward
from vsim_tpu.models.transformer import init_cache as j_init_cache
from vsim_tpu_torch import bench
from vsim_tpu_torch.convert.store import save_params
from vsim_tpu_torch.engine.generate import engine_params
from vsim_tpu_torch.models import transformer
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.models.init import init_params, random_q4_params
from vsim_tpu_torch.tools import (bench_matrix, flash_bench, mini_tpu_bench,
                                  serve_bench, serve_profile)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEOX = dict(arch="gptneox", n_vocab=300, n_ctx=256, n_embd=128, n_head=4,
            n_layer=2, n_ff=256, n_rot=16, activation="gelu_exact")
SMALL_BENCH = ["--device", "cpu", "--model", "pythia-70m", "--batch", "2",
               "--tokens", "6", "--decode-chunk", "3", "--n-ctx", "32",
               "--prompt-len", "4"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the shapes are small, and the test workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dict_keys(path: str, func: str, var: str) -> set:
    """Every string key of the dict literals assigned to ``var`` (and
    nested in them) inside ``func`` of the Python file ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == var
                for t in node.targets):
            for d in ast.walk(node.value):
                if isinstance(d, ast.Dict):
                    keys |= {k.value for k in d.keys
                             if isinstance(k, ast.Constant)}
    return keys


def last_json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def test_bench_line_has_the_jax_keys(capsys):
    assert bench.main(SMALL_BENCH + ["--verbose"]) == 0
    line = last_json(capsys.readouterr().out)
    want = dict_keys(os.path.join(REPO, "bench.py"), "main", "result")
    got = set(line) | set(line["extra"])
    assert want - {"impl"} <= got and "impl" in line["extra"]
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["extra"]["decode_step_ms_batch"] > 0
    assert line["extra"]["captures_in_timed_reps"] == 0
    assert line["extra"]["backend"] == line["extra"]["device"] == "cpu"
    assert len(line["extra"]["reps_s"]["long"]) == 3
    phases = line["extra"]["phase_ms"]
    assert {"q4[w_qkv]", "q4[lm_head]", "attention_kv", "sampling",
            "other"} <= set(phases)


def test_serve_bench_runs_to_its_line(capsys):
    assert serve_bench.main(["--device", "cpu", "--model", "pythia-70m",
                             "--max-batch", "2", "--requests", "3",
                             "--tokens", "3", "--n-ctx", "96"]) == 0
    line = last_json(capsys.readouterr().out)
    want = dict_keys(os.path.join(REPO, "tools", "serve_bench.py"), "main",
                     "result")
    assert want <= set(line) | set(line["extra"])
    assert line["extra"]["total_tokens"] == 9 and line["value"] > 0
    assert line["extra"]["device"] == "cpu"


def test_serve_profile_modes_give_the_same_tokens():
    cfg = ModelConfig(**NEOX, kv_dtype="int8")
    dev = torch.device("cpu")
    params = engine_params(cfg, random_q4_params(cfg, seed=0, device="cpu"),
                           dev)
    toks = {m: serve_profile.mode_tokens(m, cfg, params, 3, 64, 5, dev)
            for m in serve_profile.MODES}
    assert toks["uniform"].shape == (5, 3)
    assert len(set(map(tuple, toks["uniform"].T.tolist()))) > 1
    for m in serve_profile.MODES[1:]:
        assert torch.equal(toks[m], toks["uniform"])
    ms = serve_profile.profile(cfg, params, 2, 64, dev, reps=1)
    assert set(ms) == set(serve_profile.MODES)
    assert all(v > 0 for v in ms.values())


def test_flash_bench_einsum_and_k4_agree():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 40, 4, 64), generator=g)
    k, v = (torch.randn((1, 4, 40, 64), generator=g) for _ in range(2))
    a = flash_bench.attend(q, k, v, use_flash=False)
    b = flash_bench.attend(q, k, v, use_flash=True)
    assert a.shape == b.shape == q.shape
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    cfg = ModelConfig(**NEOX)
    for fl in (False, True):
        assert flash_bench.attn_micro(cfg, 32, fl, torch.device("cpu")) > 0


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_use_flash_false_takes_the_einsum(monkeypatch, compute):
    """At T = 256 the port's prefill logits with use_flash=False match the
    JAX forward's with use_flash=False (its einsum route), and K4 is not
    called; with use_flash=True it is."""
    jc = JConfig(**NEOX, compute_dtype=compute, use_flash=False)
    jparams = j_init_params(jc, seed=0, quantize=True, std=0.05)
    ids = np.random.default_rng(1).integers(0, 300, (1, 256))
    ref, _ = j_forward(jc, jparams, jnp.asarray(ids, jnp.int32),
                       j_init_cache(jc, 1, dtype="int8"), 0, fresh_kv=True)
    ref = np.asarray(ref)
    cfg = ModelConfig(**NEOX, compute_dtype=compute, use_flash=False)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    calls = []
    real = transformer.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(transformer, "flash_attention", counting)
    got, _ = transformer.forward(
        cfg, params, torch.from_numpy(ids),
        transformer.init_cache(cfg, 1, dtype="int8", device="cpu"), 0,
        fresh_kv=True)
    assert not calls
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got.numpy() - ref).max() <= 0.01 * np.abs(ref).max()
    transformer.forward(cfg.replace(use_flash=True), params,
                        torch.from_numpy(ids[:, :8]), None, 0)
    assert len(calls) == cfg.n_layer


def test_bench_matrix_configs_are_the_jax_tools():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_matrix", os.path.join(REPO, "tools", "bench_matrix.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    assert bench_matrix.CONFIGS == jax_tool.CONFIGS
    cmds = bench_matrix.commands(extra=["--device", "cpu"])
    assert [n for n, _ in cmds] == [c["name"] for c in jax_tool.CONFIGS]
    for (name, cmd), c in zip(cmds, jax_tool.CONFIGS):
        assert cmd == [sys.executable, "-m", "vsim_tpu_torch.bench",
                       *c["args"], "--device", "cpu"]
    only = bench_matrix.commands(["gpt-neox-20b-b8"])
    assert [n for n, _ in only] == ["gpt-neox-20b-b8"]


def test_mini_tpu_bench_on_a_small_checkpoint(tmp_path, capsys):
    cfg = ModelConfig(**dict(NEOX, n_vocab=256, n_ctx=128))
    ckpt = str(tmp_path / "ckpt")
    save_params(ckpt, cfg, init_params(cfg, seed=0, device="cpu"))
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps({"perf": {"q4_0_t1": {
        "tokens_per_s": 32.258, "ms_per_token": 31.0}}}))
    out = tmp_path / "out.json"
    assert mini_tpu_bench.main(["--ckpt", ckpt, "--tokens", "40",
                                "--out", str(out), "--reference", str(ref),
                                "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    row = last_json(printed)
    assert row["tokens_per_s"] > 0 and row["device"] == "cpu"
    assert "32.258 tokens/s" in printed
    doc = json.loads(out.read_text())
    assert doc["ours_q4_0_b1"] == row
    assert doc["reference_q4_0_t1"]["tokens_per_s"] == 32.258
    assert json.loads(ref.read_text())["perf"].keys() == {"q4_0_t1"}
