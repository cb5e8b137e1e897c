"""The root probes' counterparts (vsim_tpu_torch/tools/gi_batch_probe.py and
attn_gate_probe.py) against the JAX package on the CPU.

* K1's plain version (``q4_gemv_ps_plain``, the grouped-integer math) at
  9-32 rows against the Pallas giw kernel ``_pallas_q4_matmul_ps_giw`` in
  interpret mode with its n <= 8 gate lifted (what tools/gi_batch_probe.py
  runs), K = 512, O = 256, block_kh 256, kchunk None and 128, with and
  without a bias: within 1e-5 of max|ref| (f32 sums in another order).
* The port's ``decode_attention_oracle`` and the kernel route's plain
  version (``decode_attention_q`` on the CPU) against the JAX
  ``decode_attention_oracle`` at every head dim of the zoo, int8 and int4,
  on one cache quantized by the JAX tool's ``make_cache``: 1e-5 of max|ref|.
* Both tools' CPU ``run`` and ``--check``, and their JSON keys held to the
  keys the JAX tools print (read from those files' AST).
* tools/k1_compare.py (K1's n <= 8 outputs against another checkout's
  build) refuses a directory that is no checkout, and covers the probe's
  weights.
"""

import ast
import importlib.util
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.ops.decode_attention import (
    decode_attention_oracle as j_oracle)
from vsim_tpu.ops.pallas_q4 import _pallas_q4_matmul_ps_giw
from vsim_tpu_torch.ops.decode_attention import (decode_attention_oracle,
                                                 decode_attention_q)
from vsim_tpu_torch.ops.q4_cuda import (GEMV_MAX_ROWS, q4_gemv_ps,
                                        q4_gemv_ps_plain)
from vsim_tpu_torch.tools import attn_gate_probe, gi_batch_probe, k1_compare

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jgate = load_jax_tool("attn_gate_probe")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("has_bias", [False, True])
@pytest.mark.parametrize("kchunk", [None, 128])
@pytest.mark.parametrize("n", [9, 16, 24, 32])
def test_k1_plain_past_8_rows_matches_the_giw_kernel(n, kchunk, has_bias):
    K, O = 512, 256  # noqa: N806
    rng = np.random.default_rng(n)
    packed = rng.integers(0, 256, (K // 2, O), dtype=np.uint8)
    scales = torch.from_numpy((rng.random((K // 32, O)) * 0.02).astype(
        np.float32)).to(torch.bfloat16)
    x = rng.standard_normal((n, K)).astype(np.float32)
    bias = rng.standard_normal(O).astype(np.float32)
    ref = _pallas_q4_matmul_ps_giw(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed),
        jnp.asarray(scales.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(bias).reshape(1, O) if has_bias else None,
        block_kh=256, ochunk=O, interpret=True, has_bias=has_bias,
        kchunk=kchunk)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    b = torch.from_numpy(bias) if has_bias else None
    got = q4_gemv_ps_plain(xt, torch.from_numpy(packed), scales, b)
    _close(got.numpy(), ref)
    # on a CPU tensor the wrapper takes 9-32 rows through its plain version
    assert torch.equal(q4_gemv_ps(xt, torch.from_numpy(packed), scales, b),
                       got)


def _cache(D, H, kv):  # noqa: N803
    """One cache from the JAX tool's ``make_cache`` (JAX's quantizers), as
    numpy for both packages: B=4, S=256, L=2."""
    rng = np.random.default_rng(D + (kv == "int4"))
    k_store = jgate.make_cache(rng, 2, 4, H, 256, D, kv)
    v_store = jgate.make_cache(rng, 2, 4, H, 256, D, kv)
    q = rng.standard_normal((4, 1, H, D)).astype(np.float32)
    n_past = rng.integers(1, 255, size=(4,)).astype(np.int32)
    return k_store, v_store, q, n_past


def _torch_store(store):
    vals, scales = (np.asarray(a) for a in store)
    return (torch.from_numpy(vals.copy()),
            torch.from_numpy(scales.astype(np.float32)).to(torch.bfloat16))


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", sorted({d for _, d, _, _ in
                                      attn_gate_probe.ZOO}))
def test_decode_attention_routes_match_the_jax_oracle(D, kv):  # noqa: N803
    k_store, v_store, q, n_past = _cache(D, 3, kv)
    scale = 1.0 / math.sqrt(D)
    qb = jnp.asarray(q, jnp.bfloat16)
    ref = j_oracle(qb, k_store, v_store, 1, jnp.asarray(n_past), kv_len=256,
                   scale=scale)
    kt, vt = _torch_store(k_store), _torch_store(v_store)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    npt = torch.from_numpy(n_past)
    oracle = decode_attention_oracle(qt, kt, vt, 1, npt, scale=scale)
    _close(oracle.numpy(), ref)
    kernel_route = decode_attention_q(qt[:, 0], kt, vt, 1, npt, scale=scale)
    _close(kernel_route.numpy(), np.asarray(ref)[:, 0])
    # the tool's einsum route, bf16 p and values: bf16's 2^-8
    einsum = attn_gate_probe.einsum_layer(qt, 1, kt, vt, npt, 256, scale)
    _close(einsum.float().numpy(), ref, tol=2 ** -7)


def test_gi_batch_probe_on_the_cpu(capsys):
    assert gi_batch_probe.main(["--device", "cpu", "--check"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == ["n=", "n=", "n=", "n="]
    rows = gi_batch_probe.run([(256, 512)], (9, 32), device="cpu")
    assert [(r["n"], r["variant"]) for r in rows] == [
        (9, "giw"), (9, "f32x"), (32, "giw"), (32, "f32x")]
    assert all(r["ms"] is None and r["kchunk"] is None and r["rel_err"] == 0
               for r in rows)


def test_attn_gate_probe_on_the_cpu(capsys):
    assert attn_gate_probe.main(["--device", "cpu", "--check"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 * len(attn_gate_probe.ZOO)
    assert all("relerr" in ln for ln in out)
    rows = attn_gate_probe.run(attn_gate_probe.ZOO[:2], batch=2, kvlen=64,
                               device="cpu")
    assert [(r["model"], r["kv"]) for r in rows] == [
        (m, kv) for m, _, _, _ in attn_gate_probe.ZOO[:2]
        for kv in ("int8", "int4")]
    assert all(r["kernel_ms"] is None and r["rel_err"] <= 1e-3
               for r in rows)


def _function(path, name):
    with open(path) as f:
        tree = ast.parse(f.read())
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _const_keys(node) -> set:
    return {k.value for d in ast.walk(node) if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant)}


def test_gi_batch_probe_keys_are_the_jax_tools(capsys):
    """Every key the JAX tool's ``row`` dicts print (its ``main``), but the
    ``error`` a TPU failure printed (the port raises instead)."""
    fn = _function(os.path.join(REPO, "tools", "gi_batch_probe.py"), "main")
    want = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "row"
                for t in node.targets):
            want |= _const_keys(node.value)
    assert {"shape", "n", "variant", "kchunk", "ms", "gbs"} <= want
    gi_batch_probe.run([(128, 256)], (16,), ("giw",), device="cpu")
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert want - {"error"} <= set(line)


def test_attn_gate_probe_keys_are_the_jax_tools(capsys):
    """The JAX tool's printed keys: its ``main``'s dict literal and
    ``<pass>_<stat>`` for each pass of ``bench_one`` and each stat of its
    ``out[name]`` dict (but ``error``)."""
    path = os.path.join(REPO, "tools", "attn_gate_probe.py")
    want = _const_keys(_function(path, "main"))
    bench = _function(path, "bench_one")
    passes = [e.elts[0].value for f in ast.walk(bench)
              if isinstance(f, ast.For) and isinstance(f.iter, ast.Tuple)
              for e in f.iter.elts if isinstance(e, ast.Tuple)]
    stats = set()
    for node in ast.walk(bench):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Subscript) for t in node.targets):
            stats |= _const_keys(node.value)
    want |= {f"{p}_{s}" for p in passes for s in stats - {"error"}}
    assert {"kernel_ms", "kernel_gbs", "einsum_ms", "einsum_gbs",
            "model", "D", "kv"} <= want
    attn_gate_probe.run(attn_gate_probe.ZOO[3:4], ("int8",), batch=1,
                        kvlen=32, device="cpu")
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert want <= set(line)


def test_k1_compare_refuses_a_directory_that_is_no_checkout(tmp_path):
    with pytest.raises(FileNotFoundError, match="root of a checkout"):
        k1_compare.build_other(str(tmp_path), str(tmp_path / "build"))
    assert not (tmp_path / "build").exists()


def test_k1_compare_covers_the_probes_weights_at_every_gemv_row_count():
    for shapes in gi_batch_probe.SHAPES.values():
        assert set(shapes) <= set(k1_compare.SHAPES)
    assert k1_compare.NS == tuple(range(1, GEMV_MAX_ROWS + 1))
