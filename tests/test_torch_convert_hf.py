"""The port's HF conversion against HF itself and against the JAX package,
on tiny models built from configs (tests/test_model_parity.py's
``_hf_model``: E = 64, H = 4, 2 layers, vocab 96; no download).

  * the four tests of tests/test_model_parity.py through the port, at their
    tolerances: f32 logits vs HF, NeoX's sequential residual, Q4 logits vs
    the quantize-dequantized HF model, and one-token decode vs the full
    forward;
  * ``convert_hf_model``'s params byte-identical to the JAX package's, for
    the three scale dtypes, and ``export_ggml``'s files byte-identical;
  * the ``quantize`` CLI on a tiny HF model saved to disk: its store
    directory byte-identical to the JAX package's ``save_params`` of the
    same conversion, and its nibble histogram the JAX CLI's sum.
"""

import dataclasses
import filecmp
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from vsim_tpu.convert.export_ggml import export_ggml as j_export_ggml
from vsim_tpu.convert.hf import convert_hf_model as j_convert_hf_model
from vsim_tpu.convert.store import save_params as j_save_params
from vsim_tpu.quant.q4 import Q4Tensor as JQ4Tensor
from vsim_tpu_torch.convert import quantize as quantize_cli
from vsim_tpu_torch.convert.export_ggml import export_ggml
from vsim_tpu_torch.convert.hf import convert_hf_model
from vsim_tpu_torch.models.transformer import forward, init_cache
from vsim_tpu_torch.quant.q4 import QK, Q4Tensor, dequantize_q4_0_np
from vsim_tpu_torch.quant.q4 import quantize_q4_0_np

from test_model_parity import PROBE, _hf_logits, _hf_model

ARCHS = ["gptneox", "gptj", "codegen", "bloom", "gpt2"]
SCALES = {"bfloat16": (np.dtype(ml_dtypes.bfloat16), torch.bfloat16),
          "float16": (np.float16, torch.float16),
          "float32": (np.float32, torch.float32)}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) \
            if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_params_equal(port, ref, where="params"):
    """A port params tree (CPU tensors) equal byte for byte to a JAX one:
    the same keys, Q4 leaves where the JAX tree has them, the same dtypes
    (bf16 as bits), shapes and bytes."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), where
        for k in ref:
            assert_params_equal(port[k], ref[k], f"{where}/{k}")
        return
    if isinstance(ref, JQ4Tensor):
        assert isinstance(port, Q4Tensor) and port.layout == ref.layout, where
        assert_params_equal(port.packed, ref.packed, where + ".packed")
        assert_params_equal(port.scales, ref.scales, where + ".scales")
        return
    got, want = _bits(port), _bits(ref)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        where, got.dtype, want.dtype, got.shape, want.shape)
    assert np.ascontiguousarray(got).tobytes() == \
        np.ascontiguousarray(want).tobytes(), where


def _logits(cfg, params, ids, n_ctx=32):
    cache = init_cache(cfg, 1, n_ctx=n_ctx, dtype="float32", device="cpu")
    lg, _ = forward(cfg, params, torch.tensor([ids]), cache, 0)
    return lg[0].numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_logits_match_hf(arch):
    model = _hf_model(arch)
    cfg, params = convert_hf_model(model, quantize=False, device="cpu")
    np.testing.assert_allclose(_logits(cfg, params, PROBE),
                               _hf_logits(model, PROBE), rtol=2e-4, atol=2e-4)


def test_gptneox_sequential_residual():
    model = _hf_model("gptneox", use_parallel_residual=False)
    cfg, params = convert_hf_model(model, quantize=False, device="cpu")
    assert not cfg.parallel_residual
    np.testing.assert_allclose(_logits(cfg, params, PROBE),
                               _hf_logits(model, PROBE), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_q4_logits_match_quantized_hf(arch):
    """Q4 forward == HF forward with its weights replaced by their Q4_0
    quantize-dequantize images (f32 scales)."""
    model = _hf_model(arch)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight") and p.ndim == 2:
                w = p.float().numpy()
                # GPT-2's Conv1D weights are [in, out]: quantized along the
                # contraction dim, as the converter sees them
                transpose = arch == "gpt2" and any(
                    s in name for s in ("c_attn", "c_proj", "c_fc"))
                if transpose:
                    w = w.T
                if w.shape[-1] % QK != 0:
                    continue
                deq = dequantize_q4_0_np(*quantize_q4_0_np(w, torch.float32))
                p.copy_(torch.from_numpy(deq.T if transpose else deq))
    cfg, params = convert_hf_model(model, quantize=True,
                                   scale_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(_logits(cfg, params, PROBE),
                               _hf_logits(model, PROBE), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_decode_matches_full_forward(arch):
    """Tokens fed one at a time reproduce the prefill's logits."""
    model = _hf_model(arch)
    cfg, params = convert_hf_model(model, quantize=True,
                                   scale_dtype=torch.float32, device="cpu")
    cache = init_cache(cfg, 1, n_ctx=16, dtype="float32", device="cpu")
    full, _ = forward(cfg, params, torch.tensor([PROBE]), cache, 0)
    cache = init_cache(cfg, 1, n_ctx=16, dtype="float32", device="cpu")
    steps = []
    for t, tok in enumerate(PROBE):
        lg, cache = forward(cfg, params, torch.tensor([[tok]]), cache, t)
        steps.append(lg[0, 0].numpy())
    np.testing.assert_allclose(full[0].numpy(), np.stack(steps), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("arch", ARCHS)
def test_convert_params_byte_identical_to_jax(arch, scale):
    jdt, tdt = SCALES[scale]
    model = _hf_model(arch)
    cfg, params = convert_hf_model(model, scale_dtype=tdt, device="cpu")
    jcfg, jparams = j_convert_hf_model(model, scale_dtype=jdt)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_params_equal(params, jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_export_ggml_byte_identical_to_jax(arch, quantize, tmp_path):
    model = _hf_model(arch)
    export_ggml(str(tmp_path / "port.bin"), model, quantize=quantize)
    j_export_ggml(str(tmp_path / "jax.bin"), model, quantize=quantize)
    assert filecmp.cmp(tmp_path / "port.bin", tmp_path / "jax.bin",
                       shallow=False)


def test_quantize_cli(tmp_path, capsys):
    model = _hf_model("gptneox")
    model.save_pretrained(tmp_path / "hf")
    assert quantize_cli.main([str(tmp_path / "hf"),
                              str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    jcfg, jparams = j_convert_hf_model(model)
    j_save_params(str(tmp_path / "jax"), jcfg, jparams)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "jax",
                                           names, shallow=False)
    assert not mismatch and not errors
    # the JAX CLI's histogram: every nibble of every Q4 leaf
    hist = np.zeros(16, np.int64)
    for leaf in jax.tree.leaves(jparams,
                                is_leaf=lambda x: isinstance(x, JQ4Tensor)):
        if isinstance(leaf, JQ4Tensor):
            p = np.asarray(leaf.packed)
            hist += np.bincount((p & 0x0F).ravel(), minlength=16)
            hist += np.bincount((p >> 4).ravel(), minlength=16)
    want = " ".join(f"{v / hist.sum():5.3f}" for v in hist)
    assert f"nibble histogram: {want}" in out
