"""The port's ggml files and checkpoint store against the JAX package's, on
the tiny HF models of tests/test_model_parity.py (E = 64, H = 4, 2 layers,
vocab 96), in files the tests write themselves.

  * ``read_ggml`` + ``write_ggml`` give back a JAX-written file byte for
    byte, for gptneox, gptj, codegen (a GPT-J file), bloom and gpt2;
  * ``load_ggml_model`` on a JAX-written file gives params byte-identical to
    the JAX loader's, and f32 forward logits within 1e-5 of max|logit| of
    the JAX forward's;
  * the header fields read back as written;
  * the store both ways, with bf16, f16 and f32 scales: a JAX-written
    directory loads in the port and a port-written one in the JAX package,
    to the same bytes, and the two packages write the same files.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.convert.export_ggml import export_ggml as j_export_ggml
from vsim_tpu.convert.ggml_file import load_ggml_model as j_load_ggml_model
from vsim_tpu.convert.ggml_file import read_ggml as j_read_ggml
from vsim_tpu.convert.ggml_file import write_ggml as j_write_ggml
from vsim_tpu.convert.hf import convert_hf_model as j_convert_hf_model
from vsim_tpu.convert.store import load_params as j_load_params
from vsim_tpu.convert.store import save_params as j_save_params
from vsim_tpu.models.transformer import forward as j_forward
from vsim_tpu.models.transformer import init_cache as j_init_cache
from vsim_tpu_torch.convert.export_ggml import export_ggml
from vsim_tpu_torch.convert.ggml_file import (
    FTYPE_F32,
    FTYPE_Q4_0,
    load_ggml_model,
    read_ggml,
    write_ggml,
)
from vsim_tpu_torch.convert.hf import convert_hf_model
from vsim_tpu_torch.convert.store import load_params, save_params
from vsim_tpu_torch.models.transformer import forward, init_cache

from test_model_parity import PROBE, _hf_model
from test_torch_convert_hf import SCALES, assert_params_equal

ARCHS = ["gptneox", "gptj", "codegen", "bloom", "gpt2"]


def _file_arch(arch):
    return "gptj" if arch == "codegen" else arch  # CodeGen ships as GPT-J


@pytest.mark.parametrize("arch", ARCHS)
def test_read_write_gives_the_jax_file_back(arch, tmp_path):
    src = str(tmp_path / "jax.bin")
    j_export_ggml(src, _hf_model(arch), quantize=True)
    a = _file_arch(arch)
    hparams, vocab, tensors = read_ggml(src, a)
    write_ggml(str(tmp_path / "port.bin"), a, hparams, vocab,
               list(tensors.values()))
    jh, jv, jt = j_read_ggml(src, a)
    j_write_ggml(str(tmp_path / "jax2.bin"), a, jh, jv, list(jt.values()))
    assert hparams == jh and vocab == jv
    assert filecmp.cmp(tmp_path / "port.bin", src, shallow=False)
    assert filecmp.cmp(tmp_path / "jax2.bin", src, shallow=False)


def _port_logits(cfg, params):
    cache = init_cache(cfg, 1, n_ctx=32, dtype="float32", device="cpu")
    lg, _ = forward(cfg, params, torch.tensor([PROBE]), cache, 0)
    return lg[0].numpy()


def _jax_logits(cfg, params):
    cache = j_init_cache(cfg, 1, n_ctx=32, dtype=jnp.float32)
    lg, _ = j_forward(cfg, params, jnp.asarray([PROBE], jnp.int32), cache, 0)
    return np.asarray(lg[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_load_ggml_matches_jax_loader(arch, tmp_path):
    path = str(tmp_path / "model.bin")
    j_export_ggml(path, _hf_model(arch), quantize=True)
    a = _file_arch(arch)
    cfg, params, vocab = load_ggml_model(path, a, n_ctx=32, device="cpu")
    jcfg, jparams, jvocab = j_load_ggml_model(path, a, n_ctx=32)
    assert cfg.__dict__ == jcfg.__dict__ and vocab == jvocab
    assert_params_equal(params, jax.tree.map(np.asarray, jparams))
    if arch == "gpt2":  # the tied head is the requantized wte itself
        assert params["lm_head"] is params["wte"]
    got, want = _port_logits(cfg, params), _jax_logits(jcfg, jparams)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_ggml_header_fields(tmp_path):
    path = str(tmp_path / "model.bin")
    export_ggml(path, _hf_model("gptneox"), quantize=True)
    hparams, vocab, tensors = read_ggml(path, "gptneox")
    assert hparams == {"n_vocab": 96, "n_embd": 64, "n_head": 4,
                       "n_layer": 2, "n_rot": 4, "use_parallel_residual": 1,
                       "ftype": 2}
    assert vocab[:2] == [b"<tok0>", b"<tok1>"] and len(vocab) == 96
    # quantized 2-D weights carry ftype 2, 1-D tensors stay f32
    embed = tensors["gpt_neox.embed_in.weight"]
    assert embed.ftype == FTYPE_Q4_0 and embed.shape == (96, 64)
    assert embed.raw.size == 96 * 2 * 20
    assert tensors["gpt_neox.final_layer_norm.weight"].ftype == FTYPE_F32
    bad = tmp_path / "bad.bin"
    data = bytearray((tmp_path / "model.bin").read_bytes())
    data[0] ^= 0xFF
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad magic"):
        read_ggml(str(bad), "gptneox")


@pytest.mark.parametrize("scale", list(SCALES))
def test_store_both_ways(scale, tmp_path):
    jdt, tdt = SCALES[scale]
    model = _hf_model("gptneox")
    jcfg, jparams = j_convert_hf_model(model, scale_dtype=jdt)
    cfg, params = convert_hf_model(model, scale_dtype=tdt, device="cpu")
    ref = jax.tree.map(np.asarray, jparams)
    # JAX → port
    j_save_params(str(tmp_path / "jax"), jcfg, jparams)
    cfg2, params2 = load_params(str(tmp_path / "jax"), device="cpu")
    assert cfg2 == cfg
    assert_params_equal(params2, ref)
    # port → JAX, and the same files
    save_params(str(tmp_path / "port"), cfg, params)
    jcfg2, jparams2 = j_load_params(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    assert_params_equal(params, jax.tree.map(np.asarray, jparams2))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "jax",
                                           names, shallow=False)
    assert not mismatch and not errors
    np.testing.assert_array_equal(_port_logits(cfg2.replace(n_ctx=32),
                                               params2),
                                  _port_logits(cfg.replace(n_ctx=32), params))
