"""The port's AutoInference and chat CLI: the counterparts of
tests/test_api.py's ten tests on the CPU (``_download`` against the same
local HTTP server), and the port against the JAX package's AutoInference on
one model file: a tiny GPT-NeoX (E = 64, H = 4, 2 layers, vocab 96) written
by the JAX package as a ggml Q4_0 file with a byte-level vocab (the 95
printable ASCII characters and a newline), and as a checkpoint directory.

  * greedy streams equal the JAX AutoInference's, from a text prompt
    through ``VocabTokenizer``, and ``return_logits`` within 1e-5 of
    max|logit|, from either source;
  * without transformers, the tokenizer is the file's vocab;
  * the chat CLI runs with ``--device cpu``;
  * without a card and without ``device="cpu"``, AutoInference raises.

No test lets AutoInference look a tokenizer up by name: each passes one,
or runs with transformers made unimportable.
"""

import sys

import numpy as np
import pytest
import torch

from vsim_tpu.api.interface import AutoInference as JAutoInference
from vsim_tpu.api.interface import VocabTokenizer as JVocabTokenizer
from vsim_tpu.convert.export_ggml import export_ggml as j_export_ggml
from vsim_tpu.convert.hf import convert_hf_model as j_convert_hf_model
from vsim_tpu.convert.store import save_params as j_save_params
from vsim_tpu_torch.api import chat
from vsim_tpu_torch.api import interface as iface
from vsim_tpu_torch.api.interface import (
    MAP_MODEL_TO_URL,
    AutoInference,
    VocabTokenizer,
)

from test_api import DummyTokenizer, _serve_once
from test_model_parity import _hf_model

NAME = "OpenAssistant/oasst-sft-1-pythia-12b"  # a gptneox registry entry
VOCAB = [bytes([c]) for c in range(32, 127)] + [b"\n"]
TEXT = "Hello, world"


@pytest.fixture(scope="module")
def ai():
    return AutoInference("test/tiny-neox", hf_model=_hf_model("gptneox"),
                         tokenizer=DummyTokenizer(), n_ctx=64, device="cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(ggml path, checkpoint dir) of one tiny GPT-NeoX, both written by
    the JAX package."""
    d = tmp_path_factory.mktemp("model")
    model = _hf_model("gptneox")
    j_export_ggml(str(d / "model.bin"), model, quantize=True, vocab=VOCAB)
    j_save_params(str(d / "ckpt"), *j_convert_hf_model(model))
    return str(d / "model.bin"), str(d / "ckpt")


def test_registry_covers_reference_models():
    assert len(MAP_MODEL_TO_URL) == 14
    archs = {e.cpp_model_name for e in MAP_MODEL_TO_URL.values()}
    assert archs == {"gptneox", "gptj", "bloom", "gpt2"}
    assert MAP_MODEL_TO_URL[NAME].get_modes() == ["int4_fixed_zero"]


def test_generate_result_shape(ai):
    out = ai.generate("hello", num_tokens_to_generate=5, greedy=True,
                      stop_tokens=())
    assert out["success"] is True
    assert len(out["generated_token_ids"]) == 5
    assert out["token_ids"][:-5] == ai.tokenizer.encode("hello")
    assert isinstance(out["token_str"], str)


def test_streaming_hooks(ai):
    ids_seen, strs_seen = [], []
    out = ai.generate(
        [1, 2, 3], num_tokens_to_generate=4, greedy=True, stop_tokens=(),
        streaming_token_ids_hook=ids_seen.append,
        streaming_token_str_hook=strs_seen.append)
    assert ids_seen == out["generated_token_ids"]
    assert len(strs_seen) == 4


def test_return_logits_protocol(ai):
    lg = ai.return_logits([1, 2, 3, 4, 5])
    assert lg.shape == (5, ai.config.n_vocab)
    out = ai.generate([1, 2, 3, 4, 5], num_tokens_to_generate=1, greedy=True,
                      stop_tokens=())
    assert out["generated_token_ids"][0] == int(np.argmax(lg[-1]))


def test_seeded_generation_reproducible(ai):
    a = ai.generate([5, 6, 7], num_tokens_to_generate=8, seed=42,
                    stop_tokens=())
    b = ai.generate([5, 6, 7], num_tokens_to_generate=8, seed=42,
                    stop_tokens=())
    assert a["token_ids"] == b["token_ids"]


def test_eos_stops_generation(ai):
    out = ai.generate([1, 2, 3], num_tokens_to_generate=30, greedy=True,
                      stop_tokens=range(96))
    assert len(out["generated_token_ids"]) == 1


def test_unknown_model_rejected():
    with pytest.raises(ValueError, match="unknown model"):
        AutoInference("not/a-model", device="cpu")


def test_download_atomic_and_resumable(tmp_path):
    payload = bytes(range(256)) * 1000
    url, shutdown = _serve_once(payload)
    try:
        dest = str(tmp_path / "model.bin")
        with open(dest + ".part", "wb") as f:  # an interrupted download
            f.write(payload[:10_000])
        iface._download(url, dest)
        assert open(dest, "rb").read() == payload
        assert not (tmp_path / "model.bin.part").exists()
    finally:
        shutdown()


def test_sha256_pin_detects_corruption(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(iface, "CACHE_PATH", str(tmp_path))
    payload = b"model-bytes" * 100
    url, shutdown = _serve_once(payload)
    try:
        monkeypatch.setitem(iface.MAP_MODEL_TO_URL, "test/tiny",
                            iface.ModelUrlMap("gptneox", url))
        ai = object.__new__(AutoInference)
        ai.model_name, ai.mode = "test/tiny", "int4_fixed_zero"
        path = ai._resolve_model_path()
        assert open(path, "rb").read() == payload
        assert open(path + ".sha256").read().strip() == iface._sha256(path)
        ai._resolve_model_path()  # pristine: no warning
        assert "WARNING" not in capsys.readouterr().out
        with open(path, "ab") as f:
            f.write(b"junk")
        ai._resolve_model_path()
        assert "sha256" in capsys.readouterr().out
    finally:
        shutdown()


def test_vocab_tokenizer_roundtrip():
    vocab = [b"<unk>", b"hello", b" world", b"hel", b"lo", b" ", b"w", b"o",
             b"r", b"l", b"d", b"!"]
    tok = VocabTokenizer(vocab)
    ids = tok.encode("hello world!")
    assert ids == [1, 2, 11]  # the longest entries
    assert tok.decode(ids) == "hello world!"
    assert tok.encode("hello\x00world!") == [1, 6, 7, 8, 9, 10, 11]
    assert tok.decode([1, 999]) == "hello"
    assert ids == JVocabTokenizer(vocab).encode("hello world!")


@pytest.mark.parametrize("source", ["ggml", "checkpoint"])
def test_streams_and_logits_equal_jax(files, source):
    path = files[0] if source == "ggml" else files[1]
    port = AutoInference(NAME, model_path=path, n_ctx=64, device="cpu",
                         tokenizer=VocabTokenizer(VOCAB))
    ref = JAutoInference(NAME, model_path=path, n_ctx=64,
                         tokenizer=JVocabTokenizer(VOCAB))
    got = port.generate(TEXT, num_tokens_to_generate=12, greedy=True,
                        stop_tokens=())
    want = ref.generate(TEXT, num_tokens_to_generate=12, greedy=True,
                        stop_tokens=())
    assert got["token_ids"] == want["token_ids"]
    assert got["token_str"] == want["token_str"]
    ids = VocabTokenizer(VOCAB).encode(TEXT)
    lg, jlg = port.return_logits(ids), np.asarray(ref.return_logits(ids))
    assert lg.shape == jlg.shape == (len(ids), 96)
    assert np.abs(lg - jlg).max() <= 1e-5 * np.abs(jlg).max()


def test_file_vocab_without_transformers(files, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # import fails
    port = AutoInference(NAME, model_path=files[0], n_ctx=64, device="cpu")
    assert isinstance(port.tokenizer, VocabTokenizer)
    assert port.tokenizer.vocab == VOCAB
    assert port.generate(TEXT, num_tokens_to_generate=3, greedy=True,
                         stop_tokens=())["token_ids"][:len(TEXT)] == \
        VocabTokenizer(VOCAB).encode(TEXT)


def test_chat_cli_on_cpu(files, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert chat.main(["--model-path", files[0], "-p", "Hello", "-t", "4",
                      "--device", "cpu", "--seed", "1"]) == 0
    assert capsys.readouterr().out.endswith("\n")


def test_auto_inference_needs_a_card_unless_told(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoInference(NAME, model_path=files[0])
