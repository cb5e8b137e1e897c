"""The device generator of ``models/init.py``'s random inits
(``rng="device"``): the same tree as the numpy draw, at the same scale,
reproducible from its seed, on the CPU here.  numpy stays the default (the
JAX package's values and bytes, held by the parity tests)."""

import pytest
import torch

from vsim_tpu_torch.engine.generate import InferenceEngine
from vsim_tpu_torch.engine.sampling import SamplingParams
from vsim_tpu_torch.models.config import PRESETS
from vsim_tpu_torch.models.init import init_params, random_q4_params
from vsim_tpu_torch.quant.q4 import Q4Tensor

# one preset an architecture: the rotary, the parallel-residual, the
# learned-position and the ALiBi trees
ARCHS = ("pythia-70m", "gpt-j-6b", "gpt2", "bloom-560m")


def tiny(name):
    rot = PRESETS[name].n_rot and 16
    return PRESETS[name].replace(n_layer=2, n_embd=64, n_head=2, n_ff=256,
                                 n_vocab=96, n_ctx=32, n_rot=rot)


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        elif isinstance(v, Q4Tensor):
            out[f"{prefix}{k}.packed"] = v.packed
            out[f"{prefix}{k}.scales"] = v.scales
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_device_rng_tree(name):
    cfg = tiny(name)
    ref = leaves(init_params(cfg, seed=3, device="cpu"))
    got = leaves(init_params(cfg, seed=3, device="cpu", rng="device"))
    assert got.keys() == ref.keys()
    for k, t in got.items():
        assert (t.shape, t.dtype) == (ref[k].shape, ref[k].dtype), k
        if "ln" in k.split("/")[-1]:  # layer norms: ones and zeros
            assert torch.equal(t, ref[k]), k
    w = got["layers/w_fc"]
    assert 0.018 < w.std().item() < 0.022 and abs(w.mean().item()) < 2e-3
    again = leaves(init_params(cfg, seed=3, device="cpu", rng="device"))
    assert all(torch.equal(again[k], t) for k, t in got.items())
    other = leaves(init_params(cfg, seed=4, device="cpu", rng="device"))
    assert not torch.equal(other["layers/w_fc"], w)


@pytest.mark.parametrize("name", ARCHS)
def test_random_q4_params_device_rng_tree(name):
    cfg = tiny(name)
    ref = leaves(random_q4_params(cfg, seed=3, device="cpu"))
    got = leaves(random_q4_params(cfg, seed=3, device="cpu", rng="device"))
    assert got.keys() == ref.keys()
    for k, t in got.items():
        assert (t.shape, t.dtype) == (ref[k].shape, ref[k].dtype), k
        if not k.endswith((".packed", ".scales")):  # vectors: filled
            assert torch.equal(t, ref[k]), k
    s = got["layers/w_fc.scales"].float()
    # uniform in [0, 0.01), rounded to bf16 (which may round up to 0.01)
    assert s.min().item() >= 0 and s.max().item() <= 0.01 * (1 + 2**-8)
    p = got["layers/w_fc.packed"]
    assert p.min().item() == 0 and p.max().item() == 255
    again = leaves(random_q4_params(cfg, seed=3, device="cpu", rng="device"))
    assert all(torch.equal(again[k], t) for k, t in got.items())


def test_device_rng_params_run_an_engine():
    cfg = tiny("pythia-70m")
    params = random_q4_params(cfg, seed=0, device="cpu", rng="device")
    res = InferenceEngine(cfg, params, kv_dtype="int8", device="cpu").generate(
        [1, 2, 3], 4, SamplingParams(greedy=True))
    assert len(res.token_ids) == 4
    assert all(0 <= t < cfg.n_vocab for t in res.token_ids)


def test_rng_refuses_other_names_and_quantized_device_draws():
    cfg = tiny("pythia-70m")
    with pytest.raises(ValueError, match="rng must be"):
        random_q4_params(cfg, device="cpu", rng="host")
    with pytest.raises(ValueError, match="dense weights only"):
        init_params(cfg, device="cpu", quantize=True, rng="device")
