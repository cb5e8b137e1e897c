"""Port vs JAX tool: ``vsim_tpu_torch/tools/train_small.py`` against
``tools/train_small.py`` on a tiny GPT-NeoX (E 64, L 2, H 2, n_rot 16,
V 256, n_ctx 32), the same numpy inputs on both sides.

Tolerances: the learning rate at every step rtol 1e-6 of optax's (both in
float32, one ulp apart at most); the clip rtol 1e-6 (equal below the norm);
three recipe steps at f32 compute with the clip engaged: losses rtol 1e-5,
every leaf within 3e-6, as tests/test_torch_train.py holds its steps; Q4
bytes equal; the f32 eval rows rtol 1e-5, bf16 compute 1e-2 (every
activation rounds to bf16 at places where the two frameworks' sums
differ); the checkpoint leaves equal both ways.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vsim_tpu.convert import store as jstore
from vsim_tpu.engine.evaluate import perplexity as j_perplexity
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu_torch.convert import store as pstore
from vsim_tpu_torch.engine.train import float_leaves, make_train_step
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.tools import kv_ppl as pkv
from vsim_tpu_torch.tools import train_small as pts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(arch="gptneox", n_vocab=256, n_ctx=32, n_embd=64, n_head=2,
            n_layer=2, n_ff=256, n_rot=16)
CORPUS_BYTES = 200_000


def load_jax_tool(name):
    """``tools/<name>.py`` of the JAX package as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jts = load_jax_tool("train_small")


@pytest.fixture(scope="module")
def corpora():
    """Both tools' corpus at a small budget, built once."""
    return jts.build_corpus(CORPUS_BYTES), pts.build_corpus(CORPUS_BYTES)


def tiny(compute_dtype="float32", seed=0):
    """(JAX config, JAX params, port config, port params) from one seed;
    the port's params are the JAX ones carried across."""
    jc = JConfig(**TINY, compute_dtype=compute_dtype)
    pc = ModelConfig(**TINY, compute_dtype=compute_dtype)
    jp = j_init_params(jc, seed=seed, param_dtype=jnp.float32)
    pp = params_from_numpy(pc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, pc, pp


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def test_corpus_byte_identical(corpora):
    (jt, je), (pt, pe) = corpora
    assert pt.dtype == pe.dtype == np.uint8
    assert jt.size >= CORPUS_BYTES and je.size >= CORPUS_BYTES // 20
    assert pt.tobytes() == np.asarray(jt).tobytes()
    assert pe.tobytes() == np.asarray(je).tobytes()


def test_recipe_config_is_the_jax_tools():
    assert {f: getattr(pts.CFG, f) for f in pts.CFG.__dataclass_fields__} \
        == {f: getattr(jts.CFG, f) for f in pts.CFG.__dataclass_fields__}


@pytest.mark.parametrize("steps", [10, 50, 3000])
def test_lr_schedule_matches_optax(steps):
    warmup = min(100, max(1, steps // 10))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, warmup_steps=warmup, decay_steps=max(steps, warmup + 1),
        end_value=3e-4 * 0.1)
    counts = np.arange(steps + 2, dtype=np.int32)
    want = np.asarray(sched(jnp.asarray(counts)))
    lr = pts.lr_schedule(steps)
    got = np.array([lr(int(c)) for c in counts], np.float32)
    assert got[0] == 0.0  # the first update has lr 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ratio", [2.0, 0.5])
def test_clip_matches_optax(ratio):
    """Below (ratio 2: max_norm twice the norm) and above (0.5) the
    global norm."""
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((5, 7)).astype(np.float32),
             "b": rng.standard_normal(11).astype(np.float32) * 0.1}
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads.values())))
    max_norm = norm * ratio
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    got = [torch.from_numpy(grads[k].copy()) for k in ("a", "b")]
    got_norm = pts.clip_by_global_norm_(got, max_norm)
    np.testing.assert_allclose(float(got_norm), norm, rtol=1e-6)
    for k, g in zip(("a", "b"), got):
        if ratio > 1:
            assert np.array_equal(g.numpy(), grads[k])
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=0)


def test_recipe_steps_match_jax(corpora):
    """Three recipe steps (f32 compute; the schedule sized for 3 steps:
    warmup 1, so lr 0, then 3e-4 and its decay) on windows drawn as the
    recipe draws them, against ``make_train_step`` of the JAX tool with
    its optax chain.  The port's step forwards the first T tokens of each
    [B, T + 1] window, the JAX tool's all T + 1 (the last logit dropped):
    a causal model gives the first T logits alike.  The gradient norm
    exceeds 1 at every step here, so the clip is engaged."""
    (_, _), (train_b, _) = corpora
    steps, B = 3, 2  # noqa: N806
    jc, jp, pc, pp = tiny("float32", seed=1)
    warmup = min(100, max(1, steps // 10))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, warmup_steps=warmup, decay_steps=max(steps, warmup + 1),
        end_value=3e-5)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=0.01))
    j_state = tx.init(jp)
    j_step = jts.make_train_step(jc, tx)
    p_init, p_step = make_train_step(pc, pts.recipe_optimizer(steps))
    p_state = p_init(pp)
    assert isinstance(p_state, pts.RecipeAdamW)
    batches = pts.draw_batches(train_b, steps, B, pc.n_ctx)
    rng = np.random.default_rng(0)  # the JAX loop's own draws
    first = {k: _np(v).copy() for k, v in _flat(pp).items()}
    j_losses, p_losses = [], []
    for i in range(steps):
        starts = rng.integers(0, train_b.size - pc.n_ctx - 1, B)
        ids = np.stack([train_b[s:s + pc.n_ctx + 1] for s in starts])
        assert np.array_equal(ids, batches[i])
        jp, j_state, jl = j_step(jp, j_state, jnp.asarray(ids, jnp.int32))
        _, p_state, pl = p_step(pp, p_state,
                                torch.from_numpy(batches[i]).long())
        j_losses.append(float(jl))
        p_losses.append(float(pl))
        norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                    for p in float_leaves(pp).values())))
        assert norm == pytest.approx(1.0, rel=1e-5)  # clipped to max_norm
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-5)
    jflat = _flat(jax.tree.map(np.asarray, jp))
    for name, t in _flat(pp).items():
        got = _np(t)
        np.testing.assert_allclose(got, jflat[name], rtol=0, atol=3e-6,
                                   err_msg=name)
        assert np.abs(got - first[name]).max() > 1e-5, name  # it trained


def test_quantize_params_byte_identical():
    _, jp, _, pp = tiny()
    jq, pq = jts.quantize_params(jp), pts.quantize_params(pp)
    jflat, pflat = _flat(jq), _flat(pq)
    assert set(jflat) == set(pflat)
    n_q4 = 0
    for name, j in jflat.items():
        p = pflat[name]
        if hasattr(j, "packed"):
            n_q4 += 1
            assert p.layout == "i" and p.packed.dtype == torch.uint8
            assert np.array_equal(p.packed.numpy(), np.asarray(j.packed))
            assert np.array_equal(
                p.scales.view(torch.int16).numpy().view(np.uint16),
                np.asarray(j.scales).view(np.uint16)), name
        else:
            assert np.array_equal(_np(p), np.asarray(j)), name
    assert n_q4 == 6 + 2  # the six stacked layer weights, wte, lm_head


def test_eval_table_matches_jax(corpora):
    (_, eval_b), _ = corpora
    toks = eval_b[:200].astype(np.int64)
    jc, jp, pc, pp = tiny("bfloat16")
    jq = jts.quantize_params(jp)
    f32 = jc.replace(compute_dtype="float32")
    want = {"f32": j_perplexity(f32, jp, toks)["ppl"],
            "bf16": j_perplexity(jc, jp, toks)["ppl"],
            "q4": j_perplexity(f32, jq, toks)["ppl"],
            "q4_act_quant": j_perplexity(f32.replace(act_quant=True), jq,
                                         toks)["ppl"]}
    rows = pts.eval_rows(pc, pp, toks, log=None)
    assert all(r["tokens"] == toks.size - 1 for r in rows.values())
    for name, ref in want.items():
        rtol = 1e-2 if name == "bf16" else 1e-5
        np.testing.assert_allclose(rows[name]["ppl"], ref, rtol=rtol,
                                   err_msg=name)
    table = pts.ppl_table(rows)
    assert set(table) == set(pts.EVAL_ROWS) | {"delta_q4_vs_f32",
                                               "delta_q4aq_vs_f32"}
    assert table["delta_q4_vs_f32"] == round(table["q4"] - table["f32"], 4)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_both_ways(tmp_path, writer):
    """The recipe's checkpoint (dense f32 leaves, bf16 compute in the
    config): written by one package, read by the other unchanged."""
    jc, jp, pc, pp = tiny("bfloat16", seed=2)
    path = str(tmp_path / "ckpt")
    if writer == "port":
        pstore.save_params(path, pc, pp)
        cfg, got = jstore.load_params(path)
        assert cfg == jc
        got = jax.tree.map(np.asarray, got)
    else:
        jstore.save_params(path, jc, jp)
        cfg, got = pstore.load_params(path, device="cpu")
        assert cfg == pc
    want, got = _flat(pp), _flat(got)
    assert set(got) == set(want)
    for name, t in want.items():
        assert np.array_equal(_np(got[name]), _np(t)), name


def test_tools_end_to_end_on_cpu(tmp_path, monkeypatch, corpora):
    """Both command lines on the CPU at the tiny config: train 2 steps,
    save, the ppl table; then kv_ppl on the checkpoint, its rows merged
    into the same ppl.json.  The JAX package reads the checkpoint."""
    (_, _), corpus = corpora
    monkeypatch.setattr(pts, "CFG", ModelConfig(**TINY,
                                                compute_dtype="bfloat16"))
    monkeypatch.setattr(pts, "build_corpus", lambda: corpus)
    monkeypatch.setattr(pkv, "build_corpus", lambda: corpus)
    out = str(tmp_path / "mp")
    table = pts.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                      "--eval-tokens", "100", "--out", out])
    kv = pkv.main(["--device", "cpu", "--ckpt", out, "--windows", "2",
                   "--win-len", "8"])
    with open(os.path.join(out, "ppl.json")) as f:
        saved = json.load(f)
    assert saved == {**table, **kv}
    assert len(saved) == 6 + 7 and all(np.isfinite(v) for v in saved.values())
    with open(os.path.join(out, "train.json")) as f:
        stats = json.load(f)
    assert stats["device"] == "cpu" and stats["steps"] == 2
    assert sorted(stats["losses"]) == ["0", "1"]
    cfg, params = jstore.load_params(out)
    assert cfg == JConfig(**TINY, compute_dtype="bfloat16")
    assert params["layers"]["wq"].shape == (2, 64, 64)
