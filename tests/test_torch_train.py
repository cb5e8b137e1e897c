"""Port vs JAX package: the training step (engine/train.py) on a tiny
GPT-NeoX (2 layers, E=64, H=2, D=32, n_rot 16, vocab 128), f32, both sides
from their own package's ``init_params(seed)`` (the same bytes).

Ids of 257 tokens make the JAX side take its flash route (T = 256 >= 256,
S % 128 == 0: Pallas forward and backward in interpret mode); 17 tokens its
einsum route.  The port runs ``flash_attention`` (plain K4/K7/K8 on the CPU)
for both.

Tolerances: loss rtol 1e-5 (f32, sums in another order); every gradient
leaf within 1e-4 of its own max|grad| plus 1e-7 of the largest gradient of
any leaf (a leaf whose true gradient is 0, such as the key bias of the
unrotated dims, holds only rounding noise); after three AdamW steps the
losses rtol 1e-5 and the params within 3e-6 (each step moves a weight by
about lr = 1e-4, and a noise-sized gradient's step is its sign times up
to lr).  Each step's change of the layer-norm weights, which start at 1,
within 4e-3 of JAX's: f32 rounding at 1 is 1.2e-3 of a 1e-4 step, and
torch's default decay of 1e-2 in place of optax's 1e-4 would add 1e-2.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vsim_tpu.engine import train as jtrain
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu_torch.engine import train as ptrain
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import init_params

NEOX_TINY = dict(arch="gptneox", n_vocab=128, n_ctx=256, n_embd=64,
                 n_head=2, n_layer=2, n_ff=128, n_rot=16)


def _setup(n_tok, seed=0):
    jc, pc = JConfig(**NEOX_TINY), ModelConfig(**NEOX_TINY)
    jp = j_init_params(jc, seed=seed)
    pp = init_params(pc, seed=seed, device="cpu")
    ids = np.random.default_rng(n_tok).integers(0, 128, (2, n_tok))
    return jc, jp, pc, pp, ids


def _flat(tree, prefix=""):
    """{path: leaf} of a params tree (dict of arrays/tensors)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n_tok", [257, 17])
def test_loss_and_grads_match_jax(n_tok):
    jc, jp, pc, pp, ids = _setup(n_tok)
    jids = jnp.asarray(ids, jnp.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtrain.cross_entropy_loss(jc, p, jids))(jp)
    leaves = ptrain.float_leaves(pp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = ptrain.cross_entropy_loss(pc, pp, torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jflat, pflat = _flat(jgrads), _flat(pp)
    assert set(jflat) == set(pflat) == set(leaves)
    top = max(np.abs(np.asarray(g)).max() for g in jflat.values())
    for name, g in jflat.items():
        ref = np.asarray(g)
        got = pflat[name].grad.numpy()
        tol = 1e-4 * np.abs(ref).max() + 1e-7 * top
        assert np.abs(got - ref).max() <= tol, name


@pytest.mark.parametrize("n_tok", [257, 17])
def test_train_steps_match_jax(n_tok):
    jc, jp, pc, pp, ids = _setup(n_tok, seed=1)
    j_init, j_step = jtrain.make_train_step(jc)
    p_init, p_step = ptrain.make_train_step(pc)
    j_state, p_state = j_init(jp), p_init(pp)
    jids, pids = jnp.asarray(ids, jnp.int32), torch.from_numpy(ids)
    first = {k: _np(v).copy() for k, v in _flat(pp).items()}
    j_losses, p_losses = [], []
    for _ in range(3):
        p_before = {k: _np(v).copy() for k, v in _flat(pp).items()}
        j_before = _flat(jax.tree.map(np.asarray, jp))
        jp, j_state, jl = j_step(jp, j_state, jids)
        pp2, p_state, pl = p_step(pp, p_state, pids)
        assert pp2 is pp  # in place
        j_losses.append(float(jl))
        p_losses.append(float(pl))
        j_after = _flat(jax.tree.map(np.asarray, jp))
        for name in ("layers/ln1_w", "layers/ln2_w", "ln_f_w"):
            dj = j_after[name] - j_before[name]
            dp = _np(_flat(pp)[name]) - p_before[name]
            assert np.abs(dp - dj).max() <= 4e-3 * np.abs(dj).max(), name
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-5)
    assert p_losses[-1] < p_losses[0]
    jflat = _flat(jax.tree.map(np.asarray, jp))
    for name, t in _flat(pp).items():
        got = _np(t)
        np.testing.assert_allclose(got, jflat[name], rtol=0, atol=3e-6,
                                   err_msg=name)
        assert np.abs(got - first[name]).max() > 1e-5, name  # it trained


def test_default_optimizer_is_optax_adamw():
    """The default optimizer is ``optax.adamw(1e-4)`` with optax's own
    defaults (b1, b2, eps, weight_decay; mask=None: every leaf decays), as
    the JAX package's make_train_step builds it."""
    pc = ModelConfig(**NEOX_TINY)
    pp = init_params(pc, seed=0, device="cpu")
    opt = ptrain.make_train_step(pc)[0](pp)
    want = {k: v.default for k, v in
            inspect.signature(optax.adamw).parameters.items()
            if v.default is not inspect.Parameter.empty}
    assert want["mask"] is None and want["eps_root"] == 0.0
    assert not want["nesterov"]
    assert type(opt) is torch.optim.AdamW
    assert len(opt.param_groups) == 1
    group = opt.param_groups[0]
    assert len(group["params"]) == len(ptrain.float_leaves(pp))
    assert group["lr"] == 1e-4
    assert group["betas"] == (want["b1"], want["b2"])
    assert group["eps"] == want["eps"]
    assert group["weight_decay"] == want["weight_decay"]
    assert not group["amsgrad"] and not group["maximize"]


def test_train_perplexity_matches_jax():
    jc, jp, pc, pp, ids = _setup(257)
    ref = jtrain.perplexity(jc, jp, jnp.asarray(ids, jnp.int32))
    got = ptrain.perplexity(pc, pp, torch.from_numpy(ids))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert 0.5 * 128 < got < 2 * 128  # an untrained model: near |V|


def test_q4_leaves_stay_frozen():
    """Only float leaves train: Q4 weights keep their bytes, and a custom
    optimizer factory is used as given."""
    pc = ModelConfig(**NEOX_TINY)
    pp = init_params(pc, seed=2, quantize=True, device="cpu")
    wq = pp["layers"]["wq"]
    packed = wq.packed.clone()
    init, step = ptrain.make_train_step(
        pc, optimizer=lambda leaves: torch.optim.SGD(leaves, lr=0.1))
    state = init(pp)
    assert isinstance(state, torch.optim.SGD)
    assert all(t.dtype != torch.uint8 for g in state.param_groups
               for t in g["params"])
    ln = pp["layers"]["ln1_w"].detach().clone()
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (1, 9)))
    _, _, loss = step(pp, state, ids)
    assert torch.isfinite(loss) and not loss.requires_grad
    assert torch.equal(wq.packed, packed)
    assert not torch.equal(pp["layers"]["ln1_w"], ln)
