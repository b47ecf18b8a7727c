"""The port's training step against the JAX package, on the CPU at small
sizes: the losses, the objective's gradients, the optimizer, gradient
reversal, dropout and the step itself (grad_norm, EMA, modality dropout).
The trainer and its data, metrics and checkpoints: tests/test_torch_trainer.py.

Inputs are made with numpy from seeds and handed to both packages.
Tolerances: losses, the optimizer and reverse_grad 1e-6 (f32, the same
formulas); one step's gradients 1e-4 in f32 (summation orders through BERT,
the towers and the heads) and 2e-2 in bf16 (the two frameworks' bf16
roundings differ by single units in the last place).  The JAX training
step draws its dropout from JAX's PRNG, which the port cannot reproduce, so
the step is compared with dropout off.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import misa as jmisa
from mmda_tpu.ops import functions as jfn
from mmda_tpu.ops import losses as JL
from mmda_tpu.train import objective as jobjective
from mmda_tpu.train import state as jstate
from mmda_tpu.train.step import _stop_frozen

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import jax_name, load_jax_params
from mmda_tpu_torch.models import MISA, Batch
from mmda_tpu_torch.models.bert import BertConfig, freeze_layers
from mmda_tpu_torch.models.common import dropout
from mmda_tpu_torch.ops import functions as pfn
from mmda_tpu_torch.ops import losses as PL
from mmda_tpu_torch.train.state import Optimizer
from mmda_tpu_torch.train.step import (ema_update, loss_and_grads,
                                       sample_modality_keep, train_step)

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL6 = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ losses


def _loss_inputs(seed, B=8, H=6):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    scores = rng.uniform(0.01, 0.99, size=(B, 6)).astype(np.float32)
    labels = (rng.uniform(size=(B, 6)) < 0.4).astype(np.float32)
    labels[0] = 1.0                                  # every class has a positive
    return dict(scores=scores, labels=labels, tcp=rng.uniform(size=(B, 6)).astype(np.float32),
                six=[f(B, H) for _ in range(6)], dom=[f(B, 3) for _ in range(3)],
                rec=[f(B, H) for _ in range(6)])


LOSS_CASES = {
    "bce": lambda m, a: m.bce(a["scores"], a["labels"]),
    "bce_sum_over_classes": lambda m, a: m.bce_sum_over_classes(a["scores"], a["labels"]),
    "diff_loss": lambda m, a: m.diff_loss(a["six"][0], a["six"][3]),
    "diff_loss_total": lambda m, a: m.diff_loss_total(*a["six"]),
    "cmd_loss": lambda m, a: m.cmd_loss(a["six"][0], a["six"][1]),
    "cmd_loss_total": lambda m, a: m.cmd_loss_total(*a["six"][:3]),
    "domain_loss": lambda m, a: m.domain_loss(*a["dom"]),
    "mse": lambda m, a: m.mse(a["rec"][0], a["rec"][1]),
    "simse": lambda m, a: m.simse(a["rec"][0], a["rec"][1]),
    "recon_loss_total": lambda m, a: m.recon_loss_total(*a["rec"]),
    "conf_loss": lambda m, a: m.conf_loss(a["scores"], a["labels"], a["tcp"], fix=False),
    "conf_loss_fix": lambda m, a: m.conf_loss(a["scores"], a["labels"], a["tcp"], fix=True),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    a = _loss_inputs(seed=len(name))
    as_t = {k: ([_t(x) for x in v] if isinstance(v, list) else _t(v)) for k, v in a.items()}
    as_j = {k: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
            for k, v in a.items()}
    got = LOSS_CASES[name](PL, as_t)
    want = LOSS_CASES[name](JL, as_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL6)


@pytest.mark.parametrize("fix", [False, True])
def test_conf_loss_with_a_class_without_positives(fix):
    """fix=False divides by the class's positive count (inf, as the
    reference); fix=True clamps the count at 1."""
    a = _loss_inputs(seed=1)
    a["labels"][:, 2] = 0.0
    got = PL.conf_loss(_t(a["scores"]), _t(a["labels"]), _t(a["tcp"]), fix=fix).numpy()
    want = np.asarray(JL.conf_loss(jnp.asarray(a["scores"]), jnp.asarray(a["labels"]),
                                   jnp.asarray(a["tcp"]), fix=fix))
    assert np.isfinite(got) == fix and np.isfinite(want) == fix
    np.testing.assert_allclose(got, want, **TOL6)


# --------------------------------------------------- the step's gradients

SIZES = dict(visual_size=5, acoustic_size=7, vocab_size=40)
SMALL = dict(hidden_size=16, embedding_size=6, num_classes=6, **SIZES)


def _batch_arrays(B=6, T=6, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, 1, 3, 5, 2, T][:B], np.int32)
    S = T + 2
    bert_mask = (np.arange(S)[None, :] < (lengths + 2)[:, None]).astype(np.int32)
    emo = (rng.uniform(size=(B, 6)) < 0.4).astype(np.float32)
    emo[0] = 1.0
    return dict(
        text=rng.integers(0, 40, size=(B, T)).astype(np.int32),
        visual=rng.normal(size=(B, T, 5)).astype(np.float32),
        acoustic=rng.normal(size=(B, T, 7)).astype(np.float32),
        lengths=lengths,
        bert_ids=(rng.integers(0, 128, size=(B, S)) * bert_mask).astype(np.int32),
        bert_type=np.zeros((B, S), np.int32), bert_mask=bert_mask,
        sentiment=rng.normal(size=B).astype(np.float32), emo_label=emo,
        sample_weight=np.ones(B, np.float32))


def _port_batch(arrays):
    batch = Batch(**{k: _t(v) for k, v in arrays.items()})
    return batch._replace(**{k: getattr(batch, k).long()
                             for k in ("text", "bert_ids", "bert_type")})


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


@pytest.mark.parametrize("dtype,use_bert,use_cmd_sim,tol", [
    ("float32", True, False, 1e-4), ("float32", False, True, 1e-4),
    ("bfloat16", True, False, 2e-2)])
def test_step_gradients_match_jax_grad(dtype, use_bert, use_cmd_sim, tol):
    """One training step's objective and gradients, dropout off, under the
    mosei freeze rule (tiny BERT: both encoder layers frozen, embeddings and
    pooler train): jax.grad of compute_losses(misa_forward(_stop_frozen(p)))
    against the port's loss_and_grads over its trainable parameters; the
    JAX gradients of frozen leaves are zero."""
    _step_gradients(dtype, use_bert, use_cmd_sim, tol)


@pytest.fixture
def flash_interpreted():
    """The JAX package's flash kernels in interpret mode (off the TPU its
    bert_encode takes the dense core unless a test forces them)."""
    from mmda_tpu.ops.pallas import attention as jattn

    calls, forward = [], jattn._flash_forward
    jattn._flash_forward = lambda *a, **k: calls.append(1) or forward(*a, **k)
    jattn.set_force_interpret(True)
    yield
    jattn.set_force_interpret(False)
    jattn._flash_forward = forward
    assert calls, "the JAX side never reached its flash kernel"


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_flash_step_gradients_match_jax_grad(dtype, tol, flash_interpreted):
    """The same step with attn_impl="flash": the JAX side through its Pallas
    kernels (interpret mode) and their blockwise backward, the port through
    its plain versions; the backward crosses the frozen layers' attention."""
    _step_gradients(dtype, True, False, tol, attn_impl="flash")


def _step_gradients(dtype, use_bert, use_cmd_sim, tol, **extra):
    kw = dict(use_bert=use_bert, use_cmd_sim=use_cmd_sim, compute_dtype=dtype,
              data="mosei", **SMALL, **extra)
    jcfg = JConfig(use_pallas=False, **kw)
    cfg = Config(device="cpu", **kw)
    jbert_cfg = jbert.BertConfig.tiny() if use_bert else None
    tree = jmisa.init_misa_params(jax.random.PRNGKey(4), jcfg, bert_cfg=jbert_cfg)
    frozen = jax.tree_util.tree_map(lambda _: False, tree)
    if use_bert:
        frozen["bert"] = jbert.frozen_mask(tree["bert"], max_frozen_layer=8)
    arrays = _batch_arrays(seed=2)
    jbatch = jmisa.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})

    def loss_fn(p):
        out = jmisa.misa_forward(_stop_frozen(p, frozen), jcfg, jbatch, bert_cfg=jbert_cfg,
                                 deterministic=True)
        losses = jobjective.compute_losses(jcfg, out, jbatch)
        return losses["total"], losses

    jgrads, jlosses = jax.jit(jax.grad(loss_fn, has_aux=True))(tree)

    model = load_jax_params(MISA(cfg, bert_cfg=BertConfig.tiny() if use_bert else None), tree)
    if use_bert:
        freeze_layers(model.bert, 8)
    model.eval()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    losses, grads = loss_and_grads(model, _port_batch(arrays), cfg, [p for _, p in named])
    assert set(losses) == set(jlosses)
    for k in losses:
        np.testing.assert_allclose(losses[k].detach().float().numpy(),
                                   np.asarray(jlosses[k], np.float32), rtol=tol, atol=tol,
                                   err_msg=k)
    for (name, _), g in zip(named, grads):
        path = jax_name(model, name)
        want = np.asarray(_leaf(jgrads, path), np.float32)
        got = g.float().numpy()
        if path.endswith(".kernel"):
            got = got.T
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=path)
    trainable = {jax_name(model, n) for n, _ in named}
    frozen_paths = [jax_name(model, n) for n, p in model.named_parameters()
                    if not p.requires_grad]
    assert len(trainable) + len(frozen_paths) == len(jax.tree_util.tree_leaves(tree))
    for path in frozen_paths:
        assert not np.any(np.asarray(_leaf(jgrads, path))), path


# ---------------------------------------------------------------- optimizer

OPT_CASES = [
    dict(optimizer="Adam"),
    dict(optimizer="Adam", adam_mu_dtype="bfloat16"),
    dict(optimizer="Adam", apply_weight_decay=True, weight_decay=0.01),
    dict(optimizer="AdamW", weight_decay=0.01),
    dict(optimizer="RMSprop"),
    dict(optimizer="SGD", learning_rate=0.1),
    dict(optimizer="Adam", lr_schedule="exponential", lr_decay_rate=0.5, min_lr=1e-5),
    dict(optimizer="Adam", lr_schedule="cosine", warmup_steps=2, n_epoch=2, min_lr=1e-6),
    dict(optimizer="Adam", lr_schedule="plateau"),
]


@pytest.mark.parametrize("case", OPT_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_optimizer_matches_optax(case):
    """Value clip then the rule, over 4 updates with gradients beyond the
    clip, against make_optimizer(cfg, frozen).update, jitted as the JAX
    training step runs it (XLA keeps bf16 mu's product with b1 in f32); the
    frozen leaf is never touched and carries no state."""
    kw = {"clip": 0.5, "learning_rate": 1e-2, **case}
    jcfg, cfg = JConfig(**kw), Config(device="cpu", **kw)
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32),
              "z_frozen": rng.normal(size=(2, 2)).astype(np.float32)}
    frozen = {"a": False, "b": False, "z_frozen": True}
    spe = 2
    tx = jstate.make_optimizer(jcfg, frozen, steps_per_epoch=spe)
    update = jax.jit(tx.update)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: _t(v.copy()) for k, v in params.items()}
    opt = Optimizer(cfg, [tp["a"], tp["b"]], steps_per_epoch=spe)
    for step in range(4):
        if case.get("lr_schedule") == "plateau" and step == 2:
            state = jstate.set_learning_rate(state, 3e-3)
            opt.set_learning_rate(3e-3)
        grads = {k: (2 * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in params.items()}
        updates, state = update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        opt.step([_t(grads["a"]), _t(grads["b"])])
        for k in ("a", "b"):
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL6)
    assert np.array_equal(np.asarray(jp["z_frozen"]), params["z_frozen"])
    if cfg.optimizer in ("Adam", "AdamW"):
        assert opt.mu[0].dtype == getattr(torch, cfg.adam_mu_dtype)


def test_optimizer_schedules_need_steps_per_epoch():
    with pytest.raises(ValueError, match="steps_per_epoch"):
        Optimizer(Config(device="cpu", lr_schedule="cosine"), [])


# ------------------------------------------------- reverse_grad, dropout


def test_reverse_grad_matches_jax_grad():
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(4, 3)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jfn.reverse_grad(v, 0.7) * jnp.asarray(w)))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = pfn.reverse_grad(xt, 0.7)
    (g,) = torch.autograd.grad((y * _t(w)).sum(), [xt])
    torch.testing.assert_close(y.detach(), _t(x), rtol=0, atol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL6)


def test_dropout_keep_rate_scaling_and_seed():
    """Inverted dropout: each element kept with probability 1 - rate (within
    5 standard deviations over 2e5 draws) and scaled by 1 / (1 - rate); the
    same generator seed gives the same mask; off unless training."""
    rate, n = 0.3, 200_000
    x = torch.ones(n)
    y = dropout(x, rate, True, torch.Generator().manual_seed(5))
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n)
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - rate)))
    y2 = dropout(x, rate, True, torch.Generator().manual_seed(5))
    assert torch.equal(y, y2)
    assert not torch.equal(y, dropout(x, rate, True, torch.Generator().manual_seed(6)))
    assert dropout(x, rate, False) is x and dropout(x, 0.0, True) is x
    assert dropout(x.bfloat16(), rate, True, torch.Generator()).dtype == torch.bfloat16


def test_misa_dropout_follows_the_module_mode():
    cfg = Config(device="cpu", use_bert=True, **SMALL)
    model = MISA(cfg, bert_cfg=BertConfig.tiny())
    model.reset_parameters(torch.Generator().manual_seed(0))
    batch = _port_batch(_batch_arrays(seed=1))
    with torch.no_grad():
        e1, e2 = model.eval()(batch).scores, model(batch).scores
        t1 = model.train()(batch, generator=torch.Generator().manual_seed(1)).scores
        t2 = model(batch, generator=torch.Generator().manual_seed(1)).scores
        t3 = model(batch, generator=torch.Generator().manual_seed(2)).scores
    assert torch.equal(e1, e2) and torch.equal(t1, t2)
    assert not torch.equal(e1, t1) and not torch.equal(t1, t3)


def test_train_step_grad_norm_before_clip_and_ema():
    """grad_norm is the norm of the trainable gradients before the value
    clip (a clip of 1e-3 would shrink it far below); the EMA shadow moves
    to decay * shadow + (1 - decay) * params after the update."""
    cfg = Config(device="cpu", use_bert=False, clip=1e-3, ema_decay=0.9,
                 missing_modality_prob=0.5, **SMALL)
    model = MISA(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    ema = [p.detach().clone() for p in params]
    batch = _port_batch(_batch_arrays(seed=3))

    gen = torch.Generator().manual_seed(0)          # the draws train_step makes
    keep = sample_modality_keep(cfg, 6, "cpu", gen)
    model.train()
    _, grads = loss_and_grads(model, batch, cfg, params, keep, None, gen)
    want_norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()

    out = train_step(model, Optimizer(cfg, params), batch, cfg,
                     torch.Generator().manual_seed(0), ema)
    assert out["grad_norm"].item() == pytest.approx(want_norm, rel=1e-5)
    assert want_norm > 1.0
    assert set(out) == {"total", "cls", "diff", "sim", "recon", "conf", "moe",
                        "moe_drop", "model_aux", "grad_norm"}
    for p, b, e in zip(params, before, ema):
        torch.testing.assert_close(e, 0.9 * b + 0.1 * p.detach())


def test_sample_modality_keep_keeps_text():
    cfg = Config(device="cpu", missing_modality_prob=0.5, missing_modality="acoustic")
    keep = sample_modality_keep(cfg, 4000, "cpu", torch.Generator().manual_seed(0))
    assert torch.all(keep[:, 0] == 1) and torch.all(keep[:, 2] == 0)
    assert abs(keep[:, 1].mean().item() - 0.5) < 0.05
    assert sample_modality_keep(Config(device="cpu"), 4, "cpu") is None
    ema = [torch.zeros(2)]
    ema_update(ema, [torch.ones(2)], 0.75)
    torch.testing.assert_close(ema[0], torch.full((2,), 0.25))
