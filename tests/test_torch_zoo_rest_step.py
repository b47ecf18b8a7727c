"""One training step of MULT, MAG_BERT and MMIM against `jax.grad` on the
CPU, over the cases of tests/test_torch_zoo_rest.py: the objective (with
MMIM's `model_aux` in `total`) and the gradient of every trainable
parameter, dropout off, f32, the mosei freeze rule (a tiny BERT's two
encoder layers frozen), JAX's weights carried across by `convert.py`.
`jax.grad` runs op by op: f32 1e-4, and 1e-3 with a tiny BERT, whose table
gradients f32 carries that far from a float64 evaluation
(tests/test_torch_zoo.py).  MAG_BERT's gate gets non-zero gradients through
the frozen layers after it.
"""

import numpy as np
import pytest
import torch
import jax

from mmda_tpu.models import bert as jbert
from mmda_tpu.train import objective as jobjective
from mmda_tpu_torch.convert import jax_name
from mmda_tpu_torch.models.bert import freeze_layers
from mmda_tpu_torch.train.step import loss_and_grads
from test_torch_zoo import _close, _port_batch
from test_torch_zoo_rest import CASES, _arrays, _case_id, _jbatch, _setup

torch.set_num_threads(1)


def _jgrads(jcfg, fwd, tree, jbert_cfg, arrays, use_bert):
    frozen = jax.tree_util.tree_map(lambda _: False, tree)
    if use_bert:
        frozen["bert"] = jbert.frozen_mask(tree["bert"], max_frozen_layer=8)
    jbatch = _jbatch(arrays)

    def loss_fn(p):
        p = jax.tree_util.tree_map(lambda x, f: jax.lax.stop_gradient(x) if f else x, p,
                                   frozen)
        losses = jobjective.compute_losses(
            jcfg, fwd(p, jcfg, jbatch, bert_cfg=jbert_cfg, deterministic=True), jbatch)
        return losses["total"], losses

    return jax.grad(loss_fn, has_aux=True)(tree)          # op by op (module docstring)


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_step_gradients_match_jax_grad(case):
    """jax.grad of compute_losses(forward(_stop_frozen(p))) against the
    port's loss_and_grads over its trainable parameters, dropout off."""
    family, use_bert, extra, aligned = case
    jcfg, cfg, jbert_cfg, tree, fwd, model = _setup(family, use_bert, extra, seed=5,
                                                    compute_dtype="float32")
    arrays = _arrays(aligned, seed=2)
    jgrads, jlosses = _jgrads(jcfg, fwd, tree, jbert_cfg, arrays, use_bert)
    if use_bert:
        freeze_layers(model.bert, 8)
    model.eval()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    losses, grads = loss_and_grads(model, _port_batch(arrays), cfg, [p for _, p in named])
    assert set(losses) == set(jlosses)
    for k in losses:
        _close(losses[k], jlosses[k], 1e-4, k)
    aux = float(losses["model_aux"].detach())
    if family == "MMIM":
        assert aux > 0.0
        want_total = float(losses["cls"].detach()) + aux   # no conf term: use_confidNet off
        np.testing.assert_allclose(float(losses["total"]), want_total, rtol=1e-6)
    else:
        assert aux == 0.0
    tol = 1e-3 if use_bert else 1e-4
    for (name, _), g in zip(named, grads):
        path = jax_name(model, name)
        want = np.asarray(_leaf(jgrads, path), np.float32)
        got = to_jax_tree_value(g, path)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=path)
        if family == "MAG_BERT" and name.startswith("mag.") and extra["mag_inject_layer"] < 2:
            # through the frozen layers after the gate; after the last layer
            # only [CLS] is read, where the token grid is zero, so W_v and
            # W_a get none
            assert np.abs(got).max() > 0.0, name


def to_jax_tree_value(g, path):
    """A port gradient in the JAX leaf's layout."""
    got = g.float()
    if path.endswith(".kernel"):
        got = got.permute(*reversed(range(got.dim())))
    return got.numpy()


@pytest.mark.parametrize("family,use_bert", [("MULT", True), ("MMIM", False)])
def test_regression_step_matches_jax_grad(family, use_bert):
    jcfg, cfg, jbert_cfg, tree, fwd, model = _setup(family, use_bert, {}, seed=6,
                                                    compute_dtype="float32",
                                                    task="regression", num_classes=1)
    arrays = _arrays(seed=3)
    jgrads, jlosses = _jgrads(jcfg, fwd, tree, jbert_cfg, arrays, use_bert)
    if use_bert:
        freeze_layers(model.bert, 8)
    model.eval()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    losses, grads = loss_and_grads(model, _port_batch(arrays), cfg, [p for _, p in named])
    for k in losses:
        _close(losses[k], jlosses[k], 1e-4, k)
    tol = 1e-3 if use_bert else 1e-4
    for (name, _), g in zip(named, grads):
        path = jax_name(model, name)
        np.testing.assert_allclose(to_jax_tree_value(g, path),
                                   np.asarray(_leaf(jgrads, path), np.float32),
                                   rtol=tol, atol=tol, err_msg=path)
