"""The port's GRU and transformer towers (mmda_tpu_torch/models/bilstm.py,
extractors.py) and the models built on them, against the JAX package on
weights carried across by `mmda_tpu_torch.convert`: `birnn`,
`extract_features`, both tower kinds, the MISA forward, one training step's
gradients, and the CLIs with the GRU options (the trainer with them:
tests/test_torch_trainer.py).

On the CPU the port's GRU recurrence is the kernel's plain version.  Inputs
are made with numpy from seeds and handed to both packages.  f32 tolerance
1e-5 abs/rel for the towers (summation order only), 1e-4 with bf16 inputs
(both sides round the same inputs to bf16, then compute in f32), 1e-4 for
the whole model and its step gradients (as tests/test_torch_train.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import bilstm as jbilstm
from mmda_tpu.models import misa as jmisa
from mmda_tpu.models.extractors import make_tower_params, tower_extract
from mmda_tpu.train import objective as jobjective
from mmda_tpu.train.step import _stop_frozen

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import jax_name, load_jax_params, to_jax_tree
from mmda_tpu_torch.models import MISA, Batch, bilstm
from mmda_tpu_torch.models.bert import BertConfig, freeze_layers
from mmda_tpu_torch.models.extractors import (TransformerExtractor, make_tower,
                                              tower_extract as t_tower_extract)
from mmda_tpu_torch.ops.kernels import gru as kgru
from mmda_tpu_torch.serving import Predictor
from mmda_tpu_torch.train.step import loss_and_grads

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)


def _data(B, T, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = T, 1
    return x, lengths


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


def _assert_same_tree(jax_tree, port_tree):
    """Leaf for leaf; a module list comes back from `to_jax_tree` keyed '0',
    '1', ..., which `_leaf` reads like list indices."""
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(port_tree, is_leaf=torch.is_tensor))
    for path, leaf in flat:
        keys = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        got = _leaf(port_tree, keys)
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=keys)


# ------------------------------------------------------------------ towers


@pytest.mark.parametrize("B,T,F,H", [(5, 7, 6, 4), (3, 4, 9, 9)])
def test_gru_birnn_matches_jax(B, T, F, H):
    tree = jbilstm.rnn_params(jax.random.PRNGKey(B + F), F, H, "gru")
    x, lengths = _data(B, T, F, seed=B)
    ys_j, h_j = jbilstm.birnn(tree, jnp.asarray(x), jnp.asarray(lengths), "gru",
                              training=False)
    p = load_jax_params(bilstm.BiLSTM(F, H, cell="gru"), tree)
    with torch.no_grad():
        ys_t, h_t = bilstm.birnn(p, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-5, atol=1e-5)
    mask = np.arange(T)[None, :] < lengths[:, None]
    assert np.all(ys_t.numpy()[~mask] == 0.0)      # pads are zero


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_gru_extract_features_matches_jax(dtype, tol):
    B, T, F = 6, 8, 5
    tree = jbilstm.extractor_params(jax.random.PRNGKey(3), F, F, "gru")
    x, lengths = _data(B, T, F, seed=7)
    want = jbilstm.extract_features(tree, jnp.asarray(x).astype(dtype),
                                    jnp.asarray(lengths), "gru", training=False)
    p = load_jax_params(bilstm.LSTMExtractor(F, F, cell="gru"), tree)
    with torch.no_grad():
        got = bilstm.extract_features(p, torch.from_numpy(x).to(getattr(torch, dtype)),
                                      torch.from_numpy(lengths))
    assert got.shape == (B, 4 * F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("option", [dict(rnncell="gru"), dict(extractor="transformer")],
                         ids=["gru", "transformer"])
def test_tower_kinds_match_jax_and_convert_both_ways(option):
    """make_tower / tower_extract for the GRU and the transformer tower; the
    converted parameters go back to the same JAX tree (`to_jax_tree`): the
    GRU's 3H leaves under rnn1/rnn2.{fwd,bwd}, the transformer's `pos` leaf
    and `layers` list."""
    F = 7
    jcfg = JConfig(hidden_size=16, compute_dtype="float32", use_pallas=False, **option)
    cfg = Config(hidden_size=16, compute_dtype="float32", device="cpu", **option)
    tree = make_tower_params(jax.random.PRNGKey(9), jcfg, F)
    x, lengths = _data(4, 6, F, seed=9)
    want = tower_extract(tree, jcfg, jnp.asarray(x), jnp.asarray(lengths), training=False)
    tower = load_jax_params(make_tower(cfg, F), tree)
    with torch.no_grad():
        got = t_tower_extract(tower, torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape == (4, 4 * F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    _assert_same_tree(tree, to_jax_tree(tower))
    if "rnncell" in option:
        assert tower.rnn1.fwd.w_hh.shape == (3 * F, F) and tower.rnn2.bwd.b_hh.shape == (3 * F,)
    else:
        assert isinstance(tower, TransformerExtractor) and tower.pos.shape == (512, 4 * F)


def test_tower_reset_parameters_draws_every_leaf():
    gen = torch.Generator().manual_seed(0)
    for tower in (make_tower(Config(device="cpu", rnncell="gru"), 5),
                  make_tower(Config(device="cpu", extractor="transformer"), 5)):
        tower.reset_parameters(gen)
        for name, p in tower.named_parameters():
            assert torch.isfinite(p).all(), name
    t = make_tower(Config(device="cpu", extractor="transformer"), 5)
    t.reset_parameters(torch.Generator().manual_seed(1))
    assert 0.015 < t.pos.std().item() < 0.025 and t.layers[0].ffn1.weight.shape == (40, 20)


def test_gru_recurrence_argument_reaches_every_direction():
    calls = []

    def spy(x_proj, w_hh_t, b_hh, mask, reverse):
        calls.append((reverse, tuple(b_hh.shape)))
        return kgru.gru_recurrence_reference(x_proj, w_hh_t, b_hh, mask, reverse)

    tower = bilstm.LSTMExtractor(3, 3, cell="gru")
    tower.reset_parameters(torch.Generator().manual_seed(0))
    x, lengths = _data(2, 4, 3, seed=1)
    with torch.no_grad():
        tower(torch.from_numpy(x), torch.from_numpy(lengths), spy)
    assert calls == [(False, (9,)), (True, (9,))] * 2


# ------------------------------------------------------- model and step

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
    batch = Batch(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()})
    return batch._replace(**{k: getattr(batch, k).long()
                             for k in ("text", "bert_ids", "bert_type")})


@pytest.mark.parametrize("use_bert,option", [
    (True, dict(rnncell="gru")), (False, dict(rnncell="gru")),
    (False, dict(extractor="transformer"))], ids=["bert-gru", "glove-gru", "glove-transformer"])
def test_misa_forward_matches_jax(use_bert, option):
    kw = dict(use_bert=use_bert, compute_dtype="float32", **SMALL, **option)
    jcfg, cfg = JConfig(use_pallas=False, **kw), Config(device="cpu", **kw)
    jbert_cfg = jbert.BertConfig.tiny() if use_bert else None
    tree = jmisa.init_misa_params(jax.random.PRNGKey(2), jcfg, bert_cfg=jbert_cfg)
    arrays = _batch_arrays(seed=5)
    want = jmisa.misa_forward(tree, jcfg, jmisa.Batch(**{k: jnp.asarray(v)
                                                         for k, v in arrays.items()}),
                              bert_cfg=jbert_cfg, deterministic=True)
    model = load_jax_params(MISA(cfg, bert_cfg=BertConfig.tiny() if use_bert else None), tree)
    with torch.no_grad():
        got = model.eval()(_port_batch(arrays))
    for name in ("scores", "tcp", "orig_v", "orig_a", "orig_t", "shared_t", "recon_a", "sp_s"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    _assert_same_tree(tree, to_jax_tree(model))


@pytest.mark.parametrize("use_bert", [True, False], ids=["bert", "glove"])
def test_gru_step_gradients_match_jax_grad(use_bert):
    """One training step's objective and gradients with rnncell=gru, dropout
    off, under the mosei freeze rule: jax.grad of
    compute_losses(misa_forward(_stop_frozen(p))) against the port's
    loss_and_grads over its trainable parameters (the towers' gradients go
    through GRURecurrence: forward, then the BPTT wrapper)."""
    kw = dict(use_bert=use_bert, compute_dtype="float32", data="mosei", rnncell="gru", **SMALL)
    jcfg, cfg = JConfig(use_pallas=False, **kw), Config(device="cpu", **kw)
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
    kgru.reset_launch_count()
    losses, grads = loss_and_grads(model, _port_batch(arrays), cfg, [p for _, p in named])
    for k in losses:
        np.testing.assert_allclose(losses[k].detach().float().numpy(),
                                   np.asarray(jlosses[k], np.float32), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    seen_b_hh = 0
    for (name, _), g in zip(named, grads):
        path = jax_name(model, name)
        want = np.asarray(_leaf(jgrads, path), np.float32)
        got = g.float().numpy().T if path.endswith(".kernel") else g.float().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=path)
        if path.endswith(".b_hh"):
            seen_b_hh += 1
            assert np.abs(want).sum() > 0, path
    assert seen_b_hh == (8 if use_bert else 12)     # 2 or 3 towers x 2 layers x 2 directions


# --------------------------------------------------------- CLI and serving


def test_train_and_serve_clis_accept_the_gru_options(tmp_path):
    """`cli.train --rnncell gru --fused_ln_dropout True` on the CPU, then
    the serving CLI's config parser and a Predictor on the export."""
    from mmda_tpu_torch.cli import train as cli_train
    from mmda_tpu_torch.config import get_config

    args = ["--device", "cpu", "--data", "synthetic", "--use_bert", "False", "--rnncell", "gru",
            "--fused_ln_dropout", "True", "--hidden_size", "16", "--embedding_size", "8",
            "--max_seq_len", "8", "--batch_size", "64", "--bucket_sizes", "8",
            "--n_epoch", "1", "--ckpt_dir", str(tmp_path), "--name", "cli"]
    summary = cli_train.main(args)
    assert summary["best_epoch"] == 0 and np.isfinite(summary["test_loss"])
    cfg = get_config(argv=args)
    assert cfg.rnncell == "gru" and cfg.fused_ln_dropout
    pred = Predictor(cfg, visual_size=35, acoustic_size=74, vocab_size=2048, max_batch=4)
    assert pred.model.visual_extractor.rnn1.fwd.cell == "gru"
    rng = np.random.default_rng(0)
    reqs = [{"text": rng.integers(2, 2048, size=L).astype(np.int32),
             "visual": rng.normal(size=(L, 35)).astype(np.float32),
             "acoustic": rng.normal(size=(L, 74)).astype(np.float32)} for L in (3, 8)]
    out = pred(reqs)
    assert np.isfinite(out["scores"]).all() and out["scores"].shape == (2, 6)
    want = pred(reqs, recurrence=kgru.gru_recurrence_reference)
    np.testing.assert_allclose(out["scores"], want["scores"], rtol=1e-6, atol=1e-6)
