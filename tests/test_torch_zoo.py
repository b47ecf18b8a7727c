"""The port's first four zoo families (EF_LSTM, LF_DNN, LMF, TFN; with the
pooled encoders of models/pooled.py) against the JAX package on the CPU:

* the deterministic forward on JAX-initialised weights carried across by
  `convert.py`, every family with a GloVe text tower and the pooled ones
  with a tiny BERT too, EF_LSTM with LSTM and GRU cells, with and without
  `modality_keep`: f32 1e-4 abs/rel (summation orders), bf16 2e-2;
* one step's objective and gradients, dropout off (mosei freeze rule under
  BERT), against `jax.grad` run op by op: f32 1e-4, and 1e-3 for a pooled
  family's tiny BERT, whose word-table gradient f32 itself carries to 9e-4
  of a float64 evaluation of the same model (both packages' op-by-op
  gradients lie that close to it; XLA's jitted CPU gradient lies 0.08 away,
  so it is not the yardstick);
* the `Predictor` over ragged requests against the JAX `Predictor` on the
  same weights (1e-4), as tests/test_zoo_serving_matrix.py runs the zoo;
* a `Trainer` epoch whose best-on-dev export loads in the JAX package's
  `load_checkpoint`, leaf for leaf, and round-trips through `convert.py`.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import get_model as jget_model
from mmda_tpu.models import misa as jmisa
from mmda_tpu.serving import Predictor as JPredictor
from mmda_tpu.train import checkpoint as jckpt
from mmda_tpu.train import objective as jobjective
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import convert_params, jax_name, load_jax_params, to_jax_tree
from mmda_tpu_torch.data import synthetic as psynth
from mmda_tpu_torch.models import Batch, get_model
from mmda_tpu_torch.models.bert import BertConfig, freeze_layers
from mmda_tpu_torch.serving import Predictor
from mmda_tpu_torch.train import checkpoint as pckpt
from mmda_tpu_torch.train.loop import Trainer
from mmda_tpu_torch.train.step import loss_and_grads

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

SIZES = dict(visual_size=5, acoustic_size=7, vocab_size=40)
SMALL = dict(hidden_size=16, embedding_size=6, num_classes=6, lmf_rank=3, tfn_post_dim=4,
             **SIZES)
FAMILIES = ["EF_LSTM", "LF_DNN", "LMF", "TFN"]
POOLED = ["LF_DNN", "LMF", "TFN"]
# (family, use_bert): EF_LSTM is GloVe-only
CASES = [("EF_LSTM", False)] + [(f, b) for f in POOLED for b in (False, True)]


def _batch(B=4, T=6, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, 1, 3, 5][:B], np.int32)
    S = T + 2
    bert_mask = (np.arange(S)[None, :] < (lengths + 2)[:, None]).astype(np.int32)
    return dict(
        text=rng.integers(0, 40, size=(B, T)).astype(np.int32),
        visual=rng.normal(size=(B, T, 5)).astype(np.float32),
        acoustic=rng.normal(size=(B, T, 7)).astype(np.float32),
        lengths=lengths,
        bert_ids=(rng.integers(0, 128, size=(B, S)) * bert_mask).astype(np.int32),
        bert_type=np.zeros((B, S), np.int32),
        bert_mask=bert_mask,
        sentiment=rng.normal(size=B).astype(np.float32),
        emo_label=(rng.random((B, 6)) < 0.4).astype(np.float32),
        sample_weight=np.ones(B, np.float32),
    )


def _port_batch(arrays):
    batch = Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    return batch._replace(**{k: getattr(batch, k).long()
                             for k in ("text", "bert_ids", "bert_type")})


def _setup(family, use_bert, dtype="float32", seed=0, **extra):
    kw = dict(model=family, use_bert=use_bert, compute_dtype=dtype, data="mosei",
              **SMALL, **extra)
    jcfg = JConfig(use_pallas=False, **kw)
    cfg = Config(device="cpu", **kw)
    jbert_cfg = jbert.BertConfig.tiny() if use_bert else None
    init_fn, fwd = jget_model(family)
    tree = init_fn(jax.random.PRNGKey(seed), jcfg, bert_cfg=jbert_cfg)
    model = load_jax_params(
        get_model(family)(cfg, bert_cfg=BertConfig.tiny() if use_bert else None), tree)
    return jcfg, cfg, jbert_cfg, tree, fwd, model


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("family,use_bert", CASES)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("keep", [None, [[1, 1, 1], [1, 0, 1], [0, 1, 0], [1, 1, 0]]],
                         ids=["all", "keep"])
def test_forward_matches_jax(family, use_bert, dtype, tol, keep):
    jcfg, cfg, jbert_cfg, tree, fwd, model = _setup(family, use_bert, dtype)
    arrays = _batch(seed=1)
    mk = None if keep is None else np.asarray(keep, np.float32)
    want = fwd(tree, jcfg, jmisa.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
               bert_cfg=jbert_cfg, deterministic=True,
               modality_keep=None if mk is None else jnp.asarray(mk))
    with torch.no_grad():
        got = model.eval()(_port_batch(arrays), None if mk is None else torch.from_numpy(mk))
    for k in ("scores", "labels", "tcp"):
        if k == "labels":       # a score within tol of the threshold may binarize the other way
            near = np.abs(np.asarray(want.scores, np.float32) - cfg.threshold) < tol
            np.testing.assert_array_equal(got.labels.float().numpy()[~near],
                                          np.asarray(want.labels, np.float32)[~near])
            continue
        _close(getattr(got, k), getattr(want, k), tol, k)
    assert got.shared_t is None and want.shared_t is None


def test_ef_lstm_gru_cell_matches_jax():
    jcfg, cfg, jbert_cfg, tree, fwd, model = _setup("EF_LSTM", False, rnncell="gru")
    arrays = _batch(seed=3)
    want = fwd(tree, jcfg, jmisa.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
               deterministic=True)
    with torch.no_grad():
        got = model.eval()(_port_batch(arrays))
    _close(got.scores, want.scores, 1e-4, "scores")
    _close(got.tcp, want.tcp, 1e-4, "tcp")


def test_ef_lstm_refuses_bert_and_unaligned_streams():
    with pytest.raises(ValueError, match="use_bert False"):
        get_model("EF_LSTM")(Config(device="cpu", model="EF_LSTM", use_bert=True, **SMALL))
    model = get_model("EF_LSTM")(Config(device="cpu", model="EF_LSTM", use_bert=False,
                                        **SMALL))
    model.reset_parameters(torch.Generator().manual_seed(0))
    arrays = _batch()
    arrays["visual"] = arrays["visual"][:, :4]
    with pytest.raises(ValueError, match="word-aligned"):
        model.eval()(_port_batch(arrays))


@pytest.mark.parametrize("family,use_bert", CASES)
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_step_gradients_match_jax_grad(family, use_bert, task):
    """jax.grad of compute_losses(forward(_stop_frozen(p))) against the
    port's loss_and_grads over its trainable parameters, dropout off; diff,
    sim and recon are 0 in both (no shared/private factorization)."""
    extra = {} if task == "classification" else dict(task="regression", num_classes=1)
    kw = {**SMALL, **extra}
    jcfg = JConfig(use_pallas=False, model=family, use_bert=use_bert, data="mosei", **kw)
    cfg = Config(device="cpu", model=family, use_bert=use_bert, data="mosei", **kw)
    jbert_cfg = jbert.BertConfig.tiny() if use_bert else None
    init_fn, fwd = jget_model(family)
    tree = init_fn(jax.random.PRNGKey(5), jcfg, bert_cfg=jbert_cfg)
    frozen = jax.tree_util.tree_map(lambda _: False, tree)
    if use_bert:
        frozen["bert"] = jbert.frozen_mask(tree["bert"], max_frozen_layer=8)
    arrays = _batch(seed=2)
    jbatch = jmisa.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})

    def loss_fn(p):
        p = jax.tree_util.tree_map(lambda x, f: jax.lax.stop_gradient(x) if f else x, p, frozen)
        losses = jobjective.compute_losses(
            jcfg, fwd(p, jcfg, jbatch, bert_cfg=jbert_cfg, deterministic=True), jbatch)
        return losses["total"], losses

    jgrads, jlosses = jax.grad(loss_fn, has_aux=True)(tree)        # op by op (docstring)
    model = load_jax_params(
        get_model(family)(cfg, bert_cfg=BertConfig.tiny() if use_bert else None), tree)
    if use_bert:
        freeze_layers(model.bert, 8)
    model.eval()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    losses, grads = loss_and_grads(model, _port_batch(arrays), cfg, [p for _, p in named])
    for k in ("diff", "sim", "recon"):
        assert float(losses[k]) == 0.0 and float(jlosses[k]) == 0.0, k
    tol = 1e-3 if use_bert else 1e-4
    for k in losses:
        _close(losses[k], jlosses[k], 1e-4, k)
    for (name, _), g in zip(named, grads):
        path = jax_name(model, name)
        want = jgrads
        for part in path.split("."):
            want = want[int(part)] if isinstance(want, list) else want[part]
        got = g.float().numpy()
        if path.endswith(".kernel"):
            got = got.T
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol,
                                   err_msg=path)


def _req(rng, L, bert):
    r = {"text": rng.integers(2, 40, size=L).astype(np.int32),
         "visual": rng.normal(size=(L, 5)).astype(np.float32),
         "acoustic": rng.normal(size=(L, 7)).astype(np.float32)}
    if bert:
        r.update({"bert_ids": rng.integers(3, 64, size=L + 2).astype(np.int32),
                  "bert_type": np.zeros(L + 2, np.int32),
                  "bert_mask": np.ones(L + 2, np.int32)})
    return r


@pytest.mark.parametrize("family,use_bert", CASES)
def test_predictor_matches_jax_predictor(family, use_bert):
    """Ragged requests through both Predictors on the same weights: scores,
    labels, tcp and the hidden output (the scores, for these families)."""
    kw = dict(model=family, use_bert=use_bert, compute_dtype="float32", bucket_sizes=(4, 8),
              max_seq_len=8, data="synthetic", **SMALL)
    jbert_cfg = jbert.BertConfig.tiny(vocab_size=64) if use_bert else None
    init_fn, _ = jget_model(family)
    tree = init_fn(jax.random.PRNGKey(0), JConfig(**kw), bert_cfg=jbert_cfg)
    want_pred = JPredictor(JConfig(**kw), params=tree, bert_cfg=jbert_cfg, max_batch=8)
    got_pred = Predictor(Config(device="cpu", **kw), params=tree,
                         bert_cfg=BertConfig.tiny(vocab_size=64) if use_bert else None,
                         max_batch=8)
    rng = np.random.default_rng(11)
    reqs = [_req(rng, L, use_bert) for L in (3, 7, 1)]
    want, got = want_pred(reqs), got_pred(reqs)
    for k in ("scores", "tcp", "hidden"):
        assert got[k].shape == np.asarray(want[k]).shape == (3, 6), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert np.isfinite(got["scores"]).all()


@pytest.mark.parametrize("family,use_bert", [("EF_LSTM", False), ("LF_DNN", True),
                                             ("LMF", False), ("TFN", True)])
def test_trainer_epoch_export_loads_in_jax(tmp_path, family, use_bert):
    cfg = Config(device="cpu", model=family, use_bert=use_bert, data="mosei", hidden_size=16,
                 embedding_size=8, lmf_rank=3, tfn_post_dim=4, batch_size=32, max_seq_len=8,
                 bucket_sizes=(8,), n_epoch=1, learning_rate=1e-3, ckpt_dir=str(tmp_path),
                 name="zoo", seed=1)
    data = psynth.make_dataset(96, 32, 32, max_len=8, seed=0, bert_vocab_size=128)
    bert_cfg = BertConfig.tiny() if use_bert else None
    trainer = Trainer(cfg, data, bert_cfg=bert_cfg)
    summary = trainer.train()
    assert np.isfinite(summary["test_loss"])
    assert summary["history"][0]["train_diff"] == 0.0
    name = pckpt.best_model_name(cfg)
    tree = pckpt.load_checkpoint(str(tmp_path), name)
    init_fn, _ = jget_model(family)
    jcfg = JConfig(model=family, use_bert=use_bert, data="mosei", hidden_size=16,
                   embedding_size=8, lmf_rank=3, tfn_post_dim=4)
    template = init_fn(jax.random.PRNGKey(0), jcfg,
                       bert_cfg=jbert.BertConfig.tiny() if use_bert else None,
                       **trainer.sizes)
    loaded = jckpt.load_checkpoint(str(tmp_path), name, template)
    want = to_jax_tree(trainer.model)
    flat = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert len(flat) == len(list(trainer.model.parameters()))
    for path, leaf in flat:
        node = want
        for k in path:
            key = getattr(k, "key", getattr(k, "idx", k))
            node = node[str(key)] if isinstance(node, dict) else node[key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf), err_msg=str(path))
    # the export carries back into a fresh model of the family
    fresh = get_model(family)(cfg, bert_cfg=bert_cfg, **trainer.sizes)
    state = convert_params(tree, fresh)
    for n, p in trainer.model.named_parameters():
        torch.testing.assert_close(state[n], p.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("family", ["MISA", "EF_LSTM", "LF_DNN"])
def test_word_ids_beyond_the_table_read_as_in_jax(family):
    """A GloVe id past the table's end (a dev word beyond a table sized from
    the train split) reads the last row, as the JAX package's gather clamps
    it, where the port's lookup used to raise IndexError."""
    if family == "MISA":
        from mmda_tpu.models.misa import init_misa_params, misa_forward
        from mmda_tpu_torch.models import MISA
        kw = dict(use_bert=False, data="mosei", **SMALL)
        jcfg, cfg = JConfig(use_pallas=False, **kw), Config(device="cpu", **kw)
        tree, fwd = init_misa_params(jax.random.PRNGKey(2), jcfg), misa_forward
        model = load_jax_params(MISA(cfg), tree)
    else:
        jcfg, cfg, _, tree, fwd, model = _setup(family, False, seed=2)
    arrays = _batch(seed=4)
    arrays["text"][0, :3] = [40, 41, 1000]          # the table has 40 rows
    want = fwd(tree, jcfg, jmisa.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
               deterministic=True)
    with torch.no_grad():
        got = model.eval()(_port_batch(arrays))
    _close(got.scores, want.scores, 1e-4, "scores")
    _close(got.tcp, want.tcp, 1e-4, "tcp")
