"""The port's trainer and what surrounds it, against the JAX package on the
CPU at small sizes: the synthetic data and the loader (the same arrays and
batches for a seed), the numpy metrics against the scikit-learn-based JAX
ones, the metric logger, the trainer (its loss falls, frozen layers stay,
its best-on-dev export loads in both packages), the options it refuses
and the ones it no longer does (GRU and transformer towers, the fused
LayerNorm sites), the training CLI, and the parameter conversion's round trip.

Exact equality where both packages compute the same numpy arithmetic
(data, loader, checkpoint leaves); 1e-12 for the metrics (float64 on both
sides, other summation orders).
"""

import json
import time

import numpy as np
import pytest
import torch
import jax

from mmda_tpu.config import Config as JConfig
from mmda_tpu.data import loader as jloader
from mmda_tpu.data import synthetic as jsynth
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import misa as jmisa
from mmda_tpu.train import checkpoint as jckpt
from mmda_tpu.utils import metrics as jmetrics
from mmda_tpu.utils import sentiment_metrics as jsenti

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import load_jax_params, to_jax_tree
from mmda_tpu_torch.data import loader as ploader
from mmda_tpu_torch.data import synthetic as psynth
from mmda_tpu_torch.models import MISA, Batch
from mmda_tpu_torch.models.bert import BertConfig
from mmda_tpu_torch.train import checkpoint as pckpt
from mmda_tpu_torch.train.loop import Trainer
from mmda_tpu_torch.utils import metrics as pmetrics
from mmda_tpu_torch.utils import sentiment_metrics as psenti
from mmda_tpu_torch.utils.logging import MetricLogger

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

SMALL = dict(hidden_size=16, embedding_size=6, num_classes=6, visual_size=5,
             acoustic_size=7, vocab_size=40)


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


# ----------------------------------------------------------- data, loader


@pytest.mark.parametrize("aligned", [True, False])
def test_synthetic_split_matches_jax(aligned):
    spec = dict(num_examples=40, max_len=12, seed=7, aligned=aligned)
    got = psynth.make_split(psynth.SyntheticSpec(**spec))
    want = jsynth.make_split(jsynth.SyntheticSpec(**spec))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    d_got, d_want = psynth.make_dataset(20, 8, 8, max_len=8), jsynth.make_dataset(20, 8, 8, max_len=8)
    for split in ("train", "dev", "test"):
        for k in d_want[split]:
            np.testing.assert_array_equal(d_got[split][k], d_want[split][k])


@pytest.mark.parametrize("shuffle,drop_last,buckets", [
    (True, True, (4, 8, 12)), (False, False, (4, 8, 12)), (True, False, None)])
def test_loader_batches_match_jax(shuffle, drop_last, buckets):
    """The same batches in the same order, two epochs (the shuffle plan's
    generator carries across), pad rows included."""
    data = jsynth.make_split(jsynth.SyntheticSpec(num_examples=70, max_len=12, seed=3))
    kw = dict(batch_size=16, shuffle=shuffle, drop_last=drop_last, bucket_sizes=buckets,
              seed=11)
    pl, jl = ploader.ArrayLoader(data, **kw), jloader.ArrayLoader(data, **kw)
    assert len(pl) == len(jl)
    for _ in range(2):
        got = list(pl.host_batches())
        want = [{k: a.get(k) for k in jloader.ARRAY_KEYS} for a in jl._host_batches()]
        assert len(got) == len(want) == len(pl)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if w[k] is None:
                    assert g[k] is None, k
                else:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    batch = next(iter(pl))
    assert isinstance(batch, Batch) and batch.text.dtype == torch.int64
    assert batch.visual.dtype == torch.float32 and batch.visual_lengths is None


def test_auto_bucket_sizes_match_jax():
    lengths = np.random.default_rng(0).integers(1, 50, size=300)
    for k in (1, 3, 5):
        assert ploader.auto_bucket_sizes(lengths, k) == jloader.auto_bucket_sizes(lengths, k)


# ------------------------------------------------------------------ metrics


def test_multilabel_metrics_match_sklearn_based_jax():
    rng = np.random.default_rng(0)
    y_true = (rng.uniform(size=(50, 6)) < 0.3).astype(np.float32)
    y_pred = (rng.uniform(size=(50, 6)) < 0.3).astype(np.float32)
    y_true[:, 4] = 0.0
    y_pred[:, 4] = 0.0                     # a label nobody has: zero division
    y_pred[:, 5] = 0.0                     # a label never predicted
    got, want = pmetrics.get_metrics(y_true, y_pred), jmetrics.get_metrics(y_true, y_pred)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12, err_msg=k)
    for mode in ("macro", "micro", "weighted"):
        assert (pmetrics.select_by_eval_mode(got, mode)
                == pytest.approx(jmetrics.select_by_eval_mode(want, mode)))


def test_sentiment_and_binary_metrics_match_sklearn_based_jax():
    rng = np.random.default_rng(1)
    truths = np.round(rng.normal(scale=1.5, size=80), 1)
    truths[:5] = 0.0
    preds = truths + rng.normal(scale=0.8, size=80)
    got, want = psenti.eval_mosei_senti(preds, truths), jsenti.eval_mosei_senti(preds, truths)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12, err_msg=k)
    b_true, b_pred = rng.uniform(size=40) > 0.5, rng.uniform(size=40) > 0.3
    assert psenti.eval_binary(b_pred, b_true) == pytest.approx(jsenti.eval_binary(b_pred, b_true))


def test_metric_logger_sinks(tmp_path, capsys):
    log = MetricLogger(("stdout", "jsonl"), run_name="r", log_dir=str(tmp_path))
    log.log({"loss": torch.tensor(1.234567891), "epoch": 2}, step=3)
    log.close()
    rec = json.loads((tmp_path / "r.jsonl").read_text())
    assert rec["loss"] == pytest.approx(1.234567891) and rec["step"] == 3
    assert "1.23457" in capsys.readouterr().out
    with pytest.raises(ValueError, match="not ported"):
        MetricLogger(("wandb",))


# ------------------------------------------------- trainer and checkpoint


def _assert_same_tree(jax_tree, port_tree):
    """Every leaf of a JAX-layout tree (lists or '0', '1' keys for the BERT
    layers) equals the leaf at the same path of the port's tree."""
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(port_tree, is_leaf=torch.is_tensor))
    for path, leaf in flat:
        keys = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        got = _leaf(port_tree, keys)
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=keys)


def _tiny_data(n_train=96, seed=0, max_len=8):
    return psynth.make_dataset(n_train, 32, 32, max_len=max_len, seed=seed,
                               bert_vocab_size=128)


def _tiny_cfg(tmp_path, **kw):
    base = dict(device="cpu", use_bert=True, data="mosei", hidden_size=16, embedding_size=8,
                batch_size=32,
                max_seq_len=8, bucket_sizes=(8,), n_epoch=3, learning_rate=1e-3,
                ckpt_dir=str(tmp_path), name="t", seed=1)
    return Config(**{**base, **kw})


def test_trainer_loss_falls_and_checkpoint_loads_in_both_packages(tmp_path):
    """A 3-epoch CPU run with a tiny BERT under the mosei freeze rule: the
    train loss falls, frozen layers do not move, the best-on-dev export
    loads in the port (convert round trip) and in the JAX package."""
    cfg = _tiny_cfg(tmp_path)
    bert_cfg = BertConfig.tiny()
    trainer = Trainer(cfg, _tiny_data(), bert_cfg=bert_cfg)
    frozen_before = [p.detach().clone() for p in trainer.model.bert.layers.parameters()]
    assert not any(p.requires_grad for p in trainer.model.bert.layers.parameters())
    summary = trainer.train()
    hist = summary["history"]
    assert len(hist) == 3 and hist[-1]["train_loss"] < hist[0]["train_loss"]
    for p, b in zip(trainer.model.bert.layers.parameters(), frozen_before):
        assert torch.equal(p, b)
    assert np.isfinite(summary["test_loss"]) and "test_f1" in summary

    name = pckpt.best_model_name(cfg)
    best = to_jax_tree(trainer._load_best(name, MISA(cfg, bert_cfg=bert_cfg, **trainer.sizes)))
    jcfg = JConfig(use_bert=True, data="mosei", hidden_size=16, embedding_size=8)
    template = jmisa.init_misa_params(jax.random.PRNGKey(0), jcfg,
                                      bert_cfg=jbert.BertConfig.tiny(), **trainer.sizes)
    _assert_same_tree(jckpt.load_checkpoint(str(tmp_path), name, template), best)
    _assert_same_tree(pckpt.load_checkpoint(str(tmp_path), name), best)


def test_trainer_with_ema_exports_the_shadow(tmp_path):
    cfg = _tiny_cfg(tmp_path, use_bert=False, n_epoch=1, ema_decay=0.5)
    trainer = Trainer(cfg, _tiny_data(seed=2))
    trainer.train()
    shadow = trainer.eval_model()
    tree = pckpt.load_checkpoint(str(tmp_path), pckpt.best_model_name(cfg))
    got = to_jax_tree(shadow)
    np.testing.assert_array_equal(tree["classifier"]["kernel"],
                                  got["classifier"]["kernel"].numpy())
    assert not torch.equal(trainer.ema[0], next(trainer.model.parameters()).detach())


def test_async_export_is_byte_equal_to_a_synchronous_one(tmp_path):
    """save_checkpoint(async_write=True) copies the parameters to the host
    before it returns: a write still running when the parameters change in
    place gives the bytes of a synchronous save taken before the change."""
    cfg = _tiny_cfg(tmp_path, use_bert=False, **SMALL)
    model = MISA(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    meta = {"epoch": 0, "valid_loss": 1.5}
    assert pckpt.save_checkpoint(str(tmp_path / "sync"), "best", model, meta) is None
    thread = pckpt.save_checkpoint(str(tmp_path / "async"), "best", model, meta,
                                   async_write=True)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)                         # the next step
    thread.join(timeout=60)
    assert not thread.is_alive()
    for f in ("best.msgpack", "best.json"):
        assert (tmp_path / "async" / f).read_bytes() == (tmp_path / "sync" / f).read_bytes()


@pytest.mark.parametrize("reload", ["early_stop", "stage2"])
def test_reloads_wait_for_the_export_written_on_a_thread(tmp_path, monkeypatch, reload):
    """The best-on-dev export is written on a thread; with that write slowed
    down, the early-stop reload and ConfidNet stage 2 still load the
    finished file: the epoch-0 parameters, not the later ones."""
    extra = (dict(enable_early_stop=True, patience=0, n_epoch=3) if reload == "early_stop"
             else dict(use_confidNet=True, confid_two_stage=True, n_epoch_stage2=1, n_epoch=2))
    cfg = _tiny_cfg(tmp_path, use_bert=False, **extra)
    trainer = Trainer(cfg, _tiny_data())
    name = pckpt.best_model_name(cfg)
    write = pckpt._atomic_write

    def slow_write(path, chunks):
        if path.endswith(f"{name}.msgpack"):
            time.sleep(0.5)
        write(path, chunks)

    monkeypatch.setattr(pckpt, "_atomic_write", slow_write)
    evaluate, at_best = trainer.evaluate, []

    def rising_dev_loss(mode, model=None):
        loss, *rest = evaluate(mode, model)
        if mode == "dev":
            if not at_best:
                at_best.append([p.detach().clone() for p in trainer.model.parameters()])
            loss += len(at_best) * 10.0 * trainer.step       # epoch 0 is the best
        return (loss, *rest)

    trainer.evaluate = rising_dev_loss
    summary = trainer.train()
    assert summary["best_epoch"] == 0 and trainer._export is None
    for (n, p), want in zip(trainer.model.named_parameters(), at_best[0]):
        if not n.startswith("confidence."):
            assert torch.equal(p.detach(), want), n


@pytest.mark.parametrize("option", [
    dict(dp_size=2), dict(pp_size=2), dict(sp=True), dict(tp_size=2), dict(zero1=True),
    dict(fsdp=True), dict(ckpt_backend="orbax")])
def test_trainer_refuses_what_is_not_ported(tmp_path, option):
    """Each mode not ported names its ROADMAP item; data parallelism
    (dp_size > 1) is ported, and without a process group of as many ranks it
    is refused too, instead of running as one process."""
    cfg = _tiny_cfg(tmp_path, **option)
    with pytest.raises(ValueError, match="process group" if "dp_size" in option else "ROADMAP"):
        Trainer(cfg, _tiny_data())


@pytest.mark.parametrize("option", [
    dict(rnncell="gru"), dict(extractor="transformer"), dict(fused_ln_dropout=True),
    dict(rnncell="gru", fused_ln_dropout=True)],
    ids=["gru", "transformer", "fused_ln", "gru+fused_ln"])
def test_trainer_trains_with_the_towers_and_the_fused_sites(tmp_path, option, monkeypatch):
    """The options the trainer used to refuse: it builds the towers, trains
    (finite, falling loss), and its best-on-dev export loads in the JAX
    package's `load_checkpoint` and in the port's `Predictor`.  With
    fused_ln_dropout every training step goes through the fused function
    twice per BERT layer, and eval through none."""
    from mmda_tpu_torch.models import bert as pbert
    from mmda_tpu_torch.serving import Predictor

    calls = []
    real = pbert.residual_dropout_layernorm
    monkeypatch.setattr(pbert, "residual_dropout_layernorm",
                        lambda *a: (calls.append(a[5]), real(*a))[1])
    cfg = _tiny_cfg(tmp_path, n_epoch=2, **option)
    trainer = Trainer(cfg, _tiny_data(), bert_cfg=BertConfig.tiny())
    assert trainer.bert_cfg.fused_ln_dropout == bool(option.get("fused_ln_dropout"))
    summary = trainer.train()
    hist = summary["history"]
    assert len(hist) == 2 and hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert np.isfinite(summary["test_loss"])
    steps = 2 * 3                                   # 96 rows / 32 per batch, 2 epochs
    assert len(calls) == (steps * 2 * 2 if option.get("fused_ln_dropout") else 0)
    assert all(rate == 0.1 for rate in calls)

    name = pckpt.best_model_name(cfg)
    jcfg = JConfig(use_bert=True, data="mosei", hidden_size=16, embedding_size=8,
                   **{k: v for k, v in option.items() if k != "fused_ln_dropout"})
    template = jmisa.init_misa_params(jax.random.PRNGKey(0), jcfg,
                                      bert_cfg=jbert.BertConfig.tiny(), **trainer.sizes)
    loaded = jckpt.load_checkpoint(str(tmp_path), name, template)
    best = trainer._load_best(name, MISA(cfg, bert_cfg=BertConfig.tiny(), **trainer.sizes))
    _assert_same_tree(loaded, to_jax_tree(best))

    pred = Predictor(cfg, bert_cfg=BertConfig.tiny(), max_batch=4,
                     visual_size=trainer.sizes["visual_size"],
                     acoustic_size=trainer.sizes["acoustic_size"])
    rng = np.random.default_rng(0)
    reqs = [{"text": rng.integers(2, 40, size=L).astype(np.int32),
             "visual": rng.normal(size=(L, trainer.sizes["visual_size"])).astype(np.float32),
             "acoustic": rng.normal(size=(L, trainer.sizes["acoustic_size"])).astype(np.float32),
             "bert_ids": rng.integers(1, 128, size=L + 2).astype(np.int32),
             "bert_type": np.zeros(L + 2, np.int32), "bert_mask": np.ones(L + 2, np.int32)}
            for L in (3, 8)]
    out = pred(reqs)
    assert out["scores"].shape == (2, 6) and np.isfinite(out["scores"]).all()


def test_trainer_trains_with_fused_attention(tmp_path, monkeypatch):
    """attn_impl="fused" used to be refused: every training step goes
    through `short_attention` once per BERT layer with the probs dropout
    rate, every eval batch at rate 0, the loss falls, and a Predictor on the
    checkpoint reaches it at rate 0 (S <= 16 here)."""
    from mmda_tpu_torch.models import bert as pbert
    from mmda_tpu_torch.serving import Predictor

    calls = []
    real = pbert.short_attention
    monkeypatch.setattr(pbert, "short_attention",
                        lambda *a: (calls.append((a[0].shape, a[5])), real(*a))[1])
    cfg = _tiny_cfg(tmp_path, n_epoch=2, attn_impl="fused")
    trainer = Trainer(cfg, _tiny_data(n_train=64), bert_cfg=BertConfig.tiny())
    summary = trainer.train()
    hist = summary["history"]
    assert len(hist) == 2 and hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert np.isfinite(summary["test_loss"])
    steps, evals, layers = 2 * 2, 2 + 1, 2          # 2 epochs x 2 batches; dev x 2, test
    rates = [rate for _, rate in calls]
    assert rates.count(0.1) == steps * layers and rates.count(0.0) == evals * layers
    assert len(rates) == (steps + evals) * layers
    assert all(shape == (32, 2, 10, 16) for shape, _ in calls)   # (B, nh, S, hd)

    calls.clear()
    pred = Predictor(cfg, bert_cfg=BertConfig.tiny(), max_batch=4,
                     visual_size=trainer.sizes["visual_size"],
                     acoustic_size=trainer.sizes["acoustic_size"])
    rng = np.random.default_rng(1)
    reqs = [{"text": rng.integers(2, 40, size=5).astype(np.int32),
             "visual": rng.normal(size=(5, trainer.sizes["visual_size"])).astype(np.float32),
             "acoustic": rng.normal(size=(5, trainer.sizes["acoustic_size"])).astype(np.float32),
             "bert_ids": rng.integers(1, 128, size=7).astype(np.int32),
             "bert_type": np.zeros(7, np.int32), "bert_mask": np.ones(7, np.int32)}]
    out = pred(reqs)
    assert np.isfinite(out["scores"]).all()
    assert [rate for _, rate in calls] == [0.0] * layers


def test_train_cli_on_the_cpu_writes_a_checkpoint_both_packages_serve(tmp_path):
    """`python -m mmda_tpu_torch.cli.train --device cpu` on the synthetic
    data: the port's Predictor serves the export, and the JAX package's
    Predictor-facing `load_checkpoint` reads it."""
    from mmda_tpu_torch.cli import train as cli_train
    from mmda_tpu_torch.serving import Predictor

    args = ["--device", "cpu", "--data", "synthetic", "--use_bert", "False",
            "--hidden_size", "16", "--embedding_size", "8", "--max_seq_len", "8",
            "--batch_size", "64",
            "--bucket_sizes", "8", "--n_epoch", "1", "--ckpt_dir", str(tmp_path),
            "--name", "cli"]
    summary = cli_train.main(args)
    assert (tmp_path / "summary_cli.json").exists() and summary["best_epoch"] == 0
    cfg = Config(device="cpu", data="synthetic", use_bert=False, hidden_size=16,
                 embedding_size=8, max_seq_len=8, bucket_sizes=(8,), ckpt_dir=str(tmp_path))
    pred = Predictor(cfg, visual_size=35, acoustic_size=74, vocab_size=2048, max_batch=4)
    rng = np.random.default_rng(0)
    reqs = [{"text": rng.integers(2, 2048, size=L).astype(np.int32),
             "visual": rng.normal(size=(L, 35)).astype(np.float32),
             "acoustic": rng.normal(size=(L, 74)).astype(np.float32)} for L in (3, 8)]
    out = pred(reqs)
    assert np.isfinite(out["scores"]).all() and out["scores"].shape == (2, 6)

    jcfg = JConfig(data="synthetic", use_bert=False, hidden_size=16, embedding_size=8)
    template = jmisa.init_misa_params(jax.random.PRNGKey(0), jcfg, visual_size=35,
                                      acoustic_size=74, vocab_size=2048)
    loaded = jckpt.load_checkpoint(str(tmp_path), pckpt.best_model_name(cfg), template)
    np.testing.assert_array_equal(np.asarray(loaded["classifier"]["kernel"]),
                                  pred.model.classifier.weight.detach().numpy().T)


def test_convert_round_trip_is_exact():
    cfg = Config(device="cpu", use_bert=True, **SMALL)
    jcfg = JConfig(use_bert=True, **SMALL)
    tree = jmisa.init_misa_params(jax.random.PRNGKey(9), jcfg, bert_cfg=jbert.BertConfig.tiny())
    model = load_jax_params(MISA(cfg, bert_cfg=BertConfig.tiny()), tree)
    _assert_same_tree(tree, to_jax_tree(model))
