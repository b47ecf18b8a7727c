"""The port's `last_*` train-state snapshots, preemption and resume, on the
CPU at small sizes, against the JAX package where both can be compared:

* the JAX package reads a port snapshot's parameters, full and incremental
  (frozen base + delta), bit for bit, with its own `load_checkpoint`;
* the same frozen parameters give the same base digest in both packages;
* a stale asynchronous write never replaces a newer snapshot;
* SIGTERM ends the run at the epoch boundary with `last_*` written and the
  old handler back; `ckpt_interval` saves where the JAX trainer does; the
  incremental snapshot of a run with a frozen GloVe table resumes with the
  table bit-equal (`tests/test_resilience.py`,
  `tests/test_checkpoint_incremental.py` on the JAX trainer);
* a resume loads into the trainer's own tensors (their addresses kept, so a
  captured graph stays valid): every parameter, moment, accumulator,
  count, mini_step and the generator bit-equal to the snapshot, and a step
  from the loaded state equals, bit for bit, the same step from the state
  in memory;
* a port run stopped after epoch 1 and resumed to epoch 3 against the same
  JAX runs (the JAX trainer's initial weights carried across, dropout off):
  the same resumed_at_step, start epoch and history length, parameters at
  1e-5 (the fusion key bias within lr x updates, as
  test_torch_confidnet_stage2 explains).
"""

import json
import os
import signal

import numpy as np
import pytest
import torch
import jax
from flax import serialization

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.train import checkpoint as jckpt
from mmda_tpu.train.loop import Trainer as JTrainer

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import flatten_tree, load_jax_params, to_jax_tree
from mmda_tpu_torch.data.loader import to_device
from mmda_tpu_torch.data.synthetic import make_dataset
from mmda_tpu_torch.models.bert import BertConfig
from mmda_tpu_torch.train import checkpoint as pckpt
from mmda_tpu_torch.train.loop import Trainer
from mmda_tpu_torch.train.step import train_step
from test_torch_confidnet_stage2 import assert_params_close, deterministic, no_dropout

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

SIZES = dict(visual_size=5, acoustic_size=6, vocab_size=50, bert_vocab_size=64)


class Recorder:
    """A logger that keeps every payload."""

    def __init__(self):
        self.seen = []

    def log(self, metrics, step=None):
        self.seen.append(dict(metrics))

    def close(self):
        pass


def _data(n_train=96, seed=0):
    return make_dataset(n_train, 32, 32, max_len=8, seed=seed, **SIZES)


def _bert_kw(tmp_path, **kw):
    """Tiny BERT under the mosei freeze rule: a frozen mask, frozen layers."""
    return dict(use_bert=True, data="mosei", hidden_size=16, embedding_size=8,
                batch_size=32, max_seq_len=8, bucket_sizes=(8,), n_epoch=1,
                compute_dtype="float32", ckpt_dir=str(tmp_path), name="res", seed=1,
                log_sinks=(), **kw)


def _bert_trainer(tmp_path, **kw):
    return Trainer(Config(device="cpu", **_bert_kw(tmp_path, **kw)), _data(),
                   bert_cfg=BertConfig.tiny(), logger=Recorder())


def _jax_bert_trainer(tmp_path):
    return JTrainer(JConfig(**_bert_kw(tmp_path)), _data(), bert_cfg=jbert.BertConfig.tiny(),
                    use_mesh=False, logger=Recorder())


def _numpy(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("incremental", [False, True], ids=["full", "incremental"])
def test_jax_package_reads_the_parameters_of_a_port_snapshot(tmp_path, incremental):
    tr = _bert_trainer(tmp_path / "port", ckpt_incremental=incremental)
    tr.train()
    want = _numpy(to_jax_tree(tr.model))
    jtr = _jax_bert_trainer(tmp_path / "jax")
    d = str(tmp_path / "port")
    if not incremental:
        assert not pckpt.incremental_checkpoint_exists(d, "last_res")
        got = _numpy(jckpt.load_checkpoint(d, "last_res", {"params": jtr.state.params})["params"])
    else:
        assert not pckpt.checkpoint_exists(d, "last_res")
        meta = json.loads(open(os.path.join(d, "last_res.inc.json")).read())
        assert meta["incremental"] is True and meta["has_ema"] is False
        t_train, t_frozen = jckpt._split_params(jtr.state.params, jtr.frozen)
        trainable = jckpt.load_checkpoint(d, "last_res.inc", {"trainable": t_train})["trainable"]
        frozen = jckpt.load_checkpoint(d, f"frozen_base_{meta['base_digest']}", t_frozen)
        merged = {**trainable, **frozen}
        flat = jax.tree_util.tree_flatten_with_path(jtr.state.params)
        tree = jax.tree_util.tree_unflatten(
            flat[1], [merged[jax.tree_util.keystr(p)] for p, _ in flat[0]])
        got = _numpy(tree)
        assert set(frozen) and set(trainable) and not set(frozen) & set(trainable)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_both_packages_give_the_same_base_digest(tmp_path):
    """The port's parameters, carried into the JAX train state, saved by the
    JAX package's save_checkpoint_incremental: the same frozen base, named
    by the same digest, with the same bytes."""
    tr = _bert_trainer(tmp_path / "port")
    pckpt.save_checkpoint_incremental(str(tmp_path / "port"), "last_res", tr.train_state())
    jtr = _jax_bert_trainer(tmp_path / "jax")
    params = serialization.from_state_dict(jtr.state.params, _nested_numpy(to_jax_tree(tr.model)))
    jckpt.save_checkpoint_incremental(str(tmp_path / "jax"), "last_res",
                                      jtr.state._replace(params=params), jtr.frozen)
    pmeta, jmeta = (json.loads(open(str(tmp_path / d / "last_res.inc.json")).read())
                    for d in ("port", "jax"))
    assert pmeta["base_digest"] and pmeta["base_digest"] == jmeta["base_digest"]
    base = f"frozen_base_{pmeta['base_digest']}.msgpack"
    assert (open(str(tmp_path / "port" / base), "rb").read()
            == open(str(tmp_path / "jax" / base), "rb").read())


def _nested_numpy(tree):
    return {k: _nested_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def test_a_stale_async_write_does_not_win(tmp_path):
    """Two snapshots of one name issued in order, the newer written first:
    the older one's write is dropped, file and metadata alike."""
    path = os.path.join(str(tmp_path), "last_x.msgpack")
    older, newer = pckpt._next_seq(path), pckpt._next_seq(path)
    meta = os.path.join(str(tmp_path), "last_x.json")
    pckpt._write(path, newer, pckpt.to_chunks({"v": torch.tensor([2.0])}), meta, {"seq": 2})
    pckpt._write(path, older, pckpt.to_chunks({"v": torch.tensor([1.0])}), meta, {"seq": 1})
    assert pckpt.load_checkpoint(str(tmp_path), "last_x")["v"].item() == 2.0
    assert json.loads(open(meta).read()) == {"seq": 2}


def _small_kw(tmp_path, **kw):
    base = dict(device="cpu", use_bert=False, data="mosei", hidden_size=16,
                embedding_size=8, compute_dtype="float32", batch_size=16, bucket_sizes=(8,),
                max_seq_len=8, log_sinks=(), ckpt_dir=str(tmp_path), seed=2)
    return {**base, **kw}


def test_preemption_signal_snapshots_and_stops(tmp_path):
    cfg = Config(**_small_kw(tmp_path, name="pre", n_epoch=50))
    log = Recorder()
    tr = Trainer(cfg, _data(32), logger=log)
    fired = []

    def hooked(metrics, step=None):
        Recorder.log(log, metrics, step)
        if "train_loss" in metrics and not fired:
            fired.append(1)
            os.kill(os.getpid(), signal.SIGTERM)

    log.log = hooked
    before = signal.getsignal(signal.SIGTERM)
    summary = tr.train()                 # must stop after the first epoch, not 50
    assert len(summary["history"]) == 1
    assert {"preempted_at_epoch": 0} in log.seen
    assert pckpt.checkpoint_exists(str(tmp_path), "last_pre")
    assert json.loads(open(str(tmp_path / "last_pre.json")).read())["epoch"] == 0
    assert signal.getsignal(signal.SIGTERM) is before


def test_ckpt_interval_skips_and_final_epoch_saves(tmp_path, monkeypatch):
    """ckpt_interval=3, n_epoch=4: last_* written after epochs 2 and 3 only;
    a resume then starts at the saved step."""
    saves = []
    real = pckpt.save_train_state
    monkeypatch.setattr(pckpt, "save_train_state",
                        lambda d, name, state, meta, **kw: (saves.append((name, meta["epoch"])),
                                                            real(d, name, state, meta, **kw))[1])
    cfg = Config(**_small_kw(tmp_path, name="ckint", n_epoch=4, ckpt_interval=3))
    tr = Trainer(cfg, _data(32), logger=Recorder())
    tr.train()
    assert saves == [("last_ckint", 2), ("last_ckint", 3)]
    log = Recorder()
    tr2 = Trainer(cfg.replace(resume=True), _data(32), logger=log)
    assert tr2.step == tr.step == 8 and {"resumed_at_step": 8} in log.seen


def test_incremental_resume_with_a_frozen_glove_table(tmp_path):
    """The GloVe table frozen (freeze_embeddings): the snapshot is
    incremental, never full; the resumed trainer starts at the saved step
    with the table bit-equal, and trains on."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(SIZES["vocab_size"], 8)).astype(np.float32)
    cfg = Config(**_small_kw(tmp_path, name="increso", n_epoch=2, ckpt_incremental=True))
    data = _data(32)
    t1 = Trainer(cfg, data, pretrained_emb=emb, logger=Recorder())
    t1.train()
    assert pckpt.incremental_checkpoint_exists(str(tmp_path), "last_increso")
    assert not pckpt.checkpoint_exists(str(tmp_path), "last_increso")
    t2 = Trainer(cfg.replace(resume=True, n_epoch=3), data, pretrained_emb=emb,
                 logger=Recorder())
    assert t2.step == t1.step == 4
    np.testing.assert_array_equal(t2.model.embed.detach().numpy(), emb)
    summary = t2.train()
    assert len(summary["history"]) == 1 and np.isfinite(summary["test_loss"])


def _state_tensors(tr):
    opt = tr.optimizer
    return [*tr.model.parameters(), *opt.mu, *opt.nu, *opt.acc, *(tr.ema or [])]


def test_resume_loads_in_place_and_the_next_step_is_bit_equal(tmp_path):
    """A run with everything a snapshot carries (tiny BERT under the freeze
    rule: an incremental snapshot; grad_accum_steps=2 stopped mid-update,
    so the accumulators hold a mini-step; an EMA shadow; the generator after
    dropout draws), then a resumed trainer: the same bits everywhere, the
    loaded tensors where they were, and one more step from each on the same
    batch the same bits again."""
    kw = dict(grad_accum_steps=2, ema_decay=0.5, compiled_epoch=True)
    tr = _bert_trainer(tmp_path, **kw)
    tr.train()                                       # 3 mini-steps: one update, one held
    assert tr.optimizer.mini_step == 1 and tr.optimizer.count == 1
    assert pckpt.incremental_checkpoint_exists(str(tmp_path), "last_res")
    log = Recorder()
    tr2 = Trainer(Config(device="cpu", **_bert_kw(tmp_path, resume=True, **kw)), _data(),
                  bert_cfg=BertConfig.tiny(), logger=log)
    assert {"resumed_at_step": 3} in log.seen
    for a, b in zip(_state_tensors(tr), _state_tensors(tr2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (tr2.step, tr2.optimizer.count, tr2.optimizer.mini_step) == (3, 1, 1)
    assert torch.equal(tr.generator.get_state(), tr2.generator.get_state())

    ptrs = [t.data_ptr() for t in _state_tensors(tr2)]
    pckpt.load_checkpoint_incremental(str(tmp_path), "last_res", tr2.train_state())
    assert ptrs == [t.data_ptr() for t in _state_tensors(tr2)]

    host = next(tr._loader("train", shuffle=False).host_batches())
    outs = [train_step(t.model, t.optimizer, to_device(host, torch.device("cpu")), t.cfg,
                       t.generator, t.ema) for t in (tr, tr2)]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    for a, b in zip(_state_tensors(tr), _state_tensors(tr2)):
        assert torch.equal(a, b)
    assert tr2.optimizer.count == 2 and tr2.optimizer.mini_step == 0


def test_resumed_run_matches_jax(tmp_path, monkeypatch):
    """Stopped after epoch 1 (n_epoch=2), resumed to epoch 3, in both
    packages from the same initial weights with dropout off: the same
    resumed_at_step, start epoch and history; parameters at 1e-5."""
    deterministic(monkeypatch)
    kw = dict(use_bert=False, data="mosei", hidden_size=16, embedding_size=8,
              compute_dtype="float32", batch_size=16, bucket_sizes=(8,), max_seq_len=8,
              log_sinks=(), name="rr", seed=5, learning_rate=1e-3, n_epoch=2)
    data = _data(64, seed=3)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j1 = JTrainer(JConfig(**kw, ckpt_dir=jdir), data, use_mesh=False, logger=Recorder())
    p1 = Trainer(Config(device="cpu", **kw, ckpt_dir=pdir), data, logger=Recorder())
    load_jax_params(p1.model, j1.state.params)
    no_dropout(p1)
    j1.train()
    p1.train()
    jlog, plog = Recorder(), Recorder()
    resume = dict(kw, resume=True, n_epoch=3)
    j2 = JTrainer(JConfig(**resume, ckpt_dir=jdir), data, use_mesh=False, logger=jlog)
    p2 = Trainer(Config(device="cpu", **resume, ckpt_dir=pdir), data, logger=plog)
    no_dropout(p2)
    assert {"resumed_at_step": 8} in jlog.seen and {"resumed_at_step": 8} in plog.seen
    jsum, psum = j2.train(), p2.train()
    assert [h["epoch"] for h in psum["history"]] == [h["epoch"] for h in jsum["history"]] == [2]
    assert p2.step == int(j2.state.step) == 12
    got, want = _numpy(to_jax_tree(p2.model)), _numpy(j2.state.params)
    assert_params_close(got, want, kw["learning_rate"], 12)
