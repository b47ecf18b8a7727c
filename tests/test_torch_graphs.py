"""The captured step's body on the CPU: `make_train_graph` / `make_eval_graph`
(`mmda_tpu_torch/train/step.py`) over the static batch buffers against the
eager `train_step` / `eval_step`, the trainer with `compiled_epoch` and
`compiled_eval`, the optimizer's device scalars, and the launch recording a
replay counts by.  On the CPU there is no graph: the same body runs over the
same buffers, which is what a capture records on the card
(`tests/test_torch_cuda.py` holds the replays there).

Bit for bit where both sides run the same arithmetic (the port against
itself); against the JAX package's scanned epoch, 1e-4 (f32, the step
test's tolerance in tests/test_torch_train.py); the optimizer against optax
1e-6, as there.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import misa as jmisa
from mmda_tpu.train import state as jstate
from mmda_tpu.train.step import make_train_epoch

from mmda_tpu_torch.cli import train as cli_train
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import jax_name, load_jax_params
from mmda_tpu_torch.data import loader as ploader
from mmda_tpu_torch.data import synthetic as psynth
from mmda_tpu_torch.models import MISA
from mmda_tpu_torch.models.bert import BertConfig, freeze_layers
from mmda_tpu_torch.ops.kernels import _launch
from mmda_tpu_torch.train import checkpoint as pckpt
from mmda_tpu_torch.train.loop import Trainer
from mmda_tpu_torch.train.state import Optimizer
from mmda_tpu_torch.train.step import (eval_step, make_eval_graph, make_train_graph,
                                       train_step)

torch.set_num_threads(1)

SIZES = dict(visual_size=5, acoustic_size=7, vocab_size=40)
SMALL = dict(hidden_size=16, embedding_size=6, num_classes=6, **SIZES)
TOL4 = dict(rtol=1e-4, atol=1e-4)
TOL6 = dict(rtol=1e-6, atol=1e-6)
TIME_KEYS = ("epoch_time_s", "epoch_total_time_s", "eval_time_s", "post_eval_time_s",
             "utterances_per_s")


def _split(n=64, max_len=8, seed=3):
    split = psynth.make_split(psynth.SyntheticSpec(num_examples=n, max_len=max_len, seed=seed,
                                                   vocab_size=40, visual_size=5,
                                                   acoustic_size=7, bert_vocab_size=128))
    return split


def _host_batches(buckets=(5, 8), batch_size=8, drop_last=True):
    """Three host batches in two bucket shapes: 5, 8, 5 words."""
    loader = ploader.ArrayLoader(_split(), batch_size, shuffle=False, drop_last=drop_last,
                                 bucket_sizes=buckets)
    batches = list(loader.host_batches())
    short = [b for b in batches if b["text"].shape[1] == 5]
    long = [b for b in batches if b["text"].shape[1] == 8]
    return [short[0], long[0], short[1]]


def _same(a, b, where):
    assert a.dtype == b.dtype and torch.equal(a, b), where


def _assert_same_state(m1, o1, e1, m2, o2, e2):
    for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
        _same(p.detach(), q.detach(), n)
    for k in ("mu", "nu"):
        for i, (x, y) in enumerate(zip(getattr(o1, k), getattr(o2, k))):
            _same(x, y, f"{k}[{i}]")
    for i, (x, y) in enumerate(zip(e1 or [], e2 or [])):
        _same(x, y, f"ema[{i}]")
    assert o1.count == o2.count


def _model(cfg, seed=0):
    bert_cfg = dataclasses.replace(BertConfig.tiny(), fused_ln_dropout=cfg.fused_ln_dropout)
    model = MISA(cfg, bert_cfg=bert_cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    freeze_layers(model.bert, 8)
    return model


def _train_setup(cfg, model):
    params = [p for p in model.parameters() if p.requires_grad]
    ema = [p.detach().clone() for p in model.parameters()] if cfg.ema_decay > 0 else None
    return Optimizer(cfg, params), torch.Generator().manual_seed(5), ema


@pytest.mark.parametrize("options", [
    dict(), dict(ema_decay=0.9, missing_modality_prob=0.3, fused_ln_dropout=True)],
    ids=["dropout", "ema+modality-keep+fused-ln"])
def test_train_graph_body_equals_train_step_bit_for_bit(options):
    """Three host batches in two bucket shapes (a warm-up of each shape, then
    a second batch of the first: what a replay runs), dropout on: the losses,
    grad_norm, every parameter, both moments and the EMA shadow equal those
    of `train_step` over `to_device`'s batches from the same state, bit for
    bit; each shape keeps its buffers."""
    cfg = Config(device="cpu", use_bert=True, data="mosei", **SMALL, **options)
    model = _model(cfg)
    twin = copy.deepcopy(model)
    opt, gen, ema = _train_setup(cfg, model)
    opt2, gen2, ema2 = _train_setup(cfg, twin)
    graphs = make_train_graph(model, opt, cfg, "cpu", gen, ema)
    for host in _host_batches():
        got = graphs(host)
        want = train_step(twin, opt2, ploader.to_device(host, torch.device("cpu")), cfg,
                          gen2, ema2)
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k], k)
    _assert_same_state(model, opt, ema, twin, opt2, ema2)
    assert len(graphs.buffers) == 2 and not graphs.graphs
    assert [b.batch.text.shape[1] for b in graphs.buffers.values()] == [5, 8]


def test_train_graph_steps_match_the_jax_scanned_epoch():
    """Three steps of the training graph's body against `make_train_epoch`
    (one `lax.scan` over the same three batches), dropout off (both models
    run their deterministic forward: the fusion layer's rate is fixed at
    0.1) and no modality dropout, under the mosei freeze rule: every step's
    losses and grad_norm, and the trainable parameters after the three
    updates."""
    kw = dict(use_bert=True, compute_dtype="float32", data="mosei",
              missing_modality_prob=0.0, **SMALL)
    jcfg = JConfig(use_pallas=False, **kw)
    cfg = Config(device="cpu", **kw)
    jbert_cfg = jbert.BertConfig.tiny()
    tree = jmisa.init_misa_params(jax.random.PRNGKey(4), jcfg, bert_cfg=jbert_cfg)
    frozen = jax.tree_util.tree_map(lambda _: False, tree)
    frozen["bert"] = jbert.frozen_mask(tree["bert"], max_frozen_layer=8)
    loader = ploader.ArrayLoader(_split(), 8, shuffle=False, drop_last=True,
                                 bucket_sizes=(8,))
    hosts = list(loader.host_batches())[:3]

    model = load_jax_params(MISA(cfg, bert_cfg=BertConfig.tiny()), tree)
    model.train = lambda mode=True: torch.nn.Module.train(model, False)    # dropout off
    tx = jstate.make_optimizer(jcfg, frozen)
    state = jstate.create_train_state(jcfg, tree, jax.random.PRNGKey(0), frozen, tx)
    stacked = jmisa.Batch(**{k: None if hosts[0][k] is None
                             else jnp.asarray(np.stack([h[k] for h in hosts]))
                             for k in ploader.ARRAY_KEYS})
    epoch = make_train_epoch(
        jcfg, tx, lambda *a, **k: jmisa.misa_forward(*a, **{**k, "deterministic": True}),
        jbert_cfg, frozen)
    state, jlosses = epoch(state, stacked)          # donates the state

    freeze_layers(model.bert, 8)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt = Optimizer(cfg, [p for _, p in named])
    graphs = make_train_graph(model, opt, cfg, "cpu", torch.Generator().manual_seed(0))
    for i, host in enumerate(hosts):
        got = graphs(host)
        for k in got:
            np.testing.assert_allclose(got[k].float().numpy(), np.asarray(jlosses[k][i]),
                                       err_msg=f"step {i} {k}", **TOL4)
    for name, p in named:
        path = jax_name(model, name)
        want = state.params
        for part in path.split("."):
            want = want[int(part)] if isinstance(want, (list, tuple)) else want[part]
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if path.endswith(".kernel") else got,
                                   np.asarray(want), err_msg=path, **TOL4)


def _tiny_data(seed=0):
    return psynth.make_dataset(96, 32, 32, max_len=8, seed=seed, bert_vocab_size=128)


def _tiny_cfg(tmp_path, **kw):
    base = dict(device="cpu", use_bert=True, data="mosei", hidden_size=16, embedding_size=8,
                batch_size=8, max_seq_len=8, bucket_sizes=(5, 8), n_epoch=2,
                learning_rate=1e-3, ckpt_dir=str(tmp_path), name="t", seed=1)
    return Config(**{**base, **kw})


def _strip_times(summary):
    out = {k: v for k, v in summary.items() if k != "history"}
    out["history"] = [{k: v for k, v in h.items() if k not in TIME_KEYS}
                      for h in summary["history"]]
    return out


@pytest.mark.parametrize("options", [dict(), dict(ema_decay=0.5, lr_schedule="cosine",
                                                   warmup_steps=3)],
                         ids=["adam", "ema+cosine"])
def test_trainer_compiled_epoch_equals_the_per_step_epoch(tmp_path, options):
    """`Trainer(compiled_epoch=True)` on the CPU against `compiled_epoch=False`
    (two epochs, two bucket shapes, the batch order of the shuffled loader):
    the same per-epoch losses, summary and final parameters, bit for bit."""
    runs = []
    for compiled in (True, False):
        cfg = _tiny_cfg(tmp_path / str(compiled), compiled_epoch=compiled, **options)
        trainer = Trainer(cfg, _tiny_data(), bert_cfg=BertConfig.tiny())
        runs.append((trainer, trainer.train()))
    (t1, s1), (t2, s2) = runs
    assert t1.train_graph is not None and t2.train_graph is None
    assert len(t1.train_graph.buffers) == 2
    np.testing.assert_equal(_strip_times(s1), _strip_times(s2))     # nan == nan
    _assert_same_state(t1.model, t1.optimizer, t1.ema, t2.model, t2.optimizer, t2.ema)
    assert t1.step == t2.step == 2 * len(t1._loader("train", shuffle=False))


@pytest.mark.parametrize("ema_decay", [0.0, 0.5])
def test_evaluate_compiled_eval_equals_the_eager_eval(tmp_path, ema_decay):
    """`evaluate` with compiled_eval True and False: the same loss, accuracy,
    predictions, truths and ConfidNet inputs over a split of several batches
    in two bucket shapes.  With an EMA shadow, `eval_model()` builds a new
    module at every call and the eval graph over those tensors is reused."""
    cfg = _tiny_cfg(tmp_path, ema_decay=ema_decay)
    trainer = Trainer(cfg, _tiny_data(), bert_cfg=BertConfig.tiny())
    trainer.train()
    got = [trainer.evaluate("dev") for _ in range(2)]
    conf = trainer._last_eval_confidence
    trainer.cfg = cfg.replace(compiled_eval=False)
    want = trainer.evaluate("dev")
    for out in got:
        assert out[:2] == want[:2]
        np.testing.assert_array_equal(out[2], want[2])
        np.testing.assert_array_equal(out[3], want[3])
    for k in ("tcp", "scores"):
        np.testing.assert_array_equal(conf[k], trainer._last_eval_confidence[k])
    graph = trainer._eval_graph(trainer.eval_model())
    assert list(trainer.eval_graphs.values()) == [graph]
    assert len(graph.buffers) == 2


def test_early_stop_reload_keeps_the_static_path_on_the_live_parameters(tmp_path):
    """Early stop loads the best-on-dev export into the live parameters in
    place: the parameters keep their storage (the training graph reads them
    there), hold the export afterwards, and a further step through the
    training graph equals an eager step from the reloaded state."""
    cfg = _tiny_cfg(tmp_path, compiled_epoch=True, n_epoch=4, enable_early_stop=True,
                    patience=0)
    trainer = Trainer(cfg, _tiny_data(), bert_cfg=BertConfig.tiny())
    evaluate, calls = trainer.evaluate, []

    def rising_dev_loss(mode, model=None):
        loss, *rest = evaluate(mode, model)
        if mode == "dev":
            calls.append(1)
            loss += len(calls)              # epoch 1 is worse: reload, then stop
        return (loss, *rest)

    trainer.evaluate = rising_dev_loss
    ptrs = [p.data_ptr() for p in trainer.model.parameters()]
    summary = trainer.train()
    assert summary["best_epoch"] == 0 and len(summary["history"]) == 1 and len(calls) == 2
    assert [p.data_ptr() for p in trainer.model.parameters()] == ptrs
    best = pckpt.load_checkpoint(cfg.ckpt_dir, pckpt.best_model_name(cfg))
    reloaded = load_jax_params(copy.deepcopy(trainer.model), best)
    for (n, p), q in zip(trainer.model.named_parameters(), reloaded.parameters()):
        _same(p.detach(), q.detach(), n)

    twin, opt2 = copy.deepcopy(trainer.model), copy.deepcopy(trainer.optimizer)
    opt2.params = [p for p in twin.parameters() if p.requires_grad]
    gen2 = torch.Generator().manual_seed(0)
    gen2.set_state(trainer.generator.get_state())
    host = next(trainer._loader("train", shuffle=False).host_batches())
    got = trainer.train_graph(host)
    want = train_step(twin, opt2, ploader.to_device(host, torch.device("cpu")), cfg, gen2)
    for k in want:
        _same(got[k], want[k], k)
    _assert_same_state(trainer.model, trainer.optimizer, None, twin, opt2, None)


def test_static_batch_copy_equals_to_device_pad_rows_included():
    """A host batch loaded into `StaticBatch` buffers equals `to_device`'s
    batch field for field (dtypes, the int64 ids, the padded rows of a short
    batch: length 1, one BERT position, sample_weight 0); the next batch of
    that shape goes into the same tensors; another shape is refused."""
    loader = ploader.ArrayLoader(_split(n=20), 16, shuffle=False, bucket_sizes=(8,))
    first, padded = list(loader.host_batches())
    assert padded["sample_weight"].sum() == 4 and (padded["lengths"][4:] == 1).all()
    static = ploader.StaticBatch(first, torch.device("cpu"))
    ptrs = [None if t is None else t.data_ptr() for t in static.batch]
    for host in (first, padded):
        got = static.load(host)
        want = ploader.to_device(host, torch.device("cpu"))
        for k, g, w in zip(ploader.ARRAY_KEYS, got, want):
            if w is None:
                assert g is None, k
            else:
                _same(g, w, k)
        assert [None if t is None else t.data_ptr() for t in got] == ptrs
    other = next(ploader.ArrayLoader(_split(n=20), 8, shuffle=False).host_batches())
    with pytest.raises(ValueError, match="shape"):
        static.load(other)


@pytest.mark.parametrize("case", [
    dict(lr_schedule="exponential", lr_decay_rate=0.5, min_lr=1e-5),
    dict(lr_schedule="cosine", warmup_steps=3, n_epoch=3, min_lr=1e-6),
    dict(lr_schedule="plateau")], ids=["exponential", "cosine", "plateau"])
def test_optimizer_scalars_follow_the_schedule_between_updates(case):
    """Six updates split as a replay runs them: `advance()` on the host, then
    `apply()` (the captured half) reading the learning rate and the bias
    corrections from the same device tensor every time.  Against optax: the
    exponential decay across two epoch boundaries (2 updates an epoch), the
    cosine warm-up into its decay, and plateau `set_learning_rate` before
    updates 2 and 4."""
    kw = {"clip": 0.5, "learning_rate": 1e-2, "optimizer": "Adam", **case}
    jcfg, cfg = JConfig(**kw), Config(device="cpu", **kw)
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    spe = 2
    tx = jstate.make_optimizer(jcfg, steps_per_epoch=spe)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = Optimizer(cfg, [tp["a"], tp["b"]], steps_per_epoch=spe)
    scalars, lrs = opt.scalars, []
    for step in range(6):
        if case["lr_schedule"] == "plateau" and step in (2, 4):
            lr = 3e-3 if step == 2 else 1e-3
            state = jstate.set_learning_rate(state, lr)
            opt.set_learning_rate(lr)
        grads = {k: (2 * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        opt.advance()
        lrs.append(-float(opt.scalars[0]))
        opt.apply([torch.from_numpy(grads["a"]), torch.from_numpy(grads["b"])])
        for k in ("a", "b"):
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       err_msg=f"update {step} {k}", **TOL6)
    assert opt.scalars is scalars and opt.count == 6
    assert len(set(lrs)) >= 3                  # the rate did change between updates


def test_launches_made_while_recording_count_at_each_replay():
    """A launch inside `recording()` (a capture) goes to the recorded dict,
    not to the counts; `add_launches` adds it once per replay; one capture at
    a time."""
    _launch.reset_launch_count()
    with _launch.recording() as recorded:
        _launch.launch("gru_fwd", lambda *a: 0)
        _launch.launch("gru_fwd", lambda *a: 0)
        _launch.launch("short_attn_fwd", lambda *a: 0)
        with pytest.raises(RuntimeError, match="one capture"):
            with _launch.recording():
                pass
    assert _launch.launch_count("gru_fwd") == 0
    assert recorded["gru_fwd"] == 2 and recorded["short_attn_fwd"] == 1
    for _ in range(3):
        _launch.add_launches(recorded)
    assert _launch.launch_count("gru_fwd") == 6 and _launch.launch_count("short_attn_fwd") == 3
    _launch.launch("gru_fwd", lambda *a: 0)
    assert _launch.launch_count("gru_fwd") == 7
    with pytest.raises(RuntimeError, match="cudaError 2"):
        _launch.launch("gru_fwd", lambda *a: 2)
    _launch.reset_launch_count()


def test_eval_graph_body_equals_eval_step_bit_for_bit():
    """The eval graph's body over its buffers against `eval_step` over
    `to_device`'s batches: every output, in two bucket shapes."""
    cfg = Config(device="cpu", use_bert=True, data="mosei", **SMALL)
    model = _model(cfg)
    graphs = make_eval_graph(model, cfg, "cpu")
    for host in _host_batches(drop_last=False):
        got = graphs(host)
        want = eval_step(model, ploader.to_device(host, torch.device("cpu")), cfg)
        for k in want:
            _same(got[k], want[k], k)


def test_train_cli_takes_compiled_epoch_and_compiled_eval(tmp_path):
    """`python -m mmda_tpu_torch.cli.train --device cpu --compiled_epoch True
    --compiled_eval False`, as the JAX CLI takes them: the trainer runs
    through its training graph and the run writes its summary."""
    args = ["--device", "cpu", "--data", "synthetic", "--use_bert", "False",
            "--hidden_size", "16", "--embedding_size", "8", "--max_seq_len", "8",
            "--batch_size", "64", "--bucket_sizes", "8", "--n_epoch", "1",
            "--ckpt_dir", str(tmp_path), "--name", "cli", "--compiled_epoch", "True",
            "--compiled_eval", "False"]
    summary = cli_train.main(args)
    assert (tmp_path / "summary_cli.json").exists()
    assert np.isfinite(summary["history"][0]["train_loss"])
