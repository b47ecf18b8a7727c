"""ConfidNet's two-stage recipe (`use_confidNet`, `confid_two_stage`) in the
port's Trainer against the JAX package's, on the CPU at a small size: the
same initial weights (the JAX trainer's, carried across), dropout off (the
deterministic forward in both: the fusion layer's rate is fixed) and the
same batches, so both runs are the same arithmetic.

Checked: the stage-2 export differs from the stage-1 best export in the
`confidence` leaves alone (every other leaf bit-equal, as stage 2 freezes
them) and agrees with the JAX package's at 1e-5; the stage-1 exports agree
at 1e-5 too (`assert_params_close`), but for the fusion attention's key
bias: its gradient is zero in exact arithmetic (a softmax does not see a
bias shared by every key), so Adam turns each package's rounding noise into
a step of up to the learning rate, and it is held within lr x updates; the `stage2_epoch` / `stage2_conf_loss` log lines, the test
metrics and the `conf_*` keys match the JAX trainer's (1e-5 relative,
metrics of labels exactly); stage 2 runs the towers' recurrences forward
only (no `lstm_scan`, whose backward is the BPTT kernel on the card); with
ema_decay > 0 the final test eval reads stage 2's own EMA shadow while the
export holds the trained parameters, as in the JAX trainer.
"""

import numpy as np
import pytest
import torch

from mmda_tpu.config import Config as JConfig
from mmda_tpu.train import loop as jloop
from mmda_tpu.train.loop import Trainer as JTrainer

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import flatten_tree, load_jax_params
from mmda_tpu_torch.data.synthetic import make_dataset
from mmda_tpu_torch.models import bilstm
from mmda_tpu_torch.train import checkpoint as pckpt
from mmda_tpu_torch.train.loop import Trainer

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
COMMON = dict(hidden_size=16, embedding_size=8, compute_dtype="float32", use_bert=False,
              batch_size=16, bucket_sizes=(8,), max_seq_len=8, n_epoch=2, data="mosei",
              use_confidNet=True, fix_conf_loss=True, confid_two_stage=True,
              n_epoch_stage2=2, learning_rate=1e-3, log_sinks=(), name="two", seed=3)


def _data():
    return make_dataset(64, 32, 32, max_len=8, visual_size=5, acoustic_size=6,
                        vocab_size=50, bert_vocab_size=64, seed=4)


def _logs(trainer):
    seen = []
    log = trainer.logger.log
    trainer.logger.log = lambda metrics, step=None: (seen.append(dict(metrics)),
                                                     log(metrics, step))[1]
    return seen


def _stage1_export(trainer, read):
    """Keep the best export as stage 1 left it, just before stage 2 runs."""
    held = {}
    stage2 = trainer._train_confidnet_stage2

    def wrapped(loader):
        held["tree"] = read()
        return stage2(loader)

    trainer._train_confidnet_stage2 = wrapped
    return held


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in flatten_tree(tree).items()}


def assert_params_close(got, want, lr, updates, where=""):
    """Every leaf at 1e-5 but the fusion attention's key bias (the middle
    third of in_proj.bias, module docstring), held within lr x updates."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.array(got[k]), np.array(want[k])
        if k == "fusion.in_proj.bias":
            H = g.shape[0] // 3
            assert np.abs(g[H:2 * H] - w[H:2 * H]).max() <= lr * updates, k
            g[H:2 * H] = w[H:2 * H]
        np.testing.assert_allclose(g, w, err_msg=f"{where} {k}", **TOL)


def deterministic(monkeypatch):
    """Dropout off in the JAX trainer's steps (its model's deterministic
    forward); the port's model is held in eval mode by `no_dropout`."""
    real = jloop.get_model

    def get_model(name):
        init, fwd = real(name)
        return init, lambda *a, **k: fwd(*a, **{**k, "deterministic": True})

    monkeypatch.setattr(jloop, "get_model", get_model)


def no_dropout(trainer):
    model = trainer.model
    model.train = lambda mode=True: torch.nn.Module.train(model, False)


def _runs(tmp_path, monkeypatch, **extra):
    deterministic(monkeypatch)
    data = _data()
    name = pckpt.best_model_name(Config(**COMMON))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtr = JTrainer(JConfig(**COMMON, **extra, ckpt_dir=jdir), data, use_mesh=False)
    ptr = Trainer(Config(device="cpu", **COMMON, **extra, ckpt_dir=pdir), data)
    load_jax_params(ptr.model, jtr.state.params)
    no_dropout(ptr)
    if ptr.ema is not None:
        ptr.ema = [p.detach().clone() for p in ptr.model.parameters()]
    jlogs, plogs = _logs(jtr), _logs(ptr)
    jheld = _stage1_export(jtr, lambda: pckpt.load_checkpoint(jdir, name))
    pheld = _stage1_export(ptr, lambda: pckpt.load_checkpoint(pdir, name))
    calls = {"scan": 0, "recurrence": 0}
    scan, recurrence = bilstm.lstm_scan, bilstm.lstm_recurrence

    def count(key, fn):
        def inner(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return inner

    jsum = jtr.train()
    stage2 = ptr._train_confidnet_stage2

    def counted(loader):
        bilstm.lstm_scan = count("scan", scan)
        bilstm.lstm_recurrence = count("recurrence", recurrence)
        try:
            return stage2(loader)
        finally:
            bilstm.lstm_scan, bilstm.lstm_recurrence = scan, recurrence

    ptr._train_confidnet_stage2 = counted
    psum = ptr.train()
    return dict(jtr=jtr, ptr=ptr, jsum=jsum, psum=psum, jlogs=jlogs, plogs=plogs,
                jheld=jheld, pheld=pheld, calls=calls,
                jbest=pckpt.load_checkpoint(jdir, name), pbest=pckpt.load_checkpoint(pdir, name))


def test_two_stage_run_matches_jax(tmp_path, monkeypatch):
    r = _runs(tmp_path, monkeypatch)
    p1, p2 = _flat(r["pheld"]["tree"]), _flat(r["pbest"])
    j1, j2 = _flat(r["jheld"]["tree"]), _flat(r["jbest"])
    assert p1.keys() == p2.keys() == j1.keys() == j2.keys()
    conf = [k for k in p1 if k.startswith("confidence.")]
    assert sorted(conf) == ["confidence.bias", "confidence.kernel"]
    assert_params_close(p1, j1, COMMON["learning_rate"], 2 * 4, "stage 1")
    for k in p1:
        if k in conf:
            np.testing.assert_allclose(p2[k], j2[k], err_msg=f"stage 2 {k}", **TOL)
            assert not np.array_equal(p2[k], p1[k]), k
        else:
            assert np.array_equal(p2[k], p1[k]), k

    for logs in (r["plogs"], r["jlogs"]):
        assert [m["stage2_epoch"] for m in logs if "stage2_epoch" in m] == [0, 1]
    got = [m["stage2_conf_loss"] for m in r["plogs"] if "stage2_conf_loss" in m]
    want = [m["stage2_conf_loss"] for m in r["jlogs"] if "stage2_conf_loss" in m]
    np.testing.assert_allclose(got, want, rtol=1e-5)

    psum, jsum = r["psum"], r["jsum"]
    keys = sorted(k for k in jsum if k.startswith(("test_", "conf_")))
    assert keys == sorted(k for k in psum if k.startswith(("test_", "conf_")))
    assert any(k.startswith("conf_") for k in keys)
    for k in keys:
        np.testing.assert_allclose(psum[k], jsum[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert psum["best_epoch"] == jsum["best_epoch"]
    # 4 stage-2 steps an epoch, 2 epochs: each runs the 12 directional
    # recurrences (text, visual and acoustic towers without BERT, 2 layers,
    # 2 directions) forward only
    assert r["calls"] == {"scan": 0, "recurrence": 2 * 4 * 12}
    assert not any(p.requires_grad for n, p in r["ptr"].model.named_parameters()
                   if not n.startswith("confidence."))


def test_two_stage_with_ema_tests_the_stage2_shadow(tmp_path, monkeypatch):
    """ema_decay > 0: the export is stage 2's parameters, the final test
    eval the stage-2 shadow's (a fresh copy of the best export that moved
    toward them), in both packages alike."""
    r = _runs(tmp_path, monkeypatch, ema_decay=0.5)
    ptr = r["ptr"]
    shadow = dict(zip([n for n, _ in ptr.model.named_parameters()], ptr.ema))
    live = dict(ptr.model.named_parameters())
    assert not torch.equal(shadow["confidence.weight"], live["confidence.weight"])
    assert torch.equal(shadow["classifier.weight"], live["classifier.weight"])
    np.testing.assert_array_equal(_flat(r["pbest"])["confidence.kernel"],
                                  live["confidence.weight"].detach().numpy().T)
    for k in ("test_loss", "conf_tcp_mse"):
        np.testing.assert_allclose(r["psum"][k], r["jsum"][k], rtol=1e-5, err_msg=k)
