"""The ConfidNet confidence-quality metrics of the port against the JAX
package on the CPU: `mmda_tpu_torch.utils.confidence_metrics` (the port's
own numpy copy) against `mmda_tpu.utils.confidence_metrics` on seeded
arrays, and the `conf_*` keys of `Trainer.train()`'s summary under
`use_confidNet=True` against the JAX trainer's on the same Config and data.

Tolerance 1e-12: both sides compute in float64 and differ only in the order
of their sums.
"""

import numpy as np
import pytest
import torch

from mmda_tpu.config import Config as JConfig
from mmda_tpu.train.loop import Trainer as JTrainer
from mmda_tpu.utils import confidence_metrics as jconf

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.train.loop import Trainer
from mmda_tpu_torch.utils import confidence_metrics as pconf

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _cells(case, seed):
    """(scores, tcp, pred_labels, truth) of (N, C) cells for a case."""
    rng = np.random.default_rng(seed)
    N, C = 40, 6
    scores, tcp = rng.random((N, C)), rng.random((N, C))
    pred = (rng.random((N, C)) > 0.5).astype(np.float32)
    truth = (rng.random((N, C)) > 0.5).astype(np.float32)
    if case == "ties":                 # few distinct values: tied thresholds
        scores, tcp = np.round(scores * 4) / 4, np.round(tcp * 5) / 5
    elif case == "all_correct":
        truth = pred.copy()
    elif case == "all_wrong":
        truth = 1.0 - pred
    return scores, tcp, pred, truth


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["random", "ties", "all_correct", "all_wrong"])
def test_confidence_metrics_match_jax(case, seed):
    """Every key, nan where the JAX package gives nan (no positives to rank,
    no negatives for the FPR), within 1e-12 elsewhere."""
    args = _cells(case, seed)
    got, want = pconf.confidence_metrics(*args), jconf.confidence_metrics(*args)
    assert got.keys() == want.keys()
    for k in want:
        assert np.isnan(got[k]) == np.isnan(want[k]), k
        if not np.isnan(want[k]):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def _data(seed=3):
    rng = np.random.default_rng(seed)

    def split(n):
        L = 8
        return {
            "text": rng.integers(2, 64, size=(n, L)).astype(np.int32),
            "visual": rng.normal(size=(n, L, 5)).astype(np.float32),
            "acoustic": rng.normal(size=(n, L, 6)).astype(np.float32),
            "lengths": rng.integers(2, L + 1, size=n).astype(np.int32),
            "bert_ids": rng.integers(3, 64, size=(n, L + 2)).astype(np.int32),
            "bert_type": np.zeros((n, L + 2), np.int32),
            "bert_mask": np.ones((n, L + 2), np.int32),
            "sentiment": rng.normal(size=n).astype(np.float32),
            "emo_label": (rng.random(size=(n, 6)) > 0.6).astype(np.float32),
        }

    data = {"train": split(32), "dev": split(16), "test": split(16)}
    data["train"]["text"][0, 0] = 63     # both trainers size the vocabulary from train
    return data


def test_trainer_summary_has_the_jax_confidnet_keys(tmp_path):
    """use_confidNet=True on a classification split: the port's summary
    holds the JAX trainer's conf_* keys, finite where defined, and equal to
    the port's metrics over its own last evaluate()'s tcp and scores and the
    test predictions."""
    opts = dict(hidden_size=16, embedding_size=8, compute_dtype="float32", use_bert=False,
                batch_size=8, bucket_sizes=(8,), max_seq_len=8, n_epoch=1,
                use_confidNet=True, fix_conf_loss=True, confid_two_stage=False,
                log_sinks=(), name="confq")
    data = _data()
    want = JTrainer(JConfig(**opts, ckpt_dir=str(tmp_path / "jax"), prefetch=0), data,
                    use_mesh=False).train()
    trainer = Trainer(Config(**opts, ckpt_dir=str(tmp_path / "port"), device="cpu"), data)
    passes = []
    evaluate = trainer.evaluate

    def recorded(mode, model=None):
        out = evaluate(mode, model)
        passes.append((mode, out, trainer._last_eval_confidence))
        return out

    trainer.evaluate = recorded
    got = trainer.train()
    conf_keys = {k for k in want if k.startswith("conf_")}
    assert conf_keys and {k for k in got if k.startswith("conf_")} == conf_keys
    for k in ("conf_tcp_mse", "conf_error_rate", "conf_mean_tcp_correct"):
        assert np.isfinite(got[k]), k
    for k in ("conf_aupr_error", "conf_aupr_success", "conf_fpr_at_95tpr"):
        assert np.isnan(got[k]) or 0.0 <= got[k] <= 1.0, k

    mode, (_, _, preds, truths), last = passes[-1]
    assert mode == "test" and last["tcp"].shape == last["scores"].shape == preds.shape
    mine = pconf.confidence_metrics(last["scores"], last["tcp"], preds, truths)
    for k, v in mine.items():
        assert np.isnan(v) == np.isnan(got[f"conf_{k}"]), k
        if not np.isnan(v):
            np.testing.assert_allclose(got[f"conf_{k}"], v, err_msg=k, **TOL)
