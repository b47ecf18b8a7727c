"""Sentiment regression and binary metrics, numpy only.

The port's copy of `mmda_tpu/utils/sentiment_metrics.py` with the same keys
and values: accuracy and the support-weighted F1 over the classes present
in either array (sklearn's `f1_score(average="weighted")`) are written out
here instead of imported from scikit-learn.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def accuracy(truths: np.ndarray, preds: np.ndarray) -> float:
    return float(np.mean(np.asarray(truths) == np.asarray(preds)))


def weighted_f1(truths: np.ndarray, preds: np.ndarray) -> float:
    """F1 of each class present in truths or preds, weighted by its count
    in truths (0 for a class with no predictions and no truths)."""
    t, p = np.asarray(truths).reshape(-1), np.asarray(preds).reshape(-1)
    f1s, weights = [], []
    for c in np.union1d(t, p):
        tp = float(np.sum((t == c) & (p == c)))
        den = float(np.sum(t == c) + np.sum(p == c))
        f1s.append(2 * tp / den if den else 0.0)
        weights.append(float(np.sum(t == c)))
    if not weights or sum(weights) == 0:
        return 0.0
    return float(np.average(f1s, weights=weights))


def multiclass_acc(preds: np.ndarray, truths: np.ndarray) -> float:
    """Rounded-bucket accuracy."""
    return float(np.sum(np.round(preds) == np.round(truths)) / float(len(truths)))


def extreme_mae(preds: np.ndarray, truths: np.ndarray) -> float:
    """MAE over |truth| > 2."""
    sel = np.abs(truths) > 2.0
    if not sel.any():
        return float("nan")
    return float(np.mean(np.abs(preds[sel] - truths[sel])))


def eval_mosei_senti(results, truths, exclude_zero: bool = False) -> Dict[str, float]:
    """mae, corr, mult, f1, acc2, acc2_non0, acc7, acc5, mae_intensity."""
    preds = np.asarray(results, dtype=np.float64).reshape(-1)
    truth = np.asarray(truths, dtype=np.float64).reshape(-1)
    non_zeros = np.flatnonzero(truth != 0)

    mult_a7 = multiclass_acc(np.clip(preds, -3.0, 3.0), np.clip(truth, -3.0, 3.0))
    mult_a5 = multiclass_acc(np.clip(preds, -2.0, 2.0), np.clip(truth, -2.0, 2.0))
    if len(non_zeros):
        bt_non0, bp_non0 = truth[non_zeros] > 0, preds[non_zeros] > 0
        f_score_non0 = weighted_f1(bt_non0, bp_non0)
        acc_2_non0 = accuracy(bt_non0, bp_non0)
    else:
        f_score_non0 = acc_2_non0 = float("nan")
    bt_has0, bp_has0 = truth >= 0, preds >= 0
    return {
        "mae": float(np.mean(np.abs(preds - truth))),
        "corr": float(np.corrcoef(preds, truth)[0][1]),
        "mult": mult_a7, "f1": weighted_f1(bt_has0, bp_has0),
        "acc2": accuracy(bt_has0, bp_has0), "acc2_non0": acc_2_non0,
        "acc7": mult_a7, "acc5": mult_a5,
        "mae_intensity": extreme_mae(preds, truth),
    }


def eval_binary(results, truths) -> Dict[str, float]:
    """Binary classification (UR_FUNNY humor): acc2 and weighted F1."""
    return {"acc2": accuracy(truths, results), "f1": weighted_f1(truths, results)}
