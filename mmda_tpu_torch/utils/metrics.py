"""Multi-label emotion metrics, numpy only.

The port's copy of `mmda_tpu/utils/metrics.py` with the same keys and
values, without scikit-learn: precision, recall and F1 over the label
columns of (N, C) indicator arrays, averaged `macro` (mean over labels),
`micro` (pooled counts) or `weighted` (by each label's true count), with 0
wherever a ratio has a zero denominator (sklearn's `zero_division=0`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def get_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Per-sample Jaccard |true AND pred| / |true OR pred| (0/0 counts 0),
    averaged, rounded to 4 decimals."""
    y_true = np.asarray(y_true) > 0
    y_pred = np.asarray(y_pred) > 0
    inter = np.sum(y_true & y_pred, axis=1).astype(np.float64)
    union = np.sum(y_true | y_pred, axis=1).astype(np.float64)
    union = np.where(union <= 0, 1.0, union)
    return round(float(np.mean(inter / union)), 4)


def _ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def _counts(y_true: np.ndarray, y_pred: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Per-label true positives, predicted count, true count."""
    t, p = np.asarray(y_true) != 0, np.asarray(y_pred) != 0
    if t.ndim == 1:
        t, p = t[:, None], p[:, None]
    return (t & p).sum(0), p.sum(0), t.sum(0)


def precision_recall_f1(y_true: np.ndarray, y_pred: np.ndarray,
                        average: str) -> Tuple[float, float, float]:
    """(precision, recall, F1) of multilabel indicator arrays."""
    tp, n_pred, n_true = _counts(y_true, y_pred)
    if average == "micro":
        tp, n_pred, n_true = tp.sum(), n_pred.sum(), n_true.sum()
    prec = _ratio(tp, n_pred)
    rec = _ratio(tp, n_true)
    f1 = _ratio(2 * tp, n_pred + n_true)
    if average == "micro":
        return float(prec), float(rec), float(f1)
    if average == "macro":
        return float(prec.mean()), float(rec.mean()), float(f1.mean())
    if average == "weighted":
        w = n_true.astype(np.float64)
        if w.sum() == 0:
            return 0.0, 0.0, 0.0
        return tuple(float(np.average(x, weights=w)) for x in (prec, rec, f1))
    raise ValueError(f"average must be macro|micro|weighted, got {average!r}")


def get_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    """Multilabel accuracy and macro (unprefixed), micro_ and weighted_
    precision / recall / F1."""
    out = {"acc": get_accuracy(y_true, y_pred)}
    for avg, prefix in (("macro", ""), ("micro", "micro_"), ("weighted", "weighted_")):
        p, r, f = precision_recall_f1(y_true, y_pred, avg)
        out[f"{prefix}f1"] = f
        out[f"{prefix}precision"] = p
        out[f"{prefix}recall"] = r
    return out


def select_by_eval_mode(values: Dict[str, float], eval_mode: str) -> Dict[str, float]:
    """The logged payload of one eval_mode."""
    prefix = {"macro": "", "micro": "micro_", "weighted": "weighted_"}[eval_mode]
    return {
        "test_f_score": values[f"{prefix}f1"],
        "test_precision": values[f"{prefix}precision"],
        "test_recall": values[f"{prefix}recall"],
        "test_acc2": values["acc"],
    }
