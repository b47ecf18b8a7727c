"""ConfidNet confidence-quality evaluation (numpy only).

Counterpart of `mmda_tpu/utils/confidence_metrics.py`.  It scores what the
ConfidNet paper (Corbiere et al., "Addressing Failure Prediction by Learning
Model Confidence", NeurIPS 2019) cares about, over the flat per-class cells
of a multilabel problem:

  * TCP calibration: the MSE between the predicted confidence tcp_c and its
    regression target truth_c * score_c (the True Class Probability the head
    was trained toward);
  * failure prediction: AUPR-Error (positives = misclassified cells, score
    1 - tcp), AUPR-Success (positives = correct cells, score tcp) and
    FPR@95TPR on the success side.

Average precision is the step integral over the distinct score values
(`sklearn.metrics.average_precision_score`'s definition: tied scores form one
threshold), written out in numpy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sum over the distinct scores s, high to low, of (R(s) - R(s')) P(s):
    precision P and recall R of the cells scored >= s, s' the next higher
    score (R = 0 above the highest).  nan without positives."""
    if y_true.sum() == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")[::-1]
    score, yt = y_score[order], y_true[order].astype(np.float64)
    last = np.r_[np.where(np.diff(score))[0], yt.size - 1]   # each threshold's last cell
    tps = np.cumsum(yt)[last]
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(max(0.0, np.sum(np.diff(np.r_[0.0, recall]) * precision)))


def _fpr_at_tpr(y_true: np.ndarray, y_score: np.ndarray,
                tpr_target: float = 0.95) -> float:
    """Smallest false-positive rate among thresholds achieving >= tpr_target
    true-positive rate (positives = y_true)."""
    pos = y_true.astype(bool)
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(-y_score, kind="stable")
    yt = pos[order]
    tpr = np.cumsum(yt) / n_pos
    fpr = np.cumsum(~yt) / n_neg
    ok = tpr >= tpr_target
    return float(fpr[ok][0]) if ok.any() else 1.0


def confidence_metrics(scores: np.ndarray, tcp: np.ndarray,
                       pred_labels: np.ndarray, truth: np.ndarray) -> Dict[str, float]:
    """scores/tcp/pred_labels/truth: (N, C) arrays (see module docstring).
    Returns {tcp_mse, aupr_error, aupr_success, fpr_at_95tpr, error_rate,
    mean_tcp_correct, mean_tcp_error}."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    tcp = np.asarray(tcp, np.float64).reshape(-1)
    pred = np.asarray(pred_labels, np.float64).reshape(-1)
    truth = np.asarray(truth, np.float64).reshape(-1)

    correct = (pred > 0.5) == (truth > 0.5)
    error = ~correct
    return {
        "tcp_mse": float(np.mean((tcp - truth * scores) ** 2)),
        "aupr_error": _average_precision(error.astype(np.int64), 1.0 - tcp),
        "aupr_success": _average_precision(correct.astype(np.int64), tcp),
        "fpr_at_95tpr": _fpr_at_tpr(correct.astype(np.int64), tcp),
        "error_rate": float(np.mean(error)),
        "mean_tcp_correct": float(np.mean(tcp[correct])) if correct.any() else float("nan"),
        "mean_tcp_error": float(np.mean(tcp[error])) if error.any() else float("nan"),
    }
