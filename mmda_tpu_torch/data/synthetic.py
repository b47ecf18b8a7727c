"""Synthetic MOSEI-shaped splits (numpy only).

The port's copy of `mmda_tpu/data/synthetic.py`: the same draws from
`np.random.default_rng(seed)` in the same order, so a spec gives the same
arrays in both packages.  Word ids, visual (FACET 35) and acoustic (COVAREP
74) features, lengths, BERT ids/type/mask, sentiment and six binary emotion
labels that correlate with the visual and acoustic means, so that training
on them lowers the loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_examples: int = 512
    max_len: int = 32
    visual_size: int = 35
    acoustic_size: int = 74
    vocab_size: int = 2048
    bert_vocab_size: int = 30522
    num_classes: int = 6
    seed: int = 0
    aligned: bool = True      # False: visual/acoustic get their own lengths


def make_split(spec: SyntheticSpec) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(spec.seed)
    n, t = spec.num_examples, spec.max_len

    lengths = rng.integers(4, t + 1, size=n).astype(np.int32)
    tmask = (np.arange(t)[None, :] < lengths[:, None])

    text = rng.integers(2, spec.vocab_size, size=(n, t)).astype(np.int32)
    text[~tmask] = 1                                   # PAD id 1

    visual = rng.normal(size=(n, t, spec.visual_size)).astype(np.float32)
    acoustic = rng.normal(size=(n, t, spec.acoustic_size)).astype(np.float32)
    class_dirs_v = rng.normal(size=(spec.num_classes, spec.visual_size)).astype(np.float32)
    class_dirs_a = rng.normal(size=(spec.num_classes, spec.acoustic_size)).astype(np.float32)
    emo = (rng.uniform(size=(n, spec.num_classes)) < 0.3).astype(np.float32)
    visual += 0.5 * (emo @ class_dirs_v)[:, None, :]
    acoustic += 0.5 * (emo @ class_dirs_a)[:, None, :]
    visual[~tmask] = 0.0
    acoustic[~tmask] = 0.0

    sentiment = np.clip(rng.normal(scale=1.2, size=n) + emo.sum(1) - 0.9, -3, 3
                        ).astype(np.float32)

    s = t + 2                                          # [CLS] ... [SEP]
    cls_id, sep_id = (101, 102) if spec.bert_vocab_size > 103 else (1, 2)
    bert_ids = rng.integers(sep_id + 1, spec.bert_vocab_size, size=(n, s)).astype(np.int32)
    bert_ids[:, 0] = cls_id
    bert_mask = np.zeros((n, s), np.int32)
    for i, L in enumerate(lengths):
        bert_ids[i, L + 1] = sep_id
        bert_ids[i, L + 2:] = 0
        bert_mask[i, : L + 2] = 1
    bert_type = np.zeros((n, s), np.int32)

    out = {
        "text": text, "visual": visual, "acoustic": acoustic, "lengths": lengths,
        "bert_ids": bert_ids, "bert_type": bert_type, "bert_mask": bert_mask,
        "sentiment": sentiment, "emo_label": emo,
        "sample_weight": np.ones(n, np.float32),
    }
    if not spec.aligned:
        tv, ta = 2 * t, 3 * t
        v_len = rng.integers(4, tv + 1, size=n).astype(np.int32)
        a_len = rng.integers(4, ta + 1, size=n).astype(np.int32)
        vis = rng.normal(size=(n, tv, spec.visual_size)).astype(np.float32)
        aco = rng.normal(size=(n, ta, spec.acoustic_size)).astype(np.float32)
        vis += 0.5 * (emo @ class_dirs_v)[:, None, :]
        aco += 0.5 * (emo @ class_dirs_a)[:, None, :]
        vis[~(np.arange(tv)[None, :] < v_len[:, None])] = 0.0
        aco[~(np.arange(ta)[None, :] < a_len[:, None])] = 0.0
        out.update(visual=vis, acoustic=aco, visual_lengths=v_len, acoustic_lengths=a_len)
    return out


def make_dataset(num_train: int = 512, num_dev: int = 128, num_test: int = 128,
                 **kw) -> Dict[str, Dict[str, np.ndarray]]:
    """train/dev/test splits from seeds seed, seed + 1, seed + 2."""
    base = SyntheticSpec(**kw)
    return {
        "train": make_split(dataclasses.replace(base, num_examples=num_train, seed=base.seed)),
        "dev": make_split(dataclasses.replace(base, num_examples=num_dev, seed=base.seed + 1)),
        "test": make_split(dataclasses.replace(base, num_examples=num_test, seed=base.seed + 2)),
    }
