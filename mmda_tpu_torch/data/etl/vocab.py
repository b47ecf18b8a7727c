"""Vocabulary + GloVe embedding matrix.

The port's own copy of `mmda_tpu/data/etl/vocab.py`, numpy only: the GloVe
scan is the Python loop (the JAX package's C++ scan behind `native_bridge`
gives the same matrix and is not ported).

Reference semantics (src/create_dataset.py:25-51):
  * growing word->id map with <unk>=0, <pad>=1, frozen to UNK after build;
  * GloVe scan: one pass over glove.840B.300d.txt (2,196,017 lines), tokens may
    contain spaces so the vector is the LAST 300 fields; words not found keep
    their random-normal init row.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

UNK = 0
PAD = 1


class Vocab:
    """Growing word2id with reference UNK/PAD conventions."""

    def __init__(self):
        self.word2id: Dict[str, int] = {"<unk>": UNK, "<pad>": PAD}
        self.frozen = False

    def add(self, word: str) -> int:
        idx = self.word2id.get(word)
        if idx is None:
            if self.frozen:
                return UNK
            idx = len(self.word2id)
            self.word2id[word] = idx
        return idx

    def freeze(self) -> None:
        """After this, unknown words map to UNK (reference return_unk,
        src/create_dataset.py:31-32)."""
        self.frozen = True

    def __len__(self) -> int:
        return len(self.word2id)

    def __getitem__(self, word: str) -> int:
        return self.add(word)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for w, i in sorted(self.word2id.items(), key=lambda kv: kv[1]):
                f.write(f"{w}\t{i}\n")

    @staticmethod
    def load(path: str) -> "Vocab":
        v = Vocab()
        with open(path) as f:
            for line in f:
                w, i = line.rstrip("\n").split("\t")
                v.word2id[w] = int(i)
        v.freeze()
        return v


def load_glove(
    vocab: Vocab,
    path: str,
    embedding_size: int = 300,
    seed: int = 0,
) -> np.ndarray:
    """Fill a (len(vocab), embedding_size) matrix from a GloVe text file.

    Rows for words absent from the file keep N(0,1) init, matching the
    reference (src/create_dataset.py:35-51).
    """
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((len(vocab), embedding_size)).astype(np.float64)

    found = 0
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            content = line.rstrip("\n").split(" ")
            if len(content) <= embedding_size:
                continue
            word = " ".join(content[:-embedding_size])
            idx = vocab.word2id.get(word)
            if idx is not None:
                emb[idx, :] = np.asarray(
                    [float(x) for x in content[-embedding_size:]])
                found += 1
    print(f"Found {found} words in the embedding file.")
    return emb.astype(np.float32)
