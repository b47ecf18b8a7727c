"""Pure-Python BERT WordPiece tokenizer (bert-base-uncased semantics).

The port's own copy of the pure-Python path of
`mmda_tpu/data/etl/tokenizer.py`: BasicTokenizer (lowercase, accent-strip,
punctuation split, CJK spacing) + WordPiece greedy longest-match with '##'
continuations, then [CLS] ... [SEP] + pad.  Needs only a vocab.txt.  The
C++ batch encoder behind the JAX package's `native_bridge` is not ported
yet; `encode_batch` runs the Python path row by row.  `HashTokenizer` is
the ETL's stand-in when no BERT vocab file is given.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Tuple

import numpy as np


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or (
                unicodedata.category(ch).startswith("C") and ch not in "\t\n\r"):
            continue
        out.append(" " if ch in "\t\n\r" or unicodedata.category(ch) == "Zs" else ch)
    return "".join(out)


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.lowercase = lowercase
        self.max_chars = max_chars_per_word
        self.unk = vocab.get("[UNK]", 100)
        self.cls = vocab.get("[CLS]", 101)
        self.sep = vocab.get("[SEP]", 102)
        self.pad = vocab.get("[PAD]", 0)

    @staticmethod
    def from_vocab_file(path: str) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return WordPieceTokenizer(vocab)

    # ---- basic tokenization ----
    def _basic(self, text: str) -> List[str]:
        text = _clean(text)
        # CJK spacing
        spaced = []
        for ch in text:
            if _is_cjk(ord(ch)):
                spaced.append(f" {ch} ")
            else:
                spaced.append(ch)
        tokens = "".join(spaced).split()
        out = []
        for tok in tokens:
            if self.lowercase:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur = []
            for ch in tok:
                if _is_punct(ch):
                    if cur:
                        out.append("".join(cur))
                        cur = []
                    out.append(ch)
                else:
                    cur.append(ch)
            if cur:
                out.append("".join(cur))
        return out

    # ---- wordpiece ----
    def _wordpiece(self, token: str) -> List[int]:
        if len(token) > self.max_chars:
            return [self.unk]
        ids, start = [], 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    def tokenize_ids(self, text: str) -> List[int]:
        ids = []
        for tok in self._basic(text):
            ids.extend(self._wordpiece(tok))
        return ids

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """encode_plus parity: [CLS] ids[:max_length-2] [SEP] + pad.
        Returns (input_ids, token_type_ids, attention_mask), each (max_length,)."""
        ids = self.tokenize_ids(text)[: max_length - 2]
        ids = [self.cls] + ids + [self.sep]
        n = len(ids)
        input_ids = np.full(max_length, self.pad, np.int32)
        input_ids[:n] = ids
        mask = np.zeros(max_length, np.int32)
        mask[:n] = 1
        types = np.zeros(max_length, np.int32)
        return input_ids, types, mask

    def encode_batch(self, texts: List[str], max_length: int):
        """Encode rows; returns (input_ids, token_type_ids, attention_mask),
        each (len(texts), max_length) int32."""
        out_ids = np.empty((len(texts), max_length), np.int32)
        out_mask = np.empty((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            out_ids[i], _, out_mask[i] = self.encode(t, max_length)
        return out_ids, np.zeros((len(texts), max_length), np.int32), out_mask


class HashTokenizer:
    """Deterministic stand-in when no BERT vocab file is available: each
    whitespace token hashed into the BERT id space with Python's `hash`,
    which is salted per process unless PYTHONHASHSEED is set (as in the JAX
    package's copy).  Not semantically meaningful: it lets the pipeline run
    without a vocab; training with real text needs vocab.txt."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self.cls, self.sep, self.pad = 101, 102, 0

    def encode_batch(self, texts: List[str], max_length: int):
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            toks = text.lower().split()[: max_length - 2]
            row = [self.cls] + [
                1000 + (hash(t) % (self.vocab_size - 1010)) for t in toks
            ] + [self.sep]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, np.zeros_like(ids), mask
