"""Pure-Python BERT WordPiece tokenizer (bert-base-uncased semantics).

The port's own copy of the pure-Python path of
`mmda_tpu/data/etl/tokenizer.py`: BasicTokenizer (lowercase, accent-strip,
punctuation split, CJK spacing) + WordPiece greedy longest-match with '##'
continuations, then [CLS] ... [SEP] + pad.  Needs only a vocab.txt.
`encode_batch` runs the ASCII rows through the repository's C++ batch
encoder (`native_bridge.WordPieceHandle`, built at first use, the same
bytes) and every row with non-ASCII text through the Python path, row by
row, as the JAX package does; `use_native=False`, or a host without
make or a C++ compiler, runs every row in Python.  `HashTokenizer` is the
ETL's stand-in when no BERT vocab file is given.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Tuple

import numpy as np

from mmda_tpu_torch.data.etl import native_bridge


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
                 max_chars_per_word: int = 100, use_native: bool = True):
        self.vocab = vocab
        self.lowercase = lowercase
        self.max_chars = max_chars_per_word
        self.use_native = use_native
        self._native = None       # the C++ vocab handle, built at first use
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

    def _native_handle(self):
        if self._native is None and self.use_native and self.max_chars == 100:
            lib = native_bridge.load()
            if lib is not None:
                self._native = native_bridge.WordPieceHandle(lib, self.vocab)
            else:
                self.use_native = False
        return self._native

    def encode_batch(self, texts: List[str], max_length: int):
        """Encode rows; returns (input_ids, token_type_ids, attention_mask),
        each (len(texts), max_length) int32.  ASCII rows go through the C++
        encoder; a row it flags (non-ASCII text) through `encode`."""
        out_types = np.zeros((len(texts), max_length), np.int32)
        handle = self._native_handle()
        if handle is not None and texts:
            out_ids, out_mask, fallback = handle.encode_batch(
                texts, max_length, self.lowercase, self.unk, self.cls, self.sep, self.pad)
            for i in np.nonzero(fallback)[0]:
                out_ids[i], _, out_mask[i] = self.encode(texts[i], max_length)
            return out_ids, out_types, out_mask
        out_ids = np.empty((len(texts), max_length), np.int32)
        out_mask = np.empty((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            out_ids[i], _, out_mask[i] = self.encode(t, max_length)
        return out_ids, out_types, out_mask


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
