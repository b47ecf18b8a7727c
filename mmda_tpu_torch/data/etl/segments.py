"""Segment-level ETL core shared by all dataset builders.

The port's own copy of `mmda_tpu/data/etl/segments.py`: `pack_split` packs
the word ids and the feature streams in the repository's C++ library
(`native_bridge.pack_tokens` / `pack_floats`), else (`use_native=False`, or
a host without make or a C++ compiler) in Python, with the same result.

Reproduces the reference per-segment pipeline (src/create_dataset.py:157-199 /
:339-394) on generic records, with mmsdk needed only by the collectors:

  * drop segments whose modalities disagree in length (:168-171);
  * nan_to_num on label/visual/acoustic (:174-177);
  * strip b'sp' speech-pause tokens, keeping modalities aligned (:185-190);
  * per-instance z-norm (x - mean) / (1e-6 + std) with nan/inf -> 0 (:198-199);
  * assign to train/dev/test by video id (:201-208).

Then `pack_split` turns a list of segments into the framework's fixed-shape
array format (pre-tokenized BERT ids, padded/truncated streams) - the step the
reference defers to a per-batch collate (src/data_loader.py:59-122).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from mmda_tpu_torch.data.etl import native_bridge
from mmda_tpu_torch.data.etl.vocab import PAD, Vocab

EPS = 1e-6


@dataclasses.dataclass
class Segment:
    words: np.ndarray          # (L,) int32 vocab ids
    visual: np.ndarray         # (L, Dv) float32
    acoustic: np.ndarray       # (L, Da) float32
    actual_words: List[str]
    label: np.ndarray          # raw label array (dataset-specific shape)
    segment_id: str


def znorm(x: np.ndarray) -> np.ndarray:
    """Per-instance z-norm, reference formula (src/create_dataset.py:198-199)."""
    x = np.asarray(x, np.float64)
    return np.nan_to_num(
        (x - x.mean(0, keepdims=True)) / (EPS + np.std(x, axis=0, keepdims=True))
    ).astype(np.float32)


def process_segment(
    vocab: Vocab,
    raw_words: Sequence,        # sequence of word strings or bytes (b'sp' = pause)
    visual: np.ndarray,
    acoustic: np.ndarray,
    label: np.ndarray,
    segment_id: str,
    aligned: bool = True,
) -> Optional[Segment]:
    """One reference segment -> Segment, or None if dropped.

    aligned=False (unaligned MOSEI): modalities keep their OWN sequence
    lengths; sp-pause stripping applies to the text stream only (there is no
    row correspondence to strip against)."""
    if not aligned:
        label = np.nan_to_num(np.asarray(label, np.float64)).astype(np.float32)
        actual_words, word_ids = [], []
        for w in raw_words:
            if isinstance(w, bytes):
                if w == b"sp":
                    continue
                w = w.decode("utf-8")
            elif w == "sp":
                continue
            actual_words.append(w)
            word_ids.append(vocab[w])
        if not word_ids or not len(visual) or not len(acoustic):
            return None
        return Segment(
            words=np.asarray(word_ids, np.int32),
            visual=znorm(np.nan_to_num(np.asarray(visual, np.float64))),
            acoustic=znorm(np.nan_to_num(np.asarray(acoustic, np.float64))),
            actual_words=actual_words,
            label=label,
            segment_id=segment_id,
        )

    if not (len(raw_words) == len(visual) == len(acoustic)):
        return None
    label = np.nan_to_num(np.asarray(label, np.float64)).astype(np.float32)
    visual = np.nan_to_num(np.asarray(visual, np.float64))
    acoustic = np.nan_to_num(np.asarray(acoustic, np.float64))

    actual_words, word_ids, vis_rows, aco_rows = [], [], [], []
    for i, w in enumerate(raw_words):
        if isinstance(w, bytes):
            if w == b"sp":
                continue
            w = w.decode("utf-8")
        elif w == "sp":
            continue
        actual_words.append(w)
        word_ids.append(vocab[w])
        vis_rows.append(visual[i])
        aco_rows.append(acoustic[i])

    if not word_ids:
        return None
    return Segment(
        words=np.asarray(word_ids, np.int32),
        visual=znorm(np.asarray(vis_rows)),
        acoustic=znorm(np.asarray(aco_rows)),
        actual_words=actual_words,
        label=label,
        segment_id=segment_id,
    )


def split_label(label: np.ndarray, num_classes: int = 6):
    """Reference label split (src/data_loader.py:94-107): a 7-dim MOSEI label
    becomes (sentiment scalar, 6 binary emotions via >0); other sizes keep the
    first element as sentiment and produce zero emotions (MOSI) or a binary
    column (UR_FUNNY num_classes=1)."""
    flat = np.asarray(label, np.float32).reshape(-1)
    if flat.size == 7:
        sentiment = flat[0]
        emo = (flat[1:1 + num_classes] > 0.0).astype(np.float32)
        if emo.size < num_classes:
            emo = np.pad(emo, (0, num_classes - emo.size))
        return sentiment, emo
    sentiment = flat[0] if flat.size else 0.0
    if num_classes == 1:
        return sentiment, np.array([1.0 if sentiment > 0 else 0.0], np.float32)
    return sentiment, np.zeros(num_classes, np.float32)


def pack_split(
    segments: List[Segment],
    max_len: int,
    tokenizer,
    num_classes: int = 6,
    use_native: bool = True,
    aligned: bool = True,
    max_len_visual: Optional[int] = None,
    max_len_acoustic: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Segments -> the framework's fixed-shape split format (Batch fields).
    aligned=False packs visual/acoustic with their OWN time axes and emits
    visual_lengths/acoustic_lengths."""
    n = len(segments)
    mlv = (max_len_visual or max_len) if not aligned else max_len
    mla = (max_len_acoustic or max_len) if not aligned else max_len

    lib = native_bridge.load() if use_native else None

    def pack_f(feats, ml):
        if lib is not None:
            return native_bridge.pack_floats(lib, feats, ml, znorm=False)
        out = np.zeros((n, ml, feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            L = min(len(f), ml)
            out[i, :L] = f[:L]
        return out

    if lib is not None:
        text, lengths = native_bridge.pack_tokens(
            lib, [s.words for s in segments], max_len, PAD)
    else:
        text = np.full((n, max_len), PAD, np.int32)
        lengths = np.zeros(n, np.int32)
        for i, s in enumerate(segments):
            L = min(len(s.words), max_len)
            text[i, :L] = s.words[:L]
            lengths[i] = L

    visual = pack_f([s.visual for s in segments], mlv)
    acoustic = pack_f([s.acoustic for s in segments], mla)

    texts = [" ".join(s.actual_words) for s in segments]
    bert_ids, bert_type, bert_mask = tokenizer.encode_batch(texts, max_len + 2)

    sentiment = np.zeros(n, np.float32)
    emo = np.zeros((n, num_classes), np.float32)
    for i, s in enumerate(segments):
        sentiment[i], emo[i] = split_label(s.label, num_classes)

    out = {
        "text": text,
        "visual": visual,
        "acoustic": acoustic,
        "lengths": lengths.astype(np.int32),
        "bert_ids": bert_ids,
        "bert_type": bert_type,
        "bert_mask": bert_mask,
        "sentiment": sentiment,
        "emo_label": emo,
        "sample_weight": np.ones(n, np.float32),
    }
    if not aligned:
        out["visual_lengths"] = np.asarray(
            [min(len(s.visual), mlv) for s in segments], np.int32)
        out["acoustic_lengths"] = np.asarray(
            [min(len(s.acoustic), mla) for s in segments], np.int32)
    return out
