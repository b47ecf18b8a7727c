"""The serving request contract, without the model: the schema check, the
raw-text expansion, the bucket choice and the padding to (max_batch,
bucket) that both the live `Predictor` (serving.py) and the
`ExportedPredictor` (serving_export.py) apply before a call.

This module imports no model code (only numpy), so a host that serves an
exported artifact loads it without the zoo.  The padding is the JAX
package's (`mmda_tpu/serving.py`): pad rows get length 1 and one unmasked
BERT token; a request longer than the largest bucket raises
`RequestTooLongError` under overflow="error" and keeps its first tokens
under "truncate".
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

FIELDS = ("text", "visual", "acoustic", "lengths", "bert_ids", "bert_type", "bert_mask")
INDEX_FIELDS = ("text", "bert_ids", "bert_type")        # int64 tensors (lookups)
OVERFLOW = ("error", "truncate")


class RequestTooLongError(ValueError):
    """Request exceeds the largest serving bucket (maps to HTTP 413)."""


def check_overflow(overflow: str) -> str:
    if overflow not in OVERFLOW:
        raise ValueError(f"overflow must be 'error'|'truncate', got {overflow!r}")
    return overflow


def validate_request(r: Dict) -> None:
    """Schema check for one request row; raises ValueError before a malformed
    dict can reach the batching worker."""
    if not isinstance(r, dict):
        raise ValueError(f"request must be a dict, got {type(r).__name__}")
    text = r.get("text")
    if text is None:
        raise ValueError(
            "request is missing 'text' (a string, or an int32 token-id "
            "array); visual/acoustic-only requests must still carry an "
            "empty-string text field")
    if not isinstance(text, str):
        try:
            len(text)
        except TypeError:
            raise ValueError(
                f"'text' must be a string or a sized array, got "
                f"{type(text).__name__}")


def choose_bucket(n: int, bucket_sizes: Sequence[int]) -> int:
    """The smallest bucket that holds n tokens, else the largest."""
    for b in sorted(bucket_sizes):
        if n <= b:
            return b
    return max(bucket_sizes)


def detokenize(r: Dict, tokenizer, word2id: Dict[str, int], visual_size: int,
               acoustic_size: int) -> Dict[str, np.ndarray]:
    """Expand a raw-text request into the array form: WordPiece ids for the
    BERT stream, word2id for the GloVe stream (0 for an unseen word), and
    zeros for missing visual and acoustic streams."""
    words = r["text"].split()
    L = max(len(words), 1)
    ids, types, mask = tokenizer.encode(r["text"], L + 2)
    return {
        "text": np.asarray([word2id.get(w.lower(), 0) for w in words] or [0], np.int32),
        "bert_ids": ids, "bert_type": types, "bert_mask": mask,
        "visual": r.get("visual", np.zeros((L, visual_size), np.float32)),
        "acoustic": r.get("acoustic", np.zeros((L, acoustic_size), np.float32)),
    }


def pad_requests(requests: Sequence[Dict], *, bucket_sizes: Sequence[int], max_batch: int,
                 overflow: str, use_bert: bool, tokenizer=None,
                 word2id: Optional[Dict[str, int]] = None, visual_size: int = 0,
                 acoustic_size: int = 0, who: str = "Predictor"
                 ) -> Tuple[Dict[str, np.ndarray], int]:
    """({field: host array padded to (max_batch, bucket[+2])}, n) for the
    `FIELDS`; the `INDEX_FIELDS` as int64, lengths int32, the streams f32.
    `who` names the caller in the errors."""
    for r in requests:
        validate_request(r)
    if any(isinstance(r.get("text"), str) for r in requests):
        if tokenizer is None:
            raise ValueError(
                f"raw-text request but the {who} has no tokenizer; build it with "
                "tokenizer=WordPieceTokenizer.from_vocab_file(...) (an export: "
                "export_model(..., tokenizer=..., word2id=...))")
        requests = [detokenize(r, tokenizer, word2id or {}, visual_size, acoustic_size)
                    if isinstance(r.get("text"), str) else r for r in requests]
    if any("bert_ids" not in r for r in requests):
        if use_bert:
            raise ValueError(
                "pre-tokenized request is missing 'bert_ids'/'bert_type'/"
                "'bert_mask' but the model consumes BERT inputs "
                "(use_bert=True); either supply them or send raw text "
                "with a tokenizer")

        def _with_bert(r):
            if "bert_ids" in r:
                return r
            L = len(r["text"]) + 2
            return {**r, "bert_ids": np.zeros(L, np.int32),
                    "bert_type": np.zeros(L, np.int32),
                    "bert_mask": np.ones(L, np.int32)}
        requests = [_with_bert(r) for r in requests]
    n = len(requests)
    B = max_batch
    if n > B:
        raise ValueError(f"{n} requests exceed max_batch={B}")
    max_len = max(len(r["text"]) for r in requests)
    cap = max(bucket_sizes)
    if max_len > cap and overflow == "error":
        raise RequestTooLongError(
            f"request has {max_len} tokens but the largest serving bucket "
            f"is {cap}; shorten the request or build the {who} with "
            "overflow='truncate'")
    t = choose_bucket(max_len, bucket_sizes)

    def pad_to(x, shape):
        x = np.asarray(x)
        out = np.zeros(shape, x.dtype)
        sl = tuple(slice(0, min(a, b)) for a, b in zip(x.shape, shape))
        out[sl] = x[sl]
        return out

    dv = np.asarray(requests[0]["visual"]).shape[-1]
    da = np.asarray(requests[0]["acoustic"]).shape[-1]
    arrays = {
        "text": np.stack([pad_to(r["text"], (t,)) for r in requests]),
        "visual": np.stack([pad_to(r["visual"], (t, dv)) for r in requests]),
        "acoustic": np.stack([pad_to(r["acoustic"], (t, da)) for r in requests]),
        "lengths": np.asarray([min(len(r["text"]), t) for r in requests], np.int32),
        "bert_ids": np.stack([pad_to(r["bert_ids"], (t + 2,)) for r in requests]),
        "bert_type": np.stack([pad_to(r["bert_type"], (t + 2,)) for r in requests]),
        "bert_mask": np.stack([pad_to(r["bert_mask"], (t + 2,)) for r in requests]),
    }
    if n < B:
        for k, v in arrays.items():
            pad = np.zeros((B - n,) + v.shape[1:], v.dtype)
            if k == "lengths":
                pad[:] = 1
            if k == "bert_mask":
                pad[:, :1] = 1
            arrays[k] = np.concatenate([v, pad])
    for k in INDEX_FIELDS:
        arrays[k] = arrays[k].astype(np.int64)
    return arrays, n
