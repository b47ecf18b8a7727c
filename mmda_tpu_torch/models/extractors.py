"""Tower feature extractors.

Counterpart of `mmda_tpu/models/extractors.py`, `extractor='lstm'` with
`rnncell='lstm'`: two stacked bi-LSTMs whose hidden size is the modality's
input size, giving a (B, 4 * input_size) utterance vector.  The transformer
extractor and the GRU cell are not ported yet and raise.
"""

from __future__ import annotations

import torch

from mmda_tpu_torch.models.bilstm import LSTMExtractor


def make_tower(cfg, input_size: int, device=None) -> LSTMExtractor:
    if cfg.extractor != "lstm":
        raise NotImplementedError(
            f"extractor={cfg.extractor!r} is not ported yet (only 'lstm')")
    if cfg.rnncell != "lstm":
        raise NotImplementedError(
            f"rnncell={cfg.rnncell!r} is not ported yet (only 'lstm')")
    return LSTMExtractor(input_size, input_size, device)


def tower_extract(tower: LSTMExtractor, x: torch.Tensor, lengths: torch.Tensor,
                  recurrence=None) -> torch.Tensor:
    return tower(x, lengths, recurrence)
