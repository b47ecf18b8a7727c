"""Data: the ETL's fixed-shape splits on disk, synthetic splits, the loader.

A split is one `{split}.npz` per name in SPLITS, whose keys are the `Batch`
fields (text, visual, acoustic, lengths, bert_ids, bert_type, bert_mask,
sentiment, emo_label[, sample_weight, visual_lengths, acoustic_lengths]),
as `mmda_tpu/data/__init__.py` writes and reads them;
`python -m mmda_tpu_torch.cli.etl` builds them from a corpus.
"""

import os
from typing import Dict

import numpy as np

SPLITS = ("train", "dev", "test")


def save_splits(out_dir: str, splits: Dict[str, Dict[str, np.ndarray]]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name, arrays in splits.items():
        np.savez_compressed(os.path.join(out_dir, f"{name}.npz"), **arrays)


def load_splits(data_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """{split: dict of arrays} from `{data_dir}/{split}.npz`."""
    out = {}
    for name in SPLITS:
        path = os.path.join(data_dir, f"{name}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} not found - run the ETL "
                                    "(python -m mmda_tpu_torch.cli.etl) or use --data synthetic")
        with np.load(path) as z:
            out[name] = {k: z[k] for k in z.files}
    return out
