"""Dataset builders: MOSI / MOSEI (CMU-MultimodalSDK) and UR_FUNNY (pickles).

The port's own copy of `mmda_tpu/data/etl/datasets.py`: the same collectors
and `build_dataset`, so a corpus gives the same arrays in both packages.
A re-implementation of the reference ETL classes
(src/create_dataset.py:57-540).  Same pipeline - SDK download, word-level
alignment with avg collapse, label alignment, standard folds, segment
processing (segments.py) - but the output is the framework's fixed-shape
array format plus a saved vocab + GloVe matrix, produced ONCE (the reference
re-tokenizes per batch forever after).

mmsdk is imported lazily: everything else in the framework works without it
(tests/benchmarks use data/synthetic.py).
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Optional

import numpy as np

from mmda_tpu_torch.data import save_splits
from mmda_tpu_torch.data.etl.segments import Segment, pack_split, process_segment
from mmda_tpu_torch.data.etl.tokenizer import HashTokenizer, WordPieceTokenizer
from mmda_tpu_torch.data.etl.vocab import Vocab, load_glove

_SEGMENT_VID = re.compile(r"(.*)\[.*\]")


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _require_mmsdk(sdk_dir: Optional[str], data_path: Optional[str] = None):
    """Return an SDK backend: the real mmsdk when installed, else the local
    h5py CSD backend (etl/csd.py) when .csd files are already on disk.  The
    local backend runs the exact same collector code; it just can't download."""
    import glob
    import sys

    if sdk_dir:
        sys.path.append(str(sdk_dir))
    try:
        from mmsdk import mmdatasdk as md  # noqa: PLC0415

        return md
    except ImportError as e:
        if data_path and glob.glob(os.path.join(data_path, "*.csd")):
            from mmda_tpu_torch.data.etl.csd import local_sdk

            return local_sdk(data_path)
        raise ImportError(
            "CMU-MultimodalSDK (mmsdk) is required to DOWNLOAD MOSI/MOSEI. "
            "With .csd files already on disk the built-in h5py backend is "
            "used automatically; for hermetic runs use --data synthetic."
        ) from e


def _collect_sdk_segments(
    md, data_path: str, dataset_cfg, text_field: str, visual_field: str,
    acoustic_field: str, label_field: str, vocab: Vocab, aligned: bool = True,
) -> Dict[str, List[Segment]]:
    """Shared MOSI/MOSEI collection (src/create_dataset.py:96-208/:268-394).
    aligned=False skips the word-level collapse: every modality keeps its own
    rate within a labelled segment."""
    for attr in ("highlevel", "raw", "labels"):
        try:
            md.mmdataset(getattr(dataset_cfg, attr), data_path)
        except RuntimeError:
            pass  # already downloaded

    recipe = {f: os.path.join(data_path, f) + ".csd"
              for f in (text_field, visual_field, acoustic_field)}
    dataset = md.mmdataset(recipe)

    def avg(intervals, features):
        try:
            return np.average(features, axis=0)
        except Exception:
            return features

    if aligned:
        dataset.align(text_field, collapse_functions=[avg])
    label_recipe = {label_field: os.path.join(data_path, label_field + ".csd")}
    dataset.add_computational_sequences(label_recipe, destination=None)
    dataset.align(label_field)

    folds = dataset_cfg.standard_folds
    split_of = {}
    for vid in folds.standard_train_fold:
        split_of[vid] = "train"
    for vid in folds.standard_valid_fold:
        split_of[vid] = "dev"
    for vid in folds.standard_test_fold:
        split_of[vid] = "test"

    out: Dict[str, List[Segment]] = {"train": [], "dev": [], "test": []}
    num_drop = 0
    for segment in dataset[label_field].keys():
        try:
            vid = _SEGMENT_VID.search(segment).group(1)
            label = dataset[label_field][segment]["features"]
            words = dataset[text_field][segment]["features"]
            visual = dataset[visual_field][segment]["features"]
            acoustic = dataset[acoustic_field][segment]["features"]
        except Exception:
            continue
        seg = process_segment(
            vocab, [w[0] for w in words], visual, acoustic, label, segment, aligned=aligned)
        if seg is None:
            num_drop += 1
            continue
        split = split_of.get(vid)
        if split is None:
            continue
        out[split].append(seg)
    print(f"Total number of {num_drop} datapoints have been dropped.")
    return out


def collect_mosi(data_path: str, sdk_dir: Optional[str], vocab: Vocab):
    md = _require_mmsdk(sdk_dir, data_path)
    return _collect_sdk_segments(
        md, data_path, md.cmu_mosi,
        text_field="CMU_MOSI_TimestampedWords",
        visual_field="CMU_MOSI_VisualFacet_4.1",
        acoustic_field="CMU_MOSI_COVAREP",
        label_field="CMU_MOSI_Opinion_Labels",
        vocab=vocab,
    )


def collect_mosei(data_path: str, sdk_dir: Optional[str], vocab: Vocab):
    md = _require_mmsdk(sdk_dir, data_path)
    return _collect_sdk_segments(
        md, data_path, md.cmu_mosei,
        text_field="CMU_MOSEI_TimestampedWords",
        visual_field="CMU_MOSEI_VisualFacet42",
        acoustic_field="CMU_MOSEI_COVAREP",
        label_field="CMU_MOSEI_LabelsSentiment",
        vocab=vocab,
    )


def collect_mosei_unaligned(data_path: str, sdk_dir: Optional[str],
                            vocab: Vocab) -> Dict[str, List[Segment]]:
    """Unaligned MOSEI: align to LABELS only (no word-level collapse), so each
    modality keeps its native sampling rate within a labeled segment.
    Implements the reference's empty UnAlignedMoseiDataset stub
    (src/data_loader.py:133-135)."""
    md = _require_mmsdk(sdk_dir, data_path)
    return _collect_sdk_segments(
        md, data_path, md.cmu_mosei,
        text_field="CMU_MOSEI_TimestampedWords",
        visual_field="CMU_MOSEI_VisualFacet42",
        acoustic_field="CMU_MOSEI_COVAREP",
        label_field="CMU_MOSEI_LabelsSentiment",
        vocab=vocab, aligned=False,
    )


def collect_ur_funny(data_path: str, vocab: Vocab) -> Dict[str, List[Segment]]:
    """UR_FUNNY humor detection from the pre-pickled SDK features
    (src/create_dataset.py:447-520)."""
    folds = _load_pickle(os.path.join(data_path, "data_folds.pkl"))
    openface = _load_pickle(os.path.join(data_path, "openface_features_sdk.pkl"))
    covarep = _load_pickle(os.path.join(data_path, "covarep_features_sdk.pkl"))
    word_idx = _load_pickle(os.path.join(data_path, "word_embedding_indexes_sdk.pkl"))
    word_list = _load_pickle(os.path.join(data_path, "word_list.pkl"))
    humor = _load_pickle(os.path.join(data_path, "humor_label_sdk.pkl"))

    split_of = {}
    for k in folds["train"]:
        split_of[k] = "train"
    for k in folds["dev"]:
        split_of[k] = "dev"
    for k in folds["test"]:
        split_of[k] = "test"

    out: Dict[str, List[Segment]] = {"train": [], "dev": [], "test": []}
    num_drop = 0
    for key, label in humor.items():
        word_ids = np.asarray(word_idx[key]["punchline_embedding_indexes"])
        acoustic = np.asarray(covarep[key]["punchline_features"])
        visual = np.asarray(openface[key]["punchline_features"])
        words = [word_list[i] for i in word_ids]
        seg = process_segment(
            vocab, words, visual, acoustic,
            np.array([[label]], np.float32), str(key))
        if seg is None:
            num_drop += 1
            continue
        split = split_of.get(key)
        if split is not None:
            out[split].append(seg)
    print(f"Total number of {num_drop} datapoints have been dropped.")
    return out


def build_dataset(
    name: str,
    data_dir: str,
    out_dir: Optional[str] = None,
    sdk_dir: Optional[str] = None,
    word_emb_path: Optional[str] = None,
    bert_vocab_path: Optional[str] = None,
    max_len: int = 64,
    num_classes: int = 6,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Full offline ETL: collect -> freeze vocab -> GloVe -> pack -> save npz."""
    data_path = os.path.join(data_dir, name.upper())
    out_dir = out_dir or data_path
    vocab = Vocab()

    aligned = True
    if name == "mosi":
        splits_seg = collect_mosi(data_path, sdk_dir, vocab)
    elif name == "mosei":
        splits_seg = collect_mosei(data_path, sdk_dir, vocab)
    elif name == "mosei_unaligned":        # read from MOSEI, written to MOSEI_UNALIGNED
        data_path = os.path.join(data_dir, "MOSEI")
        splits_seg = collect_mosei_unaligned(data_path, sdk_dir, vocab)
        aligned = False
    elif name == "ur_funny":
        splits_seg = collect_ur_funny(data_path, vocab)
        num_classes = 1
    else:
        raise ValueError(f"unknown dataset {name!r}")

    vocab.freeze()

    tokenizer = (
        WordPieceTokenizer.from_vocab_file(bert_vocab_path)
        if bert_vocab_path
        else HashTokenizer()
    )

    splits = {split: pack_split(segs, max_len, tokenizer, num_classes, aligned=aligned,
                                max_len_visual=4 * max_len, max_len_acoustic=8 * max_len)
              for split, segs in splits_seg.items()}
    save_splits(out_dir, splits)

    vocab.save(os.path.join(out_dir, "vocab.tsv"))
    if word_emb_path:
        emb = load_glove(vocab, word_emb_path)
        np.save(os.path.join(out_dir, "glove_emb.npy"), emb)
    return splits
