"""mmsdk-free CSD ingestion + interval alignment engine.

The port's own copy of `mmda_tpu/data/etl/csd.py` (h5py, imported where a
file is read or written).

The CMU-MultimodalSDK stores computational sequences as `.csd` files - plain
HDF5 with layout  <root>/<seq>/data/<vid>/{features, intervals}  (+ metadata).
The reference hard-depends on the mmsdk package to read and align them
(src/create_dataset.py:2-13,126,310); this module removes that dependency:

  * `CsdSequence` / `read_csd` - h5py readers for the on-disk format;
  * `CsdDataset.align` - the word-level interval alignment the reference's
    pipeline uses (`dataset.align(text_field, collapse_functions=[avg])` then
    `align(label_field)`, src/create_dataset.py:126,134 / :310-318):
    reference-row keys become `vid[i]`, other sequences contribute the rows
    whose intervals overlap, optionally collapsed (averaged) per reference row;
  * `local_sdk` - an object exposing the exact mmsdk surface the collectors
    in datasets.py consume (`mmdataset`, dataset cfg with `standard_folds`),
    so `_collect_sdk_segments` runs UNCHANGED on real .csd files with no
    mmsdk installed.  Standard fold video lists load from a
    `standard_folds.json` next to the data (mmsdk embeds them in code; we
    cannot download anything in a hermetic environment).

Written from the documented on-disk format and alignment semantics - no mmsdk
code consulted.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

_SEGMENT_VID = re.compile(r"(.*)\[.*\]")


def read_csd(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read one .csd file -> {vid: {"features": (T,d), "intervals": (T,2)}}."""
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        roots = list(f.keys())
        if not roots:
            raise ValueError(f"{path}: empty csd")
        root = f[roots[0]]
        data = root["data"]
        for vid in data.keys():
            out[vid] = {
                "features": np.asarray(data[vid]["features"]),
                "intervals": np.asarray(data[vid]["intervals"], np.float64),
            }
    return out


def write_csd(path: str, name: str, data: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Write the CSD HDF5 layout (used by tests and export tooling)."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group(name).create_group("data")
        for vid, entry in data.items():
            vg = g.create_group(vid)
            vg.create_dataset("features", data=np.asarray(entry["features"]))
            vg.create_dataset("intervals",
                              data=np.asarray(entry["intervals"], np.float64))
        f[name].create_group("metadata")


class CsdSequence:
    """Dict-like view over one computational sequence."""

    def __init__(self, entries: Dict[str, Dict[str, np.ndarray]]):
        self.entries = entries

    def keys(self):
        return self.entries.keys()

    def __getitem__(self, key):
        return self.entries[key]

    def __contains__(self, key):
        return key in self.entries


def _overlap_rows(intervals: np.ndarray, start: float, end: float) -> np.ndarray:
    """Row indices whose [s_i, e_i) overlaps [start, end) with positive
    measure (point intervals match when they fall inside)."""
    s = intervals[:, 0]
    e = intervals[:, 1]
    ov = np.minimum(e, end) - np.maximum(s, start)
    span = e - s
    return np.where((ov > 0) | ((span == 0) & (s >= start) & (s < end)))[0]


class CsdDataset:
    """In-memory multimodal dataset with mmsdk-compatible align semantics."""

    def __init__(self, sequences: Dict[str, CsdSequence]):
        self.computational_sequences: Dict[str, CsdSequence] = dict(sequences)

    def __getitem__(self, field: str) -> CsdSequence:
        return self.computational_sequences[field]

    def keys(self):
        return self.computational_sequences.keys()

    def add_computational_sequences(self, recipe: Dict[str, str],
                                    destination=None) -> None:
        for name, path in recipe.items():
            self.computational_sequences[name] = CsdSequence(read_csd(path))

    # ------------------------------------------------------------------
    def align(self, reference: str,
              collapse_functions: Optional[Sequence[Callable]] = None) -> None:
        """Re-segment every sequence to the reference's rows.

        For each entry of the reference and each of its rows i with interval
        [s, e): emit key `vid[i]` holding, per sequence, the rows overlapping
        [s, e) - collapsed to one row via `collapse_functions` when given
        (the word-level `avg` collapse of src/create_dataset.py:120-126),
        stacked raw otherwise (the label-segment align at :134).  Reference
        keys that are already `vid[j]` segments group by their base vid.
        """
        ref = self.computational_sequences[reference]
        # group non-reference entries by base vid for interval lookup
        by_vid: Dict[str, Dict[str, List[str]]] = {}
        for name, seq in self.computational_sequences.items():
            if name == reference:
                continue
            vids: Dict[str, List[str]] = {}
            for key in seq.keys():
                m = _SEGMENT_VID.search(key)
                vids.setdefault(m.group(1) if m else key, []).append(key)
            by_vid[name] = vids

        new: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {
            name: {} for name in self.computational_sequences
        }
        for ref_key in ref.keys():
            m = _SEGMENT_VID.search(ref_key)
            base_vid = m.group(1) if m else ref_key
            r_feats = ref[ref_key]["features"]
            r_ivals = ref[ref_key]["intervals"]
            for i in range(len(r_ivals)):
                s, e = float(r_ivals[i, 0]), float(r_ivals[i, 1])
                out_key = f"{base_vid}[{i}]"
                ival = np.array([[s, e]], np.float64)
                new[reference][out_key] = {
                    "features": r_feats[i : i + 1],
                    "intervals": ival,
                }
                ok = True
                for name, seq in self.computational_sequences.items():
                    if name == reference:
                        continue
                    feats_rows: List[np.ndarray] = []
                    for key in by_vid[name].get(base_vid, ()):
                        entry = seq[key]
                        rows = _overlap_rows(entry["intervals"], s, e)
                        if len(rows):
                            feats_rows.append(entry["features"][rows])
                    if not feats_rows:
                        ok = False
                        break
                    feats = np.concatenate(feats_rows, axis=0)
                    if collapse_functions:
                        feats = np.stack(
                            [fn(ival, feats) for fn in collapse_functions])
                    new[name][out_key] = {"features": feats, "intervals": ival}
                if not ok:
                    for name in new:
                        new[name].pop(out_key, None)
        self.computational_sequences = {
            name: CsdSequence(entries) for name, entries in new.items()
        }


# ---------------------------------------------------------------------------
# mmsdk-compatible module surface
# ---------------------------------------------------------------------------


class _Folds:
    def __init__(self, train, valid, test):
        self.standard_train_fold = list(train)
        self.standard_valid_fold = list(valid)
        self.standard_test_fold = list(test)


class _DatasetCfg:
    """Stands in for md.cmu_mosi / md.cmu_mosei: download recipes are empty
    (hermetic environments can't download; .csd files must already be on
    disk) and standard folds load from standard_folds.json."""

    def __init__(self, data_path: str):
        self._data_path = data_path
        self.highlevel: Dict[str, str] = {}
        self.raw: Dict[str, str] = {}
        self.labels: Dict[str, str] = {}

    @property
    def standard_folds(self) -> _Folds:
        path = os.path.join(self._data_path, "standard_folds.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found: without mmsdk the standard fold video "
                "lists must be provided as JSON with keys train/valid/test")
        with open(path) as f:
            folds = json.load(f)
        return _Folds(folds["train"], folds["valid"], folds["test"])


class LocalSdk:
    """Drop-in for the `md` (mmsdk.mmdatasdk) module surface the collectors
    use: md.mmdataset(recipe[, path]), md.cmu_mosi, md.cmu_mosei."""

    def __init__(self, data_path: str):
        self.cmu_mosi = _DatasetCfg(data_path)
        self.cmu_mosei = _DatasetCfg(data_path)

    @staticmethod
    def mmdataset(recipe, destination: Optional[str] = None):
        if not isinstance(recipe, dict) or not recipe:
            raise RuntimeError("local csd backend: nothing to download")
        sequences = {}
        for name, path in recipe.items():
            if not str(path).endswith(".csd"):
                path = str(path) + ".csd"
            if not os.path.exists(path):
                raise RuntimeError(
                    f"{path} missing (local csd backend cannot download)")
            sequences[name] = CsdSequence(read_csd(path))
        return CsdDataset(sequences)


def local_sdk(data_path: str) -> LocalSdk:
    return LocalSdk(data_path)
