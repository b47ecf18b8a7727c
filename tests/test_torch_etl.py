"""The port's ETL (`mmda_tpu_torch/data/etl`, `cli/etl.py`) against the JAX
package's, on corpora the tests write themselves in the formats the
reference reads (as `tests/test_etl*.py` and `tests/test_golden_pipeline.py`
write them): MOSI and MOSEI as `.csd` HDF5 files through the mmsdk-free
`LocalSdk` (word alignment with the avg collapse, label alignment, folds),
unaligned MOSEI, and UR_FUNNY's SDK pickles.  Every array of every split,
the vocab and the GloVe matrix equal, dtype and value; `cli.etl` writes the
same `.npz` files; it runs with the JAX package blocked from import; and
the port's training CLI trains on what it wrote.

The port's ETL is numpy only; the JAX package packs and scans through its
C++ library when it builds, which gives the same arrays.  Both run in one
process, so `HashTokenizer`'s salted `hash` gives both the same ids.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mmda_tpu.cli import etl as jcli
from mmda_tpu.data.etl import datasets as jds

from mmda_tpu_torch.cli import etl as pcli
from mmda_tpu_torch.data import load_splits
from mmda_tpu_torch.data.etl import csd as pcsd
from mmda_tpu_torch.data.etl import datasets as pds

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the UR_FUNNY pickles' writer)
FIELDS = {
    "MOSI": ("CMU_MOSI_TimestampedWords", "CMU_MOSI_VisualFacet_4.1", "CMU_MOSI_COVAREP",
             "CMU_MOSI_Opinion_Labels"),
    "MOSEI": ("CMU_MOSEI_TimestampedWords", "CMU_MOSEI_VisualFacet42", "CMU_MOSEI_COVAREP",
              "CMU_MOSEI_LabelsSentiment"),
}
WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "happy", "sad"]
DV, DA, EMB = 35, 74, 300


def write_csd_corpus(data_path, kind, n_vids=6, segs=3, seed=0):
    """n_vids videos of `segs` 3-second labelled segments in the CMU SDK's
    .csd layout: words at 4 Hz with b'sp' pauses, visual at 10 Hz, acoustic
    at 20 Hz (a ragged tail on one video), 7-dim MOSEI labels or MOSI's
    scalar sentiment; folds in standard_folds.json."""
    os.makedirs(data_path, exist_ok=True)
    rng = np.random.default_rng(seed)
    pool = [w.encode() for w in WORDS] + [b"sp"]
    text, vis, aco, lab = FIELDS[kind]
    seqs = {f: {} for f in FIELDS[kind]}
    vids = [f"vid{j:02d}" for j in range(n_vids)]
    for j, vid in enumerate(vids):
        dur = 3.0 * segs
        n_w, n_v, n_a = int(dur * 4), int(dur * 10), int(dur * 20) - (j == 2) * 7
        seqs[text][vid] = {
            "features": np.array([pool[rng.integers(len(pool))] for _ in range(n_w)],
                                 dtype="S8").reshape(-1, 1),
            "intervals": np.stack([np.arange(n_w) * 0.25, (np.arange(n_w) + 1) * 0.25], 1)}
        for field, n, rate, d in ((vis, n_v, 0.1, DV), (aco, n_a, 0.05, DA)):
            feats = rng.normal(size=(n, d)).astype(np.float32)
            feats[rng.random(size=feats.shape) < 0.01] = np.nan
            seqs[field][vid] = {"features": feats,
                                "intervals": np.stack([np.arange(n) * rate,
                                                       (np.arange(n) + 1) * rate], 1)}
        width = 7 if kind == "MOSEI" else 1
        labels = rng.uniform(-3, 3, size=(segs, width)).astype(np.float32)
        seqs[lab][vid] = {"features": labels,
                          "intervals": np.stack([np.arange(segs) * 3.0,
                                                 (np.arange(segs) + 1) * 3.0], 1)}
    for field, entries in seqs.items():
        pcsd.write_csd(os.path.join(data_path, field + ".csd"), field, entries)
    with open(os.path.join(data_path, "standard_folds.json"), "w") as f:
        json.dump({"train": vids[:4], "valid": vids[4:5], "test": vids[5:]}, f)


def write_urfunny(data_path):
    """UR_FUNNY's SDK pickles (reference src/create_dataset.py:447-520):
    24 utterances of 2 to 8 words, 4 visual and 5 acoustic features."""
    chip_smoke.write_urfunny(data_path, rows=(16, 4, 4), widths=(4, 5), words=WORDS,
                             max_words=8)


def write_glove(path, seed=1):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for w in WORDS[:6]:
            f.write(w + " " + " ".join(f"{x:.5f}" for x in rng.normal(size=EMB)) + "\n")


def write_bert_vocab(path):
    with open(path, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS[:7]) + "\n")


def write_corpus(data_dir, name):
    if name == "ur_funny":
        write_urfunny(os.path.join(data_dir, "UR_FUNNY"))
    else:
        kind = "MOSI" if name == "mosi" else "MOSEI"
        write_csd_corpus(os.path.join(data_dir, kind), kind)


def assert_same_outputs(got_dir, want_dir):
    got, want = load_splits(got_dir), load_splits(want_dir)
    for split in want:
        assert got[split].keys() == want[split].keys(), split
        for k, w in want[split].items():
            g = got[split][k]
            assert g.dtype == w.dtype and g.shape == w.shape, (split, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{split} {k}")
    for extra in ("vocab.tsv", "glove_emb.npy"):
        a, b = os.path.join(got_dir, extra), os.path.join(want_dir, extra)
        assert os.path.exists(a) == os.path.exists(b), extra
        if os.path.exists(b):
            assert open(a, "rb").read() == open(b, "rb").read(), extra


@pytest.mark.parametrize("name,bert_vocab", [
    ("mosi", False), ("mosei", True), ("mosei", False), ("mosei_unaligned", True),
    ("ur_funny", False)])
def test_build_dataset_matches_jax(tmp_path, name, bert_vocab):
    data_dir = str(tmp_path / "data")
    write_corpus(data_dir, name)
    glove = str(tmp_path / "glove.txt")
    write_glove(glove)
    vocab = None
    if bert_vocab:
        vocab = str(tmp_path / "vocab.txt")
        write_bert_vocab(vocab)
    kw = dict(word_emb_path=glove, bert_vocab_path=vocab, max_len=12)
    want = jds.build_dataset(name, data_dir, out_dir=str(tmp_path / "jax"), **kw)
    got = pds.build_dataset(name, data_dir, out_dir=str(tmp_path / "port"), **kw)
    assert got.keys() == want.keys() == {"train", "dev", "test"}
    for split in want:
        assert got[split].keys() == want[split].keys()
        for k in want[split]:
            np.testing.assert_array_equal(got[split][k], want[split][k], err_msg=f"{split} {k}")
            assert got[split][k].dtype == want[split][k].dtype, k
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))
    if name == "mosei_unaligned":
        assert "visual_lengths" in got["train"]
        assert got["train"]["visual"].shape[1] == 4 * 12


@pytest.mark.parametrize("name", ["mosei", "ur_funny"])
def test_etl_cli_writes_what_the_jax_cli_writes(tmp_path, name):
    data_dir = str(tmp_path / "data")
    write_corpus(data_dir, name)
    glove = str(tmp_path / "glove.txt")
    write_glove(glove)
    args = ["--data", name, "--data_dir", data_dir, "--word_emb_path", glove,
            "--max_len", "10"]
    jcli.main(args + ["--out_dir", str(tmp_path / "jax")])
    pcli.main(args + ["--out_dir", str(tmp_path / "port")])
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_etl_cli_runs_without_the_jax_package(tmp_path):
    """`python -m mmda_tpu_torch.cli.etl` in an interpreter where importing
    jax, flax, optax or mmda_tpu fails: the UR_FUNNY splits (which need no
    h5py) land where `cli.train` reads them."""
    data_dir = str(tmp_path / "data")
    write_urfunny(os.path.join(data_dir, "UR_FUNNY"))
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in ("jax", "jaxlib", "flax", "optax", "mmda_tpu"):
            sys.modules[name] = None
        sys.argv = ["etl", "--data", "ur_funny", "--data_dir", {data_dir!r}]
        runpy.run_module("mmda_tpu_torch.cli.etl", run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "train: 16 segments" in out.stdout
    splits = load_splits(os.path.join(data_dir, "UR_FUNNY"))
    assert splits["train"]["emo_label"].shape == (16, 1)


def test_train_cli_trains_on_the_etl_output(tmp_path):
    """cli.etl then cli.train on the CPU for one epoch: a finite test loss
    and a best-on-dev export."""
    from mmda_tpu_torch.cli import train as cli_train

    data_dir = str(tmp_path / "data")
    write_corpus(data_dir, "mosei")
    glove = str(tmp_path / "glove.txt")
    write_glove(glove)
    pcli.main(["--data", "mosei", "--data_dir", data_dir, "--word_emb_path", glove,
               "--max_len", "12"])
    ckpt = str(tmp_path / "ckpt")
    summary = cli_train.main([
        "--data", "mosei", "--data_dir", data_dir, "--device", "cpu", "--use_bert", "False",
        "--embedding_size", str(EMB), "--hidden_size", "16", "--batch_size", "4",
        "--n_epoch", "1", "--max_seq_len", "12", "--bucket_sizes", "12",
        "--compute_dtype", "float32", "--ckpt_dir", ckpt, "--name", "etl"])
    assert np.isfinite(summary["test_loss"])
    assert os.path.exists(os.path.join(ckpt, "best_model_MISA_mosei.msgpack"))
