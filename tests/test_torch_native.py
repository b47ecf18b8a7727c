"""The port's bridge to the repository's C++ host library
(mmda_tpu_torch/data/etl/native_bridge.py, native/mmda_native.cc built under build/native/) on the
CPU: the port's bridge against the JAX package's (`glove_scan`,
`pack_tokens`, `pack_floats`, `WordPieceHandle.encode_batch`), and each
caller's native path against its Python path and the JAX package's: the
WordPiece `encode_batch` byte for byte, ASCII rows native and non-ASCII
rows per row in Python; the GloVe matrix; `pack_split`'s arrays.  Exact
equality throughout; the build keyed by host and source, and `load()`
None only without a compiler.  Skips only where make or g++ is absent.
"""

import os
import shutil

import numpy as np
import pytest

from mmda_tpu.data.etl import native_bridge as jbridge
from mmda_tpu.data.etl import segments as jsegments
from mmda_tpu.data.etl import tokenizer as jtokenizer
from mmda_tpu.data.etl import vocab as jvocab
from mmda_tpu_torch.data.etl import native_bridge
from mmda_tpu_torch.data.etl import segments
from mmda_tpu_torch.data.etl import tokenizer
from mmda_tpu_torch.data.etl import vocab

VOCAB = {w: i for i, w in enumerate([
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown", "fox",
    "jump", "##s", "##ed", "##ing", "over", "lazy", "dog", "!", ",", ".",
    "'", "don", "##'", "##t", "a", "##b", "##c", "un", "##believ", "##able",
    "cafe", "naive", "模", "型",
])}

CORPUS = [
    "The quick brown fox jumps over the lazy dog!",
    "don't", "unbelievable", "jumping, jumped.  JUMPS", "", "   ",
    "xyzzy unknownword the", "a" * 150, "the\tquick\nfox", "!!!...",
    "café déjà vu", "the 模型 fox", "naïve dog", "Ünïcödé only",
]


@pytest.fixture(scope="module")
def lib():
    if not native_bridge.can_build():
        pytest.skip("no make or C++ compiler on this host: the native library cannot build")
    return native_bridge.load()


def test_bridge_builds_from_the_repository(lib):
    path = native_bridge.lib_path()
    assert path.startswith(os.path.join(native_bridge._ROOT, "build", "native") + os.sep)
    assert os.path.exists(path) and native_bridge._NATIVE_DIR == os.path.dirname(
        jbridge._LIB_PATH)
    assert native_bridge.load() is lib


def test_a_library_for_another_host_or_source_is_not_loaded(lib, monkeypatch):
    """The build's directory is named by the host CPU and the source: a
    library built elsewhere (another -march=native) sits under another name."""
    here = native_bridge.lib_path()
    monkeypatch.setattr(native_bridge, "_cpu_id", lambda: "x86_64\nflags : sse2")
    assert native_bridge.lib_path() != here
    monkeypatch.undo()
    assert native_bridge.lib_path() == here


def _fresh_bridge(monkeypatch, tmp_path):
    monkeypatch.setattr(native_bridge, "_lib_cache", None)
    monkeypatch.setattr(native_bridge, "_BUILD_DIR", str(tmp_path / "native"))


@pytest.mark.parametrize("missing", ["make", "g++"])
def test_load_is_none_only_without_a_compiler(monkeypatch, tmp_path, missing):
    _fresh_bridge(monkeypatch, tmp_path)
    which = shutil.which
    monkeypatch.setattr(native_bridge.shutil, "which",
                        lambda name: None if name == missing else which(name))
    assert native_bridge.load() is None
    assert tokenizer.WordPieceTokenizer(VOCAB)._native_handle() is None
    assert not (tmp_path / "native").exists()


def test_a_failed_build_raises_in_every_caller(lib, monkeypatch, tmp_path):
    _fresh_bridge(monkeypatch, tmp_path)
    monkeypatch.setenv("CXX", "false")                 # a compiler that always fails
    with pytest.raises(RuntimeError, match="make -C native failed"):
        native_bridge.load()
    with pytest.raises(RuntimeError, match="make -C native failed"):
        tokenizer.WordPieceTokenizer(VOCAB).encode_batch(["the fox"], 8)
    with pytest.raises(RuntimeError, match="make -C native failed"):
        vocab.load_glove(vocab.Vocab(), str(tmp_path / "glove.txt"), 4)
    with pytest.raises(RuntimeError, match="make -C native failed"):
        segments.pack_split(_segments(), 8, tokenizer.WordPieceTokenizer(VOCAB, use_native=False))
    assert not list((tmp_path / "native").rglob("*.so"))


@pytest.mark.parametrize("L", [8, 16, 48])
def test_encode_batch_native_equals_python_and_jax(lib, L):
    nat = tokenizer.WordPieceTokenizer(VOCAB)
    py = tokenizer.WordPieceTokenizer(VOCAB, use_native=False)
    jnat = jtokenizer.WordPieceTokenizer(VOCAB)
    got = nat.encode_batch(CORPUS, L)
    assert nat._native_handle() is not None and py._native_handle() is None
    for want in (py.encode_batch(CORPUS, L), jnat.encode_batch(CORPUS, L)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_non_ascii_rows_take_the_python_path(lib):
    texts = ["the quick fox", "café déjà vu", "the 模型 fox", "naïve dog"]
    handle = native_bridge.WordPieceHandle(lib, VOCAB)
    ids, mask, fallback = handle.encode_batch(texts, 16, True, 1, 2, 3, 0)
    j_ids, j_mask, j_fallback = jbridge.WordPieceHandle(lib, VOCAB).encode_batch(
        texts, 16, True, 1, 2, 3, 0)
    assert fallback.tolist() == j_fallback.tolist() == [False, True, True, True]
    np.testing.assert_array_equal(ids[~fallback], j_ids[~fallback])
    np.testing.assert_array_equal(mask[~fallback], j_mask[~fallback])
    ids_p, _, mask_p = tokenizer.WordPieceTokenizer(VOCAB, use_native=False).encode_batch(
        texts, 16)
    ids_n, _, mask_n = tokenizer.WordPieceTokenizer(VOCAB).encode_batch(texts, 16)
    np.testing.assert_array_equal(ids_n, ids_p)
    np.testing.assert_array_equal(mask_n, mask_p)


def _glove_file(path, dim, words, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w", encoding="utf-8") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{v:.6f}" for v in rng.normal(size=dim)) + "\n")
        f.write("short 1.0\n")                          # too few fields: skipped


def test_glove_scan_native_equals_python_and_jax(lib, tmp_path, capsys):
    dim = 12
    path = str(tmp_path / "glove.txt")
    _glove_file(path, dim, ["the", "fox", "two words", "lazy", "absent_from_vocab", "dog"])
    v, jv = vocab.Vocab(), jvocab.Vocab()
    for w in ["the", "fox", "two words", "dog", "cat", "lazy"]:
        v.add(w)
        jv.add(w)
    nat = vocab.load_glove(v, path, dim, seed=3)
    assert "(native scan)" in capsys.readouterr().out
    np.testing.assert_array_equal(nat, vocab.load_glove(v, path, dim, seed=3, use_native=False))
    np.testing.assert_array_equal(nat, jvocab.load_glove(jv, path, dim, seed=3))
    emb = np.zeros((len(v), dim))
    assert native_bridge.glove_scan(lib, v.word2id, path, emb) == 5
    with pytest.raises(IOError):
        native_bridge.glove_scan(lib, v.word2id, str(tmp_path / "nope.txt"), emb)


def _segments(n=7, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(1, 12))
        words = ["the", "fox", "dog", "lazy"]
        out.append(segments.Segment(
            words=rng.integers(2, 50, size=L).astype(np.int32),
            visual=rng.normal(size=(L, 5)).astype(np.float32),
            acoustic=rng.normal(size=(L, 3)).astype(np.float32),
            actual_words=[words[j % 4] for j in range(L)],
            label=rng.normal(size=(1, 7)).astype(np.float32), segment_id=f"s{i}"))
    return out


@pytest.mark.parametrize("max_len", [4, 16])
def test_pack_split_native_equals_python_and_jax(lib, max_len):
    segs = _segments()
    tok = tokenizer.WordPieceTokenizer(VOCAB)
    nat = segments.pack_split(segs, max_len, tok)
    py = segments.pack_split(segs, max_len, tokenizer.WordPieceTokenizer(VOCAB, use_native=False),
                             use_native=False)
    jsegs = [jsegments.Segment(**vars(s)) for s in segs]
    jax_arrays = jsegments.pack_split(jsegs, max_len, jtokenizer.WordPieceTokenizer(VOCAB))
    assert nat.keys() == py.keys() == jax_arrays.keys()
    for k in nat:
        np.testing.assert_array_equal(nat[k], py[k], err_msg=k)
        np.testing.assert_array_equal(nat[k], jax_arrays[k], err_msg=k)
    streams = [s.words for s in segs]
    for got, want in zip(native_bridge.pack_tokens(lib, streams, max_len, vocab.PAD),
                         jbridge.pack_tokens(lib, streams, max_len, jvocab.PAD)):
        np.testing.assert_array_equal(got, want)
    feats = [s.visual for s in segs]
    np.testing.assert_array_equal(native_bridge.pack_floats(lib, feats, max_len, True),
                                  jbridge.pack_floats(lib, feats, max_len, True))
