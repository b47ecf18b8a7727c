"""The port's serving stack (mmda_tpu_torch/serving.py, serving_server.py,
cli/serve.py, convert.py, train/checkpoint.py, data/etl/tokenizer.py)
against the JAX package's, on the CPU.

The two Predictors get the same JAX-initialised weights (the port's through
`convert.py`) and the same requests.  Outputs agree within 1e-4 abs/rel
(f32; summation order through BERT, the towers and the heads).
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.data.etl.tokenizer import WordPieceTokenizer as JTokenizer
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import misa as jmisa
from mmda_tpu.serving import Predictor as JPredictor
from mmda_tpu.train import checkpoint as jckpt
from mmda_tpu_torch import convert
from mmda_tpu_torch.cli.serve import serve
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.data.etl.tokenizer import WordPieceTokenizer
from mmda_tpu_torch.models import MISA
from mmda_tpu_torch.models.bert import BertConfig
from mmda_tpu_torch.serving import Predictor, RequestTooLongError
from mmda_tpu_torch.serving_server import PredictionServer
from mmda_tpu_torch.train import checkpoint as ckpt

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(hidden_size=16, visual_size=5, acoustic_size=7, vocab_size=40,
          embedding_size=6, compute_dtype="float32", bucket_sizes=(4, 8),
          max_seq_len=8, use_cmd_sim=False)
MAX_BATCH = 5
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "good", "##s"]


def _request(L, rng):
    return {
        "text": rng.integers(0, 40, size=L).astype(np.int32),
        "visual": rng.normal(size=(L, 5)).astype(np.float32),
        "acoustic": rng.normal(size=(L, 7)).astype(np.float32),
        "bert_ids": np.concatenate([[101], rng.integers(1000, 2000, size=L),
                                    [102]]).astype(np.int32) % 128,
        "bert_type": np.zeros(L + 2, np.int32),
        "bert_mask": np.ones(L + 2, np.int32),
    }


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(use_pallas=False, **KW)
    tree = jmisa.init_misa_params(jax.random.PRNGKey(0), jcfg,
                                  bert_cfg=jbert.BertConfig.tiny())
    tree = jax.tree_util.tree_map(np.asarray, tree)
    jpred = JPredictor(jcfg, params=tree, bert_cfg=jbert.BertConfig.tiny(),
                       max_batch=MAX_BATCH)
    cfg = Config(device="cpu", **KW)
    pred = Predictor(cfg, params=tree, bert_cfg=BertConfig.tiny(),
                     max_batch=MAX_BATCH)
    return tree, jpred, pred, cfg


def _assert_same(got, want):
    assert set(got) == set(want) == {"scores", "labels", "tcp", "hidden"}
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("lengths", [[1, 3, 4], [5, 8], [2, 2, 7, 8, 3]])
def test_predictor_matches_jax_in_every_bucket(models, lengths):
    """Buckets 4 and 8, with pad rows (fewer requests than max_batch) and
    a full batch."""
    _, jpred, pred, _ = models
    rng = np.random.default_rng(sum(lengths))
    reqs = [_request(L, rng) for L in lengths]
    got = pred(reqs)
    _assert_same(got, jpred(reqs))
    assert got["hidden"].shape == (len(lengths), 6 * 16)
    assert set(np.unique(got["labels"])) <= {0.0, 1.0}


@pytest.mark.parametrize("lengths", [[1, 3, 4], [2, 2, 7, 8, 3]])
def test_flash_predictor_matches_jax(models, lengths):
    """A Predictor built from a config with attn_impl="flash" scores through
    the blockwise attention (the JAX one through its Pallas kernels in
    interpret mode, the port through their plain versions).  2e-4: the
    online and the whole-row softmax differ in summation order."""
    from mmda_tpu.ops.pallas import attention as jattn
    from mmda_tpu_torch.models import bert as pbert

    tree, _, dense, cfg = models
    rng = np.random.default_rng(sum(lengths))
    reqs = [_request(L, rng) for L in lengths]
    calls, real = [], pbert.flash_attention
    pbert.flash_attention = lambda *a: (calls.append(a[5]), real(*a))[1]
    jattn.set_force_interpret(True)
    try:
        want = JPredictor(JConfig(use_pallas=False, attn_impl="flash", **KW), params=tree,
                          bert_cfg=jbert.BertConfig.tiny(), max_batch=MAX_BATCH)(reqs)
        got = Predictor(cfg.replace(attn_impl="flash"), params=tree, bert_cfg=BertConfig.tiny(),
                        max_batch=MAX_BATCH)(reqs)
    finally:
        jattn.set_force_interpret(False)
        pbert.flash_attention = real
    assert calls == [0.0, 0.0]                    # once per BERT layer, no dropout
    for k in ("scores", "tcp", "hidden"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=2e-4, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(got[k], dense(reqs)[k], rtol=2e-4, atol=2e-4, err_msg=k)
    clear = np.abs(np.asarray(want["scores"]) - cfg.threshold) > 2e-4
    np.testing.assert_array_equal(got["labels"][clear], np.asarray(want["labels"])[clear])


def test_pad_rows_follow_the_jax_batcher(models):
    _, _, pred, _ = models
    batch, n = pred.batch_arrays([_request(3, np.random.default_rng(0))])
    assert n == 1 and batch.text.shape == (MAX_BATCH, 4)
    np.testing.assert_array_equal(batch.lengths, [3, 1, 1, 1, 1])
    np.testing.assert_array_equal(batch.bert_mask[1:, 0], 1)
    np.testing.assert_array_equal(batch.bert_mask[1:, 1:], 0)
    np.testing.assert_array_equal(batch.sample_weight, [1, 0, 0, 0, 0])


def test_too_long_raises_and_truncate_matches_jax(models):
    tree, _, pred, cfg = models
    rng = np.random.default_rng(4)
    reqs = [_request(11, rng), _request(2, rng)]
    with pytest.raises(RequestTooLongError):
        pred(reqs)
    jcfg = JConfig(use_pallas=False, **KW)
    jt = JPredictor(jcfg, params=tree, bert_cfg=jbert.BertConfig.tiny(),
                    max_batch=MAX_BATCH, overflow="truncate")
    pt = Predictor(cfg, params=tree, bert_cfg=BertConfig.tiny(),
                   max_batch=MAX_BATCH, overflow="truncate")
    _assert_same(pt(reqs), jt(reqs))
    with pytest.raises(ValueError):
        Predictor(cfg, params=tree, bert_cfg=BertConfig.tiny(), overflow="drop")


def test_malformed_requests_raise(models):
    _, _, pred, _ = models
    for bad in ({}, {"text": 3}, "text"):
        with pytest.raises(ValueError):
            pred([bad])
    with pytest.raises(ValueError):       # raw text without a tokenizer
        pred([{"text": "hello world"}])


def test_raw_text_requests_match_jax(models):
    tree, _, _, cfg = models
    vocab = {w: i for i, w in enumerate(VOCAB)}
    word2id = {"hello": 5, "world": 6}
    jcfg = JConfig(use_pallas=False, **KW)
    jpred = JPredictor(jcfg, params=tree, bert_cfg=jbert.BertConfig.tiny(),
                       max_batch=MAX_BATCH, tokenizer=JTokenizer(vocab, use_native=False),
                       word2id=word2id)
    pred = Predictor(cfg, params=tree, bert_cfg=BertConfig.tiny(), max_batch=MAX_BATCH,
                     tokenizer=WordPieceTokenizer(vocab), word2id=word2id)
    reqs = [{"text": "Hello world, goods!"}, {"text": ""}, {"text": "world"}]
    _assert_same(pred(reqs), jpred(reqs))


def test_tokenizer_matches_jax():
    vocab = {w: i for i, w in enumerate(VOCAB + ["café", "[CLS]x"])}
    texts = ["Hello, WORLD!", "goods\tgood  world", "Café 東京 x", "", "a" * 120]
    want = JTokenizer(vocab, use_native=False)
    got = WordPieceTokenizer(vocab)
    for t in texts:
        for a, b in zip(got.encode(t, 12), want.encode(t, 12)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got.encode_batch(texts, 9), want.encode_batch(texts, 9)):
        np.testing.assert_array_equal(a, b)


def test_prediction_server_round_trip(models):
    _, _, pred, _ = models
    rng = np.random.default_rng(9)
    reqs = [_request(L, rng) for L in (1, 4, 6, 8, 2, 3)]
    want = {i: pred([r]) for i, r in enumerate(reqs)}
    srv = PredictionServer(pred, max_wait_ms=20.0)
    try:
        srv.warmup()
        futs = [srv.submit(r) for r in reqs]
        for i, f in enumerate(futs):
            out = f.result(timeout=120)
            for k in want[i]:
                np.testing.assert_allclose(out[k], want[i][k][0], err_msg=k, **TOL)
        with pytest.raises(ValueError):
            srv.submit({})
        assert srv.stats["utterances"] >= len(reqs)
    finally:
        srv.close()
    with pytest.raises(RuntimeError):
        srv.submit(reqs[0])


def test_http_front_end(models):
    tree, _, _, cfg = models
    pred = Predictor(cfg, params=tree, bert_cfg=BertConfig.tiny(), max_batch=MAX_BATCH)
    httpd, psrv = serve(cfg, port=0, predictor=pred, timeout_s=60)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["ok"]
        r0 = _request(3, np.random.default_rng(1))
        body = json.dumps({k: v.tolist() for k, v in r0.items()}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                url + "/predict", data=body), timeout=60) as r:
            out = json.loads(r.read())
        np.testing.assert_allclose(out["scores"], pred([r0])["scores"][0], **TOL)
        long = {k: v.tolist() for k, v in _request(10, np.random.default_rng(2)).items()}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                url + "/predict", data=json.dumps(long).encode()), timeout=60)
        assert e.value.code == 413
    finally:
        httpd.shutdown()
        psrv.close()


def test_checkpoint_written_by_jax_serves_in_the_port(models, tmp_path):
    tree, _, pred, cfg = models
    cfg = cfg.replace(ckpt_dir=str(tmp_path))
    jckpt.save_checkpoint(str(tmp_path), ckpt.best_model_name(cfg), tree)
    assert ckpt.best_model_name(cfg) == jckpt.best_model_name(JConfig(**KW))
    served = Predictor(cfg, params=None, bert_cfg=BertConfig.tiny(), max_batch=MAX_BATCH)
    reqs = [_request(L, np.random.default_rng(L)) for L in (2, 7)]
    want = pred(reqs)
    got = served(reqs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_reads_bf16_and_refuses_flax_msgpack(tmp_path):
    from flax import serialization

    tree = {"a": {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3},
            "layers": [{"b": np.arange(3, dtype=np.float32)}], "step": 7}
    jckpt.save_checkpoint(str(tmp_path), "x", tree)
    got = ckpt.load_checkpoint(str(tmp_path), "x")
    assert got["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"]["w"].float().numpy(),
                                  np.asarray(tree["a"]["w"], np.float32))
    np.testing.assert_array_equal(got["layers"]["0"]["b"].numpy(), [0, 1, 2])
    assert got["step"] == 7
    with open(os.path.join(tmp_path, "legacy.msgpack"), "wb") as f:
        f.write(serialization.to_bytes({"w": np.ones(3, np.float32)}))
    with pytest.raises(ValueError, match="flax-msgpack"):
        ckpt.load_checkpoint(str(tmp_path), "legacy")


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_convert_raises_on_any_leaf_mismatch(models, fault):
    tree, _, _, cfg = models
    tree = jax.tree_util.tree_map(lambda a: a, tree)      # a copy to edit
    if fault == "missing":
        del tree["project_v"]["ln"]["bias"]
    elif fault == "extra":
        tree["classifier"]["gain"] = np.ones(6, np.float32)
    else:
        tree["shared"]["kernel"] = np.ones((16, 17), np.float32)
    model = MISA(cfg, bert_cfg=BertConfig.tiny())
    with pytest.raises(ValueError, match="project_v.ln.bias|classifier.gain|shared"):
        convert.load_jax_params(model, tree)
