"""The port's serving artifacts (mmda_tpu_torch/serving_export.py,
cli/export.py, cli/serve.py --export_dir) on the CPU, the counterparts of
tests/test_export.py at its sizes (hidden 16, buckets 4/8, max_batch 8).

An `ExportedPredictor` holds the port's live `Predictor` at rtol 1e-5 /
atol 1e-6 (the same ops in the same order: in practice the same bits) and
the JAX `Predictor` on the same JAX-initialised weights at 1e-4.  Each
bucket program calls the kernels as `torch.ops.mmda_tpu_torch.*` nodes, as
many as a live call makes wrapper calls, and holds no recurrence unrolled
over time; the four ops pass `torch.library.opcheck`.  The loader imports
no model code, and an artifact serves only on the device type it was
exported for.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch
import jax

from mmda_tpu.config import Config as JConfig
from mmda_tpu.data.etl.tokenizer import WordPieceTokenizer as JTokenizer
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import get_model as jget_model
from mmda_tpu.serving import Predictor as JPredictor
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.data.etl.tokenizer import WordPieceTokenizer
from mmda_tpu_torch.models.bert import BertConfig
from mmda_tpu_torch.ops.kernels import attention as kattn
from mmda_tpu_torch.ops.kernels import gru as kgru
from mmda_tpu_torch.ops.kernels import lstm as klstm
from mmda_tpu_torch.ops.kernels import short_attention as kshort
from mmda_tpu_torch.serving import Predictor
from mmda_tpu_torch.serving_export import FORMAT, ExportedPredictor, export_model

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(9)
LIVE = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(hidden_size=16, num_classes=6, visual_size=5, acoustic_size=6, vocab_size=64,
          embedding_size=8, compute_dtype="float32", use_bert=False, batch_size=8,
          bucket_sizes=(4, 8), max_seq_len=8, data="synthetic")
ZOO = ("mmda_tpu_torch.models", "mmda_tpu_torch.serving", "mmda_tpu_torch.train")
OPS = ("lstm_recurrence", "gru_recurrence", "short_attention_fwd", "flash_attention_fwd")


def _cfgs(**kw):
    return JConfig(use_pallas=False, **{**KW, **kw}), Config(device="cpu", **{**KW, **kw})


def _tree(jcfg, seed, bert=False):
    init_fn, _ = jget_model("MISA")
    tree = init_fn(jax.random.PRNGKey(seed), jcfg,
                   bert_cfg=jbert.BertConfig.tiny(vocab_size=64) if bert else None)
    return jax.tree_util.tree_map(np.asarray, tree)


def _req(L):
    return {
        "text": RNG.integers(2, 64, size=L).astype(np.int32),
        "visual": RNG.normal(size=(L, 5)).astype(np.float32),
        "acoustic": RNG.normal(size=(L, 6)).astype(np.float32),
        "bert_ids": RNG.integers(3, 64, size=L + 2).astype(np.int32),
        "bert_type": np.zeros(L + 2, np.int32),
        "bert_mask": np.ones(L + 2, np.int32),
    }


def _same(got, want, n, keys=("scores", "tcp"), **tol):
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want[k])[:n], err_msg=k, **tol)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """MISA (GloVe towers) exported from a JAX tree, the live Predictors of
    both packages on that tree."""
    jcfg, cfg = _cfgs()
    tree = _tree(jcfg, 0)
    out = tmp_path_factory.mktemp("artifact")
    manifest = export_model(cfg, tree, str(out), max_batch=8)
    live = Predictor(cfg, params=tree, max_batch=8)
    jlive = JPredictor(jcfg, params=tree, max_batch=8)
    return out, manifest, cfg, live, jlive


def test_export_roundtrip_matches_live_predictor(artifact):
    out, manifest, _, live, jlive = artifact
    assert manifest["bucket_sizes"] == [4, 8] and manifest["format"] == FORMAT
    assert (out / "bucket_4.pt2").exists() and (out / "bucket_8.pt2").exists()
    exported = ExportedPredictor(str(out), device="cpu")
    for reqs in ([_req(3)], [_req(2), _req(7), _req(4)]):
        got = exported(reqs)
        n = len(reqs)
        assert set(got) == {"scores", "labels", "tcp", "hidden"}
        _same(got, live(reqs), n, ("scores", "labels", "tcp", "hidden"), **LIVE)
        _same(got, jlive(reqs), n, **JAX_TOL)


def test_export_artifact_is_loadable_standalone(artifact):
    """A fresh interpreter loads the artifact and serves finite scores
    without importing the zoo, the live serving module or the trainer."""
    out = artifact[0]
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        from mmda_tpu_torch.serving_export import ExportedPredictor
        pred = ExportedPredictor({str(out)!r}, device="cpu")
        L = 5
        rng = np.random.default_rng(0)
        out = pred([{{"text": rng.integers(2, 64, size=L).astype(np.int32),
                     "visual": rng.normal(size=(L, 5)).astype(np.float32),
                     "acoustic": rng.normal(size=(L, 6)).astype(np.float32)}}])
        zoo = [m for m in sys.modules if any(m == z or m.startswith(z + ".") for z in {ZOO!r})]
        print(json.dumps({{"shape": list(out["scores"].shape),
                          "finite": bool(np.isfinite(out["scores"]).all()), "zoo": zoo}}))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == {"shape": [1, 6], "finite": True, "zoo": []}
    with open(out / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["format"] == "torch.export/pt2" and manifest["device"] == "cpu"
    for key in ("model", "num_classes", "task", "max_batch", "bucket_sizes", "visual_size",
                "acoustic_size", "use_bert", "weights_dtype", "torch", "output_widths"):
        assert key in manifest, key


def test_export_cli_end_to_end(tmp_path):
    """cli.train -> cli.export -> ExportedPredictor through the on-disk
    contract; the artifact equals a live Predictor on the same checkpoint."""
    from mmda_tpu_torch.cli import export as export_cli
    from mmda_tpu_torch.cli import train as train_cli

    common = ["--device", "cpu", "--data", "synthetic", "--use_bert", "False",
              "--batch_size", "64", "--hidden_size", "16", "--embedding_size", "8",
              "--max_seq_len", "8", "--bucket_sizes", "8", "--name", "exp_e2e",
              "--ckpt_dir", str(tmp_path / "ckpt")]
    train_cli.main(common + ["--n_epoch", "1"])
    manifest = export_cli.main(common + ["--export_dir", str(tmp_path / "artifact")])
    assert manifest["max_batch"] == 64 and manifest["bucket_sizes"] == [8]
    pred = ExportedPredictor(str(tmp_path / "artifact"), device="cpu")
    reqs = [{"text": RNG.integers(2, 2048, size=L).astype(np.int32),
             "visual": RNG.normal(size=(L, 35)).astype(np.float32),
             "acoustic": RNG.normal(size=(L, 74)).astype(np.float32)} for L in (3, 6)]
    out = pred(reqs)
    assert out["scores"].shape == (2, 6) and np.isfinite(out["scores"]).all()
    cfg = Config(device="cpu", data="synthetic", use_bert=False, hidden_size=16,
                 embedding_size=8, max_seq_len=8, bucket_sizes=(8,), batch_size=64,
                 name="exp_e2e", ckpt_dir=str(tmp_path / "ckpt"))
    live = Predictor(cfg, visual_size=35, acoustic_size=74, vocab_size=2048, max_batch=64)
    _same(out, live(reqs), 2, **LIVE)


def test_http_serving_from_export_artifact(artifact):
    """export -> the HTTP server fronting the ExportedPredictor -> POST
    /predict (the live Predictor's scores) and GET /healthz (its stats and
    the kernel launches)."""
    from mmda_tpu_torch.cli.serve import serve

    out, _, cfg, live, _ = artifact
    pred = ExportedPredictor(str(out), device="cpu")
    ready = threading.Event()
    httpd, psrv = serve(cfg, port=0, predictor=pred, ready_event=ready, warmup=True)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    ready.wait(30)
    try:
        url = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
        r = _req(4)
        payload = json.dumps({k: np.asarray(v).tolist() for k, v in r.items()}).encode()
        req = urllib.request.Request(url + "/predict", data=payload,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            got = json.loads(resp.read())
        np.testing.assert_allclose(np.asarray(got["scores"]), live([r])["scores"][0], **LIVE)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["stats"]["requests"] >= 1
        assert set(health["kernel_launches"]) >= {"lstm_fwd", "short_attn_fwd"}
    finally:
        httpd.shutdown()
        psrv.close()
        thread.join(timeout=30)


def test_export_raw_text_roundtrip(tmp_path):
    """The artifact bakes in the WordPiece vocab and word2id: raw-text
    requests give the live Predictor's scores (the JAX one's at 1e-4), and
    an artifact exported without a tokenizer refuses raw text."""
    jcfg, cfg = _cfgs()
    tree = _tree(jcfg, 3)
    vocab = {w: i for i, w in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "maybe", "##ly"])}
    tok = WordPieceTokenizer(vocab)
    word2id = {"hello": 5, "world": 9, "maybe": 11}
    export_model(cfg, tree, str(tmp_path), max_batch=8, tokenizer=tok, word2id=word2id)
    assert (tmp_path / "bert_vocab.json").exists() and (tmp_path / "word2id.json").exists()
    live = Predictor(cfg, params=tree, max_batch=8, tokenizer=tok, word2id=word2id)
    jlive = JPredictor(jcfg, params=tree, max_batch=8, tokenizer=JTokenizer(vocab),
                       word2id=word2id)
    exported = ExportedPredictor(str(tmp_path), device="cpu")
    reqs = [{"text": "hello world"}, {"text": "maybe unseen"}, {"text": ""}]
    got = exported(reqs)
    _same(got, live(reqs), 3, **LIVE)
    _same(got, jlive(reqs), 3, **JAX_TOL)

    bare = tmp_path / "bare"
    export_model(cfg, tree, str(bare), max_batch=8)
    with pytest.raises(ValueError, match="tokenizer"):
        ExportedPredictor(str(bare), device="cpu")([{"text": "hello"}])


# (name, Config options, tiny BERT): the towers' cell and the attention core;
# the ops each bucket program must call
PROGRAMS = [
    ("lstm", {}, False, {"lstm_recurrence"}),
    ("gru", {"rnncell": "gru"}, False, {"gru_recurrence"}),
    ("bert-fused", {"use_bert": True, "attn_impl": "fused"}, True,
     {"lstm_recurrence", "short_attention_fwd"}),
    ("bert-flash", {"use_bert": True, "attn_impl": "flash"}, True,
     {"lstm_recurrence", "flash_attention_fwd"}),
]


def _count_calls(monkeypatch, pred, reqs):
    """How often a live call calls each op's wrapper."""
    calls = Counter()
    for module, name in ((klstm, "lstm_recurrence_op"), (kgru, "gru_recurrence_op"),
                         (kshort, "short_attention_fwd_op"),
                         (kattn, "flash_attention_fwd_op")):
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name[:-3], **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(module, name, spy)
    pred(reqs)
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("name,options,bert,ops", PROGRAMS, ids=[p[0] for p in PROGRAMS])
def test_bucket_programs_call_the_kernel_ops(tmp_path, monkeypatch, name, options, bert, ops):
    """Each bucket's program holds one `torch.ops.mmda_tpu_torch.*` node per
    wrapper call of a live call, of exactly the expected ops, and no
    recurrence unrolled over time (its sigmoid count does not grow with T)."""
    jcfg, cfg = _cfgs(**options)
    tree = _tree(jcfg, 4, bert)
    bert_cfg = BertConfig.tiny(vocab_size=64) if bert else None
    export_model(cfg, tree, str(tmp_path), bert_cfg=bert_cfg, max_batch=8)
    live = Predictor(cfg, params=tree, bert_cfg=bert_cfg, max_batch=8)
    sigmoids = []
    for t in (4, 8):
        program = torch.export.load(str(tmp_path / f"bucket_{t}.pt2"))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        nodes = Counter(s.split(".")[1] for s in targets if s.startswith("mmda_tpu_torch."))
        assert set(nodes) == ops
        assert nodes == _count_calls(monkeypatch, live, [_req(t)])
        sigmoids.append(sum("sigmoid" in s for s in targets))
    assert sigmoids[0] == sigmoids[1]
    exported = ExportedPredictor(str(tmp_path), device="cpu")
    reqs = [_req(2), _req(8)]
    _same(exported(reqs), live(reqs), 2, ("scores", "labels", "tcp", "hidden"), **LIVE)


def _op_inputs(name):
    g = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    T, B, H = 5, 3, 4
    mask = (torch.rand(T, B, generator=g) > 0.3).float()
    if name == "lstm_recurrence":
        return [(rand(T, B, 4 * H), rand(H, 4 * H), mask, rev, cs)
                for rev, cs in ((False, False), (True, True))]
    if name == "gru_recurrence":
        return [(rand(T, B, 3 * H), rand(H, 3 * H), rand(3 * H), mask, rev)
                for rev in (False, True)]
    seed = torch.tensor([7], dtype=torch.int32)
    if name == "short_attention_fwd":
        q = [rand(2, 2, 6, 8, dtype=dt) for dt in (torch.float32, torch.bfloat16)]
        return [(x, x.clone(), x.clone(), rand(2, 6), s, r)
                for x in q for s, r in ((None, 0.0), (seed, 0.1))]
    q = [rand(4, 6, 16, dtype=dt) for dt in (torch.float32, torch.bfloat16)]
    return [(x, x.clone(), x.clone(), rand(4, 6), s, r)
            for x in q for s, r in ((None, 0.0), (seed, 0.1))]


@pytest.mark.parametrize("name", OPS)
def test_kernel_ops_pass_opcheck(name):
    """`torch.library.opcheck` (schema, fake implementation, autograd
    registration, AOT dispatch) on CPU tensors, each argument combination;
    the op's result equals its wrapper's."""
    op = getattr(torch.ops.mmda_tpu_torch, name)
    for args in _op_inputs(name):
        torch.library.opcheck(op.default, args)
    module = {"lstm_recurrence": klstm, "gru_recurrence": kgru,
              "short_attention_fwd": kshort, "flash_attention_fwd": kattn}[name]
    args = _op_inputs(name)[-1]
    got, want = op(*args), getattr(module, name)(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert b is not None and torch.equal(a, b)


@pytest.mark.parametrize("case", ["gru", "int8"])
def test_gru_and_int8_round_trips(tmp_path, case):
    """A GRU-tower artifact, and an int8 one (weights_dtype="int8": a tiny
    BERT's encoder denses quantized as Predictor(bert_weights_dtype="int8")
    does) against the live Predictor, and the JAX one at 1e-4."""
    options = {"rnncell": "gru"} if case == "gru" else {"use_bert": True}
    bert = case == "int8"
    dtype = "int8" if bert else None
    jcfg, cfg = _cfgs(**options)
    tree = _tree(jcfg, 6, bert)
    bert_cfg = BertConfig.tiny(vocab_size=64) if bert else None
    manifest = export_model(cfg, tree, str(tmp_path), bert_cfg=bert_cfg, max_batch=8,
                            weights_dtype=dtype)
    assert manifest["weights_dtype"] == dtype
    live = Predictor(cfg, params=tree, bert_cfg=bert_cfg, max_batch=8,
                     bert_weights_dtype=dtype)
    jlive = JPredictor(jcfg, params=tree, bert_cfg=jbert.BertConfig.tiny(vocab_size=64)
                       if bert else None, max_batch=8, bert_weights_dtype=dtype)
    exported = ExportedPredictor(str(tmp_path), device="cpu")
    if bert:
        program = torch.export.load(str(tmp_path / "bucket_8.pt2"))
        assert any(v.dtype == torch.int8 for v in program.state_dict.values())
    reqs = [_req(3), _req(8), _req(1)]
    got = exported(reqs)
    _same(got, live(reqs), 3, ("scores", "labels", "tcp", "hidden"), **LIVE)
    _same(got, jlive(reqs), 3, **JAX_TOL)


def test_artifact_for_another_device_raises(artifact, tmp_path):
    """An artifact serves only on the device type it was exported for: asked
    for another, the loader raises a ValueError naming both, before it loads
    a program."""
    out = artifact[0]
    with pytest.raises(ValueError, match="exported for cpu.*not on cuda"):
        ExportedPredictor(str(out), device="cuda")
    moved = tmp_path / "moved"
    moved.mkdir()
    manifest = json.loads((out / "manifest.json").read_text())
    (moved / "manifest.json").write_text(json.dumps({**manifest, "device": "cuda"}))
    with pytest.raises(ValueError, match="exported for cuda.*not on cpu"):
        ExportedPredictor(str(moved), device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        ExportedPredictor(str(out), overflow="drop", device="cpu")
