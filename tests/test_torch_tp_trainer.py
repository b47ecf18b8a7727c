"""Tensor parallelism end to end on the CPU: the `Trainer` on a (1, 2) mesh
of gloo ranks (`tests/dp_workers.py`) against the one-process Trainer, its
best export read whole by the JAX package and its `last_*` snapshot resumed
at tp = 1, `cli.train` and `cli.serve --tp_size 2` under torchrun, and
`Predictor(mesh=)` on a (2, 2) mesh against the one-process Predictor.

The tiny BERT of tests/test_torch_tp.py (H = 32, nh = 4, 2 layers), f32,
dropout off in the trainer's runs.  Tolerances: the trainer's losses and
metrics at 1e-3 relative, as tests/test_torch_dp_trainer.py holds the
data-parallel Trainer (a run parts further than one step); the Predictor
at 1e-4, as tests/test_torch_serving.py holds it.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch
import jax

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import misa as jmisa
from mmda_tpu.train import checkpoint as jckpt

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import jax_name
from mmda_tpu_torch.data import synthetic as psynth
from mmda_tpu_torch.serving import Predictor
from mmda_tpu_torch.train.loop import Trainer

import dp_workers

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
RUN_TOL = dict(rtol=1e-3, atol=1e-4)
JBERT = jbert.BertConfig(**dataclasses.asdict(dp_workers.tp_bert_cfg()))


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


def _jax_template(kw, data, bert_cfg):
    """The JAX parameter tree of the Trainer's model for `data`: the
    template the JAX package's `load_checkpoint` checks an export's shapes
    and dtypes against."""
    skip = ("device", "log_sinks", "ckpt_dir", "dp_size", "tp_size", "name", "n_epoch")
    train = data["train"]
    return jmisa.init_misa_params(jax.random.PRNGKey(0), JConfig(
        use_pallas=False, **{k: v for k, v in kw.items() if k not in skip},
        visual_size=train["visual"].shape[-1], acoustic_size=train["acoustic"].shape[-1],
        vocab_size=int(train["text"].max()) + 1), bert_cfg=bert_cfg)


def test_trainer_at_tp_2_exports_the_full_layout_and_resumes_at_tp_1(tmp_path):
    """`Trainer.train()` on a (1, 2) mesh for one epoch: the summary
    matches the one-process Trainer's; the best export holds every leaf in
    the full layout, which the JAX package's `load_checkpoint` reads with
    the shapes of its own tree and the values of the ranks' gathered
    parameters; the `last_*` snapshot written at tp = 2 resumes in a
    one-process Trainer (tp = 1) to those same parameters."""
    data = psynth.make_dataset(8, 16, 16, max_len=8, seed=0, bert_vocab_size=128)
    kw = dict(device="cpu", use_bert=True, data="mosei", hidden_size=16, embedding_size=8,
              batch_size=8, max_seq_len=8, bucket_sizes=(8,), n_epoch=1, learning_rate=1e-3,
              log_sinks=(), name="tp", seed=1)
    ranks = dp_workers.run_ranks(dp_workers.tp_trainer_worker, 2, tmp_path, 2,
                                 dict(kw, ckpt_dir=str(tmp_path / "tp"), dp_size=1, tp_size=2),
                                 data)
    one = Trainer(Config(**kw, ckpt_dir=str(tmp_path / "one")), data,
                  bert_cfg=dp_workers.tp_bert_cfg())
    model = one.model
    model.train = lambda mode=True: torch.nn.Module.train(model, False)
    want = one.train()
    for r in ranks:
        for k in ("test_loss", "best_valid_loss"):
            np.testing.assert_allclose(r["summary"][k], want[k], err_msg=k, **RUN_TOL)
        assert r["summary"]["best_epoch"] == want["best_epoch"] == 0
        for n, p in r["params"].items():
            assert torch.equal(p, ranks[0]["params"][n]), n
    got = ranks[0]["params"]
    tree = jckpt.load_checkpoint(str(tmp_path / "tp"), "best_model_MISA_mosei",
                                 _jax_template(kw, data, JBERT))
    for n, p in got.items():
        path = jax_name(model, n)
        mine = p.numpy()
        np.testing.assert_array_equal(mine.T if path.endswith(".kernel") else mine,
                                      np.asarray(_leaf(tree, path)), err_msg=path)
    resumed = Trainer(Config(**{**kw, "resume": True}, ckpt_dir=str(tmp_path / "tp")), data,
                      bert_cfg=dp_workers.tp_bert_cfg())
    assert resumed.step == ranks[0]["step"] == 1       # 8 rows, batch 8
    for n, p in resumed.model.named_parameters():
        assert torch.equal(p.detach(), got[n]), n


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_train_and_serve_cli_at_tp_2_under_torchrun(tmp_path):
    """`torchrun --nproc_per_node 2 -m mmda_tpu_torch.cli.train --device cpu
    --dp_size 1 --tp_size 2` (the GloVe configuration: no encoder to shard,
    each rank of the 'model' row the same model): trains, writes the best
    export and the snapshot once (rank 0 alone prints), and the JAX
    package's `load_checkpoint` reads the export; then `cli.serve` with the
    same flags under torchrun (rank 0's HTTP front end, rank 1 making its
    calls) scores a request as the one-process `Predictor` does."""
    flags = ["--device", "cpu", "--dp_size", "1", "--tp_size", "2", "--data", "synthetic",
             "--use_bert", "False", "--hidden_size", "16", "--embedding_size", "8",
             "--max_seq_len", "16", "--ckpt_dir", str(tmp_path)]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([*run, "mmda_tpu_torch.cli.train", *flags, "--batch_size", "64",
                          "--n_epoch", "1", "--name", "cli"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("Best epoch:") == 1
    summary = json.loads((tmp_path / "summary_cli.json").read_text())
    assert np.isfinite(summary["test_loss"])
    from mmda_tpu_torch.cli.train import load_data

    cfg = Config(device="cpu", data="synthetic", use_bert=False, hidden_size=16,
                 embedding_size=8, max_seq_len=16)
    template = _jax_template(dict(data="synthetic", use_bert=False, hidden_size=16,
                                  embedding_size=8, max_seq_len=16), load_data(cfg)[0], None)
    tree = jckpt.load_checkpoint(str(tmp_path), "best_model_MISA_synthetic", template)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(tree))

    port = _free_port()
    sizes = ["--vocab_size", str(template["embed"].shape[0])]
    server = subprocess.Popen([*run, "mmda_tpu_torch.cli.serve", *flags, *sizes, "--port",
                               str(port)], cwd=root, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
    try:
        end = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5).read()
                break
            except OSError:
                assert server.poll() is None, server.stderr.read()[-3000:]
                assert time.monotonic() < end, "cli.serve did not start"
                time.sleep(1)
        rng = np.random.default_rng(0)
        req = {"text": rng.integers(0, 100, size=5), "visual": rng.normal(size=(5, 35)),
               "acoustic": rng.normal(size=(5, 74))}
        got = [_post(f"http://127.0.0.1:{port}/predict", {k: v.tolist() for k, v in
                                                          req.items()}) for _ in range(2)]
    finally:
        server.send_signal(signal.SIGINT)
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    one = Predictor(cfg.replace(vocab_size=template["embed"].shape[0], ckpt_dir=str(tmp_path)))
    want = one([{"text": req["text"].astype(np.int32),
                 "visual": req["visual"].astype(np.float32),
                 "acoustic": req["acoustic"].astype(np.float32)}])
    for g in got:
        np.testing.assert_allclose(g["scores"], want["scores"][0], **TOL)
    assert (tmp_path / "last_cli.msgpack").exists()


PRED_KW = dict(device="cpu", hidden_size=16, visual_size=5, acoustic_size=7, vocab_size=40,
               embedding_size=6, bucket_sizes=(4, 8), max_seq_len=8, use_cmd_sim=False)
VARIANTS = [("float32", None), ("float32", "int8"), ("bfloat16", None), ("bfloat16", "int8")]


def test_predictor_on_a_2x2_mesh(tmp_path):
    """`Predictor(mesh=)` on (dp, tp) = (2, 2): each rank its 3 rows of the
    padded batch through the Megatron-sharded encoder, the outputs gathered
    over 'data'; every rank returns the one-process Predictor's outputs, in
    f32 and bf16 compute, with the loaded weights and with int8 encoder
    denses."""
    tree = jax.tree_util.tree_map(np.asarray, jmisa.init_misa_params(
        jax.random.PRNGKey(0), JConfig(use_pallas=False, **{
            k: v for k, v in PRED_KW.items() if k != "device"}), bert_cfg=JBERT))
    rng = np.random.default_rng(5)
    reqs = [{"text": rng.integers(0, 40, size=L).astype(np.int32),
             "visual": rng.normal(size=(L, 5)).astype(np.float32),
             "acoustic": rng.normal(size=(L, 7)).astype(np.float32),
             "bert_ids": rng.integers(1, 128, size=L + 2).astype(np.int32),
             "bert_type": np.zeros(L + 2, np.int32), "bert_mask": np.ones(L + 2, np.int32)}
            for L in (3, 7, 2, 5, 8)]
    variants = [(dict(PRED_KW, compute_dtype=dt), dict(max_batch=6, bert_weights_dtype=w))
                for dt, w in VARIANTS]
    ranks = dp_workers.run_ranks(dp_workers.tp_predictor_worker, 4, tmp_path, 2, variants,
                                 tree, reqs)
    for i, (kw, options) in enumerate(variants):
        want = Predictor(Config(**kw), params=tree, bert_cfg=dp_workers.tp_bert_cfg(),
                         **options)(reqs)
        for r in ranks:
            got = r[i]
            assert set(got) == set(want) == {"scores", "labels", "tcp", "hidden"}
            for k in want:
                assert got[k].shape == want[k].shape
                np.testing.assert_allclose(got[k], want[k], err_msg=f"{VARIANTS[i]} {k}",
                                           **TOL)
