"""Data parallelism end to end on the CPU: the `Trainer` on 2 gloo ranks
(`tests/dp_workers.py`) against the one-process Trainer, `cli.train` under
torchrun, and `Predictor(mesh=)` against the one-process Predictor and the
JAX package's Predictor on a (2, 1) mesh.

The trainer's runs have dropout off (both sides run their deterministic
forward), so that the two-rank run and the one-process run take the same
steps.  Tolerance: one step is held to the one-process step at 1e-4 in
tests/test_torch_dp.py; over several steps the two trajectories part
further, since Adam turns gradient components that are zero but for
rounding (the attention key bias: a softmax does not see it) into updates
of +-lr, and an input of a ReLU near 0 can take the other branch.  So the
trainer's runs take one step an epoch, and their losses, grad_norm and test
metrics are held at 1e-3 relative (the largest difference seen was 3e-4);
the Predictor at 1e-4 as in tests/test_torch_serving.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import misa as jmisa
from mmda_tpu.parallel import mesh as jmesh
from mmda_tpu.serving import Predictor as JPredictor

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.data import synthetic as psynth
from mmda_tpu_torch.models.bert import BertConfig
from mmda_tpu_torch.serving import Predictor

import dp_workers

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
RUN_TOL = dict(rtol=1e-3, atol=1e-4)
CONTINUOUS = ("train_loss", "valid_loss", "train_cls", "train_diff", "train_sim",
              "train_recon", "train_conf", "train_grad_norm")


def _trainer_kw(ckpt_dir, **kw):
    return dict(dict(device="cpu", use_bert=True, data="mosei", hidden_size=16,
                     embedding_size=8, batch_size=8, max_seq_len=8, bucket_sizes=(8,),
                     n_epoch=2, learning_rate=1e-3, use_confidNet=True, fix_conf_loss=True,
                     log_sinks=(), ckpt_dir=str(ckpt_dir), name="dp", seed=1), **kw)


def _same_summary(got, want):
    for run in ("first", "resumed"):
        g, w = got[run], want[run]
        assert g["best_epoch"] == w["best_epoch"]
        assert len(g["history"]) == len(w["history"])
        for hg, hw in zip(g["history"], w["history"]):
            for k in CONTINUOUS:
                np.testing.assert_allclose(hg[k], hw[k], err_msg=f"{run} {k}", **RUN_TOL)
        keys = [k for k in w if k.startswith(("test_", "conf_", "best_valid"))]
        assert keys and set(keys) <= set(g)
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{run} {k}", **RUN_TOL)


def test_trainer_on_two_ranks_is_the_one_process_trainer(tmp_path):
    """`Trainer.train()` at dp = 2 (the captured-epoch body on the CPU) for
    2 epochs, then a Trainer resumed from its `last_*` snapshot for a third,
    on both ranks: the history's losses and grad_norm, the best epoch, the
    test loss and metrics and the ConfidNet metrics match the one-process
    run's (the eager epoch); both ranks hold the same parameters; rank 0
    writes what the one-process run writes (each best export and snapshot
    once) and rank 1 nothing; both ranks resume at the same step as the
    one-process run."""
    data = psynth.make_dataset(8, 16, 16, max_len=8, seed=0, bert_vocab_size=128)
    ranks = dp_workers.run_ranks(dp_workers.trainer_worker, 2, tmp_path,
                                 _trainer_kw(tmp_path / "dp", compiled_epoch=True), data)
    want = dp_workers.train_sequence(Config(**_trainer_kw(tmp_path / "one")), data)
    for r in ranks:
        _same_summary(r, want)
        for n, p in r["resumed_params"].items():
            assert torch.equal(p, ranks[0]["resumed_params"][n]), n
        assert r["resumed_start_step"] == want["resumed_start_step"] == 2
    assert ranks[0]["writes"] == want["writes"] and ranks[1]["writes"] == []
    names = [n for _, n in want["writes"]]
    assert "best_model_MISA_C_mosei" in names and "last_dp" in names
    for f in ("best_model_MISA_C_mosei.msgpack", "last_dp.inc.msgpack", "dp_config.json"):
        assert (tmp_path / "dp" / f).exists(), f


def test_train_cli_under_torchrun_on_two_cpu_ranks(tmp_path):
    """`torchrun --nproc_per_node 2 -m mmda_tpu_torch.cli.train --device cpu
    --dp_size 2`: trains, evaluates and writes the best export, the
    `last_*` snapshot and the summary once (rank 0 alone prints); then
    `--resume True` carries on from the snapshot on both ranks."""
    args = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "mmda_tpu_torch.cli.train", "--device", "cpu",
            "--dp_size", "2", "--data", "synthetic", "--use_bert", "False", "--hidden_size",
            "16", "--embedding_size", "8", "--max_seq_len", "16", "--batch_size", "32",
            "--ckpt_dir", str(tmp_path), "--name", "cli"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = []
    for extra in (["--n_epoch", "1"], ["--n_epoch", "2", "--resume", "True"]):
        out = subprocess.run(args + extra, cwd=root, env=env, capture_output=True, text=True,
                             timeout=240)
        assert out.returncode == 0, out.stderr[-3000:]
        outs.append(out.stdout)
    assert all(o.count("Best epoch:") == 1 for o in outs)
    assert "resumed_at_step" not in outs[0] and outs[1].count("resumed_at_step") == 1
    summary = json.loads((tmp_path / "summary_cli.json").read_text())
    assert np.isfinite(summary["test_loss"]) and summary["best_epoch"] in (0, 1)
    for f in ("best_model_MISA_synthetic.msgpack", "last_cli.msgpack"):
        assert (tmp_path / f).exists(), f


PRED_KW = dict(hidden_size=16, visual_size=5, acoustic_size=7, vocab_size=40, embedding_size=6,
               compute_dtype="float32", bucket_sizes=(4, 8), max_seq_len=8, use_cmd_sim=False)
SIZES = dict(bert_cfg=BertConfig.tiny(), max_batch=6, device="cpu")


def test_predictor_on_a_mesh_of_two(tmp_path):
    """`Predictor(mesh=)` at dp = 2 (each rank its 3 rows of the padded
    batch, the outputs gathered): every rank returns the one-process
    Predictor's outputs, and the JAX Predictor's on `make_mesh(2, 1)`;
    max_batch must divide by dp."""
    tree = jax.tree_util.tree_map(np.asarray, jmisa.init_misa_params(
        jax.random.PRNGKey(0), JConfig(use_pallas=False, **PRED_KW),
        bert_cfg=jbert.BertConfig.tiny()))
    rng = np.random.default_rng(5)
    reqs = [{"text": rng.integers(0, 40, size=L).astype(np.int32),
             "visual": rng.normal(size=(L, 5)).astype(np.float32),
             "acoustic": rng.normal(size=(L, 7)).astype(np.float32),
             "bert_ids": rng.integers(1, 128, size=L + 2).astype(np.int32),
             "bert_type": np.zeros(L + 2, np.int32), "bert_mask": np.ones(L + 2, np.int32)}
            for L in (3, 7, 2, 5, 8)]
    ranks = dp_workers.run_ranks(dp_workers.predictor_worker, 2, tmp_path,
                                 dict(device="cpu", **PRED_KW), tree, reqs, SIZES)
    one = Predictor(Config(device="cpu", **PRED_KW), params=tree, **SIZES)
    jpred = JPredictor(JConfig(use_pallas=False, **PRED_KW),
                       params=jax.tree_util.tree_map(jnp.asarray, tree),
                       bert_cfg=jbert.BertConfig.tiny(), max_batch=6,
                       mesh=jmesh.make_mesh(2, 1, devices=jax.devices()[:2]))
    for calls in ranks:
        for got, batch in zip(calls, (reqs, reqs[:3])):
            want, jwant = one(batch), jpred(batch)
            assert set(got) == set(want) == {"scores", "labels", "tcp", "hidden"}
            for k in want:
                assert got[k].shape == want[k].shape == (len(batch), want[k].shape[1])
                np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
                np.testing.assert_allclose(got[k], np.asarray(jwant[k]), err_msg=k, **TOL)
    from mmda_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="max_batch=5 must be divisible"):
        Predictor(Config(device="cpu", **PRED_KW), params=tree,
                  mesh=Mesh(dp=2, rank=0, device=torch.device("cpu")),
                  **{**SIZES, "max_batch": 5})
