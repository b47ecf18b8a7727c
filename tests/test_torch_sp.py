"""Sequence parallelism on the ('data', 'model') mesh, on the CPU: the
sharded BERT with its LayerNorm regions on each rank's S-shard
(`parallel/sequence.py`), on gloo ranks (`tests/dp_workers.py`) against the
JAX package: its unsharded `bert_encode` and `jax.grad` (its own SP test
holds SP exact), its `sequence_sharded_bert` on a (dp, 2) mesh of the faked
CPU devices, and its SP training step; against the port's one-process step
with dropout on; a MAG_BERT forward; the Trainer and `cli.train` under
torchrun; the refusals.

The tiny BERT of tests/test_torch_tp.py (H = 32, nh = 4, 2 layers), f32,
at S = 12 and at S = 13, which tp = 2 does not divide (each rank 7 rows,
the last padded).  Tolerances: the forward at 1e-5 and the gradients at
2e-4 + 1e-3 |ref|, as `tests/test_sequence_parallel.py` holds the JAX
package's SP; a step at 1e-4, as tests/test_torch_tp.py holds the TP step;
the Trainer's runs at 1e-3 relative, as tests/test_torch_tp_trainer.py.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import get_model as jget_model
from mmda_tpu.models import misa as jmisa
from mmda_tpu.parallel import mesh as jmesh
from mmda_tpu.parallel import sequence as jsq
from mmda_tpu.train import checkpoint as jckpt

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import jax_name, load_jax_params
from mmda_tpu_torch.data import synthetic as psynth
from mmda_tpu_torch.models import MISA, get_model
from mmda_tpu_torch.models.bert import BertEncoder
from mmda_tpu_torch.parallel import mesh as pmesh
from mmda_tpu_torch.parallel.sequence import sequence_rows, shard_sequence
from mmda_tpu_torch.train.loop import Trainer

import dp_workers
from test_torch_tp import (DROPOUT_KW, SMALL, TOL, _arrays, _jax_tp_step, _jax_tree, _leaf,
                           _one_process)

torch.set_num_threads(1)

FWD_TOL = dict(rtol=0.0, atol=1e-5)
RUN_TOL = dict(rtol=1e-3, atol=1e-4)
JBERT = jbert.BertConfig(**dataclasses.asdict(dp_workers.tp_bert_cfg()))
IMPLS = ("xla", "fused", "flash")
SEQ = (12, 13)                        # 13: tp = 2 does not divide it
SP_KW = dict(tp_size=2, sp=True)
MAG = dict(SMALL, model="MAG_BERT", use_confidNet=False)


def _ids_and_mask(S, B=8, seed=0):
    rng = np.random.default_rng(seed + S)
    ids = rng.integers(1, 128, size=(B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    for b in range(B):
        mask[b, S - 1 - (b * 3) % 5:] = 0
    return ids, mask


def _bert_tree(seed=3):
    return jax.tree_util.tree_map(np.asarray, jbert.init_bert_params(jax.random.PRNGKey(seed),
                                                                     JBERT))


def _mag_tree():
    tree = jget_model("MAG_BERT")[0](jax.random.PRNGKey(2), JConfig(use_pallas=False, **MAG),
                                     bert_cfg=JBERT)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results of the module's cases, on a (1, 2) mesh (two
    ranks) and a (2, 2) mesh (four), both sets at once: {dp: [rank
    results]}, each a dict by case key."""
    tmp = tmp_path_factory.mktemp("sp")
    tree = _bert_tree()
    common = [dict(key=("encode", S), kind="encode", tree=tree, ids=ids, mask=mask,
                   impls=IMPLS, sp=True, grads=True)
              for S in SEQ for ids, mask in [_ids_and_mask(S)]]
    step_kw = dict(SMALL, use_cmd_sim=True, **SP_KW)
    four = common + [dict(key="step", kind="step", cfg=step_kw, tree=_jax_tree(step_kw),
                          arrays=_arrays(8, seed=3), frozen=0)]
    two = common + [
        dict(key=("dropout", options["attn_impl"]), kind="step",
             cfg=dict(SMALL, **SP_KW, **options), tree=_jax_tree(SMALL, seed=5),
             arrays=_arrays(8, T=7, seed=4), dropout=True, frozen=0)
        for options in DROPOUT_KW] + [
        dict(key=("mag", layer), kind="model", cfg=dict(MAG, mag_inject_layer=layer, **SP_KW),
             tree=_mag_tree(), arrays=_arrays(4, T=7, seed=6)) for layer in (0, 2)] + [
        dict(key="trainer", kind="trainer", cfg=dict(TRAINER_KW, ckpt_dir=str(tmp / "tp"),
                                                     dp_size=1, **SP_KW),
             data=_trainer_data())]
    sets = []
    for world, cases in ((2, two), (4, four)):
        path = tmp / f"cases{world}.pkl"
        with open(path, "wb") as f:
            pickle.dump(cases, f)
        sets.append((dp_workers.mesh_worker, world, (2, str(path))))
    results = dp_workers.run_rank_sets(sets, tmp, deadline_s=240.0)
    return {1: results[0], 2: results[1], "tmp": tmp}


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's unsharded forward and `jax.grad` of the global batch's
    mean(hidden^2) at each S, and its forward under `sequence_sharded_bert`
    on make_mesh(dp, 2) (f32)."""
    tree = jax.tree_util.tree_map(jnp.asarray, _bert_tree())
    refs = {}
    for S in SEQ:
        ids, mask = (jnp.asarray(a, jnp.int32) for a in _ids_and_mask(S))

        def loss(p, ids=ids, mask=mask):
            out = jbert.bert_encode(p, JBERT, ids, mask, compute_dtype=jnp.float32)
            return (out ** 2).mean(), out

        (_, out), grads = jax.value_and_grad(loss, has_aux=True)(tree)
        sharded = {}
        for dp in (1, 2):
            mesh = jmesh.make_mesh(dp, 2, devices=jax.devices()[:dp * 2])
            params = jmesh.shard_params({"bert": tree}, mesh, tp=True)["bert"]
            s_ids, s_mask = (jax.device_put(a, jmesh.batch_sharding(mesh)) for a in (ids, mask))
            with jsq.sequence_sharded_bert(mesh):
                sharded[dp] = np.asarray(jax.jit(lambda p, i, m: jbert.bert_encode(
                    p, JBERT, i, m, compute_dtype=jnp.float32))(params, s_ids, s_mask))
        refs[S] = (np.asarray(out), jax.tree_util.tree_map(np.asarray, grads), sharded)
    return refs


# ------------------------------------------------------------ the encoder


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("S", SEQ)
@pytest.mark.parametrize("dp", [1, 2])
def test_sp_forward_and_grads_match_jax(runs, jax_refs, dp, S, impl):
    """Each rank's rows of the SP forward (the dense, fused and flash cores,
    2 of 4 heads a rank) against JAX's unsharded `bert_encode` and its
    `sequence_sharded_bert` forward on make_mesh(dp, 2); the gradient of
    the global batch's mean(hidden^2), summed over 'data' and gathered into
    the full layout, against `jax.grad` leaf by leaf: the embeddings, both
    LayerNorms and the row-parallel biases of each layer summed over
    'model' as much as the sharded leaves; the ranks of a 'model' row agree
    bit for bit."""
    want, grads, sharded = jax_refs[S]
    ranks = runs[dp]
    checked = 0
    for r in ranks:
        got = r[("encode", S)][impl]
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["out"].numpy(), want[lo:hi], err_msg=impl, **FWD_TOL)
        np.testing.assert_allclose(got["out"].numpy(), sharded[dp][lo:hi], err_msg=impl,
                                   **FWD_TOL)
        for path, g in got["grads"].items():
            ref = np.asarray(_leaf(grads, path))
            np.testing.assert_array_less(np.abs(g.numpy() - ref), 2e-4 + 1e-3 * np.abs(ref),
                                         err_msg=f"{impl} {path}")
            checked += 1
    assert checked == len(ranks) * len(jax.tree_util.tree_leaves(grads))
    for a, b in zip(ranks[::2], ranks[1::2]):
        assert torch.equal(a[("encode", S)][impl]["out"], b[("encode", S)][impl]["out"])


def test_sequence_rows_pad_the_last_shard():
    """S_local = ceil(S / tp), rank m's rows from m S_local: at S = 13 and
    tp = 2, 7 rows each, the last shard's seventh padding; at S = 50 and tp
    = 4, 13 rows, the last shard's last two."""
    for rank, want in ((0, (7, 0)), (1, (7, 7))):
        assert sequence_rows(13, pmesh.Mesh(dp=1, rank=rank, device=torch.device("cpu"),
                                            tp=2)) == want
    assert sequence_rows(50, pmesh.Mesh(dp=1, rank=3, device=torch.device("cpu"),
                                        tp=4)) == (13, 39)


# ------------------------------------------------------------ the step


def test_sp_step_matches_the_jax_step_and_the_one_process_step(runs):
    """At (dp, tp) = (2, 2) with sp, dropout off, encoder layer 0 frozen:
    every rank's losses (grad_norm among them: the rows' LayerNorm and bias
    gradients summed over 'model' and counted once) and gathered
    parameters against `make_train_step` on make_mesh(2, 2) under
    `sequence_sharded_bert`, and against the port's one-process step."""
    kw = dict(SMALL, use_cmd_sim=True, **SP_KW)
    tree, arrays = _jax_tree(kw), _arrays(8, seed=3)
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    with jsq.sequence_sharded_bert(mesh):
        jlosses, jparams = _jax_tp_step(kw, tree, arrays, 2, 2, 0)
    want = _one_process((kw, tree, arrays, False, 0))
    model = dp_workers._tiny_misa(Config(device="cpu", **kw), tree, dp_workers.tp_bert_cfg(),
                                  frozen=0)
    for r in runs[2]:
        got = r["step"]
        assert got["sharded"]
        for k, v in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], v, err_msg=k, **TOL)
            if k in jlosses:
                np.testing.assert_allclose(got["losses"][k], jlosses[k], err_msg=k, **TOL)
        assert got["params"].keys() == want["params"].keys()
        for n, p in want["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), err_msg=n, **TOL)
            np.testing.assert_allclose(got["grads"][n].numpy(), want["grads"][n].numpy(),
                                       err_msg=n, **TOL)
            path = jax_name(model, n)
            mine = got["params"][n].numpy()
            np.testing.assert_allclose(mine.T if path.endswith(".kernel") else mine,
                                       _leaf(jparams, path), err_msg=path, **TOL)
        assert "bert.layers.1.ffn_ln.weight" in got["params"]


@pytest.mark.parametrize("impl", [o["attn_impl"] for o in DROPOUT_KW])
def test_sp_step_with_dropout_draws_the_one_process_masks(runs, impl):
    """At tp = 2 with sp and dropout on, S = 9 (one padded row a rank), both
    ranks' step is the one-process step from the same generator seed
    (1e-4): under the fused attention kernels and the fused LayerNorm sites
    with their row layout (s0 = 0 and 5), and under the dense core with the
    hidden dropout's one-process draw, its rows kept."""
    options = next(o for o in DROPOUT_KW if o["attn_impl"] == impl)
    want = _one_process((dict(SMALL, **SP_KW, **options), _jax_tree(SMALL, seed=5),
                         _arrays(8, T=7, seed=4), True, 0))
    ranks = runs[1]
    for r in ranks:
        got = r[("dropout", impl)]
        for k, v in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], v, err_msg=f"{impl} {k}", **TOL)
        for n, p in want["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(),
                                       err_msg=f"{impl} {n}", **TOL)
    assert ranks[0][("dropout", impl)]["losses"] == ranks[1][("dropout", impl)]["losses"]


@pytest.mark.parametrize("layer", [0, 2])
def test_mag_bert_forward_under_sp(runs, layer):
    """MAG_BERT's gate on the gathered stream (inject layer 0, and 2: after
    the last layer), re-sliced after it: each rank's scores are the
    one-process model's and JAX's (1e-5)."""
    kw = dict(MAG, mag_inject_layer=layer)
    tree, arrays = _mag_tree(), _arrays(4, T=7, seed=6)
    cfg = Config(device="cpu", **kw)
    model = load_jax_params(get_model("MAG_BERT")(cfg, bert_cfg=dp_workers.tp_bert_cfg()), tree)
    from mmda_tpu_torch.data.loader import to_device

    with torch.no_grad():
        want = model.eval()(to_device(arrays, torch.device("cpu"))).scores
    jcfg = JConfig(use_pallas=False, **kw)
    jout = jget_model("MAG_BERT")[1](tree, jcfg, jmisa.Batch(**{
        k: None if v is None else jnp.asarray(v) for k, v in arrays.items()}),
        bert_cfg=JBERT, deterministic=True)
    for r in runs[1]:
        got = r[("mag", layer)]["scores"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jout.scores), **FWD_TOL)


# ------------------------------------------------------ the trainer, the CLI

TRAINER_KW = dict(device="cpu", use_bert=True, data="mosei", hidden_size=16, embedding_size=8,
                  batch_size=8, max_seq_len=7, bucket_sizes=(7,), n_epoch=1,
                  learning_rate=1e-3, log_sinks=(), name="sp", seed=1)


def _trainer_data():
    return psynth.make_dataset(16, 8, 8, max_len=7, seed=0, bert_vocab_size=128)


def _jax_template(kw, data, bert_cfg):
    skip = ("device", "log_sinks", "ckpt_dir", "dp_size", "tp_size", "name", "n_epoch", "sp")
    train = data["train"]
    return jmisa.init_misa_params(jax.random.PRNGKey(0), JConfig(
        use_pallas=False, **{k: v for k, v in kw.items() if k not in skip},
        visual_size=train["visual"].shape[-1], acoustic_size=train["acoustic"].shape[-1],
        vocab_size=int(train["text"].max()) + 1), bert_cfg=bert_cfg)


def test_trainer_with_sp_at_tp_2(runs):
    """`Trainer.train()` with sp at tp = 2 (S = 9, dropout off) for one
    epoch of two steps: the summary matches the one-process Trainer's, and
    the JAX package's `load_checkpoint` reads the best export whole, the
    ranks' gathered parameters."""
    data = _trainer_data()
    one = Trainer(Config(**TRAINER_KW, ckpt_dir=str(runs["tmp"] / "one")), data,
                  bert_cfg=dp_workers.tp_bert_cfg())
    model = one.model
    model.train = lambda mode=True: torch.nn.Module.train(model, False)
    want = one.train()
    ranks = [r["trainer"] for r in runs[1]]
    for r in ranks:
        assert r["step"] == 2
        for k in ("test_loss", "best_valid_loss"):
            np.testing.assert_allclose(r["summary"][k], want[k], err_msg=k, **RUN_TOL)
    tree = jckpt.load_checkpoint(str(runs["tmp"] / "tp"), "best_model_MISA_mosei",
                                 _jax_template(TRAINER_KW, data, JBERT))
    for n, p in ranks[0]["params"].items():
        path = jax_name(model, n)
        mine = p.numpy()
        np.testing.assert_array_equal(mine.T if path.endswith(".kernel") else mine,
                                      np.asarray(_leaf(tree, path)), err_msg=path)


def test_cli_train_with_sp_and_moe_at_tp_2_under_torchrun(tmp_path):
    """`torchrun --nproc_per_node 2 tests/tiny_bert_cli.py` (`cli.train`'s
    `main` with the tests' tiny BERT in place of bert-base) with
    `--tp_size 2 --sp True --moe_experts 4`: one epoch, rank 0 alone prints
    and writes, and its test loss is the one-process `cli.train`'s (1e-3);
    the JAX package reads the export with the experts whole."""
    flags = ["--device", "cpu", "--data", "synthetic", "--hidden_size", "16",
             "--embedding_size", "8", "--max_seq_len", "7", "--batch_size", "16",
             "--n_epoch", "1", "--moe_experts", "4", "--fused_ln_dropout", "True"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    script = os.path.join(root, "tests", "tiny_bert_cli.py")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", script, *flags, "--dp_size", "1",
                          "--tp_size", "2", "--sp", "True", "--ckpt_dir", str(tmp_path / "sp"),
                          "--name", "sp"], cwd=root, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("Best epoch:") == 1
    one = subprocess.run([sys.executable, script, *flags, "--ckpt_dir", str(tmp_path / "one"),
                          "--name", "one"], cwd=root, env=env, capture_output=True, text=True,
                         timeout=240)
    assert one.returncode == 0, one.stderr[-3000:]
    import json

    got = json.loads((tmp_path / "sp" / "summary_sp.json").read_text())
    want = json.loads((tmp_path / "one" / "summary_one.json").read_text())
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], **RUN_TOL)
    import tiny_bert_cli

    data = tiny_bert_cli.tiny_data(Config(device="cpu", max_seq_len=7))
    bert_cfg = dataclasses.replace(JBERT, moe_experts=4)
    template = _jax_template(dict(data="synthetic", hidden_size=16, embedding_size=8,
                                  max_seq_len=7, moe_experts=4), data, bert_cfg)
    tree = jckpt.load_checkpoint(str(tmp_path / "sp"), "best_model_MISA_synthetic", template)
    assert np.asarray(tree["bert"]["layers"][1]["moe"]["w_in"]).shape == (4, 32, 64)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(tree))


# ------------------------------------------------------------ refusals


def test_sp_needs_tensor_parallelism():
    """sp at tp_size = 1 raises JAX's "sp=True needs tp_size > 1", in the
    Config and in `shard_sequence` on an encoder that no mesh shards."""
    with pytest.raises(ValueError, match="sp=True needs tp_size > 1"):
        Config(device="cpu", sp=True)
    assert Config(device="cpu", sp=True, tp_size=2).sp
    with pytest.raises(ValueError, match="sp=True needs tp_size > 1"):
        shard_sequence(MISA(Config(device="cpu", **SMALL), bert_cfg=dp_workers.tp_bert_cfg()))
    enc = BertEncoder(dp_workers.tp_bert_cfg())
    enc.tp_mesh = pmesh.Mesh(dp=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="sp=True needs tp_size > 1"):
        shard_sequence(enc)
