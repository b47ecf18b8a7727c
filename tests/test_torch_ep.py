"""Expert parallelism and MoE BERT on the ('data', 'model') mesh, on the CPU:
the Switch MoE with its experts sharded on their leading E over 'model'
(`parallel/expert.py`) and routed over 'data' at dp > 1, on gloo ranks
(`tests/dp_workers.py`) against the JAX package (its unsharded
`bert_encode` and `jax.grad`, its `expert_sharded_moe` on a (dp, 2) mesh of
the faked CPU devices, its global-batch aux losses at dp = 2) and against
the port's one-process encoder; the Trainer at tp = 2 and at dp = 2,
`cli.train` at dp = 2 under torchrun, `Predictor(mesh=)` on a MoE export at
tp = 2, and the expert-count check.

The tiny BERT of tests/test_torch_tp.py (H = 32, nh = 4, 2 layers) with 4
experts, capacity factor 1.0 (some routes overflow), f32.  Tolerances: the
forward at 2e-4 relative and 2e-5, the aux losses at 1e-4, as
`tests/test_moe.py::test_expert_parallel_equivalence` holds the JAX
package's EP; the gradients at 2e-4 + 1e-3 |ref| (tests/test_torch_sp.py);
the Trainer's runs at 1e-3 and the Predictor at 1e-4, as
tests/test_torch_tp_trainer.py.
"""

import dataclasses
import json
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
from mmda_tpu.models import misa as jmisa
from mmda_tpu.parallel import expert as jexp
from mmda_tpu.parallel import mesh as jmesh
from mmda_tpu.train import checkpoint as jckpt

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import jax_leaves, jax_name, load_jax_params, transposed
from mmda_tpu_torch.models import MISA
from mmda_tpu_torch.models.bert import BertEncoder, bert_encode
from mmda_tpu_torch.parallel import mesh as pmesh
from mmda_tpu_torch.serving import Predictor
from mmda_tpu_torch.train.loop import Trainer, unsupported

import dp_workers
from test_torch_sp import _jax_template, _leaf
from test_torch_tp import SMALL

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
AUX_TOL = dict(rtol=1e-4, atol=1e-6)
RUN_TOL = dict(rtol=1e-3, atol=1e-4)
PRED_TOL = dict(rtol=1e-4, atol=1e-4)
AUX_W = (0.5, 0.1)                    # dp_workers.encode_case's weights of balance, router_z
B, S = 8, 13


def _moe(top_k=1, by_example=True):
    return dict(moe_experts=4, moe_top_k=top_k, moe_capacity_factor=1.0,
                moe_group_by_example=by_example)


def _jbert(**moe):
    return jbert.BertConfig(**dataclasses.asdict(dp_workers.tp_bert_cfg(**moe)))


def _tree(moe, seed=3):
    return jax.tree_util.tree_map(np.asarray, jbert.init_bert_params(jax.random.PRNGKey(seed),
                                                                     _jbert(**moe)))


def _ids_and_mask(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 128, size=(B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    for b in range(B):
        mask[b, S - 1 - (b * 3) % 6:] = 0
    return ids, mask


# (top_k, sp) on the tp = 2 meshes; (top_k, by_example) at dp = 2, tp = 1
EP_CASES = [(k, sp) for k in (1, 2) for sp in (False, True)]
DP_CASES = [(k, g) for k in (1, 2) for g in (True, False)]
TRAIN_KW = dict(device="cpu", use_bert=True, data="mosei", hidden_size=16, embedding_size=8,
                batch_size=8, max_seq_len=7, bucket_sizes=(7,), n_epoch=1, learning_rate=1e-3,
                log_sinks=(), seed=1, moe_experts=4, moe_capacity_factor=1.0)
PRED_KW = dict(device="cpu", hidden_size=16, visual_size=5, acoustic_size=7, vocab_size=40,
               embedding_size=6, bucket_sizes=(8,), max_seq_len=8, use_cmd_sim=False,
               compute_dtype="float32", moe_experts=4)


def _train_data():
    from mmda_tpu_torch.data import synthetic as psynth

    return psynth.make_dataset(16, 8, 8, max_len=7, seed=0, bert_vocab_size=128)


def _pred_tree():
    tree = jmisa.init_misa_params(jax.random.PRNGKey(0), JConfig(use_pallas=False, **{
        k: v for k, v in PRED_KW.items() if k != "device"}), bert_cfg=_jbert(**_moe()))
    return jax.tree_util.tree_map(np.asarray, tree)


def _requests():
    rng = np.random.default_rng(5)
    return [{"text": rng.integers(0, 40, size=L).astype(np.int32),
             "visual": rng.normal(size=(L, 5)).astype(np.float32),
             "acoustic": rng.normal(size=(L, 7)).astype(np.float32),
             "bert_ids": rng.integers(1, 128, size=L + 2).astype(np.int32),
             "bert_type": np.zeros(L + 2, np.int32), "bert_mask": np.ones(L + 2, np.int32)}
            for L in (3, 7, 2, 5, 8)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, by case key, on a (1, 2) mesh, a (2, 2) mesh
    and a (2, 1) mesh, the three sets at once: {(dp, tp): [rank results]}."""
    tmp = tmp_path_factory.mktemp("ep")
    ids, mask = _ids_and_mask()
    ep = [dict(key=("ep", k, sp), kind="encode", tree=_tree(_moe(k)), bert=_moe(k), ids=ids,
               mask=mask, impls=("xla",), sp=sp, over_data=True, grads=True)
          for k, sp in EP_CASES]
    data_cases = [dict(key=("dp", k, g), kind="encode", tree=_tree(_moe(k, g)),
                       bert=_moe(k, g), ids=ids, mask=mask, impls=("xla",), over_data=True,
                       grads=True) for k, g in DP_CASES]
    trainer = [dict(key="trainer", kind="trainer", data=_train_data(),
                    cfg=dict(TRAIN_KW, name="moe", ckpt_dir=str(tmp / f"tp{tp}"), dp_size=dp,
                             tp_size=tp)) for dp, tp in ((1, 2), (2, 1))]
    predictor = dict(key="predictor", kind="predictor", cfg=PRED_KW, tree=_pred_tree(),
                     bert=_moe(), options=dict(max_batch=6), requests=_requests())
    sets = {(1, 2): ep + [trainer[0], predictor], (2, 2): ep, (2, 1): data_cases + [trainer[1]]}
    launched = []
    for (dp, tp), cases in sets.items():
        path = tmp / f"cases{dp}{tp}.pkl"
        with open(path, "wb") as f:
            pickle.dump(cases, f)
        launched.append((dp_workers.mesh_worker, dp * tp, (tp, str(path))))
    results = dp_workers.run_rank_sets(launched, tmp, deadline_s=240.0)
    return {**dict(zip(sets, results)), "tmp": tmp}


@pytest.fixture(scope="module")
def refs():
    """For each MoE configuration of the cases: JAX's unsharded (hidden,
    aux) and `jax.grad` of mean(hidden^2) + the weighted aux losses, its
    forward under `expert_sharded_moe` on make_mesh(dp, 2), and the port's
    one-process forward and gradients (by name and by JAX path)."""
    ids, mask = _ids_and_mask()
    out = {}
    for moe in [_moe(k) for k in (1, 2)] + [_moe(k, False) for k in (1, 2)]:
        jb, tree = _jbert(**moe), jax.tree_util.tree_map(jnp.asarray, _tree(moe))
        jids, jmask = jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)

        def loss(p, jb=jb):
            h, aux = jbert.bert_encode(p, jb, jids, jmask, compute_dtype=jnp.float32)
            return (h ** 2).mean() + AUX_W[0] * aux["balance"] + AUX_W[1] * aux["router_z"], \
                (h, aux)

        (_, (h, aux)), grads = jax.value_and_grad(loss, has_aux=True)(tree)
        sharded = {}
        for dp in (1, 2):
            mesh = jmesh.make_mesh(dp, 2, devices=jax.devices()[:dp * 2])
            params = jmesh.shard_params({"bert": tree}, mesh, tp=True)["bert"]
            s_ids, s_mask = (jax.device_put(a, jmesh.batch_sharding(mesh))
                             for a in (jids, jmask))
            with jexp.expert_sharded_moe(mesh):
                sh, saux = jax.jit(lambda p, i, m, jb=jb: jbert.bert_encode(
                    p, jb, i, m, compute_dtype=jnp.float32))(params, s_ids, s_mask)
            sharded[dp] = (np.asarray(sh), {k: float(v) for k, v in saux.items()})
        enc = load_jax_params(BertEncoder(dp_workers.tp_bert_cfg(**moe)), _tree(moe))
        ph, paux = bert_encode(enc, torch.from_numpy(ids), torch.from_numpy(mask),
                               compute_dtype=torch.float32, attn_impl="xla")
        named = list(enc.named_parameters())
        ploss = ph.square().mean() + AUX_W[0] * paux["balance"] + AUX_W[1] * paux["router_z"]
        pg = torch.autograd.grad(ploss, [p for _, p in named], allow_unused=True,
                                 materialize_grads=True)
        out[(moe["moe_top_k"], moe["moe_group_by_example"])] = dict(
            jax=(np.asarray(h), {k: float(v) for k, v in aux.items()},
                 jax.tree_util.tree_map(np.asarray, grads)), sharded=sharded,
            port=(ph.detach(), {k: v.item() for k, v in paux.items()},
                  dict(zip([n for n, _ in named], pg)), dict(jax_leaves(enc, list(pg)))))
    return out


def _check_encode(got, ref, where, sharded=None):
    """A rank's rows, aux losses and gradients against JAX and the
    one-process port; its own router and experts' gradients against the
    one-process ones (its E / tp experts' slice)."""
    jh, jaux, jgrads = ref["jax"]
    ph, paux, pown, pgrads = ref["port"]
    lo, hi = got["rows"]
    for want in (jh, ph.numpy()) + (() if sharded is None else (sharded[0],)):
        np.testing.assert_allclose(got["out"].numpy(), want[lo:hi], err_msg=where, **FWD_TOL)
    for k in ("balance", "router_z", "drop_frac"):
        for want in (jaux, paux) + (() if sharded is None else (sharded[1],)):
            np.testing.assert_allclose(got["aux"][k], want[k], err_msg=f"{where} {k}",
                                       **AUX_TOL)
    for path, g in got["grads"].items():
        for ref_g in (np.asarray(_leaf(jgrads, path)), pgrads[path].numpy()):
            np.testing.assert_array_less(np.abs(g.numpy() - ref_g), 2e-4 + 1e-3 * np.abs(ref_g),
                                         err_msg=f"{where} {path}")
    moe = [n for n in got["own_grads"] if ".moe." in n]
    assert len(moe) == 2 * 5
    for n in moe:
        want = pown[n]
        if not n.endswith(".gate"):
            e = got["own_grads"][n].shape[0]
            want = want[got["tp_rank"] * e:(got["tp_rank"] + 1) * e]
        np.testing.assert_array_less((got["own_grads"][n] - want).abs().numpy(),
                                     2e-4 + 1e-3 * want.abs().numpy(), err_msg=f"{where} {n}")


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dp", [1, 2])
def test_expert_sharded_moe_matches_jax_and_one_process(runs, refs, dp, top_k, sp):
    """At (dp, 2), 2 of 4 experts a rank, with and without sp: each rank's
    rows and aux losses against JAX's unsharded encoder and its
    `expert_sharded_moe` forward, and against the one-process port; the
    gradient of mean(hidden^2) + 0.5 balance + 0.1 router_z, summed over
    'data', in the full layout against `jax.grad` and the one-process
    gradient; every rank's router gradient (whole) and its experts'
    against the one-process ones."""
    ref = refs[(top_k, True)]
    for r in runs[(dp, 2)]:
        _check_encode(r[("ep", top_k, sp)]["xla"], ref, f"dp={dp} top_k={top_k} sp={sp}",
                      ref["sharded"][dp])
    some_dropped = max(r[("ep", top_k, sp)]["xla"]["aux"]["drop_frac"] for r in runs[(dp, 2)])
    assert some_dropped > 0.0


@pytest.mark.parametrize("by_example", [True, False], ids=["G=B", "G=1"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_at_dp_2_routes_the_global_batch(runs, refs, top_k, by_example):
    """At dp = 2 (tp = 1) each rank's 4 rows: balance, router_z and
    drop_frac are the global batch's, as JAX computes them on the whole
    batch, and the rows and gradients are the one-process ones, routed by
    example (G = B) and as one group over both ranks' tokens (G = 1: the
    queue positions count the lower rank's tokens, top-2's second choices
    every rank's first ones)."""
    ref = refs[(top_k, by_example)]
    ranks = runs[(2, 1)]
    for r in ranks:
        _check_encode(r[("dp", top_k, by_example)]["xla"], ref,
                      f"dp=2 top_k={top_k} G={'B' if by_example else 1}")
    assert ranks[0][("dp", top_k, by_example)]["xla"]["aux"]["drop_frac"] > 0.0


# ---------------------------------------------------- the trainer, the CLI


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["tp2", "dp2"])
def test_trainer_with_moe_on_a_mesh(runs, mesh):
    """`Trainer.train()` with moe_experts = 4 at tp = 2 (2 experts a rank)
    and at dp = 2 (the aux losses over 'data') for one epoch, dropout off:
    the summary matches the one-process Trainer's (1e-3), and the JAX
    package's `load_checkpoint` reads the export with every expert, the
    ranks' gathered parameters."""
    data = _train_data()
    kw = dict(TRAIN_KW, name="moe")
    one = Trainer(Config(**kw, ckpt_dir=str(runs["tmp"] / f"one{mesh}")), data,
                  bert_cfg=dp_workers.tp_bert_cfg())
    model = one.model
    model.train = lambda mode=True: torch.nn.Module.train(model, False)
    want = one.train()
    ranks = [r["trainer"] for r in runs[mesh]]
    for r in ranks:
        assert r["step"] == 2
        for k in ("test_loss", "best_valid_loss"):
            np.testing.assert_allclose(r["summary"][k], want[k], err_msg=k, **RUN_TOL)
    tree = jckpt.load_checkpoint(str(runs["tmp"] / f"tp{mesh[1]}"), "best_model_MISA_mosei",
                                 _jax_template(kw, data, _jbert(moe_experts=4,
                                                                moe_capacity_factor=1.0)))
    for n, p in ranks[0]["params"].items():
        path = jax_name(model, n)
        mine = p.numpy()
        np.testing.assert_array_equal(mine.T if transposed(path) else mine,
                                      np.asarray(_leaf(tree, path)), err_msg=path)
    assert ranks[0]["params"]["bert.layers.1.moe.w_in"].shape == (4, 32, 64)


def test_cli_train_with_moe_at_dp_2_under_torchrun(tmp_path):
    """`torchrun --nproc_per_node 2 tests/tiny_bert_cli.py --dp_size 2
    --moe_experts 4` (`cli.train` with the tests' tiny BERT), dropout off
    (at dp > 1 each rank draws its own): one epoch, rank 0 alone prints, its
    test loss the one-process `cli.train`'s (1e-3)."""
    flags = ["--device", "cpu", "--data", "synthetic", "--hidden_size", "16",
             "--embedding_size", "8", "--max_seq_len", "7", "--batch_size", "16",
             "--n_epoch", "1", "--moe_experts", "4", "--dropout", "0.0"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    script = os.path.join(root, "tests", "tiny_bert_cli.py")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", script, *flags, "--dp_size", "2",
                          "--ckpt_dir", str(tmp_path / "dp"), "--name", "dp"], cwd=root,
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("Best epoch:") == 1
    one = subprocess.run([sys.executable, script, *flags, "--ckpt_dir", str(tmp_path / "one"),
                          "--name", "one"], cwd=root, env=env, capture_output=True, text=True,
                         timeout=240)
    assert one.returncode == 0, one.stderr[-3000:]
    got = json.loads((tmp_path / "dp" / "summary_dp.json").read_text())
    want = json.loads((tmp_path / "one" / "summary_one.json").read_text())
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], **RUN_TOL)


def test_predictor_on_a_moe_export_at_tp_2(runs):
    """`Predictor(mesh=)` at tp = 2 on a MoE MISA (each rank 2 of 4 experts,
    as the JAX Predictor shards the export): both ranks return the
    one-process Predictor's outputs (1e-4)."""
    want = Predictor(Config(**PRED_KW), params=_pred_tree(),
                     bert_cfg=dp_workers.tp_bert_cfg(**_moe()), max_batch=6)(_requests())
    for r in runs[(1, 2)]:
        got = r["predictor"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **PRED_TOL)


# ------------------------------------------------------------ the checks


def test_tp_must_divide_the_experts():
    """tp not dividing moe_experts raises the JAX trainer's message, in the
    Trainer and in `shard_params`; at tp = 2 MoE on a mesh is not refused."""
    with pytest.raises(ValueError, match="moe_experts=3 must be divisible by tp_size=2"):
        Trainer(Config(device="cpu", use_bert=True, moe_experts=3, tp_size=2), {})
    model = MISA(Config(device="cpu", **SMALL), bert_cfg=dp_workers.tp_bert_cfg(moe_experts=6))
    with pytest.raises(ValueError, match="moe_experts=6 must be divisible by tp_size=4"):
        pmesh.shard_params(model, pmesh.Mesh(dp=1, rank=0, device=torch.device("cpu"), tp=4))
    assert unsupported(Config(device="cpu", moe_experts=4, tp_size=2), dp=2) == []
