"""Data parallelism on the ('data', 'model') mesh, on the CPU: the port's
data-parallel step (gloo ranks, `tests/dp_workers.py`) against the JAX
package's step on a (dp, 1) mesh of the faked CPU devices
(`tests/conftest.py`) and against the port's one-process step at the global
batch; `gather_rows`, `all_reduce_grads`, the ranks' dropout, the mesh's
refusals.

The small MISA of tests/test_torch_train.py (tiny BERT, narrow widths, f32,
dropout off, the mosei freeze rule) with use_confidNet, so that the diff,
CMD or domain, reconstruction and ConfidNet terms, which all couple the
rows of a batch, are live.  Tolerance: 1e-4, the one the one-process step
is held to against JAX there; the data-parallel step against the
one-process step differs only by summation order (the ranks' shares of each
gradient summed by the all_reduce, the forward's products over fewer rows),
which that tolerance covers with room, so nothing is added for it.
"""

import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import misa as jmisa
from mmda_tpu.parallel import mesh as jmesh
from mmda_tpu.train import objective as jobjective
from mmda_tpu.train import state as jstate
from mmda_tpu.train.step import make_train_step

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import jax_name
from mmda_tpu_torch.parallel import mesh as pmesh
from mmda_tpu_torch.train.loop import Trainer, unsupported

import dp_workers

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(hidden_size=16, embedding_size=6, num_classes=6, visual_size=5, acoustic_size=7,
             vocab_size=40, use_bert=True, compute_dtype="float32", data="mosei",
             use_confidNet=True, missing_modality_prob=0.0)


def _arrays(B, dp, T=6, seed=0):
    """A host batch of B rows; the first row of each rank's share has every
    label, so that each rank's own ConfidNet term is finite too."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    S = T + 2
    bert_mask = (np.arange(S)[None, :] < (lengths + 2)[:, None]).astype(np.int32)
    emo = (rng.uniform(size=(B, 6)) < 0.4).astype(np.float32)
    emo[:: B // dp if B % dp == 0 else B] = 1.0
    return dict(
        text=rng.integers(0, 40, size=(B, T)).astype(np.int32),
        visual=rng.normal(size=(B, T, 5)).astype(np.float32),
        acoustic=rng.normal(size=(B, T, 7)).astype(np.float32), lengths=lengths,
        bert_ids=(rng.integers(0, 128, size=(B, S)) * bert_mask).astype(np.int32),
        bert_type=np.zeros((B, S), np.int32), bert_mask=bert_mask,
        sentiment=rng.normal(size=B).astype(np.float32), emo_label=emo,
        sample_weight=np.ones(B, np.float32), visual_lengths=None, acoustic_lengths=None)


def _tree(kw, seed=4):
    tree = jmisa.init_misa_params(jax.random.PRNGKey(seed), JConfig(use_pallas=False, **kw),
                                  bert_cfg=jbert.BertConfig.tiny())
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_step(kw, tree, arrays, dp):
    """The JAX training step (make_train_step, dropout off) with the state
    replicated on a (dp, 1) mesh and the batch sharded over 'data', or
    replicated where its rows do not divide dp (the JAX trainer's rule):
    its losses, jax.grad of the objective on that mesh, and the parameters
    after the update."""
    jcfg = JConfig(use_pallas=False, **kw)
    mesh = jmesh.make_mesh(dp, 1, devices=jax.devices()[:dp])
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    frozen = jax.tree_util.tree_map(lambda _: False, params)
    frozen["bert"] = jbert.frozen_mask(params["bert"], max_frozen_layer=8)
    tx = jstate.make_optimizer(jcfg, frozen)
    state = jstate.create_train_state(jcfg, params, jax.random.PRNGKey(0), frozen, tx)
    state = jax.device_put(state, jmesh.replicated(mesh))
    batch = jmisa.Batch(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    if len(arrays["lengths"]) % dp == 0:
        batch = jmesh.shard_batch(batch, mesh)
    else:
        batch = jax.device_put(batch, jmesh.replicated(mesh))

    def objective(p):
        out = jmisa.misa_forward(p, jcfg, batch, bert_cfg=jbert.BertConfig.tiny(),
                                 deterministic=True)
        return jobjective.compute_losses(jcfg, out, batch)["total"]

    grads = jax.jit(jax.grad(objective))(state.params)
    step = make_train_step(
        jcfg, tx, lambda *a, **k: jmisa.misa_forward(*a, **{**k, "deterministic": True}),
        jbert.BertConfig.tiny(), donate=False, frozen=frozen)
    state, losses = step(state, batch)
    as_numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {k: float(v) for k, v in losses.items()}, as_numpy(grads), as_numpy(state.params)


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


# (use_cmd_sim, B): each dp runs these on one set of ranks
CASES = [(False, 8), (True, 8), (False, 6)]
JAX_CASES = {2: [(False, 8)], 4: [(True, 8), (False, 6)]}   # a compile each: ~10 s


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The data-parallel step at dp = 2 and 4 for every case (one set of
    ranks per dp, both sets at once), with the case's tree and arrays."""
    cases, sets = {}, []
    tmp = tmp_path_factory.mktemp("dp")
    for dp in (2, 4):
        cases[dp] = []
        for cmd, B in CASES + [c for c in JAX_CASES[dp] if c not in CASES]:
            kw = dict(SMALL, use_cmd_sim=cmd)
            cases[dp].append(((cmd, B), kw, _tree(kw), _arrays(B, dp, seed=B + dp)))
        path = tmp / f"cases{dp}.pkl"
        with open(path, "wb") as f:
            pickle.dump([(kw, tree, arrays) for _, kw, tree, arrays in cases[dp]], f)
        sets.append((dp_workers.step_worker, dp, (str(path),)))
    results = dp_workers.run_rank_sets(sets, tmp)
    return {dp: [(key, kw, tree, arrays, [r[i] for r in ranks])
                 for i, (key, kw, tree, arrays) in enumerate(cases[dp])]
            for dp, ranks in zip((2, 4), results)}


def _case(dp_runs, dp, key):
    return next(run for run in dp_runs[dp] if run[0] == key)


@pytest.mark.parametrize("dp,cmd,B", [(dp, cmd, B) for dp in (2, 4) for cmd, B in CASES])
def test_dp_step_is_the_one_process_step_at_the_global_batch(dp_runs, dp, cmd, B):
    """Every rank's losses, grad_norm, applied gradients (leaf by leaf) and
    updated parameters against the port's one-process step on the whole
    batch (B = 6 at dp = 4 runs replicated); the ranks agree with each other
    bit for bit."""
    _, kw, tree, arrays, ranks = _case(dp_runs, dp, (cmd, B))
    want = dp_workers.one_step(Config(device="cpu", **kw), tree, arrays)
    assert all(r["sharded"] == (B % dp == 0) for r in ranks)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        for n, p in r["params"].items():
            assert torch.equal(p, ranks[0]["params"][n]), n
            assert torch.equal(r["grads"][n], ranks[0]["grads"][n]), n
    got = ranks[0]
    assert got["losses"].keys() == want["losses"].keys()
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, err_msg=k, **TOL)
    assert got["grads"].keys() == want["grads"].keys() == want["params"].keys()
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(), err_msg=n, **TOL)
    for n, p in want["params"].items():
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), err_msg=n, **TOL)


@pytest.mark.parametrize("dp,cmd,B", [(dp, cmd, B) for dp in (2, 4) for cmd, B in JAX_CASES[dp]])
def test_dp_step_matches_the_jax_step_on_a_mesh(dp_runs, dp, cmd, B):
    """Rank 0's losses, grad_norm, applied gradients (leaf by leaf, against
    jax.grad of the objective on the same mesh) and trainable parameters
    after the update against `make_train_step` on `make_mesh(dp, 1)` over
    the faked CPU devices (its frozen leaves unchanged)."""
    _, kw, tree, arrays, ranks = _case(dp_runs, dp, (cmd, B))
    jlosses, jgrads, jparams = _jax_step(kw, tree, arrays, dp)
    got = ranks[0]
    assert set(got["losses"]) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(got["losses"][k], v, err_msg=k, **TOL)
    model = dp_workers._tiny_misa(Config(device="cpu", **kw), tree)
    for n, p in got["params"].items():
        path = jax_name(model, n)
        for name, mine, theirs in (("grad", got["grads"][n], jgrads), ("param", p, jparams)):
            mine = mine.numpy()
            np.testing.assert_allclose(mine.T if path.endswith(".kernel") else mine,
                                       _leaf(theirs, path), err_msg=f"{name} {path}", **TOL)


@pytest.mark.parametrize("dp", [2, 4])
def test_per_rank_loss_averaging_is_another_objective(dp_runs, dp):
    """Naive DDP (each rank's objective over its own rows, averaged) is not
    the global objective the data-parallel step computes: it misses the
    cross-row terms.  The port's step reports the global one (checked
    against the one-process step above)."""
    _, kw, tree, arrays, ranks = _case(dp_runs, dp, (True, 8))
    naive = float(np.mean([r["own_objective"] for r in ranks]))
    assert all(np.isfinite(r["own_objective"]) for r in ranks)
    total = ranks[0]["losses"]["total"]
    assert abs(naive - total) > 1e-2 * abs(total), (naive, total)


def test_gather_rows_gradient_is_the_one_process_gradient(tmp_path):
    """gather_rows' forward is the whole batch in rank order (any dtype);
    its backward gives each rank the one-process gradient of its rows, not
    dp times it; all_reduce_grads sums in place across a bucket boundary and
    a dtype change."""
    x = np.random.default_rng(0).normal(size=(6, 3))
    ranks = dp_workers.run_ranks(dp_workers.gather_worker, 2, tmp_path, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    c = xt - xt.mean(0)
    loss = (c.T @ c).pow(2).sum() + xt.pow(3).mean(0).sum()
    (want,) = torch.autograd.grad(loss, [xt])
    for r, got in enumerate(ranks):
        assert torch.equal(got["y"], torch.from_numpy(x))
        assert torch.equal(got["w"], torch.arange(3, dtype=torch.float64).repeat(2))
        assert got["loss"] == pytest.approx(loss.item(), rel=1e-12)
        torch.testing.assert_close(got["grad"], want[3 * r: 3 * r + 3], rtol=1e-12,
                                   atol=1e-12)
        assert torch.equal(got["reduced"][0], torch.full((5,), 3.0))
        assert torch.equal(got["reduced"][1], torch.full((3, 2), 2.0))
        assert torch.equal(got["reduced"][2], torch.full((2,), 2.0, dtype=torch.float64))


def test_ranks_draw_their_own_dropout_and_the_shared_keep_mask(tmp_path):
    """At dp = 2 a Trainer's forward with dropout on (BERT's fused
    LayerNorm sites included) gives the two ranks different outputs on the
    same rows; the modality-keep mask, drawn at the global batch from the
    shared generator, is the same on both."""
    from mmda_tpu_torch.data import synthetic as psynth

    data = psynth.make_dataset(32, 8, 8, max_len=8, seed=0, bert_vocab_size=128)
    kw = dict(device="cpu", use_bert=True, data="mosei", hidden_size=16, embedding_size=8,
              batch_size=8, max_seq_len=8, bucket_sizes=(8,), fused_ln_dropout=True,
              missing_modality_prob=0.5, compiled_eval=False, log_sinks=(),
              ckpt_dir=str(tmp_path), name="drop")
    ranks = dp_workers.run_ranks(dp_workers.dropout_worker, 2, tmp_path, kw, data)
    assert not any(r["shared_is_dropout"] for r in ranks)
    assert not torch.equal(ranks[0]["scores"], ranks[1]["scores"])
    assert torch.equal(ranks[0]["keep"], ranks[1]["keep"])
    assert 0 < ranks[0]["keep"][:, 1:].mean() < 1


@pytest.mark.parametrize("option,item", [
    (dict(tp_size=2, moe_experts=4), "item 3"), (dict(sp=True), "item 3"),
    (dict(zero1=True), "item 4"),
    (dict(fsdp=True), "item 4"), (dict(pp_size=2), "item 5"),
    (dict(ckpt_backend="orbax"), "item 6"), (dict(moe_experts=4), "item 3"),
    (dict(model="MMIM"), "item 7")])
def test_unported_modes_are_refused_by_name(option, item):
    """Each mode the trainer cannot run names its ROADMAP item; MMIM only
    at dp > 1 (one process runs it).  Item 3's modes run: MoE at dp = 2
    and at tp = 2 is accepted (tests/test_torch_ep.py), and sp raises the
    JAX trainer's "needs tp_size > 1" at tp_size = 1."""
    if item == "item 3":
        if "sp" in option:
            with pytest.raises(ValueError, match="sp=True needs tp_size > 1"):
                Config(device="cpu", **option)
            option = dict(option, tp_size=2)
        cfg = Config(device="cpu", **option)
        assert unsupported(cfg, dp=2) == unsupported(cfg, dp=1) == []
        with pytest.raises(ValueError, match="process group"):
            Trainer(cfg.replace(dp_size=2), {})
        return
    cfg = Config(device="cpu", **option)
    (msg,) = unsupported(cfg, dp=2)
    assert f"ROADMAP Queue 1 {item}" in msg and next(iter(option)) in msg
    if option == dict(model="MMIM"):
        assert unsupported(cfg, dp=1) == []
    with pytest.raises(ValueError, match=f"not ported yet: .*{item}"):
        Trainer(cfg.replace(dp_size=2) if item == "item 7" else cfg, {})


def test_a_mesh_needs_a_process_group_and_tp_1():
    """No process group: make_mesh and a Trainer at dp_size = 2 raise
    (nothing runs as one process instead); shard_batch takes a rank's
    contiguous rows or leaves a batch that does not divide dp whole."""
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(2, 1)
    with pytest.raises(ValueError, match="process group"):
        Trainer(Config(device="cpu", dp_size=2), {})
    mesh = pmesh.Mesh(dp=4, rank=2, device=torch.device("cpu"))
    arrays = {"a": np.arange(8), "b": None}
    assert np.array_equal(pmesh.shard_batch(arrays, mesh)["a"], [4, 5])
    assert pmesh.shard_batch(arrays, mesh)["b"] is None
    assert np.array_equal(pmesh.shard_batch({"a": np.arange(6)}, mesh)["a"], np.arange(6))
    assert pmesh.rank_seed(0, 1, 3) != pmesh.rank_seed(0, 2, 3) != pmesh.rank_seed(0, 1, 4)
    assert pmesh.rank_seed(0, 1, 3) == pmesh.rank_seed(0, 1, 3)
