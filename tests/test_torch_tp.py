"""Tensor parallelism on the ('data', 'model') mesh, on the CPU: the port's
Megatron partition rules against the JAX package's `param_partition_specs`,
the attention plain versions with a head offset against the JAX kernels
(interpret mode) on all heads, the sharded BERT forward and the training
step on gloo ranks (`tests/dp_workers.py`) against the JAX package on a
(dp, tp) mesh of the faked CPU devices (`tests/conftest.py`) and against the
port's one-process step, and the refusals.

The tiny BERT has H = 32, nh = 4 and 2 layers (`dp_workers.tp_bert_cfg`),
f32.  Tolerances: the forward at rtol 2e-4, atol 2e-5, as
`tests/test_parallel.py::test_tp_sharded_bert_matches_replicated` holds the
JAX package's sharded forward; a step at 1e-4, as the one-process and the
data-parallel steps are held to JAX; the plain attention with a head offset
at 1e-5 + 1e-5 |ref| and the masks bit for bit.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import misa as jmisa
from mmda_tpu.ops.pallas import attention as jattn
from mmda_tpu.ops.pallas import short_attention as jsa
from mmda_tpu.parallel import mesh as jmesh
from mmda_tpu.train import state as jstate
from mmda_tpu.train.step import make_train_step

from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import jax_name
from mmda_tpu_torch.models import MISA
from mmda_tpu_torch.models.bert import quantize_bert_int8
from mmda_tpu_torch.ops.kernels import attention as tattn
from mmda_tpu_torch.ops.kernels import short_attention as tsa
from mmda_tpu_torch.ops.kernels.hash_dropout import (attention_keep_mask,
                                                    short_attention_keep_mask)
from mmda_tpu_torch.parallel import mesh as pmesh
from mmda_tpu_torch.train.loop import Trainer, unsupported

import dp_workers

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
JBERT = jbert.BertConfig(**dataclasses.asdict(dp_workers.tp_bert_cfg()))
SMALL = dict(hidden_size=16, embedding_size=6, num_classes=6, visual_size=5, acoustic_size=7,
             vocab_size=40, use_bert=True, compute_dtype="float32", data="mosei",
             use_confidNet=True, missing_modality_prob=0.0)


def _jax_tree(kw, seed=4):
    tree = jmisa.init_misa_params(jax.random.PRNGKey(seed), JConfig(use_pallas=False, **kw),
                                  bert_cfg=JBERT)
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


# ------------------------------------------------------------- the rules


@pytest.mark.parametrize("layout", ["float", "int8"])
def test_partition_rules_match_jax(layout):
    """Every BERT leaf is sharded along the axis JAX's
    `param_partition_specs(tp=True)` shards it (its dim in the port's
    (out, in) layout), matched through `convert.py`'s names, and nothing
    outside BERT is sharded; the int8 layout shards `weight_q` as the
    weight and a column-parallel `scale` with its columns."""
    tree = _jax_tree(SMALL)
    model = MISA(Config(device="cpu", **SMALL), bert_cfg=dp_workers.tp_bert_cfg())
    if layout == "int8":
        tree = {**tree, "bert": jax.tree_util.tree_map(
            np.asarray, jbert.quantize_bert_int8(tree["bert"]))}
        quantize_bert_int8(model.bert)
    jspecs = jmesh.param_partition_specs(tree, tp=True)
    specs = pmesh.param_partition_specs(model, 2)
    assert pmesh.param_partition_specs(model, 1) == {}
    leaves = list(model.named_parameters()) + list(model.named_buffers())
    checked = 0
    for name, t in leaves:
        path = jax_name(model, name).replace(".weight_q", ".kernel_q")
        spec = _leaf(jspecs, path)
        axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
        want = None
        if axes:
            # a JAX kernel (in, out) is the port's weight (out, in): axis i is dim ndim - 1 - i
            want = t.dim() - 1 - axes[0] if path.endswith(("kernel", "kernel_q")) else axes[0]
        assert specs.get(name) == want, (name, spec)
        checked += name in specs
    # 2 layers x (q, k, v, ffn_in: weight and bias (+ scale) ; attn_out, ffn_out: weight)
    assert checked == 2 * (4 * (3 if layout == "int8" else 2) + 2)


def test_shard_params_keeps_each_ranks_block():
    """`shard_params` keeps a rank's block of each sharded leaf (the same
    Parameter objects) and the rest whole, as `shard_tensor` cuts a full
    tensor; the mesh's coordinates lie as the JAX mesh's devices (rank = d
    * tp + m)."""
    mesh = pmesh.Mesh(dp=2, rank=3, device=torch.device("cpu"), tp=2)
    assert (mesh.dp_rank, mesh.tp_rank) == (1, 1) and mesh.rows(8) == slice(4, 8)
    model = MISA(Config(device="cpu", **SMALL), bert_cfg=dp_workers.tp_bert_cfg())
    model.reset_parameters(torch.Generator().manual_seed(0))
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    before = {n: id(p) for n, p in model.named_parameters()}
    pmesh.shard_params(model, mesh)
    specs = pmesh.param_partition_specs(model, 2)
    assert model.bert.tp_mesh is mesh
    for n, p in model.named_parameters():
        assert id(p) == before[n]
        want = full[n] if n not in specs else full[n].chunk(2, dim=specs[n])[1]
        assert torch.equal(p, want), n
    assert torch.equal(pmesh.shard_tensor("bert.layers.0.q.bias", full["bert.layers.0.q.bias"],
                                          specs, mesh), full["bert.layers.0.q.bias"][16:])


# ------------------------------------------------------------ the masks


def test_keep_masks_with_a_head_offset_are_the_whole_masks_slices():
    """Heads 2..3 of 4 with the head offset draw the whole call's masks of
    those heads, bit for bit: the short kernels' h = head0 + local head, the
    flash kernels' global (batch, head) index."""
    seed = torch.tensor([11], dtype=torch.int32)
    b = torch.arange(3).reshape(3, 1, 1, 1)
    whole = short_attention_keep_mask(10, 0.3, seed, b, torch.arange(4).reshape(1, 4, 1, 1))
    part = short_attention_keep_mask(10, 0.3, seed, b, torch.arange(2, 4).reshape(1, 2, 1, 1))
    assert torch.equal(part, whole[:, 2:]) and not torch.equal(part, whole[:, :2])
    whole = attention_keep_mask((3 * 4, 10, 10), 0.3, seed).reshape(3, 4, 10, 10)
    part = attention_keep_mask((3 * 2, 10, 10), 0.3, seed, heads=(2, 4, 2))
    assert torch.equal(part.reshape(3, 2, 10, 10), whole[:, 2:])
    assert not torch.equal(attention_keep_mask((3 * 2, 10, 10), 0.3, seed).reshape(3, 2, 10, 10),
                           whole[:, 2:])


def _attn_inputs(B, nh, S, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, nh, S, hd)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, S), np.float32)
    for b in range(1, B):
        mask[b, S - 1 - b * S // (2 * B):] = 0.0
    return q, k, v, g, ((1.0 - mask) * -1e9).astype(np.float32)


def _close(got, want, name):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    np.testing.assert_array_less(np.abs(got - want), 1e-5 + 1e-5 * np.abs(want) + 1e-30,
                                 err_msg=name)


@pytest.mark.parametrize("core", ["short", "flash"])
def test_plain_attention_with_a_head_offset_matches_the_jax_kernels(core):
    """The plain forward and backward on heads 2..3 of 4 with the head
    offset against the JAX kernels (interpret mode) on all four heads,
    sliced, at rate 0.1."""
    B, nh, S, hd, h0, rate, seed = 3, 4, 10, 8, 2, 0.1, 1234
    q, k, v, g, bias = _attn_inputs(B, nh, S, hd, 5)
    jseed = jnp.asarray([seed], jnp.int32)
    tseed = torch.tensor([seed], dtype=torch.int32)
    part = [torch.from_numpy(a[:, h0:].copy()).requires_grad_(True) for a in (q, k, v)]
    tg = torch.from_numpy(g[:, h0:].copy())
    if core == "short":
        want, vjp = jax.vjp(lambda a, b_, c: jsa.short_attention(
            a, b_, c, jnp.asarray(bias), jseed, rate), *(jnp.asarray(a) for a in (q, k, v)))
        want = (want, *vjp(jnp.asarray(g)))
        got = tsa.short_attention(*part, torch.from_numpy(bias), tseed, rate, head0=h0)
        grads = torch.autograd.grad(got, part, tg)
    else:
        jattn.set_force_interpret(True)
        try:
            flat = [jnp.asarray(a.reshape(B * nh, S, hd)) for a in (q, k, v)]
            fbias = jnp.asarray(np.repeat(bias, nh, axis=0))
            want, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(a, b_, c, fbias, jseed,
                                                                       rate), *flat)
            want = [np.asarray(w).reshape(B, nh, S, hd)
                    for w in (want, *vjp(jnp.asarray(g.reshape(B * nh, S, hd))))]
        finally:
            jattn.set_force_interpret(False)
        pflat = [t.reshape(B * (nh - h0), S, hd) for t in part]
        got = tattn.flash_attention(*pflat, torch.from_numpy(np.repeat(bias, nh - h0, axis=0)),
                                    tseed, rate, heads=(nh - h0, nh, h0))
        grads = torch.autograd.grad(got, part, tg.reshape(B * (nh - h0), S, hd))
        got = got.reshape(B, nh - h0, S, hd)
    for name, a, w in zip(("o", "dq", "dk", "dv"), (got, *grads), want):
        _close(a, np.asarray(w)[:, h0:], f"{core} {name}")
    # without the offset the same heads draw other masks
    other = (tsa.short_attention(*part, torch.from_numpy(bias), tseed, rate)
             if core == "short" else None)
    if other is not None:
        assert not torch.allclose(other, got)


# ------------------------------------------------------- the sharded forward


def _ids_and_mask(B=8, S=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 128, size=(B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    for b in range(B):
        mask[b, S - 1 - (b * 3) % 5:] = 0
    return ids, mask


def _jax_encode(tree, ids, mask, dp, tp):
    """`bert_encode` with the JAX BERT sharded by its TP rules on a (dp, tp)
    mesh of the faked CPU devices, the batch over 'data' (f32)."""
    mesh = jmesh.make_mesh(dp, tp, devices=jax.devices()[:dp * tp])
    params = jmesh.shard_params({"bert": jax.tree_util.tree_map(jnp.asarray, tree)}, mesh,
                                tp=True)["bert"]
    s_ids, s_mask = (jax.device_put(jnp.asarray(a, jnp.int32), jmesh.batch_sharding(mesh))
                     for a in (ids, mask))
    out = jax.jit(lambda p, i, m: jbert.bert_encode(p, JBERT, i, m,
                                                    compute_dtype=jnp.float32))(
        params, s_ids, s_mask)
    return np.asarray(out)


IMPLS = ("xla", "fused", "flash")


@pytest.fixture(scope="module")
def encode_runs(tmp_path_factory):
    """The sharded forward at (dp, tp) = (1, 2) and (2, 2), both sets of
    ranks at once."""
    tree = jax.tree_util.tree_map(np.asarray, jbert.init_bert_params(jax.random.PRNGKey(3),
                                                                     JBERT))
    ids, mask = _ids_and_mask()
    sets = [(dp_workers.tp_encode_worker, dp * 2, (2, tree, ids, mask, IMPLS)) for dp in (1, 2)]
    results = dp_workers.run_rank_sets(sets, tmp_path_factory.mktemp("tp_encode"))
    return tree, ids, mask, dict(zip((1, 2), results))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_bert_forward_matches_jax_on_a_mesh(encode_runs, dp, impl):
    """Each rank's rows of the port's Megatron-sharded forward (the dense,
    the fused and the flash cores on nh / tp = 2 heads) against JAX's
    `bert_encode` on make_mesh(dp, 2) with `shard_params(tp=True)`; the
    ranks of a 'model' row agree bit for bit."""
    tree, ids, mask, runs = encode_runs
    want = _jax_encode(tree, ids, mask, dp, 2)
    ranks = runs[dp]
    for r in ranks:
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["out"][impl].numpy(), want[lo:hi], err_msg=impl,
                                   **FWD_TOL)
    for a, b in zip(ranks[::2], ranks[1::2]):
        assert (a["tp_rank"], b["tp_rank"]) == (0, 1)
        assert torch.equal(a["out"][impl], b["out"][impl])


# ------------------------------------------------------------ the step


def _arrays(B, T=6, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    S = T + 2
    bert_mask = (np.arange(S)[None, :] < (lengths + 2)[:, None]).astype(np.int32)
    emo = (rng.uniform(size=(B, 6)) < 0.4).astype(np.float32)
    emo[::B // 2] = 1.0
    return dict(
        text=rng.integers(0, 40, size=(B, T)).astype(np.int32),
        visual=rng.normal(size=(B, T, 5)).astype(np.float32),
        acoustic=rng.normal(size=(B, T, 7)).astype(np.float32), lengths=lengths,
        bert_ids=(rng.integers(0, 128, size=(B, S)) * bert_mask).astype(np.int32),
        bert_type=np.zeros((B, S), np.int32), bert_mask=bert_mask,
        sentiment=rng.normal(size=B).astype(np.float32), emo_label=emo,
        sample_weight=np.ones(B, np.float32), visual_lengths=None, acoustic_lengths=None)


def _jax_tp_step(kw, tree, arrays, dp, tp, frozen_layer):
    """The JAX training step (dropout off) with the BERT sharded by its TP
    rules on a (dp, tp) mesh, the rest of the state replicated and the batch
    over 'data': its losses and updated parameters."""
    jcfg = JConfig(use_pallas=False, **kw)
    mesh = jmesh.make_mesh(dp, tp, devices=jax.devices()[:dp * tp])
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    frozen = jax.tree_util.tree_map(lambda _: False, params)
    frozen["bert"] = jbert.frozen_mask(params["bert"], max_frozen_layer=frozen_layer)
    tx = jstate.make_optimizer(jcfg, frozen)
    state = jstate.create_train_state(jcfg, params, jax.random.PRNGKey(0), frozen, tx)
    state = jstate.TrainState(
        step=jax.device_put(state.step, jmesh.replicated(mesh)),
        params=jmesh.shard_params(state.params, mesh, tp=True),
        opt_state=jax.device_put(state.opt_state, jmesh.replicated(mesh)),
        rng=jax.device_put(state.rng, jmesh.replicated(mesh)))
    batch = jmisa.Batch(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    batch = jmesh.shard_batch(batch, mesh)
    step = make_train_step(
        jcfg, tx, lambda *a, **k: jmisa.misa_forward(*a, **{**k, "deterministic": True}),
        JBERT, donate=False, frozen=frozen)
    state, losses = step(state, batch)
    return ({k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_map(np.asarray, state.params))


# the attention cores with dropout on: the fused kernels' plain versions with
# the fused LayerNorm sites, and the dense core with the generator's dropout
DROPOUT_KW = (dict(attn_impl="fused", fused_ln_dropout=True), dict(attn_impl="xla"))


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """The step at (2, 2) with dropout off and at (1, 2) with dropout on
    under each of DROPOUT_KW, on two sets of ranks at once: for each key,
    [(case, every rank's result)]."""
    tmp = tmp_path_factory.mktemp("tp_step")
    kw = dict(SMALL, use_cmd_sim=True)
    cases = {"dp2": [(kw, _jax_tree(kw), _arrays(8, seed=3), False, 0)],
             "dropout": [(dict(SMALL, **options), _jax_tree(SMALL, seed=5),
                          _arrays(8, seed=4), True, 0) for options in DROPOUT_KW]}
    sets = []
    for key, world in (("dp2", 4), ("dropout", 2)):
        path = tmp / f"{key}.pkl"
        with open(path, "wb") as f:
            pickle.dump(cases[key], f)
        sets.append((dp_workers.tp_step_worker, world, (2, str(path))))
    results = dp_workers.run_rank_sets(sets, tmp)
    return {key: [(case, [r[i] for r in ranks]) for i, case in enumerate(cases[key])]
            for key, ranks in zip(("dp2", "dropout"), results)}


def _one_process(case):
    kw, tree, arrays, dropout, frozen = case
    return dp_workers.one_step(Config(device="cpu", **kw), tree, arrays,
                               bert_cfg=dp_workers.tp_bert_cfg(
                                   fused_ln_dropout=kw.get("fused_ln_dropout", False)),
                               dropout=dropout, frozen=frozen)


def test_tp_step_matches_the_jax_step_and_the_one_process_step(step_runs):
    """At (dp, tp) = (2, 2), dropout off, encoder layer 0 frozen and layer
    1 trained: every rank's losses and gathered parameters against
    `make_train_step` on make_mesh(2, 2) with the BERT TP-sharded, and
    against the port's one-process step (losses, grad_norm, gradients,
    parameters, the sharded blocks of layer 1 among them); layer 0 stays as
    it was."""
    (case, ranks), = step_runs["dp2"]
    kw, tree, arrays, _, frozen = case
    jlosses, jparams = _jax_tp_step(kw, tree, arrays, 2, 2, frozen)
    want = _one_process(case)
    model = dp_workers._tiny_misa(Config(device="cpu", **kw), tree, dp_workers.tp_bert_cfg(),
                                  frozen=frozen)
    assert all(r["sharded"] for r in ranks)
    for r in ranks:
        assert r["losses"].keys() == want["losses"].keys()
        for k, v in want["losses"].items():
            np.testing.assert_allclose(r["losses"][k], v, err_msg=k, **TOL)
            if k in jlosses:
                np.testing.assert_allclose(r["losses"][k], jlosses[k], err_msg=k, **TOL)
        assert r["params"].keys() == want["params"].keys()
        for n, p in want["params"].items():
            np.testing.assert_allclose(r["params"][n].numpy(), p.numpy(), err_msg=n, **TOL)
            np.testing.assert_allclose(r["grads"][n].numpy(), want["grads"][n].numpy(),
                                       err_msg=n, **TOL)
            path = jax_name(model, n)
            mine = r["params"][n].numpy()
            np.testing.assert_allclose(mine.T if path.endswith(".kernel") else mine,
                                       _leaf(jparams, path), err_msg=path, **TOL)
        assert "bert.layers.1.ffn_out.weight" in r["params"]
        assert not any(n.startswith("bert.layers.0.") for n in r["params"])   # frozen
    for n, p in model.named_parameters():
        if n.startswith("bert.layers.0."):
            path = jax_name(model, n)
            mine = p.detach().numpy()
            np.testing.assert_array_equal(mine.T if path.endswith(".kernel") else mine,
                                          _leaf(jparams, path), err_msg=path)


def test_tp_step_with_dropout_draws_the_one_process_masks(step_runs):
    """At tp = 2 with dropout on, both ranks' step is the one-process step
    from the same generator seed (1e-4), under the fused attention and
    LayerNorm kernels' plain versions and under the dense core: the ranks
    draw the one-process masks of the heads they hold.  The same step with
    the heads' offset dropped would draw others (checked on the masks
    above)."""
    assert [case[0]["attn_impl"] for case, _ in step_runs["dropout"]] == ["fused", "xla"]
    for case, ranks in step_runs["dropout"]:
        impl = case[0]["attn_impl"]
        want = _one_process(case)
        for r in ranks:
            for k, v in want["losses"].items():
                np.testing.assert_allclose(r["losses"][k], v, err_msg=f"{impl} {k}", **TOL)
            for n, p in want["params"].items():
                np.testing.assert_allclose(r["params"][n].numpy(), p.numpy(),
                                           err_msg=f"{impl} {n}", **TOL)
        assert ranks[0]["losses"] == ranks[1]["losses"], impl


# ------------------------------------------------------------ refusals


def test_tp_must_divide_the_heads_and_the_ffn():
    """tp not dividing num_heads (4) or intermediate_size raises, naming
    them; MoE BERT at tp > 1 shards its experts, and tp not dividing them
    raises the JAX trainer's message."""
    model = MISA(Config(device="cpu", **SMALL), bert_cfg=dp_workers.tp_bert_cfg())
    with pytest.raises(ValueError, match="num_heads=4 and intermediate_size=64"):
        pmesh.shard_params(model, pmesh.Mesh(dp=1, rank=0, device=torch.device("cpu"), tp=3))
    moe = MISA(Config(device="cpu", **SMALL),
               bert_cfg=dp_workers.tp_bert_cfg(moe_experts=2))
    with pytest.raises(ValueError, match="moe_experts=2 must be divisible by tp_size=4"):
        pmesh.shard_params(moe, pmesh.Mesh(dp=1, rank=0, device=torch.device("cpu"), tp=4))
    pmesh.shard_params(moe, pmesh.Mesh(dp=1, rank=1, device=torch.device("cpu"), tp=2))
    assert moe.bert.layers[0].moe.w_in.shape == (1, 32, 64)
    assert moe.bert.layers[0].moe.gate.shape == (32, 2)


@pytest.mark.parametrize("option,item", [
    (dict(sp=True), "item 3"), (dict(moe_experts=4), "item 3"), (dict(zero1=True), "item 4"),
    (dict(fsdp=True), "item 4"), (dict(pp_size=2), "item 5"),
    (dict(ckpt_backend="orbax"), "item 6")])
def test_the_other_modes_stay_refused_at_tp_2(option, item):
    """At tp_size = 2 tensor parallelism itself is no longer refused, nor
    are item 3's sequence parallelism and MoE (their checks instead: sp
    needs tp_size > 1, tp must divide the experts); each mode still to come
    is refused, by name and ROADMAP item."""
    assert unsupported(Config(device="cpu", tp_size=2), dp=1) == []
    cfg = Config(device="cpu", tp_size=2, **option)
    if item == "item 3":
        assert unsupported(cfg, dp=1) == unsupported(cfg, dp=2) == []
        if "sp" in option:
            with pytest.raises(ValueError, match="sp=True needs tp_size > 1"):
                cfg.replace(tp_size=1)
        else:
            with pytest.raises(ValueError, match="moe_experts=4 must be divisible by "
                                                 "tp_size=3"):
                Trainer(cfg.replace(tp_size=3), {})
        with pytest.raises(ValueError, match="process group"):
            Trainer(cfg, {})
        return
    (msg,) = unsupported(cfg, dp=1)
    assert f"ROADMAP Queue 1 {item}" in msg and next(iter(option)) in msg
    with pytest.raises(ValueError, match=f"not ported yet: .*{item}"):
        Trainer(cfg, {})
    with pytest.raises(ValueError, match="process group"):
        Trainer(Config(device="cpu", tp_size=2), {})
