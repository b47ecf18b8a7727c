"""The port's MoE BERT (mmda_tpu_torch/ops/moe.py, models/bert.py with
moe_experts > 0, the objective's moe terms, the Trainer's rules,
convert.py's router) against the JAX package's, on the CPU: the
single-card cases of tests/test_moe.py.

Every comparison with `mmda_tpu.ops.moe.switch_ffn` first holds the routing
token for token (each token's expert, queue slot and whether it was kept:
the (G, n, E, C) dispatch, transcribed from the JAX code by `_jax_dispatch`
and bit-equal to the port's `route`), then the values at 1e-5 + 1e-5 |ref|.
A route that flips on a near tie is a fault to report, not a seed to
change.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import misa as jmisa
from mmda_tpu.ops import moe as jmoe
from mmda_tpu.serving import Predictor as JPredictor
from mmda_tpu.train import checkpoint as jckpt
from mmda_tpu.train import objective as jobjective
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import jax_name, load_jax_params, to_port_layout, transposed
from mmda_tpu_torch.data.synthetic import SyntheticSpec, make_split
from mmda_tpu_torch.models import MISA
from mmda_tpu_torch.models.bert import (BertConfig, BertEncoder, QuantizedDense,
                                         bert_config_for, freeze_layers, load_hf_weights,
                                         quantize_bert_int8)
from mmda_tpu_torch.ops import moe
from mmda_tpu_torch.serving import Predictor
from mmda_tpu_torch.train import checkpoint as pckpt
from mmda_tpu_torch.train.loop import Trainer
from mmda_tpu_torch.train.step import loss_and_grads

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _tokens(n=16, h=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, h)).astype(np.float32)


def _params(seed, h=8, f=16, e=2):
    """JAX `init_moe_ffn_params` as numpy, and a port `SwitchFFN` holding it."""
    tree = jax.tree_util.tree_map(np.asarray, jmoe.init_moe_ffn_params(
        jax.random.PRNGKey(seed), h, f, num_experts=e))
    return tree, _port(tree)


def _port(tree):
    E, H, F = tree["w_in"].shape
    p = moe.SwitchFFN(H, F, E)
    with torch.no_grad():
        p.gate.copy_(torch.from_numpy(np.array(tree["gate"]["kernel"])))
        for k in ("w_in", "b_in", "w_out", "b_out"):
            getattr(p, k).copy_(torch.from_numpy(np.array(tree[k])))
    return p


def _jax_dispatch(tree, x, capacity_factor, groups, top_k):
    """`mmda_tpu/ops/moe.py::switch_ffn`'s (G, n, E, C) dispatch, its lines
    transcribed."""
    N, H = x.shape
    E = tree["w_in"].shape[0]
    n = N // groups
    C = max(int(np.ceil(capacity_factor * top_k * n / E)), 1)
    xg = jnp.asarray(x).reshape(groups, n, H)
    probs = jax.nn.softmax(jnp.einsum("gnh,he->gne", xg, jnp.asarray(tree["gate"]["kernel"])),
                           axis=-1)
    onehot = jax.nn.one_hot(jnp.argmax(probs, axis=-1), E, dtype=jnp.float32)

    def make(oh, pos):
        keep = oh * (pos < C)
        return keep[..., None] * jax.nn.one_hot(jnp.sum(pos * oh, axis=-1).astype(jnp.int32),
                                                C, dtype=jnp.float32)[:, :, None, :]

    dispatch = make(onehot, jnp.cumsum(onehot, axis=1) * onehot - onehot)
    if top_k == 2:
        onehot2 = jax.nn.one_hot(jnp.argmax(probs * (1.0 - onehot), axis=-1), E,
                                 dtype=jnp.float32)
        pos2 = (jnp.cumsum(onehot2, axis=1) * onehot2 - onehot2
                + jnp.sum(onehot, axis=1, keepdims=True) * onehot2)
        dispatch = dispatch + make(onehot2, pos2)
    return np.asarray(dispatch)


def _routes_agree(tree, p, x, capacity_factor, groups=1, top_k=1):
    """Each token's expert, slot and kept flag: the port's against JAX's."""
    want = _jax_dispatch(tree, x, capacity_factor, groups, top_k)
    got = moe.route(p, torch.from_numpy(x), capacity_factor=capacity_factor, groups=groups,
                    top_k=top_k).dispatch.numpy()
    assert got.shape == want.shape
    for name, reduce in (("kept", lambda d: d.sum((2, 3))), ("expert", lambda d: d.sum(3)),
                         ("slot", lambda d: d.sum(2))):
        np.testing.assert_array_equal(reduce(got), reduce(want), err_msg=name)
    np.testing.assert_array_equal(got, want)
    return got


def _both(tree, p, x, **kw):
    """(port y, aux), (JAX y, aux) as numpy, f32 compute unless given."""
    kw.setdefault("compute_dtype", "float32")
    y, aux = moe.switch_ffn(p, torch.from_numpy(x),
                            **{**kw, "compute_dtype": getattr(torch, kw["compute_dtype"])})
    jy, jaux = jmoe.switch_ffn(tree, jnp.asarray(x),
                               **{**kw, "compute_dtype": getattr(jnp, kw["compute_dtype"])})
    return ((y.detach().numpy(), {k: float(v.detach()) for k, v in aux.items()}),
            (np.asarray(jy), {k: float(v) for k, v in jaux.items()}))


def _dense_ffn(tree, e, x):
    h = jax.nn.gelu(x @ tree["w_in"][e] + tree["b_in"][e], approximate=False)
    return np.asarray(h @ tree["w_out"][e] + tree["b_out"][e])


def test_e1_matches_dense_ffn():
    """One expert, capacity N: every token routed with gate prob 1, the
    dense FFN; balance 1."""
    tree, p = _params(0, e=1)
    x = _tokens()
    _routes_agree(tree, p, x, 1.0)
    (y, aux), (jy, jaux) = _both(tree, p, x, capacity_factor=1.0)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(y, _dense_ffn(tree, 0, x), **TOL)
    assert aux["balance"] == pytest.approx(1.0, abs=1e-6) and aux["drop_frac"] == 0.0


def test_capacity_overflow_drops_to_zero():
    tree, p = _params(1, e=1)
    x = _tokens(n=8)
    d = _routes_agree(tree, p, x, 0.5)
    assert d.sum((2, 3)).reshape(-1).tolist() == [1.0] * 4 + [0.0] * 4
    (y, aux), (jy, jaux) = _both(tree, p, x, capacity_factor=0.5)
    np.testing.assert_allclose(y, jy, **TOL)
    assert np.abs(y[:4]).sum() > 0
    np.testing.assert_array_equal(y[4:], np.zeros_like(y[4:]))
    assert aux["drop_frac"] == jaux["drop_frac"] == 0.5


def test_identical_experts_match_dense_any_routing():
    """Every expert the same FFN, capacity for all: y = gate_p * dense(x)."""
    E = 4
    tree, _ = _params(2, e=E)
    for k in ("w_in", "b_in", "w_out", "b_out"):
        tree[k] = np.tile(tree[k][:1], (E,) + (1,) * (tree[k].ndim - 1))
    p = _port(tree)
    x = _tokens()
    _routes_agree(tree, p, x, float(E))
    (y, _), (jy, _) = _both(tree, p, x, capacity_factor=float(E))
    np.testing.assert_allclose(y, jy, **TOL)
    gate_p = np.asarray(jax.nn.softmax(x @ tree["gate"]["kernel"], axis=-1)).max(-1)
    np.testing.assert_allclose(y, gate_p[:, None] * _dense_ffn(tree, 0, x), **TOL)


def test_grouped_dispatch_matches_ungrouped_at_ample_capacity():
    E, G = 2, 4
    tree, p = _params(4, e=E)
    x = _tokens()
    for groups in (1, G):
        _routes_agree(tree, p, x, float(E), groups)
    (y1, a1), _ = _both(tree, p, x, capacity_factor=float(E), groups=1)
    (yg, ag), (jyg, _) = _both(tree, p, x, capacity_factor=float(E), groups=G)
    np.testing.assert_allclose(yg, y1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(yg, jyg, **TOL)
    assert ag["balance"] == pytest.approx(a1["balance"], rel=1e-6)


def test_grouped_capacity_is_per_group():
    """E=1, capacity_factor 0.5: ungrouped C=4 keeps tokens 0-3; G=4 groups
    of 2 with C=1 keep tokens 0, 2, 4, 6."""
    tree, p = _params(5, e=1)
    x = _tokens(n=8)
    _routes_agree(tree, p, x, 0.5, 1)
    _routes_agree(tree, p, x, 0.5, 4)
    (yu, _), (jyu, _) = _both(tree, p, x, capacity_factor=0.5, groups=1)
    (yg, _), (jyg, _) = _both(tree, p, x, capacity_factor=0.5, groups=4)
    np.testing.assert_allclose(yu, jyu, **TOL)
    np.testing.assert_allclose(yg, jyg, **TOL)
    assert np.abs(yu[:4]).sum() > 0 and np.abs(yu[4:]).sum() == 0
    np.testing.assert_array_equal(np.abs(yg).sum(1) > 0, [True, False] * 4)


def test_top2_with_two_experts_is_softmax_mixture():
    E = 2
    tree, p = _params(7, e=E)
    x = _tokens(n=12)
    _routes_agree(tree, p, x, float(E), top_k=2)
    (y, _), (jy, _) = _both(tree, p, x, capacity_factor=float(E), top_k=2)
    np.testing.assert_allclose(y, jy, **TOL)
    probs = np.asarray(jax.nn.softmax(x @ tree["gate"]["kernel"], axis=-1))
    want = probs[:, :1] * _dense_ffn(tree, 0, x) + probs[:, 1:] * _dense_ffn(tree, 1, x)
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-5)


def test_top2_second_choice_queues_after_first():
    """E=2, N=4, C=4: every first choice fits and keeps slots 0.. of its
    expert's queue; the second choices take the slots after them."""
    E = 2
    tree, p = _params(8, e=E)
    x = _tokens(n=4)
    first = _routes_agree(tree, p, x, float(E), top_k=1)
    both = _routes_agree(tree, p, x, float(E) / 2, top_k=2)
    count1 = first[0].sum((0, 2))                   # first choices per expert
    second = both[0] - first[0]
    for e in range(E):
        slots = np.nonzero(second[:, e].sum(0))[0]
        assert (slots >= count1[e]).all()
    (y1, _), _ = _both(tree, p, x, capacity_factor=float(E), top_k=1)
    (y2, _), (jy2, _) = _both(tree, p, x, capacity_factor=float(E) / 2, top_k=2)
    np.testing.assert_allclose(y2, jy2, **TOL)
    assert np.isfinite(y2).all() and not np.allclose(y1, y2)


@pytest.mark.parametrize("bad,match", [(dict(top_k=3), "top_k"), (dict(groups=4), "divide")])
def test_top_k_and_groups_are_validated(bad, match):
    _, p = _params(9)
    x = torch.from_numpy(_tokens(n=10))
    with pytest.raises(ValueError, match=match):
        moe.switch_ffn(p, x, **bad)
    with pytest.raises(ValueError, match=match):
        moe.route(p, x, **bad)


# (E, top_k, groups, capacity_factor, compute dtype, exact gelu)
CASES = [(4, 1, 1, 1.25, "float32", True), (4, 1, 4, 1.0, "float32", False),
         (3, 2, 2, 1.25, "float32", True), (4, 2, 1, 0.5, "float32", True),
         (4, 1, 4, 1.25, "bfloat16", True), (2, 2, 2, 1.0, "bfloat16", True)]


@pytest.mark.parametrize("E,top_k,groups,cf,dtype,gelu", CASES)
def test_switch_ffn_matches_jax(E, top_k, groups, cf, dtype, gelu):
    """Routes, outputs, the three aux losses and (f32) the gradients of x
    and every parameter under sum(y * w) + balance + router_z."""
    tree, p = _params(10 + E, h=8, f=16, e=E)
    x = _tokens(n=24, seed=E + top_k)
    _routes_agree(tree, p, x, cf, groups, top_k)
    kw = dict(capacity_factor=cf, groups=groups, top_k=top_k, gelu_exact=gelu,
              compute_dtype=dtype)
    (y, aux), (jy, jaux) = _both(tree, p, x, **kw)
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(y, jy, **tol)
    for k in jaux:
        assert aux[k] == pytest.approx(jaux[k], rel=1e-5, abs=1e-6), k
    if dtype != "float32":
        return
    w = np.random.default_rng(1).normal(size=y.shape).astype(np.float32)

    def jloss(tree, x):
        y, a = jmoe.switch_ffn(tree, x, **{**kw, "compute_dtype": jnp.float32})
        return jnp.sum(y * w) + a["balance"] + a["router_z"]

    jg_tree, jg_x = jax.grad(jloss, argnums=(0, 1))(tree, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t, a_t = moe.switch_ffn(p, xt, **{**kw, "compute_dtype": torch.float32})
    (torch.sum(y_t * torch.from_numpy(w)) + a_t["balance"] + a_t["router_z"]).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p.gate.grad.numpy(), np.asarray(jg_tree["gate"]["kernel"]),
                               rtol=1e-4, atol=1e-5)
    for k in ("w_in", "b_in", "w_out", "b_out"):
        np.testing.assert_allclose(getattr(p, k).grad.numpy(), np.asarray(jg_tree[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def _bert_cfgs(**kw):
    jb = dataclasses.replace(jbert.BertConfig(vocab_size=64, hidden_size=16, num_layers=2,
                                              num_heads=2, intermediate_size=32,
                                              max_position_embeddings=32), moe_experts=2, **kw)
    pb = BertConfig(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
                    intermediate_size=32, max_position_embeddings=32, moe_experts=2, **kw)
    return jb, pb


@pytest.mark.parametrize("group", [True, False])
def test_bert_encode_returns_hidden_and_aux(group):
    """(hidden, aux) with each aux averaged over the layers, as JAX's."""
    jb, pb = _bert_cfgs(moe_group_by_example=group)
    tree = jax.tree_util.tree_map(np.asarray, jbert.init_bert_params(jax.random.PRNGKey(0), jb))
    enc = load_jax_params(BertEncoder(pb), tree)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 64, size=(4, 10))
    mask = np.ones((4, 10), np.int32)
    mask[1, 6:] = 0
    jh, jaux = jbert.bert_encode(tree, jb, jnp.asarray(ids), jnp.asarray(mask),
                                 compute_dtype=jnp.float32)
    h, aux = enc(torch.from_numpy(ids), torch.from_numpy(mask), compute_dtype=torch.float32)
    assert h.shape == (4, 10, 16) and set(aux) == {"balance", "router_z", "drop_frac"}
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **TOL)
    for k in aux:
        assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=1e-5), k
    assert float(aux["balance"]) >= 1.0 - 1e-5


KW = dict(use_bert=True, batch_size=8, compute_dtype="float32", hidden_size=16,
          visual_size=5, acoustic_size=6, vocab_size=64, moe_experts=2, data="mosei",
          bucket_sizes=(8,), max_seq_len=8)


def _split(n=8, seed=0):
    return make_split(SyntheticSpec(num_examples=n, max_len=8, visual_size=5, acoustic_size=6,
                                    vocab_size=64, bert_vocab_size=64, seed=seed))


def test_misa_step_gradients_match_jax_grad():
    """One MISA step with a MoE tower against `jax.grad` op by op (the mosei
    freeze rule: a two-layer tower's layers frozen, so only the embeddings,
    the pooler... train in it): the objective's terms, `moe` included, and
    every trainable gradient; then with the freeze rule off, the routers'
    gradients, which must be non-zero."""
    jb, pb = _bert_cfgs()
    jcfg, cfg = JConfig(use_pallas=False, **KW), Config(device="cpu", **KW)
    tree = jax.tree_util.tree_map(np.asarray, jmisa.init_misa_params(
        jax.random.PRNGKey(3), jcfg, bert_cfg=jb))
    arrays = _split()
    jbatch = jmisa.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    from mmda_tpu_torch.models import Batch

    batch = Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    batch = batch._replace(**{k: getattr(batch, k).long() for k in ("text", "bert_ids",
                                                                     "bert_type")})
    for frozen in (True, False):
        mask = jax.tree_util.tree_map(lambda _: False, tree)
        if frozen:
            mask["bert"] = jbert.frozen_mask(tree["bert"], max_frozen_layer=8)

        def loss_fn(p):
            p = jax.tree_util.tree_map(lambda a, f: jax.lax.stop_gradient(a) if f else a,
                                       p, mask)
            losses = jobjective.compute_losses(
                jcfg, jmisa.misa_forward(p, jcfg, jbatch, bert_cfg=jb, deterministic=True),
                jbatch)
            return losses["total"], losses

        jgrads, jlosses = jax.grad(loss_fn, has_aux=True)(tree)
        model = load_jax_params(MISA(cfg, bert_cfg=pb), tree).eval()
        if frozen:
            freeze_layers(model.bert, 8)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        losses, grads = loss_and_grads(model, batch, cfg, [p for _, p in named])
        assert set(losses) == set(jlosses) and float(losses["moe"]) != 0.0
        for k in losses:
            np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        for (name, _), g in zip(named, grads):
            path = jax_name(model, name)
            want = jgrads
            for part in path.split("."):
                want = want[int(part)] if isinstance(want, list) else want[part]
            got = to_port_layout(g) if transposed(path) else g
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3,
                                       err_msg=path)
            if ".moe.gate" in name:
                assert np.abs(got.numpy()).max() > 0, name
        assert frozen == (not any(".moe." in n for n, _ in named))


def test_trainer_rejects_bad_moe_configs(tmp_path):
    """The JAX trainer's own errors (no BERT tower; pipelined encoder), and
    tensor parallelism, which the port does not have."""
    data = {k: _split() for k in ("train", "dev", "test")}
    base = {**KW, "ckpt_dir": str(tmp_path), "device": "cpu"}
    with pytest.raises(ValueError, match="use_bert"):
        Trainer(Config(**{**base, "use_bert": False}), data)
    with pytest.raises(ValueError, match="pp_size"):
        Trainer(Config(**base, pp_size=2), data)
    with pytest.raises(ValueError, match="ROADMAP"):
        Trainer(Config(**base, tp_size=2), data)


def _reqs(n=3, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for L in (5, 8, 2)[:n]:
        out.append({"text": rng.integers(1, 64, size=L).astype(np.int32),
                    "visual": rng.normal(size=(L, 5)).astype(np.float32),
                    "acoustic": rng.normal(size=(L, 6)).astype(np.float32),
                    "bert_ids": rng.integers(3, 64, size=L + 2).astype(np.int32),
                    "bert_type": np.zeros(L + 2, np.int32),
                    "bert_mask": np.ones(L + 2, np.int32)})
    return out


def test_moe_checkpoint_serves_in_both_packages(tmp_path):
    """A port Trainer's MoE best-on-dev export loads into the JAX package's
    Predictor, and a JAX MoE tree into the port's: the same scores (1e-4);
    and the port's export of it as a serving artifact."""
    from mmda_tpu_torch.serving_export import ExportedPredictor, export_model

    jb, pb = _bert_cfgs()
    data = {k: _split(seed=1) for k in ("train", "dev", "test")}
    cfg = Config(**KW, device="cpu", n_epoch=1, name="moe_serve", ckpt_dir=str(tmp_path))
    Trainer(cfg, data, bert_cfg=pb).train()
    jcfg = JConfig(use_pallas=False, **{**KW, "name": "moe_serve"})
    template = jmisa.init_misa_params(jax.random.PRNGKey(0), jcfg, visual_size=5,
                                      acoustic_size=6, vocab_size=64, bert_cfg=jb)
    tree = jckpt.load_checkpoint(str(tmp_path), pckpt.best_model_name(cfg), template)
    assert "moe" in tree["bert"]["layers"][0]
    reqs = _reqs()
    pred = Predictor(cfg, bert_cfg=pb, visual_size=5, acoustic_size=6, vocab_size=64,
                     max_batch=8)
    jpred = JPredictor(jcfg, params=tree, bert_cfg=jb, max_batch=8)
    np.testing.assert_allclose(pred(reqs)["scores"], np.asarray(jpred(reqs)["scores"])[:3],
                               rtol=1e-4, atol=1e-4)

    jtree = jax.tree_util.tree_map(np.asarray, jmisa.init_misa_params(
        jax.random.PRNGKey(5), jcfg, visual_size=5, acoustic_size=6, vocab_size=64,
        bert_cfg=jb))
    from_jax = Predictor(cfg, params=jtree, bert_cfg=pb, max_batch=8)
    want = np.asarray(JPredictor(jcfg, params=jtree, bert_cfg=jb, max_batch=8)(reqs)["scores"])
    np.testing.assert_allclose(from_jax(reqs)["scores"], want[:3], rtol=1e-4, atol=1e-4)
    export_model(cfg, jtree, str(tmp_path / "artifact"), bert_cfg=pb, max_batch=8)
    got = ExportedPredictor(str(tmp_path / "artifact"), device="cpu")(reqs)
    np.testing.assert_allclose(got["scores"], from_jax(reqs)["scores"], rtol=1e-5, atol=1e-6)


def test_bert_config_for_carries_the_moe_options():
    cfg = Config(device="cpu", use_bert=True, moe_experts=4, moe_capacity_factor=2.0,
                 moe_top_k=2)
    bc = bert_config_for(cfg)
    assert (bc.moe_experts, bc.moe_capacity_factor, bc.moe_top_k,
            bc.moe_group_by_example) == (4, 2.0, 2, True)
    assert bert_config_for(Config(device="cpu", use_bert=True)).moe_experts == 0


def test_int8_leaves_the_experts_as_loaded():
    """quantize_bert_int8 on a MoE tower: q, k, v, attn_out quantized, the
    router and the experts untouched (as the JAX tree's `moe` leaves)."""
    _, pb = _bert_cfgs()
    enc = BertEncoder(pb)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in enc.named_parameters() if ".moe." in n}
    quantize_bert_int8(enc)
    for lp in enc.layers:
        assert all(isinstance(getattr(lp, n), QuantizedDense) for n in ("q", "k", "v",
                                                                         "attn_out"))
    after = {n: p for n, p in enc.named_parameters() if ".moe." in n}
    assert set(after) == set(before)
    assert all(torch.equal(after[n], before[n]) for n in before)


def test_hf_sparse_upcycling(tmp_path):
    """load_hf_weights with moe_experts > 0: every expert an exact copy of
    the file's FFN (the JAX loader's experts bit for bit), the router (H, E)
    drawn from a generator seeded by the layer index (reproducible)."""
    transformers = pytest.importorskip("transformers")

    hf_cfg = transformers.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                                     num_attention_heads=2, intermediate_size=64,
                                     max_position_embeddings=64, type_vocab_size=2)
    torch.manual_seed(5)
    model = transformers.BertModel(hf_cfg).eval()
    model.save_pretrained(tmp_path, safe_serialization=True)
    pcfg = dataclasses.replace(BertConfig.tiny(), moe_experts=2)
    sd = load_hf_weights(str(tmp_path), pcfg)
    assert "layers.0.ffn_in.weight" not in sd and "layers.0.moe.w_in" in sd
    jtree = jbert.load_hf_weights(str(tmp_path), dataclasses.replace(jbert.BertConfig.tiny(),
                                                                     moe_experts=2))
    dense_w = model.encoder.layer[0].intermediate.dense.weight.detach().numpy().T
    for i in range(2):
        for k in ("w_in", "b_in", "w_out", "b_out"):
            np.testing.assert_array_equal(sd[f"layers.{i}.moe.{k}"].numpy(),
                                          np.asarray(jtree["layers"][i]["moe"][k]))
        for e in range(2):
            np.testing.assert_array_equal(sd[f"layers.{i}.moe.w_in"][e].numpy(),
                                          model.encoder.layer[i].intermediate.dense.weight
                                          .detach().numpy().T)
    np.testing.assert_array_equal(sd["layers.0.moe.w_in"][1].numpy(), dense_w)
    assert sd["layers.0.moe.gate"].shape == (32, 2)
    assert not torch.equal(sd["layers.0.moe.gate"], sd["layers.1.moe.gate"])
    assert torch.equal(load_hf_weights(str(tmp_path), pcfg)["layers.1.moe.gate"],
                       sd["layers.1.moe.gate"])
    enc = BertEncoder(pcfg)
    enc.load_state_dict(sd, strict=True)
