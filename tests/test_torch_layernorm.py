"""The port's fused residual + dropout + LayerNorm (mmda_tpu_torch/ops/
kernels/layernorm.py) and its positional hash (hash_dropout.py) against the
JAX package's Pallas kernels (`mmda_tpu.ops.pallas.layernorm`) in interpret
mode, and the routing of the BERT layer's two sites.

Same inputs (numpy, seeded) into both.  The keep mask must be equal bit for
bit.  f32 outputs 1e-5 abs/rel (the same formulas, other summation orders),
gradients 2e-4 (as the JAX package's own test: dg/db sum N rows in other
orders).  On the CPU the wrappers run the kernels' plain versions; the CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.models import bert as jbert
from mmda_tpu.ops.pallas import layernorm as pln
from mmda_tpu_torch.convert import load_jax_params
from mmda_tpu_torch.models import bert as pbert
from mmda_tpu_torch.ops.kernels import hash_dropout
from mmda_tpu_torch.ops.kernels import layernorm as kln

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _interpret_mode():
    pln.set_force_interpret(True)
    yield
    pln.set_force_interpret(False)


@pytest.mark.parametrize("row0", [0, 128, 3199, 2 ** 31 + 5])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("seed", [0, 77, 2 ** 31 - 2, -3])
def test_keep_mask_equals_the_jax_hash_bit_for_bit(seed, rate, row0):
    shape = (37, 130)
    want = np.asarray(pln._keep_mask(shape, rate, jnp.asarray(seed, jnp.int32), row0))
    got = hash_dropout.keep_mask(shape, rate, seed, row0)
    np.testing.assert_array_equal(got.numpy(), want)
    got_t = hash_dropout.keep_mask(shape, rate, torch.tensor([seed], dtype=torch.int32), row0)
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_keep_mask_rate_and_scale():
    keeps = hash_dropout.keep_mask((512, 256), 0.3, 5)
    assert abs(keeps.mean().item() - 0.7) < 0.01
    assert hash_dropout.keep_scale(0.1) == float(np.float32(1.0 / 0.9))
    # a row block's mask is the whole mask's rows: no dependence on blocking
    whole = hash_dropout.keep_mask((300, 64), 0.1, 9)
    assert torch.equal(hash_dropout.keep_mask((100, 64), 0.1, 9, row0=128), whole[128:228])


def _inputs(N, H, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in (("x", (N, H)), ("y", (N, H)), ("g", (H,)), ("b", (H,)),
                         ("dout", (N, H)))}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N,H", [(64, 32), (200, 128), (300, 128)])
def test_forward_and_gradients_match_pallas(N, H, rate):
    """200 and 300 rows: the TPU kernel pads them up to its 128-row blocks;
    the port's mask takes the absolute row, so nothing is padded."""
    eps = 1e-12
    a = _inputs(N, H, seed=N + H)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    jseed = jnp.array([77], jnp.int32)
    want, vjp = jax.vjp(lambda x, y, g, b: pln.residual_dropout_layernorm(
        x, y, g, b, jseed, rate, eps), j["x"], j["y"], j["g"], j["b"])
    want_grads = vjp(j["dout"])

    t = {k: torch.from_numpy(v).requires_grad_(k != "dout") for k, v in a.items()}
    seed = torch.tensor([77], dtype=torch.int32)
    got = kln.residual_dropout_layernorm(t["x"], t["y"], t["g"], t["b"], seed, rate, eps)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(got, [t["x"], t["y"], t["g"], t["b"]], t["dout"])
    for name, g, w in zip(("dx", "dy", "dscale", "dbias"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_backward_matches_autograd_through_the_plain_forward():
    a = _inputs(50, 24, seed=3)
    t = {k: torch.from_numpy(v).requires_grad_(k != "dout") for k, v in a.items()}
    seed = torch.tensor([5], dtype=torch.int32)
    out = kln.residual_dropout_layernorm_reference(t["x"], t["y"], t["g"], t["b"], seed,
                                                   0.25, 1e-5)
    want = torch.autograd.grad(out, [t["x"], t["y"], t["g"], t["b"]], t["dout"])
    got = kln.residual_dropout_layernorm_bwd(t["x"].detach(), t["y"].detach(), t["g"].detach(),
                                             t["dout"], seed, 0.25, 1e-5)
    for name, g, w in zip(("dx", "dy", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)
    # a dropped element passes no gradient to y
    keep = hash_dropout.keep_mask((50, 24), 0.25, seed)
    assert torch.all(got[1][keep == 0] == 0) and torch.any(got[1][keep == 1] != 0)


def test_bf16_inputs_keep_f32_statistics_and_round_once():
    """bf16 x and y (the training path's dtype): out, dx, dy come back in
    bf16, dscale and dbias in f32, and the result is the f32 computation on
    the upcast inputs rounded once."""
    a = _inputs(40, 64, seed=9)
    seed = torch.tensor([3], dtype=torch.int32)
    x, y, dout = (torch.from_numpy(a[k]).bfloat16() for k in ("x", "y", "dout"))
    g, b = torch.from_numpy(a["g"]), torch.from_numpy(a["b"])
    out = kln.residual_dropout_layernorm_fwd(x, y, g, b, seed, 0.1, 1e-12)
    want = kln.residual_dropout_layernorm_reference(x.float(), y.float(), g, b, seed, 0.1, 1e-12)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want.bfloat16())
    dx, dy, dg, db = kln.residual_dropout_layernorm_bwd(x, y, g, dout, seed, 0.1, 1e-12)
    assert dx.dtype == dy.dtype == torch.bfloat16 and dg.dtype == db.dtype == torch.float32


def test_seed_changes_the_mask_and_gets_no_gradient():
    a = _inputs(64, 32, seed=1)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    outs = [kln.residual_dropout_layernorm(t["x"], t["y"], t["g"], t["b"],
                                           torch.tensor([s], dtype=torch.int32), 0.3)
            for s in (1, 2, 1)]
    assert not torch.allclose(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    none = kln.residual_dropout_layernorm(t["x"], t["y"], t["g"], t["b"])   # rate 0, no seed
    torch.testing.assert_close(none, torch.nn.functional.layer_norm(
        t["x"] + t["y"], (32,), t["g"], t["b"], 1e-12), **TOL)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "shape_y", "shape_g", "contig",
                                 "device_mix", "no_seed", "seed_dtype", "rate"])
def test_wrappers_reject_what_the_kernels_cannot_take(bad):
    t = {k: torch.from_numpy(v) for k, v in _inputs(6, 8, seed=2).items()}
    seed, rate = torch.tensor([1], dtype=torch.int32), 0.1
    if bad == "dtype":
        t["x"], t["y"] = t["x"].double(), t["y"].double()
    elif bad == "mixed_dtype":
        t["y"] = t["y"].bfloat16()
    elif bad == "shape_y":
        t["y"] = t["y"][:-1].contiguous()
    elif bad == "shape_g":
        t["g"] = t["g"][None]
    elif bad == "contig":
        t["x"] = t["x"].t().contiguous().t()
    elif bad == "device_mix":
        t["y"] = t["y"].to("meta")
    elif bad == "no_seed":
        seed = None
    elif bad == "seed_dtype":
        seed = seed.long()
    else:
        rate = 1.0
    with pytest.raises((TypeError, ValueError)):
        kln.residual_dropout_layernorm_fwd(t["x"], t["y"], t["g"], t["b"], seed, rate)
    with pytest.raises((TypeError, ValueError)):
        kln.residual_dropout_layernorm_bwd(t["x"], t["y"], t["g"], t["dout"], seed, rate)


def test_cpu_calls_do_not_count_as_launches_and_grid_covers_the_rows():
    kln.reset_launch_count()
    t = {k: torch.from_numpy(v) for k, v in _inputs(6, 8, seed=2).items()}
    kln.residual_dropout_layernorm_fwd(t["x"], t["y"], t["g"], t["b"], None)
    kln.residual_dropout_layernorm_bwd(t["x"], t["y"], t["g"], t["dout"], None)
    assert kln.launch_count("ln_dropout_fwd") == 0 and kln.launch_count("ln_dropout_bwd") == 0
    assert kln.bwd_blocks(3200, 132) == 264 and kln.bwd_blocks(6, 132) == 2
    assert kln.bwd_blocks(1, 132) == 1


# ------------------------------------------------------- the BERT layer's sites


def _tiny_bert(fused):
    jcfg = jbert.BertConfig.tiny()
    tree = jbert.init_bert_params(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(pbert.BertConfig.tiny(), fused_ln_dropout=fused)
    return load_jax_params(pbert.BertEncoder(cfg), tree), jcfg, tree


def test_bert_layer_fused_ln_routing(monkeypatch):
    """`BertConfig.fused_ln_dropout` routes both per-layer LN sites through
    the fused function under the JAX package's condition: the deterministic
    output equals the plain path's exactly (the kernel is not engaged) and
    matches the JAX encoder; the training output is finite, differs from the
    deterministic one, calls the fused function twice per layer with a seed
    in [0, 2^31 - 1) and the compute dtype, and backprops finite gradients
    through both sites; with hidden_dropout = 0 the site is not engaged."""
    rng = np.random.default_rng(11)
    plain, jcfg, tree = _tiny_bert(False)
    fused, _, _ = _tiny_bert(True)
    B, S = 2, 12
    ids = rng.integers(5, 128, size=(B, S))
    tids, tmask = torch.from_numpy(ids), torch.ones(B, S, dtype=torch.int64)

    calls = []
    real = pbert.residual_dropout_layernorm

    def spy(x, y, scale, bias, seed, rate, eps):
        calls.append((tuple(x.shape), x.dtype, int(seed), rate, eps))
        return real(x, y, scale, bias, seed, rate, eps)

    monkeypatch.setattr(pbert, "residual_dropout_layernorm", spy)
    with torch.no_grad():
        det_plain = plain(tids, tmask, compute_dtype=torch.float32)
        det_fused = fused(tids, tmask, compute_dtype=torch.float32)
    assert torch.equal(det_plain, det_fused) and not calls
    want = jbert.bert_encode(tree, dataclasses.replace(jcfg, fused_ln_dropout=True),
                             jnp.asarray(ids, jnp.int32), jnp.ones((B, S), jnp.int32),
                             deterministic=True, compute_dtype=jnp.float32)
    np.testing.assert_allclose(det_fused.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    gen = torch.Generator().manual_seed(3)
    out = fused(tids, tmask, compute_dtype=torch.float32, training=True, generator=gen)
    assert len(calls) == 2 * len(fused.layers)
    for shape, dtype, seed, rate, eps in calls:
        assert shape == (B * S, 32) and dtype == torch.float32
        assert 0 <= seed < 2 ** 31 - 1 and rate == 0.1 and eps == 1e-12
    assert len({c[2] for c in calls}) == len(calls)          # a fresh seed per site
    assert torch.isfinite(out).all() and not torch.allclose(out, det_fused)
    (out ** 2).sum().backward()
    for name, p in fused.named_parameters():
        if not name.startswith("pooler."):       # the last hidden state skips the pooler
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert fused.layers[0].attn_ln.weight.grad.abs().sum() > 0

    calls.clear()
    no_drop = load_jax_params(pbert.BertEncoder(dataclasses.replace(
        pbert.BertConfig.tiny(), fused_ln_dropout=True, hidden_dropout=0.0)), tree)
    no_drop(tids, tmask, compute_dtype=torch.float32, training=True, generator=gen)
    assert not calls


def test_bert_config_for_passes_the_flag_on():
    from mmda_tpu_torch.config import Config

    assert pbert.bert_config_for(Config(device="cpu", fused_ln_dropout=True)).fused_ln_dropout
    assert not pbert.bert_config_for(Config(device="cpu")).fused_ln_dropout
    assert pbert.bert_config_for(Config(device="cpu", use_bert=False)) is None
    assert pbert.bert_config_for(Config(device="cpu")) == pbert.BertConfig.base()
