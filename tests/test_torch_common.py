"""The port's pure ops and layer primitives (mmda_tpu_torch/ops/functions.py,
models/common.py) against the JAX package's, on the same numpy inputs.

Tolerances: elementwise ops exact or 1e-6; LayerNorm and the fusion
transformer layer 1e-5 abs/rel (f32, summation order only).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.models import common as jcommon
from mmda_tpu.ops import functions as jfn
from mmda_tpu_torch.convert import load_jax_params
from mmda_tpu_torch.models import common
from mmda_tpu_torch.ops import functions as fn

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.mark.parametrize("name", sorted(jfn.ACTIVATION_FNS))
def test_activation_registry_matches_jax(name):
    x = RNG.normal(size=(5, 7)).astype(np.float32) * 2
    got = fn.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfn.get_activation(name)(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_binarize_masked_mean_length_mask_reverse_grad():
    s = np.array([[0.35, 0.3500001, 0.9, 0.0]], np.float32)
    np.testing.assert_array_equal(fn.binarize(torch.from_numpy(s), 0.35).numpy(),
                                  np.asarray(jfn.binarize(jnp.asarray(s), 0.35)))
    x = RNG.normal(size=(3, 6, 4)).astype(np.float32)
    mask = np.array([[1, 1, 0, 0, 0, 0], [1] * 6, [1, 0, 1, 0, 1, 0]], np.int32)
    np.testing.assert_allclose(
        fn.masked_mean(torch.from_numpy(x), torch.from_numpy(mask)).numpy(),
        np.asarray(jfn.masked_mean(jnp.asarray(x), jnp.asarray(mask))), rtol=1e-6)
    lengths = np.array([0, 3, 6])
    np.testing.assert_array_equal(
        fn.length_mask(torch.from_numpy(lengths), 6).numpy(),
        np.asarray(jfn.length_mask(jnp.asarray(lengths), 6)))
    t = torch.from_numpy(x)
    assert torch.equal(fn.reverse_grad(t, 0.5), t)      # the identity forward
    with pytest.raises(KeyError):
        fn.get_activation("swish")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_and_layer_norm_match_jax(dtype):
    tree = jcommon.linear_params(jax.random.PRNGKey(0), 12, 5)
    x = RNG.normal(size=(4, 12)).astype(np.float32)
    lin = load_jax_params(common.Linear(12, 5), tree)
    got = lin(torch.from_numpy(x).to(getattr(torch, dtype)))
    want = jcommon.linear(tree, jnp.asarray(x).astype(dtype))
    assert got.dtype == getattr(torch, dtype)
    # bf16: the same f32 sum of the same bf16 products, one rounding: exact
    tol = 0.0 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    ln_tree = {"scale": RNG.normal(size=5).astype(np.float32),
               "bias": RNG.normal(size=5).astype(np.float32)}
    y = RNG.normal(size=(3, 5)).astype(np.float32) * 3 + 1
    ln = load_jax_params(common.LayerNorm(5), ln_tree)
    np.testing.assert_allclose(ln(torch.from_numpy(y)).numpy(),
                               np.asarray(jcommon.layer_norm(ln_tree, jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)


def test_transformer_layer_matches_jax():
    """The fusion layer: 2 heads over 6 tokens, FFN 2048, attention probs
    returned; with and without an additive key bias."""
    tree = jcommon.transformer_layer_params(jax.random.PRNGKey(1), 16)
    x = RNG.normal(size=(3, 6, 16)).astype(np.float32)
    bias = np.where(RNG.random((3, 6)) < 0.3, -1e9, 0.0).astype(np.float32)
    bias[:, 0] = 0.0
    layer = load_jax_params(common.TransformerLayer(16), tree)
    for b in (None, bias):
        want_out, want_p = jcommon.transformer_layer(
            tree, jnp.asarray(x), num_heads=2, return_attn=True,
            attn_bias=None if b is None else jnp.asarray(b))
        got_out, got_p = layer(torch.from_numpy(x), 2,
                               None if b is None else torch.from_numpy(b))
        np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-5)


def test_seeded_init_follows_torch_defaults():
    g = torch.Generator().manual_seed(0)
    lin = common.Linear(64, 8)
    lin.reset_parameters(g)
    assert float(lin.weight.abs().max()) <= 1 / 8 and float(lin.bias.abs().max()) <= 1 / 8
    layer = common.TransformerLayer(16)
    layer.reset_parameters(g)
    assert float(layer.in_proj.weight.abs().max()) <= np.sqrt(6 / 64)
    assert torch.all(layer.in_proj.bias == 0) and torch.all(layer.out_proj.bias == 0)
