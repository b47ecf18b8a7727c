"""The port's BERT encoder (mmda_tpu_torch/models/bert.py) against
`mmda_tpu.models.bert.bert_encode` at BertConfig.tiny(), on JAX-initialised
weights carried across by `mmda_tpu_torch.convert`.

f32: tolerance 1e-5 abs/rel (summation order only).  bf16: both sides round
at the same sites (dense outputs, LayerNorm outputs, attention probs), so
the outputs differ by at most a few bf16 units in the last place; the
bound is 0.05 on LayerNorm outputs of order 1.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import load_jax_params
from mmda_tpu_torch.models import bert


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _inputs(B=3, S=9, vocab=128, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    types = rng.integers(0, 2, size=(B, S)).astype(np.int32)
    lens = np.array([S, 2, 5][:B])
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return ids, types, mask


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_tiny_encoder_matches_jax(dtype, tol):
    bc = bert.BertConfig.tiny()
    tree = jbert.init_bert_params(jax.random.PRNGKey(1), jbert.BertConfig.tiny())
    ids, types, mask = _inputs()
    want = jbert.bert_encode(tree, jbert.BertConfig.tiny(), jnp.asarray(ids),
                             jnp.asarray(mask), jnp.asarray(types),
                             compute_dtype=jnp.dtype(dtype))
    enc = load_jax_params(bert.BertEncoder(bc), tree)
    got = bert.bert_encode(enc, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                           torch.from_numpy(types).long(), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 9, bc.hidden_size)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_apply_dense_rounds_like_jax():
    """f32 accumulation, one rounding to bf16, then + bias in bf16."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    want = jbert._apply_dense({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                              jnp.asarray(x).astype(jnp.bfloat16), jnp.bfloat16)
    got = bert.apply_dense(torch.from_numpy(x).bfloat16(), torch.from_numpy(w.T.copy()),
                           torch.from_numpy(b), torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_bert_config_for_matches_jax():
    for use_bert in (True, False):
        want = jbert.bert_config_for(JConfig(use_bert=use_bert))
        got = bert.bert_config_for(Config(use_bert=use_bert, device="cpu"))
        if want is None:
            assert got is None
        else:
            for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                      "intermediate_size", "max_position_embeddings",
                      "layer_norm_eps"):
                assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(NotImplementedError):
        bert.bert_config_for(Config(moe_experts=4, device="cpu"))


def test_seeded_init_draws_bert_distributions():
    enc = bert.BertEncoder(bert.BertConfig.tiny(vocab_size=4096))
    enc.reset_parameters(torch.Generator().manual_seed(0))
    w = enc.embeddings.word
    assert abs(float(w.std()) - 0.02 * 0.88) < 2e-3     # truncated at 2 std
    assert float(w.abs().max()) <= 0.04 + 1e-6
    assert torch.all(enc.layers[0].q.bias == 0)
    assert torch.all(enc.layers[0].attn_ln.weight == 1)
