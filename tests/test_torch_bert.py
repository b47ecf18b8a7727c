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

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)


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
    moe = dict(use_bert=True, moe_experts=4, moe_capacity_factor=2.0, moe_top_k=2)
    want = jbert.bert_config_for(JConfig(**moe))
    got = bert.bert_config_for(Config(device="cpu", **moe))
    for f in ("moe_experts", "moe_capacity_factor", "moe_top_k", "moe_group_by_example"):
        assert getattr(got, f) == getattr(want, f), f


def test_seeded_init_draws_bert_distributions():
    enc = bert.BertEncoder(bert.BertConfig.tiny(vocab_size=4096))
    enc.reset_parameters(torch.Generator().manual_seed(0))
    w = enc.embeddings.word
    assert abs(float(w.std()) - 0.02 * 0.88) < 2e-3     # truncated at 2 std
    assert float(w.abs().max()) <= 0.04 + 1e-6
    assert torch.all(enc.layers[0].q.bias == 0)
    assert torch.all(enc.layers[0].attn_ln.weight == 1)


@pytest.fixture
def flash_interpreted():
    """The JAX package's flash kernels in interpret mode (off the TPU its
    bert_encode takes the dense core unless a test forces them)."""
    from mmda_tpu.ops.pallas import attention as jattn

    calls, forward = [], jattn._flash_forward
    jattn._flash_forward = lambda *a, **k: calls.append(1) or forward(*a, **k)
    jattn.set_force_interpret(True)
    yield
    jattn.set_force_interpret(False)
    jattn._flash_forward = forward
    assert calls, "the JAX side never reached its flash kernel"


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_tiny_encoder_flash_matches_jax(dtype, tol, flash_interpreted):
    """attn_impl="flash", deterministic: the JAX encoder through its Pallas
    kernels, the port through the plain version of its kernels.  f32 2e-4:
    the online softmax and the whole-row softmax differ in summation order,
    carried through two layers."""
    bc = bert.BertConfig.tiny()
    tree = jbert.init_bert_params(jax.random.PRNGKey(1), jbert.BertConfig.tiny())
    ids, types, mask = _inputs(S=21)
    want = jbert.bert_encode(tree, jbert.BertConfig.tiny(), jnp.asarray(ids),
                             jnp.asarray(mask), jnp.asarray(types),
                             compute_dtype=jnp.dtype(dtype), attn_impl="flash")
    enc = load_jax_params(bert.BertEncoder(bc), tree)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask),
            torch.from_numpy(types).long(), getattr(torch, dtype))
    got = bert.bert_encode(enc, *args, attn_impl="flash")
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 21, bc.hidden_size)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    # and the module's forward passes the argument on
    assert torch.equal(enc(*args, attn_impl="flash"), got)
    dense = bert.bert_encode(enc, *args)
    assert not torch.equal(dense, got)
    np.testing.assert_allclose(dense.float().numpy(), got.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_positions_beyond_the_table_read_its_last_row(attn_impl, request):
    """S > max_position_embeddings: the JAX package's gather clamps the
    index, so the rows beyond the table take its last position embedding."""
    if attn_impl == "flash":
        request.getfixturevalue("flash_interpreted")
    jbc = jbert.BertConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                           intermediate_size=64, max_position_embeddings=8)
    bc = bert.BertConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                         intermediate_size=64, max_position_embeddings=8)
    tree = jbert.init_bert_params(jax.random.PRNGKey(3), jbc)
    ids, types, mask = _inputs(S=11)
    mask[0] = 1                                   # the rows beyond the table are real tokens
    want = jbert.bert_encode(tree, jbc, jnp.asarray(ids), jnp.asarray(mask),
                             jnp.asarray(types), compute_dtype=jnp.float32,
                             attn_impl=attn_impl)
    enc = load_jax_params(bert.BertEncoder(bc), tree)
    got = bert.bert_encode(enc, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                           torch.from_numpy(types).long(), torch.float32,
                           attn_impl=attn_impl)
    assert got.shape == (3, 11, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_positions_beyond_the_table_add_no_gradient_to_its_last_row():
    """S > max_position_embeddings: jax.grad of the clamped gather drops what
    the positions beyond the table would add to its last row, and so does
    the port: the position table's gradient equals the JAX one, and it
    differs from the gradient that adds them."""
    jbc = jbert.BertConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                           intermediate_size=64, max_position_embeddings=8)
    bc = bert.BertConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                         intermediate_size=64, max_position_embeddings=8)
    tree = jbert.init_bert_params(jax.random.PRNGKey(3), jbc)
    ids, types, mask = _inputs(S=11)
    w = np.random.default_rng(1).normal(size=(3, 11, 32)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jbert.bert_encode(
        t, jbc, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types),
        compute_dtype=jnp.float32) * w))(tree)["embeddings"]["position"]
    enc = load_jax_params(bert.BertEncoder(bc), tree)
    with torch.enable_grad():      # the file's fixture turns autograd off
        out = bert.bert_encode(enc, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                               torch.from_numpy(types).long(), torch.float32)
        got, = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                   [enc.embeddings.position])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert np.abs(np.asarray(want)[-1]).max() > 0


def test_flash_dropout_draws_its_seed_from_the_generator():
    """Training with attn_impl="flash": the probs dropout is the kernel's
    (a per-layer seed drawn from the step's generator), so the same
    generator state gives the same output and another state another."""
    bc = bert.BertConfig.tiny()
    enc = bert.BertEncoder(bc)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    ids, types, mask = _inputs(S=12)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask),
            torch.from_numpy(types).long(), torch.float32)

    def run(seed):
        return bert.bert_encode(enc, *args, training=True, attn_impl="flash",
                                generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    assert torch.isfinite(run(5)).all()


@pytest.fixture
def fused_interpreted():
    """The JAX package's short attention kernel in interpret mode (off the
    TPU its bert_encode takes the dense core unless a test forces it)."""
    from mmda_tpu.ops.pallas import short_attention as jsa

    calls, forward = [], jsa._fwd_call
    jsa._fwd_call = lambda *a, **k: calls.append(1) or forward(*a, **k)
    jsa.set_force_interpret(True)
    yield
    jsa.set_force_interpret(False)
    jsa._fwd_call = forward
    assert calls, "the JAX side never reached its short attention kernel"


def test_tiny_encoder_fused_matches_jax(fused_interpreted):
    """attn_impl="fused", deterministic, f32: the JAX encoder through its
    Pallas kernel, the port through the plain version of its kernels; 1e-5
    abs/rel (the file's f32 tolerance: both take the whole-row softmax in
    f32, summation order only)."""
    bc = bert.BertConfig.tiny()
    tree = jbert.init_bert_params(jax.random.PRNGKey(1), jbert.BertConfig.tiny())
    ids, types, mask = _inputs(S=13)
    want = jbert.bert_encode(tree, jbert.BertConfig.tiny(), jnp.asarray(ids),
                             jnp.asarray(mask), jnp.asarray(types),
                             compute_dtype=jnp.float32, attn_impl="fused")
    enc = load_jax_params(bert.BertEncoder(bc), tree)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask),
            torch.from_numpy(types).long(), torch.float32)
    got = bert.bert_encode(enc, *args, attn_impl="fused")
    assert got.dtype == torch.float32 and got.shape == (3, 13, bc.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(enc(*args, attn_impl="fused"), got)


def test_fused_attention_is_refused_by_name():
    """`fused` runs (it raised before its kernels existed) and draws its
    training dropout seed from the generator; a name that is none of the
    three cores still raises."""
    enc = bert.BertEncoder(bert.BertConfig.tiny())
    enc.reset_parameters(torch.Generator().manual_seed(0))
    ids, types, mask = _inputs()
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask), torch.from_numpy(types).long())
    out = bert.bert_encode(enc, *args, attn_impl="fused")
    assert out.shape == (3, 9, 32) and torch.isfinite(out.float()).all()

    def train(seed):
        return bert.bert_encode(enc, *args, torch.float32, training=True, attn_impl="fused",
                                generator=torch.Generator().manual_seed(seed))

    assert torch.equal(train(5), train(5)) and not torch.equal(train(5), train(6))
    with pytest.raises(ValueError):
        bert.bert_encode(enc, *args, attn_impl="nope")
