"""The port's weight-only int8 BERT serving (models/bert.py::quantize_bert_int8,
`QuantizedDense`, `Predictor(bert_weights_dtype="int8")`) against the JAX
package's on the CPU:

* `w_q` (int8) and the per-output-channel scales bit for bit, on random
  weights and on a row whose values fall on round-half-to-even ties;
* the quantized dense and a tiny `bert_encode` on quantized weights against
  JAX's int8 path (`_apply_dense` with `kernel_q`, the fused QKV scales):
  f32 compute 1e-5, bf16 compute one bf16 ulp (2^-7 relative) plus 1e-3
  for a product summed in another order before its one rounding;
* the `Predictor` on a tiny-BERT MISA: int8 scores against the JAX int8
  `Predictor` at 1e-5, and against the port's f32-weight `Predictor` at the
  JAX test's `rtol 0.02, atol 0.005` (tests/test_int8_serving.py);
* only the six encoder denses are quantized; the rest keeps its dtype.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import get_model as jget_model
from mmda_tpu.serving import Predictor as JPredictor
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import load_jax_params
from mmda_tpu_torch.models.bert import (BertConfig, BertEncoder, Dense, QuantizedDense,
                                        bert_encode, dense, quantize_bert_int8,
                                        quantize_dense)
from mmda_tpu_torch.serving import Predictor

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

NAMES = ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")


def _tiny_pair(seed=0):
    tree = jbert.init_bert_params(jax.random.PRNGKey(seed), jbert.BertConfig.tiny())
    return tree, load_jax_params(BertEncoder(BertConfig.tiny()), tree)


def test_quantized_weights_equal_jax_bit_for_bit():
    tree, enc = _tiny_pair()
    want = jbert.quantize_bert_int8(tree)
    quantize_bert_int8(enc)
    for i, lp in enumerate(enc.layers):
        for name in NAMES:
            d = getattr(lp, name)
            assert isinstance(d, QuantizedDense) and d.weight_q.dtype == torch.int8
            w = want["layers"][i][name]
            np.testing.assert_array_equal(d.weight_q.numpy().T, np.asarray(w["kernel_q"]))
            np.testing.assert_array_equal(d.scale.numpy(), np.asarray(w["scale"]))
            np.testing.assert_array_equal(d.bias.detach().numpy(), np.asarray(w["bias"]))
    assert isinstance(enc.pooler, Dense) and enc.embeddings.word.dtype == torch.float32


def test_ties_round_half_to_even_as_jax():
    """A row with max |w| = 31.75 has s = 0.25, so w / s lands on halves:
    0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -1.5 -> -2, 126.5 -> 126."""
    w = np.asarray([[31.75, 0.125, 0.375, 0.625, -0.125, -0.375, 31.625, 0.0]], np.float32)
    d = Dense(8, 1)
    with torch.no_grad():
        d.weight.copy_(torch.from_numpy(w))
        d.bias.zero_()
    q = quantize_dense(d)
    jq = jbert.quantize_bert_int8({"layers": [{"q": {"kernel": jnp.asarray(w.T),
                                                     "bias": jnp.zeros(1)}}]})
    np.testing.assert_array_equal(q.weight_q.numpy().T, np.asarray(jq["layers"][0]["q"]["kernel_q"]))
    np.testing.assert_array_equal(q.weight_q.numpy()[0], [127, 0, 2, 2, 0, -2, 126, 0])
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq["layers"][0]["q"]["scale"]))


def _close_bf16(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_less(np.abs(got - want), atol + 2.0 ** -7 * np.abs(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_dense_matches_jax(dtype):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(48, 40)) * 0.05).astype(np.float32)      # (in, out), JAX layout
    b = (rng.normal(size=40) * 0.01).astype(np.float32)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    jq = jbert.quantize_bert_int8({"layers": [{"q": {"kernel": jnp.asarray(w),
                                                     "bias": jnp.asarray(b)}}]})["layers"][0]["q"]
    jd = getattr(jnp, dtype)
    want = jbert._apply_dense(jq, jnp.asarray(x).astype(jd), jd)
    d = Dense(48, 40)
    with torch.no_grad():
        d.weight.copy_(torch.from_numpy(w.T))
        d.bias.copy_(torch.from_numpy(b))
    td = getattr(torch, dtype)
    got = dense(torch.from_numpy(x).to(td), quantize_dense(d), td)
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        _close_bf16(got.float().numpy(), np.asarray(want, np.float32), 1e-3)


@pytest.mark.parametrize("d_in,d_out", [(48, 40), (96, 200), (200, 64)])
def test_quantized_dense_bf16_rounds_once(d_in, d_out):
    """The bf16 int8 dense keeps the product in f32 and rounds once, after
    the scale: against the float64 product scaled and rounded to bf16 once
    (+ bias in bf16), at most 1e-3 of the outputs differ (f32 summation
    order).  Rounding the product to bf16 before the scale, as a dense
    whose matmul returns bf16 would, misses more than a tenth of them."""
    rng = np.random.default_rng(d_in)
    d = Dense(d_in, d_out)
    with torch.no_grad():
        d.weight.copy_(torch.from_numpy(rng.normal(size=(d_out, d_in)).astype(np.float32) * 0.02))
        d.bias.copy_(torch.from_numpy(rng.normal(size=d_out).astype(np.float32) * 0.02))
    q = quantize_dense(d)
    bf = torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(512, d_in)).astype(np.float32)).to(bf)
    got = dense(x, q, bf)
    ref = ((x.double() @ q.weight_q.double().t()) * q.scale.double()).to(bf) + q.bias.to(bf)
    twice = ((x @ q.weight_q.to(bf).t()).float() * q.scale).to(bf) + q.bias.to(bf)
    assert got.dtype == bf
    assert (got != ref).float().mean().item() <= 1e-3
    assert (twice != ref).float().mean().item() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_encode_int8_matches_jax(dtype):
    tree, enc = _tiny_pair(seed=2)
    qtree = jbert.quantize_bert_int8(tree)
    quantize_bert_int8(enc)
    rng = np.random.default_rng(4)
    ids = rng.integers(5, 128, size=(3, 9))
    mask = np.ones((3, 9), np.int64)
    mask[1, 5:] = 0
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jbert.bert_encode(qtree, jbert.BertConfig.tiny(), jnp.asarray(ids, jnp.int32),
                             jnp.asarray(mask, jnp.int32), deterministic=True,
                             compute_dtype=jd)
    with torch.no_grad():
        got = bert_encode(enc, torch.from_numpy(ids), torch.from_numpy(mask), None, td)
    real = mask.astype(bool)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                                   rtol=1e-5, atol=1e-5)
    else:
        # bf16 through two layers: a value on a rounding boundary may round
        # the other way and carry on; held at 2e-2 as the bf16 forward tests
        np.testing.assert_allclose(got.float().numpy()[real],
                                   np.asarray(want, np.float32)[real], rtol=2e-2, atol=2e-2)


def _serving_setup():
    kw = dict(hidden_size=16, visual_size=5, acoustic_size=6, vocab_size=64,
              embedding_size=8, compute_dtype="float32", use_bert=True, batch_size=8,
              bucket_sizes=(4, 8), max_seq_len=8)
    jbert_cfg = jbert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                                 intermediate_size=64, max_position_embeddings=64)
    bert_cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                          intermediate_size=64, max_position_embeddings=64)
    init_fn, _ = jget_model("MISA")
    tree = init_fn(jax.random.PRNGKey(0), JConfig(log_sinks=(), **kw), bert_cfg=jbert_cfg)
    rng = np.random.default_rng(3)

    def req(L):
        return {"text": rng.integers(2, 64, size=L).astype(np.int32),
                "visual": rng.normal(size=(L, 5)).astype(np.float32),
                "acoustic": rng.normal(size=(L, 6)).astype(np.float32),
                "bert_ids": rng.integers(3, 64, size=L + 2).astype(np.int32),
                "bert_type": np.zeros(L + 2, np.int32),
                "bert_mask": np.ones(L + 2, np.int32)}

    return kw, jbert_cfg, bert_cfg, tree, [req(3), req(7), req(2), req(5)]


def test_predictor_int8_matches_jax_int8_and_f32():
    kw, jbert_cfg, bert_cfg, tree, reqs = _serving_setup()
    cfg = Config(device="cpu", **kw)
    q = Predictor(cfg, params=tree, bert_cfg=bert_cfg, max_batch=8, bert_weights_dtype="int8")
    assert q.model.bert.layers[0].q.weight_q.dtype == torch.int8
    assert q.model.bert.embeddings.word.dtype == torch.float32       # kept as loaded
    full = Predictor(cfg, params=tree, bert_cfg=bert_cfg, max_batch=8, bert_weights_dtype=None)
    jq = JPredictor(JConfig(log_sinks=(), **kw), params=tree, bert_cfg=jbert_cfg, max_batch=8,
                    bert_weights_dtype="int8")
    got, want, f32 = q(reqs), jq(reqs), full(reqs)
    for k in ("scores", "tcp", "hidden"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["scores"], f32["scores"], rtol=0.02, atol=0.005)
    assert np.isfinite(got["scores"]).all()
    assert not np.array_equal(got["scores"], f32["scores"])          # int8 really ran


def test_quantize_in_place_on_a_model_and_without_bert():
    kw, _, bert_cfg, tree, reqs = _serving_setup()
    cfg = Config(device="cpu", **kw)
    from mmda_tpu_torch.models import MISA

    model = load_jax_params(MISA(cfg, bert_cfg=bert_cfg), tree)
    pred = Predictor(cfg, params=model, bert_cfg=bert_cfg, max_batch=8,
                     bert_weights_dtype="int8")
    assert pred.model is model and isinstance(model.bert.layers[1].ffn_out, QuantizedDense)
    glove = Config(device="cpu", **{**kw, "use_bert": False})
    init_fn, _ = jget_model("MISA")
    gtree = init_fn(jax.random.PRNGKey(1), JConfig(log_sinks=(), **{**kw, "use_bert": False}))
    out = Predictor(glove, params=gtree, max_batch=8, bert_weights_dtype="int8")(reqs)
    assert np.isfinite(out["scores"]).all()
