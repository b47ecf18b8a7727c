"""The port's blockwise attention (mmda_tpu_torch/ops/kernels/attention.py,
its plain versions on the CPU) against `mmda_tpu.ops.pallas.attention`
running its Pallas kernels in interpret mode.

The keep mask is compared bit for bit.  Forward and gradients: f32 within
1e-5 + 1e-4 |ref| (summation order only: the JAX kernel rescales per key
tile, the plain version forms the whole S x S matrix); bf16 within 2e-2
(forward) and 5e-2 (gradients), the JAX tests' own bounds for bf16 operands.
Last, the port's `Trainer` on a tiny model with the attention core resolved
to flash (it refused that before the kernels existed).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.ops.pallas import attention as jattn
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.data import synthetic as psynth
from mmda_tpu_torch.models.bert import BertConfig
from mmda_tpu_torch.ops.kernels import attention as tattn
from mmda_tpu_torch.ops.kernels.hash_dropout import attention_keep_mask
from mmda_tpu_torch.train.loop import Trainer

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret():
    jattn.set_force_interpret(True)
    yield
    jattn.set_force_interpret(False)


@pytest.mark.parametrize("seed,bh,row0,col0", [
    (0, 0, 0, 0), (7, 1, 0, 128), (12345, 23, 128, 0), (2 ** 31 - 2, 383, 512, 384),
    (-5, 3, 8, 640), (-2 ** 31, 11, 1024, 1024)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_bit_for_bit(seed, bh, row0, col0, rate):
    want = np.asarray(jattn._keep_mask((24, 128), rate, jnp.asarray(seed, jnp.int32),
                                       bh, row0, col0))
    got = attention_keep_mask((1, 24, 128), rate, torch.tensor([seed], dtype=torch.int32),
                              bh, row0, col0)
    assert got.shape == (1, 24, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert 0.0 < want.mean() < 1.0


def test_keep_mask_depends_on_the_batch_head_index():
    """bh is the flattened (batch, head) index of the whole call: a call on
    a slice of the batch draws another mask unless it is told its offset."""
    seed = torch.tensor([3], dtype=torch.int32)
    whole = attention_keep_mask((4, 16, 16), 0.3, seed)
    assert torch.equal(attention_keep_mask((2, 16, 16), 0.3, seed, bh0=2), whole[2:])
    assert not torch.equal(attention_keep_mask((2, 16, 16), 0.3, seed), whole[2:])
    assert torch.equal(attention_keep_mask((4, 16, 16), 0.3, 3), whole)       # int seed


def _inputs(BH, S, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(BH, S, D)).astype(np.float32) for _ in range(4))
    mask = np.ones((BH, S), np.float32)
    for b in range(1, BH):                    # masked tails of different lengths
        mask[b, S - (b * S) // (2 * BH) - 1:] = 0.0
    return q, k, v, g, ((1.0 - mask) * -1e9).astype(np.float32)


def _both(BH, S, D, dtype, rate, seed=1234):
    q, k, v, g, bias = _inputs(BH, S, D, seed=S + D)
    seed_arr = np.array([seed], np.int32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (q, k, v))
    out, vjp = jax.vjp(
        lambda a, b, c: jattn.flash_attention(a, b, c, jnp.asarray(bias),
                                              jnp.asarray(seed_arr), rate), jq, jk, jv)
    want = (out, *vjp(jnp.asarray(g)))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
                  for a in (q, k, v))
    o = tattn.flash_attention(tq, tk, tv, torch.from_numpy(bias), torch.from_numpy(seed_arr),
                              rate)
    got = (o, *torch.autograd.grad(o, [tq, tk, tv], torch.from_numpy(g)))
    return got, want


def _compare(got, want, dtype):
    assert got[0].dtype == torch.float32                      # o is f32 whatever the inputs
    for name, g, w, in zip(("o", "dq", "dk", "dv"), got, want):
        if name != "o":
            assert g.dtype == getattr(torch, dtype), name
        g, w = g.detach().float().numpy(), np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape and np.isfinite(g).all(), name
        if dtype == "float32":
            np.testing.assert_array_less(np.abs(g - w), 1e-5 + 1e-4 * np.abs(w) + 1e-30,
                                         err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=2e-2 if name == "o" else 5e-2, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("S", [64, 130, 258])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_matches_jax_kernel(S, dtype, rate):
    got, want = _both(3, S, 16, dtype, rate)
    _compare(got, want, dtype)


def test_flash_attention_matches_jax_kernel_at_514():
    got, want = _both(2, 514, 8, "float32", 0.1)
    _compare(got, want, "float32")


@pytest.mark.parametrize("case,dtype", [("do_rounded", "float32"), ("do_rounded", "bfloat16"),
                                        ("dsum_from_f32_do", "bfloat16")])
def test_backward_reads_do_in_the_operand_type(case, dtype):
    """The backward kernels read do in the operand type: their wrappers round
    the f32 d_out once.  do_rounded: a d_out already rounded to the operand
    type gives the same dq, dk, dv as the f32 one (with the same dsum), so the
    rounding in the wrapper changes no function, and both match the JAX
    kernels.  dsum_from_f32_do: rounding this do moves dsum = rowsum(do * o),
    so dsum must come from the f32 do, as the JAX package takes it: the
    port's backward does, and matches the JAX gradients; dsum from the
    rounded do would give other gradients."""
    BH, S, D, rate = 3, 130, 16, 0.1
    _, want = _both(BH, S, D, dtype, rate)
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(BH, S, D, seed=S + D))
    q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
    seed = torch.tensor([1234], dtype=torch.int32)
    o, lse = tattn.flash_attention_fwd(q, k, v, bias, seed, rate)
    g_rounded = g.to(q.dtype).float()
    dsum = tattn.row_dsum(g, o)

    def halves(d_out, dsum_):
        args = (q, k, v, bias, seed, d_out, lse, dsum_, rate)
        return (tattn.flash_attention_bwd_dq(*args), *tattn.flash_attention_bwd_dkv(*args))

    if case == "do_rounded":
        got = halves(g_rounded, dsum)
        for a, b in zip(got, halves(g, dsum)):
            assert torch.equal(a, b)
    else:
        dsum_rounded = tattn.row_dsum(g_rounded, o)
        assert (dsum_rounded - dsum).abs().max() > 0
        got = tattn.flash_attention_bwd(q, k, v, bias, seed, lse, o, g, rate)
        for a, b in zip(got, halves(g, dsum)):
            assert torch.equal(a, b)
        assert not torch.equal(halves(g, dsum_rounded)[0], got[0])
    _compare((o, *got), want, dtype)


def test_masked_keys_get_no_probability_and_no_gradient():
    """A key under the -1e9 bias is swallowed in f32: o ignores it, and its
    dk, dv are exactly zero."""
    q, k, v, g, bias = _inputs(2, 70, 16, seed=5)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = tattn.flash_attention(*t, torch.from_numpy(bias))
    dq, dk, dv = torch.autograd.grad(o, t, torch.from_numpy(g))
    masked = torch.from_numpy(bias) < 0
    assert masked.any() and torch.all(dk[masked] == 0) and torch.all(dv[masked] == 0)
    v2 = v.copy()
    v2[masked.numpy()] = 1e3
    o2 = tattn.flash_attention(t[0], t[1], torch.from_numpy(v2), torch.from_numpy(bias))
    assert torch.equal(o2, o)


def test_backward_halves_match_the_whole_backward():
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(3, 40, 16, seed=9))
    seed = torch.tensor([77], dtype=torch.int32)
    o, lse = tattn.flash_attention_fwd(q, k, v, bias, seed, 0.2)
    dsum = tattn.row_dsum(g, o)
    dq = tattn.flash_attention_bwd_dq(q, k, v, bias, seed, g, lse, dsum, 0.2)
    dk, dv = tattn.flash_attention_bwd_dkv(q, k, v, bias, seed, g, lse, dsum, 0.2)
    for a, b in zip((dq, dk, dv), tattn.flash_attention_bwd(q, k, v, bias, seed, lse, o, g, 0.2)):
        assert torch.equal(a, b)
    # autograd through the plain forward agrees with the explicit backward
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o2, _ = tattn.flash_attention_fwd_reference(*leaves, bias, seed, 0.2)
    for a, b in zip((dq, dk, dv), torch.autograd.grad(o2, leaves, g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(2, 8, 16)
    bias = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        tattn.flash_attention_fwd(q.double(), q.double(), q.double(), bias, None)
    with pytest.raises(TypeError):
        tattn.flash_attention_fwd(q, q.bfloat16(), q, bias, None)
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(q, q, q, bias[:, :4], None)
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(q, q.transpose(0, 1).contiguous().transpose(0, 1), q, bias, None)
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(q, q, q, bias, None, rate=0.1)        # needs a seed
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(q, q, q, bias, None, rate=1.0)
    with pytest.raises(TypeError):
        tattn.flash_attention_fwd(q, q, q, bias, torch.zeros(1, dtype=torch.int64), rate=0.1)
    assert tattn.launch_count("flash_fwd") == 0       # the CPU takes the plain version


@pytest.mark.parametrize("option,train_calls,eval_calls", [
    (dict(attn_impl="flash"), 2, 2),
    (dict(attn_impl="auto", max_seq_len=254, bucket_sizes=(254,), batch_size=4,
          extractor="transformer"), 2, 0)],
    ids=["flash", "auto-long"])
def test_trainer_trains_with_flash_attention(tmp_path, option, train_calls, eval_calls,
                                             monkeypatch):
    """attn_impl="flash" (and "auto" at S = 256, which resolves to it for
    training and to the dense core for eval) used to be refused: every
    training step now goes through `flash_attention` once per BERT layer with
    the probs dropout rate, eval as the rule says, and the loss falls.  At
    S = 256 the towers are the transformer ones: the plain recurrences would
    be a Python loop over 254 steps, and the towers are not what this case
    checks."""
    from mmda_tpu_torch.models import bert as pbert

    calls = []
    real = pbert.flash_attention
    monkeypatch.setattr(pbert, "flash_attention",
                        lambda *a: (calls.append(a[5]), real(*a))[1])
    cfg = Config(**{**dict(device="cpu", use_bert=True, data="mosei", hidden_size=16,
                           embedding_size=8, batch_size=32, max_seq_len=8, bucket_sizes=(8,),
                           n_epoch=2, learning_rate=1e-3, ckpt_dir=str(tmp_path), name="t",
                           seed=1), **option})
    # two train batches an epoch, one eval batch per split
    data = psynth.make_dataset(2 * cfg.batch_size, cfg.batch_size, cfg.batch_size,
                               max_len=cfg.max_seq_len, seed=0, bert_vocab_size=128)
    trainer = Trainer(cfg, data, bert_cfg=BertConfig.tiny())
    summary = trainer.train()
    hist = summary["history"]
    assert len(hist) == 2 and hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert np.isfinite(summary["test_loss"])
    steps, evals = 2 * 2, 2 + 1                    # 2 epochs x 2 batches; dev x 2, test
    assert len(calls) == steps * train_calls + evals * eval_calls
    assert sorted(set(calls)) == ([0.0, 0.1] if eval_calls else [0.1])
