"""The TPU kernels' whole domain in the port: the shapes beyond what one
block of the card held before, on the CPU, against the JAX package's Pallas
kernels in interpret mode.

- Short attention (`ops/kernels/short_attention.py`) beyond S = 128, where a
  CUDA input goes to the tiled kernels (`csrc/short_attn_tiled_*.cu`): the
  plain versions against `mmda_tpu.ops.pallas.short_attention` at S = 129,
  257 and 514 (forward and jax.vjp, masked tails), its keep mask bit for bit
  at S = 514, and a CPU model of the tiled kernels' arithmetic (the row max
  and sum taken over key tiles with the sum rescaled, r = rowsum(dp p) the
  same way, every product summed tile by tile; bf16: three bf16 terms per
  f32 intermediate, scale after the products) within the gates of the plain
  versions.
- Flash attention at head dims outside the kernels' instantiations (8, 40,
  96): the plain versions against `mmda_tpu.ops.pallas.attention`; the card
  runs the next instantiation up on zero-padded columns.
- The LayerNorm backward at H = 1536 (a block a row on the card) against
  `mmda_tpu.ops.pallas.layernorm`.
- A MISA with tiny BERT and `attn_impl="fused"` exported at a bucket of 136
  words (S = 138): one short attention op a layer in the program, its scores
  the live `Predictor`'s.

Tolerances: f32 1e-5 + 1e-5 |ref| (short attention, LayerNorm), 1e-5 +
1e-4 |ref| (flash); bf16 one bf16 ulp (short attention: both sides in f32,
rounded once), 2e-2 / 5e-2 (flash, the JAX tests' bounds for bf16 operands).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import get_model as jget_model
from mmda_tpu.ops.pallas import attention as jattn
from mmda_tpu.ops.pallas import layernorm as jln
from mmda_tpu.ops.pallas import short_attention as jsa
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.models.bert import BertConfig
from mmda_tpu_torch.ops.kernels import attention as tattn
from mmda_tpu_torch.ops.kernels import layernorm as kln
from mmda_tpu_torch.ops.kernels import short_attention as tsa
from mmda_tpu_torch.ops.kernels.hash_dropout import keep_scale, short_attention_keep_mask
from mmda_tpu_torch.serving import Predictor
from mmda_tpu_torch.serving_export import ExportedPredictor, export_model

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.fixture
def interpreted():
    """The JAX package's Pallas kernels in interpret mode."""
    for module in (jsa, jattn):
        module.set_force_interpret(True)
    yield
    for module in (jsa, jattn):
        module.set_force_interpret(False)


def _short_inputs(B, nh, S, hd, seed):
    """q, k, v, the incoming gradient, and a key bias with a masked tail of
    another length in every batch item but the first, as numpy f32."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, nh, S, hd)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, S), np.float32)
    for b in range(1, B):
        mask[b, S - 1 - b * S // (2 * B):] = 0.0
    return q, k, v, g, ((1.0 - mask) * -1e9).astype(np.float32)


# ---------------------------------------------------- short attention, S > 128


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 2, 129, 8), (2, 1, 257, 16), (2, 1, 514, 8)], ids=str)
def test_short_attention_beyond_128_matches_jax_kernel(interpreted, shape, dtype, rate):
    """Forward and autograd.grad against the JAX kernel (which holds the
    whole S x S of a head) and jax.vjp: the shapes a CUDA input takes to the
    tiled kernels."""
    B, nh, S, hd = shape
    assert tsa.kernel_route(S, hd, getattr(torch, dtype)) == "tiled"
    q, k, v, g, bias = _short_inputs(*shape, seed=S + hd)
    seed = 99
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want, vjp = jax.vjp(lambda a, b_, c: jsa.short_attention(
        a, b_, c, jnp.asarray(bias), jnp.asarray([seed], jnp.int32), rate), jq, jk, jv)
    want_grads = vjp(jnp.asarray(g).astype(jdt))

    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    got = tsa.short_attention(tq, tk, tv, torch.from_numpy(bias),
                              torch.tensor([seed], dtype=torch.int32), rate)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g).to(tdt))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, a, b in zip(("o", "dq", "dk", "dv"), (got, *got_grads), (want, *want_grads)):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b, np.float32),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 2, -5])
@pytest.mark.parametrize("b,h", [(0, 0), (31, 11)])
def test_keep_mask_at_514_bit_for_bit(seed, b, h):
    """The short kernels' mask at the long step's S = 514 (i S + j runs past
    2^18; the JAX code's uint32 arithmetic, S the full length)."""
    want = np.asarray(jsa._dropout_mask((514, 514), 0.1, jnp.asarray(seed, jnp.int32), b, h))
    assert 0.0 < want.mean() < 1.0
    np.testing.assert_array_equal(short_attention_keep_mask(514, 0.1, seed, b, h).numpy(), want)


def _split_matmul(x, b):
    """x @ b with the f32 x as three bf16 terms (hi, mid, lo: all its 24
    bits), each times the bf16-exact b: the tensor-core products."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    lo = (x - hi - mid).bfloat16().float()
    return sum(torch.matmul(t, b) for t in (hi, mid, lo))


def _tiled_model(q, k, v, bias, seed, g, rate):
    """(o, dq, dk, dv) as the tiled kernels form them, on the CPU: keys and
    queries in tiles of NB (bf16: 64, 32 at hd > 64; f32: 32).  Forward:
    a pass over the key tiles for the row max m and the sum l (rescaled by
    exp(m_old - m_new) when a tile raises m), then p = exp(s - m) / l and o
    summed tile by tile.  dq kernel: m, l and R = sum dp exp(s - m) rescaled
    alike, r = R / l, then ds = p (dp - r) and dq summed tile by tile; dk/dv
    kernel: p from that m and l, the same ds, dk and dv summed over query
    tiles.  bf16 takes its products as the kernels do (q k^T and do v^T of
    the inputs, scale after q k^T and ds^T q, pd and ds as three bf16
    terms); each output rounded once."""
    B, nh, S, hd = q.shape
    bf16 = q.dtype == torch.bfloat16
    NB = (64 if hd <= 64 else 32) if bf16 else 32
    scale = tsa.softmax_scale(hd)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    if bf16:
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale + bias[:, None, None, :]
        product = _split_matmul
    else:
        s = torch.matmul(qf * scale, kf.transpose(-1, -2)) + bias[:, None, None, :]
        product = torch.matmul
    keep = torch.ones_like(s)
    if rate > 0.0:
        b = torch.arange(B).reshape(B, 1, 1, 1)
        h = torch.arange(nh).reshape(1, nh, 1, 1)
        keep = short_attention_keep_mask(S, rate, seed, b, h) * keep_scale(rate)
    dp = torch.matmul(gf, vf.transpose(-1, -2)) * keep
    tiles = [slice(t, min(t + NB, S)) for t in range(0, S, NB)]
    m = torch.full((B, nh, S, 1), -float("inf"))
    l, R = torch.zeros(B, nh, S, 1), torch.zeros(B, nh, S, 1)
    for t in tiles:
        m_new = torch.maximum(m, s[..., t].max(-1, keepdim=True).values)
        alpha, x = torch.exp(m - m_new), torch.exp(s[..., t] - m_new)
        l = l * alpha + x.sum(-1, keepdim=True)
        R = R * alpha + (dp[..., t] * x).sum(-1, keepdim=True)
        m = m_new
    r = R / l
    p = torch.exp(s - m) / l
    pd, ds = p * keep, p * (dp - r)
    qs = qf if bf16 else qf * scale
    o = sum(product(pd[..., t], vf[..., t, :]) for t in tiles)
    dq = sum(product(ds[..., t], kf[..., t, :]) for t in tiles) * scale
    dk = sum(product(ds[..., t, :].transpose(-1, -2), qs[..., t, :]) for t in tiles)
    dv = sum(product(pd[..., t, :].transpose(-1, -2), gf[..., t, :]) for t in tiles)
    if bf16:
        dk = dk * scale
    return tuple(x.to(q.dtype) for x in (o, dq, dk, dv))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,hd", [(129, 16), (200, 100), (514, 64)])
def test_tiled_kernel_arithmetic_meets_the_gates(S, hd, dtype, rate):
    """The tiled kernels' design on the CPU against the plain versions: f32
    within 1e-5 + 1e-5 |ref|, bf16 within one bf16 ulp (plus 1e-6)."""
    q, k, v, g, bias = (torch.from_numpy(a) for a in _short_inputs(2, 2, S, hd, seed=S * hd))
    q, k, v, g = (t.to(getattr(torch, dtype)) for t in (q, k, v, g))
    seed = torch.tensor([4321], dtype=torch.int32)
    got = _tiled_model(q, k, v, bias, seed, g, rate)
    want = (tsa.short_attention_fwd_reference(q, k, v, bias, seed, rate),
            *tsa.short_attention_bwd_reference(q, k, v, bias, seed, g, rate))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), err_msg=name, **tol)


# ------------------------------------------------- flash attention at any D


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 40, 96])
def test_flash_attention_at_any_head_dim_matches_jax_kernel(interpreted, D, dtype, rate):
    """The plain versions against the JAX flash kernels at head dims that
    are no instantiation of the card's kernels (which run 16, 64 and 128 on
    zero-padded columns with the true scale)."""
    assert tattn.kernel_head_dim(D) == {8: 16, 40: 64, 96: 128}[D]
    BH, S = 3, 130
    rng = np.random.default_rng(D)
    q, k, v, g = (rng.normal(size=(BH, S, D)).astype(np.float32) for _ in range(4))
    mask = np.ones((BH, S), np.float32)
    for b in range(1, BH):
        mask[b, S - (b * S) // (2 * BH) - 1:] = 0.0
    bias = ((1.0 - mask) * -1e9).astype(np.float32)
    seed = np.array([1234], np.int32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (q, k, v))
    out, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(
        a, b_, c, jnp.asarray(bias), jnp.asarray(seed), rate), jq, jk, jv)
    want = (out, *vjp(jnp.asarray(g)))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
                  for a in (q, k, v))
    o = tattn.flash_attention(tq, tk, tv, torch.from_numpy(bias), torch.from_numpy(seed), rate)
    got = (o, *torch.autograd.grad(o, [tq, tk, tv], torch.from_numpy(g)))
    for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        a, w = a.detach().float().numpy(), np.asarray(w.astype(jnp.float32))
        assert a.shape == w.shape == (BH, S, D) and np.isfinite(a).all(), name
        if dtype == "float32":
            np.testing.assert_array_less(np.abs(a - w), 1e-5 + 1e-4 * np.abs(w) + 1e-30,
                                         err_msg=name)
        else:
            np.testing.assert_allclose(a, w, atol=2e-2 if name == "o" else 5e-2, rtol=0,
                                       err_msg=name)


def test_flash_head_dims_run_on_the_next_instantiation():
    """Zero columns appended to q, k and v change no score: the plain
    forward on the padded inputs with the true scale gives o's true
    columns and zeros in the pad, and the same lse."""
    BH, S, D = 2, 20, 40
    q, k, v = (torch.randn(BH, S, D, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    bias = torch.zeros(BH, S)
    qp, kp, vp = tattn._pad_heads(D, q, k, v)
    assert qp.shape == (BH, S, 64) and torch.equal(qp[..., :D], q) and not qp[..., D:].any()
    assert tattn._pad_heads(64, q)[0] is q
    scores = torch.matmul(qp, kp.transpose(1, 2)) * tattn.softmax_scale(D)
    p = torch.softmax(scores + bias[:, None, :], -1)
    o, lse = tattn.flash_attention_fwd_reference(q, k, v, bias, None)
    torch.testing.assert_close(torch.matmul(p, vp)[..., :D], o, **F32_TOL)
    assert not torch.matmul(p, vp)[..., D:].any()
    torch.testing.assert_close(torch.logsumexp(scores + bias[:, None, :], -1), lse, **F32_TOL)


# ------------------------------------------------ LayerNorm backward, H > 1024


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_layernorm_backward_at_1536_matches_pallas(rate):
    """A row wider than a warp's registers hold on the card (a block a row
    there): forward and gradients against the JAX kernel."""
    N, H, eps = 40, 1536, 1e-12
    rng = np.random.default_rng(H)
    a = {name: rng.normal(size=shape).astype(np.float32)
         for name, shape in (("x", (N, H)), ("y", (N, H)), ("g", (H,)), ("b", (H,)),
                             ("dout", (N, H)))}
    j = {name: jnp.asarray(v) for name, v in a.items()}
    jseed = jnp.array([77], jnp.int32)
    want, vjp = jax.vjp(lambda x, y, g, b: jln.residual_dropout_layernorm(
        x, y, g, b, jseed, rate, eps), j["x"], j["y"], j["g"], j["b"])
    want_grads = vjp(j["dout"])
    t = {name: torch.from_numpy(v).requires_grad_(name != "dout") for name, v in a.items()}
    seed = torch.tensor([77], dtype=torch.int32)
    got = kln.residual_dropout_layernorm(t["x"], t["y"], t["g"], t["b"], seed, rate, eps)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)
    grads = torch.autograd.grad(got, [t["x"], t["y"], t["g"], t["b"]], t["dout"])
    tols = (F32_TOL, F32_TOL, dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-4))
    for name, gr, w, tol in zip(("dx", "dy", "dscale", "dbias"), grads, want_grads, tols):
        np.testing.assert_allclose(gr.numpy(), np.asarray(w), err_msg=name, **tol)
    assert kln.bwd_wide_blocks(N, 132) == N and kln.bwd_wide_blocks(3200, 132) == 264


# ------------------------------------- a fused model exported above 128 words


def _request(L, rng):
    return {
        "text": rng.integers(2, 64, size=L).astype(np.int32),
        "visual": rng.normal(size=(L, 5)).astype(np.float32),
        "acoustic": rng.normal(size=(L, 6)).astype(np.float32),
        "bert_ids": rng.integers(3, 64, size=L + 2).astype(np.int32),
        "bert_type": np.zeros(L + 2, np.int32),
        "bert_mask": np.ones(L + 2, np.int32),
    }


def test_fused_model_exports_a_bucket_above_128(tmp_path):
    """MISA with tiny BERT and attn_impl="fused" at a bucket of 136 words (S
    = 138, the tiled kernels' route on the card): the bucket's program holds
    one `short_attention_fwd` node a BERT layer, and the artifact's scores
    are the live `Predictor`'s."""
    kw = dict(hidden_size=16, num_classes=6, visual_size=5, acoustic_size=6, vocab_size=64,
              embedding_size=8, compute_dtype="float32", use_bert=True, batch_size=4,
              bucket_sizes=(136,), max_seq_len=136, data="synthetic", attn_impl="fused")
    jcfg, cfg = JConfig(use_pallas=False, **kw), Config(device="cpu", **kw)
    init_fn, _ = jget_model("MISA")
    tree = jax.tree_util.tree_map(np.asarray, init_fn(
        jax.random.PRNGKey(3), jcfg, bert_cfg=jbert.BertConfig.tiny(vocab_size=64)))
    bert_cfg = BertConfig.tiny(vocab_size=64)
    export_model(cfg, tree, str(tmp_path), bert_cfg=bert_cfg, max_batch=2)
    program = torch.export.load(str(tmp_path / "bucket_136.pt2"))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert sum(t.startswith("mmda_tpu_torch.short_attention_fwd") for t in targets) == \
        bert_cfg.num_layers
    rng = np.random.default_rng(5)
    reqs = [_request(136, rng), _request(7, rng)]
    live = Predictor(cfg, params=tree, bert_cfg=bert_cfg, max_batch=2)
    got, want = ExportedPredictor(str(tmp_path), device="cpu")(reqs), live(reqs)
    for key in ("scores", "tcp"):
        np.testing.assert_allclose(got[key], np.asarray(want[key])[:2], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
