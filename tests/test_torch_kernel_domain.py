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


# The f32 tiled kernels' term products (csrc/wgmma.cuh kTermPairs): (A's
# term, B's term) with 0 = hi, 1 = mid, 2 = lo, in the order they are issued
SIX_TERMS = ((0, 2), (2, 0), (1, 1), (0, 1), (1, 0), (0, 0))


def _terms(x):
    """x (f32) as its three bf16 terms hi, mid, lo, each widened back to f32."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def _grid_terms(x):
    """x (f32) as its three bf16 terms on each row's grid (the f32 kernels'
    split of q scale and k, csrc/short_tiled.cuh store_terms): hi is x
    rounded to a multiple of 2^(e - 7), e the exponent of the row's largest
    |x| (clamped to [-100, 111]), mid and lo the rest as `_terms` takes it."""
    e = (torch.frexp(x.abs().amax(-1, keepdim=True)).exponent - 1).clamp(-100, 111)
    quantum = torch.pow(2.0, (e - 7).float())
    hi = torch.round(x / quantum) * quantum
    assert torch.equal(hi.bfloat16().float(), hi)
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def _terms_matmul(x, y, pairs=SIX_TERMS, tx=None, ty=None):
    """x @ y with both f32 operands as three bf16 terms (tx, ty where given,
    else `_terms`): the term products of `pairs` (each exact, summed in
    f32), added in their order in f32."""
    tx, ty = tx or _terms(x), ty or _terms(y)
    out = torch.matmul(tx[pairs[0][0]], ty[pairs[0][1]])
    for a, b in pairs[1:]:
        out = out + torch.matmul(tx[a], ty[b])
    return out


def _scores_matmul(tx, ty, pairs=SIX_TERMS):
    """The f32 kernels' scores from terms on the rows' grids (`_grid_terms`;
    ty transposed): the hi hi products' sum in its own accumulator, exact
    there (an integer of at most 2^23 units of the grids), the other pairs'
    by `_terms_matmul`, then the two added in f32."""
    rest = _terms_matmul(None, None, [p for p in pairs if p != (0, 0)], tx, ty)
    return rest + torch.matmul(tx[0].double(), ty[0].double()).float()


def _tiled_model(q, k, v, bias, seed, g, rate, r_from_bf16_o=False, pairs=None):
    """(o, dq, dk, dv) as the tiled kernels form them, on the CPU: keys and
    queries in tiles of NB (bf16: 64, 32 for the dk/dv kernel's query tiles
    at hd > 64; f32: 32).  With `pairs`, f32 on the tensor cores: every
    product of f32 operands (q scale k^T, do v^T, and the tile products pd
    v, ds k, pd^T do, ds^T (q scale)) as those term products
    (`_terms_matmul`; q scale and k split on their rows' grids, the
    scores' hi hi sum exact, `_scores_matmul`), the forward's key tiles 64
    (32 at hd > 64), the dq
    kernel's key tiles and the dk/dv kernel's query tiles 32; each tile's
    product a fresh sum, added to the running one in f32.  Forward, one
    pass over the key tiles: the row max m and sum l online (when a tile
    raises m, l and the f32 accumulator are rescaled by exp(m_old - m_new)),
    the accumulator += (exp(s - m) times the 0/1 mask) v, and at the end
    o32 = acc (1 / l) keep_scale; it saves m, l and o32.  r = rowsum(do
    o32) (from the bf16 o with `r_from_bf16_o`).  dq kernel, one pass: p =
    exp(s - m) (1 / l), ds = p (dp - r), dq summed tile by tile; dk/dv
    kernel: the same p and ds, pd = p keep, dk and dv summed over query
    tiles.  bf16 takes its products as the kernels do (q
    k^T and do v^T of the inputs, scale after q k^T and ds^T q, the f32
    intermediate as three bf16 terms); each output rounded once.  (The bf16
    kernels take exp as ex2.approx, within a few f32 ulps of torch.exp.)"""
    B, nh, S, hd = q.shape
    bf16 = q.dtype == torch.bfloat16
    NB = 64 if bf16 else 32
    NQ = (64 if hd <= 64 else 32) if bf16 else 32
    NK = NB                     # the dq kernel's key tiles
    scale = tsa.softmax_scale(hd)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    if bf16:
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale + bias[:, None, None, :]
        product = _split_matmul
    elif pairs is None:
        s = torch.matmul(qf * scale, kf.transpose(-1, -2)) + bias[:, None, None, :]
        product = torch.matmul
    else:
        NB, NK = (64 if hd <= 64 else 32), 32

        def product(x, y, ty=None):
            return _terms_matmul(x, y, pairs, ty=ty)

        t_q, t_k = _grid_terms(qf * scale), _grid_terms(kf)
        s = _scores_matmul(t_q, [t.transpose(-1, -2) for t in t_k], pairs) + bias[:, None, None, :]
    mask = torch.ones_like(s)
    ks = keep_scale(rate)
    if rate > 0.0:
        b = torch.arange(B).reshape(B, 1, 1, 1)
        h = torch.arange(nh).reshape(1, nh, 1, 1)
        mask = short_attention_keep_mask(S, rate, seed, b, h)
    keep = mask * ks
    tiles = [slice(t, min(t + NB, S)) for t in range(0, S, NB)]
    m = torch.full((B, nh, S, 1), -float("inf"))
    l, acc = torch.zeros(B, nh, S, 1), torch.zeros(B, nh, S, hd)
    for t in tiles:
        m_new = torch.maximum(m, s[..., t].max(-1, keepdim=True).values)
        alpha, x = torch.exp(m - m_new), torch.exp(s[..., t] - m_new)
        l = l * alpha + x.sum(-1, keepdim=True)
        acc = acc * alpha + product(x * mask[..., t], vf[..., t, :])
        m = m_new
    inv_l = 1.0 / l
    o32 = acc * (inv_l * ks)
    o = o32.to(q.dtype)
    r = (gf * (o.float() if r_from_bf16_o else o32)).sum(-1, keepdim=True)
    p = torch.exp(s - m) * inv_l
    dp = (torch.matmul if pairs is None else product)(gf, vf.transpose(-1, -2)) * keep
    pd, ds = p * keep, p * (dp - r)
    qs = qf if bf16 else qf * scale
    ktiles = [slice(t, min(t + NK, S)) for t in range(0, S, NK)]
    qtiles = [slice(t, min(t + NQ, S)) for t in range(0, S, NQ)]
    if pairs is None:
        dq = sum(product(ds[..., t], kf[..., t, :]) for t in ktiles) * scale
        dk = sum(product(ds[..., t, :].transpose(-1, -2), qs[..., t, :]) for t in qtiles)
    else:                       # k's and q scale's terms on their rows' grids
        dq = sum(product(ds[..., t], None, [u[..., t, :] for u in t_k]) for t in ktiles) * scale
        dk = sum(product(ds[..., t, :].transpose(-1, -2), None, [u[..., t, :] for u in t_q])
                 for t in qtiles)
    dv = sum(product(pd[..., t, :].transpose(-1, -2), gf[..., t, :]) for t in qtiles)
    if bf16:
        dk = dk * scale
    return (o, *(x.to(q.dtype) for x in (dq, dk, dv))), torch.cat((m, l), -1), o32


def _block_model(q, k, v, bias, seed, g, rate, pairs=SIX_TERMS):
    """(o, dq, dk, dv) as the f32 block kernels on the tensor cores form
    them (`csrc/short_attn_fwd.cu`, `short_attn_bwd.cu`, design 0 of
    `short_attention._BLOCK_IMPL`), on the CPU, with the row statistics (m, l)
    and o in f32 as `_tiled_model` returns them: the whole row at once, every
    product of f32 operands (q scale k^T, do v^T, pd v, ds k, pd^T do, ds^T
    (q scale)) as the term products of `pairs`, each one fresh f32 sum over
    all S (`_terms_matmul`; q scale and k on their rows' grids, the scores'
    hi hi sum exact, `_scores_matmul`); the exact softmax, p = exp(s - m) /
    l, pd = p keep, r = rowsum(dp p), ds = p (dp - r)."""
    B, nh, S, hd = q.shape
    scale = tsa.softmax_scale(hd)
    qs = q.float() * scale
    t_q, t_k = _grid_terms(qs), _grid_terms(k.float())
    s = _scores_matmul(t_q, [t.transpose(-1, -2) for t in t_k], pairs) + bias[:, None, None, :]
    keep = torch.full_like(s, 1.0)
    if rate > 0.0:
        b = torch.arange(B).reshape(B, 1, 1, 1)
        h = torch.arange(nh).reshape(1, nh, 1, 1)
        keep = short_attention_keep_mask(S, rate, seed, b, h) * keep_scale(rate)
    m = s.max(-1, keepdim=True).values
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    p = e / l
    pd = p * keep
    o = _terms_matmul(pd, v.float(), pairs)
    dp = _terms_matmul(g.float(), v.float().transpose(-1, -2), pairs) * keep
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = _terms_matmul(ds, None, pairs, ty=t_k) * scale
    dk = _terms_matmul(ds.transpose(-1, -2), None, pairs, ty=t_q)
    dv = _terms_matmul(pd.transpose(-1, -2), g.float(), pairs)
    return (o, dq, dk, dv), torch.cat((m, l), -1), o


def _tiled_case(S, hd, dtype, case):
    """Inputs of a model case: `_short_inputs` at (2, 2, S, hd), and for
    "rescale" a last key tile (unmasked) with a bias of 30 (each row's max
    rises by at least 20 there), for "masked_tail" batch item 0's keys
    masked from 64 before the last tile of 64 on (whole trailing tiles of
    every kernel's keys)."""
    q, k, v, g, bias = (torch.from_numpy(a) for a in _short_inputs(2, 2, S, hd, seed=S * hd))
    last = (S - 1) // 64 * 64
    if case == "rescale":
        bias[:, last:] = 30.0
    elif case == "masked_tail":
        bias[0, last - 64:] = -1e9
    return (*(t.to(getattr(torch, dtype)) for t in (q, k, v, g)), bias)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,hd,case", [
    pytest.param(129, 16, "plain", id="129-16"), pytest.param(200, 100, "plain", id="200-100"),
    pytest.param(514, 64, "plain", id="514-64"), (514, 64, "rescale"),
    (257, 128, "masked_tail"), (1026, 64, "plain")])
def test_tiled_kernel_arithmetic_meets_the_gates(S, hd, dtype, rate, case):
    """The tiled kernels' design on the CPU against the plain versions: f32
    within 1e-5 + 1e-5 |ref|, bf16 within one bf16 ulp (plus 1e-6); the
    saved m and l and o32 within f32 rounding of the plain training
    forward's."""
    q, k, v, g, bias = _tiled_case(S, hd, dtype, case)
    if case == "rescale":
        s = torch.matmul(q.float() * tsa.softmax_scale(hd), k.float().transpose(-1, -2))
        s = s + bias[:, None, None, :]
        last = (S - 1) // 64 * 64
        assert (s[..., last:].amax(-1) - s[..., :last].amax(-1)).min() >= 20.0
    seed = torch.tensor([4321], dtype=torch.int32)
    got, stats, o32 = _tiled_model(q, k, v, bias, seed, g, rate)
    o_w, stats_w, o32_w = tsa.short_attention_fwd_train_reference(q, k, v, bias, seed, rate)
    want = (o_w, *tsa.short_attention_bwd_reference(q, k, v, bias, seed, g, rate))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), err_msg=name, **tol)
    np.testing.assert_allclose(stats.numpy(), stats_w.numpy(), **F32_TOL)
    np.testing.assert_allclose(o32.numpy(), o32_w.numpy(), **F32_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S,hd,case", [(129, 16, "plain"), (514, 64, "plain"),
                                       (514, 64, "rescale")])
def test_r_from_the_bf16_output_misses_the_gate(S, hd, case, rate):
    """Why the training forward saves o32 in bf16: r = rowsum(do o) taken
    from the rounded o (2^-9 relative) reaches dq wherever ds = p (dp - r)
    cancels, and dq then leaves the one-ulp gate, where r from o32 meets it."""
    q, k, v, g, bias = _tiled_case(S, hd, "bfloat16", case)
    seed = torch.tensor([4321], dtype=torch.int32)
    want = tsa.short_attention_bwd_reference(q, k, v, bias, seed, g, rate)[0].float()
    limit = BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()
    outside = {}
    for from_o in (False, True):
        dq = _tiled_model(q, k, v, bias, seed, g, rate, r_from_bf16_o=from_o)[0][1].float()
        outside[from_o] = int(((dq - want).abs() > limit).sum())
    assert outside == {False: 0, True: outside[True]} and outside[True] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [129, 514])
def test_training_forward_plain_version(S, dtype):
    """`short_attention_fwd_train` on the CPU (its plain version): o bit
    for bit `short_attention_fwd`'s, m and l the plain softmax's row max and
    sum, o32 the f32 o (o itself in f32); the backward from them within f32
    rounding of the one without (r = rowsum(do o32) against rowsum(dp p))."""
    q, k, v, g, bias = _tiled_case(S, 32, dtype, "plain")
    seed = torch.tensor([11], dtype=torch.int32)
    o, stats, o32 = tsa.short_attention_fwd_train(q, k, v, bias, seed, 0.1)
    assert stats.shape == (2, 2, S, 2) and stats.dtype == o32.dtype == torch.float32
    assert torch.equal(o, tsa.short_attention_fwd(q, k, v, bias, seed, 0.1))
    s = torch.matmul(q.float() * tsa.softmax_scale(32), k.float().transpose(-1, -2))
    s = s + bias[:, None, None, :]
    m = s.max(-1).values
    assert torch.equal(stats[..., 0], m)
    assert torch.equal(stats[..., 1], torch.exp(s - m[..., None]).sum(-1))
    assert (o32 is o) == (dtype == "float32") and torch.equal(o32.to(o.dtype), o)
    with_stats = tsa.short_attention_bwd(q, k, v, bias, seed, g, 0.1, stats, o32)
    alone = tsa.short_attention_bwd(q, k, v, bias, seed, g, 0.1)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, a, b in zip(("dq", "dk", "dv"), with_stats, alone):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), err_msg=name, **tol)
    with pytest.raises(ValueError, match="together"):
        tsa.short_attention_bwd(q, k, v, bias, seed, g, 0.1, stats)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 2, 200, 40), (1, 2, 514, 64)], ids=str)
def test_short_attention_saves_the_row_statistics_and_matches_jax(interpreted, monkeypatch,
                                                                   shape, dtype):
    """`ShortAttention` beyond S = 128 runs the training forward when a
    gradient is needed (and only then), saves its statistics and o32, and
    its backward reads them: forward and gradients against jax.vjp of the
    JAX kernel in interpret mode at S = 200 and 514."""
    B, nh, S, hd = shape
    q, k, v, g, bias = _short_inputs(*shape, seed=S)
    rate, seed = 0.1, 123
    jdt = jnp.dtype(dtype)
    want, vjp = jax.vjp(lambda a, b_, c: jsa.short_attention(
        a, b_, c, jnp.asarray(bias), jnp.asarray([seed], jnp.int32), rate),
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g).astype(jdt))
    calls = {"train": 0, "bwd_stats": 0}
    train, bwd = tsa.short_attention_fwd_train, tsa.short_attention_bwd

    def spy_train(*args):
        calls["train"] += 1
        return train(*args)

    def spy_bwd(*args):
        calls["bwd_stats"] += len(args) == 9 and args[7] is not None
        return bwd(*args)

    monkeypatch.setattr(tsa, "short_attention_fwd_train", spy_train)
    monkeypatch.setattr(tsa, "short_attention_bwd", spy_bwd)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    tseed, tbias = torch.tensor([seed], dtype=torch.int32), torch.from_numpy(bias)
    with torch.no_grad():
        tsa.short_attention(tq, tk, tv, tbias, tseed, rate)
    assert calls["train"] == 0
    got = tsa.short_attention(tq, tk, tv, tbias, tseed, rate)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g).to(tdt))
    assert calls == {"train": 1, "bwd_stats": 1}
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, a, b in zip(("o", "dq", "dk", "dv"), (got, *got_grads), (want, *want_grads)):
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b, np.float32),
                                   err_msg=name, **tol)


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
