"""The port's short-sequence attention (mmda_tpu_torch/ops/kernels/
short_attention.py, its plain versions on the CPU) against
`mmda_tpu.ops.pallas.short_attention` running its Pallas kernels in
interpret mode (their default off the TPU).

The keep mask is compared bit for bit.  Forward and gradients: f32 within
1e-5 + 1e-5 |ref| (both sides take the whole-row softmax and every product
in f32: summation order only); bf16 inputs within one bf16 ulp of the
output (2^-7 relative): both compute in f32 and round once, so a value
that lies on a rounding boundary may round the other way, no further.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.ops.pallas import short_attention as jsa
from mmda_tpu_torch.ops.kernels import short_attention as tsa
from mmda_tpu_torch.ops.kernels.hash_dropout import keep_scale, short_attention_keep_mask

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 2, -5])
@pytest.mark.parametrize("S,b,h", [(10, 0, 0), (18, 2, 3), (50, 63, 11)])
def test_keep_mask_bit_for_bit(S, b, h, seed):
    """`short_attention_keep_mask` is `_dropout_mask` of the JAX kernels,
    for an int seed and a device-tensor seed (a negative one wraps as the
    JAX code's astype(uint32) does)."""
    want = np.asarray(jsa._dropout_mask((S, S), 0.1, jnp.asarray(seed, jnp.int32), b, h))
    assert 0.0 < want.mean() < 1.0
    np.testing.assert_array_equal(short_attention_keep_mask(S, 0.1, seed, b, h).numpy(), want)
    seed_t = torch.tensor([seed], dtype=torch.int32)
    np.testing.assert_array_equal(short_attention_keep_mask(S, 0.1, seed_t, b, h).numpy(), want)


def test_keep_mask_broadcasts_over_batch_items_and_heads():
    """b and h as broadcasting tensors give the stack of the per-(b, h)
    masks, which differ from each other."""
    b = torch.arange(3).reshape(3, 1, 1, 1)
    h = torch.arange(2).reshape(1, 2, 1, 1)
    whole = short_attention_keep_mask(9, 0.3, 11, b, h)
    assert whole.shape == (3, 2, 9, 9)
    for i in range(3):
        for j in range(2):
            assert torch.equal(whole[i, j], short_attention_keep_mask(9, 0.3, 11, i, j))
    assert not torch.equal(whole[0, 0], whole[0, 1])
    assert not torch.equal(whole[0, 0], whole[1, 0])


def _inputs(B, nh, S, hd, seed):
    """q, k, v, the incoming gradient, a key bias with a masked tail of
    another length in every batch item but the first, as numpy f32."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, nh, S, hd)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, S), np.float32)
    for b in range(1, B):
        mask[b, S - 1 - b * S // (2 * B):] = 0.0
    return q, k, v, g, ((1.0 - mask) * -1e9).astype(np.float32)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 4, 10, 8), (2, 2, 18, 16)], ids=str)
def test_short_attention_matches_jax_kernel(shape, dtype, rate):
    """Forward and autograd.grad against the JAX function and jax.vjp."""
    q, k, v, g, bias = _inputs(*shape, seed=sum(shape))
    seed = 1234
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
    assert got.dtype == tdt and all(t.dtype == tdt for t in got_grads)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, a, b in zip(("o", "dq", "dk", "dv"), (got, *got_grads), (want, *want_grads)):
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b, np.float32),
                                   err_msg=name, **tol)
    assert tsa.launch_count("short_attn_fwd") == tsa.launch_count("short_attn_bwd") == 0


def test_masked_keys_get_no_probability_and_no_gradient():
    """A key under the -1e9 bias adds nothing to o and gets no dk, dv."""
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(2, 2, 9, 8, seed=3))
    k, v = k.requires_grad_(True), v.requires_grad_(True)
    o = tsa.short_attention(q, k, v, bias)
    dk, dv = torch.autograd.grad(o, (k, v), g)
    masked = bias[1] < 0
    assert masked.any()
    assert torch.all(dk[1][:, masked] == 0) and torch.all(dv[1][:, masked] == 0)
    v2 = v.detach().clone()
    v2[1][:, masked] = 1e3
    torch.testing.assert_close(tsa.short_attention(q, k.detach(), v2, bias), o.detach())


def test_dropout_keeps_the_hash_mask():
    """With q = 0 every probability of a row is 1 / S, so at v = identity
    o * S (1 - rate) is the keep mask of the row itself."""
    B, nh, S = 2, 3, 12
    q = torch.zeros(B, nh, S, S)
    v = torch.eye(S).expand(B, nh, S, S).contiguous()
    seed = torch.tensor([77], dtype=torch.int32)
    o = tsa.short_attention(q, q, v, torch.zeros(B, S), seed, 0.25)
    b = torch.arange(B).reshape(B, 1, 1, 1)
    h = torch.arange(nh).reshape(1, nh, 1, 1)
    want = short_attention_keep_mask(S, 0.25, seed, b, h)
    assert torch.equal((o * S * 0.75).round(), want)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(2, 3, 8, 16)
    bias = torch.zeros(2, 8)
    seed = torch.zeros(1, dtype=torch.int32)
    fwd = tsa.short_attention_fwd
    with pytest.raises(TypeError):
        fwd(q.double(), q.double(), q.double(), bias, None)
    with pytest.raises(TypeError):
        fwd(q, q.bfloat16(), q, bias, None)
    with pytest.raises(ValueError):
        fwd(q[0], q[0], q[0], bias, None)                      # (B, nh, S, hd)
    with pytest.raises(ValueError):
        fwd(q, q, q, bias[:, :4], None)
    with pytest.raises(ValueError):
        fwd(q, q.transpose(2, 3).contiguous().transpose(2, 3), q, bias, None)
    with pytest.raises(ValueError):
        fwd(q, q, q, bias, None, rate=0.1)                     # needs a seed
    with pytest.raises(ValueError):
        fwd(q, q, q, bias, seed, rate=1.0)
    with pytest.raises(ValueError):
        fwd(q, q, q, bias, seed, rate=-0.1)
    with pytest.raises(TypeError):
        fwd(q, q, q, bias, torch.zeros(1, dtype=torch.int64), rate=0.1)
    with pytest.raises(TypeError):
        tsa.short_attention_bwd(q, q, q, bias, None, q.bfloat16())
    with pytest.raises(ValueError):
        fwd(q, q, q, bias.t().contiguous().t(), None)
    assert tsa.launch_count("short_attn_fwd") == 0      # the CPU takes the plain version


@pytest.mark.parametrize("S,hd,route", [(50, 64, "block"), (66, 64, "block"), (128, 64, "block"),
                                        (129, 64, "tiled"), (66, 128, "block"),
                                        (128, 128, "block"), (10, 8, "block")])
def test_kernel_takes_shapes_that_fit_one_block(S, hd, route):
    """f32: one block per (batch item, head) holds S and hd up to 128 (the
    tensor-core design's slots of bf16 term tiles, 199,680 bytes at most,
    fit in 227 KB); every other S goes to the tiled kernels (a
    CUDA input at any S launches one or the other; a CPU one takes the plain
    version)."""
    assert tsa.kernel_route(S, hd) == route and tsa.kernel_takes(S, hd)
    assert tsa.block_smem_bytes(min(S, 128), hd) <= tsa.SMEM_LIMIT


@pytest.mark.parametrize("S,hd,route", [(50, 64, "block"), (128, 64, "block"),
                                        (66, 128, "block"), (128, 128, "tiled")])
def test_fma_block_design_sends_what_it_cannot_hold_to_the_tiled_kernels(monkeypatch, S, hd,
                                                                          route):
    """The f32 FMA design of the block kernels (`_BLOCK_IMPL` = 1) holds its
    backward's two f32 S x S tiles and two operand tiles: at S = hd = 128
    they need 271,360 bytes, so that shape goes to the tiled kernels."""
    monkeypatch.setattr(tsa, "_BLOCK_IMPL", 1)
    assert tsa.kernel_route(S, hd) == route
    assert (tsa.block_smem_bytes(S, hd) <= tsa.SMEM_LIMIT) == (route == "block")


@pytest.mark.parametrize("S,hd", [(128, 128), (66, 128), (1, 1), (128, 8), (33, 100)])
def test_bf16_kernels_take_every_shape_up_to_128(S, hd):
    """The bf16 block kernels hold at most four padded bf16 operand tiles
    (141,312 bytes at S = hd = 128), so bf16 takes S = hd = 128 in one
    block, which the f32 backward's two f32 S x S tiles do not fit; beyond
    S = 128 the tiled kernels take it; no kernel takes hd > 128."""
    assert tsa.kernel_route(S, hd, torch.bfloat16) == "block"
    assert tsa.kernel_route(S + 128, hd, torch.bfloat16) == "tiled"
    assert not tsa.kernel_takes(S, hd + 128, torch.bfloat16)


def _split3(x):
    """x (f32) as three bf16 terms hi + mid + lo, each widened back to f32:
    x - hi and x - hi - mid are exact in f32, and the three hold x's 24 bits."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def _split_matmul(x, b):
    """x @ b as the tensor-core kernels form it: each bf16 term of x times the
    bf16-exact b, every product exact and every sum in f32."""
    return sum(torch.matmul(t, b) for t in _split3(x))


def _tensor_core_model(q, k, v, bias, seed, g, rate):
    """(o, dq, dk, dv) with the arithmetic of the bf16 kernels on the tensor
    cores, the forward's (csrc/short_attn_fwd.cu, o) and the backward's
    (csrc/short_attn_bwd.cu, dq, dk, dv) alike: products of two bf16 inputs
    straight in f32, `scale` after q k^T (the forward's scores and the
    backward's recomputed ones) and after ds^T q, the f32 intermediates pd and
    ds split into three bf16 terms, the softmax, mask and ds in f32, each
    output rounded once to bf16."""
    B, nh, S, hd = q.shape
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    scale = tsa.softmax_scale(hd)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale + bias[:, None, None, :]
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    p = p / p.sum(-1, keepdim=True)
    keep = torch.ones_like(p)
    if rate > 0.0:
        b = torch.arange(B).reshape(B, 1, 1, 1)
        h = torch.arange(nh).reshape(1, nh, 1, 1)
        keep = short_attention_keep_mask(S, rate, seed, b, h) * keep_scale(rate)
    pd = p * keep
    dp = torch.matmul(gf, vf.transpose(-1, -2)) * keep
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    out = (_split_matmul(pd, vf), _split_matmul(ds, kf) * scale,
           _split_matmul(ds.transpose(-1, -2), qf) * scale,
           _split_matmul(pd.transpose(-1, -2), gf))
    return tuple(t.bfloat16() for t in out)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("hd", [16, 64, 100])
@pytest.mark.parametrize("S", [18, 50, 66, 128])
def test_tensor_core_arithmetic_meets_the_bf16_tolerance(S, hd, rate):
    """The bf16 kernels' design on the CPU: three bf16 terms per f32
    intermediate and `scale` taken after the products keep o, dq, dk and dv
    within one bf16 ulp (plus 1e-6) of the plain versions, which multiply q
    by `scale` first and take every product on f32 operands."""
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(2, 3, S, hd, seed=S * hd))
    q, k, v, g = (t.bfloat16() for t in (q, k, v, g))
    seed = torch.tensor([4321], dtype=torch.int32)
    got = _tensor_core_model(q, k, v, bias, seed, g, rate)
    want = (tsa.short_attention_fwd_reference(q, k, v, bias, seed, rate),
            *tsa.short_attention_bwd_reference(q, k, v, bias, seed, g, rate))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), err_msg=name,
                                   **BF16_TOL)
