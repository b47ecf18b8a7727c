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
from mmda_tpu_torch.ops.kernels.hash_dropout import short_attention_keep_mask

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


@pytest.mark.parametrize("S,hd,takes", [(50, 64, True), (66, 64, True), (128, 64, True),
                                        (129, 64, False), (66, 128, True), (128, 128, False),
                                        (10, 8, True)])
def test_kernel_takes_shapes_that_fit_one_block(S, hd, takes):
    """The kernels hold one (batch item, head) in shared memory: S and hd
    up to 128 where the backward's two S x S tiles and two operand tiles
    fit in 227 KB; a CUDA input beyond that raises (names attn_impl="flash")
    where a CPU one takes the plain version."""
    assert tsa.kernel_takes(S, hd) == takes
