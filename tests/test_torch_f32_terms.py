"""The f32 short-attention kernels' arithmetic on the tensor cores, modelled
on the CPU: the tiled kernels (`csrc/short_attn_tiled_fwd.cu`,
`short_attn_tiled_bwd.cu`, design 0 of `short_attention._TILED_IMPL`) and
the one-block kernels (`csrc/short_attn_fwd.cu`, `short_attn_bwd.cu`,
design 0 of `_BLOCK_IMPL`).

Every f32 operand (q * scale, k, v, do; pd and ds) is three bf16 terms, hi,
mid and lo, and every product of two of them is six term products (hi hi,
hi mid, mid hi, hi lo, lo hi, mid mid).  The tiled kernels sum each tile's
product fresh and add it to the running one
(`test_torch_kernel_domain._tiled_model` with `pairs`); the block kernels
take the whole row at once with the exact softmax, each product one fresh
f32 sum over all S (`_block_model`).  q * scale and k are split on each
row's grid (hi a multiple of 2^(e - 7), e the exponent of the row's largest
|x|), so that the scores' hi hi sum is exact and takes its own accumulator.
The models are held against the JAX package's kernel in interpret mode
(forward and jax.vjp), tiled at S = 200 and 514, block at S = 50 and 100,
each at hd = 64 and 100, rate 0 and 0.1, with q as drawn (scores of unit
spread) and times 4 (a peaked softmax), within the f32 gate 1e-5 + 1e-5
|ref|.  With the mid mid product left out, or the lo terms, the tiled
model's peaked cases leave the gate several times over.

The model sums in f32 with round to nearest.  The card's tensor cores
truncate their f32 sums instead (each k16 step drops the bits below the
accumulator's f32 width), which this model does not show: a sum of many
steps drifts toward zero by about an ulp of its size a step.  Only the
hi hi grid argument (`test_grid_terms_make_the_hi_hi_sums_exact`: exact in
any order, so in the card's too) carries over.  `chip_smoke.py` phase 3
and `tests/test_torch_cuda.py` hold the kernels to their plain versions
and, on peaked scores, to float64.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmda_tpu.ops.pallas import short_attention as jsa
from mmda_tpu_torch.ops.kernels import short_attention as tsa
from test_torch_kernel_domain import (SIX_TERMS, _block_model, _grid_terms, _short_inputs,
                                      _terms, _tiled_model)

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-5
# (S, hd, rate, q's factor): 4 makes the scores' spread 4, the softmax peaked;
# the tiled kernels' S, then the block kernels'
TILED_CASES = list(itertools.product((200, 514), (64, 100), (0.0, 0.1), (1.0, 4.0)))
BLOCK_CASES = list(itertools.product((50, 100), (64, 100), (0.0, 0.1), (1.0, 4.0)))
CASES = TILED_CASES + BLOCK_CASES
MODELS = {"tiled": _tiled_model, "block": _block_model}
# the term products kept by each form the tests compare: the kernels' six,
# and the two that fall short of the gate
FORMS = {"six": SIX_TERMS,
         "no mid mid": tuple(p for p in SIX_TERMS if p != (1, 1)),
         "no lo": tuple(p for p in SIX_TERMS if 2 not in p)}
_JAX_CACHE = {}


@pytest.fixture
def interpreted():
    jsa.set_force_interpret(True)
    yield
    jsa.set_force_interpret(False)


def _case(S, hd, rate, q_factor):
    """The inputs of a case (B = 2, nh = 2, a masked tail in item 1; q times
    q_factor) and the JAX kernel's (o, dq, dk, dv) on them, as numpy f32
    (computed once)."""
    q, k, v, g, bias = _short_inputs(2, 2, S, hd, seed=S + hd)
    q = (q * q_factor).astype(np.float32)
    key = (S, hd, rate, q_factor)
    if key not in _JAX_CACHE:
        seed = jnp.asarray([31], jnp.int32)
        o, vjp = jax.vjp(lambda a, b, c: jsa.short_attention(a, b, c, jnp.asarray(bias), seed,
                                                             rate),
                         *(jnp.asarray(a) for a in (q, k, v)))
        _JAX_CACHE[key] = [np.asarray(t, np.float32) for t in (o, *vjp(jnp.asarray(g)))]
    return [torch.from_numpy(a) for a in (q, k, v, g, bias)], _JAX_CACHE[key]


def _outside(case, pairs):
    """{output: elements outside the gate} of the model with `pairs` against
    the JAX kernel."""
    (q, k, v, g, bias), want = _case(*case)
    S, hd, rate, _ = case
    model = MODELS[tsa.kernel_route(S, hd, torch.float32)]
    got = model(q, k, v, bias, torch.tensor([31], dtype=torch.int32), g, rate, pairs=pairs)[0]
    return {name: int((np.abs(a.numpy() - w) > ATOL + RTOL * np.abs(w)).sum())
            for name, a, w in zip(("o", "dq", "dk", "dv"), got, want)}


def test_three_terms_hold_every_bit():
    """hi + mid + lo is x exactly (x - hi and x - hi - mid are exact in f32)
    wherever lo stays a normal number (|x| >= 2^-100) and hi a finite one
    (below bf16's largest, 3.39e38); below 2^-100, what is lost lies under
    2^-132."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-29, 30, size=4096),
        [1.0 + 2.0 ** -23, -(1.5 + 2.0 ** -22) * 2.0 ** 127, 2.0 ** -100, 0.0, -0.0]])
        .astype(np.float32))
    hi, mid, lo = _terms(x)
    assert torch.equal((hi + mid) + lo, x)
    for t in (hi, mid, lo):
        assert torch.equal(t.bfloat16().float(), t)
    tiny = torch.tensor([1.2e-38, -3.0e-36, 2.0 ** -110], dtype=torch.float32)
    assert (sum(_terms(tiny)) - tiny).abs().max().item() < 2.0 ** -132


@pytest.mark.parametrize("case", CASES, ids=str)
def test_six_term_products_meet_the_f32_gate_against_jax(interpreted, case):
    """The kernels' f32 design of the case's route (S <= 128 one block per
    (b, h), else tiles) against the JAX kernel (forward and jax.vjp) and
    against the plain training forward's (m, l) and o32."""
    S, hd, rate, _ = case
    route = tsa.kernel_route(S, hd, torch.float32)
    assert route == ("block" if S <= tsa.MAX_S else "tiled")
    assert _outside(case, SIX_TERMS) == {"o": 0, "dq": 0, "dk": 0, "dv": 0}
    (q, k, v, g, bias), _ = _case(*case)
    seed = torch.tensor([31], dtype=torch.int32)
    _, stats, o32 = MODELS[route](q, k, v, bias, seed, g, rate, pairs=SIX_TERMS)
    _, stats_w, o32_w = tsa.short_attention_fwd_train_reference(q, k, v, bias, seed, rate)
    np.testing.assert_allclose(stats.numpy(), stats_w.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(o32.numpy(), o32_w.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hd", [8, 64, 100, 128])
def test_grid_terms_make_the_hi_hi_sums_exact(hd):
    """On each row's grid (`_grid_terms`) hi is a bf16 and hi + mid + lo
    lies within 2^-25 of the row's largest |x| of x, and a sum of hi hi
    products over hd <= 128 columns is exact in f32 whatever its order (an
    integer of at most 2^23 units of the two rows' grids): f32 sums forwards
    and backwards equal the float64 one, rows of very different sizes and
    values far below their row's largest included."""
    rng = np.random.default_rng(hd)
    x, y = (torch.from_numpy((rng.normal(size=(96, hd)) * 10.0 ** rng.integers(-6, 7, (96, 1))
                              * 10.0 ** rng.integers(-3, 1, (96, hd))).astype(np.float32))
            for _ in range(2))
    x[0], y[:, 0] = 0.0, 1e30                    # an all-zero row; a huge column
    for t in (x, y):
        hi, mid, lo = _grid_terms(t)
        assert torch.equal(hi.bfloat16().float(), hi)
        big = t.abs().amax(-1, keepdim=True)
        assert ((hi + mid + lo).double() - t.double()).abs().le(2.0 ** -25 * big).all()
    hx, hy = _grid_terms(x)[0], _grid_terms(y)[0]
    exact = torch.matmul(hx.double(), hy.double().T)
    prods = hx[:, None, :] * hy[None, :, :]                         # exact in f32
    assert torch.equal(prods.double(), hx.double()[:, None, :] * hy.double()[None, :, :])
    for order in (slice(None), slice(None, None, -1)):
        total = torch.zeros(96, 96)
        for c in range(hd)[order]:
            total = total + prods[..., c]
        assert torch.equal(total.double(), exact)


@pytest.mark.parametrize("form", ["no mid mid", "no lo"])
def test_fewer_term_products_miss_the_gate(interpreted, form):
    """Why six: with mid mid left out (on the grid, up to 2^-16 of the
    rows' largest products for every value), or the lo terms (hi hi + hi
    mid + mid hi + mid mid: 16 bits past the grid), every peaked tiled case
    of the test above leaves the f32 gate (the error of a score grows with its
    size, and p = exp(s - m) carries it into every output); without mid mid
    the unit-spread cases leave it too.  The counts by case (outputs outside
    the gate) are in the assertion's message."""
    outside = {case: _outside(case, FORMS[form]) for case in TILED_CASES}
    missed = [case for case, n in outside.items() if sum(n.values())]
    peaked = [case for case in TILED_CASES if case[3] > 1.0]
    assert set(peaked) <= set(missed), (form, outside)
    if form == "no mid mid":
        assert missed == TILED_CASES, (form, outside)
