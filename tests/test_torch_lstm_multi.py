"""The port's multi-direction LSTM (mmda_tpu_torch/ops/kernels/lstm_multi.py,
its plain versions on the CPU) and the tower pair that runs it
(`models/bilstm.py::extract_features_pair`) against
`mmda_tpu.ops.pallas.lstm_multi` and `mmda_tpu.models.bilstm` running the
Pallas kernels in interpret mode (their default off the TPU).

The JAX kernel pads every direction to 128 lanes and takes the reverse ones
time-flipped; the port keeps each direction at its true H with a reverse
flag.  The padded lanes of the JAX outputs are zero and the true ones agree
with the port's.  f32 throughout, 1e-5 abs/rel (summation order only; the
port sums dW_hh in f64 and rounds once).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.models import bilstm as jbilstm
from mmda_tpu.ops.pallas import lstm_multi as jlm
from mmda_tpu_torch.convert import flatten_tree, load_jax_params, port_name
from mmda_tpu_torch.models import bilstm
from mmda_tpu_torch.ops.kernels import lstm_multi as tlm

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
HP = jlm.HP


def _pair(F_v=5, F_a=9, B=4, T=6, seed=7):
    """Both towers' JAX parameters (H = F: 5 and 9), inputs and ragged,
    different visual and acoustic lengths (T and 1 among them)."""
    rng = np.random.default_rng(seed)
    kv, ka = jax.random.split(jax.random.PRNGKey(seed))
    pv = jbilstm.extractor_params(kv, F_v, F_v, "lstm")
    pa = jbilstm.extractor_params(ka, F_a, F_a, "lstm")
    xv = rng.normal(size=(B, T, F_v)).astype(np.float32)
    xa = rng.normal(size=(B, T, F_a)).astype(np.float32)
    lv = rng.integers(1, T + 1, size=B).astype(np.int32)
    la = rng.integers(1, T + 1, size=B).astype(np.int32)
    lv[0], la[-1] = T, 1
    return pv, pa, xv, xa, lv, la


def _true(x, H, G=True):
    """The true-H part of a padded JAX operand: (..., 4 * HP) gate blocks or
    (..., HP) lanes."""
    if G:
        return np.asarray(x).reshape(*x.shape[:-1], 4, HP)[..., :H].reshape(*x.shape[:-1], 4 * H)
    return np.asarray(x)[..., :H]


def test_lstm_scan_multi_plain_matches_jax_per_direction():
    """The plain version, fed the operands JAX's pack_directions builds from
    the same weights (cut to each direction's true H; JAX's reverse ones
    come time-flipped, so here they run forward), and its gradients through
    autograd against `lstm_scan_multi` and jax.vjp."""
    pv, pa, xv, xa, lv, la = _pair(T=5)
    T = xv.shape[1]
    mv = (np.arange(T)[None] < lv[:, None]).astype(np.float32)
    ma = (np.arange(T)[None] < la[:, None]).astype(np.float32)
    dirs = [(pv["rnn1"]["fwd"], jnp.asarray(xv), jnp.asarray(mv), False),
            (pv["rnn1"]["bwd"], jnp.asarray(xv), jnp.asarray(mv), True),
            (pa["rnn1"]["fwd"], jnp.asarray(xa), jnp.asarray(ma), False),
            (pa["rnn1"]["bwd"], jnp.asarray(xa), jnp.asarray(ma), True)]
    (jx, jw, jm), hs = jlm.pack_directions(dirs)
    assert hs == [5, 5, 9, 9]
    (ys, h_fin), vjp = jax.vjp(lambda a, b: jlm.lstm_scan_multi(a, b, jm), jx, jw)
    rng = np.random.default_rng(1)
    dys = rng.normal(size=ys.shape).astype(np.float32)
    dh = rng.normal(size=h_fin.shape).astype(np.float32)
    for d, H in enumerate(hs):                        # the gradients' padded lanes are 0
        dys[d][..., H:] = 0.0
        dh[d][..., H:] = 0.0
    dx_j, dw_j = vjp((jnp.asarray(dys), jnp.asarray(dh)))

    x = [torch.from_numpy(_true(jx[d], H)).requires_grad_(True) for d, H in enumerate(hs)]
    w = [torch.from_numpy(np.ascontiguousarray(
        np.asarray(jw[d]).reshape(HP, 4, HP)[:H, :, :H].reshape(H, 4 * H))).requires_grad_(True)
        for d, H in enumerate(hs)]
    m = [torch.from_numpy(np.array(jm[d])[..., 0]) for d in range(4)]
    got_ys, got_h = tlm.lstm_scan_multi(x, w, m, [False] * 4)
    grads = torch.autograd.grad(
        got_ys + got_h, x + w,
        [torch.from_numpy(_true(dys[d], H, G=False)) for d, H in enumerate(hs)]
        + [torch.from_numpy(_true(dh[d], H, G=False)) for d, H in enumerate(hs)])
    for d, H in enumerate(hs):
        assert np.all(np.asarray(ys[d])[..., H:] == 0) and np.all(np.asarray(h_fin[d])[..., H:] == 0)
        np.testing.assert_allclose(got_ys[d].detach().numpy(), _true(ys[d], H, G=False), **TOL)
        np.testing.assert_allclose(got_h[d].detach().numpy(), _true(h_fin[d], H, G=False), **TOL)
        np.testing.assert_allclose(grads[d].numpy(), _true(dx_j[d], H), **TOL)
        dw = np.asarray(dw_j[d]).reshape(HP, 4, HP)[:H, :, :H].reshape(H, 4 * H)
        np.testing.assert_allclose(grads[4 + d].numpy(), dw, **TOL)
    # a reverse flag on the unflipped operands is the flip
    unflipped = [torch.flip(t.detach(), [0]) for t in x]
    rev_ys, _, rev_h = tlm.lstm_multi_recurrence(
        unflipped, [t.detach() for t in w], [torch.flip(t, [0]) for t in m], [True] * 4)
    for d in range(4):
        torch.testing.assert_close(torch.flip(rev_ys[d], [0]), got_ys[d].detach(), rtol=0, atol=0)
        torch.testing.assert_close(rev_h[d], got_h[d].detach(), rtol=0, atol=0)
    assert tlm.launch_count("lstm_multi_fwd") == tlm.launch_count("lstm_multi_bwd") == 0


def _port_pair(pv, pa):
    tv = load_jax_params(bilstm.LSTMExtractor(pv["rnn1"]["fwd"]["w_ih"].shape[1],
                                              pv["rnn1"]["fwd"]["w_hh"].shape[1]), pv)
    ta = load_jax_params(bilstm.LSTMExtractor(pa["rnn1"]["fwd"]["w_ih"].shape[1],
                                              pa["rnn1"]["fwd"]["w_hh"].shape[1]), pa)
    return tv, ta


def test_extract_features_pair_multi_matches_jax(B=3, T=5):
    """extract_features_pair(use_pallas_multi=True): values, and the
    gradients of a scalar of both outputs with respect to all four towers'
    parameters and both inputs, against the JAX function and jax.grad; and
    the same values as the port's own use_pallas_multi=False route."""
    pv, pa, xv, xa, lv, la = _pair(B=B, T=T, seed=B + T)
    rng = np.random.default_rng(2)
    gv = rng.normal(size=(B, 4 * 5)).astype(np.float32)
    ga = rng.normal(size=(B, 4 * 9)).astype(np.float32)

    def loss(params, xv_, xa_):
        v, a = jbilstm.extract_features_pair(params["v"], params["a"], xv_, xa_,
                                             jnp.asarray(lv), jnp.asarray(la), "lstm",
                                             use_pallas_multi=True)
        return jnp.sum(v * gv) + jnp.sum(a * ga), (v, a)

    (_, (want_v, want_a)), want_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        {"v": pv, "a": pa}, jnp.asarray(xv), jnp.asarray(xa))

    tv, ta = _port_pair(pv, pa)
    txv, txa = torch.from_numpy(xv).requires_grad_(True), torch.from_numpy(xa).requires_grad_(True)
    args = (torch.from_numpy(lv), torch.from_numpy(la))
    got_v, got_a = bilstm.extract_features_pair(tv, ta, txv, txa, *args, "lstm",
                                                use_pallas_multi=True)
    np.testing.assert_allclose(got_v.detach().numpy(), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(got_a.detach().numpy(), np.asarray(want_a), **TOL)
    names = [f"v.{n}" for n, _ in tv.named_parameters()] + [f"a.{n}" for n, _ in ta.named_parameters()]
    leaves = list(tv.parameters()) + list(ta.parameters())
    grads = torch.autograd.grad((got_v * torch.from_numpy(gv)).sum()
                                + (got_a * torch.from_numpy(ga)).sum(), leaves + [txv, txa])
    want_params = {port_name(k): v for k, v in flatten_tree(want_g[0]).items()}
    assert sorted(want_params) == sorted(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_params[name]), err_msg=name, **TOL)
    np.testing.assert_allclose(grads[-2].numpy(), np.asarray(want_g[1]), **TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(want_g[2]), **TOL)

    with torch.no_grad():
        off_v, off_a = bilstm.extract_features_pair(tv, ta, txv, txa, *args, "lstm")
    np.testing.assert_allclose(off_v.numpy(), got_v.detach().numpy(), **TOL)
    np.testing.assert_allclose(off_a.numpy(), got_a.detach().numpy(), **TOL)


def test_recurrence_argument_selects_the_plain_multi_version(monkeypatch):
    """With use_pallas_multi, a `recurrence` runs the plain multi version
    (the kernels' wrappers are not called), with the same numbers."""
    pv, pa, xv, xa, lv, la = _pair()
    tv, ta = _port_pair(pv, pa)
    args = (tv, ta, torch.from_numpy(xv), torch.from_numpy(xa), torch.from_numpy(lv),
            torch.from_numpy(la), "lstm", True)
    with torch.no_grad():
        want = bilstm.extract_features_pair(*args)
    calls = []
    monkeypatch.setattr(bilstm, "lstm_multi_recurrence", lambda *a, **k: calls.append(1))
    monkeypatch.setattr(bilstm, "lstm_scan_multi", lambda *a, **k: calls.append(1))
    from mmda_tpu_torch.ops.kernels.lstm import lstm_recurrence_reference

    with torch.no_grad():
        got = bilstm.extract_features_pair(*args, recurrence=lstm_recurrence_reference)
    assert not calls
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["off", "gru", "other-length"])
def test_pair_falls_back_to_two_extract_features_calls(case, monkeypatch):
    """As in the JAX package (`extract_features_pair` :441): use_pallas_multi
    off, a GRU cell, or towers of different (B, T) take two
    extract_features calls (held against the JAX package in
    test_torch_bilstm.py and test_torch_towers.py), and no multi version."""
    cell = "gru" if case == "gru" else "lstm"
    B, T = 3, 5
    Ta = T + 2 if case == "other-length" else T
    rng = np.random.default_rng(4)
    tv = bilstm.LSTMExtractor(5, 5, cell=cell)
    ta = bilstm.LSTMExtractor(7, 7, cell=cell)
    tv.reset_parameters(torch.Generator().manual_seed(1))
    ta.reset_parameters(torch.Generator().manual_seed(2))
    xv = torch.from_numpy(rng.normal(size=(B, T, 5)).astype(np.float32))
    xa = torch.from_numpy(rng.normal(size=(B, Ta, 7)).astype(np.float32))
    lv, la = torch.tensor([T, 2, 1]), torch.tensor([1, Ta, 3])
    with torch.no_grad():
        want = (bilstm.extract_features(tv, xv, lv), bilstm.extract_features(ta, xa, la))
    calls = []
    for name in ("lstm_multi_recurrence", "lstm_scan_multi", "lstm_multi_recurrence_reference"):
        monkeypatch.setattr(bilstm, name, lambda *a, **k: calls.append(1))
    with torch.no_grad():
        got = bilstm.extract_features_pair(tv, ta, xv, xa, lv, la, cell,
                                           use_pallas_multi=case != "off")
    assert not calls
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _operands(hs=(3, 3, 6), T=4, B=2):
    rng = np.random.default_rng(0)
    x = [torch.from_numpy(rng.normal(size=(T, B, 4 * H)).astype(np.float32)) for H in hs]
    w = [torch.from_numpy(rng.normal(size=(H, 4 * H)).astype(np.float32)) for H in hs]
    m = [torch.ones(T, B) for _ in hs]
    return x, w, m, [False] * len(hs)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, w, m, rev = _operands()
    fwd = tlm.lstm_multi_recurrence
    with pytest.raises(ValueError):
        fwd([], [], [], [])                                  # no direction
    with pytest.raises(ValueError):
        fwd(x * 3, w * 3, m * 3, rev * 3)                    # more than MAX_DIRS
    with pytest.raises(ValueError):
        fwd(x, w[:2], m, rev)                                # one entry per direction
    with pytest.raises(TypeError):
        fwd([x[0].double()] + x[1:], w, m, rev)
    with pytest.raises(ValueError):
        fwd(x, [w[0].t().contiguous()] + w[1:], m, rev)      # (H, 4H)
    with pytest.raises(ValueError):
        fwd([x[0], x[1][:, :1].contiguous(), x[2]], w, m, rev)   # the same (T, B)
    with pytest.raises(ValueError):
        fwd(x, w, [m[0][:3]] + m[1:], rev)
    with pytest.raises(ValueError):
        fwd([x[0].transpose(0, 1).contiguous().transpose(0, 1)] + x[1:], w, m, rev)
    with pytest.raises(ValueError):
        fwd([x[0][..., :5].contiguous()] + x[1:], w, m, rev)     # 4H columns
    ys, cs, h = fwd(x, w, m, rev, need_cs=True)
    with pytest.raises(ValueError):
        tlm.lstm_multi_recurrence_bwd(x, w, m, rev, ys, cs, ys[:1] * 3, h)
    assert tlm.launch_count("lstm_multi_fwd") == 0           # the CPU takes the plain version
