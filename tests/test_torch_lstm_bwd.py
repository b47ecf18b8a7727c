"""The port's LSTM backward recurrence (BPTT) and its autograd Function
(mmda_tpu_torch/ops/kernels/lstm.py) against the JAX package: the Pallas
backward kernel `_bwd_call` in interpret mode, whole-T and time-chunked
streaming, and `jax.vjp` of `lstm_scan`; and against torch.autograd through
the plain forward.

Same inputs (numpy, seeded) into both.  Tolerance 1e-5 abs/rel: both sides
are f32 and differ only in summation order (the port sums dW_hh in f64).
The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.ops.pallas import lstm as plstm
from mmda_tpu_torch.models import bilstm
from mmda_tpu_torch.ops.kernels import lstm as klstm

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_mode():
    plstm.set_force_interpret(True)
    yield
    plstm.set_force_interpret(False)
    plstm.set_force_stream(None)


def _inputs(T, B, H, seed, reverse=False):
    """Forward inputs, the forward's saved ys and cs, and random incoming
    gradients dys, dh_fin, dc_fin (numpy)."""
    rng = np.random.default_rng(seed)
    x_proj = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    w_hh_t = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0], lengths[-1] = 1, T          # the edges: length 1 and length T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    ys, cs, _, _ = klstm.lstm_recurrence_reference(
        torch.from_numpy(x_proj), torch.from_numpy(w_hh_t), torch.from_numpy(mask),
        reverse, need_cs=True)
    dys = rng.normal(size=(T, B, H)).astype(np.float32)
    dh_fin = rng.normal(size=(B, H)).astype(np.float32)
    dc_fin = rng.normal(size=(B, H)).astype(np.float32)
    return dict(x_proj=x_proj, w_hh_t=w_hh_t, mask=mask, ys=ys.numpy(), cs=cs.numpy(),
                dys=dys, dh_fin=dh_fin, dc_fin=dc_fin)


def _port(a, reverse, dc=True):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    out = klstm.lstm_recurrence_bwd(t["x_proj"], t["w_hh_t"], t["mask"], t["ys"], t["cs"],
                                    t["dys"], t["dh_fin"], t["dc_fin"] if dc else None,
                                    reverse)
    return [o.numpy() for o in out]


def _jax(a, reverse, dc=True):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    dc_fin = j["dc_fin"] if dc else jnp.zeros_like(j["dh_fin"])
    out = plstm._bwd_call(j["x_proj"], j["w_hh_t"], j["mask"][..., None], j["ys"], j["cs"],
                          j["dys"], j["dh_fin"], dc_fin, reverse)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H,dc", [(6, 5, 7, True), (9, 3, 4, False), (1, 2, 3, True)])
def test_bwd_matches_pallas_whole_t(T, B, H, dc, reverse):
    a = _inputs(T, B, H, seed=T * 100 + H, reverse=reverse)
    for name, got, want in zip(("dx_proj", "dw_hh_t"), _port(a, reverse, dc),
                               _jax(a, reverse, dc)):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_matches_pallas_streaming(reverse):
    """The streaming backward (time chunks of 4, two batch blocks of 8) is
    the same function; the port's one loop over T stands for both."""
    a = _inputs(12, 16, 4, seed=5, reverse=reverse)
    plstm.set_force_stream((8, 4))
    for name, got, want in zip(("dx_proj", "dw_hh_t"), _port(a, reverse), _jax(a, reverse)):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_matches_autograd_through_the_plain_forward(reverse):
    """With dc_fin = 0 the backward is the gradient of <ys, dys> + <h_fin,
    dh_fin> through the plain forward."""
    a = _inputs(7, 4, 5, seed=11, reverse=reverse)
    x = torch.from_numpy(a["x_proj"]).requires_grad_(True)
    w = torch.from_numpy(a["w_hh_t"]).requires_grad_(True)
    ys, _, h_fin, _ = klstm.lstm_recurrence_reference(x, w, torch.from_numpy(a["mask"]),
                                                      reverse)
    loss = (ys * torch.from_numpy(a["dys"])).sum() + (h_fin * torch.from_numpy(a["dh_fin"])).sum()
    want = torch.autograd.grad(loss, [x, w])
    got = _port(a, reverse, dc=False)
    for name, g, w_ in zip(("dx_proj", "dw_hh_t"), got, want):
        np.testing.assert_allclose(g, w_.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_grads_match_jax_vjp(reverse):
    """LSTMRecurrence (forward kernel with cs saved, BPTT as its backward)
    against jax.vjp of the JAX package's lstm_scan custom_vjp."""
    a = _inputs(8, 5, 6, seed=21)
    rng = np.random.default_rng(3)
    g_ys = rng.normal(size=a["dys"].shape).astype(np.float32)
    g_h = rng.normal(size=a["dh_fin"].shape).astype(np.float32)

    (ys_j, h_j), vjp = jax.vjp(
        lambda x, w: plstm.lstm_scan(x, w, jnp.asarray(a["mask"])[..., None], reverse),
        jnp.asarray(a["x_proj"]), jnp.asarray(a["w_hh_t"]))
    dx_j, dw_j = vjp((jnp.asarray(g_ys), jnp.asarray(g_h)))

    x = torch.from_numpy(a["x_proj"]).requires_grad_(True)
    w = torch.from_numpy(a["w_hh_t"]).requires_grad_(True)
    ys, h = klstm.lstm_scan(x, w, torch.from_numpy(a["mask"]), reverse)
    dx, dw = torch.autograd.grad([ys, h], [x, w],
                                [torch.from_numpy(g_ys), torch.from_numpy(g_h)])
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_j), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **TOL)


def test_unused_ys_gets_a_zero_gradient():
    """Only h_fin reaches the loss (rnn2's ys in the towers): autograd hands
    the Function zeros for dys, and the result is the h_fin-only gradient."""
    a = _inputs(5, 3, 4, seed=8)
    x = torch.from_numpy(a["x_proj"]).requires_grad_(True)
    w = torch.from_numpy(a["w_hh_t"]).requires_grad_(True)
    _, h = klstm.LSTMRecurrence.apply(x, w, torch.from_numpy(a["mask"]), False)
    got = torch.autograd.grad(h.sum(), [x, w])
    x2 = x.detach().clone().requires_grad_(True)
    w2 = w.detach().clone().requires_grad_(True)
    _, _, h2, _ = klstm.lstm_recurrence_reference(x2, w2, torch.from_numpy(a["mask"]))
    want = torch.autograd.grad(h2.sum(), [x2, w2])
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **TOL)


def test_scan_direction_routes_by_gradient(monkeypatch):
    """With a gradient wanted the towers go through LSTMRecurrence (forward
    with cs, then the backward); without one, the forward alone and no cs,
    so serving makes exactly one forward launch per direction."""
    calls = []
    real = klstm.lstm_recurrence

    def spy(*args, **kw):
        calls.append(kw.get("need_cs", False))
        return real(*args, **kw)

    monkeypatch.setattr(klstm, "lstm_recurrence", spy)
    monkeypatch.setattr(bilstm, "lstm_recurrence", spy)
    p = bilstm.LSTMDirection(3, 4)
    p.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 5)
    with torch.no_grad():
        bilstm.scan_direction(p, x, mask, reverse=False)
    assert calls == [False]
    ys, h = bilstm.scan_direction(p, x, mask, reverse=True)
    assert calls == [False, True]
    (h.sum() + ys.sum()).backward()
    assert p.w_hh.grad is not None and p.w_ih.grad is not None


@pytest.mark.parametrize("bad", ["dtype", "shape_ys", "shape_dh", "contig", "device_mix"])
def test_bwd_wrapper_rejects_what_the_kernel_cannot_take(bad):
    t = {k: torch.from_numpy(v) for k, v in _inputs(4, 3, 2, seed=3).items()}
    if bad == "dtype":
        t["dys"] = t["dys"].double()
    elif bad == "shape_ys":
        t["ys"] = t["ys"][:-1].contiguous()
    elif bad == "shape_dh":
        t["dh_fin"] = t["dh_fin"][:, :1].contiguous()
    elif bad == "contig":
        t["cs"] = t["cs"].transpose(0, 1)
    else:
        t["dys"] = t["dys"].to("meta")
    with pytest.raises((TypeError, ValueError)):
        klstm.lstm_recurrence_bwd(t["x_proj"], t["w_hh_t"], t["mask"], t["ys"], t["cs"],
                                  t["dys"], t["dh_fin"])


def test_cpu_backward_does_not_count_as_a_launch():
    klstm.reset_launch_count()
    a = _inputs(3, 2, 2, seed=4)
    _port(a, False)
    assert klstm.launch_count("lstm_bwd") == 0 and klstm.launch_count("lstm_fwd") == 0


def test_dw_splits_fill_the_card_and_cover_every_step():
    """The dW_hh reduction's runs of steps: about two blocks per SM at the
    tower widths, never more runs than steps that add, at least one."""
    tiles_74 = 5 * 5                             # ceil(74 / 16) x ceil(296 / 64)
    assert klstm.dw_splits(48, 74, 132) * tiles_74 >= 2 * 132
    assert klstm.dw_splits(48, 35, 132) == 30
    assert klstm.dw_splits(7, 33, 132) == 6      # T - 1 steps carry an h_prev
    assert klstm.dw_splits(1, 4, 132) == 1
    assert klstm.dw_splits(48, 300, 132) == 1    # 361 tiles fill the card alone
