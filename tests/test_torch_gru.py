"""The port's masked GRU recurrence, forward and BPTT backward, and its
autograd Function (mmda_tpu_torch/ops/kernels/gru.py) against the JAX
package: the Pallas kernels of `mmda_tpu.ops.pallas.gru` in interpret mode,
whole-T and time-chunked streaming, and `jax.vjp` of `gru_scan`; and against
torch.autograd through the plain forward.

Same inputs (numpy, seeded) into both.  Tolerance 1e-5 abs/rel forward and
1e-4 for gradients: both sides are f32 and differ only in summation order
(the port sums dW_hh and db_hh in f64).  On the CPU the wrappers run the
kernels' plain versions; the CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.ops.pallas import gru as pgru
from mmda_tpu.ops.pallas import lstm as plstm
from mmda_tpu_torch.models import bilstm
from mmda_tpu_torch.ops.kernels import gru as kgru

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _interpret_mode():
    plstm.set_force_interpret(True)      # gru.py reads the LSTM module's switch
    yield
    plstm.set_force_interpret(False)
    pgru.set_force_stream(None)


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0], lengths[-1] = 1, T          # the edges: length 1 and length T
    return dict(
        x_proj=rng.normal(size=(T, B, 3 * H)).astype(np.float32),
        w_hh_t=(rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
        b_hh=rng.normal(size=3 * H).astype(np.float32),
        mask=(np.arange(T)[:, None] < lengths[None, :]).astype(np.float32),
        dys=rng.normal(size=(T, B, H)).astype(np.float32),   # random at pads too
        dh_fin=rng.normal(size=(B, H)).astype(np.float32))


def _port_fwd(a, reverse):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return kgru.gru_recurrence(t["x_proj"], t["w_hh_t"], t["b_hh"], t["mask"], reverse)


def _jax_fwd(a, reverse):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return pgru._fwd_call(j["x_proj"], j["w_hh_t"], j["b_hh"][None], j["mask"][..., None],
                          reverse)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(6, 5, 7), (9, 3, 4), (1, 2, 3)])
def test_fwd_matches_pallas_whole_t(T, B, H, reverse):
    a = _inputs(T, B, H, seed=T * 100 + H)
    for name, got, want in zip(("ys", "h_fin"), _port_fwd(a, reverse), _jax_fwd(a, reverse)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **FWD_TOL)


def _bwd_pair(a, reverse):
    """(port, jax) backward outputs from the same saved ys."""
    ys = _port_fwd(a, reverse)[0]
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = kgru.gru_recurrence_bwd(t["x_proj"], t["w_hh_t"], t["b_hh"], t["mask"], ys,
                                  t["dys"], t["dh_fin"], reverse)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    dx, dw, db = pgru._bwd_call(j["x_proj"], j["w_hh_t"], j["b_hh"][None],
                                j["mask"][..., None], jnp.asarray(ys.numpy()), j["dys"],
                                j["dh_fin"], reverse)
    return [g.numpy() for g in got], [np.asarray(dx), np.asarray(dw), np.asarray(db)[0]]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(6, 5, 7), (9, 3, 4), (1, 2, 3)])
def test_bwd_matches_pallas_whole_t(T, B, H, reverse):
    got, want = _bwd_pair(_inputs(T, B, H, seed=T * 100 + H + 1), reverse)
    for name, g, w in zip(("dx_proj", "dw_hh_t", "db_hh"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_fwd_and_bwd_match_pallas_streaming(reverse):
    """The streaming kernels (time chunks of 4, two batch blocks of 8) are
    the same function; the port's one loop over T stands for both."""
    a = _inputs(12, 16, 4, seed=5)
    pgru.set_force_stream((8, 4))
    for name, got, want in zip(("ys", "h_fin"), _port_fwd(a, reverse), _jax_fwd(a, reverse)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **FWD_TOL)
    got, want = _bwd_pair(a, reverse)
    for name, g, w in zip(("dx_proj", "dw_hh_t", "db_hh"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_matches_autograd_through_the_plain_forward(reverse):
    """The backward is the gradient of <ys, dys> + <h_fin, dh_fin> through
    the plain forward, dys at padded steps included."""
    a = _inputs(7, 4, 5, seed=11)
    x, w, b = (torch.from_numpy(a[k]).requires_grad_(True) for k in ("x_proj", "w_hh_t", "b_hh"))
    ys, h_fin = kgru.gru_recurrence_reference(x, w, b, torch.from_numpy(a["mask"]), reverse)
    loss = (ys * torch.from_numpy(a["dys"])).sum() + (h_fin * torch.from_numpy(a["dh_fin"])).sum()
    want = torch.autograd.grad(loss, [x, w, b])
    got = kgru.gru_recurrence_bwd(x.detach(), w.detach(), b.detach(),
                                  torch.from_numpy(a["mask"]), ys.detach(),
                                  torch.from_numpy(a["dys"]), torch.from_numpy(a["dh_fin"]),
                                  reverse)
    for name, g, w_ in zip(("dx_proj", "dw_hh_t", "db_hh"), got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), err_msg=name, **FWD_TOL)
    # masked steps get no input gradient
    assert torch.all(got[0][torch.from_numpy(a["mask"]) == 0] == 0)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_grads_match_jax_vjp(reverse):
    """GRURecurrence (forward kernel with ys saved, BPTT as its backward)
    against jax.vjp of the JAX package's gru_scan custom_vjp."""
    a = _inputs(8, 5, 6, seed=21)
    (ys_j, h_j), vjp = jax.vjp(
        lambda x, w, b: pgru.gru_scan(x, w, b, jnp.asarray(a["mask"])[..., None], reverse),
        jnp.asarray(a["x_proj"]), jnp.asarray(a["w_hh_t"]), jnp.asarray(a["b_hh"])[None])
    dx_j, dw_j, db_j = vjp((jnp.asarray(a["dys"]), jnp.asarray(a["dh_fin"])))

    x, w, b = (torch.from_numpy(a[k]).requires_grad_(True) for k in ("x_proj", "w_hh_t", "b_hh"))
    ys, h = kgru.gru_scan(x, w, b, torch.from_numpy(a["mask"]), reverse)
    dx, dw, db = torch.autograd.grad([ys, h], [x, w, b], [torch.from_numpy(a["dys"]),
                                                         torch.from_numpy(a["dh_fin"])])
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD_TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_j), **FWD_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **BWD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **BWD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j)[0], **BWD_TOL)


def test_unused_ys_gets_a_zero_gradient():
    """Only h_fin reaches the loss (rnn2's ys in the towers): autograd hands
    the Function zeros for dys, and the result is the h_fin-only gradient."""
    a = _inputs(5, 3, 4, seed=8)
    mask = torch.from_numpy(a["mask"])
    leaves = [torch.from_numpy(a[k]).requires_grad_(True) for k in ("x_proj", "w_hh_t", "b_hh")]
    _, h = kgru.GRURecurrence.apply(*leaves, mask, False)
    got = torch.autograd.grad(h.sum(), leaves)
    leaves2 = [t.detach().clone().requires_grad_(True) for t in leaves]
    _, h2 = kgru.gru_recurrence_reference(*leaves2, mask)
    want = torch.autograd.grad(h2.sum(), leaves2)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **FWD_TOL)


def test_scan_direction_routes_by_gradient(monkeypatch):
    """With a gradient wanted the GRU towers go through GRURecurrence
    (forward, then the backward kernel's wrapper); without one, the forward
    wrapper alone, so serving makes exactly one launch per direction."""
    calls = []
    real_fwd, real_bwd = kgru.gru_recurrence, kgru.gru_recurrence_bwd
    monkeypatch.setattr(kgru, "gru_recurrence",
                        lambda *a, **k: (calls.append("fwd"), real_fwd(*a, **k))[1])
    monkeypatch.setattr(bilstm, "gru_recurrence", kgru.gru_recurrence)
    monkeypatch.setattr(kgru, "gru_recurrence_bwd",
                        lambda *a, **k: (calls.append("bwd"), real_bwd(*a, **k))[1])
    p = bilstm.LSTMDirection(3, 4, cell="gru")
    p.reset_parameters(torch.Generator().manual_seed(0))
    assert p.w_ih.shape == (12, 3) and p.w_hh.shape == (12, 4) and p.b_hh.shape == (12,)
    x = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 5)
    with torch.no_grad():
        bilstm.scan_direction(p, x, mask, reverse=False)
    assert calls == ["fwd"]
    ys, h = bilstm.scan_direction(p, x, mask, reverse=True)
    (h.sum() + ys.sum()).backward()
    assert calls == ["fwd", "fwd", "bwd"]
    assert all(t.grad is not None for t in (p.w_hh, p.w_ih, p.b_ih, p.b_hh))


@pytest.mark.parametrize("bad", ["dtype", "shape_ys", "shape_b", "contig", "device_mix", "gates"])
def test_wrappers_reject_what_the_kernels_cannot_take(bad):
    t = {k: torch.from_numpy(v) for k, v in _inputs(4, 3, 2, seed=3).items()}
    t["ys"] = kgru.gru_recurrence_reference(t["x_proj"], t["w_hh_t"], t["b_hh"], t["mask"])[0]
    if bad == "dtype":
        t["dys"] = t["dys"].double()
    elif bad == "shape_ys":
        t["ys"] = t["ys"][:-1].contiguous()
    elif bad == "shape_b":
        t["b_hh"] = t["b_hh"][None]               # the JAX package's (1, 3H)
    elif bad == "contig":
        t["ys"] = t["ys"].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "device_mix":
        t["dys"] = t["dys"].to("meta")
    else:
        t["x_proj"] = t["x_proj"][..., :5].contiguous()
    with pytest.raises((TypeError, ValueError)):
        kgru.gru_recurrence_bwd(t["x_proj"], t["w_hh_t"], t["b_hh"], t["mask"], t["ys"],
                                t["dys"], t["dh_fin"])


def test_cpu_calls_do_not_count_as_launches():
    kgru.reset_launch_count()
    a = _inputs(3, 2, 2, seed=4)
    ys, _ = _port_fwd(a, False)
    _bwd_pair(a, False)
    assert kgru.launch_count("gru_fwd") == 0 and kgru.launch_count("gru_bwd") == 0
    assert ys.shape == (3, 2, 2)


def test_dw_splits_fill_the_card_and_cover_every_step():
    """The dW_hh / db_hh reduction's runs of steps over its (H + 1, 3H)
    result: about two blocks per SM at the tower widths, never more runs
    than steps, at least one."""
    tiles_74 = 5 * 4                             # ceil(75 / 16) x ceil(222 / 64)
    assert kgru.dw_splits(48, 74, 132) * tiles_74 >= 2 * 132
    assert kgru.dw_splits(48, 35, 132) == 44     # 3 x 2 tiles
    assert kgru.dw_splits(7, 33, 132) == 7
    assert kgru.dw_splits(1, 4, 132) == 1
    assert kgru.dw_splits(48, 300, 132) == 1     # 19 x 15 tiles fill the card alone
