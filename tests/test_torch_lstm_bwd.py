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
from mmda_tpu_torch.ops.kernels import lstm_multi as kmulti

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


def _previous(x, reverse):
    """x at the previous processed step of every step, 0 at the first."""
    prev = torch.zeros_like(x)
    if reverse:
        prev[:-1] = x[1:]
    else:
        prev[1:] = x[:-1]
    return prev


def _strided_matmul(a, b):
    """a @ b with the k terms split over four accumulators by k mod 4, added
    as (a0 + a1) + (a2 + a3): a thread's float4 reads of the dgates."""
    acc = [torch.matmul(a[:, e::4], b[e::4]) for e in range(4)]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _kernel_model(x_proj, w_hh_t, mask, ys, cs, dys, dh_fin, dc_fin, reverse):
    """The backward as csrc/lstm_bwd.cu computes it: the gate activations of
    every step from a pass of their own (off the serial chain), tanh(c_new)
    recomputed from c_prev and the activations, then the serial steps, where
    dh_prev[j] is four per-gate parts, each row j of one gate's columns of
    w_hh_t against that gate's dgates, added in a quad as (i + f) + (g + o)."""
    T, B, G = x_proj.shape
    H = G // 4
    h_prev, c_prev = _previous(ys, reverse), _previous(cs, reverse)
    gates = x_proj + torch.matmul(h_prev, w_hh_t)                 # the gate pass
    acts = torch.cat([torch.sigmoid(gates[..., :2 * H]), torch.tanh(gates[..., 2 * H:3 * H]),
                      torch.sigmoid(gates[..., 3 * H:])], dim=-1)
    dh = dh_fin
    dc = torch.zeros_like(dh_fin) if dc_fin is None else dc_fin
    dx = torch.empty_like(x_proj)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        ig, fg, gg, og = acts[t].split(H, dim=-1)
        tanh_c = torch.tanh(fg * c_prev[t] + ig * gg)
        dh = dh + dys[t]
        m = mask[t][:, None]
        dh_new, dc_new = m * dh, m * dc
        dh_pass, dc_pass = (1.0 - m) * dh, (1.0 - m) * dc
        dc_new = dc_new + dh_new * og * (1.0 - tanh_c * tanh_c)
        dc = dc_new * fg + dc_pass
        dg = [dc_new * gg * ig * (1.0 - ig), dc_new * c_prev[t] * fg * (1.0 - fg),
              dc_new * ig * (1.0 - gg * gg), dh_new * tanh_c * og * (1.0 - og)]
        part = [_strided_matmul(d, w_hh_t[:, q * H:(q + 1) * H].t()) for q, d in enumerate(dg)]
        dh = ((part[0] + part[1]) + (part[2] + part[3])) + dh_pass
        dx[t] = torch.cat(dg, dim=-1)
    dw = torch.einsum("tbk,tbg->kg", h_prev.double(), dx.double())
    return dx, dw.float()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(512, 2, 74), (7, 5, 33), (48, 3, 35)])
def test_gate_pass_arithmetic_matches_plain_version_and_pallas(T, B, H, reverse):
    """The card kernel's order of work, modelled on the CPU: the gates in a
    pass of their own and dh_prev as four per-gate parts give the plain
    version's dx_proj and dW_hh^T and the Pallas kernel's (interpret mode)
    within 1e-5 abs/rel, at the long step's T = 512 and H = 74 and at an H
    that is no multiple of 4, both directions."""
    a = _inputs(T, B, H, seed=T + H, reverse=reverse)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = _kernel_model(t["x_proj"], t["w_hh_t"], t["mask"], t["ys"], t["cs"], t["dys"],
                        t["dh_fin"], t["dc_fin"], reverse)
    for want in (_port(a, reverse), _jax(a, reverse)):
        for name, g, w in zip(("dx_proj", "dw_hh_t"), got, want):
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_bptt_rows_fill_the_block_limits():
    """The serial pass's batch rows per block (csrc/lstm_bwd.cu): four
    threads per hidden unit up to H = 80 (one gate each, its weights in
    registers, which caps the block), four per group of ceil(H / 256) units
    above; B spread over the SMs first."""
    assert klstm.bptt_threads_per_row(74) == (296, 384)
    assert klstm.bptt_threads_per_row(35) == (140, 640)
    assert klstm.bptt_threads_per_row(300) == (600, 1024)     # 2 units a quad
    assert klstm.bptt_threads_per_row(1024) == (1024, 1024)
    assert klstm.bptt_rows_per_block(32, 74, 132) == 1
    assert klstm.bptt_rows_per_block(512, 35, 132) == 4
    for H in range(1, 1025):
        per_row, cap = klstm.bptt_threads_per_row(H)
        rows = klstm.bptt_rows_per_block(4096, H, 132)   # 32 rows wanted per block
        assert per_row <= cap and 1 <= rows == min(32, cap // per_row), H


def test_bwd_dw_splits_fill_the_card_and_cover_every_row():
    """The backward's dW_hh reduction cuts the (T - 1) B rows that add into
    runs: about four blocks per SM at the tower widths, at most one run per
    16 rows, at least one."""
    tiles_74 = 3 * 5                             # ceil(74 / 32) x ceil(296 / 64)
    assert klstm.bwd_dw_splits(512, 32, 74, 132) * tiles_74 >= 4 * 132
    assert klstm.bwd_dw_splits(48, 64, 35, 132) == 88      # 2 x 3 tiles
    assert klstm.bwd_dw_splits(7, 5, 33, 132) == 2         # 30 rows in runs of 16
    assert klstm.bwd_dw_splits(1, 4, 4, 132) == 1          # no row adds
    assert klstm.bwd_dw_splits(48, 64, 300, 132) == 3      # 10 x 19 tiles


def test_cpu_backward_does_not_count_as_a_launch():
    klstm.reset_launch_count()
    a = _inputs(3, 2, 2, seed=4)
    _port(a, False)
    assert klstm.launch_count("lstm_bwd") == 0 and klstm.launch_count("lstm_fwd") == 0


def test_dw_splits_fill_the_card_and_cover_every_step():
    """The multi-direction backward's dW_hh reductions (csrc/lstm_multi_bwd.cu,
    with this backward's 32 x 64 tiles): each direction's runs sized as
    `bwd_dw_splits` over 2 n_sm / D SMs, never more runs than 16-row chunks
    that add, at least one."""
    hs = (35, 35, 74, 74)
    assert kmulti.dw_splits(48, 64, hs, 132) == [klstm.bwd_dw_splits(48, 64, H, 66) for H in hs]
    assert kmulti.dw_splits(48, 64, hs, 132) == [44, 44, 18, 18]
    assert kmulti.dw_splits(7, 5, (33,), 132) == [2]          # 30 rows in runs of 16
    assert kmulti.dw_splits(1, 4, (4, 4), 132) == [1, 1]      # no row adds
    assert kmulti.dw_splits(48, 64, (300, 74), 132) == [3, 36]
