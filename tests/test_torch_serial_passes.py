"""The recurrences as the card runs them, modelled on the CPU: the order of
summation of csrc/lstm_fwd.cu's and csrc/gru_fwd.cu's serial passes and of
csrc/gru_bwd.cu's gate pass and serial pass, held against the port's plain versions
(mmda_tpu_torch/ops/kernels/{lstm,gru}.py) and the JAX package's Pallas
kernels in interpret mode (whole-T and time-chunked streaming) and, for the
GRU backward, `jax.vjp` of `gru_scan`.

Same inputs (numpy, seeded) into all.  Tolerance 1e-5 + 1e-5 |ref|: every
side is f32 and they differ only in the order of their sums (the port sums
dW_hh and db_hh in f64).  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.ops.pallas import gru as pgru
from mmda_tpu.ops.pallas import lstm as plstm
from mmda_tpu_torch.ops.kernels import gru as kgru
from mmda_tpu_torch.ops.kernels import lstm as klstm
from mmda_tpu_torch.ops.kernels._launch import _gate_stride

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRU_PARTS = 4      # csrc/gru_bwd.cu kParts: runs of a row's dgh float4s, one thread each
CASES = [(512, 2, 74), (512, 2, 33)]


@pytest.fixture(autouse=True)
def _interpret_mode():
    plstm.set_force_interpret(True)      # gru.py reads the LSTM module's switch
    yield
    plstm.set_force_interpret(False)
    plstm.set_force_stream(None)
    pgru.set_force_stream(None)


def _mask(rng, T, B):
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0], lengths[-1] = 1, T          # the edges: length 1 and length T
    return (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)


def _strided_matmul(a, b):
    """a @ b with the k terms split over four accumulators by k mod 4, added
    as (a0 + a1) + (a2 + a3): a thread's float4 reads."""
    acc = [torch.matmul(a[:, e::4], b[e::4]) for e in range(4)]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _previous(x, reverse):
    """x at the previous processed step of every step, 0 at the first."""
    prev = torch.zeros_like(x)
    if reverse:
        prev[:-1] = x[1:]
    else:
        prev[1:] = x[:-1]
    return prev


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


# ------------------------------------------------------------ LSTM forward


def _lstm_fwd_model(x_proj, w_hh_t, mask, reverse):
    """The forward as csrc/lstm_fwd.cu computes it: thread (j, q) forms gate
    q's product h . w_hh_t[:, qH + j] over four accumulators strided over k,
    then adds x_proj; the quad's four activations make the cell update."""
    T, B, G = x_proj.shape
    H = G // 4
    h = x_proj.new_zeros(B, H)
    c = x_proj.new_zeros(B, H)
    ys, cs = torch.empty(T, B, H), torch.empty(T, B, H)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        pre = x_proj[t] + _strided_matmul(h, w_hh_t)
        ig, fg, og = (_sigmoid(pre[:, q * H:(q + 1) * H]) for q in (0, 1, 3))
        gg = torch.tanh(pre[:, 2 * H:3 * H])
        c_new = fg * c + ig * gg
        h_new = og * torch.tanh(c_new)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys[t], cs[t] = h, c
    return ys, cs, h, c


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", CASES)
def test_lstm_fwd_serial_arithmetic_matches_plain_version_and_pallas(T, B, H, reverse):
    """The card kernel's order of summation (strided accumulators over k,
    then x_proj) gives the plain version's ys, cs, h_fin, c_fin and the
    Pallas kernels' (interpret mode: whole-T, and time-chunked streaming in
    chunks of 64 steps) within 1e-5 abs/rel at T = 512, for an H that is no
    multiple of 4 and the wider tower's, both directions."""
    rng = np.random.default_rng(T + H)
    x_proj = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    w_hh_t = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    mask = _mask(rng, T, B)
    x, w, m = (torch.from_numpy(a) for a in (x_proj, w_hh_t, mask))
    got = _lstm_fwd_model(x, w, m, reverse)
    wants = [klstm.lstm_recurrence_reference(x, w, m, reverse, need_cs=True)]
    for stream in (None, (B, 64)):
        plstm.set_force_stream(stream)
        wants.append(plstm._fwd_call(jnp.asarray(x_proj), jnp.asarray(w_hh_t),
                                     jnp.asarray(mask)[..., None], reverse))
    for want in wants:
        for name, g, w_ in zip(("ys", "cs", "h_fin", "c_fin"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), err_msg=name, **TOL)


# ------------------------------------------------------------ GRU forward


def _gru_fwd_model(x_proj, w_hh_t, b_hh, mask, reverse):
    """The forward as csrc/gru_fwd.cu computes it: thread (j, g) forms gate
    g's product h . w_hh_t[:, gH + j] over four accumulators strided over k,
    then adds b_hh; r, z from x_proj + hh and n = tanh(x_n + r hh_n), the
    cell update held at masked steps."""
    T, B, G = x_proj.shape
    H = G // 3
    h = x_proj.new_zeros(B, H)
    ys = torch.empty(T, B, H)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hh = _strided_matmul(h, w_hh_t) + b_hh
        r = _sigmoid(x_proj[t, :, :H] + hh[:, :H])
        z = _sigmoid(x_proj[t, :, H:2 * H] + hh[:, H:2 * H])
        n = torch.tanh(x_proj[t, :, 2 * H:] + r * hh[:, 2 * H:])
        h_new = (1.0 - z) * n + z * h
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        ys[t] = h
    return ys, h


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", CASES)
def test_gru_fwd_serial_arithmetic_matches_plain_version_and_pallas(T, B, H, reverse):
    """The card kernel's order of summation (strided accumulators over k,
    then b_hh, then x_proj) gives the plain version's ys and h_fin and the Pallas kernels' (interpret mode:
    whole-T, and streaming in chunks of 64 steps) within 1e-5 abs/rel at
    T = 512, both directions."""
    rng = np.random.default_rng(T + H + 2)
    a = dict(x_proj=rng.normal(size=(T, B, 3 * H)).astype(np.float32),
             w_hh_t=(rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
             b_hh=rng.normal(size=3 * H).astype(np.float32), mask=_mask(rng, T, B))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    args = (t["x_proj"], t["w_hh_t"], t["b_hh"], t["mask"], reverse)
    got = _gru_fwd_model(*args)
    wants = [kgru.gru_recurrence_reference(*args)]
    j = {k: jnp.asarray(v) for k, v in a.items()}
    for stream in (None, (B, 64)):
        pgru.set_force_stream(stream)
        wants.append(pgru._fwd_call(j["x_proj"], j["w_hh_t"], j["b_hh"][None],
                                    j["mask"][..., None], reverse))
    for want in wants:
        for name, g, w_ in zip(("ys", "h_fin"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), err_msg=name, **TOL)


# ------------------------------------------------------------ GRU backward


def _gru_parts(dgh, w_hh_t, H):
    """dgh @ w_hh_t^T as csrc/gru_bwd.cu's serial pass forms it: each gate's
    dgh padded to gate_stride(H) and laid end to end, the row cut into
    GRU_PARTS runs of float4s, each run a thread's strided sum against row j
    of w_hh_t laid out the same way, the quad's parts added as
    (p0 + p1) + (p2 + p3)."""
    HP = _gate_stride(H)
    B = dgh.shape[0]
    v = torch.zeros(B, 3 * HP)
    w = torch.zeros(H, 3 * HP)
    for g in range(3):
        v[:, g * HP:g * HP + H] = dgh[:, g * H:(g + 1) * H]
        w[:, g * HP:g * HP + H] = w_hh_t[:, g * H:(g + 1) * H]
    n4 = 3 * HP // 4
    per = -(-n4 // GRU_PARTS)
    parts = [torch.zeros(B, H) for _ in range(4)]
    for q in range(GRU_PARTS):
        lo, hi = 4 * min(n4, q * per), 4 * min(n4, (q + 1) * per)
        if hi > lo:
            parts[q] = _strided_matmul(v[:, lo:hi], w[:, lo:hi].t())
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _gru_bwd_model(x_proj, w_hh_t, b_hh, mask, ys, dys, dh_fin, reverse):
    """The backward as csrc/gru_bwd.cu computes it: r, z, n and hh_n of
    every step from a pass of their own (off the serial chain), then the
    serial steps with the cell backward and dh_prev as `_gru_parts`, then
    dW_hh^T and db_hh summed in f64."""
    T, B, G = x_proj.shape
    H = G // 3
    h_prev = _previous(ys, reverse)
    hh = torch.matmul(h_prev, w_hh_t) + b_hh                    # the gate pass
    r = _sigmoid(x_proj[..., :H] + hh[..., :H])
    z = _sigmoid(x_proj[..., H:2 * H] + hh[..., H:2 * H])
    hn = hh[..., 2 * H:]
    n = torch.tanh(x_proj[..., 2 * H:] + r * hn)
    dh = dh_fin
    dx = torch.empty_like(x_proj)
    dgh = torch.empty_like(x_proj)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        dhv = dh + dys[t]
        m = mask[t][:, None]
        dh_new, dh_pass = m * dhv, (1.0 - m) * dhv
        dz = dh_new * (h_prev[t] - n[t])
        dn = dh_new * (1.0 - z[t])
        dpre_n = dn * (1.0 - n[t] * n[t])
        dpre_r = dpre_n * hn[t] * r[t] * (1.0 - r[t])
        dpre_z = dz * z[t] * (1.0 - z[t])
        dx[t] = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
        dgh[t] = torch.cat([dpre_r, dpre_z, dpre_n * r[t]], dim=-1)
        dh = _gru_parts(dgh[t], w_hh_t, H) + (dh_new * z[t] + dh_pass)
    dw = torch.einsum("tbk,tbg->kg", h_prev.double(), dgh.double())
    return dx, dw.float(), dgh.double().sum((0, 1)).float()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", CASES)
def test_gru_bwd_gate_pass_arithmetic_matches_plain_version_and_pallas(T, B, H, reverse):
    """The card kernel's order of work (the gates in a pass of their own,
    dh_prev as per-thread parts of the padded dgh row) gives the plain
    version's dx_proj, dW_hh^T and db_hh, the Pallas kernels' (interpret
    mode: whole-T, and streaming in chunks of 64 steps) and jax.vjp of
    gru_scan's within 1e-5 abs/rel at T = 512, both directions."""
    rng = np.random.default_rng(T + H + 1)
    a = dict(x_proj=rng.normal(size=(T, B, 3 * H)).astype(np.float32),
             w_hh_t=(rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
             b_hh=rng.normal(size=3 * H).astype(np.float32), mask=_mask(rng, T, B),
             dys=rng.normal(size=(T, B, H)).astype(np.float32),
             dh_fin=rng.normal(size=(B, H)).astype(np.float32))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ys, _ = kgru.gru_recurrence_reference(t["x_proj"], t["w_hh_t"], t["b_hh"], t["mask"],
                                          reverse)
    args = (t["x_proj"], t["w_hh_t"], t["b_hh"], t["mask"], ys, t["dys"], t["dh_fin"], reverse)
    got = _gru_bwd_model(*args)
    wants = [kgru.gru_recurrence_bwd_reference(*args)]
    j = {k: jnp.asarray(v) for k, v in a.items()}
    for stream in (None, (B, 64)):
        pgru.set_force_stream(stream)
        dx, dw, db = pgru._bwd_call(j["x_proj"], j["w_hh_t"], j["b_hh"][None],
                                    j["mask"][..., None], jnp.asarray(ys.numpy()), j["dys"],
                                    j["dh_fin"], reverse)
        wants.append((dx, dw, db[0]))
    pgru.set_force_stream(None)
    _, vjp = jax.vjp(lambda x, w, b: pgru.gru_scan(x, w, b, j["mask"][..., None], reverse),
                     j["x_proj"], j["w_hh_t"], j["b_hh"][None])
    dx, dw, db = vjp((j["dys"], j["dh_fin"]))
    wants.append((dx, dw, db[0]))
    for want in wants:
        for name, g, w_ in zip(("dx_proj", "dw_hh_t", "db_hh"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), err_msg=name, **TOL)
