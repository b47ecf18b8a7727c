"""The port's masked LSTM recurrence (mmda_tpu_torch/ops/kernels/lstm.py)
against the JAX package's Pallas kernel in interpret mode, whole-T and
time-chunked streaming.

Same inputs (numpy, seeded) into both.  Tolerance 1e-5 abs/rel: both sides
are f32 throughout and differ only in the summation order of h @ w_hh_t.
The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mmda_tpu.ops.pallas import lstm as plstm
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


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    x_proj = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    w_hh_t = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0], lengths[-1] = 1, T          # the edges: length 1 and length T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return x_proj, w_hh_t, mask


def _port(x_proj, w_hh_t, mask, reverse):
    out = klstm.lstm_recurrence(torch.from_numpy(x_proj), torch.from_numpy(w_hh_t),
                                torch.from_numpy(mask), reverse, need_cs=True)
    return [t.numpy() for t in out]


def _jax(x_proj, w_hh_t, mask, reverse):
    out = plstm._fwd_call(jnp.asarray(x_proj), jnp.asarray(w_hh_t),
                          jnp.asarray(mask)[..., None], reverse)
    return [np.asarray(t) for t in out]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(6, 5, 7), (9, 3, 4)])
def test_recurrence_matches_pallas_whole_t(T, B, H, reverse):
    args = _inputs(T, B, H, seed=T * 100 + H)
    for name, got, want in zip(("ys", "cs", "h_fin", "c_fin"),
                               _port(*args, reverse), _jax(*args, reverse)):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_matches_pallas_streaming(reverse):
    """The streaming kernel (time chunks of 4, two batch blocks of 8) is the
    same function; the port's one loop over T stands for both."""
    args = _inputs(12, 16, 4, seed=5)
    plstm.set_force_stream((8, 4))
    for name, got, want in zip(("ys", "cs", "h_fin", "c_fin"),
                               _port(*args, reverse), _jax(*args, reverse)):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_need_cs_false_returns_none_and_same_outputs():
    x, w, m = (torch.from_numpy(a) for a in _inputs(5, 4, 3, seed=1))
    ys, cs, h, c = klstm.lstm_recurrence(x, w, m, True)
    ys2, cs2, h2, c2 = klstm.lstm_recurrence(x, w, m, True, need_cs=True)
    assert cs is None and cs2.shape == ys.shape
    torch.testing.assert_close(ys, ys2, rtol=0, atol=0)
    torch.testing.assert_close(c, c2, rtol=0, atol=0)


def test_masked_steps_hold_the_carry():
    """Forward: h_fin is the state at each row's last valid step; reverse:
    pads keep the zero carry, so ys is 0 there."""
    x, w, m = _inputs(7, 4, 3, seed=2)
    ys, _, h_fin, _ = _port(x, w, m, False)
    last = m.sum(0).astype(int) - 1
    np.testing.assert_array_equal(h_fin, ys[last, np.arange(4)])
    ys_b, _, _, _ = _port(x, w, m, True)
    assert np.all(ys_b[m == 0] == 0.0)


@pytest.mark.parametrize("bad", ["dtype", "shape_w", "shape_mask", "contig", "device_mix"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    x, w, m = (torch.from_numpy(a) for a in _inputs(4, 3, 2, seed=3))
    if bad == "dtype":
        x = x.double()
    elif bad == "shape_w":
        w = w[:, :-4].contiguous()
    elif bad == "shape_mask":
        m = m[:, :2].contiguous()
    elif bad == "contig":
        x = x.transpose(0, 1)
    else:
        m = m.to("meta")
    with pytest.raises((TypeError, ValueError)):
        klstm.lstm_recurrence(x, w, m)


def test_cpu_calls_do_not_count_as_launches():
    klstm.reset_launch_count()
    x, w, m = (torch.from_numpy(a) for a in _inputs(3, 2, 2, seed=4))
    klstm.lstm_recurrence(x, w, m)
    assert klstm.launch_count() == 0


def test_rows_per_block_spreads_the_batch_over_the_sms():
    """Batch rows per block of the forward's serial pass: B spread over the
    SMs first, within the block's thread limit (384 threads at H = 74, 640
    at H = 35, 1024 at H = 300 with 2 units a quad)."""
    assert klstm.bptt_rows_per_block(64, 74, 132) == 1
    assert klstm.bptt_rows_per_block(512, 74, 132) == 1
    assert klstm.bptt_rows_per_block(512, 35, 132) == 4
    assert klstm.bptt_rows_per_block(512, 300, 132) == 1
    assert klstm.bptt_rows_per_block(1, 35, 132) == 1
