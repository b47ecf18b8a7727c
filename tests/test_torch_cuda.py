"""The port's CUDA kernels on the card.  Every test here needs an NVIDIA
card (marker `cuda`) and skips without one.  The file imports no JAX, so on
the card, where JAX is not installed, it runs without the repository's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmda_tpu_torch.ops.kernels import attention as kattn
from mmda_tpu_torch.ops.kernels import gru as kgru
from mmda_tpu_torch.ops.kernels import hash_dropout
from mmda_tpu_torch.ops.kernels import layernorm as kln
from mmda_tpu_torch.ops.kernels import lstm as klstm
from mmda_tpu_torch.ops.kernels import lstm_multi as kmulti
from mmda_tpu_torch.ops.kernels import short_attention as kshort

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (CHECK_SHAPES, INT8_DENSES, MASKED_ITEM_SHAPES,  # noqa: E402
                        MASKED_REACH, PEAKED_TIMES, SHORT_SHAPES,
                        check_short_mask, masked_item_case, masked_item_inputs, peaked_check,
                        steady_on_cpu)

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)       # f32 both sides, summation order only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _inputs(T, B, H, seed, device):
    rng = np.random.default_rng(seed)
    x_proj = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    w_hh_t = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0], lengths[-1] = 1, T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x_proj, w_hh_t, mask))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", CHECK_SHAPES)
def test_lstm_kernel_matches_plain_version(cuda_device, T, B, H, reverse):
    """The forward's serial pass (quads, the x_proj ring, weights in
    registers up to H = 80 and from global memory at H = 300) against its
    plain version at every shape `chip_smoke.py` checks, T = 512 included,
    with cs written and not; one launch per call."""
    x, w, m = _inputs(T, B, H, seed=H, device=cuda_device)
    want = klstm.lstm_recurrence_reference(x, w, m, reverse, need_cs=True)
    for need_cs in (True, False):
        before = klstm.launch_count()
        got = klstm.lstm_recurrence(x, w, m, reverse, need_cs=need_cs)
        assert klstm.launch_count() == before + 1
        assert (got[1] is None) == (not need_cs)
        for g, r in zip(got, want):
            if g is not None:
                torch.testing.assert_close(g, r, **TOL)


def _middle_mask(T, B, device):
    """A ragged mask with zeros between ones (not only padded tails), and a
    row masked at every step."""
    rng = np.random.default_rng(T * B)
    m = torch.from_numpy((rng.random((T, B)) < 0.7).astype(np.float32)).to(device)
    m[:, 0] = 0.0
    return m


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(48, 64, 74), (512, 32, 74), (33, 7, 33), (40, 9, 35),
                                   (16, 9, 300)])
def test_lstm_kernel_passes_masked_steps_in_the_middle(cuda_device, T, B, H, reverse):
    """At a masked step h and c hold: the row masked everywhere stays 0."""
    x, w, _ = _inputs(T, B, H, seed=H, device=cuda_device)
    m = _middle_mask(T, B, cuda_device)
    got = klstm.lstm_recurrence(x, w, m, reverse, need_cs=True)
    want = klstm.lstm_recurrence_reference(x, w, m, reverse, need_cs=True)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL)
    assert torch.equal(got[0][:, 0], torch.zeros_like(got[0][:, 0]))


@pytest.mark.parametrize("T,B,H", [(512, 32, 74), (48, 64, 300), (7, 5, 33)])
def test_lstm_kernel_gives_the_same_bits_twice(cuda_device, T, B, H):
    x, w, m = _inputs(T, B, H, seed=H, device=cuda_device)
    first = klstm.lstm_recurrence(x, w, m, need_cs=True)
    again = klstm.lstm_recurrence(x, w, m, need_cs=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_lstm_kernel_rejects_cpu_mixed_inputs(cuda_device):
    x, w, m = _inputs(4, 3, 5, seed=0, device=cuda_device)
    with pytest.raises(ValueError):
        klstm.lstm_recurrence(x, w.cpu(), m)


def _grads(T, B, H, seed, device):
    rng = np.random.default_rng(seed + 1)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
                 for s in ((T, B, H), (B, H), (B, H)))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(48, 64, 35), (48, 64, 74), (48, 64, 300), (7, 5, 33),
                                   (256, 32, 74)])
def test_lstm_bwd_kernel_matches_plain_version(cuda_device, T, B, H, reverse):
    """The BPTT kernel against its plain version on the card, dc_fin given
    and dc_fin None (zeros); dW_hh is summed in f64 on both sides."""
    x, w, m = _inputs(T, B, H, seed=H, device=cuda_device)
    ys, cs, _, _ = klstm.lstm_recurrence_reference(x, w, m, reverse, need_cs=True)
    dys, dh, dc = _grads(T, B, H, H, cuda_device)
    for dc_fin in (dc, None):
        before = klstm.launch_count("lstm_bwd")
        got = klstm.lstm_recurrence_bwd(x, w, m, ys, cs, dys, dh, dc_fin, reverse)
        assert klstm.launch_count("lstm_bwd") == before + 1
        want = klstm.lstm_recurrence_bwd_reference(x, w, m, ys, cs, dys, dh, dc_fin, reverse)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", CHECK_SHAPES)
def test_lstm_bwd_kernel_matches_plain_version_at_the_check_shapes(cuda_device, T, B, H,
                                                                   reverse):
    """The gate pass, the serial pass and the dW passes against the plain
    version at every shape `chip_smoke.py` checks (T = 512 included), with
    dc_fin given; one `lstm_bwd` launch per call."""
    x, w, m = _inputs(T, B, H, seed=T + H, device=cuda_device)
    ys, cs, _, _ = klstm.lstm_recurrence_reference(x, w, m, reverse, need_cs=True)
    dys, dh, dc = _grads(T, B, H, T + H, cuda_device)
    before = klstm.launch_count("lstm_bwd")
    got = klstm.lstm_recurrence_bwd(x, w, m, ys, cs, dys, dh, dc, reverse)
    assert klstm.launch_count("lstm_bwd") == before + 1
    want = klstm.lstm_recurrence_bwd_reference(x, w, m, ys, cs, dys, dh, dc, reverse)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(48, 64, 74), (512, 32, 74), (33, 7, 33), (16, 9, 300)])
def test_lstm_bwd_kernel_passes_masked_steps_in_the_middle(cuda_device, T, B, H, reverse):
    """A ragged mask with zeros between ones (not only padded tails): at a
    masked step dh and dc pass straight through and the dgates are 0,
    whatever the recomputed c_new holds."""
    x, w, _ = _inputs(T, B, H, seed=H, device=cuda_device)
    rng = np.random.default_rng(T * H)
    m = torch.from_numpy((rng.random((T, B)) < 0.7).astype(np.float32)).to(cuda_device)
    m[:, 0] = 0.0                                     # a row masked at every step
    ys, cs, _, _ = klstm.lstm_recurrence_reference(x, w, m, reverse, need_cs=True)
    dys, dh, dc = _grads(T, B, H, H, cuda_device)
    for dc_fin in (dc, None):
        got = klstm.lstm_recurrence_bwd(x, w, m, ys, cs, dys, dh, dc_fin, reverse)
        want = klstm.lstm_recurrence_bwd_reference(x, w, m, ys, cs, dys, dh, dc_fin, reverse)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, **TOL)
        assert torch.equal(got[0][m == 0.0], torch.zeros_like(got[0][m == 0.0]))


def test_lstm_scan_gradients_on_the_card_match_the_cpu(cuda_device):
    """LSTMRecurrence through both kernels on the card against the same
    Function on the CPU (plain versions)."""
    cpu = _inputs(16, 9, 20, seed=3, device="cpu")

    def run(dev):
        x, w, m = (t.to(dev) for t in cpu)
        x.requires_grad_(True)
        w.requires_grad_(True)
        ys, h = klstm.lstm_scan(x, w, m, reverse=True)
        g = torch.autograd.grad((ys * ys).sum() + h.sum(), [x, w])
        return [t.detach().cpu() for t in (ys, h, *g)]

    for a, b in zip(steady_on_cpu(lambda: run("cpu")), run(cuda_device)):
        torch.testing.assert_close(a, b, **TOL)


def test_lstm_bwd_kernel_rejects_cpu_mixed_inputs(cuda_device):
    x, w, m = _inputs(4, 3, 5, seed=0, device=cuda_device)
    ys, cs, _, _ = klstm.lstm_recurrence(x, w, m, need_cs=True)
    dys, dh, _ = _grads(4, 3, 5, 0, cuda_device)
    with pytest.raises(ValueError):
        klstm.lstm_recurrence_bwd(x, w, m, ys, cs.cpu(), dys, dh)


# ------------------------------------------------------------------- GRU


def _gru_inputs(T, B, H, seed, device):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0], lengths[-1] = 1, T
    arrays = (rng.normal(size=(T, B, 3 * H)), rng.normal(size=(H, 3 * H)) / np.sqrt(H),
              rng.normal(size=3 * H), np.arange(T)[:, None] < lengths[None, :],
              rng.normal(size=(T, B, H)), rng.normal(size=(B, H)))     # dys random at pads
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", CHECK_SHAPES + [(1, 3, 5)])
def test_gru_kernels_match_plain_versions(cuda_device, T, B, H, reverse):
    """Forward and BPTT kernels against their plain versions on the card at
    every shape `chip_smoke.py` checks (T = 512 included; the backward's
    serial pass with weights in registers up to H = 80, from global memory
    at H = 300); dW_hh and db_hh are summed in f64 on both sides."""
    x, w, b, m, dys, dh = _gru_inputs(T, B, H, seed=H, device=cuda_device)
    before = kgru.launch_count("gru_fwd"), kgru.launch_count("gru_bwd")
    ys, h_fin = kgru.gru_recurrence(x, w, b, m, reverse)
    got = kgru.gru_recurrence_bwd(x, w, b, m, ys, dys, dh, reverse)
    assert (kgru.launch_count("gru_fwd"), kgru.launch_count("gru_bwd")) == (before[0] + 1,
                                                                           before[1] + 1)
    ys_r, h_r = kgru.gru_recurrence_reference(x, w, b, m, reverse)
    torch.testing.assert_close(ys, ys_r, **TOL)
    torch.testing.assert_close(h_fin, h_r, **TOL)
    want = kgru.gru_recurrence_bwd_reference(x, w, b, m, ys_r, dys, dh, reverse)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(48, 64, 74), (512, 32, 74), (33, 7, 33), (40, 9, 35),
                                   (16, 9, 300)])
def test_gru_bwd_kernel_passes_masked_steps_in_the_middle(cuda_device, T, B, H, reverse):
    """At a masked step dh passes straight through and dx_proj is 0."""
    x, w, b, _, dys, dh = _gru_inputs(T, B, H, seed=H, device=cuda_device)
    m = _middle_mask(T, B, cuda_device)
    ys, _ = kgru.gru_recurrence_reference(x, w, b, m, reverse)
    got = kgru.gru_recurrence_bwd(x, w, b, m, ys, dys, dh, reverse)
    want = kgru.gru_recurrence_bwd_reference(x, w, b, m, ys, dys, dh, reverse)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL)
    assert torch.equal(got[0][m == 0.0], torch.zeros_like(got[0][m == 0.0]))


@pytest.mark.parametrize("T,B,H", [(512, 32, 74), (48, 64, 300), (7, 5, 33)])
def test_gru_bwd_kernel_gives_the_same_bits_twice(cuda_device, T, B, H):
    x, w, b, m, dys, dh = _gru_inputs(T, B, H, seed=H, device=cuda_device)
    ys, _ = kgru.gru_recurrence(x, w, b, m)
    first = kgru.gru_recurrence_bwd(x, w, b, m, ys, dys, dh)
    again = kgru.gru_recurrence_bwd(x, w, b, m, ys, dys, dh)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, again))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,H", [(64, 64, 74), (512, 32, 74), (33, 7, 33), (40, 9, 35),
                                   (16, 9, 300)])
def test_gru_fwd_kernel_passes_masked_steps_in_the_middle(cuda_device, T, B, H, reverse):
    """At a masked step h holds: the row masked everywhere stays 0."""
    x, w, b, _, _, _ = _gru_inputs(T, B, H, seed=H, device=cuda_device)
    m = _middle_mask(T, B, cuda_device)
    got = kgru.gru_recurrence(x, w, b, m, reverse)
    want = kgru.gru_recurrence_reference(x, w, b, m, reverse)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL)
    assert torch.equal(got[0][:, 0], torch.zeros_like(got[0][:, 0]))


@pytest.mark.parametrize("T,B,H", [(64, 64, 74), (512, 32, 74), (48, 64, 300), (7, 5, 33)])
def test_gru_fwd_kernel_gives_the_same_bits_twice(cuda_device, T, B, H):
    x, w, b, m, _, _ = _gru_inputs(T, B, H, seed=H, device=cuda_device)
    first = kgru.gru_recurrence(x, w, b, m)
    again = kgru.gru_recurrence(x, w, b, m, False)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, again))


def test_gru_scan_gradients_on_the_card_match_the_cpu(cuda_device):
    cpu = _gru_inputs(16, 9, 20, seed=3, device="cpu")

    def run(dev):
        x, w, b, m = (t.to(dev) for t in cpu[:4])
        for t in (x, w, b):
            t.requires_grad_(True)
        ys, h = kgru.gru_scan(x, w, b, m, reverse=True)
        g = torch.autograd.grad((ys * ys).sum() + h.sum(), [x, w, b])
        return [t.detach().cpu() for t in (ys, h, *g)]

    for a, b_ in zip(steady_on_cpu(lambda: run("cpu")), run(cuda_device)):
        torch.testing.assert_close(a, b_, **TOL)


def test_gru_kernels_reject_cpu_mixed_inputs(cuda_device):
    x, w, b, m, dys, dh = _gru_inputs(4, 3, 5, seed=0, device=cuda_device)
    with pytest.raises(ValueError):
        kgru.gru_recurrence(x, w, b.cpu(), m)
    ys, _ = kgru.gru_recurrence(x, w, b, m)
    with pytest.raises(ValueError):
        kgru.gru_recurrence_bwd(x, w, b, m, ys.cpu(), dys, dh)


# ------------------------------------------- residual + dropout + LayerNorm


def _ln_inputs(N, H, dtype, seed, device):
    rng = np.random.default_rng(seed)
    x, y, dout = (torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32)).to(device, dtype)
                  for _ in range(3))
    g, b = (torch.from_numpy(rng.normal(size=H).astype(np.float32)).to(device) for _ in range(2))
    return x, y, g, b, dout


@pytest.mark.parametrize("seed", [7, 2 ** 31 - 2])
@pytest.mark.parametrize("N,H,dtype", [(3200, 768, torch.bfloat16), (3200, 768, torch.float32),
                                       (200, 128, torch.float32), (300, 128, torch.bfloat16),
                                       (13, 30, torch.float32), (100, 1536, torch.bfloat16),
                                       (13, 1025, torch.float32)])
def test_ln_dropout_mask_is_the_hash_bit_for_bit(cuda_device, N, H, dtype, seed):
    """x = 0, y = 1, scale = 1: the forward's z is keep / (1 - rate), so the
    kept positions are where the output lies above the row mean (in rows
    that hold both kinds); the backward's dy is zero exactly where an
    element was dropped, in every row.  (13, 30): H not a multiple of 4,
    the kernel's one-value-per-access path."""
    rate = 0.1
    x = torch.zeros(N, H, dtype=dtype, device=cuda_device)
    y = torch.ones_like(x)
    g, b = torch.ones(H, device=cuda_device), torch.zeros(H, device=cuda_device)
    s = torch.tensor([seed], dtype=torch.int32, device=cuda_device)
    want = hash_dropout.keep_mask((N, H), rate, s)
    assert 0 < want.mean().item() < 1
    out = kln.residual_dropout_layernorm_fwd(x, y, g, b, s, rate).float()
    mixed = want.min(1).values != want.max(1).values
    assert mixed.any() and torch.equal((out > 0).float()[mixed], want[mixed])
    dout = torch.randn(N, H, device=cuda_device).to(dtype)
    dx, dy, _, _ = kln.residual_dropout_layernorm_bwd(x, y, g, dout, s, rate)
    moved = dx.float() != 0
    assert torch.equal((dy.float() != 0)[moved], want.bool()[moved])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N,H,dtype", [(3200, 768, torch.bfloat16), (3200, 768, torch.float32),
                                       (200, 128, torch.float32), (300, 128, torch.float32),
                                       (13, 30, torch.float32)])
def test_ln_dropout_kernels_match_plain_versions(cuda_device, N, H, dtype, rate):
    """f32: 1e-5 abs/rel; bf16: one bf16 ulp (2^-7 relative: a value on a
    rounding boundary may round the other way); dscale, dbias 1e-4."""
    x, y, g, b, dout = _ln_inputs(N, H, dtype, seed=N + H, device=cuda_device)
    s = torch.tensor([77], dtype=torch.int32, device=cuda_device)
    tol = TOL if dtype == torch.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    before = kln.launch_count("ln_dropout_fwd"), kln.launch_count("ln_dropout_bwd")
    out = kln.residual_dropout_layernorm_fwd(x, y, g, b, s, rate, 1e-12)
    got = kln.residual_dropout_layernorm_bwd(x, y, g, dout, s, rate, 1e-12)
    assert (kln.launch_count("ln_dropout_fwd"), kln.launch_count("ln_dropout_bwd")) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, kln.residual_dropout_layernorm_reference(
        x, y, g, b, s, rate, 1e-12), **tol)
    want = kln.residual_dropout_layernorm_bwd_reference(x, y, g, dout, s, rate, 1e-12)
    for g_, w_, t in zip(got, want, (tol, tol, dict(rtol=1e-4, atol=1e-4),
                                    dict(rtol=1e-4, atol=1e-4))):
        assert g_.dtype == w_.dtype
        torch.testing.assert_close(g_, w_, **t)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N,H,dtype", [
    (3200, 768, torch.bfloat16), (3201, 768, torch.bfloat16), (3201, 768, torch.float32),
    (1, 768, torch.bfloat16), (1, 30, torch.float32), (50, 100, torch.float32),
    (50, 100, torch.bfloat16), (13, 30, torch.bfloat16), (64, 770, torch.float32),
    (64, 770, torch.bfloat16), (64, 1024, torch.bfloat16), (64, 512, torch.float32),
    (300, 1025, torch.float32), (300, 1536, torch.bfloat16), (300, 1536, torch.float32),
    (40, 4096, torch.bfloat16), (3, 14528, torch.float32)])
def test_ln_dropout_bwd_kernel_matches_plain_version(cuda_device, N, H, dtype, rate):
    """Every instantiation of the rows pass (4 values an access: H = 100,
    512, 768, 1024; one: H = 30, 770; a block a row above 1024, 4 values an
    access at H = 1536, 4096 and 14528, one at 1025), one row and a last
    block that is not full: dx, dy within 1e-5 (f32) or one bf16 ulp,
    dscale, dbias 1e-4."""
    x, y, g, _, dout = _ln_inputs(N, H, dtype, seed=N * H, device=cuda_device)
    s = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    tol = TOL if dtype == torch.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    got = kln.residual_dropout_layernorm_bwd(x, y, g, dout, s, rate, 1e-12)
    want = kln.residual_dropout_layernorm_bwd_reference(x, y, g, dout, s, rate, 1e-12)
    for g_, w_, t in zip(got, want, (tol, tol, dict(rtol=1e-4, atol=1e-4),
                                     dict(rtol=1e-4, atol=1e-4))):
        assert g_.dtype == w_.dtype
        torch.testing.assert_close(g_, w_, **t)


@pytest.mark.parametrize("N,H,dtype", [(3200, 768, torch.bfloat16), (3200, 768, torch.float32),
                                       (13, 30, torch.bfloat16), (600, 1536, torch.bfloat16),
                                       (300, 1025, torch.float32)])
def test_ln_dropout_bwd_kernel_gives_the_same_bits_twice(cuda_device, N, H, dtype):
    x, y, g, _, dout = _ln_inputs(N, H, dtype, seed=1, device=cuda_device)
    s = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    first = kln.residual_dropout_layernorm_bwd(x, y, g, dout, s, 0.1)
    again = kln.residual_dropout_layernorm_bwd(x, y, g, dout, s, 0.1)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, again))


def test_ln_dropout_bwd_kernel_takes_every_row_the_forward_takes(cuda_device):
    """Rows wider than 1024 launch the backward (a block a row) up to the
    forward's widest, 14528; one wider raises in both."""
    x, y, g, b, dout = _ln_inputs(4, 1025, torch.float32, seed=0, device=cuda_device)
    before = kln.launch_count("ln_dropout_bwd")
    kln.residual_dropout_layernorm_bwd(x, y, g, dout, None, 0.0)
    assert kln.launch_count("ln_dropout_bwd") == before + 1
    x, y, g, b, dout = _ln_inputs(2, 14529, torch.float32, seed=0, device=cuda_device)
    for call in (lambda: kln.residual_dropout_layernorm_fwd(x, y, g, b, None),
                 lambda: kln.residual_dropout_layernorm_bwd(x, y, g, dout, None)):
        with pytest.raises(ValueError, match="shared memory"):
            call()


def test_ln_dropout_autograd_on_the_card_matches_the_cpu(cuda_device):
    cpu = _ln_inputs(50, 64, torch.float32, seed=1, device="cpu")

    def run(dev):
        x, y, g, b, dout = (t.to(dev) for t in cpu)
        leaves = [t.requires_grad_(True) for t in (x, y, g, b)]
        s = torch.tensor([9], dtype=torch.int32, device=dev)
        out = kln.residual_dropout_layernorm(*leaves, s, 0.2, 1e-5)
        grads = torch.autograd.grad(out, leaves, dout)
        return [t.detach().cpu() for t in (out, *grads)]

    for a, b_ in zip(steady_on_cpu(lambda: run("cpu")), run(cuda_device)):
        torch.testing.assert_close(a, b_, **TOL)


def test_ln_dropout_kernels_reject_cpu_mixed_inputs(cuda_device):
    x, y, g, b, dout = _ln_inputs(6, 8, torch.float32, seed=0, device=cuda_device)
    s = torch.tensor([1], dtype=torch.int32)          # on the CPU
    with pytest.raises(ValueError):
        kln.residual_dropout_layernorm_fwd(x, y, g, b, s, 0.1)
    with pytest.raises(ValueError):
        kln.residual_dropout_layernorm_bwd(x, y.cpu(), g, dout, None, 0.0)


def _attn_inputs(BH, S, D, dtype, seed, device):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(BH, S, D)).astype(np.float32)).to(device)
                  for _ in range(4))
    mask = np.ones((BH, S), np.float32)
    for b in range(1, BH):                        # masked tails of different lengths
        mask[b, S - (b * S) // (2 * BH) - 1:] = 0.0
    bias = torch.from_numpy((1.0 - mask) * -1e9).float().to(device)
    return q.to(dtype), k.to(dtype), v.to(dtype), bias, g


def _close(got, want, atol, rtol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all() and want.abs().max() > 0
    assert ((got - want).abs() - atol - rtol * want.abs()).max().item() <= 0


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,D", [(24, 130, 64), (24, 514, 64), (8, 1026, 64), (4, 130, 16),
                                    (4, 70, 32), (2, 200, 128), (3, 5, 16), (4, 130, 8),
                                    (4, 200, 40), (2, 130, 96), (3, 5, 1)])
def test_flash_kernels_match_plain_versions(cuda_device, BH, S, D, dtype, rate):
    """The three attention kernels against their plain versions on the card,
    each launched once; a D outside 16, 32, 64, 128 on the next of them up.  f32: 1e-5 + 1e-4 |ref| (summation order only); bf16:
    2e-2 on o, 2e-2 plus one bf16 ulp on the gradients (a probability on a
    rounding boundary may round the other way)."""
    q, k, v, bias, g = _attn_inputs(BH, S, D, dtype, S + D, cuda_device)
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda_device)
    before = [kattn.launch_count(n) for n in kattn.SOURCES]
    o, lse = kattn.flash_attention_fwd(q, k, v, bias, seed, rate)
    o_w, lse_w = kattn.flash_attention_fwd_reference(q, k, v, bias, seed, rate)
    dsum = kattn.row_dsum(g, o_w)
    args = (q, k, v, bias, seed, g, lse_w, dsum, rate)
    dq = kattn.flash_attention_bwd_dq(*args)
    dk, dv = kattn.flash_attention_bwd_dkv(*args)
    assert [kattn.launch_count(n) for n in kattn.SOURCES] == [b + 1 for b in before]
    assert o.dtype == torch.float32 and dq.dtype == dk.dtype == dv.dtype == dtype
    f32 = dtype == torch.float32
    _close(o, o_w, *((1e-5, 1e-4) if f32 else (2e-2, 0.0)))
    _close(lse, lse_w, 1e-5, 1e-4)
    tol = (1e-5, 1e-4) if f32 else (2e-2, 2.0 ** -7)
    _close(dq, kattn.flash_attention_bwd_dq_reference(*args), *tol)
    for got, want in zip((dk, dv), kattn.flash_attention_bwd_dkv_reference(*args)):
        _close(got, want, *tol)


@pytest.mark.parametrize("BH,S,D,seed", [(3, 130, 64, 7), (2, 130, 16, -5)])
def test_flash_forward_keep_mask_is_the_hash_bit_for_bit(cuda_device, BH, S, D, seed):
    """q = k = 0, no bias, v a shifted identity: o S (1 - rate) is D columns
    of the S x S keep mask at a time."""
    rate = 0.1
    s = torch.tensor([seed], dtype=torch.int32, device=cuda_device)
    want = hash_dropout.attention_keep_mask((BH, S, S), rate, s)
    zeros = torch.zeros(BH, S, D, device=cuda_device)
    idx = torch.arange(D, device=cuda_device)
    for off in range(0, S, D):
        n = min(D, S - off)
        v = torch.zeros(BH, S, D, device=cuda_device)
        v[:, off + idx[:n], idx[:n]] = 1.0
        o, _ = kattn.flash_attention_fwd(zeros, zeros, v, torch.zeros(BH, S, device=cuda_device),
                                         s, rate)
        got = (o * S / hash_dropout.keep_scale(rate)).round()[:, :, :n]
        assert torch.equal(got, want[:, :, off:off + n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,D,seed", [(3, 130, 64, 7), (2, 130, 16, -5)])
def test_flash_backward_keep_masks_are_the_hash_bit_for_bit(cuda_device, BH, S, D, seed,
                                                            dtype):
    """q = k = 0, no bias, lse = dsum = 0: every probability is exactly 1.
    dk/dv: do a shifted identity, so dv (1 - rate) is D rows of the mask at a
    time, transposed.  dq: do = 1, v = 1 / D, so ds is the scaled mask, and k
    a shifted identity picks D of its columns.  Every value is exact in bf16
    but the scaled keep 1 / (1 - rate), which rounds to nearest: the ratio
    still rounds to 1 (kept) or 0 (dropped)."""
    rate = 0.1
    s = torch.tensor([seed], dtype=torch.int32, device=cuda_device)
    want = hash_dropout.attention_keep_mask((BH, S, S), rate, s)
    ks = hash_dropout.keep_scale(rate)
    zeros = torch.zeros(BH, S, D, device=cuda_device, dtype=dtype)
    ones = torch.ones(BH, S, D, device=cuda_device)
    vec0 = torch.zeros(BH, S, device=cuda_device)
    idx = torch.arange(D, device=cuda_device)
    for off in range(0, S, D):
        n = min(D, S - off)
        shifted = torch.zeros(BH, S, D, device=cuda_device)
        shifted[:, off + idx[:n], idx[:n]] = 1.0
        _, dv = kattn.flash_attention_bwd_dkv(zeros, zeros, zeros, vec0, s, shifted, vec0,
                                              vec0, rate)
        dq = kattn.flash_attention_bwd_dq(zeros, shifted.to(dtype), (ones / D).to(dtype), vec0,
                                          s, ones, vec0, vec0, rate)
        got_dv = (dv.float() / ks).round()[:, :, :n].transpose(1, 2)
        got_dq = (dq.float() / (kattn.softmax_scale(D) * ks)).round()[:, :, :n]
        assert torch.equal(got_dv, want[:, off:off + n, :])
        assert torch.equal(got_dq, want[:, :, off:off + n])


@pytest.mark.parametrize("BH,S,D", [(24, 514, 64), (2, 200, 128), (3, 5, 16), (4, 200, 40)])
def test_flash_backward_kernels_give_the_same_bits_twice(cuda_device, BH, S, D):
    """No atomics: each block owns its output rows, so two launches on the
    same bf16 inputs give identical bits."""
    q, k, v, bias, g = _attn_inputs(BH, S, D, torch.bfloat16, 3, cuda_device)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    o, lse = kattn.flash_attention_fwd(q, k, v, bias, seed, 0.1)
    args = (q, k, v, bias, seed, g, lse, kattn.row_dsum(g, o), 0.1)
    first = (kattn.flash_attention_bwd_dq(*args), *kattn.flash_attention_bwd_dkv(*args))
    second = (kattn.flash_attention_bwd_dq(*args), *kattn.flash_attention_bwd_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("BH,S,D", [(24, 514, 64), (2, 200, 128), (3, 5, 16)])
def test_flash_forward_gives_the_same_bits_twice(cuda_device, BH, S, D):
    """Each block owns its rows and sums in a fixed order: two launches on the
    same bf16 inputs give identical o and lse."""
    q, k, v, bias, _ = _attn_inputs(BH, S, D, torch.bfloat16, 4, cuda_device)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    first = kattn.flash_attention_fwd(q, k, v, bias, seed, 0.1)
    second = kattn.flash_attention_fwd(q, k, v, bias, seed, 0.1)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_autograd_on_the_card_matches_the_cpu(cuda_device):
    cpu = _attn_inputs(3, 70, 16, torch.float32, seed=1, device="cpu")

    def run(dev):
        q, k, v, bias, g = (t.to(dev) for t in cpu)
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        s = torch.tensor([9], dtype=torch.int32, device=dev)
        o = kattn.flash_attention(*leaves, bias, s, 0.2)
        return [t.detach().cpu() for t in (o, *torch.autograd.grad(o, leaves, g))]

    for a, b_ in zip(steady_on_cpu(lambda: run("cpu")), run(cuda_device)):
        _close(b_, a, 1e-5, 1e-4)


def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    q, k, v, bias, g = _attn_inputs(2, 9, 16, torch.float32, seed=0, device=cuda_device)
    with pytest.raises(ValueError):
        kattn.flash_attention_fwd(q, k.cpu(), v, bias, None)
    with pytest.raises(ValueError):                         # the seed on the CPU
        kattn.flash_attention_fwd(q, k, v, bias, torch.tensor([1], dtype=torch.int32), 0.1)
    wide = torch.zeros(2, 9, 136, device=cuda_device)
    with pytest.raises(ValueError, match="D <= 128"):
        kattn.flash_attention_fwd(wide, wide, wide, bias, None)


# ------------------------------------------------- short attention (rows 15-16)


def _short_inputs(B, nh, S, hd, dtype, seed, device):
    """q, k, v, the incoming gradient (in dtype) and a (B, S) key bias with a
    masked tail of another length in every batch item but the first."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, nh, S, hd)).astype(np.float32))
                  .to(device, dtype) for _ in range(4))
    mask = np.ones((B, S), np.float32)
    for b in range(1, B):
        mask[b, S - 1 - (b * S) // (2 * B):] = 0.0
    return q, k, v, g, torch.from_numpy((1.0 - mask) * -1e9).float().to(device)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nh,S,hd", [(64, 12, 50, 64), (8, 12, 66, 64), (8, 12, 18, 64),
                                       (3, 4, 10, 8), (2, 2, 128, 64), (2, 3, 33, 100),
                                       (2, 3, 66, 128), (2, 4, 129, 8), (2, 4, 257, 128),
                                       (1, 2, 1026, 64), (4, 12, 514, 64), (2, 3, 200, 40),
                                       (2, 2, 128, 128), (2, 3, 200, 100)])
def test_short_attention_kernels_match_plain_versions(cuda_device, B, nh, S, hd, dtype, rate):
    """The kernels of the shape's route (one block per (b, h), or query and
    key tiles beyond S = 128) against their plain versions on the card, each launched
    once and no other.  f32: 1e-5 + 1e-5 |ref|; bf16: one bf16 ulp (the math
    is f32 on both sides and each output is rounded once)."""
    q, k, v, g, bias = _short_inputs(B, nh, S, hd, dtype, S + hd, cuda_device)
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda_device)
    route = kshort.ROUTE_SOURCES[kshort.kernel_route(S, hd, dtype)]
    assert (kshort.kernel_route(S, hd, dtype) == "tiled") == (S > 128)
    before = {n: kshort.launch_count(n) for n in kshort.SOURCES}
    o = kshort.short_attention_fwd(q, k, v, bias, seed, rate)
    grads = kshort.short_attention_bwd(q, k, v, bias, seed, g, rate)
    assert {n: kshort.launch_count(n) for n in kshort.SOURCES} == {
        n: c + (n in route) for n, c in before.items()}
    want = [kshort.short_attention_fwd_reference(q, k, v, bias, seed, rate),
            *kshort.short_attention_bwd_reference(q, k, v, bias, seed, g, rate)]
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-6, 2.0 ** -7)
    for got, ref in zip((o, *grads), want):
        assert got.dtype == dtype
        _close(got, ref, *tol)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,nh,S,hd", SHORT_SHAPES + [(2, 3, 33, 16), (2, 3, 40, 32),
                                                      (2, 3, 33, 100), (2, 3, 17, 120),
                                                      (2, 3, 66, 128), (2, 2, 128, 128)])
def test_short_attention_bf16_forward_matches_plain_version(cuda_device, B, nh, S, hd, rate):
    """The bf16 forward on the tensor cores (three bf16 terms for pd, scale
    after q k^T) against its plain version: one bf16 ulp plus 1e-6, at every
    shape `chip_smoke.py` checks, hd = 8 to 128 and S = hd = 128; two launches
    give the same bits."""
    q, k, v, _, bias = _short_inputs(B, nh, S, hd, torch.bfloat16, S * hd, cuda_device)
    seed = torch.tensor([77], dtype=torch.int32, device=cuda_device)
    before = kshort.launch_count("short_attn_fwd")
    o = kshort.short_attention_fwd(q, k, v, bias, seed, rate)
    again = kshort.short_attention_fwd(q, k, v, bias, seed, rate)
    assert kshort.launch_count("short_attn_fwd") == before + 2
    assert o.dtype == torch.bfloat16 and torch.equal(o, again)
    _close(o, kshort.short_attention_fwd_reference(q, k, v, bias, seed, rate), 1e-6, 2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nh,S,seed", [(3, 4, 18, 7), (2, 12, 50, -5), (1, 2, 66, 2 ** 31 - 2),
                                         (2, 3, 129, 11), (1, 2, 514, -7)])
def test_short_attention_keep_mask_is_the_hash_bit_for_bit(cuda_device, B, nh, S, seed, dtype):
    """q = k = 0, no bias, v a shifted identity (128 keys at a time beyond
    S = 128): o S (1 - rate) is the keep mask; the backward with do a
    shifted identity gives dv (1 - rate) = the mask transposed.  In bf16 the
    inputs are exact and each output is the scaled keep rounded once: the
    ratio still rounds to 1 or 0 (`chip_smoke.check_short_mask`)."""
    check_short_mask(kshort, hash_dropout, B, nh, S, seed, cuda_device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nh,S,hd", [(64, 12, 50, 64), (2, 2, 128, 64), (2, 3, 66, 128),
                                       (2, 3, 33, 100), (4, 12, 514, 64), (2, 4, 257, 128),
                                       (2, 3, 200, 100)])
def test_short_attention_backward_gives_the_same_bits_twice(cuda_device, B, nh, S, hd, dtype):
    """No atomics (one block per (batch item, head), or the tiled dq kernel
    then the dk/dv kernel, each block owning its rows): two launches on the
    same inputs give identical dq, dk and dv, and the tiled forward o."""
    q, k, v, g, bias = _short_inputs(B, nh, S, hd, dtype, 6, cuda_device)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    first = kshort.short_attention_bwd(q, k, v, bias, seed, g, 0.1)
    second = kshort.short_attention_bwd(q, k, v, bias, seed, g, 0.1)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(kshort.short_attention_fwd(q, k, v, bias, seed, 0.1),
                       kshort.short_attention_fwd(q, k, v, bias, seed, 0.1))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nh,S,hd", [(4, 12, 514, 64), (2, 3, 200, 100), (2, 4, 257, 128),
                                       (2, 4, 129, 8)])
def test_tiled_backward_from_saved_statistics_is_the_standalone_one(cuda_device, B, nh, S, hd,
                                                                    dtype, rate):
    """The training forward's o is `short_attention_fwd`'s bit for bit, and
    the backward from its saved (m, l) and o32 gives the standalone
    backward's bits (which forms them itself in the same call, counted once
    as `short_attn_tiled_bwd`)."""
    q, k, v, g, bias = _short_inputs(B, nh, S, hd, dtype, S + hd + 1, cuda_device)
    seed = torch.tensor([321], dtype=torch.int32, device=cuda_device)
    before = {n: kshort.launch_count(n) for n in kshort.SOURCES}
    o, stats, o32 = kshort.short_attention_fwd_train(q, k, v, bias, seed, rate)
    grads = kshort.short_attention_bwd(q, k, v, bias, seed, g, rate, stats, o32)
    alone = kshort.short_attention_bwd(q, k, v, bias, seed, g, rate)
    assert {n: kshort.launch_count(n) - c for n, c in before.items()} == {
        n: {"short_attn_tiled_fwd": 1, "short_attn_tiled_bwd": 2}.get(n, 0)
        for n in kshort.SOURCES}
    assert stats.shape == (B, nh, S, 2) and (o32 is o) == (dtype == torch.float32)
    assert torch.equal(o, kshort.short_attention_fwd(q, k, v, bias, seed, rate))
    assert torch.equal(o32.to(dtype), o)
    for a, b in zip(grads, alone):
        assert torch.equal(a, b)
    o_w, stats_w, _ = kshort.short_attention_fwd_train_reference(q, k, v, bias, seed, rate)
    _close(stats, stats_w, 1e-5, 1e-5)


@pytest.mark.parametrize("impl", [0, 1])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,nh,S,hd", [(2, 3, 300, 36), (2, 2, 514, 128), (2, 4, 257, 8),
                                       (4, 12, 514, 64), (2, 3, 200, 100), (2, 2, 129, 33),
                                       (64, 12, 50, 64), (3, 4, 10, 8), (2, 3, 100, 100)])
def test_f32_designs_meet_the_gate(cuda_device, monkeypatch, B, nh, S, hd, rate, impl):
    """Both f32 designs of the shape's route (`_TILED_IMPL` beyond S = 128,
    `_BLOCK_IMPL` up to it; 0: six bf16 term products on wgmma at every hd,
    on columns zero-padded to 64 or 128, the f32 rows read 16 bytes a load
    where hd % 4 == 0 and 4 at hd = 33; 1: f32 FMAs) against the plain
    versions within 1e-5 + 1e-5 |ref|: the forward, and the backward (on the
    tiled route from the training forward's statistics, the standalone
    backward the same bits); two launches the same bits."""
    q, k, v, g, bias = _short_inputs(B, nh, S, hd, torch.float32, S * hd + impl, cuda_device)
    seed = torch.tensor([4242], dtype=torch.int32, device=cuda_device)
    route = "tiled" if S > kshort.MAX_S else "block"
    monkeypatch.setattr(kshort, "_TILED_IMPL" if route == "tiled" else "_BLOCK_IMPL", impl)
    assert kshort.kernel_route(S, hd, torch.float32) == route
    if route == "tiled":
        o, stats, o32 = kshort.short_attention_fwd_train(q, k, v, bias, seed, rate)
        saved = (stats, o32)
        assert o32 is o
    else:
        o, saved = kshort.short_attention_fwd(q, k, v, bias, seed, rate), ()
    grads = kshort.short_attention_bwd(q, k, v, bias, seed, g, rate, *saved)
    assert torch.equal(o, kshort.short_attention_fwd(q, k, v, bias, seed, rate))
    for a, b in zip(grads, kshort.short_attention_bwd(q, k, v, bias, seed, g, rate)):
        assert torch.equal(a, b)
    again = kshort.short_attention_bwd(q, k, v, bias, seed, g, rate, *saved)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    want = [kshort.short_attention_fwd_reference(q, k, v, bias, seed, rate),
            *kshort.short_attention_bwd_reference(q, k, v, bias, seed, g, rate)]
    for got, ref in zip((o, *grads), want):
        assert got.dtype == torch.float32
        _close(got, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("q_factor", [4.0, 8.0])
@pytest.mark.parametrize("B,nh,S,hd", [(4, 12, 514, 64), (2, 2, 514, 128), (2, 3, 300, 36),
                                       (64, 12, 50, 64)])
def test_f32_designs_hold_float64_on_peaked_scores(cuda_device, B, nh, S, hd, q_factor, rate):
    """Both f32 designs of the shape's route (tiled beyond S = 128, one block
    per (b, h) up to it) with q times 4 and 8 (scores of that spread, a
    peaked softmax): o, dq, dk and dv lie from the float64 evaluation of the
    function (its scores in float64 from the f32 q * scale) within
    PEAKED_TIMES the plain version's (cuBLAS f32) distance
    (`chip_smoke.peaked_check`, which raises past it).  Summing the scores'
    products in the tensor cores' truncating f32 accumulators would drift
    with |s|."""
    q, k, v, g, bias = _short_inputs(B, nh, S, hd, torch.float32, S * hd + 5, cuda_device)
    seed = torch.tensor([77], dtype=torch.int32, device=cuda_device)
    out = peaked_check(kshort, (q, k, v, bias, seed, g), q_factor, rate)
    for design in out.values():
        if isinstance(design, dict):
            far = design["from_float64"]
            assert all(ours <= PEAKED_TIMES * plain for ours, plain in far.values()), far


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nh,S,hd", [(3, 2, 200, 64), (2, 2, 257, 128), (2, 3, 200, 100)])
def test_tiled_kernels_take_a_batch_item_whose_keys_are_all_masked(cuda_device, B, nh, S, hd,
                                                                     dtype):
    """A batch item with every key masked (bias -1e9, as a padded row of a
    batch gets): every score of its rows is the same -1e9, and its softmax is
    uniform over the keys; the tiled kernels against the plain versions at
    the gates, forward and the backward from the saved statistics."""
    q, k, v, g, bias = _short_inputs(B, nh, S, hd, dtype, S + hd + 2, cuda_device)
    bias[1] = -1e9
    seed = torch.tensor([3], dtype=torch.int32, device=cuda_device)
    o, stats, o32 = kshort.short_attention_fwd_train(q, k, v, bias, seed, 0.1)
    grads = kshort.short_attention_bwd(q, k, v, bias, seed, g, 0.1, stats, o32)
    want = [kshort.short_attention_fwd_reference(q, k, v, bias, seed, 0.1),
            *kshort.short_attention_bwd_reference(q, k, v, bias, seed, g, 0.1)]
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-6, 2.0 ** -7)
    for got, ref in zip((o, *grads), want):
        _close(got, ref, *tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nh,S,hd", MASKED_ITEM_SHAPES)
@pytest.mark.parametrize("reach", MASKED_REACH)
def test_kernels_take_an_all_masked_item_whose_scores_reach_32(cuda_device, B, nh, S, hd, dtype,
                                                                 reach):
    """The all-masked item of the test above with its q scaled so that the
    largest |s scale| of its rows is `reach` (>= 32): s scale - 1e9 then
    rounds to a multiple of 64 away from -1e9, so its softmax is no longer
    uniform but one-hot on the keys whose rounded scores tie at the row max.
    The tiled kernels (both bf16 designs: hd = 64 on wgmma, 100 on mma.sync)
    and the block kernels (S = 50 and 100; in f32 one and two warpgroups)
    against the float64 evaluation of their function, within the gate plus
    the plain version's own error (`chip_smoke.masked_item_case`: with p
    one-hot, ds cancels to a few ulps of dp in any f32 order of summation)."""
    q, k, _, _, _ = masked_item_inputs(B, nh, S, hd, dtype, reach, cuda_device)
    s1 = torch.einsum("hqd,hkd->hqk", q[1].float(), k[1].float()) / hd ** 0.5
    assert s1.abs().max() >= 32.0
    masked_item_case(kshort, B, nh, S, hd, dtype, reach, cuda_device)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tiled_autograd_at_the_long_shape_meets_the_gate(cuda_device, rate):
    """`short_attention` through autograd at (4, 12, 514, 64) bf16 (the
    training forward, its statistics saved, the backward from them) against
    the plain forward and backward: one bf16 ulp plus 1e-6."""
    q, k, v, g, bias = _short_inputs(4, 12, 514, 64, torch.bfloat16, 17, cuda_device)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = kshort.launch_count("short_attn_tiled_fwd"), kshort.launch_count("short_attn_tiled_bwd")
    o = kshort.short_attention(*leaves, bias, seed, rate)
    grads = torch.autograd.grad(o, leaves, g)
    assert (kshort.launch_count("short_attn_tiled_fwd"),
            kshort.launch_count("short_attn_tiled_bwd")) == (before[0] + 1, before[1] + 1)
    want = [kshort.short_attention_fwd_reference(q, k, v, bias, seed, rate),
            *kshort.short_attention_bwd_reference(q, k, v, bias, seed, g, rate)]
    for got, ref in zip((o.detach(), *grads), want):
        assert got.dtype == torch.bfloat16
        _close(got, ref, 1e-6, 2.0 ** -7)


@pytest.mark.parametrize("S", [21, 150])
def test_short_attention_autograd_on_the_card_matches_the_cpu(cuda_device, S):
    cpu = _short_inputs(3, 4, S, 16, torch.float32, seed=1, device="cpu")

    def run(dev):
        q, k, v, g, bias = (t.to(dev) for t in cpu)
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        s = torch.tensor([9], dtype=torch.int32, device=dev)
        o = kshort.short_attention(*leaves, bias, s, 0.2)
        return [t.detach().cpu() for t in (o, *torch.autograd.grad(o, leaves, g))]

    for a, b_ in zip(steady_on_cpu(lambda: run("cpu")), run(cuda_device)):
        _close(b_, a, 1e-5, 1e-5)


def test_short_attention_kernels_reject_what_they_do_not_take(cuda_device):
    q, k, v, g, bias = _short_inputs(2, 2, 9, 16, torch.float32, seed=0, device=cuda_device)
    with pytest.raises(ValueError):
        kshort.short_attention_fwd(q, k.cpu(), v, bias, None)
    with pytest.raises(ValueError):                         # the seed on the CPU
        kshort.short_attention_fwd(q, k, v, bias, torch.tensor([1], dtype=torch.int32), 0.1)
    wide = _short_inputs(1, 2, 130, 136, torch.float32, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="hd <= 128"):
        kshort.short_attention_fwd(*wide[:3], wide[4], None)


def test_attention_kernels_agree_on_a_fresh_process_first_call(cuda_device):
    """`chip_smoke.py --first-calls` in three fresh processes: each attention
    kernel's first launch in a process agrees every time (the f32 flash path
    through autograd equal bit for bit to its second launch and within
    1e-5 + 1e-4 |ref| of the CPU's steady result; the bf16 flash kernels and
    both instantiations of the two short kernels against their plain
    versions)."""
    for _ in range(3):
        run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--first-calls"],
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
        assert "[first-calls]" in run.stdout


# ------------------------------------------- multi-direction LSTM (rows 19-20)


def _multi_inputs(T, B, hs, seed, device):
    """Per direction: x_proj, w_hh_t, mask (its own lengths), incoming
    gradients dys and dh_fin; reverse flags alternate."""
    dirs = [_inputs(T, B, H, seed + d, device) for d, H in enumerate(hs)]
    grads = [_grads(T, B, H, seed + d, device)[:2] for d, H in enumerate(hs)]
    return ([d[0] for d in dirs], [d[1] for d in dirs], [d[2] for d in dirs],
            [bool(d % 2) for d in range(len(hs))], [g[0] for g in grads], [g[1] for g in grads])


def _multi_run(T, B, hs, device):
    """One launch of each multi kernel for all directions, their inputs,
    and the single-direction kernels' outputs on the same operands."""
    x, w, m, rev, dys, dh = _multi_inputs(T, B, hs, T, device)
    before = [kmulti.launch_count(n) for n in kmulti.SOURCES]
    ys, cs, h_fin = kmulti.lstm_multi_recurrence(x, w, m, rev, need_cs=True)
    dx, dw = kmulti.lstm_multi_recurrence_bwd(x, w, m, rev, ys, cs, dys, dh)
    assert [kmulti.launch_count(n) for n in kmulti.SOURCES] == [b + 1 for b in before]
    single = [klstm.lstm_recurrence(x[d], w[d], m[d], rev[d], need_cs=True)[:3]
              + klstm.lstm_recurrence_bwd(x[d], w[d], m[d], ys[d], cs[d], dys[d], dh[d],
                                          None, rev[d]) for d in range(len(hs))]
    return (x, w, m, rev, dys, dh), (ys, cs, h_fin, dx, dw), single


MULTI_CASES = [(48, 64, (35, 35, 74, 74)), (512, 32, (35, 35, 74, 74)), (7, 5, (33, 3, 9)),
               (16, 64, (300, 74)), (24, 40, (35, 74, 300, 35))]


@pytest.mark.parametrize("T,B,hs", MULTI_CASES)
def test_multi_lstm_kernels_match_plain_versions(cuda_device, T, B, hs):
    """One launch of each kernel for all directions (H = 35, 74 and 300 in
    one launch reach the serial passes' instantiations 11, 21 and 0) against
    `lstm.py`'s plain versions per direction (1e-5 abs/rel), and against the
    single-direction kernels (`lstm_fwd`, `lstm_bwd`), whose passes every
    direction runs: ys, cs, h_fin and dx_proj bit for bit, dw_hh_t too where
    its runs of rows are the same (else 1e-5 abs/rel)."""
    (x, w, m, rev, dys, dh), got, single = _multi_run(T, B, hs, cuda_device)
    want_ys, want_cs, want_h = kmulti.lstm_multi_recurrence_reference(x, w, m, rev, True)
    want_dx, want_dw = kmulti.lstm_multi_recurrence_bwd_reference(x, w, m, rev, want_ys,
                                                                  want_cs, dys, dh)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits = kmulti.dw_splits(T, B, hs, n_sm)
    for d, H in enumerate(hs):
        for name, g, ref, one in zip(("ys", "cs", "h_fin", "dx_proj", "dw_hh_t"),
                                     [o[d] for o in got],
                                     (want_ys[d], want_cs[d], want_h[d], want_dx[d], want_dw[d]),
                                     single[d]):
            torch.testing.assert_close(g, ref, **TOL)
            if name != "dw_hh_t" or splits[d] == klstm.bwd_dw_splits(T, B, H, n_sm):
                assert torch.equal(g, one), f"{name}[{d}] differs from the single kernel's"
            else:
                torch.testing.assert_close(g, one, **TOL)


@pytest.mark.parametrize("T,B,hs", MULTI_CASES[:2] + MULTI_CASES[-1:])
def test_multi_lstm_kernels_give_the_same_bits_twice(cuda_device, T, B, hs):
    _, first, _ = _multi_run(T, B, hs, cuda_device)
    _, again, _ = _multi_run(T, B, hs, cuda_device)
    for a, b_ in zip(first, again):
        for d in range(len(hs)):
            assert torch.equal(a[d], b_[d])


def test_multi_lstm_scan_gradients_on_the_card_match_the_cpu(cuda_device):
    cpu = _multi_inputs(9, 6, (5, 5, 9, 9), 3, "cpu")

    def run(dev):
        x, w, m, rev, dys, dh = ([t.to(dev) for t in part] if part and torch.is_tensor(part[0])
                                 else part for part in cpu)
        leaves = [t.clone().requires_grad_(True) for t in x + w]
        ys, h = kmulti.lstm_scan_multi(leaves[:4], leaves[4:], m, rev)
        grads = torch.autograd.grad(ys + h, leaves, dys + dh)
        return [t.detach().cpu() for t in ys + h + list(grads)]

    for a, b_ in zip(steady_on_cpu(lambda: run("cpu")), run(cuda_device)):
        torch.testing.assert_close(b_, a, **TOL)


def test_multi_lstm_kernels_reject_cpu_mixed_inputs(cuda_device):
    x, w, m, rev, _, _ = _multi_inputs(4, 3, (5, 7), 0, cuda_device)
    with pytest.raises(ValueError):
        kmulti.lstm_multi_recurrence(x, [w[0].cpu(), w[1]], m, rev)
    with pytest.raises(ValueError):
        kmulti.lstm_multi_recurrence(x * 5, w * 5, m * 5, rev * 5)
    wide = _multi_inputs(4, 3, (481, 7), 0, cuda_device)       # more than 4 units a quad
    with pytest.raises(ValueError):
        kmulti.lstm_multi_recurrence(*wide[:4])


# ------------------------------------- captured steps and calls (CUDA graphs)

SMALL_MODEL = dict(use_bert=True, data="mosei", hidden_size=16, embedding_size=8,
                   batch_size=8, max_seq_len=8, bucket_sizes=(8,), compute_dtype="bfloat16",
                   n_epoch=1, seed=1)
TOWERS = {"lstm_fwd": 8, "lstm_bwd": 8}          # 2 towers x 2 layers x 2 directions
CAPTURED_PATHS = {                               # options, launches per step (tiny BERT: 2 layers)
    "dense": (dict(attn_impl="xla"), TOWERS),
    "fused": (dict(attn_impl="fused"), {**TOWERS, "short_attn_fwd": 2, "short_attn_bwd": 2}),
    "flash": (dict(attn_impl="flash"),
              {**TOWERS, "flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}),
    "gru+fused_ln": (dict(attn_impl="xla", rnncell="gru", fused_ln_dropout=True),
                     {"gru_fwd": 8, "gru_bwd": 8, "ln_dropout_fwd": 4, "ln_dropout_bwd": 4}),
}


def _small_trainer(tmp_path, **options):
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.data.synthetic import make_dataset
    from mmda_tpu_torch.models.bert import BertConfig
    from mmda_tpu_torch.train.loop import Trainer

    aligned = options.pop("aligned", True)
    cfg = Config(device="cuda", ckpt_dir=str(tmp_path), name="graphs",
                 **{**SMALL_MODEL, **options})
    data = make_dataset(48, 16, 16, max_len=8, bert_vocab_size=128, aligned=aligned)
    return Trainer(cfg, data, bert_cfg=BertConfig.tiny())


@pytest.mark.parametrize("path", sorted(CAPTURED_PATHS))
def test_captured_steps_equal_eager_steps_bit_for_bit(cuda_device, tmp_path, path):
    """`chip_smoke.captured_steps` at a small width, dropout on: three eager
    steps from one state twice, and three replays of the training graph
    from that state, give the same bits (losses, grad_norm, parameters,
    moments); each replay counts the step's launches; a warm eager step and
    a replay read nothing back to the host."""
    from chip_smoke import captured_steps
    from mmda_tpu_torch.ops.kernels import _launch

    options, per_step = CAPTURED_PATHS[path]
    trainer = _small_trainer(tmp_path, **options)
    out = captured_steps(trainer, _launch, path, cuda_device, per_step=per_step, timed=2)
    assert out["eager_twice_diffs"] == {} and out["captured_diffs"] == {}
    assert out["launches_per_replay"] == per_step and out["sync_free"]


def test_replay_after_set_learning_rate_uses_the_new_rate(cuda_device, tmp_path):
    """Plateau: a new rate set between replays reaches the next replay with
    no recapture (the same graph), and that replay equals an eager step at
    the new rate from the same state, bit for bit; each replay adds its
    launches to the counts."""
    from chip_smoke import bit_diffs, restore_train_state, train_state
    from mmda_tpu_torch.data.loader import to_device
    from mmda_tpu_torch.ops.kernels import _launch
    from mmda_tpu_torch.train.step import make_train_graph, train_step

    trainer = _small_trainer(tmp_path, lr_schedule="plateau", learning_rate=1e-3)
    hosts = list(trainer._loader("train", shuffle=False).host_batches())
    graphs = make_train_graph(trainer.model, trainer.optimizer, trainer.cfg, cuda_device,
                              trainer.generator, trainer.ema, trainer.pool)
    graphs(hosts[0])                                 # eager, then captured
    graphs(hosts[1])
    (graph, _, recorded), = graphs.graphs.values()
    trainer.optimizer.set_learning_rate(3e-2)
    snap = train_state(trainer)
    before = _launch.launch_count("lstm_bwd")
    got = {k: v.clone() for k, v in graphs(hosts[2]).items()}
    assert _launch.launch_count("lstm_bwd") == before + recorded["lstm_bwd"] == before + 8
    assert list(graphs.graphs.values())[0][0] is graph and len(graphs.graphs) == 1
    got.update(train_state(trainer)["tensors"])
    restore_train_state(trainer, snap)
    want = train_step(trainer.model, trainer.optimizer, to_device(hosts[2], cuda_device),
                      trainer.cfg, trainer.generator, trainer.ema)
    want = {**{k: v.clone() for k, v in want.items()}, **train_state(trainer)["tensors"]}
    assert bit_diffs(want, got) == {}
    assert trainer.optimizer.scalars[0].item() == pytest.approx(-3e-2)


def test_captured_predictor_equals_the_eager_call_per_bucket(cuda_device):
    """A Predictor on the card captures each bucket at its first call; later
    calls replay it and count its 8 `lstm_fwd` launches; at each bucket, a
    full batch and one request, the replay's four outputs equal an eager call
    through the same kernel (`recurrence=`) bit for bit."""
    from chip_smoke import make_requests, serve_captured_vs_eager
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.models import init_misa
    from mmda_tpu_torch.models.bert import BertConfig
    from mmda_tpu_torch.ops.kernels import _launch
    from mmda_tpu_torch.serving import Predictor

    cfg = Config(device="cuda", use_bert=True, hidden_size=16, bucket_sizes=(4, 8),
                 max_seq_len=8, visual_size=5, acoustic_size=7, vocab_size=40)
    model = init_misa(cfg, seed=0, bert_cfg=BertConfig.tiny(vocab_size=30522))
    pred = Predictor(cfg, params=model, max_batch=6)
    for b in cfg.bucket_sizes:
        reqs = make_requests([b] * 3, cfg, seed=b)
        pred(reqs)                                   # eager, then captured
        _launch.reset_launch_count()
        pred(reqs)
        assert _launch.launch_count("lstm_fwd") == 8
    assert len(pred._graphs.graphs) == 2
    out = serve_captured_vs_eager(cfg, pred, klstm.lstm_recurrence, cuda_device)
    assert out["bit_equal_at"] == [[4, 6], [4, 1], [8, 6], [8, 1]]
    assert len(out["captured"]) == len(out["eager"]) == 4
    assert len(pred._graphs.graphs) == 2


def test_a_capture_that_fails_raises(cuda_device):
    """A body that reads back to the host cannot be captured: its first call
    runs the warm-up, then the capture raises (no eager fallback), and so
    does the next call; the launch recording is closed and the card still
    runs."""
    from mmda_tpu_torch.ops.kernels import _launch
    from mmda_tpu_torch.train.step import StepGraphs

    host = {"lengths": np.arange(1, 5, dtype=np.int32), "text": np.zeros((4, 3), np.int32)}
    graphs = StepGraphs(lambda b: {"n": b.lengths.sum() * b.lengths.float().max().item()},
                        cuda_device)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            graphs(host)
        assert not graphs.graphs and _launch._recorded is None
    assert (torch.ones(3, device=cuda_device) * 2).sum().item() == 6.0


# ------------------------- accumulation, resume, ConfidNet stage 2 on the card


def test_accumulating_replays_equal_eager_mini_steps(cuda_device, tmp_path):
    """grad_accum_steps=2 at a small width: four eager mini-steps from one
    state, then the training graph's two graphs for the shape (accumulate;
    accumulate and apply), warmed and captured, replayed four times from
    that state: the same bits (losses, grad_norm, parameters, moments,
    accumulators), count 2 and mini-step 0 after both."""
    from chip_smoke import bit_diffs, restore_train_state, train_state
    from mmda_tpu_torch.data.loader import to_device
    from mmda_tpu_torch.train.step import make_train_graph, train_step

    trainer = _small_trainer(tmp_path, grad_accum_steps=2, attn_impl="xla")
    hosts = list(trainer._loader("train", shuffle=False).host_batches())[:4]
    snap = train_state(trainer)

    def four(step):
        restore_train_state(trainer, snap)
        out = {f"{i} {k}": v.clone() for i, h in enumerate(hosts) for k, v in step(h).items()}
        state = train_state(trainer)
        assert (state["count"], state["mini_step"]) == (2, 0)
        return {**out, **state["tensors"]}

    eager = four(lambda h: train_step(trainer.model, trainer.optimizer,
                                      to_device(h, cuda_device), trainer.cfg,
                                      trainer.generator, trainer.ema))
    graphs = make_train_graph(trainer.model, trainer.optimizer, trainer.cfg, cuda_device,
                              trainer.generator, trainer.ema, trainer.pool)
    restore_train_state(trainer, snap)
    graphs(hosts[0])
    graphs(hosts[1])
    assert sorted(emit for _, emit in graphs.graphs) == [False, True]
    assert all(rec == {**{k: 0 for k in rec}, **TOWERS} for _, _, rec in graphs.graphs.values())
    assert bit_diffs(eager, four(graphs)) == {}


def test_resumed_state_equals_its_snapshot(cuda_device, tmp_path):
    """A compiled-epoch run writes `last_*` (incremental: tiny BERT under the
    freeze rule); a `Trainer(resume=True)` on the card holds its parameters,
    moments, count and generator state bit for bit, and one step from each
    on the same batch gives the same bits."""
    from chip_smoke import bit_diffs, same_state, train_state
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.data.loader import to_device
    from mmda_tpu_torch.data.synthetic import make_dataset
    from mmda_tpu_torch.models.bert import BertConfig
    from mmda_tpu_torch.train import checkpoint as ckpt
    from mmda_tpu_torch.train.loop import Trainer
    from mmda_tpu_torch.train.step import train_step

    trainer = _small_trainer(tmp_path, compiled_epoch=True)
    trainer.train()
    assert ckpt.incremental_checkpoint_exists(str(tmp_path), "last_graphs")
    cfg = Config(device="cuda", ckpt_dir=str(tmp_path), name="graphs", resume=True,
                 compiled_epoch=True, **SMALL_MODEL)
    data = make_dataset(48, 16, 16, max_len=8, bert_vocab_size=128)
    resumed = Trainer(cfg, data, bert_cfg=BertConfig.tiny())
    same_state(train_state(trainer), train_state(resumed), "resumed")
    host = next(trainer._loader("dev", shuffle=False).host_batches())
    outs = []
    for t in (trainer, resumed):
        out = train_step(t.model, t.optimizer, to_device(host, cuda_device), t.cfg,
                         t.generator, t.ema)
        outs.append({**{k: v.clone() for k, v in out.items()}, **train_state(t)["tensors"]})
    assert bit_diffs(*outs) == {}


def test_confidnet_stage2_launches_no_lstm_backward(cuda_device, tmp_path):
    """Two-stage ConfidNet on the card: stage 2 (the confidence head alone)
    launches `lstm_fwd` 8 times a step and `lstm_bwd` never, and changes
    only the `confidence` leaves of the best export."""
    from mmda_tpu_torch.convert import flatten_tree
    from mmda_tpu_torch.ops.kernels import _launch
    from mmda_tpu_torch.train import checkpoint as ckpt

    trainer = _small_trainer(tmp_path, use_confidNet=True, fix_conf_loss=True,
                             confid_two_stage=True, n_epoch_stage2=1, attn_impl="xla")
    name = ckpt.best_model_name(trainer.cfg)
    real, seen = trainer._train_confidnet_stage2, {}

    def watched(loader):
        seen["stage1"] = ckpt.load_checkpoint(str(tmp_path), name)
        seen["steps"] = len(loader)
        _launch.reset_launch_count()
        real(loader)
        seen["launches"] = {k: _launch.launch_count(k) for k in ("lstm_fwd", "lstm_bwd")}

    trainer._train_confidnet_stage2 = watched
    trainer.train()
    assert seen["launches"] == {"lstm_fwd": 8 * seen["steps"], "lstm_bwd": 0}
    before = flatten_tree(seen["stage1"])
    after = flatten_tree(ckpt.load_checkpoint(str(tmp_path), name))
    changed = sorted(k for k in before if not torch.equal(before[k], after[k]))
    assert changed == ["confidence.bias", "confidence.kernel"]


# ------------------------------------------------------- the zoo, int8 serving

ZOO_PATHS = {                                    # options, launches per step (tiny BERT)
    "EF_LSTM": (dict(model="EF_LSTM", use_bert=False), {"lstm_fwd": 4, "lstm_bwd": 4}),
    "LF_DNN": (dict(model="LF_DNN", attn_impl="fused"),
               {"short_attn_fwd": 2, "short_attn_bwd": 2}),
    "LMF": (dict(model="LMF", attn_impl="fused"), {"short_attn_fwd": 2, "short_attn_bwd": 2}),
    "TFN": (dict(model="TFN", attn_impl="fused", fused_ln_dropout=True),
            {"short_attn_fwd": 2, "short_attn_bwd": 2, "ln_dropout_fwd": 4,
             "ln_dropout_bwd": 4}),
    # the rest of the zoo; "aligned" picks the synthetic splits (False:
    # visual and acoustic over their own 2T and 3T steps)
    "MULT": (dict(model="MULT", attn_impl="fused"), {"short_attn_fwd": 2, "short_attn_bwd": 2}),
    "MULT_unaligned": (dict(model="MULT", attn_impl="fused", aligned=False),
                       {"short_attn_fwd": 2, "short_attn_bwd": 2}),
    "MAG_BERT": (dict(model="MAG_BERT", attn_impl="fused", fused_ln_dropout=True,
                      mag_inject_layer=1),
                 {"short_attn_fwd": 2, "short_attn_bwd": 2, "ln_dropout_fwd": 4,
                  "ln_dropout_bwd": 4}),
    "MMIM": (dict(model="MMIM", attn_impl="fused"),
             {**TOWERS, "short_attn_fwd": 2, "short_attn_bwd": 2}),
    # MISA with a Switch MoE in both tiny BERT layers (two experts)
    "MoE": (dict(attn_impl="fused", moe_experts=2),
            {**TOWERS, "short_attn_fwd": 2, "short_attn_bwd": 2}),
}


@pytest.mark.parametrize("family", sorted(ZOO_PATHS))
def test_zoo_captured_steps_equal_eager_steps_bit_for_bit(cuda_device, tmp_path, family):
    """`chip_smoke.captured_steps` for each zoo family at a small width:
    eager steps twice and replays from one state give the same bits, and a
    replay counts the family's launches."""
    from chip_smoke import captured_steps
    from mmda_tpu_torch.ops.kernels import _launch

    options, per_step = ZOO_PATHS[family]
    trainer = _small_trainer(tmp_path, **options)
    out = captured_steps(trainer, _launch, family, cuda_device, per_step=per_step, timed=2)
    assert out["eager_twice_diffs"] == {} and out["captured_diffs"] == {}
    assert out["launches_per_replay"] == per_step and out["sync_free"]


@pytest.mark.parametrize("family", sorted(ZOO_PATHS))
def test_zoo_gradients_on_the_card_match_the_cpu(cuda_device, family):
    """`chip_smoke.train_card_vs_cpu` for the family: a small f32 model's
    step gradients through the kernels against the CPU's plain versions,
    within 1e-4."""
    from chip_smoke import DEVICE_TOL, train_card_vs_cpu

    options = {k: v for k, v in ZOO_PATHS[family][0].items() if k != "fused_ln_dropout"}
    assert train_card_vs_cpu(cuda_device, **options) <= DEVICE_TOL


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_int8_predictor_on_the_card(cuda_device, attn_impl):
    """Int8 BERT weights on the card: the small f32 model's outputs against
    the CPU's (1e-4, `chip_smoke.card_vs_cpu`), and each bucket's replay
    equal to an eager call bit for bit, 8 `lstm_fwd` a call (and with the
    fused attention 2 `short_attn_fwd`, one a layer)."""
    from chip_smoke import DEVICE_TOL, card_vs_cpu, make_requests, serve_captured_vs_eager
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.models import init_misa
    from mmda_tpu_torch.models.bert import BertConfig, QuantizedDense
    from mmda_tpu_torch.ops.kernels import _launch
    from mmda_tpu_torch.serving import Predictor

    assert card_vs_cpu(cuda_device, bert_weights_dtype="int8") <= DEVICE_TOL
    cfg = Config(device="cuda", use_bert=True, hidden_size=16, bucket_sizes=(4, 8),
                 max_seq_len=8, visual_size=5, acoustic_size=7, vocab_size=40,
                 attn_impl=attn_impl)
    model = init_misa(cfg, seed=0, bert_cfg=BertConfig.tiny(vocab_size=30522))
    pred = Predictor(cfg, params=model, max_batch=6, bert_weights_dtype="int8")
    assert isinstance(pred.model.bert.layers[0].q, QuantizedDense)
    reqs = make_requests([4] * 3, cfg, seed=4)
    pred(reqs)
    _launch.reset_launch_count()
    pred(reqs)
    assert _launch.launch_count("lstm_fwd") == 8
    assert _launch.launch_count("short_attn_fwd") == (2 if attn_impl == "fused" else 0)
    out = serve_captured_vs_eager(cfg, pred, klstm.lstm_recurrence, cuda_device)
    assert out["bit_equal_at"] == [[4, 6], [4, 1], [8, 6], [8, 1]]


@pytest.mark.parametrize("d_in,d_out", INT8_DENSES)
def test_int8_dense_bf16_rounds_once_on_the_card(cuda_device, d_in, d_out):
    """The bf16 int8 dense at bert-base's shapes on the card: within one bf16
    ulp + 2^-8 of the CPU's, and at most 1e-3 of its outputs off the float64
    product scaled and rounded once, where a second rounding misses about a
    quarter (`chip_smoke.int8_dense_bf16` raises otherwise)."""
    from chip_smoke import INT8_MISMATCH_TOL, int8_dense_bf16

    out = int8_dense_bf16(cuda_device, d_in, d_out)
    assert out["mismatch_vs_one_rounding"] <= INT8_MISMATCH_TOL


def test_int8_bert_encode_bf16_card_vs_cpu(cuda_device):
    """A two-layer bert-base-width bf16 int8 encoder with the fused attention
    on the card against the CPU, no further apart than the same encoder with
    bf16 weights plus one bf16 ulp (`chip_smoke.int8_encode_bf16`)."""
    from chip_smoke import int8_encode_bf16
    from mmda_tpu_torch.ops.kernels import _launch

    out = int8_encode_bf16(_launch, cuda_device)
    assert out["int8"]["max_abs_err"] <= out["tol"] and out["int8"]["short_attn_fwd"] == 2


# ------------------------------------- the serving kernels as ops; exported artifacts


def _op_args(name, device):
    """Arguments of the `mmda_tpu_torch::name` op at a small width."""
    g = torch.Generator().manual_seed(3)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    seed = torch.tensor([11], dtype=torch.int32, device=device)
    if name == "lstm_recurrence":
        x, w, m = _inputs(12, 16, 35, 1, device)
        return (x, w, m, True, True)
    if name == "gru_recurrence":
        return (rand(12, 16, 3 * 20), rand(20, 3 * 20) / 5, rand(3 * 20),
                (torch.rand(12, 16, generator=g) > 0.2).float().to(device), False)
    if name == "short_attention_fwd":
        q = rand(4, 12, 50, 64, dtype=torch.bfloat16)
        return (q, rand(*q.shape, dtype=q.dtype), rand(*q.shape, dtype=q.dtype),
                rand(4, 50), seed, 0.1)
    q = rand(8, 130, 64, dtype=torch.bfloat16)
    return (q, rand(*q.shape, dtype=q.dtype), rand(*q.shape, dtype=q.dtype), rand(8, 130),
            seed, 0.1)


OP_KERNELS = {"lstm_recurrence": (klstm, "lstm_fwd"), "gru_recurrence": (kgru, "gru_fwd"),
              "short_attention_fwd": (kshort, "short_attn_fwd"),
              "flash_attention_fwd": (kattn, "flash_fwd")}


@pytest.mark.parametrize("name", sorted(OP_KERNELS))
def test_kernel_ops_give_the_wrappers_bits(cuda_device, name):
    """`torch.ops.mmda_tpu_torch.<name>` on CUDA tensors launches the kernel
    once (one count) and gives the bits of the op's implementation called
    directly and of the Python wrapper."""
    from mmda_tpu_torch.ops.kernels import _launch

    module, kernel = OP_KERNELS[name]
    args = _op_args(name, cuda_device)
    _launch.reset_launch_count()
    got = getattr(torch.ops.mmda_tpu_torch, name)(*args)
    assert _launch.launch_count(kernel) == 1
    direct = module._forward(*args)
    wrapper = getattr(module, name)(*args)
    got = got if isinstance(got, tuple) else (got,)
    for g, d, w in zip(got, direct if isinstance(direct, tuple) else (direct,),
                       wrapper if isinstance(wrapper, tuple) else (wrapper,)):
        assert torch.equal(g, d) and torch.equal(g, w)
    assert _launch.launch_count(kernel) == 3


def test_exported_predictor_replays_equal_its_eager_call(cuda_device, tmp_path):
    """A tiny MISA (fused attention) exported on the card: the artifact's
    first call per bucket (eager, then captured) and its replays give the
    same bits, equal to the live Predictor's (the same kernels), and a
    replay counts 8 `lstm_fwd` + 2 `short_attn_fwd`; the artifact refuses
    the CPU."""
    from chip_smoke import make_requests
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.models import init_misa
    from mmda_tpu_torch.models.bert import BertConfig
    from mmda_tpu_torch.ops.kernels import _launch
    from mmda_tpu_torch.serving import Predictor
    from mmda_tpu_torch.serving_export import ExportedPredictor, export_model

    cfg = Config(device="cuda", use_bert=True, hidden_size=16, bucket_sizes=(4, 8),
                 max_seq_len=8, visual_size=5, acoustic_size=7, vocab_size=40,
                 attn_impl="fused")
    bert_cfg = BertConfig.tiny(vocab_size=30522)
    model = init_misa(cfg, seed=0, bert_cfg=bert_cfg)
    export_model(cfg, model, str(tmp_path), bert_cfg=bert_cfg, max_batch=6)
    exported = ExportedPredictor(str(tmp_path))
    live = Predictor(cfg, params=model, bert_cfg=bert_cfg, max_batch=6)
    for b in cfg.bucket_sizes:
        reqs = make_requests([b] * 3, cfg, seed=b)
        first = exported(reqs)
        _launch.reset_launch_count()
        again = exported(reqs)
        assert {k: _launch.launch_count(k) for k in ("lstm_fwd", "short_attn_fwd")} == {
            "lstm_fwd": 8, "short_attn_fwd": 2}
        want = live(reqs)
        for k in want:
            assert np.array_equal(first[k], again[k]) and np.array_equal(again[k], want[k]), k
    with pytest.raises(ValueError, match="exported for cuda"):
        ExportedPredictor(str(tmp_path), device="cpu")
