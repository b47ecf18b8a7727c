"""The port's CUDA kernels on the card.  Every test here needs an NVIDIA
card (marker `cuda`) and skips without one.  The file imports no JAX, so on
the card, where JAX is not installed, it runs without the repository's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mmda_tpu_torch.ops.kernels import lstm as klstm

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
@pytest.mark.parametrize("T,B,H", [(48, 64, 35), (48, 64, 74), (16, 64, 74),
                                   (48, 64, 300), (7, 5, 33)])
def test_lstm_kernel_matches_plain_version(cuda_device, T, B, H, reverse):
    x, w, m = _inputs(T, B, H, seed=H, device=cuda_device)
    before = klstm.launch_count()
    got = klstm.lstm_recurrence(x, w, m, reverse, need_cs=True)
    assert klstm.launch_count() == before + 1
    want = klstm.lstm_recurrence_reference(x, w, m, reverse, need_cs=True)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL)


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


def test_lstm_scan_gradients_on_the_card_match_the_cpu(cuda_device):
    """LSTMRecurrence through both kernels on the card against the same
    Function on the CPU (plain versions)."""
    cpu = _inputs(16, 9, 20, seed=3, device="cpu")
    outs = {}
    for dev in ("cpu", cuda_device):
        x, w, m = (t.to(dev) for t in cpu)
        x.requires_grad_(True)
        w.requires_grad_(True)
        ys, h = klstm.lstm_scan(x, w, m, reverse=True)
        g = torch.autograd.grad((ys * ys).sum() + h.sum(), [x, w])
        outs[str(dev)] = [t.detach().cpu() for t in (ys, h, *g)]
    for a, b in zip(outs["cpu"], outs[str(cuda_device)]):
        torch.testing.assert_close(a, b, **TOL)


def test_lstm_bwd_kernel_rejects_cpu_mixed_inputs(cuda_device):
    x, w, m = _inputs(4, 3, 5, seed=0, device=cuda_device)
    ys, cs, _, _ = klstm.lstm_recurrence(x, w, m, need_cs=True)
    dys, dh, _ = _grads(4, 3, 5, 0, cuda_device)
    with pytest.raises(ValueError):
        klstm.lstm_recurrence_bwd(x, w, m, ys, cs.cpu(), dys, dh)
