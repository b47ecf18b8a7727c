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
