"""The port's masked bi-LSTM towers (mmda_tpu_torch/models/bilstm.py and
extractors.py) against `mmda_tpu.models.bilstm` on weights carried across
by `mmda_tpu_torch.convert`.

On the CPU the port's recurrence is the kernel's plain version.  f32
tolerance 1e-5 abs/rel (summation order only); the bf16-input case 1e-4,
because both sides round the same inputs to bf16 and then compute in f32.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bilstm as jbilstm
from mmda_tpu.models.extractors import make_tower_params, tower_extract
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import load_jax_params
from mmda_tpu_torch.models import bilstm
from mmda_tpu_torch.models.extractors import make_tower, tower_extract as t_tower_extract

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _data(B, T, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = T, 1
    return x, lengths


@pytest.mark.parametrize("B,T,F,H", [(5, 7, 6, 4), (3, 4, 9, 9)])
def test_birnn_matches_jax(B, T, F, H):
    tree = jbilstm.rnn_params(jax.random.PRNGKey(B + F), F, H, "lstm")
    x, lengths = _data(B, T, F, seed=B)
    ys_j, h_j = jbilstm.birnn(tree, jnp.asarray(x), jnp.asarray(lengths), "lstm",
                              training=False)
    p = load_jax_params(bilstm.BiLSTM(F, H), tree)
    ys_t, h_t = bilstm.birnn(p, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-5, atol=1e-5)
    # pads are zero, as pad_packed_sequence leaves them
    mask = np.arange(T)[None, :] < lengths[:, None]
    assert np.all(ys_t.numpy()[~mask] == 0.0)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_extract_features_matches_jax(dtype, tol):
    B, T, F = 6, 8, 5
    tree = jbilstm.extractor_params(jax.random.PRNGKey(3), F, F, "lstm")
    x, lengths = _data(B, T, F, seed=7)
    want = jbilstm.extract_features(tree, jnp.asarray(x).astype(dtype),
                                    jnp.asarray(lengths), "lstm", training=False)
    p = load_jax_params(bilstm.LSTMExtractor(F, F), tree)
    got = bilstm.extract_features(p, torch.from_numpy(x).to(getattr(torch, dtype)),
                                  torch.from_numpy(lengths))
    assert got.shape == (B, 4 * F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_tower_extract_matches_jax():
    """The `lstm` branch of make_tower_params / tower_extract."""
    F = 7
    jcfg = JConfig(hidden_size=16, compute_dtype="float32", use_pallas=False)
    cfg = Config(hidden_size=16, compute_dtype="float32", device="cpu")
    tree = make_tower_params(jax.random.PRNGKey(9), jcfg, F)
    x, lengths = _data(4, 6, F, seed=9)
    want = tower_extract(tree, jcfg, jnp.asarray(x), jnp.asarray(lengths),
                         training=False)
    tower = load_jax_params(make_tower(cfg, F), tree)
    got = t_tower_extract(tower, torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_recurrence_argument_reaches_every_direction():
    """`recurrence` replaces the kernel wrapper in all four directional
    recurrences of a two-layer tower."""
    calls = []

    def spy(x_proj, w_hh_t, mask, reverse):
        calls.append(reverse)
        from mmda_tpu_torch.ops.kernels.lstm import lstm_recurrence_reference
        return lstm_recurrence_reference(x_proj, w_hh_t, mask, reverse)

    tower = bilstm.LSTMExtractor(3, 3)
    tower.reset_parameters(torch.Generator().manual_seed(0))
    x, lengths = _data(2, 4, 3, seed=1)
    tower(torch.from_numpy(x), torch.from_numpy(lengths), spy)
    assert calls == [False, True, False, True]


def test_unported_towers_raise():
    """No tower of the JAX package is left to port: the GRU and the
    transformer towers build (they used to raise) and give the LSTM towers'
    (B, 4F) utterance vector; a cell that does not exist still raises."""
    x, lengths = _data(3, 5, 4, seed=2)
    gen = torch.Generator().manual_seed(0)
    for option in (dict(rnncell="gru"), dict(extractor="transformer")):
        tower = make_tower(Config(device="cpu", **option), 4)
        tower.reset_parameters(gen)
        out = t_tower_extract(tower, torch.from_numpy(x), torch.from_numpy(lengths))
        assert out.shape == (3, 16) and torch.isfinite(out).all()
    with pytest.raises(ValueError):
        make_tower(Config(device="cpu", rnncell="rnn"), 4)
    with pytest.raises(ValueError):
        bilstm.LSTMExtractor(4, 4, cell="rnn")
