"""The port's MISA forward (mmda_tpu_torch/models/misa.py) against
`mmda_tpu.models.misa.misa_forward(deterministic=True)`: every MISAOutput
field, on JAX-initialised weights carried across by `convert.py`.

f32: tolerance 1e-4 abs/rel (summation orders through BERT, the towers and
six dense layers).  bf16: 2e-2 abs, because BERT's bf16 roundings of the
two frameworks differ by single units in the last place and the masked mean
and the heads carry them to the outputs.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import misa as jmisa
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import load_jax_params
from mmda_tpu_torch.models import Batch, MISA, MISAOutput, get_model, init_misa, misa_forward
from mmda_tpu_torch.models.bert import BertConfig

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

SIZES = dict(visual_size=5, acoustic_size=7, vocab_size=40)
SMALL = dict(hidden_size=16, embedding_size=6, num_classes=6, **SIZES)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _batch(B=4, T=6, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, 1, 3, 5][:B], np.int32)
    S = T + 2
    bert_mask = (np.arange(S)[None, :] < (lengths + 2)[:, None]).astype(np.int32)
    return dict(
        text=rng.integers(0, 40, size=(B, T)).astype(np.int32),
        visual=rng.normal(size=(B, T, 5)).astype(np.float32),
        acoustic=rng.normal(size=(B, T, 7)).astype(np.float32),
        lengths=lengths,
        bert_ids=(rng.integers(0, 128, size=(B, S)) * bert_mask).astype(np.int32),
        bert_type=np.zeros((B, S), np.int32),
        bert_mask=bert_mask,
        sentiment=np.zeros(B, np.float32),
        emo_label=np.zeros((B, 6), np.float32),
        sample_weight=np.ones(B, np.float32),
    )


def _both(use_bert, use_cmd_sim, dtype, modality_keep=None, seed=0, **extra):
    kw = dict(use_bert=use_bert, use_cmd_sim=use_cmd_sim, compute_dtype=dtype,
              **SMALL, **extra)
    jcfg = JConfig(use_pallas=False, **kw)
    cfg = Config(device="cpu", **kw)
    tiny = BertConfig.tiny() if use_bert else None
    tree = jmisa.init_misa_params(jax.random.PRNGKey(seed), jcfg,
                                  bert_cfg=jbert.BertConfig.tiny() if use_bert else None)
    arrays = _batch(seed=seed)
    mk = None if modality_keep is None else np.asarray(modality_keep, np.float32)
    want = jmisa.misa_forward(
        tree, jcfg, jmisa.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        bert_cfg=jbert.BertConfig.tiny() if use_bert else None, deterministic=True,
        modality_keep=None if mk is None else jnp.asarray(mk))
    model = load_jax_params(MISA(cfg, bert_cfg=tiny), tree).eval()   # deterministic
    batch = Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    for k in ("text", "bert_ids", "bert_type"):
        batch = batch._replace(**{k: getattr(batch, k).long()})
    got = misa_forward(model, batch, None if mk is None else torch.from_numpy(mk))
    return got, want


def _compare(got, want, tol):
    assert isinstance(got, MISAOutput) and got._fields == tuple(jmisa.MISAOutput._fields)
    compared = 0
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)
        compared += 1
    return compared


@pytest.mark.parametrize("use_bert,use_cmd_sim", [(True, True), (False, False)])
def test_every_output_matches_jax_f32(use_bert, use_cmd_sim):
    got, want = _both(use_bert, use_cmd_sim, "float32")
    # 20 tensors always (fusion_attn included); the discriminator adds
    # domain_t/v/a
    assert _compare(got, want, 1e-4) == (20 if use_cmd_sim else 23)


def test_modality_keep_matches_jax():
    keep = [[1, 1, 1], [0, 1, 1], [1, 0, 0], [1, 1, 0]]
    got, want = _both(False, True, "float32", modality_keep=keep, seed=3)
    _compare(got, want, 1e-4)


def test_label_decoder_head_matches_jax():
    got, want = _both(False, True, "float32", seed=2, use_label_decoder=True)
    _compare(got, want, 1e-4)


def test_every_output_matches_jax_bf16():
    got, want = _both(True, True, "bfloat16", seed=1)
    _compare(got, want, 2e-2)


def test_registry_and_seeded_init():
    assert get_model("MISA") is MISA
    with pytest.raises(KeyError):
        get_model("NOPE")
    cfg = Config(device="cpu", use_bert=False, **SMALL)
    a, b = init_misa(cfg, seed=7), init_misa(cfg, seed=7)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    w_hh = a.visual_extractor.rnn1.fwd.w_hh                 # (4H, H), orthogonal
    torch.testing.assert_close(w_hh.t() @ w_hh, torch.eye(5), atol=1e-5, rtol=0)
    assert not torch.equal(init_misa(cfg, seed=8).embed, a.embed)


@pytest.mark.parametrize("attn_impl", ["auto", "xla", "flash", "fused"])
@pytest.mark.parametrize("use_flash_attention", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_resolved_attn_impl_matches_jax(attn_impl, use_flash_attention, training):
    """The rule that picks the attention core, over a grid of sequence
    lengths around both thresholds, and with the default (max_seq_len)."""
    kw = dict(attn_impl=attn_impl, use_flash_attention=use_flash_attention, max_seq_len=300)
    jcfg, cfg = JConfig(**kw), Config(device="cpu", **kw)
    for S in (None, 50, 255, 256, 257, 514, 1024, 1025, 1026, 4098):
        assert (cfg.resolved_attn_impl(training=training, seq_len=S)
                == jcfg.resolved_attn_impl(training=training, seq_len=S)), S
    assert cfg.resolved_attn_impl() == jcfg.resolved_attn_impl()


def test_every_output_matches_jax_with_flash_attention():
    """attn_impl="flash": the model resolves it at the call and hands it to
    the encoder; the JAX side runs its Pallas kernels in interpret mode."""
    from mmda_tpu.ops.pallas import attention as jattn

    jattn.set_force_interpret(True)
    try:
        got, want = _both(True, True, "float32", seed=4, attn_impl="flash")
    finally:
        jattn.set_force_interpret(False)
    assert _compare(got, want, 2e-4) == 20
    dense, _ = _both(True, True, "float32", seed=4)
    assert not torch.equal(dense.orig_t, got.orig_t)         # another core ran


def test_every_output_matches_jax_with_fused_attention():
    """attn_impl="fused": the short-sequence core on both sides, the JAX
    one through its Pallas kernel in interpret mode, at the f32 tolerance of
    test_every_output_matches_jax_f32."""
    from mmda_tpu.ops.pallas import short_attention as jsa

    jsa.set_force_interpret(True)
    try:
        got, want = _both(True, True, "float32", seed=5, attn_impl="fused")
    finally:
        jsa.set_force_interpret(False)
    assert _compare(got, want, 1e-4) == 20


def test_model_resolves_the_attention_core_from_the_batch_length(monkeypatch):
    """auto: flash when training at S >= 256, the dense core in eval()."""
    seen = []
    from mmda_tpu_torch.models import bert as pbert

    encode = pbert.bert_encode
    monkeypatch.setattr(pbert, "bert_encode",
                        lambda *a: seen.append(a[-1]) or encode(*a))
    cfg = Config(device="cpu", use_bert=True, compute_dtype="float32", **SMALL)
    model = init_misa(cfg, seed=0, bert_cfg=BertConfig.tiny())
    arrays = _batch(T=254)
    batch = Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    for k in ("text", "bert_ids", "bert_type"):
        batch = batch._replace(**{k: getattr(batch, k).long()})
    model.train()(batch, generator=torch.Generator().manual_seed(0))
    model.eval()(batch)
    assert seen == ["flash", "xla"]
