"""The rest of the port's zoo (MULT, MAG_BERT, MMIM), BERT's injection hook
and the objective's `model_aux`, against the JAX package on the CPU:

* the parts on their own, at 1e-6: MULT's SAME convolution (widths 1-5)
  and sinusoid table, MAG_BERT's `mag_gate` and `to_token_grid`, MMIM's
  `infonce` and `gaussian_nll` (as tests/test_mag_bert.py and
  tests/test_mmim.py check the JAX ones);
* the deterministic forward on JAX-initialised weights carried across by
  `convert.py` (MULT's 3-D conv kernels included): MULT with a GloVe and a
  tiny-BERT text tower, aligned and unaligned, `mult_conv_kernel` 3 and 4;
  MAG_BERT at `mag_inject_layer` 0, 1 and num_layers; MMIM with GloVe and
  tiny BERT, `extractor` lstm and transformer (and unaligned); with and
  without `modality_keep`: f32 1e-4 abs/rel, bf16 2e-2, as
  tests/test_torch_zoo.py states them;
* MAG_BERT's hook under `attn_impl` "fused" and "flash" (their plain
  versions here) against the JAX xla path at the tolerances of
  tests/test_torch_bert.py (f32: fused 1e-5, flash 2e-4);
* one step's objective and gradients against `jax.grad`: in
  tests/test_torch_zoo_rest_step.py (a file of its own, so that the suite's
  workers share the JAX package's op-by-op compilations); here, the gate's
  gradients in training with `fused_ln_dropout`;
* the `Predictor` over ragged requests against the JAX `Predictor` (1e-4),
  every one of the eight families serving finite scores
  (tests/test_zoo_serving_matrix.py);
* a `Trainer` epoch whose best-on-dev export loads in the JAX package's
  `load_checkpoint`, leaf for leaf, and round-trips through `convert.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmda_tpu.config import Config as JConfig
from mmda_tpu.models import bert as jbert
from mmda_tpu.models import get_model as jget_model
from mmda_tpu.models import misa as jmisa
from mmda_tpu.models import mag_bert as jmag
from mmda_tpu.models import mmim as jmmim
from mmda_tpu.models import mult as jmult
from mmda_tpu.models.common import layer_norm_params, linear_params
from mmda_tpu.serving import Predictor as JPredictor
from mmda_tpu.train import checkpoint as jckpt
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import convert_params, load_jax_params, to_jax_tree
from mmda_tpu_torch.data import synthetic as psynth
from mmda_tpu_torch.models import get_model
from mmda_tpu_torch.models import mag_bert as pmag
from mmda_tpu_torch.models import mmim as pmmim
from mmda_tpu_torch.models import mult as pmult
from mmda_tpu_torch.models.bert import BertConfig, freeze_layers
from mmda_tpu_torch.models.common import Conv1d
from mmda_tpu_torch.serving import Predictor
from mmda_tpu_torch.train import checkpoint as pckpt
from mmda_tpu_torch.train.loop import Trainer
from mmda_tpu_torch.train.step import loss_and_grads
from test_torch_zoo import SMALL, _batch, _close, _port_batch, _req

torch.set_num_threads(1)

MULT_SMALL = dict(mult_d=8, mult_heads=2, mult_layers=2)
# (family, use_bert, extra Config options, aligned); MULT's text tower, conv
# width and alignment pairwise (each pair of values meets once); tiny BERT
# has 2 layers, so inject layer 2 runs after the last one
CASES = (
    [("MULT", b, {"mult_conv_kernel": w}, a)
     for b, w, a in ((False, 3, True), (False, 4, False), (True, 3, False), (True, 4, True))]
    + [("MAG_BERT", True, {"mag_inject_layer": i}, True) for i in (0, 1, 2)]
    + [("MMIM", b, {"extractor": x}, True) for b in (False, True)
       for x in ("lstm", "transformer")]
)


def _case_id(case):
    family, use_bert, extra, aligned = case
    opts = "-".join(f"{k}={v}" for k, v in extra.items())
    return f"{family}-{'bert' if use_bert else 'glove'}-{opts}-" + (
        "aligned" if aligned else "unaligned")


def _arrays(aligned=True, seed=1):
    """tests/test_torch_zoo.py's batch; unaligned, visual and acoustic get
    their own time axes (9 and 11 steps) and lengths."""
    arrays = _batch(seed=seed)
    if not aligned:
        rng = np.random.default_rng(seed + 100)
        for k, (T, D) in (("visual", (9, 5)), ("acoustic", (11, 7))):
            lens = np.array([T, 2, 5, 1], np.int32)
            x = rng.normal(size=(4, T, D)).astype(np.float32)
            x[np.arange(T)[None, :] >= lens[:, None]] = 0.0
            arrays[k], arrays[f"{k}_lengths"] = x, lens
    return arrays


def _jbatch(arrays):
    return jmisa.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _options(family, use_bert, extra, **kw):
    return {**SMALL, **MULT_SMALL, "model": family, "use_bert": use_bert, "data": "mosei",
            **extra, **kw}


def _setup(family, use_bert, extra, seed=0, **kw):
    opts = _options(family, use_bert, extra, **kw)
    jcfg = JConfig(use_pallas=False, **opts)
    cfg = Config(device="cpu", **opts)
    jbert_cfg = jbert.BertConfig.tiny() if use_bert else None
    init_fn, fwd = jget_model(family)
    tree = init_fn(jax.random.PRNGKey(seed), jcfg, bert_cfg=jbert_cfg)
    model = load_jax_params(
        get_model(family)(cfg, bert_cfg=BertConfig.tiny() if use_bert else None), tree)
    return jcfg, cfg, jbert_cfg, tree, fwd, model


# ------------------------------------------------------------------ the parts


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5])
def test_conv1d_matches_jax_same_padding(width):
    rng = np.random.default_rng(width)
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    p = jmult._conv1d_params(jax.random.PRNGKey(width), 5, 4, width)
    want = jmult._conv1d(p, jnp.asarray(x))
    conv = Conv1d(5, 4, width)
    conv.load_state_dict(convert_params({"kernel": p["kernel"]}, conv))
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_sinusoid_matches_jax():
    for T, d in ((1, 2), (50, 8), (144, 40)):
        np.testing.assert_allclose(pmult.sinusoid(T, d).numpy(),
                                   np.asarray(jmult._sinusoid(T, d)), rtol=1e-6, atol=1e-6)


def test_mag_gate_matches_jax():
    B, S, H, dv, da = 2, 5, 8, 3, 4
    rng = np.random.default_rng(0)
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    tree = {"gate_v": linear_params(ks[0], H + dv, H),
            "gate_a": linear_params(ks[1], H + da, H),
            "proj_v": linear_params(ks[2], dv, H), "proj_a": linear_params(ks[3], da, H),
            "ln": layer_norm_params(H)}
    h, v, a = (rng.normal(size=(B, S, n)).astype(np.float32) for n in (H, dv, da))
    gate = load_jax_params(pmag.MAGGate(H, dv, da), tree)
    # alpha below its bound of 1, and held at it; h in f32 and, as the bf16
    # encoder hands it over, in bf16 (the gate computes in f32 either way)
    for beta, h_dtype in ((0.7, jnp.float32), (1e-3, jnp.float32), (50.0, jnp.float32),
                          (0.7, jnp.bfloat16)):
        want = jmag.mag_gate(tree, jnp.asarray(h, h_dtype), jnp.asarray(v), jnp.asarray(a),
                             beta, 0.5, True, None)
        with torch.no_grad():
            got = pmag.mag_gate(gate, torch.from_numpy(h).to(getattr(torch, h_dtype.__name__)),
                                torch.from_numpy(v), torch.from_numpy(a), beta, 0.5, False)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,S", [(6, 5), (3, 8), (4, 5)])
def test_token_grid_matches_jax(T, S):
    B, D = 2, 3
    seq = (np.arange(B * T * D, dtype=np.float32).reshape(B, T, D) + 1.0)
    mask = np.ones((B, S), np.int32)
    mask[1, 3:] = 0
    want = jmag._to_token_grid(jnp.asarray(seq), S, jnp.asarray(mask))
    got = pmag.to_token_grid(torch.from_numpy(seq), S, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_mi_terms_match_jax():
    rng = np.random.default_rng(3)
    h, pred, mu, logvar, x = (rng.normal(size=(7, 5)).astype(np.float32) for _ in range(5))
    t = torch.from_numpy
    np.testing.assert_allclose(float(pmmim.infonce(t(h), t(pred))),
                               float(jmmim.infonce(jnp.asarray(h), jnp.asarray(pred))),
                               rtol=1e-6, atol=1e-6)
    aligned = float(pmmim.infonce(t(h), 4.0 * t(h)))
    assert aligned < np.log(7) < float(pmmim.infonce(t(h), 4.0 * t(h).flip(0)))
    np.testing.assert_allclose(
        float(pmmim.gaussian_nll(t(mu), t(logvar), t(x))),
        float(jmmim.gaussian_nll(jnp.asarray(mu), jnp.asarray(logvar), jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


def test_registry_has_the_eight_families():
    from mmda_tpu.models import _REGISTRY as jregistry
    from mmda_tpu_torch.models import _REGISTRY

    assert sorted(_REGISTRY) == sorted(jregistry)


def test_mag_bert_refuses_glove():
    with pytest.raises(ValueError, match="use_bert=True"):
        get_model("MAG_BERT")(Config(device="cpu", model="MAG_BERT", use_bert=False, **SMALL))


# ------------------------------------------------------------- the forward


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("keep", [None, [[1, 1, 1], [1, 0, 1], [0, 1, 0], [1, 1, 0]]],
                         ids=["all", "keep"])
def test_forward_matches_jax(case, dtype, tol, keep):
    family, use_bert, extra, aligned = case
    jcfg, cfg, jbert_cfg, tree, fwd, model = _setup(family, use_bert, extra,
                                                    compute_dtype=dtype)
    arrays = _arrays(aligned)
    mk = None if keep is None else np.asarray(keep, np.float32)
    want = fwd(tree, jcfg, _jbatch(arrays), bert_cfg=jbert_cfg, deterministic=True,
               modality_keep=None if mk is None else jnp.asarray(mk))
    with torch.no_grad():
        got = model.eval()(_port_batch(arrays), None if mk is None else torch.from_numpy(mk))
    _close(got.scores, want.scores, tol, "scores")
    _close(got.tcp, want.tcp, tol, "tcp")
    near = np.abs(np.asarray(want.scores, np.float32) - cfg.threshold) < tol
    np.testing.assert_array_equal(got.labels.float().numpy()[~near],
                                  np.asarray(want.labels, np.float32)[~near])
    assert got.shared_t is None
    if family == "MMIM":
        assert set(got.model_aux) == set(want.model_aux) == {"total", "nll", "nce"}
        for k in want.model_aux:
            _close(got.model_aux[k], want.model_aux[k], tol, k)
    else:
        assert got.model_aux is None and want.model_aux is None


def test_mult_uses_the_true_last_step():
    """Changing a feature past a sequence's length moves nothing; changing
    its last valid step does."""
    _, _, _, _, _, model = _setup("MULT", False, {})
    arrays = _arrays(False)
    model.eval()
    with torch.no_grad():
        base = model(_port_batch(arrays)).scores
        pad = {**arrays, "visual": arrays["visual"].copy()}
        pad["visual"][1, 2:] = 5.0                     # row 1 has 2 valid steps
        assert torch.equal(model(_port_batch(pad)).scores, base)
        last = {**arrays, "visual": arrays["visual"].copy()}
        last["visual"][1, 1] += 1.0
        assert not torch.equal(model(_port_batch(last)).scores[1], base[1])


@pytest.mark.parametrize("attn_impl,tol", [("fused", 1e-5), ("flash", 2e-4)])
def test_mag_bert_hook_under_kernel_attention(attn_impl, tol):
    """The gate sits between layers, outside the attention core: the port's
    `fused` and `flash` cores (their plain versions on the CPU) give JAX's
    xla-path scores at tests/test_torch_bert.py's tolerances."""
    extra = {"mag_inject_layer": 1, "compute_dtype": "float32"}
    jcfg, _, jbert_cfg, tree, fwd, _ = _setup("MAG_BERT", True, extra, attn_impl="xla")
    _, cfg, _, _, _, model = _setup("MAG_BERT", True, extra, attn_impl=attn_impl)
    assert cfg.resolved_attn_impl(training=False, seq_len=8) == attn_impl
    arrays = _arrays()
    want = fwd(tree, jcfg, _jbatch(arrays), bert_cfg=jbert_cfg, deterministic=True)
    with torch.no_grad():
        got = model.eval()(_port_batch(arrays))
    _close(got.scores, want.scores, tol, "scores")
    _close(got.tcp, want.tcp, tol, "tcp")


def test_inject_hook_rounds_once_and_runs_after_the_last_layer():
    """inject_fn's output is rounded to the compute dtype once; at
    inject_layer >= num_layers it maps the last layer's output, and no hook
    is the plain encoder."""
    from mmda_tpu_torch.models.bert import BertEncoder, bert_encode

    enc = BertEncoder(BertConfig.tiny())
    enc.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(3, 128, (2, 6), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 6, dtype=torch.long)
    seen = []

    def fn(h):
        seen.append(h.dtype)
        return h.float() * 2.0
    with torch.no_grad():
        plain = bert_encode(enc, ids, mask, compute_dtype=torch.bfloat16)
        after = bert_encode(enc, ids, mask, compute_dtype=torch.bfloat16, inject_layer=2,
                            inject_fn=fn)
        mid = bert_encode(enc, ids, mask, compute_dtype=torch.bfloat16, inject_layer=1,
                          inject_fn=fn)
    assert seen == [torch.bfloat16, torch.bfloat16]
    assert after.dtype == mid.dtype == torch.bfloat16
    assert torch.equal(after, (plain.float() * 2.0).bfloat16())
    assert not torch.equal(mid, after)


def test_mag_bert_trains_through_the_hook_with_fused_layernorm():
    """Training with `fused_ln_dropout` (its plain version here) and the
    gate's dropout: the gate gets finite, non-zero gradients."""
    opts = _options("MAG_BERT", True, {}, fused_ln_dropout=True)
    cfg = Config(device="cpu", **opts)
    model = get_model("MAG_BERT")(cfg, bert_cfg=dataclasses.replace(BertConfig.tiny(),
                                                                    fused_ln_dropout=True))
    model.reset_parameters(torch.Generator().manual_seed(0))
    freeze_layers(model.bert, 8)
    model.train()
    gate = list(model.mag.parameters())
    losses, grads = loss_and_grads(model, _port_batch(_arrays()), cfg, gate,
                                   generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(losses["total"])
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().max() > 0


# -------------------------------------------------------------- serving


@pytest.mark.parametrize("case", [c for c in CASES if c[3]], ids=_case_id)
def test_predictor_matches_jax_predictor(case):
    family, use_bert, extra, _ = case
    kw = dict(model=family, use_bert=use_bert, compute_dtype="float32", bucket_sizes=(4, 8),
              max_seq_len=8, data="synthetic", **SMALL, **MULT_SMALL, **extra)
    jbert_cfg = jbert.BertConfig.tiny(vocab_size=64) if use_bert else None
    init_fn, _ = jget_model(family)
    tree = init_fn(jax.random.PRNGKey(0), JConfig(**kw), bert_cfg=jbert_cfg)
    want_pred = JPredictor(JConfig(**kw), params=tree, bert_cfg=jbert_cfg, max_batch=8)
    got_pred = Predictor(Config(device="cpu", **kw), params=tree,
                         bert_cfg=BertConfig.tiny(vocab_size=64) if use_bert else None,
                         max_batch=8)
    rng = np.random.default_rng(11)
    reqs = [_req(rng, L, use_bert) for L in (3, 7, 1)]
    want, got = want_pred(reqs), got_pred(reqs)
    for k in ("scores", "tcp", "hidden"):
        assert got[k].shape == np.asarray(want[k]).shape == (3, 6), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("family", ["MISA", "EF_LSTM", "LF_DNN", "MULT", "LMF", "TFN",
                                    "MAG_BERT", "MMIM"])
def test_every_family_serves_finite_scores(family):
    """tests/test_zoo_serving_matrix.py's contract in the port: every family
    of the registry serves ragged requests with finite scores, at the JAX
    `Predictor`'s values."""
    use_bert = family == "MAG_BERT"
    kw = dict(model=family, use_bert=use_bert, hidden_size=16, num_classes=6,
              visual_size=5, acoustic_size=7, vocab_size=40, embedding_size=6,
              compute_dtype="float32", batch_size=8, bucket_sizes=(4, 8), max_seq_len=8,
              data="synthetic", mult_d=8, mult_heads=2, mult_layers=1)
    jbert_cfg = jbert.BertConfig.tiny(vocab_size=64) if use_bert else None
    init_fn, _ = jget_model(family)
    tree = init_fn(jax.random.PRNGKey(0), JConfig(**kw), bert_cfg=jbert_cfg)
    pred = Predictor(Config(device="cpu", **kw), params=tree,
                     bert_cfg=BertConfig.tiny(vocab_size=64) if use_bert else None,
                     max_batch=8)
    rng = np.random.default_rng(12)
    reqs = [_req(rng, 3, use_bert), _req(rng, 7, use_bert)]
    got = pred(reqs)
    assert got["scores"].shape == (2, 6) and np.isfinite(got["scores"]).all(), family
    want = JPredictor(JConfig(**kw), params=tree, bert_cfg=jbert_cfg, max_batch=8)(reqs)
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), rtol=1e-4,
                               atol=1e-4)


def test_int8_predictor_quantizes_the_gated_bert():
    """`bert_weights_dtype="int8"` acts on `model.bert` of MAG_BERT (the gate
    stays f32) and serves scores near the f32 ones."""
    kw = dict(model="MAG_BERT", use_bert=True, compute_dtype="float32", bucket_sizes=(8,),
              max_seq_len=8, data="synthetic", **SMALL)
    tree = jget_model("MAG_BERT")[0](jax.random.PRNGKey(1), JConfig(**kw),
                                     bert_cfg=jbert.BertConfig.tiny(vocab_size=64))
    preds = {d: Predictor(Config(device="cpu", **kw), params=tree,
                          bert_cfg=BertConfig.tiny(vocab_size=64), max_batch=8,
                          bert_weights_dtype=d) for d in ("int8", None)}
    from mmda_tpu_torch.models.bert import QuantizedDense
    assert isinstance(preds["int8"].model.bert.layers[0].q, QuantizedDense)
    assert preds["int8"].model.mag.gate_v.weight.dtype == torch.float32
    reqs = [_req(np.random.default_rng(2), L, True) for L in (3, 6)]
    a, b = preds["int8"](reqs)["scores"], preds[None](reqs)["scores"]
    assert np.isfinite(a).all() and np.abs(a - b).max() < 2e-2


# -------------------------------------------------------------- the Trainer


@pytest.mark.parametrize("family,use_bert,aligned", [
    ("MULT", False, True), ("MULT", True, False), ("MAG_BERT", True, True),
    ("MMIM", True, True), ("MMIM", False, False)])
def test_trainer_epoch_export_loads_in_jax(tmp_path, family, use_bert, aligned):
    opts = dict(model=family, use_bert=use_bert, data="mosei", hidden_size=16,
                embedding_size=8, **MULT_SMALL)
    cfg = Config(device="cpu", batch_size=32, max_seq_len=8, bucket_sizes=(8,), n_epoch=1,
                 learning_rate=1e-3, ckpt_dir=str(tmp_path), name="zoo", seed=1, **opts)
    data = psynth.make_dataset(96, 32, 32, max_len=8, seed=0, bert_vocab_size=128,
                               aligned=aligned)
    bert_cfg = BertConfig.tiny() if use_bert else None
    trainer = Trainer(cfg, data, bert_cfg=bert_cfg)
    summary = trainer.train()
    assert np.isfinite(summary["test_loss"])
    epoch = summary["history"][0]
    assert (epoch["train_model_aux"] > 0.0) == (family == "MMIM")
    name = pckpt.best_model_name(cfg)
    tree = pckpt.load_checkpoint(str(tmp_path), name)
    init_fn, _ = jget_model(family)
    template = init_fn(jax.random.PRNGKey(0), JConfig(**opts),
                       bert_cfg=jbert.BertConfig.tiny() if use_bert else None,
                       **trainer.sizes)
    loaded = jckpt.load_checkpoint(str(tmp_path), name, template)
    want = to_jax_tree(trainer.model)
    flat = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert len(flat) == len(list(trainer.model.parameters()))
    for path, leaf in flat:
        node = want
        for k in path:
            key = getattr(k, "key", getattr(k, "idx", k))
            node = node[str(key)] if isinstance(node, dict) else node[key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf), err_msg=str(path))
    fresh = get_model(family)(cfg, bert_cfg=bert_cfg, **trainer.sizes)
    state = convert_params(tree, fresh)
    for n, p in trainer.model.named_parameters():
        torch.testing.assert_close(state[n], p.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("family", ["MULT", "MAG_BERT", "MMIM"])
def test_trainer_starts_bert_from_a_hf_checkpoint(tmp_path, family):
    """`bert_model_dir` acts on `model.bert` of each family: the tower
    starts from the file, and under the mosei freeze rule its encoder layers
    still hold the file's tensors after an epoch."""
    from test_torch_hf import _tiny_hf_model, _write

    sd = _write(tmp_path / "hf", _tiny_hf_model(seed=5), "bin", "")
    cfg = Config(device="cpu", model=family, use_bert=True, data="mosei", hidden_size=16,
                 batch_size=32, max_seq_len=8, bucket_sizes=(8,), n_epoch=1, seed=1,
                 ckpt_dir=str(tmp_path / "ck"), name="hf", bert_model_dir=str(tmp_path / "hf"),
                 **MULT_SMALL)
    data = psynth.make_dataset(96, 32, 32, max_len=8, seed=0, bert_vocab_size=128)
    trainer = Trainer(cfg, data, bert_cfg=BertConfig.tiny())
    bert = trainer.model.bert
    assert torch.equal(bert.embeddings.word.detach(), sd["embeddings.word_embeddings.weight"])
    assert np.isfinite(trainer.train()["test_loss"])
    assert torch.equal(bert.layers[1].q.weight, sd["encoder.layer.1.attention.self.query.weight"])
    assert not any(p.requires_grad for p in bert.layers.parameters())


@pytest.mark.parametrize("family", ["MULT", "MMIM"])
def test_cli_train_writes_an_export_jax_loads(tmp_path, family):
    """`cli.train --data synthetic --model F --device cpu` at tiny widths,
    with the GloVe tower (the CLI's BERT tower is bert-base; MAG_BERT, which
    has no other, is trained through the `Trainer` above)."""
    from mmda_tpu_torch.cli import train as cli_train

    summary = cli_train.main([
        "--device", "cpu", "--data", "synthetic", "--model", family, "--use_bert", "False",
        "--hidden_size", "16", "--embedding_size", "8", "--max_seq_len", "8",
        "--bucket_sizes", "8", "--n_epoch", "1", "--batch_size", "64", "--mult_d", "8",
        "--mult_heads", "2", "--mult_layers", "1", "--ckpt_dir", str(tmp_path),
        "--name", "cli", "--log_sinks", "stdout"])
    assert np.isfinite(summary["test_loss"])
    name = f"best_model_{family}_synthetic"
    tree = pckpt.load_checkpoint(str(tmp_path), name)
    jcfg = JConfig(model=family, use_bert=False, hidden_size=16, embedding_size=8,
                   mult_d=8, mult_heads=2, mult_layers=1)
    template = jget_model(family)[0](jax.random.PRNGKey(0), jcfg, visual_size=35,
                                     acoustic_size=74, vocab_size=tree["embed"].shape[0])
    loaded = jckpt.load_checkpoint(str(tmp_path), name, template)
    for (path, leaf), want in zip(jax.tree_util.tree_flatten_with_path(loaded)[0],
                                  jax.tree_util.tree_leaves(template)):
        assert np.asarray(leaf).shape == np.asarray(want).shape, path
