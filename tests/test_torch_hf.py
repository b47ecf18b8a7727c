"""The port's HuggingFace weight loading (mmda_tpu_torch/models/bert.py::
load_hf_weights and utils/safetensors_io.py) on checkpoints written here:

* the safetensors reader against `safetensors.numpy` / `safetensors.torch`
  (F32, F16, BF16, I64, a zero-size tensor and metadata), bit for bit;
* both storage branches (`model.safetensors`, `pytorch_model.bin`), with
  and without the `bert.` prefix: the loaded encoder equals the JAX
  package's `load_hf_weights` tree carried through `convert.py`, bit for bit,
  and HF's (out, in) weights land untransposed;
* the forward against `transformers.BertModel` on the same file (2e-4,
  as tests/test_hf_ingestion.py holds the JAX package);
* the `Trainer` with `bert_model_dir`: the frozen layers keep the file's
  values after training, the trainable ones moved from them;
* the missing directory and a missing tensor raise.
"""

import numpy as np
import pytest
import torch

from mmda_tpu.models import bert as jbert
from mmda_tpu_torch.config import Config
from mmda_tpu_torch.convert import load_jax_params
from mmda_tpu_torch.data import synthetic as psynth
from mmda_tpu_torch.models.bert import (BertConfig, BertEncoder, bert_encode, load_hf_encoder,
                                        load_hf_weights)
from mmda_tpu_torch.train.loop import Trainer
from mmda_tpu_torch.utils import safetensors_io

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)


def _tiny_hf_model(seed=11):
    hf_cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    return transformers.BertModel(hf_cfg).eval()


def _write(model_dir, hf, storage, prefix):
    """The HF model's tensors under `prefix` as `storage`."""
    model_dir.mkdir(parents=True, exist_ok=True)
    sd = {prefix + k: v.detach().clone().contiguous() for k, v in hf.state_dict().items()}
    if storage == "safetensors":
        safetensors_torch.save_file(sd, str(model_dir / "model.safetensors"))
    else:
        torch.save(sd, str(model_dir / "pytorch_model.bin"))
    return sd


def test_reader_matches_safetensors_numpy(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
              "f16": rng.normal(size=(7,)).astype(np.float16),
              "i64": rng.integers(-2 ** 40, 2 ** 40, size=(2, 3, 4)).astype(np.int64),
              "empty": np.zeros((0, 4), np.float32),
              "scalar_like": np.asarray([1.5], np.float32)}
    path = str(tmp_path / "a.safetensors")
    safetensors_numpy.save_file(arrays, path, metadata={"format": "np"})
    got, want = safetensors_io.load_file(path), safetensors_numpy.load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_reader_reads_bf16_as_safetensors_torch(tmp_path):
    t = {"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(1)).bfloat16(),
         "b": torch.arange(5, dtype=torch.int64)}
    path = str(tmp_path / "b.safetensors")
    safetensors_torch.save_file(t, path)
    got, want = safetensors_io.load_file(path), safetensors_torch.load_file(path)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("storage", ["safetensors", "bin"])
@pytest.mark.parametrize("prefix", ["", "bert."])
def test_loaded_encoder_equals_jax_tree_through_convert(tmp_path, storage, prefix):
    hf = _tiny_hf_model()
    sd = _write(tmp_path / "m", hf, storage, prefix)
    got = load_hf_encoder(BertEncoder(BertConfig.tiny()), str(tmp_path / "m"))
    tree = jbert.load_hf_weights(str(tmp_path / "m"), jbert.BertConfig.tiny())
    want = load_jax_params(BertEncoder(BertConfig.tiny()), tree)
    for (n, p), q in zip(got.named_parameters(), want.parameters()):
        assert torch.equal(p, q), n
    # HF's (out, in) dense weight is the port's layout: no transpose
    assert torch.equal(got.layers[1].ffn_in.weight,
                       sd[prefix + "encoder.layer.1.intermediate.dense.weight"])
    assert torch.equal(got.pooler.weight, sd[prefix + "pooler.dense.weight"])


@pytest.mark.parametrize("storage", ["safetensors", "bin"])
def test_forward_matches_transformers(tmp_path, storage):
    hf = _tiny_hf_model()
    hf.save_pretrained(tmp_path / "m", safe_serialization=(storage == "safetensors"))
    enc = load_hf_encoder(BertEncoder(BertConfig.tiny()), str(tmp_path / "m")).eval()
    rng = np.random.default_rng(3)
    B, S = 4, 10
    ids = rng.integers(5, 128, size=(B, S))
    mask = np.ones((B, S), np.int64)
    mask[1, 6:] = 0
    mask[3, 3:] = 0
    ids[mask == 0] = 0
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    types = torch.zeros_like(ids)
    with torch.no_grad():
        ours = bert_encode(enc, ids, mask, types, torch.float32)
        theirs = hf(input_ids=ids, attention_mask=mask, token_type_ids=types).last_hidden_state
    real = mask.bool()
    np.testing.assert_allclose(ours[real].numpy(), theirs[real].numpy(), rtol=2e-4, atol=2e-4)


def test_missing_directory_and_tensor_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="no bert weights"):
        load_hf_weights(str(tmp_path / "nope"), BertConfig.tiny())
    hf = _tiny_hf_model()
    sd = {k: v for k, v in hf.state_dict().items() if "layer.1.output.LayerNorm.bias" not in k}
    (tmp_path / "m").mkdir()
    safetensors_torch.save_file({k: v.contiguous() for k, v in sd.items()},
                                str(tmp_path / "m" / "model.safetensors"))
    with pytest.raises(KeyError, match="encoder.layer.1.output.LayerNorm.bias"):
        load_hf_weights(str(tmp_path / "m"), BertConfig.tiny())


def test_trainer_starts_from_the_file_and_keeps_its_frozen_layers(tmp_path):
    """mosei freeze rule on a tiny BERT (both layers frozen): after an
    epoch every encoder layer still holds the file's tensors, and the
    embeddings, which train, started from the file and moved."""
    hf = _tiny_hf_model(seed=5)
    sd = _write(tmp_path / "hf", hf, "safetensors", "bert.")
    cfg = Config(device="cpu", use_bert=True, data="mosei", hidden_size=16, embedding_size=8,
                 batch_size=32, max_seq_len=8, bucket_sizes=(8,), n_epoch=1,
                 learning_rate=1e-3, ckpt_dir=str(tmp_path / "ck"), name="hf", seed=1,
                 bert_model_dir=str(tmp_path / "hf"))
    data = psynth.make_dataset(96, 32, 32, max_len=8, seed=0, bert_vocab_size=128)
    trainer = Trainer(cfg, data, bert_cfg=BertConfig.tiny())
    word = trainer.model.bert.embeddings.word
    assert torch.equal(word.detach(), sd["bert.embeddings.word_embeddings.weight"])
    trainer.train()
    layers = trainer.model.bert.layers
    assert torch.equal(layers[0].q.weight, sd["bert.encoder.layer.0.attention.self.query.weight"])
    assert torch.equal(layers[1].ffn_ln.bias, sd["bert.encoder.layer.1.output.LayerNorm.bias"])
    for n, p in layers.named_parameters():
        assert not p.requires_grad, n
    assert not torch.equal(word.detach(), sd["bert.embeddings.word_embeddings.weight"])
