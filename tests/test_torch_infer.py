"""The port's scoring CLI (mmda_tpu_torch/cli/infer.py) against
`mmda_tpu.cli.infer` on the same checkpoint, on the CPU.

The port's `cli.train` writes a best-on-dev export on the synthetic data
(GloVe text tower, narrow widths); both packages' `cli.infer` then score the
same split from it.  f32, tolerance 1e-4 abs/rel (summation order through
the towers and the heads); a label may only differ where its score lies
within the tolerance of the threshold.
"""

import numpy as np
import pytest
import torch

from mmda_tpu.cli import infer as jinfer
from mmda_tpu_torch.cli import infer as pinfer
from mmda_tpu_torch.cli import train as ptrain


# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

KEYS = {"scores", "labels", "truths", "tcp", "hidden"}
ARGS = ["--device", "cpu", "--data", "synthetic", "--use_bert", "False", "--hidden_size", "16",
        "--embedding_size", "8", "--max_seq_len", "8", "--batch_size", "48",
        "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("infer"))
    # two training steps of 256 rows (the last --batch_size wins): the
    # checkpoint is what the tests score, not the training
    ptrain.main([*ARGS, "--n_epoch", "1", "--bucket_sizes", "8", "--ckpt_dir", ckpt_dir,
                 "--name", "run", "--batch_size", "256"])
    return ckpt_dir


def _score(module, ckpt_dir, name, *extra):
    metrics = module.main([*ARGS, "--ckpt_dir", ckpt_dir, "--name", name, *extra])
    mode = extra[extra.index("--mode") + 1] if "--mode" in extra else "train"
    with np.load(f"{ckpt_dir}/predictions_{name}_{mode}.npz") as z:
        return metrics, {k: z[k] for k in z.files}


@pytest.mark.parametrize("extra,rows", [
    (("--mode", "test"), 128), (("--mode", "dev", "--missing_modality", "visual"), 128)],
    ids=["test", "dev-missing-visual"])
def test_infer_matches_jax_infer(trained, extra, rows):
    """128 rows in batches of 48: two full batches and a padded one, whose
    pad rows are dropped."""
    metrics, got = _score(pinfer, trained, "port", *extra)
    jmetrics, want = _score(jinfer, trained, "jax", *extra)
    assert set(got) == set(want) == KEYS
    for k in KEYS:
        assert got[k].shape == want[k].shape and got[k].shape[0] == rows, k
    assert got["hidden"].shape == (rows, 6 * 16) and got["scores"].shape == (rows, 6)
    for k in ("scores", "tcp", "hidden"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["truths"], want["truths"])
    clear = np.abs(want["scores"] - 0.5) > 1e-4
    np.testing.assert_array_equal(got["labels"][clear], want["labels"][clear])
    assert set(metrics) == set(jmetrics)
    if clear.all():
        for k in metrics:
            assert metrics[k] == pytest.approx(jmetrics[k], abs=1e-6), k


def test_infer_without_a_checkpoint_says_to_train_first(tmp_path):
    with pytest.raises(FileNotFoundError, match="train first"):
        pinfer.main([*ARGS, "--ckpt_dir", str(tmp_path)])


def test_infer_scores_the_split_named_by_mode(trained):
    """--mode names the split (train, the flag's default, is one: 512 rows in
    file order); a mode that names none (multirun) scores the test split, as
    in the JAX package."""
    from mmda_tpu_torch.data.synthetic import make_dataset

    _, got = _score(pinfer, trained, "default")
    data = make_dataset(num_train=512, num_dev=128, num_test=128, max_len=8)
    np.testing.assert_array_equal(got["truths"], data["train"]["emo_label"])
    _, other = _score(pinfer, trained, "other", "--mode", "multirun")
    _, test = _score(pinfer, trained, "explicit", "--mode", "test")
    np.testing.assert_array_equal(other["scores"], test["scores"])
