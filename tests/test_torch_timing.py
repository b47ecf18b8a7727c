"""The port's timing and profiling hooks (mmda_tpu_torch/utils/timing.py) and
`cli.train --profile_dir` / `--debug_nans`, on the CPU: `StepTimer` laps,
`profile` writing a Chrome trace that names the ops it ran (and nothing for
None), `debug_mode` raising on the op that makes a NaN as `jax_debug_nans`
does, and the reference's `time_desc_decorator` printer.
"""

import glob
import json
import os

import pytest
import torch

from mmda_tpu.utils import timing as jtiming
from mmda_tpu_torch.cli import train as cli_train
from mmda_tpu_torch.utils import timing

# The suite runs in several processes at once: one intra-op thread each keeps
# torch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)


def test_step_timer_laps():
    t = timing.StepTimer()
    for _ in range(3):
        t.start()
        x = torch.ones(64, 64) @ torch.ones(64, 64)
        assert t.stop({"x": x, "rest": [x, 1]}) >= 0.0
    assert len(t.laps) == 3 and t.mean == sum(t.laps) / 3
    assert timing.StepTimer().mean == jtiming.StepTimer().mean == 0.0


def test_profile_writes_a_chrome_trace(tmp_path):
    with timing.profile(None) as prof:
        assert prof is None
    with timing.profile(str(tmp_path / "p")) as prof:
        torch.nn.functional.gelu(torch.randn(32, 32) @ torch.randn(32, 32))
    traces = glob.glob(str(tmp_path / "p" / "trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert {"aten::mm", "aten::gelu"} <= names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_debug_mode_raises_on_the_op_that_makes_a_nan():
    x = torch.zeros(3)
    with pytest.raises(FloatingPointError, match="aten.div"):
        with timing.debug_mode():
            torch.empty(8)                      # uninitialised memory is not checked
            x / x
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(x / x).all()                # the check ends with the scope


def test_time_desc_decorator_prints(capsys):
    @timing.time_desc_decorator("work")
    def work(a):
        return a + 1

    assert work(1) == 2
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "work" and out[1].startswith("work: ")


def _args(tmp_path, *extra):
    return ["--device", "cpu", "--data", "synthetic", "--use_bert", "False",
            "--hidden_size", "8", "--embedding_size", "8", "--max_seq_len", "8",
            "--batch_size", "64", "--n_epoch", "1", "--ckpt_dir", str(tmp_path / "ck"),
            "--name", "t", "--log_sinks", "stdout", *extra]


def test_cli_train_profile_dir_writes_a_trace(tmp_path):
    summary = cli_train.main(_args(tmp_path, "--profile_dir", str(tmp_path / "prof")))
    assert summary["best_epoch"] == 0
    traces = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    # the towers' recurrence (its plain version on the CPU) and the optimizer ran in it
    assert "aten::sigmoid" in names and "aten::addcmul_" in names


def test_cli_train_debug_nans_runs_eager(tmp_path, capsys):
    summary = cli_train.main(_args(tmp_path, "--debug_nans", "True", "--compiled_epoch",
                                   "True"))
    assert summary["best_epoch"] == 0
    assert "steps and evals run eager" in capsys.readouterr().out
