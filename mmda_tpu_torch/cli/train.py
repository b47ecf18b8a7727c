"""Training entry: `python -m mmda_tpu_torch.cli.train`.

Counterpart of `mmda_tpu/cli/train.py`, with the same flags (the fields of
`mmda_tpu_torch.config.Config`).  It runs on the card by default; `--device
cpu` is the only way onto the CPU, and `--device cuda` without a card
raises.  The best-on-dev parameters land in `{ckpt_dir}/best_model_*.msgpack`
in the JAX package's format, so `python -m mmda_tpu_torch.cli.serve` and the
JAX package's `load_checkpoint` both read them; the summary goes to
`{ckpt_dir}/summary_{name}.json`.

`--compiled_epoch True` trains through CUDA-graph replays of the step and
`--compiled_eval` (default True) evaluates through them, as the JAX CLI's
flags do; `--scan_chunk` is accepted and inert (a replay is one step).
`--grad_accum_steps K` applies an update every K batches; `--use_confidNet
True --confid_two_stage True [--n_epoch_stage2 N]` retrains the confidence
head alone after the main run (the ConfidNet recipe); the `last_{name}`
snapshot lands every `--ckpt_interval` epochs and on SIGTERM/SIGINT, and
`--resume True` carries on from it.  `--bert_model_dir DIR` starts the BERT
tower from a HuggingFace checkpoint (`model.safetensors` or
`pytorch_model.bin`); `--profile_dir DIR` traces each run's `train()` with
torch.profiler into a Chrome trace there; `--debug_nans True` raises on the
op that makes a NaN (`utils/timing.py::debug_mode`), and it and
`--disable_jit True` run the steps and evals eager (no CUDA graph), as JAX
runs them op by op.

Under torchrun the run is data-parallel (`parallel/mesh.py`): each process
joins the process group (`nccl` on the card LOCAL_RANK, `gloo` with
`--device cpu`), the trainer shards each batch over `--dp_size` ranks (-1,
the default: all of them), and only rank 0 prints, logs and writes files.

Usage:
  python -m mmda_tpu_torch.cli.etl --data mosei --data_dir DIR       # the splits, once
  python -m mmda_tpu_torch.cli.train --data mosei --data_dir DIR
  python -m mmda_tpu_torch.cli.train --data mosei --data_dir DIR --resume True
  python -m mmda_tpu_torch.cli.train --data mosei --data_dir DIR --use_confidNet True \
      --confid_two_stage True
  python -m mmda_tpu_torch.cli.train --data synthetic --n_epoch 2      # no data files
  python -m mmda_tpu_torch.cli.train --data synthetic --compiled_epoch True
  python -m mmda_tpu_torch.cli.train --data synthetic --bert_model_dir DIR --profile_dir P
  python -m mmda_tpu_torch.cli.train --data synthetic --device cpu --use_bert False
  torchrun --nproc_per_node 2 -m mmda_tpu_torch.cli.train --data synthetic --dp_size 2
  torchrun --nproc_per_node 2 -m mmda_tpu_torch.cli.train --device cpu --data synthetic \
      --use_bert False --dp_size 2
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch.distributed as dist


def load_data(cfg):
    """(splits, pretrained GloVe table or None) for cfg.data: the synthetic
    splits, or what `python -m mmda_tpu_torch.cli.etl` wrote under
    `{data_dir}/{DATA}`."""
    from mmda_tpu_torch.data import load_splits
    from mmda_tpu_torch.data.synthetic import make_dataset

    if cfg.data == "synthetic":
        return make_dataset(num_train=512, num_dev=128, num_test=128,
                            max_len=cfg.max_seq_len), None
    data_dir = os.path.join(cfg.data_dir, cfg.data.upper())
    emb_path = os.path.join(data_dir, "glove_emb.npy")
    emb = np.load(emb_path) if os.path.exists(emb_path) else None
    return load_splits(data_dir), emb


def main(argv=None) -> dict:
    from mmda_tpu_torch.config import get_config

    cfg = get_config(argv=argv)
    distributed = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if distributed:                         # a torchrun rank
        from mmda_tpu_torch.parallel.mesh import init_distributed

        cfg = cfg.replace(device=str(init_distributed(cfg.device)))
    try:
        return _train(cfg)
    finally:
        if distributed:
            dist.destroy_process_group()


def _train(cfg) -> dict:
    from mmda_tpu_torch.train.loop import Trainer
    from mmda_tpu_torch.utils.logging import MetricLogger
    from mmda_tpu_torch.utils.timing import debug_mode, profile

    chief = not dist.is_initialized() or dist.get_rank() == 0
    say = print if chief else (lambda *a, **k: None)
    if cfg.use_wandb and "wandb" not in cfg.log_sinks:
        cfg = cfg.replace(log_sinks=tuple(cfg.log_sinks) + ("wandb",))
    if (cfg.debug_nans or cfg.disable_jit) and (cfg.compiled_epoch or cfg.compiled_eval):
        say("debug_nans / disable_jit: steps and evals run eager "
            "(compiled_epoch=False, compiled_eval=False)")
        cfg = cfg.replace(compiled_epoch=False, compiled_eval=False)
    say(cfg)
    data, pretrained_emb = load_data(cfg)

    summaries = []
    n_runs = max(cfg.runs, 1) if cfg.mode == "multirun" else 1
    for i in range(n_runs):
        run_cfg = cfg if n_runs == 1 else cfg.replace(seed=cfg.seed + i,
                                                      name=f"{cfg.name}_r{i}")
        logger = MetricLogger(run_cfg.log_sinks if chief else (), run_name=run_cfg.name)
        trainer = Trainer(run_cfg, data, pretrained_emb=pretrained_emb, logger=logger)
        debug = debug_mode() if cfg.debug_nans else contextlib.nullcontext()
        with debug, profile(run_cfg.profile_dir if chief else None):
            summaries.append(trainer.train())
        logger.close()
    summary = summaries[-1]
    if n_runs > 1:
        keys = [k for k in summary
                if k.startswith("test_") and isinstance(summary[k], (int, float))]
        agg = {f"mean_{k}": float(np.mean([s[k] for s in summaries])) for k in keys}
        agg.update({f"std_{k}": float(np.std([s[k] for s in summaries])) for k in keys})
        say(json.dumps(agg, indent=2))
        summary = {**summary, **agg}
    if not chief:
        return summary

    print("=" * 50)
    print(f"Best epoch: {summary['best_epoch']}")
    for label, key in (("Accuracy", "test_acc"), ("F1 score", "test_f1"),
                       ("Precision", "test_precision"), ("Recall", "test_recall"),
                       ("MAE", "test_mae"), ("Corr", "test_corr"), ("Acc2", "test_acc2")):
        if key in summary:
            print(f"{label}: {summary[key]}")
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    with open(os.path.join(cfg.ckpt_dir, f"summary_{cfg.name}.json"), "w") as f:
        json.dump({k: v for k, v in summary.items() if k != "history"}, f,
                  indent=2, default=float)
    return summary


if __name__ == "__main__":
    main()
