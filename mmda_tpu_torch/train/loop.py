"""Trainer on one card: train epochs, dev eval, best-on-dev save, test eval.

Counterpart of `mmda_tpu/train/loop.py::Trainer` on one device.  The model
is built from `cfg.seed` (the weights drawn on the CPU, then moved), the
reference's freeze rules applied as requires_grad (mosei: BERT encoder
layers <= 8, plus the embeddings under freeze_bert_embeddings; ur_funny:
all of BERT; a pretrained GloVe table under freeze_embeddings), and the
optimizer built over the trainable parameters.  Dropout draws come from one
`torch.Generator` on the device seeded from cfg.seed.

Each epoch runs `train_step` over the shuffled, length-bucketed train split
(drop_last) and reads the epoch's losses back in one copy, evaluates the
dev split, lowers the learning rate on a dev-loss plateau
(lr_schedule="plateau"), saves the best-on-dev parameters (the EMA shadow
when ema_decay > 0) as the JAX-format export `best_model_*`, and logs the
JAX trainer's payload.  `train()` then evaluates the test split with the
best-on-dev parameters and returns the summary dict.

Options that need what the port does not have yet raise `ValueError` at
construction, naming their ROADMAP item (`unsupported`).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mmda_tpu_torch.config import resolve_device
from mmda_tpu_torch.convert import load_jax_params
from mmda_tpu_torch.data.loader import ArrayLoader, auto_bucket_sizes, to_device
from mmda_tpu_torch.models import get_model
from mmda_tpu_torch.models.bert import BertConfig, bert_config_for, freeze_layers
from mmda_tpu_torch.train import checkpoint as ckpt
from mmda_tpu_torch.train.state import Optimizer, trainable_param_count
from mmda_tpu_torch.train.step import eval_step, train_step
from mmda_tpu_torch.utils.confidence_metrics import confidence_metrics
from mmda_tpu_torch.utils.logging import MetricLogger
from mmda_tpu_torch.utils.metrics import get_accuracy, get_metrics, select_by_eval_mode
from mmda_tpu_torch.utils.sentiment_metrics import eval_binary, eval_mosei_senti


def task_metrics(task: str, truths: np.ndarray, preds: np.ndarray) -> dict:
    if task == "regression":
        return eval_mosei_senti(preds, truths)
    if task == "binary":
        return eval_binary(preds.reshape(-1) > 0.5, truths.reshape(-1) > 0.5)
    return get_metrics(truths, preds)


def unsupported(cfg) -> List[str]:
    """The options of `cfg` the port's trainer cannot run yet, each with
    the ROADMAP item that brings it."""
    q = "ROADMAP Queue 1"
    checks = [
        (cfg.dp_size > 1 or cfg.tp_size > 1, f"dp_size/tp_size > 1 (mesh; {q}: parallel modes)"),
        (cfg.pp_size > 1, f"pp_size > 1 ({q}: parallel modes)"),
        (cfg.sp, f"sp ({q}: parallel modes)"),
        (cfg.moe_experts > 0, f"moe_experts > 0 ({q}: parallel modes, MoE BERT)"),
        (cfg.zero1, f"zero1 ({q}: parallel modes)"),
        (cfg.fsdp, f"fsdp ({q}: parallel modes)"),
        (cfg.ckpt_backend != "msgpack", f"ckpt_backend={cfg.ckpt_backend} ({q}: parallel modes)"),
        (cfg.compiled_epoch, f"compiled_epoch ({q}: compiled epoch / CUDA graphs)"),
        (cfg.resume, f"resume ({q}: resume and incremental checkpoints)"),
        (cfg.grad_accum_steps > 1, f"grad_accum_steps > 1 ({q}: grad_accum_steps)"),
        (cfg.confid_two_stage, f"confid_two_stage ({q}: ConfidNet stage 2)"),
        (cfg.bert_model_dir is not None, f"bert_model_dir (HF weight loading; {q})"),
        (cfg.profile_dir is not None, f"profile_dir ({q}: profiler hook)"),
    ]
    return [msg for bad, msg in checks if bad]


class Trainer:
    """data: {"train" | "dev" | "test": dict of arrays}."""

    def __init__(self, cfg, data: Dict[str, Dict[str, np.ndarray]],
                 bert_cfg: Optional[BertConfig] = None,
                 pretrained_emb: Optional[np.ndarray] = None,
                 logger: Optional[MetricLogger] = None):
        missing = unsupported(cfg)
        if missing:
            raise ValueError("not ported yet: " + "; ".join(missing))
        self.task = cfg.resolved_task()
        if self.task in ("regression", "binary") and cfg.num_classes != 1:
            cfg = cfg.replace(num_classes=1)
        if self.task == "binary":
            data = {k: {**v, "emo_label": v["emo_label"][:, :1]} for k, v in data.items()}
        if cfg.bucket_sizes and str(cfg.bucket_sizes[0]) == "auto":
            k = int(cfg.bucket_sizes[1]) if len(cfg.bucket_sizes) > 1 else 3
            cfg = cfg.replace(bucket_sizes=auto_bucket_sizes(data["train"]["lengths"], k))
        self.cfg = cfg
        self.data = data
        self._last_eval_confidence: Optional[Dict[str, np.ndarray]] = None
        self.device = resolve_device(cfg.device)
        self.bert_cfg = bert_cfg or bert_config_for(cfg)
        if cfg.fused_ln_dropout and self.bert_cfg is not None:
            self.bert_cfg = dataclasses.replace(self.bert_cfg, fused_ln_dropout=True)
        self.logger = logger or MetricLogger(cfg.log_sinks, run_name=cfg.name)

        train = data["train"]
        self.sizes = dict(visual_size=train["visual"].shape[-1],
                          acoustic_size=train["acoustic"].shape[-1],
                          vocab_size=int(train["text"].max()) + 1)
        self.num_train = len(train["lengths"])
        model = get_model(cfg.model)(cfg, bert_cfg=self.bert_cfg, device="cpu",
                                     **self.sizes)
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        if pretrained_emb is not None and not cfg.use_bert:
            with torch.no_grad():
                model.embed.copy_(torch.as_tensor(pretrained_emb))
        self.model = model.to(self.device)
        self._freeze(pretrained_emb is not None)

        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        steps_per_epoch = None
        if cfg.lr_schedule in ("exponential", "cosine"):
            steps_per_epoch = max(len(self._loader("train", shuffle=False)), 1)
        trainable = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = Optimizer(cfg, trainable, steps_per_epoch)
        self.ema = ([p.detach().clone() for p in self.model.parameters()]
                    if cfg.ema_decay > 0 else None)
        self.step = 0

        counts = trainable_param_count(self.model)
        self.logger.log({"params_total": counts["total"],
                         "params_trainable": counts["trainable"]})
        try:            # the resolved run config, reloadable with --config_json
            os.makedirs(cfg.ckpt_dir, exist_ok=True)
            with open(os.path.join(cfg.ckpt_dir, f"{cfg.name}_config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
        except OSError:
            pass

    def _freeze(self, has_pretrained_emb: bool) -> None:
        cfg, model = self.cfg, self.model
        if cfg.use_bert:
            if cfg.data.startswith("mosei"):
                freeze_layers(model.bert, max_frozen_layer=8)
                if cfg.freeze_bert_embeddings:
                    model.bert.embeddings.requires_grad_(False)
            elif cfg.data == "ur_funny":
                model.bert.requires_grad_(False)
        elif has_pretrained_emb and cfg.freeze_embeddings:
            model.embed.requires_grad_(False)

    def _loader(self, split: str, shuffle: bool) -> ArrayLoader:
        return ArrayLoader(self.data[split], batch_size=self.cfg.batch_size,
                           shuffle=shuffle, drop_last=(split == "train"),
                           bucket_sizes=self.cfg.bucket_sizes, seed=self.cfg.seed,
                           device=self.device)

    def eval_model(self) -> torch.nn.Module:
        """The model eval and the best-on-dev export read: a copy holding
        the EMA shadow when ema_decay > 0, else the live model."""
        if self.ema is None:
            return self.model
        shadow = {n: e for (n, _), e in zip(self.model.named_parameters(), self.ema)}
        model = get_model(self.cfg.model)(self.cfg, bert_cfg=self.bert_cfg,
                                          device="meta", **self.sizes)
        model.load_state_dict(shadow, assign=True)
        return model

    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        train_loader = self._loader("train", shuffle=True)
        best_valid_loss = float("inf")
        best_results = best_truths = None
        best_epoch = -1
        curr_patience, num_trials, plateau_wait = cfg.patience, 1, 0
        history: List[Dict] = []
        eval_values: Dict[str, float] = {}
        best_name = ckpt.best_model_name(cfg)

        for e in range(cfg.n_epoch):
            t0 = time.perf_counter()
            epoch_losses = []
            for batch in train_loader:
                epoch_losses.append(train_step(self.model, self.optimizer, batch, cfg,
                                               self.generator, self.ema))
                self.step += 1
            if not epoch_losses:
                raise ValueError(
                    f"epoch {e} produced no batches: the train split has "
                    f"{self.num_train} rows but batch_size={cfg.batch_size} with "
                    "drop_last; shrink batch_size or grow the dataset")
            keys = sorted(epoch_losses[0])
            stacked = torch.stack([torch.stack([l[k].float() for k in keys])
                                   for l in epoch_losses]).cpu().numpy()   # one copy
            epoch_time = time.perf_counter() - t0
            means = {k: float(np.mean(stacked[:, i])) for i, k in enumerate(keys)}
            train_avg_loss = round(means["total"], 4)

            t_eval0 = time.perf_counter()
            valid_loss, valid_acc, preds, truths = self.evaluate("dev")
            eval_time = time.perf_counter() - t_eval0
            t_ckpt0 = time.perf_counter()

            if cfg.lr_schedule == "plateau":
                if valid_loss <= best_valid_loss:
                    plateau_wait = 0
                else:
                    plateau_wait += 1
                    if plateau_wait > cfg.lr_plateau_patience:
                        new_lr = max(self.optimizer.lr * cfg.lr_decay_rate, cfg.min_lr)
                        self.optimizer.set_learning_rate(new_lr)
                        self.logger.log({"lr_reduced_to": new_lr, "epoch": e})
                        plateau_wait = 0

            if valid_loss <= best_valid_loss:
                best_valid_loss = valid_loss
                best_results, best_truths, best_epoch = preds, truths, e
                ckpt.save_checkpoint(cfg.ckpt_dir, best_name, self.eval_model(),
                                     {"epoch": e, "valid_loss": valid_loss})
                eval_values = task_metrics(self.task, best_truths, best_results)
                curr_patience = cfg.patience
            elif cfg.enable_early_stop:
                curr_patience -= 1
                if curr_patience <= -1:
                    num_trials -= 1
                    curr_patience = cfg.patience
                    if ckpt.checkpoint_exists(cfg.ckpt_dir, best_name):
                        self._load_best(best_name, self.model)
                    if num_trials <= 0:
                        self.logger.log({"early_stop_epoch": e})
                        break

            epoch_total = time.perf_counter() - t0
            payload = {
                "epoch": e, "train_loss": train_avg_loss, "valid_loss": valid_loss,
                "valid_acc": valid_acc, "epoch_time_s": round(epoch_time, 3),
                "epoch_total_time_s": round(epoch_total, 3),
                "eval_time_s": round(eval_time, 3),
                "post_eval_time_s": round(time.perf_counter() - t_ckpt0, 3),
                "utterances_per_s": round(
                    len(epoch_losses) * cfg.batch_size / max(epoch_time, 1e-9), 1),
                **{f"train_{k}": v for k, v in means.items() if k != "total"},
            }
            if eval_values and self.task == "classification":
                payload.update(select_by_eval_mode(eval_values, cfg.eval_mode))
            elif eval_values:
                payload.update({f"dev_{k}": v for k, v in eval_values.items()})
            self.logger.log(payload, step=self.step)
            history.append(payload)

        best = None
        if best_epoch >= 0:
            best = self._load_best(best_name, copy.deepcopy(self.model))
        test_loss, test_acc, test_preds, test_truths = self.evaluate("test", best)
        test_metrics = task_metrics(self.task, test_truths, test_preds)
        summary = {"best_epoch": best_epoch, "best_valid_loss": best_valid_loss,
                   "test_loss": test_loss, "test_acc": test_acc,
                   **{f"test_{k}": v for k, v in test_metrics.items()},
                   "history": history}
        # ConfidNet confidence quality on the test pass: TCP calibration MSE,
        # failure-prediction AUPR and FPR@95TPR (the JAX trainer's conf_* keys)
        if (cfg.use_confidNet and self.task == "classification"
                and self._last_eval_confidence is not None):
            conf = confidence_metrics(self._last_eval_confidence["scores"],
                                      self._last_eval_confidence["tcp"],
                                      test_preds, test_truths)
            summary.update({f"conf_{k}": v for k, v in conf.items()})
        if eval_values:
            summary["best_dev_metrics"] = eval_values
        self.logger.log({k: v for k, v in summary.items() if k != "history"})
        return summary

    def _load_best(self, name: str, model: torch.nn.Module) -> torch.nn.Module:
        """Load the best-on-dev export into `model`: the live model on early
        stop (the EMA shadow is kept), a copy for the final test, as the JAX
        trainer restores it."""
        return load_jax_params(model, ckpt.load_checkpoint(self.cfg.ckpt_dir, name))

    def evaluate(self, mode: str, model: Optional[torch.nn.Module] = None) -> tuple:
        """(loss, accuracy, preds, truths) over a split: the loss is the mean
        over batches of the per-class BCE summed over classes, taken over
        the real rows (L1 for regression); accuracy the multilabel Jaccard
        (sign agreement for regression).  model: default `eval_model()`.
        For classification the real rows' tcp and scores are kept, joined,
        in `_last_eval_confidence` for the ConfidNet metrics (None after a
        regression split)."""
        model = model if model is not None else self.eval_model()
        losses, preds, truths = [], [], []
        tcps, raw_scores = [], []
        for host in self._loader(mode, shuffle=False).host_batches():
            out = eval_step(model, to_device(host, self.device), self.cfg)
            out = {k: v.float().cpu().numpy() for k, v in out.items()}   # one sync
            w = np.asarray(host["sample_weight"]) > 0
            losses.append(float(np.sum(np.mean(out["bce"][w], axis=0))))
            if self.task == "regression":
                preds.append(out["scores"][w][:, 0])
                truths.append(np.asarray(host["sentiment"])[w])
            else:
                preds.append(out["labels"][w])
                truths.append(np.asarray(host["emo_label"])[w])
                tcps.append(out["tcp"][w])
                raw_scores.append(out["scores"][w])
        self._last_eval_confidence = (
            {"tcp": np.concatenate(tcps, axis=0), "scores": np.concatenate(raw_scores, axis=0)}
            if tcps else None)
        y_pred = np.concatenate(preds, axis=0)
        y_true = np.concatenate(truths, axis=0)
        if self.task == "regression":
            acc = float(np.mean((y_pred >= 0) == (y_true >= 0)))
        else:
            acc = get_accuracy(y_true, y_pred)
        return float(np.mean(losses)), acc, y_pred, y_true
