"""Trainer on one card: train epochs, dev eval, best-on-dev save, test eval.

Counterpart of `mmda_tpu/train/loop.py::Trainer` on one device.  The model
is built from `cfg.seed` (the weights drawn on the CPU, then moved), the
reference's freeze rules applied as requires_grad (mosei: BERT encoder
layers <= 8, plus the embeddings under freeze_bert_embeddings; ur_funny:
all of BERT; a pretrained GloVe table under freeze_embeddings), and the
optimizer built over the trainable parameters.  Dropout draws come from one
`torch.Generator` on the device seeded from cfg.seed.

Each epoch runs `train_step` over the shuffled, length-bucketed train split
(drop_last), or with `compiled_epoch` the same steps through a training
graph (`make_train_graph`: per batch shape, an eager warm-up, then CUDA-graph
replays; on the CPU the same body without a graph), and reads the epoch's
losses back in one copy, evaluates the
dev split, lowers the learning rate on a dev-loss plateau
(lr_schedule="plateau"), saves the best-on-dev parameters (the EMA shadow
when ema_decay > 0) as the JAX-format export `best_model_*`, and logs the
JAX trainer's payload.  The export is copied to the host at once and
written on a thread, as the JAX trainer writes it; every reload of it
(early stop, the final test, stage 2) and the end of `train()` join that
write first.  `train()` then evaluates the test split with the
best-on-dev parameters and returns the summary dict.  Eval runs through an
eval graph under `compiled_eval` (the default, as in the JAX package), one
per set of parameters it reads.  `scan_chunk` is inert: a replay is one step.

Resilience, as the JAX trainer: a `last_{name}` train-state snapshot
(`train/checkpoint.py`) every `ckpt_interval` epochs and at every exit of
the loop (the last epoch, early stop, preemption), written on a thread;
incremental (a frozen base once, then deltas) when the run has a frozen
mask (use_bert, or a frozen GloVe table) and `ckpt_incremental` is set.
SIGTERM and SIGINT set a flag that ends the loop at the next epoch boundary,
after the snapshot.  `resume=True` loads the snapshot in place at
construction (the captured graphs read the same tensors) and `train()`
starts at epoch step // len(train_loader), with the loader's generator
restarted from the seed, as the JAX loader's is.  `grad_accum_steps` makes
every step a mini-step of the optimizer (`train/state.py`).

ConfidNet stage 2 (`confid_two_stage` under `use_confidNet`): after the
test eval, the best-on-dev export is loaded into the model, every module
but `confidence` is frozen, a fresh optimizer (count 0, its schedules sized
by the train loader) and, when ema_decay > 0, a fresh EMA shadow of the
loaded parameters train `losses["conf"]` alone for n_epoch_stage2 epochs of
eager steps (no graph, as JAX runs its stage 2 by the per-step jit), the
trainer's generator going on; the result replaces the best export and the
test split is evaluated again (through the shadow when there is one).

`bert_model_dir` loads a HuggingFace bert checkpoint into the BERT tower
after the seeded init and before the freeze rules, so the frozen layers and
the `last_*` frozen base hold the file's weights.  `profile_dir` is read by
`cli/train.py`, which traces `train()` (`utils/timing.py::profile`).
Options that need what the port does not have yet (pipeline parallelism,
zero1 and fsdp, the orbax backend, MMIM at dp > 1) raise `ValueError` at
construction, naming their ROADMAP item (`unsupported`).  `moe_experts > 0`
(a Switch MoE in every BERT layer, `bert_config_for`) raises the JAX
trainer's own errors without the BERT tower, with `pp_size > 1` and where
tp_size does not divide the experts.

Data parallelism (the JAX trainer's mesh, `mmda_tpu/train/loop.py:192-193`,
`:661-700`): with a process group up (`parallel/mesh.py::init_distributed`,
torchrun) the trainer runs on the mesh of `cfg.dp_size` ranks (-1: the
world; without a process group, one process, and dp_size > 1 raises).
Every rank builds the same model from the seed (then rank 0's parameters
are broadcast), the same loader, batch order and bucket lengths, and takes
its rows of each batch (`shard_batch`); the steps are `train/step.py`'s
data-parallel steps, and a batch_size that does not divide dp runs every
batch whole on every rank, as the JAX trainer runs it replicated.  The
modality-keep draws come from the shared generator; at dp > 1 the forward's
dropout comes from each rank's own generator, seeded at every epoch from
(seed, rank, epoch), so a resumed run draws what the uninterrupted one did.
`evaluate` gathers the outputs, so every rank computes the same metrics,
and every host decision (best-on-dev, the plateau schedule, early stop)
follows from values every rank holds; a preemption signal on any rank stops
them all.  Only rank 0 logs and writes the best export and the `last_*`
snapshots; every rank waits at a barrier before it reads one.  The captured
steps and evals record their collectives (nccl); gloo on CUDA cannot be
captured, and compiled_epoch / compiled_eval then raise at construction.

Tensor parallelism (`cfg.tp_size` > 1, the JAX trainer's
`shard_params(..., tp=True)`, `mmda_tpu/train/loop.py:192-193`): the mesh
is (dp, tp) with dp = dp_size (-1: world / tp), the model is sharded after
the broadcast (`parallel/mesh.py::shard_params`: each rank of a 'model'
row its blocks of the BERT denses) and the optimizer and the EMA shadow
are built on the blocks.  The ranks of a row take the same rows of each
batch (their 'data' coordinate's), and their dropout generator is seeded
from (seed, 'data' coordinate, epoch), so they drop alike.  The best
export and the `last_*` snapshots hold the full layout (the JAX package
reads them whole): the 'model' row of rank 0 gathers it
(`checkpoint.full_layout`, `gather_params`) and rank 0 writes it; every
rank reads its blocks of one back (a resume at any tp).  A MoE layer's
experts are sharded too (rank m of a row its E / tp of them,
`parallel/expert.py`), and gathered into the full layout for the files.

Sequence parallelism (`cfg.sp`, which needs tp_size > 1, as the JAX
trainer's `install_sequence_sharding`): the sharded BERT runs its
LayerNorm regions on each rank's S-shard (`parallel/sequence.py::
shard_sequence`); nothing else of the trainer changes.  MoE BERT at dp > 1
routes each rank's rows as the global batch's (`route_over_data`: the aux
losses' statistics summed over 'data', and with moe_group_by_example off
the queue positions over every rank's tokens), where the steps shard the
batch.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mmda_tpu_torch.config import resolve_device
from mmda_tpu_torch.convert import load_jax_params
from mmda_tpu_torch.data.loader import ArrayLoader, auto_bucket_sizes, to_device
from mmda_tpu_torch.models import get_model
from mmda_tpu_torch.models.bert import (BertConfig, bert_config_for, freeze_layers,
                                         load_hf_encoder)
from mmda_tpu_torch.parallel import mesh as pmesh
from mmda_tpu_torch.parallel.expert import route_over_data
from mmda_tpu_torch.parallel.sequence import shard_sequence
from mmda_tpu_torch.train import checkpoint as ckpt
from mmda_tpu_torch.train.state import Optimizer, trainable_param_count
from mmda_tpu_torch.train.step import (eval_step, graph_pool, make_eval_graph,
                                       make_train_graph, train_step)
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


def unsupported(cfg, dp: int = 1) -> List[str]:
    """The options of `cfg` the port's trainer cannot run yet on a mesh of
    dp data-parallel ranks, each with the ROADMAP item that brings it."""
    q = "ROADMAP Queue 1"
    checks = [
        (cfg.zero1, f"zero1 ({q} item 4: zero1 and fsdp)"),
        (cfg.fsdp, f"fsdp ({q} item 4: zero1 and fsdp)"),
        (cfg.pp_size > 1, f"pp_size > 1 ({q} item 5: the pipelined encoder)"),
        (cfg.ckpt_backend != "msgpack",
         f"ckpt_backend={cfg.ckpt_backend} ({q} item 6: the sharded checkpoint)"),
        (cfg.model == "MMIM" and dp > 1,
         f"model=MMIM with dp > 1 (its CPC term takes a softmax over the batch; {q} item 7: "
         "MMIM under data parallelism)"),
    ]
    return [msg for bad, msg in checks if bad]


def data_parallel_size(cfg) -> int:
    """The dp the trainer runs at: cfg.dp_size, -1 taking the process
    group's world over tp_size (one process without a group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return max(world // cfg.tp_size, 1) if cfg.dp_size == -1 else cfg.dp_size


class Trainer:
    """data: {"train" | "dev" | "test": dict of arrays}."""

    def __init__(self, cfg, data: Dict[str, Dict[str, np.ndarray]],
                 bert_cfg: Optional[BertConfig] = None,
                 pretrained_emb: Optional[np.ndarray] = None,
                 logger: Optional[MetricLogger] = None):
        if cfg.moe_experts > 0:
            if not cfg.use_bert:
                raise ValueError("moe_experts > 0 replaces the BERT FFNs; "
                                 "use_bert=False has no MoE site")
            if cfg.pp_size > 1:
                raise ValueError("moe_experts > 0 does not compose with "
                                 "pp_size > 1 (pipelined encoder)")
            pmesh.check_experts(cfg.tp_size, cfg.moe_experts)
        missing = unsupported(cfg, data_parallel_size(cfg))
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
        self.mesh = self._make_mesh()
        # the mesh the steps shard over: None where batch_size does not divide
        # dp (every batch then runs whole on every rank)
        self.step_mesh = (self.mesh if self.mesh is not None
                          and self.mesh.divides(cfg.batch_size) else None)
        self.is_chief = self.mesh is None or self.mesh.rank == 0
        self.bert_cfg = bert_cfg or bert_config_for(cfg)
        if cfg.fused_ln_dropout and self.bert_cfg is not None:
            self.bert_cfg = dataclasses.replace(self.bert_cfg, fused_ln_dropout=True)
        if cfg.moe_experts > 0:
            self.bert_cfg = dataclasses.replace(
                self.bert_cfg, moe_experts=cfg.moe_experts,
                moe_capacity_factor=cfg.moe_capacity_factor, moe_top_k=cfg.moe_top_k)
        self.logger = logger or MetricLogger(cfg.log_sinks if self.is_chief else (),
                                             run_name=cfg.name)

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
        if cfg.use_bert and cfg.bert_model_dir:
            load_hf_encoder(model.bert, cfg.bert_model_dir)
        self.model = model.to(self.device)
        if self.mesh is not None:
            pmesh.replicated(self.model, self.mesh)
            self._place(self.model)
        self._freeze(pretrained_emb is not None)
        # the JAX trainer builds a frozen mask (and snapshots incrementally)
        # for every BERT run and for a frozen GloVe table
        self.has_frozen_mask = cfg.use_bert or (pretrained_emb is not None
                                                and cfg.freeze_embeddings)

        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        # the forward's dropout: each rank's own at dp > 1 (seeded per epoch,
        # `_seed_dropout`), else the one generator, as the one-process step
        self.dropout_generator = (torch.Generator(self.device)
                                  if self.step_mesh is not None and self.step_mesh.dp > 1
                                  else self.generator)
        steps_per_epoch = None
        if cfg.lr_schedule in ("exponential", "cosine"):
            steps_per_epoch = max(len(self._loader("train", shuffle=False)), 1)
        trainable = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = Optimizer(cfg, trainable, steps_per_epoch)
        self.ema = ([p.detach().clone() for p in self.model.parameters()]
                    if cfg.ema_decay > 0 else None)
        self.step = 0
        self.pool = graph_pool(self.device)             # every graph of this trainer
        self.train_graph = None                         # made by the first compiled epoch
        self.eval_graphs: Dict[tuple, Any] = {}         # by the parameters they read
        self._export: Optional[threading.Thread] = None  # the best export's writer

        counts = trainable_param_count(self.model)
        self.logger.log({"params_total": counts["total"],
                         "params_trainable": counts["trainable"]})
        try:            # the resolved run config, reloadable with --config_json
            os.makedirs(cfg.ckpt_dir, exist_ok=True)
            if self.is_chief:
                with open(os.path.join(cfg.ckpt_dir, f"{cfg.name}_config.json"), "w") as f:
                    json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
        except OSError:
            pass
        if cfg.resume:
            step = self._load_resume_ckpt()
            if step is not None:
                self.step = step
                self.logger.log({"resumed_at_step": step})

    def _make_mesh(self) -> Optional[pmesh.Mesh]:
        """The data-parallel mesh, or None for one process (module
        docstring)."""
        cfg = self.cfg
        if not dist.is_initialized():
            if cfg.dp_size > 1 or cfg.tp_size > 1:
                raise ValueError(f"dp_size={cfg.dp_size}, tp_size={cfg.tp_size} needs a process "
                                 "group of as many ranks: run under torchrun, or "
                                 "init_distributed first")
            return None
        mesh = pmesh.make_mesh(cfg.dp_size, cfg.tp_size, self.device)
        if mesh.staged and (cfg.compiled_epoch or cfg.compiled_eval):
            raise ValueError("compiled_epoch / compiled_eval capture the step's collectives "
                             "as CUDA graphs, which the gloo backend cannot be part of: use "
                             "nccl, or compiled_epoch=False compiled_eval=False")
        if not mesh.divides(cfg.batch_size) and mesh.rank == 0:
            print(f"batch_size={cfg.batch_size} does not divide dp={mesh.dp}: every rank "
                  "runs every batch whole (replicated)", flush=True)
        return mesh

    def _place(self, model: torch.nn.Module) -> None:
        """`model` (the live model or the EMA shadow's) on the mesh: this
        rank's blocks at tp > 1 (`shard_params`), its S-shards under sp, its
        MoE routing over 'data' where the steps shard the batch."""
        pmesh.shard_params(model, self.mesh)
        if self.cfg.sp:
            shard_sequence(model)
        if self.step_mesh is not None:
            route_over_data(model, self.step_mesh)

    def _seed_dropout(self, *tags: int) -> None:
        """Seed this rank's dropout generator from (seed, 'data' coordinate,
        *tags) at dp > 1 (the ranks of a 'model' row alike); at dp = 1 it is
        the trainer's one generator, left as it is."""
        if self.dropout_generator is not self.generator:
            self.dropout_generator.manual_seed(
                pmesh.rank_seed(self.cfg.seed, self.mesh.dp_rank, *tags))

    def _export_best(self, name: str, model: torch.nn.Module, meta: Dict,
                     async_write: bool = False):
        """Write `model`'s parameters as the export `name` on the chief (a
        thread under async_write, returned), in the full layout: under
        tensor parallelism rank 0's 'model' row gathers them first."""
        tensors = None
        if self.mesh is not None and self.mesh.tp > 1:
            if self.mesh.dp_rank != 0:
                return None
            tensors = pmesh.gather_params(model, self.mesh)
        if not self.is_chief:
            return None
        return ckpt.save_checkpoint(self.cfg.ckpt_dir, name, model, meta,
                                    async_write=async_write, tensors=tensors)

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def _shard(self, host: Dict[str, Optional[np.ndarray]]) -> Dict[str, Optional[np.ndarray]]:
        """This rank's rows of a host batch (the whole batch without a step
        mesh)."""
        return host if self.step_mesh is None else pmesh.shard_batch(host, self.step_mesh)

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

    def train_state(self) -> ckpt.TrainState:
        return ckpt.TrainState(self.step, self.model, self.optimizer, self.generator,
                               self.ema)

    def _save_resume_ckpt(self, epoch: int, valid_loss: float):
        """The `last_{name}` snapshot in the full layout, written by the
        chief on a thread (returned; under tensor parallelism rank 0's
        'model' row gathers it first)."""
        cfg = self.cfg
        state = self.train_state()
        if self.mesh is not None and self.mesh.tp > 1:
            if self.mesh.dp_rank != 0:
                return None
            state = ckpt.full_layout(state, self.mesh)
        if not self.is_chief:
            return None
        meta = {"epoch": epoch, "valid_loss": valid_loss}
        name = f"last_{cfg.name}"
        if cfg.ckpt_incremental and self.has_frozen_mask:
            return ckpt.save_checkpoint_incremental(cfg.ckpt_dir, name, state, meta,
                                                    async_write=True)
        return ckpt.save_train_state(cfg.ckpt_dir, name, state, meta, async_write=True)

    def _load_resume_ckpt(self) -> Optional[int]:
        """Load `last_{name}` in place, if there is one; its step or None.
        Every rank loads it."""
        cfg = self.cfg
        self._barrier()
        name = f"last_{cfg.name}"
        if self.has_frozen_mask and ckpt.incremental_checkpoint_exists(cfg.ckpt_dir, name):
            return ckpt.load_checkpoint_incremental(cfg.ckpt_dir, name, self.train_state(),
                                                    self.mesh)
        if ckpt.checkpoint_exists(cfg.ckpt_dir, name):
            return ckpt.load_train_state(cfg.ckpt_dir, name, self.train_state(), self.mesh)
        return None

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
        if self.mesh is not None:               # the shadow holds this rank's blocks
            self._place(model)
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
        pending: List = []                      # the snapshots' writer threads
        last_saved = [-1]

        def save_last(epoch: int, valid_loss: float) -> None:
            last_saved[0] = epoch
            pending.append(self._save_resume_ckpt(epoch, valid_loss))

        preempted = [False]

        def on_signal(signum, frame):
            preempted[0] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:                  # not the main thread
                pass
        start_epoch = self.step // max(len(train_loader), 1)
        try:
            for e in range(start_epoch, cfg.n_epoch):
                t0 = time.perf_counter()
                self._seed_dropout(e)
                epoch_losses = self._train_epoch(train_loader)
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

                if (e + 1) % cfg.ckpt_interval == 0 or e == cfg.n_epoch - 1:
                    save_last(e, valid_loss)

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
                    self._export = self._export_best(best_name, self.eval_model(),
                                                     {"epoch": e, "valid_loss": valid_loss},
                                                     async_write=True)
                    eval_values = task_metrics(self.task, best_truths, best_results)
                    curr_patience = cfg.patience
                elif cfg.enable_early_stop:
                    curr_patience -= 1
                    if curr_patience <= -1:
                        num_trials -= 1
                        curr_patience = cfg.patience
                        self._join_export()
                        self._barrier()
                        if ckpt.checkpoint_exists(cfg.ckpt_dir, best_name):
                            self._load_best(best_name, self.model)
                        if num_trials <= 0:
                            self.logger.log({"early_stop_epoch": e})
                            if last_saved[0] != e:
                                save_last(e, valid_loss)
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

                if self.mesh.any(preempted[0]) if self.mesh is not None else preempted[0]:
                    self.logger.log({"preempted_at_epoch": e})
                    if last_saved[0] != e:
                        save_last(e, valid_loss)
                    break
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
            for thread in pending:
                if thread is not None:
                    thread.join()
            self._join_export()

        best = None
        if best_epoch >= 0:
            best = self._load_best(best_name, copy.deepcopy(self.model))
        test_loss, test_acc, test_preds, test_truths = self.evaluate("test", best)
        if best is not None:                 # the copy is gone after this call
            self.eval_graphs.pop(self._params_key(best), None)
        test_metrics = task_metrics(self.task, test_truths, test_preds)
        if cfg.use_confidNet and cfg.confid_two_stage and best_epoch >= 0:
            self._train_confidnet_stage2(train_loader)
            test_loss, test_acc, test_preds, test_truths = self.evaluate("test")
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

    def _train_epoch(self, train_loader: ArrayLoader) -> List[Dict[str, torch.Tensor]]:
        """One epoch of steps (eager, or through the training graph under
        compiled_epoch); the loss dicts, on the device."""
        cfg = self.cfg
        epoch_losses = []
        if cfg.compiled_epoch:
            if self.train_graph is None:
                self.train_graph = make_train_graph(
                    self.model, self.optimizer, cfg, self.device, self.generator, self.ema,
                    self.pool, self.step_mesh, self.dropout_generator)
            for host in train_loader.host_batches():
                losses = self.train_graph(self._shard(host))
                epoch_losses.append({k: v.clone() for k, v in losses.items()})
                self.step += 1
        else:
            for host in train_loader.host_batches():
                batch = to_device(self._shard(host), self.device)
                epoch_losses.append(train_step(self.model, self.optimizer, batch, cfg,
                                               self.generator, self.ema, mesh=self.step_mesh,
                                               dropout_generator=self.dropout_generator))
                self.step += 1
        return epoch_losses

    def _train_confidnet_stage2(self, train_loader: ArrayLoader) -> None:
        """ConfidNet stage 2 (module docstring): the confidence head alone,
        on the frozen best-on-dev model, then exported as the best model."""
        cfg = self.cfg
        name = ckpt.best_model_name(cfg)
        self._load_best(name, self.model)                 # in place
        for n, p in self.model.named_parameters():
            p.requires_grad_(n.startswith("confidence."))
        self.optimizer = Optimizer(cfg, [p for p in self.model.parameters() if p.requires_grad],
                                   steps_per_epoch=max(len(train_loader), 1))
        self.ema = ([p.detach().clone() for p in self.model.parameters()]
                    if cfg.ema_decay > 0 else None)
        self.step = 0
        for e in range(cfg.n_epoch_stage2):
            self._seed_dropout(cfg.n_epoch, e)
            conf = []
            for host in train_loader.host_batches():
                losses = train_step(self.model, self.optimizer,
                                    to_device(self._shard(host), self.device), cfg,
                                    self.generator, self.ema, conf_only=True,
                                    mesh=self.step_mesh,
                                    dropout_generator=self.dropout_generator)
                conf.append(losses["conf"])
                self.step += 1
            self.logger.log({"stage2_epoch": e, "stage2_conf_loss": float(
                np.mean(torch.stack(conf).float().cpu().numpy()))})
        self._export_best(name, self.model, {"stage2_epochs": cfg.n_epoch_stage2})
        self._barrier()

    def _join_export(self) -> None:
        """Wait for the latest best-on-dev export's write, if one is running
        (an earlier one's write never lands after it: `train/checkpoint.py`
        orders the writes of one path)."""
        if self._export is not None:
            self._export.join()
            self._export = None

    def _load_best(self, name: str, model: torch.nn.Module) -> torch.nn.Module:
        """Load the best-on-dev export into `model`, after its write: the
        live model on early stop (the EMA shadow is kept), a copy for the
        final test, as the JAX trainer restores it."""
        self._join_export()
        self._barrier()
        return load_jax_params(model, ckpt.load_checkpoint(self.cfg.ckpt_dir, name),
                               pmesh.local_blocks(model, self.mesh))

    @staticmethod
    def _params_key(model: torch.nn.Module) -> tuple:
        return tuple(p.data_ptr() for p in model.parameters())

    def _eval_graph(self, model: torch.nn.Module):
        """The eval graph over `model`'s parameters.  It is keyed by where
        they live, not by the module: `eval_model()` builds a new module over
        the same EMA tensors at every call, and a parameter set at the same
        addresses is read the same way by any module that holds it."""
        key = self._params_key(model)
        if key not in self.eval_graphs:
            self.eval_graphs[key] = make_eval_graph(model, self.cfg, self.device, self.pool,
                                                    self.step_mesh)
        return self.eval_graphs[key]

    def evaluate(self, mode: str, model: Optional[torch.nn.Module] = None) -> tuple:
        """(loss, accuracy, preds, truths) over a split: the loss is the mean
        over batches of the per-class BCE summed over classes, taken over
        the real rows (L1 for regression); accuracy the multilabel Jaccard
        (sign agreement for regression).  model: default `eval_model()`.
        Under a mesh each rank runs its rows and every rank gets the
        split's (the outputs are gathered).
        For classification the real rows' tcp and scores are kept, joined,
        in `_last_eval_confidence` for the ConfidNet metrics (None after a
        regression split)."""
        model = model if model is not None else self.eval_model()
        graph = self._eval_graph(model) if self.cfg.compiled_eval else None
        losses, preds, truths = [], [], []
        tcps, raw_scores = [], []
        for host in self._loader(mode, shuffle=False).host_batches():
            local = self._shard(host)
            out = (graph(local) if graph is not None
                   else eval_step(model, to_device(local, self.device), self.cfg,
                                  self.step_mesh))
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
