"""Ranks for the data-parallel tests (tests/test_torch_dp*.py).

`run_ranks` starts dp processes with torch.multiprocessing (spawn), each a
gloo rank over a FileStore in the test's directory (no port to clash under
xdist), pinned to one intra-op thread, its process group's timeout 60 s; the
parent waits with a deadline and kills the ranks past it, so a rank that
dies or hangs fails its test within seconds.  Each worker writes its
results to `out/rank{r}.pt` for the parent to compare.  This module imports
torch, numpy and the port only: the ranks never import JAX.
"""

from __future__ import annotations

import pathlib
import pickle
import time

import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 60.0


def _entry(rank, fn, dp, store, out, args):
    torch.set_num_threads(1)
    from mmda_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu", init_method=f"file://{store}", rank=rank, world_size=dp,
                     timeout_s=RANK_TIMEOUT_S)
    try:
        result = fn(rank, dp, *args)
        torch.save(result, pathlib.Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, dp: int, tmp_path, *args, deadline_s: float = 120.0) -> list:
    """fn(rank, dp, *args) on dp gloo ranks; their results, by rank."""
    return run_rank_sets([(fn, dp, args)], tmp_path, deadline_s)[0]


def run_rank_sets(sets, tmp_path, deadline_s: float = 120.0) -> list:
    """Each (fn, dp, args) of `sets` on a process group of its own, all sets
    at once; each set's results, by rank."""
    tmp_path = pathlib.Path(tmp_path)
    started = []
    for fn, dp, args in sets:
        out = tmp_path / f"out_{fn.__name__}_{dp}_{time.monotonic_ns()}"
        out.mkdir()
        ctx = torch.multiprocessing.start_processes(
            _entry, args=(fn, dp, str(out / "store"), str(out), args), nprocs=dp, join=False,
            start_method="spawn")
        started.append((fn, dp, out, ctx))
    end = time.monotonic() + deadline_s
    try:
        for fn, dp, _, ctx in started:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > end:
                    raise TimeoutError(f"{fn.__name__} on {dp} ranks ran past {deadline_s} s")
    finally:
        for *_, ctx in started:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    return [[torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(dp)]
            for _, dp, out, _ in started]


# ------------------------------------------------------------ the ranks


def _mesh():
    from mmda_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(-1, 1, "cpu")


def _tiny_misa(cfg, tree):
    """The tests' small MISA with `tree`'s parameters (a JAX parameter tree
    as numpy arrays), the mosei freeze rule, dropout off in train mode."""
    from mmda_tpu_torch.convert import load_jax_params
    from mmda_tpu_torch.models import MISA
    from mmda_tpu_torch.models.bert import BertConfig, freeze_layers

    model = load_jax_params(MISA(cfg, bert_cfg=BertConfig.tiny()), tree)
    freeze_layers(model.bert, 8)
    model.train = lambda mode=True: torch.nn.Module.train(model, False)
    return model


def one_step(cfg, tree, arrays, mesh=None, generator_seed=0):
    """One training step of the small MISA from `tree` on the host batch
    `arrays` (its rows under `mesh`, or the whole of it where they do not
    divide dp): the losses and grad_norm, the gradients the optimizer
    applied (under `mesh` summed over the ranks), the trainable parameters
    after the update, and the per-rank objective a naive DDP step would
    average."""
    from mmda_tpu_torch.data.loader import to_device
    from mmda_tpu_torch.parallel.mesh import shard_batch
    from mmda_tpu_torch.train.objective import compute_losses
    from mmda_tpu_torch.train.state import Optimizer
    from mmda_tpu_torch.train.step import train_step

    model = _tiny_misa(cfg, tree)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt = Optimizer(cfg, [p for _, p in named])
    sharded = mesh is not None and mesh.divides(len(arrays["lengths"]))
    local = shard_batch(arrays, mesh) if sharded else arrays
    batch = to_device(local, torch.device("cpu"))
    with torch.no_grad():
        own = compute_losses(cfg, model(batch), batch)["total"].item()
    applied, apply = [], opt.apply
    opt.apply = lambda grads: applied.extend(g.clone() for g in grads) or apply(grads)
    out = train_step(model, opt, batch, cfg, torch.Generator().manual_seed(generator_seed),
                     mesh=mesh if sharded else None)
    return {"losses": {k: v.item() for k, v in out.items()},
            "grads": {n: g for (n, _), g in zip(named, applied)},
            "params": {n: p.detach().clone() for n, p in named}, "own_objective": own,
            "sharded": sharded}


def step_worker(rank, dp, cases_file):
    """`one_step` at every case of the pickled list (cfg kwargs, tree,
    arrays) on the mesh of the world."""
    from mmda_tpu_torch.config import Config

    with open(cases_file, "rb") as f:
        cases = pickle.load(f)
    mesh = _mesh()
    return [one_step(Config(device="cpu", **kw), tree, arrays, mesh)
            for kw, tree, arrays in cases]


def gather_worker(rank, dp, x_full):
    """gather_rows' forward and this rank's gradient of an objective that
    couples the rows (centred Gram, batch moments), and all_reduce_grads
    across a bucket boundary and a dtype change."""
    from mmda_tpu_torch.parallel import mesh as pmesh
    from mmda_tpu_torch.parallel.mesh import all_reduce_grads, gather_rows

    pmesh.GRAD_BUCKET_BYTES = 24            # buckets of 5, then 3 x 2 f32, then the f64
    mesh = _mesh()
    x = torch.from_numpy(x_full[mesh.rows(len(x_full))]).requires_grad_(True)
    w = torch.arange(x.shape[0], dtype=torch.float64)
    (y, wg) = gather_rows(mesh, x, w)
    c = y - y.mean(0)
    loss = (c.T @ c).pow(2).sum() + y.pow(3).mean(0).sum()
    (g,) = torch.autograd.grad(loss, [x])
    grads = [torch.full((5,), float(rank + 1)), torch.full((3, 2), 2.0 * rank),
             torch.ones(2, dtype=torch.float64)]
    all_reduce_grads(grads, mesh)
    return {"y": y.detach(), "w": wg, "grad": g, "loss": loss.item(), "reduced": grads}


def _tiny_trainer(cfg, data):
    from mmda_tpu_torch.models.bert import BertConfig
    from mmda_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, data, bert_cfg=BertConfig.tiny())
    model = trainer.model
    return trainer, model


def dropout_worker(rank, dp, cfg_kwargs, data):
    """A Trainer's generators at dp: the forward with dropout on (the fused
    LayerNorm kernels' seeds drawn from the rank's generator too) on the same
    rows on every rank, and the modality-keep mask a step draws."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.data.loader import to_device
    from mmda_tpu_torch.train.step import sample_modality_keep

    cfg = Config(**cfg_kwargs)
    trainer, model = _tiny_trainer(cfg, data)
    trainer._seed_dropout(0)
    arrays = next(trainer._loader("train", shuffle=False).host_batches())
    with torch.no_grad():
        scores = model.train()(to_device(arrays, trainer.device),
                               generator=trainer.dropout_generator).scores
    keep = sample_modality_keep(cfg, cfg.batch_size, trainer.device, trainer.generator)
    return {"scores": scores, "keep": keep,
            "shared_is_dropout": trainer.dropout_generator is trainer.generator}


def trainer_worker(rank, dp, cfg_kwargs, data):
    """`train_sequence` on this rank."""
    from mmda_tpu_torch.config import Config

    return train_sequence(Config(**cfg_kwargs), data)


def train_sequence(cfg, data):
    """A Trainer's run of cfg.n_epoch epochs with dropout off, then a second
    Trainer resumed from its `last_*` snapshot for one epoch more: both
    summaries, the resumed step, the trained parameters and the files this
    process wrote (by save function)."""
    from mmda_tpu_torch.train import checkpoint as ckpt

    writes = []

    def counted(name, fn):
        def save(ckpt_dir, file_name, *args, **kwargs):
            writes.append((name, file_name))
            return fn(ckpt_dir, file_name, *args, **kwargs)
        return save

    saves = {name: getattr(ckpt, name) for name in
             ("save_checkpoint", "save_train_state", "save_checkpoint_incremental")}
    out = {}
    try:
        for name, fn in saves.items():
            setattr(ckpt, name, counted(name, fn))
        for run, run_cfg in (("first", cfg),
                             ("resumed", cfg.replace(resume=True, n_epoch=cfg.n_epoch + 1))):
            trainer, model = _tiny_trainer(run_cfg, data)
            model.train = lambda mode=True, m=model: torch.nn.Module.train(m, False)
            out[f"{run}_start_step"] = trainer.step
            out[run] = trainer.train()
            out[f"{run}_params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    finally:
        for name, fn in saves.items():
            setattr(ckpt, name, fn)
    out["writes"] = writes
    return out


def predictor_worker(rank, dp, cfg_kwargs, tree, requests, sizes):
    """A `Predictor(mesh=)` of the tree's model: its outputs for `requests`,
    twice (the same calls on every rank)."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.serving import Predictor

    pred = Predictor(Config(**cfg_kwargs), params=tree, mesh=_mesh(), **sizes)
    return [pred(requests), pred(requests[:3])]
