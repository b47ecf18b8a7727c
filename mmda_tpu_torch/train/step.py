"""One training step and one eval step.

Counterpart of `mmda_tpu/train/step.py` (`make_train_step`,
`_make_eval_body`).  PyTorch runs eagerly, so a step is a function over the
model, the optimizer and a batch already on the device; its results stay on
the device until the caller reads them (the trainer reads an epoch's losses
in one copy).

* `train_step`: modality-keep sampling (train-time random modality dropout
  on top of the static `missing_modality` setting), the forward with
  dropout on, the objective, the gradients of the trainable parameters (the
  frozen ones have requires_grad False, so autograd computes no weight
  gradient for them, as `_stop_frozen` prunes them in JAX), `grad_norm` over
  those gradients before the clip, the optimizer update, the EMA shadow.
* `eval_step`: the deterministic forward with the static modality setting,
  and the same outputs as `_make_eval_body`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from mmda_tpu_torch.ops import losses as L
from mmda_tpu_torch.train.objective import compute_losses


def static_modality_keep(cfg, batch_size: int, device) -> Optional[torch.Tensor]:
    """(B, 3) keep mask of the static missing_modality setting, or None."""
    if cfg.missing_modality == "none":
        return None
    keep = torch.ones(batch_size, 3, device=device)
    if cfg.missing_modality in ("visual", "both"):
        keep[:, 1] = 0.0
    if cfg.missing_modality in ("acoustic", "both"):
        keep[:, 2] = 0.0
    return keep


def sample_modality_keep(cfg, batch_size: int, device,
                         generator: Optional[torch.Generator] = None
                         ) -> Optional[torch.Tensor]:
    """With probability missing_modality_prob, zero the visual and the
    acoustic stream of each example independently; text is always kept."""
    static = static_modality_keep(cfg, batch_size, device)
    if cfg.missing_modality_prob <= 0.0:
        return static
    u = torch.rand(2, batch_size, generator=generator, device=device)
    keep_va = (u < 1.0 - cfg.missing_modality_prob).float()
    keep = torch.stack([torch.ones(batch_size, device=device), keep_va[0], keep_va[1]],
                       dim=1)
    return keep if static is None else keep * static


def ema_update(ema: Optional[List[torch.Tensor]], params: List[torch.Tensor],
               decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place."""
    if not ema or decay <= 0.0:
        return
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, params, alpha=1.0 - decay)


def loss_and_grads(model, batch, cfg, params: List[torch.Tensor],
                   modality_keep: Optional[torch.Tensor] = None, recurrence=None,
                   generator: Optional[torch.Generator] = None):
    """The objective of one forward in the model's current mode (dropout
    only under train()) and its gradients w.r.t. `params`.  A parameter no
    loss reaches (the sp discriminator) gets a zero gradient, as jax.grad
    gives it."""
    out = model(batch, modality_keep, recurrence, generator)
    losses = compute_losses(cfg, out, batch)
    grads = torch.autograd.grad(losses["total"], params, allow_unused=True,
                                materialize_grads=True)
    return losses, grads


def train_step(model, optimizer, batch, cfg,
               generator: Optional[torch.Generator] = None,
               ema: Optional[List[torch.Tensor]] = None,
               recurrence=None) -> Dict[str, torch.Tensor]:
    """One update; returns the loss dict plus grad_norm, as 0-dim device
    tensors.  `ema` is the shadow of `model.parameters()` (same order)."""
    model.train()
    keep = sample_modality_keep(cfg, batch.emo_label.shape[0], batch.emo_label.device,
                                generator)
    losses, grads = loss_and_grads(model, batch, cfg, optimizer.params, keep,
                                   recurrence, generator)
    grad_norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([g.float() for g in grads])))
    optimizer.step(grads)
    if ema:
        ema_update(ema, [p.detach() for p in model.parameters()], cfg.ema_decay)
    result = {k: v.detach() for k, v in losses.items()}
    result["grad_norm"] = grad_norm
    return result


@torch.no_grad()
def eval_step(model, batch, cfg) -> Dict[str, torch.Tensor]:
    """Deterministic forward: scores, labels, tcp, the batch's cls loss and
    the per-example (per-class) loss the trainer averages over real rows."""
    model.eval()
    keep = static_modality_keep(cfg, batch.emo_label.shape[0], batch.emo_label.device)
    out = model(batch, keep)
    if cfg.resolved_task() == "regression":
        err = torch.abs(out.scores[:, 0] - batch.sentiment)
        cls_loss = err.mean()
        bce = err[:, None]
    else:
        cls_loss = L.bce_sum_over_classes(out.scores, batch.emo_label)
        p, t = out.scores.float(), batch.emo_label.float()
        bce = -(t * L.log_clamped(p) + (1.0 - t) * L.log_clamped(1.0 - p))
    return {"scores": out.scores, "labels": out.labels, "tcp": out.tcp,
            "cls_loss": cls_loss, "bce": bce}
