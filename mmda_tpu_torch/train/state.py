"""The optimizer: element-wise value clip, then Adam (or AdamW, RMSprop, SGD).

Counterpart of `mmda_tpu/train/state.py::make_optimizer`, written out in
PyTorch so that each rule computes what its optax chain computes:

* `optax.clip(cfg.clip)`: every gradient element clamped to +-clip (a value
  clip, torch's `clip_grad_value_`, not a norm clip);
* `add_decayed_weights` (g + weight_decay * p) when apply_weight_decay, for
  every rule but AdamW;
* Adam: b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments; the first moment
  is stored in `adam_mu_dtype` while the update uses it before that cast
  (optax `mu_dtype`); AdamW adds weight_decay * p to the Adam direction;
  RMSprop: decay 0.99, g / sqrt(nu + eps), no bias correction (optax's
  default `eps_in_sqrt`); SGD: plain;
* the learning rate of update n (n = 0, 1, ...): `none` constant,
  `exponential` staircase decay per epoch floored at min_lr, `cosine` linear
  warmup then cosine decay to min_lr over the run, `plateau` a value the
  trainer lowers (`set_learning_rate`).

Only the parameters handed in are updated, and only they carry state: the
trainer passes the trainable ones, so frozen parameters get no moments and
no update (optax `set_to_zero` under `multi_transform`).  Updates are in
place, with multi-tensor (`torch._foreach_*`) operations.

An update is two halves, so that a CUDA graph can hold the second:
`advance()` on the host counts the update and writes its scalars (-lr and
Adam's bias corrections 1 - b ** count, each rounded to f32 as a Python
scalar of an f32 operation is) into the small device tensor `scalars`, in
place; `apply(grads)` is device work only and reads them there.  `step` is
the two in turn, so an eager update and a replayed one share their
arithmetic, and a schedule or `set_learning_rate` takes effect at the next
update either way.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.99, 1e-8


class Optimizer:
    def __init__(self, cfg, params: Sequence[torch.Tensor],
                 steps_per_epoch: Optional[int] = None):
        if cfg.lr_schedule in ("exponential", "cosine") and not steps_per_epoch:
            raise ValueError(
                f"lr_schedule={cfg.lr_schedule!r} needs steps_per_epoch to size "
                "its decay horizon; pass steps_per_epoch=len(train_loader)")
        if cfg.optimizer not in ("Adam", "AdamW", "RMSprop", "SGD"):
            raise ValueError(cfg.optimizer)
        self.cfg = cfg
        self.params: List[torch.Tensor] = list(params)
        self.steps_per_epoch = steps_per_epoch
        self.count = 0                        # updates applied so far
        self.lr = cfg.learning_rate           # the plateau schedule's value
        device = self.params[0].device if self.params else torch.device("cpu")
        self.scalars = torch.zeros(3, device=device)    # -lr, 1 - B1**n, 1 - B2**n
        zeros = [torch.zeros_like(p) for p in self.params]
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []
        if cfg.optimizer in ("Adam", "AdamW"):
            mu_dtype = getattr(torch, cfg.adam_mu_dtype)
            self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
            self.nu = zeros
        elif cfg.optimizer == "RMSprop":
            self.nu = zeros

    def learning_rate(self, count: Optional[int] = None) -> float:
        """The learning rate of update number `count` (default: the next)."""
        cfg = self.cfg
        n = self.count if count is None else count
        if cfg.lr_schedule == "plateau":
            return self.lr
        if cfg.lr_schedule == "exponential":
            if n <= 0:
                return cfg.learning_rate
            lr = cfg.learning_rate * cfg.lr_decay_rate ** (n // self.steps_per_epoch)
            return max(lr, cfg.min_lr) if cfg.lr_decay_rate < 1.0 else min(lr, cfg.min_lr)
        if cfg.lr_schedule == "cosine":
            total = max(self.steps_per_epoch * cfg.n_epoch, cfg.warmup_steps + 1)
            if n < cfg.warmup_steps:
                return cfg.learning_rate * n / cfg.warmup_steps
            decay_steps = total - cfg.warmup_steps
            k = min(n - cfg.warmup_steps, decay_steps)
            alpha = cfg.min_lr / cfg.learning_rate
            cosine = 0.5 * (1.0 + math.cos(math.pi * k / decay_steps))
            return cfg.learning_rate * ((1.0 - alpha) * cosine + alpha)
        return cfg.learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.lr = lr

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of every parameter from its gradient (same order)."""
        self.advance()
        self.apply(grads)

    def advance(self) -> None:
        """The host half of the next update: count it and write its scalars
        into `scalars` (launches, no read back)."""
        lr = self.learning_rate()
        self.count += 1
        if not self.params:
            return
        self.scalars[0].fill_(-lr)
        if self.mu:
            self.scalars[1].fill_(1.0 - B1 ** self.count)
            self.scalars[2].fill_(1.0 - B2 ** self.count)

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor]) -> None:
        """The device half: the update `advance` prepared, from each
        parameter's gradient (same order)."""
        cfg = self.cfg
        g = [x.float() for x in grads]
        if len(g) != len(self.params):
            raise ValueError(f"{len(g)} gradients for {len(self.params)} parameters")
        if not g:
            return
        torch._foreach_clamp_min_(g, -cfg.clip)
        torch._foreach_clamp_max_(g, cfg.clip)
        if cfg.apply_weight_decay and cfg.optimizer != "AdamW":
            torch._foreach_add_(g, self.params, alpha=cfg.weight_decay)
        if cfg.optimizer in ("Adam", "AdamW"):
            update = self._adam(g)
            if cfg.optimizer == "AdamW":
                torch._foreach_add_(update, self.params, alpha=cfg.weight_decay)
        elif cfg.optimizer == "RMSprop":
            torch._foreach_mul_(self.nu, RMS_DECAY)
            torch._foreach_addcmul_(self.nu, g, g, value=1.0 - RMS_DECAY)
            update = torch._foreach_mul(g, torch._foreach_rsqrt(
                torch._foreach_add(self.nu, RMS_EPS)))
        else:
            update = g
        torch._foreach_mul_(update, self.scalars[0])       # optax: -lr * u, then p + u
        torch._foreach_add_(self.params, update)

    def _adam(self, g: List[torch.Tensor]) -> List[torch.Tensor]:
        f32 = self.mu[0].dtype == torch.float32
        if f32:
            mu = self.mu
            torch._foreach_mul_(mu, B1)
        else:   # optax: b1 (rounded to mu's dtype) * mu in mu's dtype, then the f32 sum
            b1 = torch.tensor(B1, dtype=self.mu[0].dtype).item()
            mu = [m.float() for m in torch._foreach_mul(self.mu, b1)]
        torch._foreach_add_(mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - B2)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, self.scalars[2]))
        torch._foreach_add_(denom, ADAM_EPS)
        update = torch._foreach_div(torch._foreach_div(mu, self.scalars[1]), denom)
        if not f32:
            for stored, m in zip(self.mu, mu):
                stored.copy_(m)
        return update


def trainable_param_count(model: torch.nn.Module) -> dict:
    total = sum(p.numel() for p in model.parameters())
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    return {"total": total, "trainable": trainable}
