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

`grad_accum_steps` = k > 1 is `optax.MultiSteps` around that chain: every
call of `apply` folds its gradient into a running mean kept in f32,
`acc <- acc + (g - acc) / (n + 1)` for the n-th mini-step of an update
(n = 0 .. k-1), and only the k-th passes the mean through the clip and the
rule, then zeroes `acc`; the other mini-steps leave the parameters as they
are.  `count`, and with it Adam's bias corrections and every schedule,
advances on the k-th mini-step only, so `exponential`'s per-epoch decay is
counted in updates (one every k epochs), as in the JAX package.  `advance()`
writes the divisor n + 1 into `scalars` and returns whether the mini-step
applies (`emit`); `apply` branches on that host flag, so a captured step
needs two graphs per batch shape, one that accumulates and one that also
applies (`train/step.py::StepGraphs`).

`state_dict()` / `load_state_dict()` carry everything an update reads
besides the parameters (the moments, the accumulators, count, mini_step
and the plateau rate), loading into the existing tensors in place.
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
        self.k = max(int(cfg.grad_accum_steps), 1)
        self.mini_step = 0                    # mini-steps folded into acc so far
        self.emit = True                      # whether the prepared mini-step applies
        device = self.params[0].device if self.params else torch.device("cpu")
        # -lr, 1 - B1**n, 1 - B2**n, the running mean's divisor n + 1
        self.scalars = torch.zeros(4, device=device)
        self.acc: List[torch.Tensor] = (
            [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            if self.k > 1 else [])
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
        """One mini-step from every parameter's gradient (same order): an
        update, or with grad_accum_steps > 1 a fold into the running mean."""
        self.advance()
        self.apply(grads)

    def advance(self) -> bool:
        """The host half of the next mini-step: write its scalars into
        `scalars` (launches, no read back) and, when it applies the update,
        count the update.  Returns `emit`, whether it applies."""
        n = self.mini_step
        self.emit = n == self.k - 1
        self.mini_step = (n + 1) % self.k
        if self.k > 1 and self.params:
            self.scalars[3].fill_(float(n + 1))
        if not self.emit:
            return False
        lr = self.learning_rate()
        self.count += 1
        if not self.params:
            return True
        self.scalars[0].fill_(-lr)
        if self.mu:
            self.scalars[1].fill_(1.0 - B1 ** self.count)
            self.scalars[2].fill_(1.0 - B2 ** self.count)
        return True

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor]) -> None:
        """The device half: the mini-step `advance` prepared, from each
        parameter's gradient (same order)."""
        cfg = self.cfg
        g = [x.float() for x in grads]
        if len(g) != len(self.params):
            raise ValueError(f"{len(g)} gradients for {len(self.params)} parameters")
        if not g:
            return
        if self.acc:                    # optax MultiSteps: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(g, self.acc)
            torch._foreach_div_(delta, self.scalars[3])
            torch._foreach_add_(self.acc, delta)
            if not self.emit:
                return
            g = [a.clone() for a in self.acc]
            torch._foreach_zero_(self.acc)
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
        else:   # optax as XLA runs it: b1 rounded to mu's dtype, its product
            # with mu and the sum in f32, one rounding to mu's dtype at the store
            b1 = torch.tensor(B1, dtype=self.mu[0].dtype).item()
            mu = [m.float() for m in self.mu]
            torch._foreach_mul_(mu, b1)
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


    def state_dict(self) -> dict:
        """The optimizer's state besides the parameters: host scalars and
        device tensors (the moments and accumulators, in `params` order)."""
        return {"count": self.count, "lr": self.lr, "mini_step": self.mini_step,
                "mu": list(self.mu), "nu": list(self.nu), "acc": list(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s values into this optimizer's own tensors
        (copy_, so a captured graph that reads them stays valid)."""
        for key in ("mu", "nu", "acc"):
            mine, theirs = getattr(self, key), state[key]
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state {key!r}: {len(theirs)} tensors for "
                                 f"{len(mine)}")
            for t, v in zip(mine, theirs):
                if tuple(t.shape) != tuple(v.shape):
                    raise ValueError(f"optimizer state {key!r}: shape {tuple(v.shape)} "
                                     f"for {tuple(t.shape)}")
                t.copy_(v)
        self.count, self.lr = int(state["count"]), float(state["lr"])
        self.mini_step = int(state["mini_step"]) % self.k


def trainable_param_count(model: torch.nn.Module) -> dict:
    total = sum(p.numel() for p in model.parameters())
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    return {"total": total, "trainable": trainable}
