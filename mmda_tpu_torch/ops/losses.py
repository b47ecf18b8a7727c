"""Training losses, vectorized.

Counterpart of `mmda_tpu/ops/losses.py`, function for function and with the
same numerics (f32, torch BCELoss's -100 log clamp):

  * `bce`, `bce_sum_over_classes` - the cls loss: per-class BCE (batch mean)
    summed over the emotion columns;
  * `diff_loss`, `diff_loss_total` - DSN orthogonality over the 6 pairs;
  * `cmd_loss`, `cmd_loss_total` - central moment discrepancy, k=5;
  * `softmax_cross_entropy_int`, `domain_loss` - adversarial domain CE;
  * `mse`, `simse`, `recon_loss_total` - reconstruction;
  * `conf_loss` - ConfidNet loss, with the reference's batch-axis soft CE
    (fix=False, inf when a class has no positive) or the fixed form.
"""

from __future__ import annotations

import torch


def log_clamped(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.log(torch.clamp(p, min=0.0)), min=-100.0)


def bce(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCELoss(reduction='mean') on probabilities."""
    p, t = probs.float(), targets.float()
    return -torch.mean(t * log_clamped(p) + (1.0 - t) * log_clamped(1.0 - p))


def bce_sum_over_classes(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-class BCE (mean over the batch), summed over classes; (B, C)."""
    p, t = scores.float(), labels.float()
    per_class = -torch.mean(t * log_clamped(p) + (1.0 - t) * log_clamped(1.0 - p), dim=0)
    return per_class.sum()


def diff_loss(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-mean over the batch, rows L2-normalized by a detached norm
    + 1e-6, then the mean of the squared Gram matrix x1^T x2."""
    b = x1.shape[0]
    x1 = torch.nan_to_num(x1.reshape(b, -1).float())
    x2 = torch.nan_to_num(x2.reshape(b, -1).float())
    x1 = x1 - x1.mean(dim=0, keepdim=True)
    x2 = x2 - x2.mean(dim=0, keepdim=True)
    n1 = torch.linalg.norm(x1, dim=1, keepdim=True).detach()
    n2 = torch.linalg.norm(x2, dim=1, keepdim=True).detach()
    x1 = x1 / (n1 + 1e-6)
    x2 = x2 / (n2 + 1e-6)
    return torch.mean(torch.matmul(x1.t(), x2) ** 2)


def diff_loss_total(private_t, private_v, private_a, shared_t, shared_v, shared_a):
    """Sum over the 6 pairs the reference uses."""
    return (diff_loss(private_t, shared_t) + diff_loss(private_v, shared_v)
            + diff_loss(private_a, shared_a) + diff_loss(private_a, private_t)
            + diff_loss(private_a, private_v) + diff_loss(private_t, private_v))


def _matchnorm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum((a - b) ** 2) ** 0.5


def cmd_loss(x1: torch.Tensor, x2: torch.Tensor, n_moments: int = 5) -> torch.Tensor:
    """Central Moment Discrepancy."""
    x1, x2 = x1.float(), x2.float()
    m1, m2 = x1.mean(dim=0), x2.mean(dim=0)
    s1, s2 = x1 - m1, x2 - m2
    out = _matchnorm(m1, m2)
    for k in range(2, n_moments + 1):
        out = out + _matchnorm((s1 ** k).mean(dim=0), (s2 ** k).mean(dim=0))
    return out


def cmd_loss_total(shared_t, shared_v, shared_a, n_moments: int = 5):
    """Average over the 3 shared pairs: (t, v) + (t, a) + (a, v), / 3."""
    return (cmd_loss(shared_t, shared_v, n_moments) + cmd_loss(shared_t, shared_a, n_moments)
            + cmd_loss(shared_a, shared_v, n_moments)) / 3.0


def softmax_cross_entropy_int(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss(reduction='mean') with integer labels."""
    logz = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logz, -1, labels[:, None].long())[:, 0].mean()


def domain_loss(domain_t, domain_v, domain_a) -> torch.Tensor:
    """CE over the stacked (3B, 3) domain logits, labels t=0, v=1, a=2."""
    logits = torch.cat([domain_t, domain_v, domain_a], dim=0)
    b = domain_t.shape[0]
    labels = torch.arange(3, device=logits.device).repeat_interleave(b)
    return softmax_cross_entropy_int(logits, labels)


def mse(pred: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    d = real.float() - pred.float()
    return torch.mean(d ** 2)


def simse(pred: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Scale-invariant MSE."""
    d = real.float() - pred.float()
    return torch.sum(d) ** 2 / (d.numel() ** 2)


def recon_loss_total(recon_t, orig_t, recon_v, orig_v, recon_a, orig_a):
    """MSE averaged over the 3 modalities."""
    return (mse(recon_t, orig_t) + mse(recon_v, orig_v) + mse(recon_a, orig_a)) / 3.0


def conf_loss(pred: torch.Tensor, truth: torch.Tensor, tcp: torch.Tensor,
              fix: bool = False, eps: float = 1e-8) -> torch.Tensor:
    """ConfidNet loss over (B, C).  fix=False reproduces the reference: per
    class, MSE(tcp, truth * pred) plus a soft CE over the BATCH axis, each
    divided by the class's positive count (inf when it is 0).  fix=True
    uses per-class BCE and clamps the count at 1."""
    pred, truth, tcp = pred.float(), truth.float(), tcp.float()
    counts = (truth != 0.0).sum(dim=0).float()
    tcp_mse = torch.mean((tcp - truth * pred) ** 2, dim=0)
    if fix:
        denom = torch.clamp(counts, min=1.0)
        log_p = torch.clamp(torch.log(torch.clamp(pred, min=eps)), min=-100.0)
        log_1p = torch.clamp(torch.log(torch.clamp(1.0 - pred, min=eps)), min=-100.0)
        mcp = -torch.mean(truth * log_p + (1.0 - truth) * log_1p, dim=0)
        return torch.sum(tcp_mse / denom) + torch.sum(mcp / denom)
    logz = torch.log_softmax(pred, dim=0)
    soft_ce = -torch.sum(truth * logz, dim=0)
    return torch.sum(tcp_mse / counts) + torch.sum(soft_ce / counts)
