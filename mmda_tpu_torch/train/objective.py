"""The training objective (counterpart of `mmda_tpu/train/objective.py`).

total = cls + diff_weight * diff + sim_weight * (cmd if use_cmd_sim else
domain) + recon_weight * recon [+ conf_weight * conf under use_confidNet].

`conf` is computed every step for logging, as the reference does, and may be
inf when a class has no positive in the batch; it enters `total` only under
use_confidNet.  The sp logits carry no loss (the reference never adds it).
The returned dict has the JAX package's keys; `moe`, `moe_drop` and
`model_aux` are 0 (the port has no MoE tower or auxiliary-objective model).
"""

from __future__ import annotations

from typing import Dict

import torch

from mmda_tpu_torch.ops import losses as L


def compute_losses(cfg, out, batch) -> Dict[str, torch.Tensor]:
    emo = batch.emo_label.float()
    task = cfg.resolved_task()
    if task == "regression":
        cls_loss = torch.mean(torch.abs(out.scores[:, 0] - batch.sentiment))
    else:
        cls_loss = L.bce_sum_over_classes(out.scores, emo)
    diff = L.diff_loss_total(out.private_t, out.private_v, out.private_a,
                             out.shared_t, out.shared_v, out.shared_a)
    recon = L.recon_loss_total(out.recon_t, out.orig_t, out.recon_v, out.orig_v,
                               out.recon_a, out.orig_a)
    if cfg.use_cmd_sim:
        sim = L.cmd_loss_total(out.shared_t, out.shared_v, out.shared_a)
    else:
        sim = L.domain_loss(out.domain_t, out.domain_v, out.domain_a)
    zero = cls_loss.new_zeros(())
    if task == "regression":
        conf = zero
    else:
        conf = L.conf_loss(out.scores, emo, out.tcp, fix=cfg.fix_conf_loss)
    total = (cls_loss + cfg.diff_weight * diff + cfg.sim_weight * sim
             + cfg.recon_weight * recon)
    if cfg.use_confidNet:
        total = total + cfg.conf_weight * conf
    return {"total": total, "cls": cls_loss, "diff": diff, "sim": sim,
            "recon": recon, "conf": conf, "moe": zero, "moe_drop": zero,
            "model_aux": zero}
