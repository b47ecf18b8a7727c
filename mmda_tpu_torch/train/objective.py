"""The training objective (counterpart of `mmda_tpu/train/objective.py`).

total = cls + diff_weight * diff + sim_weight * (cmd if use_cmd_sim else
domain) + recon_weight * recon [+ conf_weight * conf under use_confidNet].

A family without MISA's shared/private factorization (`out.shared_t is
None`: the rest of the zoo) has diff, sim and recon 0, as in the JAX
objective.  `conf` is computed every step for logging, as the reference does, and may be
inf when a class has no positive in the batch; it enters `total` only under
use_confidNet.  The sp logits carry no loss (the reference never adds it).
A family with an auxiliary objective of its own (MMIM's mutual-information
terms) returns it pre-weighted as `out.model_aux["total"]`; it is added to
`total` and reported as `model_aux` (0 for every other family).  A MoE
BERT tower's router losses (`out.moe_aux`) add `moe = moe_aux_weight *
balance + moe_z_weight * router_z` to `total`, and `moe_drop` reports the
share of routes over capacity (both 0 for a dense tower).  The returned
dict has the JAX package's keys.
"""

from __future__ import annotations

from typing import Dict

import torch

from mmda_tpu_torch.ops import losses as L


# The output fields compute_losses reads (a None field is absent): what a
# data-parallel step gathers over the ranks before it (train/step.py).
OUTPUT_FIELDS = ("scores", "tcp", "shared_t", "shared_v", "shared_a", "private_t",
                 "private_v", "private_a", "orig_t", "orig_v", "orig_a", "recon_t",
                 "recon_v", "recon_a", "domain_t", "domain_v", "domain_a")


def compute_losses(cfg, out, batch) -> Dict[str, torch.Tensor]:
    emo = batch.emo_label.float()
    task = cfg.resolved_task()
    if task == "regression":
        cls_loss = torch.mean(torch.abs(out.scores[:, 0] - batch.sentiment))
    else:
        cls_loss = L.bce_sum_over_classes(out.scores, emo)
    zero = cls_loss.new_zeros(())
    if out.shared_t is None:
        diff = sim = recon = zero
    else:
        diff = L.diff_loss_total(out.private_t, out.private_v, out.private_a,
                                 out.shared_t, out.shared_v, out.shared_a)
        recon = L.recon_loss_total(out.recon_t, out.orig_t, out.recon_v, out.orig_v,
                                   out.recon_a, out.orig_a)
        if cfg.use_cmd_sim:
            sim = L.cmd_loss_total(out.shared_t, out.shared_v, out.shared_a)
        else:
            sim = L.domain_loss(out.domain_t, out.domain_v, out.domain_a)
    if task == "regression":
        conf = zero
    else:
        conf = L.conf_loss(out.scores, emo, out.tcp, fix=cfg.fix_conf_loss)
    total = (cls_loss + cfg.diff_weight * diff + cfg.sim_weight * sim
             + cfg.recon_weight * recon)
    if cfg.use_confidNet:
        total = total + cfg.conf_weight * conf
    moe = moe_drop = zero
    if out.moe_aux is not None:
        moe = (cfg.moe_aux_weight * out.moe_aux["balance"]
               + cfg.moe_z_weight * out.moe_aux["router_z"])
        total = total + moe
        moe_drop = out.moe_aux["drop_frac"]
    model_aux = zero
    if out.model_aux is not None:
        model_aux = out.model_aux["total"]
        total = total + model_aux
    return {"total": total, "cls": cls_loss, "diff": diff, "sim": sim,
            "recon": recon, "conf": conf, "moe": moe, "moe_drop": moe_drop,
            "model_aux": model_aux}
