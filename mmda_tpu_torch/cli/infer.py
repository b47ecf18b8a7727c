"""Scoring entry: `python -m mmda_tpu_torch.cli.infer`.

Counterpart of `mmda_tpu/cli/infer.py`, with the same flags (the fields of
`mmda_tpu_torch.config.Config`).  Loads the best-on-dev export training wrote
(`{ckpt_dir}/best_model_*.msgpack`, the JAX package's format, from either
trainer), scores a split in batches of `--batch_size` rows in file order,
prints the emotion metrics and writes
`{ckpt_dir}/predictions_{name}_{mode}.npz` with the arrays `scores`,
`labels`, `truths`, `tcp` and `hidden` (the fused [private_t, private_v,
private_a, shared_t, shared_v, shared_a] vectors), one row per real example.
It runs on the card by default; `--device cpu` is the only way onto the CPU.

Usage:
  python -m mmda_tpu_torch.cli.infer --data mosei --mode test
  python -m mmda_tpu_torch.cli.infer --data synthetic --mode test --missing_modality visual
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def main(argv=None) -> dict:
    from mmda_tpu_torch.cli.train import load_data
    from mmda_tpu_torch.config import get_config, resolve_device, set_reference_numerics
    from mmda_tpu_torch.convert import load_jax_params
    from mmda_tpu_torch.data.loader import ArrayLoader, to_device
    from mmda_tpu_torch.models import get_model
    from mmda_tpu_torch.models.bert import bert_config_for
    from mmda_tpu_torch.train import checkpoint as ckpt
    from mmda_tpu_torch.train.step import static_modality_keep
    from mmda_tpu_torch.utils.metrics import get_accuracy, get_metrics

    cfg = get_config(argv=argv)
    device = resolve_device(cfg.device)
    if device.type == "cuda":
        set_reference_numerics()
    data, _ = load_data(cfg)
    split = data[cfg.mode if cfg.mode in data else "test"]

    name = ckpt.best_model_name(cfg)
    if not ckpt.checkpoint_exists(cfg.ckpt_dir, name):
        raise FileNotFoundError(
            f"{cfg.ckpt_dir}/{name}.msgpack not found - train first "
            f"(python -m mmda_tpu_torch.cli.train --data {cfg.data})")
    tree = ckpt.load_checkpoint(cfg.ckpt_dir, name)
    # the word table is as large as training made it, whatever ids this split holds
    vocab_size = (tree["embed"].shape[0] if "embed" in tree
                  else int(split["text"].max()) + 1)
    model = get_model(cfg.model)(
        cfg, visual_size=split["visual"].shape[-1],
        acoustic_size=split["acoustic"].shape[-1],
        vocab_size=vocab_size, bert_cfg=bert_config_for(cfg), device="cpu")
    model = load_jax_params(model, tree).to(device).eval()

    loader = ArrayLoader(split, batch_size=cfg.batch_size, shuffle=False, device=device)
    parts = {k: [] for k in ("scores", "labels", "tcp", "hidden")}
    truths = []
    for host in loader.host_batches():
        batch = to_device(host, device)
        keep = static_modality_keep(cfg, batch.emo_label.shape[0], device)
        with torch.inference_mode():
            out = model(batch, keep)
            # the hidden export sees every modality, as the JAX package's does
            full = out if keep is None else model(batch)
            hidden = torch.cat([full.private_t, full.private_v, full.private_a,
                                full.shared_t, full.shared_v, full.shared_a], dim=1)
            found = {"scores": out.scores, "labels": out.labels, "tcp": out.tcp,
                     "hidden": hidden}
            widths = [v.shape[1] for v in found.values()]
            # one device-to-host copy per batch
            packed = torch.cat([v.float() for v in found.values()], dim=1).cpu().numpy()
        w = np.asarray(host["sample_weight"]) > 0
        cols = np.cumsum([0] + widths)
        for i, k in enumerate(found):
            parts[k].append(packed[w, cols[i]:cols[i + 1]])
        truths.append(np.asarray(host["emo_label"])[w])
    arrays = {k: np.concatenate(v) for k, v in parts.items()}
    arrays["truths"] = np.concatenate(truths)

    metrics = get_metrics(arrays["truths"], arrays["labels"])
    metrics["acc"] = get_accuracy(arrays["truths"], arrays["labels"])
    print(json.dumps(metrics, indent=2, default=float))

    out_path = os.path.join(cfg.ckpt_dir, f"predictions_{cfg.name}_{cfg.mode}.npz")
    np.savez_compressed(out_path, **arrays)
    print(f"predictions written to {out_path}")
    return metrics


if __name__ == "__main__":
    main()
