"""Export a trained checkpoint as serving artifacts:
`python -m mmda_tpu_torch.cli.export --ckpt_dir ... --export_dir out/`.

Counterpart of `mmda_tpu/cli/export.py`: loads the splits (for the stream
widths and the GloVe vocab size), the best-on-dev export
`{ckpt_dir}/best_model_...msgpack`, a WordPiece tokenizer from
`--vocab_file` and the ETL's `vocab.tsv` word ids when there are any, and
writes one `torch.export` program per bucket at `max_batch = --batch_size`
(`serving_export.py`), for `--device` (the card by default).
`--export_weights_dtype int8` quantizes the BERT denses.
"""

from __future__ import annotations

import os


def main(argv=None) -> dict:
    from mmda_tpu_torch.cli.train import load_data
    from mmda_tpu_torch.config import get_config
    from mmda_tpu_torch.models.bert import bert_config_for
    from mmda_tpu_torch.serving_export import export_model
    from mmda_tpu_torch.train import checkpoint as ckpt

    cfg = get_config(argv=argv)
    if not cfg.export_dir:
        raise SystemExit("--export_dir is required")
    data, _ = load_data(cfg)
    split = data["test"]
    name = ckpt.best_model_name(cfg)
    if not ckpt.checkpoint_exists(cfg.ckpt_dir, name):
        raise SystemExit(f"no checkpoint {name!r} under {cfg.ckpt_dir}")
    params = ckpt.load_checkpoint(cfg.ckpt_dir, name)

    tokenizer = None
    if cfg.vocab_file:
        from mmda_tpu_torch.data.etl.tokenizer import WordPieceTokenizer

        tokenizer = WordPieceTokenizer.from_vocab_file(cfg.vocab_file)
    word2id = None
    if cfg.data != "synthetic":
        from mmda_tpu_torch.data.etl.vocab import Vocab

        w2_path = os.path.join(cfg.data_dir, cfg.data.upper(), "vocab.tsv")
        if os.path.exists(w2_path):
            word2id = Vocab.load(w2_path).word2id

    manifest = export_model(
        cfg, params, cfg.export_dir, bert_cfg=bert_config_for(cfg),
        visual_size=split["visual"].shape[-1], acoustic_size=split["acoustic"].shape[-1],
        max_batch=cfg.batch_size, tokenizer=tokenizer, word2id=word2id,
        weights_dtype=cfg.export_weights_dtype)
    print(f"exported {manifest['model']} -> {cfg.export_dir} "
          f"(buckets {manifest['bucket_sizes']}, max_batch "
          f"{manifest['max_batch']})")
    return manifest


if __name__ == "__main__":
    main()
