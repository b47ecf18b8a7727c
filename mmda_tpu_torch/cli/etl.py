"""Offline ETL: `python -m mmda_tpu_torch.cli.etl`.

Counterpart of `mmda_tpu/cli/etl.py`, with the same flags: builds a
corpus's fixed-shape `{train,dev,test}.npz` splits, its `vocab.tsv` and,
with `--word_emb_path`, its GloVe matrix `glove_emb.npy`, once, into
`{data_dir}/{DATA}` (or `--out_dir`), where `python -m
mmda_tpu_torch.cli.train --data DATA --data_dir ...` reads them.  MOSI and
MOSEI come from `.csd` files on disk (read with h5py, with the fold lists in
`standard_folds.json`) unless mmsdk is installed; UR_FUNNY from its SDK
pickles.  Host code only: it needs no card.

Usage:
  python -m mmda_tpu_torch.cli.etl --data mosei --data_dir /data/multimodal \
      --word_emb_path /data/glove.840B.300d.txt \
      --bert_vocab /data/bert-base-uncased/vocab.txt
  python -m mmda_tpu_torch.cli.etl --data ur_funny --data_dir /data/multimodal
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="mmda_tpu_torch offline ETL")
    ap.add_argument("--data", required=True,
                    choices=["mosi", "mosei", "mosei_unaligned", "ur_funny"])
    ap.add_argument("--data_dir", default="./datasets")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--sdk_dir", default=None)
    ap.add_argument("--word_emb_path", default=None)
    ap.add_argument("--bert_vocab", default=None)
    ap.add_argument("--max_len", type=int, default=64)
    args = ap.parse_args(argv)

    from mmda_tpu_torch.data.etl.datasets import build_dataset

    splits = build_dataset(
        args.data, args.data_dir, out_dir=args.out_dir, sdk_dir=args.sdk_dir,
        word_emb_path=args.word_emb_path, bert_vocab_path=args.bert_vocab,
        max_len=args.max_len,
    )
    for name, arrays in splits.items():
        print(f"{name}: {len(arrays['lengths'])} segments, "
              f"visual={arrays['visual'].shape[-1]}d, "
              f"acoustic={arrays['acoustic'].shape[-1]}d")
    return splits


if __name__ == "__main__":
    main()
