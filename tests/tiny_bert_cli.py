"""`cli.train` with the tests' tiny BERT in place of bert-base, on small
synthetic splits: the CLI end to end (flags, torchrun's process group, the
Trainer, the rank-0 writes) at a size the CPU runs in seconds.

    torchrun --standalone --nproc_per_node 2 tests/tiny_bert_cli.py \\
        --device cpu --tp_size 2 --sp True ...        # cli.train's flags
    python tests/tiny_bert_cli.py --device cpu ...    # one process

The BERT is `dp_workers.tp_bert_cfg()` (H = 32, nh = 4, 2 layers) with the
config's `dropout` as its hidden and attention dropout (`--dropout 0` turns
all of the model's dropout off), the config's other BERT options applied by
the Trainer as for bert-base; the splits are `make_dataset(32, 16, 16)`
with BERT ids below its vocabulary.
"""

import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def tiny_data(cfg):
    from mmda_tpu_torch.data.synthetic import make_dataset

    return make_dataset(num_train=32, num_dev=16, num_test=16, max_len=cfg.max_seq_len,
                        bert_vocab_size=128)


def main(argv=None) -> dict:
    from dp_workers import tp_bert_cfg
    from mmda_tpu_torch.cli import train as cli_train
    from mmda_tpu_torch.train import loop

    loop.bert_config_for = lambda cfg: tp_bert_cfg(
        hidden_dropout=cfg.dropout, attention_dropout=cfg.dropout) if cfg.use_bert else None
    cli_train.load_data = lambda cfg: (tiny_data(cfg), None)
    return cli_train.main(argv)


if __name__ == "__main__":
    main()
