"""Run configuration of the PyTorch port.

The port's own copy of `mmda_tpu.config.Config`: the same field names and
defaults, so a config JSON written by the JAX trainer loads here unchanged.
Differences:

* `device` defaults to "cuda".  Entry points run on the card unless the
  caller asks for "cpu"; asking for "cuda" where there is none raises
  (`resolve_device`), the port never falls back to the CPU on its own.
  A saved run config's `device` is not loaded by `--config_json`.
* Knobs that only steer TPU code (Pallas routing, rbg PRNG, relay-friendly
  epoch scans) are kept as inert fields so that saved configs keep
  parsing; nothing in the port reads them.  Parallel modes the port does
  not run yet are refused by its trainer (`train/loop.py::unsupported`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


ACTIVATIONS = ("elu", "hardshrink", "hardtanh", "leakyrelu", "prelu", "relu",
               "rrelu", "tanh")
OPTIMIZERS = ("Adam", "RMSprop", "AdamW", "SGD")
DATASETS = ("mosi", "mosei", "ur_funny", "synthetic")
EVAL_MODES = ("macro", "micro", "weighted")

MOSI_HP = {"activation": "relu", "batch_size": 64, "sim_weight": 1.0,
           "diff_weight": 0.3, "recon_weight": 1.0, "dropout": 0.5}
MOSEI_HP = {"activation": "leakyrelu", "batch_size": 16, "sim_weight": 0.7,
            "diff_weight": 0.3, "recon_weight": 0.7, "dropout": 0.1,
            "embedding_size": 300, "visual_size": 35, "acoustic_size": 74}
DATASET_HP = {"mosi": MOSI_HP, "mosei": MOSEI_HP}


@dataclass(frozen=True)
class Config:
    # Mode
    mode: str = "train"
    runs: int = 5
    use_confidNet: bool = False
    confid_two_stage: bool = False
    n_epoch_stage2: int = 10
    device: str = "cuda"          # "cuda" | "cuda:N" | "cpu"
    eval_mode: str = "macro"

    # Bert
    use_bert: bool = True
    use_cmd_sim: bool = True

    # Data
    data: str = "mosei"

    # Train
    name: str = "run"
    num_classes: int = 6
    batch_size: int = 64
    eval_batch_size: int = 10
    n_epoch: int = 40
    patience: int = 6
    diff_weight: float = 0.3
    sim_weight: float = 0.7
    sp_weight: float = 0.0
    recon_weight: float = 0.7
    conf_weight: float = 0.3
    learning_rate: float = 1e-4
    optimizer: str = "Adam"
    grad_accum_steps: int = 1
    lr_schedule: str = "none"
    lr_decay_rate: float = 0.5
    lr_plateau_patience: int = 5
    min_lr: float = 1e-6
    warmup_steps: int = 0
    clip: float = 1.0
    weight_decay: float = 0.1
    apply_weight_decay: bool = False
    extractor: str = "lstm"
    rnncell: str = "lstm"
    embedding_size: int = 300
    hidden_size: int = 128
    dropout: float = 0.1
    reverse_grad_weight: float = 1.0
    activation: str = "leakyrelu"
    threshold: float = 0.35

    # Model
    model: str = "MISA"
    apply_dataset_hp: bool = False
    use_label_decoder: bool = False
    mult_d: int = 40
    mult_layers: int = 4
    mult_heads: int = 5
    mult_conv_kernel: int = 3
    lmf_rank: int = 4
    tfn_post_dim: int = 16
    mag_inject_layer: int = 1
    mag_beta: float = 1.0
    mag_dropout: float = 0.5
    task: str = "auto"

    # Data / shapes
    seed: int = 336
    data_dir: str = "./datasets"
    word_emb_path: Optional[str] = None
    sdk_dir: Optional[str] = None
    bert_model_dir: Optional[str] = None
    max_seq_len: int = 64
    bucket_sizes: Tuple[int, ...] = (16, 32, 64)
    prefetch: int = 2
    ckpt_interval: int = 1
    ckpt_incremental: bool = True
    ckpt_backend: str = "msgpack"

    # Serving
    port: int = 8321
    vocab_file: Optional[str] = None
    visual_size: int = 35
    acoustic_size: int = 74
    vocab_size: int = 32000

    # Numerics / behavior
    compute_dtype: str = "bfloat16"   # activations; params & cell state f32
    freeze_bert_embeddings: bool = False
    freeze_embeddings: bool = True
    fix_conf_loss: bool = False
    missing_modality: str = "none"
    missing_modality_prob: float = 0.0

    # Parallelism: dp_size is the data-parallel mesh (parallel/mesh.py; -1:
    # every rank of the process group, one process without one).  tp_size > 1,
    # pp_size > 1, sp, zero1 and fsdp are refused by the trainer, naming their
    # ROADMAP items (train/loop.py::unsupported).  Then options the port runs:
    # MoE BERT (moe_*), the EMA shadow (ema_decay), MMIM's weights (mmim_*).
    dp_size: int = -1
    tp_size: int = 1
    pp_size: int = 1
    pp_microbatches: int = 0
    sp: bool = False
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1
    moe_aux_weight: float = 0.01
    moe_z_weight: float = 0.001
    ema_decay: float = 0.0
    zero1: bool = False
    fsdp: bool = False
    mmim_alpha: float = 0.1
    mmim_beta: float = 0.1

    # Engine
    export_dir: str = ""
    ckpt_dir: str = "checkpoints"
    resume: bool = False
    enable_early_stop: bool = False
    log_every: int = 50
    log_sinks: Tuple[str, ...] = ("stdout",)
    profile_dir: Optional[str] = None
    # the scanned epoch and eval of the JAX package: here CUDA-graph replays of
    # the step (train/step.py); scan_chunk is inert (a replay is one step)
    compiled_epoch: bool = False
    scan_chunk: int = 8
    compiled_eval: bool = True
    # Kernel and debugging knobs.  The port reads use_flash_attention,
    # attn_impl, fused_ln_dropout (the hand-written kernels' routes),
    # export_weights_dtype (cli/export.py), adam_mu_dtype, use_wandb,
    # debug_nans and disable_jit (cli/train.py); use_pallas, fast_dropout and
    # fast_rng only steer TPU code and are inert here.
    use_pallas: bool = True
    use_flash_attention: bool = False
    attn_impl: str = "auto"
    fast_dropout: bool = True
    export_weights_dtype: Optional[str] = None
    fused_ln_dropout: bool = False
    adam_mu_dtype: str = "float32"
    fast_rng: bool = True
    use_wandb: bool = False
    debug_nans: bool = False
    disable_jit: bool = False

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def resolved_attn_impl(self, training: bool = False,
                           seq_len: Optional[int] = None) -> str:
        """The BERT attention core the JAX package picks: with "auto",
        flash for training at S >= 256 and for inference at S > 1024, else
        plain ("xla"); `use_flash_attention` is the older name of
        attn_impl="flash".  `seq_len` defaults to `max_seq_len`; the model
        passes the token length of the batch it was given."""
        if self.attn_impl == "auto":
            if self.use_flash_attention:
                return "flash"
            s = self.max_seq_len if seq_len is None else seq_len
            if (training and s >= 256) or (not training and s > 1024):
                return "flash"
            return "xla"
        if self.attn_impl == "xla" and self.use_flash_attention:
            return "flash"
        return self.attn_impl

    def resolved_task(self) -> str:
        if self.task != "auto":
            return self.task
        if self.data == "mosi":
            return "regression"
        if self.data == "ur_funny":
            return "binary"
        return "classification"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {ACTIVATIONS}, got {self.activation!r}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}, got {self.optimizer!r}")
        if self.eval_mode not in EVAL_MODES:
            raise ValueError(f"eval_mode must be one of {EVAL_MODES}, got {self.eval_mode!r}")
        if self.rnncell not in ("lstm", "gru"):
            raise ValueError(f"rnncell must be lstm|gru, got {self.rnncell!r}")
        if self.missing_modality not in ("none", "visual", "acoustic", "both"):
            raise ValueError(f"bad missing_modality {self.missing_modality!r}")
        if self.task not in ("auto", "classification", "regression", "binary"):
            raise ValueError(f"bad task {self.task!r}")
        if self.attn_impl not in ("auto", "xla", "fused", "flash"):
            raise ValueError(
                f"attn_impl must be auto|xla|fused|flash, got {self.attn_impl!r}")
        if self.mult_d % self.mult_heads != 0:
            raise ValueError(
                f"mult_heads={self.mult_heads} must divide mult_d={self.mult_d}")
        if self.mult_d % 2 != 0:
            raise ValueError(
                f"mult_d={self.mult_d} must be even (sinusoidal positions)")
        if self.ckpt_interval < 1:
            raise ValueError(f"ckpt_interval must be >= 1, got {self.ckpt_interval}")
        if self.ckpt_backend not in ("msgpack", "orbax"):
            raise ValueError(f"bad ckpt_backend {self.ckpt_backend!r}")
        if self.lr_schedule not in ("none", "exponential", "plateau", "cosine"):
            raise ValueError(f"bad lr_schedule {self.lr_schedule!r}")
        if self.adam_mu_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad adam_mu_dtype {self.adam_mu_dtype!r}")

    def __str__(self) -> str:
        return "Configurations\n" + self.to_json()


def resolve_device(name: str) -> torch.device:
    """The torch device a config or caller names.  "cuda" on a machine
    without a usable card raises instead of running on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda[:N] or cpu, got {name!r}")
    return dev


def set_reference_numerics() -> None:
    """f32 products in full f32 and bf16 products with f32 reductions, as
    the JAX package computes them (`preferred_element_type=f32`): no TF32
    in cuBLAS or cuDNN, no reduced-precision split-K sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="mmda_tpu_torch")
    for f in dataclasses.fields(Config):
        default = f.default
        if isinstance(default, bool):
            p.add_argument(f"--{f.name}", type=str2bool, default=default)
        elif isinstance(default, tuple):
            p.add_argument(f"--{f.name}", type=lambda s: tuple(
                int(x) if x.isdigit() else x for x in s.split(",")), default=default)
        elif isinstance(default, int):
            p.add_argument(f"--{f.name}", type=int, default=default)
        elif isinstance(default, float):
            p.add_argument(f"--{f.name}", type=float, default=default)
        else:
            p.add_argument(f"--{f.name}", type=str, default=default)
    return p


def get_config(parse: bool = True, argv=None, **optional_kwargs) -> Config:
    """Parse argv (flags named as the fields), then apply explicit kwargs.
    `--config_json FILE` loads a saved run config as the base; flags typed
    on the command line still win."""
    if parse:
        parser = build_parser()
        parser.add_argument("--config_json", type=str, default="")
        kw = vars(parser.parse_args(argv))
        cfg_path = kw.pop("config_json", "")
        if cfg_path:
            with open(cfg_path) as f:
                saved = json.load(f)
            probe = build_parser()
            probe.add_argument("--config_json", type=str)
            for action in probe._actions:
                action.default = argparse.SUPPRESS
            explicit = set(vars(probe.parse_args(argv)))
            defaults = {f.name: f.default for f in dataclasses.fields(Config)}
            for k, v in saved.items():
                # a saved run names the device it trained on ("tpu"); the
                # port runs where its own flag says
                if k in defaults and k not in explicit and k != "device":
                    if isinstance(defaults[k], tuple) and isinstance(v, list):
                        v = tuple(v)
                    kw[k] = v
    else:
        kw = {}
    kw.update(optional_kwargs)
    for k in ("word_emb_path", "sdk_dir", "bert_model_dir", "profile_dir",
              "export_weights_dtype"):
        if kw.get(k) in ("", "None", "none"):
            kw[k] = None
    if kw.get("apply_dataset_hp") and kw.get("data") in DATASET_HP:
        kw = {**kw, **DATASET_HP[kw["data"]]}
    return Config(**kw)
