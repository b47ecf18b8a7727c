#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmda_tpu_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --first-calls
    python3 chip_smoke.py --phase15
    python3 chip_smoke.py --phase16
    python3 chip_smoke.py --phase17
    python3 chip_smoke.py --fused-long-f32
    python3 chip_smoke.py --fused-f32

With no argument, every phase below.  `--first-calls` stops after phase 2,
calling each attention kernel once in the fresh process (f32 flash through
autograd against the CPU, the bf16 flash kernels and both instantiations of
the two short kernels against their plain versions): a small target for
compute-sanitizer.  It prints no result lines.

Phases (each prints one line or more; any failure exits non-zero before
the result):

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; the card must be compute capability 9.0;
2. build: every CUDA kernel of the package from `mmda_tpu_torch/csrc` (one
   nvcc per source, all started together);
3. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes and beyond.  The LSTM and GRU forward recurrences and their
   BPTT backwards (f32, |err| <= 1e-5 + 1e-5 |ref|: summation order only),
   with CUDA-event times of each kernel, its plain version and one cuDNN
   `nn.LSTM` / `nn.GRU` call (its forward, or its backward) on the same
   inputs, beside the kernel's bound; the LSTM and GRU backwards' times also
   split into their gate pass, their serial BPTT pass and their dW passes,
   and the time per serial step (us / T) of `lstm_fwd`, `gru_fwd` and
   `gru_bwd`; the checked shapes must reach all three instantiations of the
   serial passes of `lstm_fwd`, `gru_fwd` and `gru_bwd` (weights in
   registers, 11 or 21 float4s' worth, or read from global memory at
   H = 128 (EF_LSTM's step) and 300) and an H that is no multiple of 4 (H = 33, 35).  The fused
   residual + dropout + LayerNorm forward and backward in f32 and bf16: the
   keep mask equal bit for bit to the plain hash, outputs within 1e-5 (f32)
   or one bf16 ulp, dscale and dbias within 1e-4; timed beside the composition
   `F.layer_norm(x + F.dropout(y, p))` and its `autograd.grad`, the
   backward also split into its rows pass and its column sums, with the
   inputs in L2 and read from HBM; rows wider than 1024 (H = 1025, 1536, 4096:
   the backward's block a row) checked and timed the same way.  The three
   blockwise attention kernels (forward, dq, dk/dv) at S = 130, 514 and 1026
   and at D = 16, and at D = 8, 40 and 96 (the next instantiation up on
   zero-padded columns, also timed at the long step's (384, 514)), in f32
   (|err| <= 1e-5 + 1e-4 |ref|) and bf16 (2e-2, plus one bf16 ulp on the
   gradients), at dropout rate 0 and 0.1 with masked
   tails; their keep mask equal bit for bit to the plain hash in f32 and in
   bf16; two launches of each of the three giving the same bits; the
   tensor-core instructions (HMMA/HGMMA) in the SASS of the three kernels'
   bf16 instantiations counted with cuobjdump (none fails); timed at the
   long step's (384, 514, 64) beside `F.scaled_dot_product_attention` with
   the same additive mask and dropout_p and its `autograd.grad`.  The two
   short attention kernels at (B, nh, S, hd) = (64, 12, S, 64) for S = 18,
   34, 50, 66, at (32, 12, 50, 64) and at (3, 4, 10, 8), f32 (1e-5 + 1e-5 |ref|) and bf16 (one
   bf16 ulp), rate 0 and 0.1, masked tails, their keep mask bit for bit in
   f32 and bf16, two launches of each giving the same bits, the HMMA count
   of both bf16 kernels (none fails); the tiled short kernels (query and key
   tiles, S > 128) the same way at (32, 12, 514, 64), (2, 4, 129, 8), (2, 4,
   257, 128), (1, 2, 1026, 64) and (2, 3, 200, 100) (the cp.async loader),
   their masks at S = 129 and 514, each call launching its route's kernels
   and no other, the training forward and the backward from its statistics
   bit-equal to the plain calls; an item whose keys are all masked and whose
   scores reach 33, 40 and 100 against the plain training forward and the
   plain backward from its statistics (`check_masked_items`, f32 and bf16, at
   (3, 2, 200, 64), (2, 2, 514, 64), (2, 3, 200, 100), and on the block route
   at (3, 2, 50, 64), (2, 3, 100, 100)); hd = 136 refused; timed at (64, 12, 50, 64)
   and (32, 12, 514, 64), bf16 and f32, beside SDPA, the tiled backward from the
   saved statistics by part (r, dq, dk/dv) and alone, and both tiled designs of each
   dtype in turns with their HGMMA / HMMA lines (bf16: `wgmma` fed by TMA, `mma.sync`
   fed by cp.async; f32: six bf16 term products on `wgmma`, f32 FMAs, each also
   against float64, with the plain version's distance beside it, and with q times 4
   and 8 (peaked scores) each output within twice that distance); the f32 block
   kernels' two designs likewise at (64, 12, 50, 64) (f32 FMAs, six bf16 term
   products on `wgmma`), at the serving buckets' S = 18, 34, 66 timed too, and the tiled route's
   kernels timed at (64, 12, 50, 64) as a yardstick; both f32 tiled designs
   timed at (2, 4, 257, 8) and (2, 2, 129, 33); the f32 tensor-core kernels'
   SASS (both routes) must hold HGMMA lines.  The two
   multi-direction LSTM kernels at (T, B) = (48, 64) and (512, 32) with H =
   35, 35, 74, 74, and at (16, 64) with H = 35, 74, 300 in one launch (the
   serial passes' three instantiations, which the checks must reach),
   against their plain versions (1e-5 + 1e-5 |ref|) and against four
   single-direction calls, whose passes they run: ys, cs, h_fin and dx_proj
   bit for bit, dw_hh_t too where its runs are the same; two launches
   giving the same bits; timed at (48, 64) beside those four calls and cuDNN, with the
   time per serial step, the backward split into its gate pass, BPTT and dW
   passes, and the launch geometry (registers a thread, blocks, resident
   blocks an SM, waves);
4. serving at full width: the default config (bert-base 12 x 768, bi-LSTM
   towers for 35 visual and 74 acoustic features, hidden 128, 6 classes,
   bf16), seeded random weights, behind the HTTP front end
   (`mmda_tpu_torch.cli.serve`); a few dozen pre-tokenised requests over the
   three buckets.  The launch counts must show 8 LSTM kernel launches per
   Predictor call (2 towers x 2 layers x 2 directions); the same batch with
   the plain recurrence must agree within 1e-3; a small f32 model must give
   the same outputs on the card as on the CPU (1e-4); per-bucket latency and
   a torch.profiler breakdown of one call's device time;
5. training at full width: the flagship step (bert-base with encoder layers
   <= 8 frozen, B=64, T=48, bf16, the exact objective, value clip then
   Adam), through `Trainer.train()` for one epoch of 20 full-length
   synthetic batches with dev eval, best-on-dev save and test eval.  Every
   step must make 8 forward and 8 backward LSTM kernel launches and give
   finite losses; then the median ms/step, utterances/s and peak memory of
   20 more steps, a torch.profiler breakdown of one step, one step's
   gradients with the kernels against the plain recurrence (dropout off,
   1e-3) and a small f32 model's gradients on the card against the CPU
   (1e-4);
6. train -> serve: `python -m mmda_tpu_torch.cli.train --data synthetic
   --n_epoch 1` at the default widths writes a best-on-dev checkpoint, and a
   `Predictor` loaded from it answers a few requests with finite scores; the
   `cli.train` runs of phases 7, 9 and 16 start beside it, all four
   processes at once on the card (nothing timed runs beside them), and each
   checkpoint is then served in turn;
7. the GRU configuration (`rnncell=gru`, `fused_ln_dropout=True`) at the
   flagship shape: `Trainer.train()` as in phase 5, every step making 8
   `gru_fwd`, 8 `gru_bwd`, 24 `ln_dropout_fwd` and 24 `ln_dropout_bwd`
   launches (2 fused sites in each of the 12 BERT layers) and no LSTM
   launch; timed steps and a profile; one step's gradients with dropout on,
   the four kernels against their plain versions under the same seeds
   (1e-3); a small f32 GRU model's gradients on the card against the CPU;
   then a `Predictor` on the checkpoint that run wrote, behind the HTTP front
   end (8 `gru_fwd` launches per call), and `cli.train --rnncell gru
   --fused_ln_dropout True` -> `Predictor`;
8. long sequences: bert-base at B=32, T=512 (S=514), bf16, the mosei freeze
   rule, dropout on, `attn_impl="auto"`, which resolves to the attention
   kernels for the training steps and to the dense core for eval.
   `Trainer.train()` for one epoch of 6 full-length batches: every step makes
   12 `flash_fwd`, 12 `flash_bwd_dq`, 12 `flash_bwd_dkv`, 8 `lstm_fwd` and 8
   `lstm_bwd` launches (the recurrences at T=512), an eval batch none of the
   attention kernels; 10 timed steps and a profile; the same 10 steps and a
   profile with the dense core (`attn_impl="xla"`); one step's gradients
   with dropout on, kernels against plain versions under the same seeds; a
   small f32 model with `attn_impl="flash"` on the card against the CPU;
   then a
   `Predictor(attn_impl="flash")` on that run's checkpoint behind the HTTP
   front end (one bucket of 512, 32 rows a call: 12 `flash_fwd` per call, no
   backward kernel) against the dense core (2e-2), and
   `mmda_tpu_torch.cli.infer` on it;
9. the fused configuration: the flagship step of phase 5 with
   `attn_impl="fused"`, `Trainer.train()` for one epoch of 8 full-length
   batches, every step making 12 `short_attn_fwd`, 12 `short_attn_bwd`, 8
   `lstm_fwd` and 8 `lstm_bwd` launches and every eval batch 12
   `short_attn_fwd` and 8 `lstm_fwd`; 20 timed steps (beside phase 5's
   dense-core steps) and a profile; one step's gradients with dropout on,
   kernels against plain versions under the same seeds; a small f32 model
   with `attn_impl="fused"` on the card against the CPU; then a
   `Predictor(attn_impl="fused")` on that run's checkpoint at buckets
   16/32/64 behind the HTTP front end (12 `short_attn_fwd` and 8 `lstm_fwd`
   per call, no backward kernel) against the dense core (2e-2), with
   per-bucket latency; and `cli.train --attn_impl fused` -> `Predictor`; then
   the same step in f32 (`fused_f32`: `compute_dtype="float32"`, the f32
   one-block kernels on the tensor cores, 12 + 12 a step, 12 an eval batch)
   through `Trainer.train()` for 3 steps, eager steps against captured
   replays bit for bit, 10 of each timed, busy, idle share, peak memory and
   the two kernels' ms a step (`11 fused-f32`), and a captured f32
   `Predictor` at bucket 64, B=64, on its checkpoint (12 `short_attn_fwd` +
   8 `lstm_fwd` a replay, replays bit-equal to eager calls); `--fused-f32`
   runs it alone after the build with both f32 designs in turns;
10. the tower pair: `extract_features_pair(use_pallas_multi=True)` at the
   towers' widths (35, 74), forward and backward, at B=64, T=48 and B=32,
   T=512: 2 `lstm_multi_fwd` and 2 `lstm_multi_bwd` launches per call and no
   single-direction launch; values and gradients against the per-direction
   path within 1e-5 + 1e-5 |ref|; both paths' times;
11. captured: for each training configuration (lstm, gru, fused, long), on
   the trainer its phase built: three eager steps from one state twice,
   bit for bit (the losses, grad_norm, every parameter, both moments); three
   replays of a training graph (`make_train_graph`) from that state against
   those eager steps, bit for bit (a tensor that differs is named and held
   at TRAIN_TOL plus one bf16 ulp); the launches a replay counts equal the
   configuration's per-step launches; no host read-back in a warm eager
   step or a replay (`set_sync_debug_mode("error")`); 20 timed replays (10
   at the long shape) beside as many eager steps, with the idle share and
   peak memory; `Trainer.train()` again with compiled_epoch=True, its dev
   eval replaying an eval graph, whose outputs equal the eager eval's bit
   for bit.  For serving, the Predictors of phases 4 (dense, buckets
   16/32/64), 8 (flash, 512) and 9 (fused, 16/32/64), captured per bucket by
   their HTTP runs: a replay against an eager call through the same kernels
   on the same batch, bit for bit, and both latencies at a full batch and at
   one request; phase 4 also profiles an eager call beside the captured one;
12. the rest of the one-card Trainer and the data path, at full width (bert-base, the
   default towers, bf16): ConfidNet stage 2 through `cli.train --data synthetic
   --use_confidNet True --confid_two_stage True --n_epoch 2 --n_epoch_stage2 2` in this
   process (8 `lstm_fwd` and no `lstm_bwd` a stage-2 step; the export changed from the
   stage-1 best export in the `confidence` leaves only, every other leaf bit-equal; a
   `Predictor` on it; stage-2 steps at B=64, T=48 timed and profiled beside phase 5's and
   11's steps); `grad_accum_steps=2` at B=32, T=48 (four eager mini-steps and four
   replays of the two graphs a shape gets, accumulate and apply, bit for bit; ms per
   mini-step; a small f32 model's mini-steps on the card against the CPU, 1e-4);
   `last_*` and resume (a `Trainer(compiled_epoch=True)` at B=64, T=48 that sends itself
   SIGTERM after epoch 0 stops with the incremental snapshot written; a
   `Trainer(resume=True)` holds its state bit for bit, and one step from each is the
   same bits; the bytes and seconds of the frozen base, a delta and a full snapshot);
   the ETL (`cli.etl --data ur_funny` on SDK pickles written here, then `cli.train` on
   its splits for an epoch: 8 + 8 LSTM launches a step, 8 `lstm_fwd` an eval batch);
13. HF BERT, int8 serving, the zoo and the native host library, at full width: a seeded
   bert-base written in HF's names (`bert.` prefix) as `model.safetensors` (a writer here)
   and `pytorch_model.bin`, both read back by `load_hf_weights` bit for bit; the flagship
   step from it (`bert_model_dir`, the mosei freeze rule, `attn_impl="fused"`) through
   `Trainer.train()`, 8 + 8 LSTM and 12 + 12 short-attention launches a step, encoder
   layers <= 8 still the file's bits after it and a trained layer moved, and the host-side
   ops of an eager step (`utils.timing.profile`: ATen, autograd's engine, the CUDA runtime,
   the untraced Python); `cli.train --data synthetic --bert_model_dir --attn_impl fused
   --profile_dir --compiled_epoch True` in this process (its launches, its Chrome trace
   naming the LSTM and short-attention kernels, replays included), a `Predictor` on its
   export; fused-attention `Predictor`s with `bert_weights_dtype` int8, bfloat16 and None
   on one seeded model (8 `lstm_fwd` + 12 `short_attn_fwd` a call, BERT weight bytes,
   captured latency at buckets 16/32/64 for B=64 and B=1, the score difference from f32
   weights, int8's replays bit-equal to eager calls), a small f32 int8 model on the card
   against the CPU (1e-4), and the bf16 int8 product's one rounding: each bert-base dense
   on the card against the CPU (one bf16 ulp + 2^-8) and against a float64 product scaled
   and rounded once (at most 1e-3 of the outputs not bit-equal), and a two-layer bf16 int8
   encoder on the card against the CPU, no further apart than the same encoder with bf16
   weights plus one bf16 ulp; EF_LSTM (GloVe 300 + 35 + 74,
   hidden 128: 4 `lstm_fwd` + 4 `lstm_bwd` a step, 4 `lstm_fwd` an eval batch and a
   `Predictor` call), LF_DNN, LMF and TFN with bert-base and `attn_impl="fused"` (12 + 12
   short attention a step, 12 forward a call; TFN also `fused_ln_dropout`: 24 + 24
   LayerNorm a step), each `Trainer.train()` for 4 steps at B=64, T=48, then phase 11's
   eager and captured steps (replays bit-equal), a `Predictor` on its export and a small f32
   model's gradients on the card against the CPU (1e-4); `cli.etl --data ur_funny` with a
   GloVe file and a WordPiece vocab through the native library (its build must succeed and
   its GloVe scan print its line), the native `encode_batch` byte-equal to the Python one;
14. MULT, MAG_BERT and MMIM at full width (bert-base, B=64, T=48, S=50), each as a phase 13
   zoo family (`Trainer.train()` for 4 steps, phase 11's eager and captured steps with
   every replay bit-equal, a `Predictor` on its export, a small f32 model's gradients
   on the card against the CPU at 1e-4): MULT with `fused` attention on aligned splits
   and on the unaligned ones (visual over 96 steps, acoustic over 144), 12 + 12 short
   attention a step, 12 an eval batch and a call; MAG_BERT (`fused`, `fused_ln_dropout`,
   the gate at layer 1), also 24 + 24 LayerNorm a step; MMIM (`fused`), 8 + 8 LSTM and
   12 + 12 short attention a step, 8 + 12 an eval batch and a call, its `model_aux`,
   `nll` and `nce` finite; each run's `post_eval_time_s` (the export now written on a
   thread), and beside MULT the export written synchronously against the return and the
   join of `save_checkpoint(async_write=True)`, the two files the same bytes;
15. serving artifacts and MoE BERT, at full width: the default configuration with
   `attn_impl="fused"` exported on the card (`serving_export.export_model`, buckets
   32 and 64, max_batch 64; seconds and `.pt2` bytes a bucket), an `ExportedPredictor`
   of it against the live captured `Predictor` on a copy of the weights (8 `lstm_fwd` +
   12 `short_attn_fwd` a call, scores within SERVE_TOL with the bit-equal share, both
   latencies at each bucket for B=64 and B=1, median of 10), the same artifact served by
   `python -X importtime -m mmda_tpu_torch.cli.serve --export_dir` in a fresh process
   (requests over HTTP one at a time, its launches on replays from /healthz, its import
   log free of `mmda_tpu_torch.models`, `serving` and `train`, its scores against the
   live `Predictor`'s); the same for an int8 artifact (bucket 64) and a flash one
   (bucket 512 at B=32: 12 `flash_fwd` a call); MISA with a bert-base Switch MoE (4
   experts, top-1, capacity 1.25, grouped by example, `fused`, the mosei freeze rule)
   through `Trainer.train()` for 4 steps (`moe`, `moe_drop` finite, an eager step moves
   layer 9's router), phase 11's eager and captured steps with every replay bit-equal,
   a small f32 MoE model's gradients on the card against the CPU (1e-4), and its best
   export served live and as an artifact; beside phase 9's fused trainer, eager steps
   and single calls through the kernel ops against the ops' implementations called
   directly (`15 op-dispatch`).  `--phase15` runs phase 15 alone after the build;
16. fused attention at the long shape: bert-base at B=32, T=512 (S=514), bf16, the mosei
   freeze rule, dropout on, `attn_impl="fused"`, as phases 8 and 11 run the flash step:
   `Trainer.train()` for 4 full-length batches (12 `short_attn_tiled_fwd` + 12
   `short_attn_tiled_bwd` + 8 + 8 LSTM launches a step, 12 + 8 an eval batch), 10 timed
   steps and a profile, one step's gradients with dropout on against the plain versions,
   a small f32 model at T=130 on the card against the CPU, eager steps against captured
   replays bit for bit, timed, and `Trainer.train()` with compiled_epoch; phase 8's flash
   step on the same trainer, eager and captured, the two steps side by side (`16
   fused-vs-flash`: ms, busy, attention kernels' ms a step, peak memory); the same
   step in f32 (`compute_dtype="float32"`: the f32 tiled kernels on the tensor
   cores, 12 + 12 a step, 12 an eval batch) through `Trainer.train()` for 3 steps,
   then eager steps against captured replays bit for bit, 5 of each timed, busy, idle
   share, peak memory and the tiled kernels' ms a step (`11 fused-long-f32`;
   `--fused-long-f32` runs it alone after the build with both f32 designs in turns); a
   `Predictor(attn_impl="fused")` on the
   checkpoint at bucket 512 over HTTP (12 `short_attn_tiled_fwd` + 8 `lstm_fwd` a call),
   captured at B=32 and B=1 against eager calls, within 2e-2 of the dense-core and flash
   `Predictor`s; then `cli.train --attn_impl fused --max_seq_len 512 --bucket_sizes 64,512`
   and a `Predictor` on its export.  `--phase16` runs phase 16 alone after the build;
17. data parallelism (`mmda_tpu_torch/parallel/mesh.py`) at the flagship's full width
   (bert-base, B=64 global, T=48, `attn_impl="fused"`, LSTM towers): (a) `torchrun
   --nproc_per_node 1 chip_smoke.py --dp-cli ...`, whose rank joins an nccl process group
   and runs `cli.train --compiled_epoch True` in its process (8 steps of the data-parallel
   step, its collectives captured with it; 8 + 8 LSTM and 12 + 12 short attention launches
   a step, 8 + 12 an eval batch, replays counted as recorded), against the one-process
   `Trainer` on the same configuration in this process: the best export and the `last_*`
   delta the same bytes, the epoch's losses and metrics the same; both captured steps
   timed; (b) two ranks on the one card: nccl (what it answers is recorded; it refuses two
   ranks on one device), then gloo (each collective through the host), each rank 3 eager
   f32 steps on its 32 rows (dropout off), against the one-process step at the global
   batch: the losses and the trained parameters within twice what splitting the batch in
   two on one process through the plain versions (`split_step`) moves them, and at least
   DP_LOSS_FLOOR (relative) and DP_PARAM_FLOOR; the ranks' launches and step times beside
   the one-process step's.  `--phase17` runs phase 17 alone after the build;
18. a `kernels` JSON line (all 15 kernels), the card's name and power limit, and as the last
   line `{"ok": true, "device": {...}}`.

Imports nothing of JAX or the JAX package.  Full results also go to
chiprun_out/chip_smoke.json, and every result line, each with the process's
age in `elapsed_s`, to chiprun_out/chip_smoke.log.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12            # H100 SXM f32 outside the tensor cores
KERNEL_TOL = 1e-5
SERVE_TOL = 1e-3                  # kernel vs plain recurrence, whole model
DEVICE_TOL = 1e-4                 # card vs CPU, small f32 model
# (T, B, H): serving shapes (buckets 16/32/64, batch 64, towers H=35/74),
# the GloVe tower's H=300 (w_hh_t in global memory), long T, where the TPU
# package used its time-chunked streaming kernel, EF_LSTM's step (hidden
# 128 over inputs of 409 and 256: w_hh_t in global memory too), and the
# towers at B = 32, a rank's rows of phase 17's two-rank step
CHECK_SHAPES = [(16, 64, 35), (32, 64, 35), (48, 64, 35), (64, 64, 35),
                (16, 64, 74), (32, 64, 74), (48, 64, 74), (64, 64, 74),
                (48, 64, 300), (48, 32, 35), (48, 32, 74), (256, 32, 74), (512, 32, 74),
                (7, 5, 33), (48, 64, 128)]
TIMED_SHAPES = [(48, 64, 74), (64, 64, 74), (512, 32, 74), (48, 64, 128)]
REPORT_SHAPE = (64, 64, 74)       # the kernels line: largest bucket, wider tower
REPORT_BWD_SHAPE = (48, 64, 74)   # the training step's wider tower
LAUNCHES_PER_CALL = 8             # 2 towers x 2 layers x 2 directions
LN_SITES = 24                     # 12 BERT layers x (attention, FFN) residual LayerNorms
BERT_LAYERS = 12                  # one attention core per layer
TRAIN_B, TRAIN_T, TRAIN_STEPS = 64, 48, 20
LONG_B, LONG_T, LONG_STEPS, LONG_TIMED = 32, 512, 6, 10   # the long-sequence step (S = 514)
TRAIN_TOL = 1e-3                  # kernels vs plain versions, step gradients: this, plus one
                                  # bf16 ulp of the gradient (BERT's gradients are bf16
                                  # values, and one on a rounding boundary may round the
                                  # other way)
# the training configurations: extra Config options, launches per step and
# per eval batch, the kernel names the profile sums; "long" also its batch,
# length and step counts (the others: TRAIN_B, TRAIN_T, TRAIN_STEPS) and
# whether the kernels-against-plain gradient check runs with dropout on
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SHORT_TILED = ("short_attn_tiled_fwd", "short_attn_tiled_bwd")
FUSED_LONG_STEPS = 4              # phase 16: Trainer.train()'s epoch at B=32, T=512
FUSED_LONG_SMALL_T = 130          # its small f32 model's length, card against CPU (S > 128)
FUSED_LONG_F32_STEPS, FUSED_LONG_F32_TIMED = 3, 5   # the f32 long step: train()'s, then timed
FUSED_F32_STEPS, FUSED_F32_TIMED = 3, 10    # the f32 flagship step: train()'s, then timed
TRAIN_CONFIGS = {
    "lstm": {"options": {"attn_impl": "xla"},
             "per_step": {"lstm_fwd": LAUNCHES_PER_CALL, "lstm_bwd": LAUNCHES_PER_CALL},
             "per_eval": {"lstm_fwd": LAUNCHES_PER_CALL},
             "profile": ("lstm_fwd", "lstm_gates", "lstm_bptt", "lstm_dw")},
    "gru": {"options": {"attn_impl": "xla", "rnncell": "gru", "fused_ln_dropout": True},
            "dropout_on": True,
            "per_step": {"gru_fwd": LAUNCHES_PER_CALL, "gru_bwd": LAUNCHES_PER_CALL,
                         "ln_dropout_fwd": LN_SITES, "ln_dropout_bwd": LN_SITES},
            "per_eval": {"gru_fwd": LAUNCHES_PER_CALL},
            "profile": ("gru_fwd", "gru_gates", "gru_bptt", "gru_dwb", "ln_dropout_fwd",
                        "ln_dropout_bwd", "ln_dropout_dgb")},
    # attn_impl "auto" resolves to flash for the training steps (S = 514 >= 256)
    # and to the dense core for the eval batches (S <= 1024); the towers run
    # the recurrences at T = 512
    # attn_impl "fused": the short-sequence kernels in every training step
    # (with dropout) and every eval batch (rate 0)
    "fused": {"options": {"attn_impl": "fused"}, "dropout_on": True, "steps": 8,
              "timed": TRAIN_STEPS,
              "per_step": {"lstm_fwd": LAUNCHES_PER_CALL, "lstm_bwd": LAUNCHES_PER_CALL,
                           "short_attn_fwd": BERT_LAYERS, "short_attn_bwd": BERT_LAYERS},
              "per_eval": {"lstm_fwd": LAUNCHES_PER_CALL, "short_attn_fwd": BERT_LAYERS},
              "profile": ("lstm_fwd", "lstm_gates", "lstm_bptt", "lstm_dw", "short_attn_fwd",
                          "short_attn_bwd")},
    # attn_impl "fused" at the long shape: the tiled short-attention kernels in
    # every training step and eval batch (S = 514)
    "fused_long": {"options": {"attn_impl": "fused"}, "dropout_on": True,
                   "batch": LONG_B, "T": LONG_T, "steps": FUSED_LONG_STEPS,
                   "timed": LONG_TIMED,
                   "per_step": {"lstm_fwd": LAUNCHES_PER_CALL, "lstm_bwd": LAUNCHES_PER_CALL,
                                **dict.fromkeys(SHORT_TILED, BERT_LAYERS)},
                   "per_eval": {"lstm_fwd": LAUNCHES_PER_CALL,
                                "short_attn_tiled_fwd": BERT_LAYERS},
                   "profile": ("lstm_fwd", "lstm_gates", "lstm_bptt", "lstm_dw", "tiled_fwd",
                               "tiled_r", "tiled_dq", "tiled_dkv")},
    # the same in f32: the f32 tiled kernels in every training step and eval
    # batch (phase 16); a few steps, for the captured step alone
    "fused_long_f32": {"options": {"attn_impl": "fused", "compute_dtype": "float32"},
                       "dropout_on": True, "batch": LONG_B, "T": LONG_T,
                       "steps": FUSED_LONG_F32_STEPS, "timed": FUSED_LONG_F32_TIMED,
                       "per_step": {"lstm_fwd": LAUNCHES_PER_CALL,
                                    "lstm_bwd": LAUNCHES_PER_CALL,
                                    **dict.fromkeys(SHORT_TILED, BERT_LAYERS)},
                       "per_eval": {"lstm_fwd": LAUNCHES_PER_CALL,
                                    "short_attn_tiled_fwd": BERT_LAYERS},
                       "profile": ("lstm_fwd", "lstm_gates", "lstm_bptt", "lstm_dw",
                                   "tiled_fwd", "tiled_r", "tiled_dq", "tiled_dkv")},
    # the flagship step in f32: the f32 one-block kernels in every training step
    # and eval batch (S = 50); a few steps, for the captured step alone
    "fused_f32": {"options": {"attn_impl": "fused", "compute_dtype": "float32"},
                  "dropout_on": True, "steps": FUSED_F32_STEPS, "timed": FUSED_F32_TIMED,
                  "per_step": {"lstm_fwd": LAUNCHES_PER_CALL, "lstm_bwd": LAUNCHES_PER_CALL,
                               "short_attn_fwd": BERT_LAYERS, "short_attn_bwd": BERT_LAYERS},
                  "per_eval": {"lstm_fwd": LAUNCHES_PER_CALL, "short_attn_fwd": BERT_LAYERS},
                  "profile": ("lstm_fwd", "lstm_gates", "lstm_bptt", "lstm_dw",
                              "short_attn_fwd", "short_attn_bwd")},
    "long": {"options": {"attn_impl": "auto"}, "dropout_on": True,
             "batch": LONG_B, "T": LONG_T, "steps": LONG_STEPS, "timed": LONG_TIMED,
             "per_step": {"lstm_fwd": LAUNCHES_PER_CALL, "lstm_bwd": LAUNCHES_PER_CALL,
                          **dict.fromkeys(FLASH, BERT_LAYERS)},
             "per_eval": {"lstm_fwd": LAUNCHES_PER_CALL},
             "profile": ("lstm_fwd", "lstm_gates", "lstm_bptt", "lstm_dw", "flash_fwd",
                         "flash_bwd_dq", "flash_bwd_dkv")},
}
# (BH, S, D) of the attention checks: S no multiple of the 64-wide tiles, the
# long step's S = 514, S > 1024 (where inference resolves to flash), and the
# tiny config's D = 16, and head dims that are no instantiation of the kernels (8,
# 40, 96: the next one up on zero-padded columns); each in f32 and bf16, at rate 0
# and 0.1
ATTN_SHAPES = [(24, 130, 64), (24, 514, 64), (8, 1026, 64), (4, 130, 16), (4, 130, 8),
               (4, 200, 40), (2, 130, 96)]
ATTN_ANY_D_TIMED = (8, 40, 96)    # timed at the long step's (BH, S), bf16
ATTN_REPORT = (LONG_B * 12, LONG_T + 2, 64)      # the long step's call, bf16
ATTN_RATE = 0.1
ATTN_MASK_SEEDS = (7, -5, 2 ** 31 - 2, 12345)   # the bf16 mask checks at ATTN_SHAPES
ATTN_F32_TOL = (1e-5, 1e-4)       # |err| <= 1e-5 + 1e-4 |ref|: summation order only
ATTN_BF16_TOL = (2e-2, 2.0 ** -7)  # a probability on a rounding boundary may round the
                                  # other way (one bf16 ulp of a value up to 1, times v)
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores
PEAK_F32_TERMS_FLOPS = PEAK_BF16_FLOPS / 6   # f32-accurate products as six bf16 term products
FLASH_SERVE_TOL = 2e-2            # flash Predictor against the dense core, bf16
# (N, H, dtype) of the fused LayerNorm checks: the flagship step's sites
# (N = B * S = 64 * 50) in bf16 and f32, two row counts that are no multiple of
# the TPU kernel's 128-row blocks, and rows wider than a warp's registers hold
# (the backward's block a row: H = 1025 one value an access, 1536 and 4096 four)
LN_SHAPES = [(3200, 768, "bfloat16"), (3200, 768, "float32"),
             (200, 128, "float32"), (300, 128, "float32"),
             (640, 1025, "float32"), (3200, 1536, "bfloat16"), (800, 4096, "bfloat16")]
LN_TIMED = LN_SHAPES[:2] + LN_SHAPES[-3:]
LN_REPORT = LN_SHAPES[0]
LN_RATE = 0.1
LN_SEEDS = (7, 2 ** 31 - 2)
BF16_ULP = 2.0 ** -7              # one bf16 ulp, relative
LN_SUM_TOL = 1e-4                 # dscale, dbias: f32 partial sums over N rows
# (B, nh, S, hd) of the short attention checks: the flagship step's S = 50 and the
# serving buckets' S = 18, 34, 66 at bert-base's 12 heads of 64, the flagship
# step's rank rows in phase 17's two-rank step (B = 32), and a small odd shape;
# each in f32 and bf16, at rate 0 and 0.1; they take one block per (b, h).
# Beyond S = 128 the tiled kernels: the fused long step's (32, 12, 514, 64), S just
# past 128 at hd = 8, the widest head at S = 257, and S = 1026.  hd > 128: refused.
SHORT_SHAPES = [(64, 12, 18, 64), (64, 12, 34, 64), (64, 12, 50, 64), (64, 12, 66, 64),
                (32, 12, 50, 64), (3, 4, 10, 8)]
SHORT_TILED_SHAPES = [(32, 12, 514, 64), (2, 4, 129, 8), (2, 4, 257, 128), (1, 2, 1026, 64),
                      (2, 3, 200, 100)]
SHORT_REFUSED = [(2, 12, 130, 136)]
# a batch item whose keys are all masked, its q scaled so that the largest
# |s scale| reaches each of MASKED_REACH (>= 32: s scale - 1e9 no longer rounds
# to -1e9): the tiled kernels (hd 64 on wgmma, 100 on mma.sync) and the block
# kernels (S = 50, one warpgroup in f32; S = 100, two) at these shapes
MASKED_ITEM_SHAPES = [(3, 2, 200, 64), (2, 2, 514, 64), (2, 3, 200, 100), (3, 2, 50, 64),
                      (2, 3, 100, 100)]
MASKED_REACH = (33.0, 40.0, 100.0)
SHORT_REPORT = (64, 12, 50, 64)    # the fused flagship step's call, bf16, rate 0.1
SHORT_BUCKETS = [(64, 12, 18, 64), (64, 12, 34, 64), (64, 12, 66, 64)]   # fused Predictor
                                   # calls at buckets 16, 32, 64
SHORT_TILED_REPORT = (LONG_B, 12, LONG_T + 2, 64)   # the fused long step's call
SHORT_F32_TOL = (1e-5, 1e-5)       # f32 on both sides, summation order only
SHORT_BF16_TOL = (1e-6, 2.0 ** -7)  # all math f32, each output rounded once: one bf16 ulp
SHORT_MASKS = [(3, 4, 18, 7), (2, 12, 50, -5), (1, 2, 66, 2 ** 31 - 2), (2, 3, 129, 11),
               (1, 2, 514, -7)]
# (T, B) of the multi-direction LSTM checks and of the tower pair, with its
# four directions at their true H (visual 35 forward and reverse, acoustic
# 74); the checks also launch H = 35, 74 and 300 together, so that they reach
# the serial passes' three instantiations (11, 21, 0) in one launch.  The
# kernels are timed at MULTI_REPORT alone (T = 512's last times: PERF.md rows 19-20).
MULTI_SHAPES = [(48, 64), (512, 32)]
MULTI_HS = (35, 35, 74, 74)
MULTI_REVERSE = (False, True, False, True)
MULTI_CHECKS = [(T, B, MULTI_HS, MULTI_REVERSE) for T, B in MULTI_SHAPES] + [
    (16, 64, (35, 74, 300), (False, True, False))]
MULTI_REPORT = (48, 64)
MULTI_BWD_PARTS = {"gate_pass": "lstm_multi_gates", "bptt": "lstm_multi_bptt",
                   "dw": "lstm_multi_dw"}
MULTI_LAUNCHES = 2                 # one per stacked layer
BUILD = ROOT / "build"            # git-ignored: checkpoints of phases 5 to 13
# phase 13: a seeded bert-base checkpoint in HF's names, the zoo's families
HF_DIR = BUILD / "chip_smoke_hf_bert"
ZOO_STEPS, ZOO_TIMED = 4, 10
EF_LAUNCHES = 4                   # one bi-LSTM stack: 2 layers x 2 directions
SHORT_STEP = {"short_attn_fwd": BERT_LAYERS, "short_attn_bwd": BERT_LAYERS}
SHORT_PROFILE = ("short_attn_fwd", "short_attn_bwd")
TRAIN_CONFIGS.update({
    # the flagship step from the HF checkpoint (the mosei freeze rule), with the
    # short-attention kernels as phase 9's
    "hf": {"options": {"attn_impl": "fused", "bert_model_dir": str(HF_DIR / "safetensors")},
           "steps": ZOO_STEPS, "per_step": TRAIN_CONFIGS["fused"]["per_step"],
           "per_eval": TRAIN_CONFIGS["fused"]["per_eval"],
           "profile": TRAIN_CONFIGS["fused"]["profile"]},
    "ef_lstm": {"options": {"model": "EF_LSTM", "use_bert": False}, "steps": ZOO_STEPS,
                "timed": ZOO_TIMED,
                "per_step": {"lstm_fwd": EF_LAUNCHES, "lstm_bwd": EF_LAUNCHES},
                "per_eval": {"lstm_fwd": EF_LAUNCHES},
                "profile": TRAIN_CONFIGS["lstm"]["profile"]},
    "lf_dnn": {"options": {"model": "LF_DNN", "attn_impl": "fused"}, "steps": ZOO_STEPS,
               "timed": ZOO_TIMED, "per_step": SHORT_STEP,
               "per_eval": {"short_attn_fwd": BERT_LAYERS}, "profile": SHORT_PROFILE},
    "lmf": {"options": {"model": "LMF", "attn_impl": "fused"}, "steps": ZOO_STEPS,
            "timed": ZOO_TIMED, "per_step": SHORT_STEP,
            "per_eval": {"short_attn_fwd": BERT_LAYERS}, "profile": SHORT_PROFILE},
    "tfn": {"options": {"model": "TFN", "attn_impl": "fused", "fused_ln_dropout": True},
            "steps": ZOO_STEPS, "timed": ZOO_TIMED,
            "per_step": {**SHORT_STEP, "ln_dropout_fwd": LN_SITES, "ln_dropout_bwd": LN_SITES},
            "per_eval": {"short_attn_fwd": BERT_LAYERS},
            "profile": SHORT_PROFILE + ("ln_dropout_fwd", "ln_dropout_bwd", "ln_dropout_dgb")},
})
ZOO = ("ef_lstm", "lf_dnn", "lmf", "tfn")
# phase 14: the rest of the zoo, with bert-base and the short-attention kernels;
# "mult_unaligned" on the unaligned synthetic splits (visual over 2T steps,
# acoustic over 3T), MMIM's towers through the single-direction LSTM kernels
TRAIN_CONFIGS.update({
    "mult": {"options": {"model": "MULT", "attn_impl": "fused"}, "steps": ZOO_STEPS,
             "timed": ZOO_TIMED, "per_step": SHORT_STEP,
             "per_eval": {"short_attn_fwd": BERT_LAYERS}, "profile": SHORT_PROFILE},
    "mag_bert": {"options": {"model": "MAG_BERT", "attn_impl": "fused",
                             "fused_ln_dropout": True, "mag_inject_layer": 1},
                 "steps": ZOO_STEPS, "timed": ZOO_TIMED,
                 "per_step": TRAIN_CONFIGS["tfn"]["per_step"],
                 "per_eval": {"short_attn_fwd": BERT_LAYERS},
                 "profile": TRAIN_CONFIGS["tfn"]["profile"]},
    "mmim": {"options": {"model": "MMIM", "attn_impl": "fused"}, "steps": ZOO_STEPS,
             "timed": ZOO_TIMED, "per_step": TRAIN_CONFIGS["fused"]["per_step"],
             "per_eval": TRAIN_CONFIGS["fused"]["per_eval"],
             "profile": TRAIN_CONFIGS["fused"]["profile"]},
})
TRAIN_CONFIGS["mult_unaligned"] = {**TRAIN_CONFIGS["mult"], "aligned": False}
ZOO_REST = ("mult", "mult_unaligned", "mag_bert", "mmim")


START = time.perf_counter()
LOG_LINES = []                    # every result line, written whole by main()


def log(phase: str, **kw) -> None:
    """One result line; `elapsed_s` is the process's age, for the time budget."""
    kw["elapsed_s"] = round(time.perf_counter() - START, 1)
    line = f"[{phase}] " + json.dumps(kw, default=str)
    LOG_LINES.append(line)
    print(line, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_by_name(fn, reps: int = 10) -> dict:
    """{device op name: ms per fn() call} from torch.profiler over reps calls:
    the median duration of the name's events times its launches per call
    (its event count over reps, rounded, at least 1).  The profiler can lose
    events of a window (seen on the card: 6 of 10 kernel events, once 1 of
    10), and launches of one name take the same time, so medians by name
    survive that where a sum over all events does not.  Empty where the
    profiler shows no device op."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return {name: statistics.median(us) * max(1, round(len(us) / reps)) / 1e3
            for name, us in by_name.items()}


def device_ms(fn, reps: int = 10):
    """Device time of one fn() call in ms: `device_ms_by_name` summed over
    the names; None where the profiler shows no device op."""
    by_name = device_ms_by_name(fn, reps)
    return sum(by_name.values()) if by_name else None


def queue_ms(fn, reps: int = 20) -> tuple:
    """(device span, host enqueue time) per call in ms of reps calls queued
    back to back: one CUDA-event pair around all of them, and the host clock
    until the last is enqueued.  Where the span is well above the enqueue
    time the card never waits for the host, and the span is the calls'
    device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end) / reps, host / reps


def device_time(fn, call_ms: float) -> tuple:
    """(ms, how) of one fn() call's device time: the back-to-back span where
    the queue is device-bound (span > 1.5 x the host's enqueue time), else
    the profiler's medians by kernel name, else the call's event time."""
    span, host = queue_ms(fn)
    if span > 1.5 * host:
        return span, "events, back to back"
    dev = device_ms(fn)
    return (call_ms, "events") if dev is None else (min(dev, span), "profiler")


def kernel_times(kernel, plain, library, plain_reps: int = 5, plain_warmup: int = 3) -> dict:
    """The times of one row.  `call_ms`, `plain_ms` and `library_ms` are
    CUDA-event times of one call of the wrapper, the plain version and the
    library yardstick: with the card idle before it, a call's time includes
    the host's work ahead of the launch (tens of microseconds: checks,
    allocations, ctypes), which is most of a call of a few microseconds.
    `ms` is the kernel's device time alone (`ms_by` says how, see
    `device_time`), `library_device_ms` the same for the library call.  Every
    call here finds its inputs in the L2 cache where they fit, as the main
    paths' calls mostly do (the op before wrote them)."""
    call, lib_call = cuda_ms(kernel), cuda_ms(library)
    ms, how = device_time(kernel, call)
    lib_ms, lib_how = device_time(library, lib_call)
    return {"ms": ms, "ms_by": how, "call_ms": call,
            "plain_ms": cuda_ms(plain, reps=plain_reps, warmup=plain_warmup),
            "library_ms": lib_call, "library_device_ms": lib_ms, "library_ms_by": lib_how}


# ---------------------------------------------------------------- kernels


def lstm_inputs(T, B, H, seed, device):
    rng = np.random.default_rng(seed)
    x_proj = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    w_hh_t = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0], lengths[-1] = 1, T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return (torch.from_numpy(x_proj).to(device), torch.from_numpy(w_hh_t).to(device),
            torch.from_numpy(mask).to(device), lengths)


def lstm_bound(T, B, H, mask) -> dict:
    """Least time for the serving call (no cs): every input read once, every
    output written once, over HBM; the operations the valid steps need over
    the f32 peak (8H^2 for h @ w_hh_t, 19H for the gates, cell and mask)."""
    nbytes = 4 * (T * B * 4 * H + H * 4 * H + T * B + T * B * H + 2 * B * H)
    flops = float(mask.sum()) * (8 * H * H + 19 * H)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "serial_steps": T}


def cudnn_like(w_hh_t, b_hh=None):
    """A cuDNN nn.LSTM (G = 4H) or nn.GRU (G = 3H) computing the kernels'
    function: identity input weights, a zero input bias (x_proj already holds
    it), the same w_hh, and b_hh where the cell keeps it apart (the GRU)."""
    H, G = w_hh_t.shape
    rnn = (torch.nn.LSTM if G == 4 * H else torch.nn.GRU)(G, H).to(w_hh_t.device)
    with torch.no_grad():
        rnn.weight_ih_l0.copy_(torch.eye(G, device=w_hh_t.device))
        rnn.bias_ih_l0.zero_()
        rnn.bias_hh_l0.copy_(torch.zeros(G, device=w_hh_t.device) if b_hh is None else b_hh)
        rnn.weight_hh_l0.copy_(w_hh_t.t())
    return rnn


def cudnn_fwd(x_proj, w_hh_t, lengths, b_hh=None):
    """One cuDNN nn.LSTM / nn.GRU call on a packed sequence computing the
    same forward function.  Returns (call, h_fin)."""
    rnn = cudnn_like(w_hh_t, b_hh)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x_proj, torch.as_tensor(lengths), enforce_sorted=False)

    def call():
        with torch.no_grad():
            return rnn(packed)

    state = call()[1]                   # (h, c) of the LSTM, h of the GRU
    return call, (state[0] if isinstance(state, tuple) else state)[0]


def steady_on_cpu(run) -> list:
    """run() (a list of CPU tensors or arrays) until two calls in a row give
    the same bits, at most four calls; the tests take their CPU references
    through it too.  On the card's host a process's first CPU `torch.exp`
    has been seen to differ from its later ones, and a reference with it by
    3.4e-5 (PERF.md section 7, an open fault of the CPU path); a CPU
    reference is the CPU's steady result."""
    last = run()
    for _ in range(3):
        again = run()
        if all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
               for a, b in zip(last, again)):
            return again
        last = again
    raise AssertionError("the CPU reference gives different bits on every call")


def max_err(pairs, tol, where: str) -> float:
    """Largest |got - want| over (name, got, want) pairs; raises where a
    value is not finite, the reference is all zero (the comparison would say
    nothing), or |got - want| > atol + rtol |want|.  tol: (atol, rtol), or
    one number for both."""
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    worst = 0.0
    for name, g, r in pairs:
        g, r = g.float(), r.float()
        if g.shape != r.shape or not torch.isfinite(g).all() or not r.abs().max() > 0:
            raise AssertionError(f"{name}: shape {tuple(g.shape)}, non-finite values or an "
                                 f"all-zero reference at {where}")
        if ((g - r).abs() - atol - rtol * r.abs()).max().item() > 0:
            raise AssertionError(f"kernel output {name} disagrees with the plain version "
                                 f"at {where} (tol {tol})")
        worst = max(worst, (g - r).abs().max().item())
    return worst


def serial_instantiations(rows) -> list:
    """The serial-pass instantiations (`bptt_instantiation`: 11 or 21
    float4s of weights in registers, 0 from global memory) that the check
    rows' H went through; raises unless every one was, and unless an H that
    is no multiple of 4 (a partial float4 of h and of the weights) was."""
    from mmda_tpu_torch.ops.kernels._launch import bptt_instantiation

    used = sorted({bptt_instantiation(r["H"]) for r in rows})
    if used != [0, 11, 21]:
        raise AssertionError(f"CHECK_SHAPES reach the instantiations {used}, not 0, 11 and 21")
    if all(r["H"] % 4 == 0 for r in rows):
        raise AssertionError("CHECK_SHAPES hold no H that is no multiple of 4")
    return used


def check_lstm_kernel(klstm, device) -> dict:
    rows, worst = [], 0.0
    for T, B, H in CHECK_SHAPES:
        x, w, m, lengths = lstm_inputs(T, B, H, seed=T * 1000 + H, device=device)
        for reverse in (False, True):
            want = klstm.lstm_recurrence_reference(x, w, m, reverse, need_cs=True)
            got = klstm.lstm_recurrence(x, w, m, reverse, need_cs=True)
            serving = klstm.lstm_recurrence(x, w, m, reverse)     # cs not written
            torch.cuda.synchronize()
            if serving[1] is not None:
                raise AssertionError("need_cs=False returned cs")
            names = ("ys", "cs", "h_fin", "c_fin", "ys (no cs)", "h_fin (no cs)",
                     "c_fin (no cs)")
            err = max_err(zip(names, list(got) + [serving[0], serving[2], serving[3]],
                              list(want) + [want[0], want[2], want[3]]), KERNEL_TOL,
                          f"lstm_fwd (T,B,H)={(T, B, H)} reverse={reverse}")
            worst = max(worst, err)
            rows.append({"T": T, "B": B, "H": H, "reverse": reverse, "max_abs_err": err})
    log("3 kernel-vs-plain", shapes=len(rows), max_abs_err=worst, tol=KERNEL_TOL,
        instantiations=serial_instantiations(rows))

    timed = []
    for T, B, H in TIMED_SHAPES:
        x, w, m, lengths = lstm_inputs(T, B, H, seed=T * 1000 + H, device=device)
        call, h_lib = cudnn_fwd(x, w, lengths)
        h_k = klstm.lstm_recurrence(x, w, m)[2]
        row = {"T": T, "B": B, "H": H,
               **kernel_times(lambda: klstm.lstm_recurrence(x, w, m),
                              lambda: klstm.lstm_recurrence_reference(x, w, m), call),
               "library_max_abs_err": (h_lib - h_k).abs().max().item(),
               **lstm_bound(T, B, H, m)}
        row["us_per_step"] = row["ms"] * 1e3 / T
        timed.append(row)
        log("3 kernel-time", **row)
    report = next(r for r in timed if (r["T"], r["B"], r["H"]) == REPORT_SHAPE)
    return {"checks": rows, "timed": timed, "max_abs_err": worst, "report": report}


def lstm_bwd_inputs(T, B, H, seed, device, klstm, reverse=False):
    """The forward's inputs, its saved ys and cs (plain version), and
    random incoming gradients dys and dh_fin."""
    x, w, m, lengths = lstm_inputs(T, B, H, seed, device)
    ys, cs, _, _ = klstm.lstm_recurrence_reference(x, w, m, reverse, need_cs=True)
    rng = np.random.default_rng(seed + 1)
    dys = torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32)).to(device)
    dh = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).to(device)
    return x, w, m, lengths, ys, cs, dys, dh


def lstm_bwd_bound(T, B, H, mask) -> dict:
    """Least time for the backward: x_proj, w_hh_t, mask, ys, cs, dys and
    dh_fin read once, dx_proj and dw_hh_t written once, over HBM; the
    operations the valid steps need over the f32 peak (8H^2 each for the
    recomputed gates, dh_prev and dW_hh, about 40H for the cell)."""
    nbytes = 4 * (2 * T * B * 4 * H + 2 * H * 4 * H + T * B + 3 * T * B * H + B * H)
    flops = float(mask.sum()) * (24 * H * H + 40 * H)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "serial_steps": T}


def cudnn_bwd(x_proj, w_hh_t, lengths, dys, dh, b_hh=None):
    """The backward of one cuDNN nn.LSTM / nn.GRU call on a packed sequence
    computing the same forward: autograd.grad of its outputs w.r.t. its
    input, w_hh and (for the GRU) b_hh, the forward run once outside the
    timed call.  Returns (call, dw_hh_t)."""
    rnn = cudnn_like(w_hh_t, b_hh)
    x = x_proj.clone().requires_grad_(True)
    lens = torch.as_tensor(lengths)
    out, state = rnn(torch.nn.utils.rnn.pack_padded_sequence(x, lens, enforce_sorted=False))
    h = state[0] if isinstance(state, tuple) else state
    d_out = torch.nn.utils.rnn.pack_padded_sequence(dys, lens, enforce_sorted=False).data
    wrt = [x, rnn.weight_hh_l0] + ([] if b_hh is None else [rnn.bias_hh_l0])

    def call():
        return torch.autograd.grad([out.data, h], wrt, [d_out, dh[None]], retain_graph=True)

    return call, call()[1].t()


LSTM_BWD_PARTS = {"gate_pass": "lstm_gates", "bptt": "lstm_bptt", "dw": "lstm_dw"}
GRU_BWD_PARTS = {"gate_pass": "gru_gates", "bptt": "gru_bptt", "dwb": "gru_dwb"}
LN_BWD_PARTS = {"rows": "ln_dropout_bwd", "column_sums": "ln_dropout_dgb"}


def bwd_parts(kernel, names: dict, tries: int = 3) -> dict:
    """The device ms of one `lstm_bwd`, `gru_bwd` or `ln_dropout_bwd` call by
    its kernels (`names`: part -> kernel name substring): the gate pass, the
    serial BPTT pass and the two dW passes; the rows pass and the column
    sums (profiler medians by name).  A profiler
    window that lost every event of a part is taken again, at most `tries`
    times; a part still missing is "not measured"."""
    for _ in range(tries):
        by_name = device_ms_by_name(kernel)
        parts = {part: sum(ms for name, ms in by_name.items() if key in name)
                 for part, key in names.items()}
        if all(parts.values()):
            return parts
    return {part: ms or "not measured" for part, ms in parts.items()}


def check_lstm_bwd_kernel(klstm, device) -> dict:
    rows, worst = [], 0.0
    for T, B, H in CHECK_SHAPES:
        for reverse in (False, True):
            x, w, m, _, ys, cs, dys, dh = lstm_bwd_inputs(T, B, H, T * 1000 + H + 7,
                                                          device, klstm, reverse)
            want = klstm.lstm_recurrence_bwd_reference(x, w, m, ys, cs, dys, dh,
                                                       None, reverse)
            got = klstm.lstm_recurrence_bwd(x, w, m, ys, cs, dys, dh, None, reverse)
            torch.cuda.synchronize()
            err = max_err(zip(("dx_proj", "dw_hh_t"), got, want), KERNEL_TOL,
                          f"lstm_bwd (T,B,H)={(T, B, H)} reverse={reverse}")
            worst = max(worst, err)
            rows.append({"T": T, "B": B, "H": H, "reverse": reverse, "max_abs_err": err})
    log("3 bwd-kernel-vs-plain", shapes=len(rows), max_abs_err=worst, tol=KERNEL_TOL)

    timed = []
    for T, B, H in TIMED_SHAPES:
        x, w, m, lengths, ys, cs, dys, dh = lstm_bwd_inputs(T, B, H, T * 1000 + H + 7,
                                                            device, klstm)
        dys = (dys * m[..., None]).contiguous()   # a packed sequence has no padded outputs
        call, dw_lib = cudnn_bwd(x, w, lengths, dys, dh)
        dw_k = klstm.lstm_recurrence_bwd(x, w, m, ys, cs, dys, dh)[1]

        def kernel():
            return klstm.lstm_recurrence_bwd(x, w, m, ys, cs, dys, dh)

        row = {"T": T, "B": B, "H": H,
               **kernel_times(kernel, lambda: klstm.lstm_recurrence_bwd_reference(
                   x, w, m, ys, cs, dys, dh), call, 3, 1),
               "parts_ms": bwd_parts(kernel, LSTM_BWD_PARTS),
               "library_dw_max_abs_err": (dw_lib - dw_k).abs().max().item(),
               **lstm_bwd_bound(T, B, H, m)}
        if isinstance(row["parts_ms"]["bptt"], float):
            row["bptt_us_per_step"] = row["parts_ms"]["bptt"] * 1e3 / T
        timed.append(row)
        log("3 bwd-kernel-time", **row)
    report = next(r for r in timed if (r["T"], r["B"], r["H"]) == REPORT_BWD_SHAPE)
    return {"checks": rows, "timed": timed, "max_abs_err": worst, "report": report}


def gru_inputs(T, B, H, seed, device):
    """x_proj, w_hh_t, b_hh, mask (lengths 1 and T among them), and random
    incoming gradients dys (at padded steps too) and dh_fin."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0], lengths[-1] = 1, T
    arrays = (rng.normal(size=(T, B, 3 * H)), rng.normal(size=(H, 3 * H)) / np.sqrt(H),
              rng.normal(size=3 * H), np.arange(T)[:, None] < lengths[None, :],
              rng.normal(size=(T, B, H)), rng.normal(size=(B, H)))
    return (*(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays), lengths)


def gru_bounds(T, B, H, mask) -> tuple:
    """Least times for the GRU forward and backward: every input read once
    and every output written once over HBM (forward: x_proj, w_hh_t, b_hh,
    mask -> ys, h_fin; backward: those, ys, dys, dh_fin -> dx_proj, dw_hh_t,
    db_hh); the operations the valid steps need over the f32 peak (6H^2 for
    h @ w_hh_t, and in the backward as much again for dh_prev and for dW_hh;
    about 15H and 40H for the cell)."""
    valid = float(mask.sum())
    out = []
    for nbytes, flops in (
            (4 * (T * B * 3 * H + H * 3 * H + 3 * H + T * B + T * B * H + B * H),
             valid * (6 * H * H + 15 * H)),
            (4 * (2 * T * B * 3 * H + 2 * H * 3 * H + 6 * H + T * B + 2 * T * B * H + B * H),
             valid * (18 * H * H + 40 * H))):
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
        out.append({"bound_ms": max(t_bytes, t_ops) * 1e3,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "flops": flops, "serial_steps": T})
    return tuple(out)


def check_gru_kernels(kgru, device) -> tuple:
    """`gru_fwd` and `gru_bwd` against their plain versions at the LSTM
    checks' shapes, then their times.  Returns (forward, backward) results."""
    rows = {"fwd": [], "bwd": []}
    for T, B, H in CHECK_SHAPES:
        x, w, b, m, dys, dh, _ = gru_inputs(T, B, H, T * 1000 + H + 3, device)
        for reverse in (False, True):
            where = f"(T,B,H)={(T, B, H)} reverse={reverse}"
            want = kgru.gru_recurrence_reference(x, w, b, m, reverse)
            got = kgru.gru_recurrence(x, w, b, m, reverse)
            want_b = kgru.gru_recurrence_bwd_reference(x, w, b, m, want[0], dys, dh, reverse)
            got_b = kgru.gru_recurrence_bwd(x, w, b, m, want[0], dys, dh, reverse)
            torch.cuda.synchronize()
            shape = {"T": T, "B": B, "H": H, "reverse": reverse}
            rows["fwd"].append({**shape, "max_abs_err": max_err(
                zip(("ys", "h_fin"), got, want), KERNEL_TOL, "gru_fwd " + where)})
            rows["bwd"].append({**shape, "max_abs_err": max_err(
                zip(("dx_proj", "dw_hh_t", "db_hh"), got_b, want_b), KERNEL_TOL,
                "gru_bwd " + where)})
    worst = {k: max(r["max_abs_err"] for r in v) for k, v in rows.items()}
    log("3 gru-kernels-vs-plain", shapes=len(rows["fwd"]), max_abs_err=worst, tol=KERNEL_TOL,
        fwd_instantiations=serial_instantiations(rows["fwd"]),
        bwd_instantiations=serial_instantiations(rows["bwd"]))

    timed = {"fwd": [], "bwd": []}
    for T, B, H in TIMED_SHAPES:
        x, w, b, m, dys, dh, lengths = gru_inputs(T, B, H, T * 1000 + H + 3, device)
        ys, h_k = kgru.gru_recurrence(x, w, b, m)
        dys = (dys * m[..., None]).contiguous()   # a packed sequence has no padded outputs
        call, h_lib = cudnn_fwd(x, w, lengths, b)
        call_b, dw_lib = cudnn_bwd(x, w, lengths, dys, dh, b)
        dw_k = kgru.gru_recurrence_bwd(x, w, b, m, ys, dys, dh)[1]
        bound_f, bound_b = gru_bounds(T, B, H, m)
        shape = {"T": T, "B": B, "H": H}
        timed["fwd"].append({
            **shape, **kernel_times(lambda: kgru.gru_recurrence(x, w, b, m),
                                    lambda: kgru.gru_recurrence_reference(x, w, b, m), call),
            "library_max_abs_err": (h_lib - h_k).abs().max().item(), **bound_f})
        timed["fwd"][-1]["us_per_step"] = timed["fwd"][-1]["ms"] * 1e3 / T

        def kernel():
            return kgru.gru_recurrence_bwd(x, w, b, m, ys, dys, dh)

        row = {**shape, **kernel_times(
                   kernel, lambda: kgru.gru_recurrence_bwd_reference(x, w, b, m, ys, dys, dh),
                   call_b, 3, 1),
               "parts_ms": bwd_parts(kernel, GRU_BWD_PARTS),
               "library_dw_max_abs_err": (dw_lib - dw_k).abs().max().item(), **bound_b}
        row["us_per_step"] = row["ms"] * 1e3 / T
        if isinstance(row["parts_ms"]["bptt"], float):     # the serial pass alone
            row["bptt_us_per_step"] = row["parts_ms"]["bptt"] * 1e3 / T
        timed["bwd"].append(row)
        log("3 gru-fwd-time", **timed["fwd"][-1])
        log("3 gru-bwd-time", **row)

    def result(k, report_shape):
        report = next(r for r in timed[k] if (r["T"], r["B"], r["H"]) == report_shape)
        return {"checks": rows[k], "timed": timed[k], "max_abs_err": worst[k], "report": report}

    return result("fwd", REPORT_SHAPE), result("bwd", REPORT_BWD_SHAPE)


def ln_inputs(N, H, dtype, seed, device):
    rng = np.random.default_rng(seed)
    x, y, dout = (torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32)).to(device, dtype)
                  for _ in range(3))
    g, b = (torch.from_numpy(rng.normal(size=H).astype(np.float32)).to(device) for _ in range(2))
    return x, y, g, b, dout


def ln_bounds(N, H, dtype) -> tuple:
    """Least times for the fused LayerNorm forward (x, y, scale, bias, seed
    read, out written: 3 passes over N * H) and backward (x, y, dout, scale,
    seed read, dx, dy, dscale, dbias written: 5 passes) over HBM; about 40
    and 60 operations per element (the hash is 12 integer ones) over the f32
    peak."""
    width = torch.finfo(dtype).bits // 8
    out = []
    for nbytes, flops in ((3 * N * H * width + 8 * H + 4, 40 * N * H),
                          (5 * N * H * width + 12 * H + 4, 60 * N * H)):
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
        out.append({"bound_ms": max(t_bytes, t_ops) * 1e3,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "flops": flops})
    return tuple(out)


def check_ln_mask(kln, keep_mask, N, H, dtype, seed, device) -> None:
    """The kernels' keep mask against the plain hash, bit for bit.  With
    x = 0, y = 1, scale = 1 the forward's z is keep / (1 - rate), so a kept
    element lies above its row's mean (in rows that hold both kinds); the
    backward's dy is zero exactly where an element was dropped."""
    x = torch.zeros(N, H, dtype=dtype, device=device)
    y = torch.ones_like(x)
    g, b = torch.ones(H, device=device), torch.zeros(H, device=device)
    s = torch.tensor([seed], dtype=torch.int32, device=device)
    want = keep_mask((N, H), LN_RATE, s)
    out = kln.residual_dropout_layernorm_fwd(x, y, g, b, s, LN_RATE).float()
    mixed = want.min(1).values != want.max(1).values
    dout = ln_inputs(N, H, dtype, seed % 1000, device)[4]
    dx, dy, _, _ = kln.residual_dropout_layernorm_bwd(x, y, g, dout, s, LN_RATE)
    moved = dx.float() != 0
    torch.cuda.synchronize()
    if not (0 < want.mean().item() < 1 and mixed.any() and moved.any()):
        raise AssertionError(f"degenerate mask check at {(N, H, dtype, seed)}")
    if not torch.equal((out > 0).float()[mixed], want[mixed]):
        raise AssertionError(f"forward keep mask differs from the hash at {(N, H, dtype, seed)}")
    if not torch.equal((dy.float() != 0)[moved], want.bool()[moved]):
        raise AssertionError(f"backward keep mask differs from the hash at {(N, H, dtype, seed)}")


def check_ln_kernels(kln, keep_mask, device) -> tuple:
    """`ln_dropout_fwd` and `ln_dropout_bwd` against their plain versions
    (mask, outputs, gradients), then their times.  Returns (forward,
    backward) results; max_abs_err is over the f32 shapes, max_abs_err_bf16
    over the bf16 ones (one ulp of values up to about 5)."""
    import torch.nn.functional as F

    rows = {"fwd": [], "bwd": []}
    for N, H, dtype_name in LN_SHAPES:
        dtype = getattr(torch, dtype_name)
        tol = KERNEL_TOL if dtype == torch.float32 else BF16_ULP
        for seed in LN_SEEDS:
            check_ln_mask(kln, keep_mask, N, H, dtype, seed, device)
            x, y, g, b, dout = ln_inputs(N, H, dtype, N + H + seed % 1000, device)
            s = torch.tensor([seed], dtype=torch.int32, device=device)
            for rate in (0.0, LN_RATE):
                where = f"(N,H)={(N, H)} {dtype_name} seed={seed} rate={rate}"
                got = kln.residual_dropout_layernorm_fwd(x, y, g, b, s, rate)
                want = kln.residual_dropout_layernorm_reference(x, y, g, b, s, rate)
                got_b = kln.residual_dropout_layernorm_bwd(x, y, g, dout, s, rate)
                want_b = kln.residual_dropout_layernorm_bwd_reference(x, y, g, dout, s, rate)
                torch.cuda.synchronize()
                if got.dtype != dtype or any(t.dtype != dtype for t in got_b[:2]):
                    raise AssertionError(f"output dtype at {where}")
                shape = {"N": N, "H": H, "dtype": dtype_name, "seed": seed, "rate": rate}
                rows["fwd"].append({**shape, "max_abs_err": max_err(
                    [("out", got, want)], tol, "ln_dropout_fwd " + where)})
                rows["bwd"].append({
                    **shape,
                    "max_abs_err": max_err(zip(("dx", "dy"), got_b[:2], want_b[:2]), tol,
                                           "ln_dropout_bwd " + where),
                    "sums_max_abs_err": max_err(zip(("dscale", "dbias"), got_b[2:], want_b[2:]),
                                                LN_SUM_TOL, "ln_dropout_bwd " + where)})

    def worst(k, name, key="max_abs_err"):
        return max(r[key] for r in rows[k] if r["dtype"] == name)

    errs = {k: {"float32": worst(k, "float32"), "bfloat16": worst(k, "bfloat16")} for k in rows}
    errs["bwd"]["sums"] = max(r["sums_max_abs_err"] for r in rows["bwd"])
    log("3 ln-kernels-vs-plain", checks=len(rows["fwd"]), mask="equal bit for bit",
        max_abs_err=errs, tol={"float32": KERNEL_TOL, "bfloat16": BF16_ULP, "sums": LN_SUM_TOL})

    timed = {"fwd": [], "bwd": []}
    for N, H, dtype_name in LN_TIMED:
        dtype = getattr(torch, dtype_name)
        x, y, g, b, dout = ln_inputs(N, H, dtype, N + H, device)
        s = torch.tensor([LN_SEEDS[0]], dtype=torch.int32, device=device)
        eps = 1e-12

        def composed():                 # F.layer_norm(x + F.dropout(y, p)), f32 statistics
            return F.layer_norm(x.float() + F.dropout(y.float(), LN_RATE), (H,), g, b,
                                eps).to(dtype)

        leaves = [t.requires_grad_(True) for t in (x.clone(), y.clone(), g.clone(), b.clone())]
        lib_out = F.layer_norm(leaves[0].float() + F.dropout(leaves[1].float(), LN_RATE), (H,),
                               leaves[2], leaves[3], eps).to(dtype)
        bound_f, bound_b = ln_bounds(N, H, dtype)
        shape = {"N": N, "H": H, "dtype": dtype_name, "rate": LN_RATE}
        # copies of the inputs that together exceed the 50 MB L2 several times,
        # taken in turn: the kernels' device time with every input read from HBM
        copies = -(-200 * 2 ** 20 // (3 * x.numel() * x.element_size()))
        cold = itertools.cycle([tuple(t.clone() for t in (x, y, dout)) for _ in range(copies)])

        def cold_fwd():
            xc, yc, _ = next(cold)
            kln.residual_dropout_layernorm_fwd(xc, yc, g, b, s, LN_RATE, eps)

        def cold_bwd():
            xc, yc, dc = next(cold)
            kln.residual_dropout_layernorm_bwd(xc, yc, g, dc, s, LN_RATE, eps)

        timed["fwd"].append({
            **shape,
            **kernel_times(
                lambda: kln.residual_dropout_layernorm_fwd(x, y, g, b, s, LN_RATE, eps),
                lambda: kln.residual_dropout_layernorm_reference(x, y, g, b, s, LN_RATE, eps),
                composed),
            "cold_ms": device_ms(cold_fwd, reps=2 * copies),
            "library": "F.layer_norm(x + F.dropout(y, p)) in f32, cast back", **bound_f})
        def warm_bwd():
            return kln.residual_dropout_layernorm_bwd(x, y, g, dout, s, LN_RATE, eps)

        timed["bwd"].append({
            **shape,
            **kernel_times(
                warm_bwd,
                lambda: kln.residual_dropout_layernorm_bwd_reference(
                    x, y, g, dout, s, LN_RATE, eps),
                lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)),
            "cold_ms": device_ms(cold_bwd, reps=2 * copies),
            "parts_ms": bwd_parts(warm_bwd, LN_BWD_PARTS),
            "cold_parts_ms": bwd_parts(cold_bwd, LN_BWD_PARTS),
            "library": "autograd.grad of that composition", **bound_b})
        log("3 ln-fwd-time", **timed["fwd"][-1])
        log("3 ln-bwd-time", **timed["bwd"][-1])

    def result(k):
        report = next(r for r in timed[k]
                      if (r["N"], r["H"], r["dtype"]) == LN_REPORT)
        return {"checks": rows[k], "timed": timed[k], "max_abs_err": errs[k]["float32"],
                "max_abs_err_bf16": errs[k]["bfloat16"], "report": report}

    return result("fwd"), result("bwd")


def attn_inputs(BH, S, D, dtype, seed, device):
    """q, k, v in `dtype`, an f32 incoming gradient, and a key bias with a
    masked tail of another length in every (batch, head) but the first."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(BH, S, D)).astype(np.float32)).to(device)
                  for _ in range(4))
    mask = np.ones((BH, S), np.float32)
    for b in range(1, BH):
        mask[b, S - (b * S) // (2 * BH) - 1:] = 0.0
    bias = torch.from_numpy((1.0 - mask) * -1e9).float().to(device)
    return q.to(dtype), k.to(dtype), v.to(dtype), bias, g


def attn_bounds(BH, S, D, dtype) -> dict:
    """Least times for the three attention kernels: every input read once and
    every output written once over HBM (q, k, v, bias -> o f32, lse; those,
    the f32 do, lse, dsum -> dq; -> dk, dv), against the operations of the 2,
    3 and 4 S x S x D products (2 S^2 D each) over the card's dense bf16
    tensor-core peak for bf16 operands (the TPU kernel's products take bf16
    operands) and over its f32 peak for f32 operands."""
    w = torch.finfo(dtype).bits // 8
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    n, vec = BH * S * D, BH * S * 4
    work = {"flash_fwd": (3 * n * w + vec + n * 4 + vec, 4),
            "flash_bwd_dq": (3 * n * w + n * 4 + 3 * vec + n * w, 6),
            "flash_bwd_dkv": (3 * n * w + n * 4 + 3 * vec + 2 * n * w, 8)}
    out = {}
    for name, (nbytes, products) in work.items():
        flops = float(products) * BH * S * S * D
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
        out[name] = {"bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops, "peak_flops": peak}
    return out


def check_attn_mask(kattn, hashes, BH, S, D, seed, device, dtype=torch.float32) -> None:
    """The three kernels' keep mask against the plain hash, bit for bit, D
    columns of the S x S mask at a time, with q, k, v in `dtype`.  With q = 0
    and no bias every probability is 1 / S (forward) or, with lse = 0, exactly
    1 (backward).  Forward: v a shifted identity, so o S (1 - rate) is the
    mask's columns off .. off + D.  dk/dv: do a shifted identity, so dv
    (1 - rate) is the mask's rows off .. off + D, transposed.  dq: do = 1, v =
    1 / D, dsum = 0, so ds is the scaled mask, and k a shifted identity picks
    its columns.  In bf16 every value is exact but the scaled keep 1 / (1 -
    rate), which rounds to nearest: the ratio still rounds to 1 or 0."""
    rate, ks = ATTN_RATE, hashes.keep_scale(ATTN_RATE)
    s = torch.tensor([seed], dtype=torch.int32, device=device)
    want = hashes.attention_keep_mask((BH, S, S), rate, s)
    if not 0 < want.mean().item() < 1:
        raise AssertionError(f"degenerate attention mask at {(BH, S, D, seed)}")
    zeros = torch.zeros(BH, S, D, device=device, dtype=dtype)
    ones = torch.ones(BH, S, D, device=device)
    vec0 = torch.zeros(BH, S, device=device)
    scale = kattn.softmax_scale(D)
    idx = torch.arange(D, device=device)
    for off in range(0, S, D):
        n = min(D, S - off)
        shifted = torch.zeros(BH, S, D, device=device)
        shifted[:, off + idx[:n], idx[:n]] = 1.0
        o, _ = kattn.flash_attention_fwd(zeros, zeros, shifted.to(dtype), vec0, s, rate)
        _, dv = kattn.flash_attention_bwd_dkv(zeros, zeros, zeros, vec0, s, shifted, vec0,
                                              vec0, rate)
        dq = kattn.flash_attention_bwd_dq(zeros, shifted.to(dtype), (ones / D).to(dtype), vec0,
                                          s, ones, vec0, vec0, rate)
        torch.cuda.synchronize()
        got = {"flash_fwd": (o * S / ks).round()[:, :, :n],
               "flash_bwd_dkv": (dv.float() / ks).round()[:, :, :n].transpose(1, 2),
               "flash_bwd_dq": (dq.float() / (scale * ks)).round()[:, :, :n]}
        for name, mask in got.items():
            block = want[:, off:off + n, :] if name == "flash_bwd_dkv" else want[:, :, off:off + n]
            if not torch.equal(mask, block):
                raise AssertionError(f"{name}: keep mask differs from the hash at "
                                     f"{(BH, S, D, seed)} {dtype}, offset {off}")


@functools.lru_cache(maxsize=None)
def tensor_core_instructions(so_path) -> dict:
    """{function: {"HGMMA": lines, "HMMA": lines}} of a built library's SASS
    (cuobjdump -sass), for every kernel function (the bf16 instantiations
    are the `*_mma_kernel` and `*_wgmma_kernel` ones)."""
    from mmda_tpu_torch.ops.kernels import _build

    tool = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts: dict = {}
    function = None
    for line in sass.splitlines():
        if "Function : " in line:
            function = line.split("Function : ")[1].strip()
            counts[function] = {"HGMMA": 0, "HMMA": 0}
        elif function and ("HMMA" in line or "HGMMA" in line):
            counts[function]["HGMMA" if "HGMMA" in line else "HMMA"] += 1
    return counts


def tensor_core_counts(names) -> dict:
    """{kernel: {"bf16_kernels": HMMA/HGMMA lines in its bf16 `*_mma_kernel`
    and `*_wgmma_kernel` functions, "f32_kernels": in its f32
    `*_f32_wgmma_kernel` ones (the short-attention kernels of both routes),
    "all": in the whole library}}; raises where a bf16 kernel, or a short
    attention kernel's f32 design 0, has none (its products would not run on
    the tensor cores)."""
    from mmda_tpu_torch.ops.kernels import _build

    sass = {}
    for name in names:
        by_function = {f: sum(n.values())
                       for f, n in tensor_core_instructions(_build.library_path(name)).items()}
        bf16 = sum(n for f, n in by_function.items() if "mma_kernel" in f and "f32" not in f)
        f32 = sum(n for f, n in by_function.items() if "f32_wgmma_kernel" in f)
        sass[name] = {"bf16_kernels": bf16, "f32_kernels": f32,
                      "all": sum(by_function.values())}
        if bf16 == 0:
            raise AssertionError(f"{name}: no HMMA/HGMMA instruction in the SASS of its "
                                 "bf16 kernels")
        if name.startswith("short_attn") and f32 == 0:
            raise AssertionError(f"{name}: no HMMA/HGMMA instruction in the SASS of its "
                                 "f32 tensor-core kernels")
    return sass


def check_attn_kernels(kattn, hashes, device) -> dict:
    """`flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv` against their plain
    versions (mask bit for bit, outputs, gradients), then their times at the
    long step's shape beside `F.scaled_dot_product_attention` with the same
    additive mask and dropout_p (forward) and its `autograd.grad` (dq, dk and
    dv together: the library time of both backward rows).  Returns
    {kernel: result}."""
    import torch.nn.functional as F

    for BH, S, D, seed in [(3, 130, 64, 7), (2, 514, 64, 2 ** 31 - 2), (2, 130, 16, -5),
                           (2, 130, 40, 3)]:
        check_attn_mask(kattn, hashes, BH, S, D, seed, device)
    for (BH, S, D), seed in zip(ATTN_SHAPES, ATTN_MASK_SEEDS):
        check_attn_mask(kattn, hashes, BH, S, D, seed, device, torch.bfloat16)
    # the bf16 kernels run on the tensor cores: count them in the SASS
    sass = tensor_core_counts(FLASH)
    log("3 attn-sass", tensor_core_instructions=sass)
    rows = {k: [] for k in FLASH}
    seed = torch.tensor([12345], dtype=torch.int32, device=device)
    for BH, S, D in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            tol = ATTN_F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL
            q, k, v, bias, g = attn_inputs(BH, S, D, dtype, S + D, device)
            for rate in (0.0, ATTN_RATE):
                where = f"(BH,S,D)={(BH, S, D)} {dtype} rate={rate}"
                o, lse = kattn.flash_attention_fwd(q, k, v, bias, seed, rate)
                o2, lse2 = kattn.flash_attention_fwd(q, k, v, bias, seed, rate)
                if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                    raise AssertionError(f"two forward launches differ at {where}")
                o_w, lse_w = kattn.flash_attention_fwd_reference(q, k, v, bias, seed, rate)
                dsum = kattn.row_dsum(g, o_w)
                args = (q, k, v, bias, seed, g, lse_w, dsum, rate)
                dq = kattn.flash_attention_bwd_dq(*args)
                dk, dv = kattn.flash_attention_bwd_dkv(*args)
                again = (kattn.flash_attention_bwd_dq(*args),
                         *kattn.flash_attention_bwd_dkv(*args))
                if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
                    raise AssertionError(f"two backward launches differ at {where}")
                dq_w = kattn.flash_attention_bwd_dq_reference(*args)
                dk_w, dv_w = kattn.flash_attention_bwd_dkv_reference(*args)
                torch.cuda.synchronize()
                if o.dtype != torch.float32 or any(t.dtype != dtype for t in (dq, dk, dv)):
                    raise AssertionError(f"output dtype at {where}")
                shape = {"BH": BH, "S": S, "D": D, "dtype": str(dtype)[6:], "rate": rate}
                rows["flash_fwd"].append({**shape, "max_abs_err": max_err(
                    [("o", o, o_w), ("lse", lse, lse_w)],
                    ATTN_F32_TOL if dtype == torch.float32 else (ATTN_BF16_TOL[0], 0.0),
                    "flash_fwd " + where)})
                rows["flash_bwd_dq"].append({**shape, "max_abs_err": max_err(
                    [("dq", dq, dq_w)], tol, "flash_bwd_dq " + where)})
                rows["flash_bwd_dkv"].append({**shape, "max_abs_err": max_err(
                    [("dk", dk, dk_w), ("dv", dv, dv_w)], tol, "flash_bwd_dkv " + where)})
            del q, k, v, bias, g

    def worst(name, dtype):
        return max(r["max_abs_err"] for r in rows[name] if r["dtype"] == dtype)

    errs = {k: {d: worst(k, d) for d in ("float32", "bfloat16")} for k in FLASH}
    log("3 attn-kernels-vs-plain", checks=len(rows["flash_fwd"]),
        mask="equal bit for bit, f32 and bf16", repeat="the same bits twice, all three",
        max_abs_err=errs, tol={"float32": ATTN_F32_TOL, "bfloat16": ATTN_BF16_TOL})

    BH, S, _ = ATTN_REPORT
    B, nh = BH // 12, 12
    timed = {k: [] for k in FLASH}
    for D, dtype in [(ATTN_REPORT[2], torch.bfloat16), (ATTN_REPORT[2], torch.float32)] + [
            (d, torch.bfloat16) for d in ATTN_ANY_D_TIMED]:
        q, k, v, bias, g = attn_inputs(BH, S, D, dtype, 1, device)
        o, lse = kattn.flash_attention_fwd(q, k, v, bias, seed, ATTN_RATE)
        dsum = kattn.row_dsum(g, o)
        args = (q, k, v, bias, seed, g, lse, dsum, ATTN_RATE)
        # the library yardstick: (B, nh, S, D) views, the key bias as an additive mask
        lq, lk, lv = (t.view(B, nh, S, D).clone().requires_grad_(True) for t in (q, k, v))
        lmask = bias.view(B, nh, 1, S).to(dtype)
        lg = g.view(B, nh, S, D).to(dtype)

        def sdpa():
            return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask,
                                                  dropout_p=ATTN_RATE)

        lib_out = sdpa()

        def sdpa_bwd():
            return torch.autograd.grad(lib_out, [lq, lk, lv], lg, retain_graph=True)

        with torch.no_grad():
            lib_err = (F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask).float()
                       - kattn.flash_attention_fwd(q, k, v, bias, seed, 0.0)[0]
                       .view(B, nh, S, D)).abs().max().item()
        bounds = attn_bounds(BH, S, D, dtype)
        shape = {"BH": BH, "S": S, "D": D, "kernel_D": kattn.kernel_head_dim(D),
                 "dtype": str(dtype)[6:], "rate": ATTN_RATE}
        calls = {
            "flash_fwd": (lambda: kattn.flash_attention_fwd(q, k, v, bias, seed, ATTN_RATE),
                          lambda: kattn.flash_attention_fwd_reference(q, k, v, bias, seed,
                                                                      ATTN_RATE),
                          lambda: torch.no_grad()(sdpa)(),
                          "F.scaled_dot_product_attention(attn_mask, dropout_p)"),
            "flash_bwd_dq": (lambda: kattn.flash_attention_bwd_dq(*args),
                             lambda: kattn.flash_attention_bwd_dq_reference(*args), sdpa_bwd,
                             "autograd.grad of that call: dq, dk and dv together"),
            "flash_bwd_dkv": (lambda: kattn.flash_attention_bwd_dkv(*args),
                              lambda: kattn.flash_attention_bwd_dkv_reference(*args), sdpa_bwd,
                              "autograd.grad of that call: dq, dk and dv together")}
        for name, (kernel, plain, library, what) in calls.items():
            timed[name].append({**shape, **kernel_times(kernel, plain, library, 3, 1),
                                "library": what, "library_rate0_max_abs_err": lib_err,
                                **bounds[name]})
            log(f"3 {name}-time", **timed[name][-1])
        del q, k, v, bias, g, o, lse, dsum, args, lq, lk, lv, lg, lib_out
        torch.cuda.empty_cache()
    return {name: {"checks": rows[name], "timed": timed[name],
                   "max_abs_err": errs[name]["float32"],
                   "max_abs_err_bf16": errs[name]["bfloat16"], "report": timed[name][0],
                   **({"sass": sass[name]} if name in sass else {})}
            for name in FLASH}


def short_inputs(B, nh, S, hd, dtype, seed, device):
    """q, k, v and the incoming gradient in `dtype`, and a (B, S) key bias
    with a masked tail of another length in every batch item but the first."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, nh, S, hd)).astype(np.float32))
                  .to(device, dtype) for _ in range(4))
    mask = np.ones((B, S), np.float32)
    for b in range(1, B):
        mask[b, S - 1 - (b * S) // (2 * B):] = 0.0
    return q, k, v, g, torch.from_numpy((1.0 - mask) * -1e9).float().to(device)


def short_bounds(B, nh, S, hd, dtype) -> dict:
    """Least times of the two short attention kernels: q, k, v (and do)
    read once, o (dq, dk, dv) written once, the bias once, over HBM; against
    the 2 and 5 S x S x hd products (2 S^2 hd operations each) over the
    dense bf16 tensor-core peak for bf16 operands (a tensor-core kernel
    takes them as they are, and an f32 intermediate as bf16 terms) and, for
    f32 operands, over a sixth of it (PEAK_F32_TERMS_FLOPS): an f32-accurate
    product on the tensor cores is six bf16 term products, the least time
    the card takes for it, below the f32 FMA peak's."""
    w = torch.finfo(dtype).bits // 8
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_TERMS_FLOPS
    n, bias = B * nh * S * hd, B * S * 4
    out = {}
    for name, (nbytes, products) in {"short_attn_fwd": (4 * n * w + bias, 2),
                                     "short_attn_bwd": (7 * n * w + bias, 5)}.items():
        flops = 2.0 * products * B * nh * S * S * hd
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
        out[name] = {"bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops, "peak_flops": peak}
    return out


def masked_item_inputs(B, nh, S, hd, dtype, reach, device):
    """`short_inputs` with batch item 1's keys all masked and its q scaled
    so that the largest |s scale| of its scores is `reach`."""
    q, k, v, g, bias = short_inputs(B, nh, S, hd, dtype, S + hd + 3, device)
    bias[1] = -1e9
    scale = 1.0 / hd ** 0.5
    s1 = torch.einsum("hqd,hkd->hqk", q[1].float(), k[1].float()) * scale
    q[1] = (q[1].float() * (reach / s1.abs().max())).to(dtype)
    return q, k, v, g, bias


def masked_item_exact(kshort, q, k, v, bias, seed, g, rate, scores="f32"):
    """The tiled kernels' function in float64 on these inputs: the scores
    rounded in f32 as the plain version rounds them (which, at the mask's
    -1e9, decides which keys tie at a row's max), or with scores="float64"
    formed in float64 from the f32 q * scale (the function's own rounding of
    q * scale and none after it; for inputs whose bias is 0 or a masked
    tail), every step after them in float64: (o, dq, dk, dv)."""
    s, qs = (t.double() for t in kshort._scores(q, k, bias))
    if scores == "float64":
        s = torch.matmul(qs, k.double().transpose(-1, -2)) + bias.double()[:, None, None, :]
    keep = kshort._keep(q, seed, rate)
    keep = 1.0 if keep is None else keep.double()
    p = torch.softmax(s, -1)
    do, vd = g.double(), v.double()
    dp = torch.matmul(do, vd.transpose(-1, -2)) * keep
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (torch.matmul(p * keep, vd), torch.matmul(ds, k.double()) * kshort.softmax_scale(
        q.shape[-1]), torch.matmul(ds.transpose(-1, -2), qs),
            torch.matmul((p * keep).transpose(-1, -2), do))


def masked_item_case(kshort, B, nh, S, hd, dtype, reach, device) -> dict:
    """The tiled kernels' training forward and backward from its statistics
    on `masked_item_inputs` against the plain training forward and the plain
    backward from its statistics (the form the kernels take) at the gate (on
    the block route: the forward and the backward, against the plain ones),
    but for dq and dk of the masked item: its softmax is one-hot, so ds = p
    (dp - r) cancels to a few f32 ulps of dp in any order of summation (the
    plain forms from rowsum(dp p) and from rowsum(do o32) part by 2.35e-5 in
    dk at hd = 100, reach 40).  There the kernels are held to the float64
    evaluation of their function (`masked_item_exact`) at the gate widened
    by twice that noise: the plain version's largest distance from it in
    f32, before any rounding to the output's type.  A kernel that takes the
    masked rows' p wrong lands far outside either.  Raises past a bound;
    returns, by output, the masked item's largest errors from float64, the
    kernels' and the plain version's in f32."""
    seed = torch.tensor([4], dtype=torch.int32, device=device)
    q, k, v, g, bias = masked_item_inputs(B, nh, S, hd, dtype, reach, device)
    f32 = [t.float() for t in (q, k, v)]
    if kshort.kernel_route(S, hd, dtype) == "block":
        got = (kshort.short_attention_fwd(q, k, v, bias, seed, ATTN_RATE),
               *kshort.short_attention_bwd(q, k, v, bias, seed, g, ATTN_RATE))
        plain, plain32 = ((kshort.short_attention_fwd_reference(*x, bias, seed, ATTN_RATE),
                           *kshort.short_attention_bwd_reference(*x, bias, seed, y, ATTN_RATE))
                          for x, y in (((q, k, v), g), (f32, g.float())))
    else:
        o, st, o32 = kshort.short_attention_fwd_train(q, k, v, bias, seed, ATTN_RATE)
        got = (o, *kshort.short_attention_bwd(q, k, v, bias, seed, g, ATTN_RATE, st, o32))
        o_w, st_w, o32_w = kshort.short_attention_fwd_train_reference(q, k, v, bias, seed,
                                                                      ATTN_RATE)
        plain = (o_w, *kshort.short_attention_bwd_reference(q, k, v, bias, seed, g, ATTN_RATE,
                                                            st_w, o32_w))
        plain32 = (o32_w, *kshort.short_attention_bwd_reference(
            *f32, bias, seed, g.float(), ATTN_RATE, st_w, o32_w))
    exact = masked_item_exact(kshort, q, k, v, bias, seed, g, ATTN_RATE)
    atol, rtol = SHORT_F32_TOL if dtype == torch.float32 else SHORT_BF16_TOL
    where = f"masked item (B,nh,S,hd)={(B, nh, S, hd)} {dtype} reach {reach}"
    out = {}
    for name, a, w, w32, x in zip(("o", "dq", "dk", "dv"), got, plain, plain32, exact):
        gated = [b for b in range(B) if b != 1 or name in ("o", "dv")]
        max_err([(name, a[gated], w[gated])], (atol, rtol), where)
        err = (a[1].double() - x[1]).abs()
        noise = (w32[1].double() - x[1]).abs().max().item()
        if name in ("dq", "dk") and (err - atol - rtol * x[1].abs() - 2 * noise).max() > 0:
            raise AssertionError(f"{where}: {name} of the masked item {err.max().item():.3e} "
                                 f"from float64, the plain version {noise:.3e} in f32")
        out[name] = {"err": err.max().item(), "plain_f32_err": noise}
    return out


def check_masked_items(kshort, device) -> dict:
    """`masked_item_case` at every MASKED_ITEM_SHAPES, MASKED_REACH, f32 and
    bf16; the largest errors from float64, the kernels' and the plain
    version's, by dtype."""
    worst = {}
    for (B, nh, S, hd), reach, dtype in itertools.product(
            MASKED_ITEM_SHAPES, MASKED_REACH, (torch.float32, torch.bfloat16)):
        case = masked_item_case(kshort, B, nh, S, hd, dtype, reach, device)
        row = worst.setdefault(str(dtype)[6:], {"err": 0.0, "plain_f32_err": 0.0})
        for r in case.values():
            row["err"] = max(row["err"], r["err"])
            row["plain_f32_err"] = max(row["plain_f32_err"], r["plain_f32_err"])
    out = {"shapes": MASKED_ITEM_SHAPES, "reach": MASKED_REACH, "from_float64": worst,
           "tol": {"float32": SHORT_F32_TOL, "bfloat16": SHORT_BF16_TOL}}
    log("3 short-masked-items", **out)
    return out


def check_short_mask(kshort, hashes, B, nh, S, seed, device, dtype=torch.float32) -> None:
    """The forward's and the backward's keep mask against the plain hash,
    bit for bit, with q, k, v in `dtype`: q = k = 0 and no bias make every
    probability 1 / S; with v a shifted identity (hd = min(S, 128), hd keys
    at a time) o S (1 - rate) is hd columns of the mask, and with do a
    shifted identity dv S (1 - rate) is hd rows of it, transposed.  In bf16
    the inputs are exact and each output is the scaled keep rounded once:
    the ratio still rounds to 1 or 0."""
    rate, ks = ATTN_RATE, hashes.keep_scale(ATTN_RATE)
    s = torch.tensor([seed], dtype=torch.int32, device=device)
    b = torch.arange(B, device=device).reshape(B, 1, 1, 1)
    h = torch.arange(nh, device=device).reshape(1, nh, 1, 1)
    want = hashes.short_attention_keep_mask(S, rate, s, b, h)
    if not 0 < want.mean().item() < 1:
        raise AssertionError(f"degenerate short attention mask at {(B, nh, S, seed)}")
    hd = min(S, kshort.MAX_HD)
    zeros = torch.zeros(B, nh, S, hd, device=device, dtype=dtype)
    bias = torch.zeros(B, S, device=device)
    idx = torch.arange(hd, device=device)
    where = f"{(B, nh, S, seed)} {dtype}"
    for off in range(0, S, hd):
        n = min(hd, S - off)
        shifted = torch.zeros(B, nh, S, hd, device=device, dtype=dtype)
        shifted[:, :, off + idx[:n], idx[:n]] = 1.0
        o = kshort.short_attention_fwd(zeros, zeros, shifted, bias, s, rate)
        _, _, dv = kshort.short_attention_bwd(zeros, zeros, zeros, bias, s, shifted, rate)
        torch.cuda.synchronize()
        if not torch.equal((o.float() * S / ks).round()[..., :n], want[..., off:off + n]):
            raise AssertionError(f"short attention forward: keep mask differs from the hash "
                                 f"at {where}, keys {off}..")
        if not torch.equal((dv.float() * S / ks).round()[..., :n].transpose(-1, -2),
                           want[..., off:off + n, :]):
            raise AssertionError(f"short attention backward: keep mask differs from the hash "
                                 f"at {where}, queries {off}..")


TILED_BWD_PARTS = {"r": "tiled_r", "dq": "tiled_dq", "dkv": "tiled_dkv"}
# short_attention._TILED_IMPL by dtype: design -> (name, whether a SASS
# function name is one of its kernels)
TILED_DESIGNS = {
    torch.bfloat16: {1: ("mma.sync, cp.async", lambda f: "_mma_kernel" in f),
                     0: ("wgmma, TMA", lambda f: "wgmma_kernel" in f and "f32" not in f)},
    torch.float32: {1: ("f32 FMAs", lambda f: "f32_kernel" in f),
                    0: ("wgmma, six bf16 term products", lambda f: "f32_wgmma_kernel" in f)}}
# short_attention._BLOCK_IMPL: the f32 block kernels' designs, named as above
BLOCK_F32_DESIGNS = TILED_DESIGNS[torch.float32]


def f32_designs(kshort, S, hd) -> tuple:
    """(the module constant that selects the f32 design on (S, hd)'s route,
    {design: (name, whether a SASS function name is one of its kernels)})."""
    if kshort.kernel_route(S, hd, torch.float32) == "block":
        return "_BLOCK_IMPL", BLOCK_F32_DESIGNS
    return "_TILED_IMPL", TILED_DESIGNS[torch.float32]


def from_float64(kshort, inputs, rate, got, scores="float64") -> dict:
    """How far the kernels' (o, dq, dk, dv) and the plain versions'
    (cuBLAS in f32) lie from the float64 evaluation of the function on the
    same inputs (`masked_item_exact`, its scores in float64): {output:
    [kernel's largest |error|, the plain version's]}.  With scores="f32"
    the evaluation takes the plain version's f32 scores: a distance from
    cuBLAS's own rounding of s, which the f32 FMA kernels (the same FMA
    chain) meet by construction and a kernel that forms s more exactly does
    not, by about the plain version's own error times the softmax's
    peak."""
    q, k, v, bias, seed, g = inputs
    exact = masked_item_exact(kshort, q, k, v, bias, seed, g, rate, scores)
    plain = (kshort.short_attention_fwd_reference(q, k, v, bias, seed, rate),
             *kshort.short_attention_bwd_reference(q, k, v, bias, seed, g, rate))
    out = {name: [(a.double() - x).abs().max().item(), (w.double() - x).abs().max().item()]
           for name, a, w, x in zip(("o", "dq", "dk", "dv"), got, plain, exact)}
    del exact, plain
    torch.cuda.empty_cache()
    return out


PEAKED_Q = (4.0, 8.0)              # q's factors in `peaked_scores`: scores of spread 4 and 8
PEAKED_TIMES = 2.0                 # o, dq, dk, dv from float64 within this many times
                                   # the plain version's distance


def peaked_check(kshort, inputs, q_factor, rate) -> dict:
    """Both f32 designs of the inputs' route on them, q times q_factor (a softmax
    as peaked as a trained model's can be): each output's largest |err|
    against the plain version over the f32 gate (1e-5 + 1e-5 |ref|;
    recorded: two f32 forms of s part by a few ulps of |s|, which the
    peaked softmax carries into every output, so at spread 8 dk leaves the
    gate in both designs), and `from_float64`'s two distances, with the
    scores in float64 (held) and as the plain version rounds them
    (`from_plain_scores`, recorded).  Each output must lie from float64
    within PEAKED_TIMES the plain version's distance: a design whose f32
    sums drift with the scores' size (the tensor cores truncate theirs)
    fails here.  Raises past it."""
    q, k, v, bias, seed, g = inputs
    peaked = (q * q_factor, k, v, bias, seed, g)
    qp = peaked[0]
    atol, rtol = SHORT_F32_TOL
    want = (kshort.short_attention_fwd_reference(qp, k, v, bias, seed, rate),
            *kshort.short_attention_bwd_reference(qp, k, v, bias, seed, g, rate))
    out = {"q_factor": q_factor}
    constant, designs = f32_designs(kshort, *q.shape[2:])
    for impl, (name, _) in designs.items():
        with replaced(kshort, constant, impl):
            got = (kshort.short_attention_fwd(qp, k, v, bias, seed, rate),
                   *kshort.short_attention_bwd(qp, k, v, bias, seed, g, rate))
        far = from_float64(kshort, peaked, rate, got)
        out[name] = {
            "gate_share": {n: ((a - w).abs() / (atol + rtol * w.abs())).max().item()
                           for n, a, w in zip(("o", "dq", "dk", "dv"), got, want)},
            "from_float64": far,
            "from_plain_scores": from_float64(kshort, peaked, rate, got, scores="f32")}
        del got
        for n, (ours, plain) in far.items():
            if ours > PEAKED_TIMES * plain:
                raise AssertionError(
                    f"{tuple(q.shape)} q x {q_factor}, design {name}: {n} lies {ours:.3e} "
                    f"from float64, the plain version {plain:.3e}")
    return out


def peaked_scores(kshort, inputs) -> list:
    """`peaked_check` at each PEAKED_Q at rate ATTN_RATE."""
    return [peaked_check(kshort, inputs, f, ATTN_RATE) for f in PEAKED_Q]


F32_SMALL_HD = [(2, 4, 257, 8), (2, 2, 129, 33)]   # f32 head dims the six-term design pads


def f32_small_hd_times(kshort, device) -> list:
    """Both f32 tiled designs at F32_SMALL_HD, rate ATTN_RATE, timed in
    turns (each, then each again in reverse; the smaller of a design's two
    device times): the forward and the backward from the saved statistics."""
    seed = torch.tensor([7], dtype=torch.int32, device=device)
    order = list(TILED_DESIGNS[torch.float32])
    rows = []
    for B, nh, S, hd in F32_SMALL_HD:
        q, k, v, g, bias = short_inputs(B, nh, S, hd, torch.float32, S + hd, device)
        row = {"B": B, "nh": nh, "S": S, "hd": hd}
        for impl in order + order[::-1]:
            name = TILED_DESIGNS[torch.float32][impl][0]
            with replaced(kshort, "_TILED_IMPL", impl):
                saved = kshort.short_attention_fwd_train(q, k, v, bias, seed, ATTN_RATE)[1:]
                fns = {"fwd_ms": lambda: kshort.short_attention_fwd(q, k, v, bias, seed,
                                                                    ATTN_RATE),
                       "bwd_ms": lambda: kshort.short_attention_bwd(q, k, v, bias, seed, g,
                                                                    ATTN_RATE, *saved)}
                times = row.setdefault(name, {"fwd_ms": [], "bwd_ms": []})
                for key, fn in fns.items():
                    times[key].append(device_time(fn, cuda_ms(fn))[0])
        for name, _ in TILED_DESIGNS[torch.float32].values():
            row[name] = {key: min(t) for key, t in row[name].items()}
        rows.append(row)
        del q, k, v, g, bias, saved
    return rows


def tiled_extras(kshort, inputs, saved) -> tuple:
    """The tiled rows' numbers beyond `kernel_times` at the report shape,
    (forward's, backward's): the training forward's device ms; the parts of
    the backward from the saved statistics (r, dq, dk/dv: profiler medians
    by kernel name), the standalone backward's ms and parts (the forward's
    kernel first, for the statistics); each design of the kernels in the
    inputs' dtype (`TILED_DESIGNS`) timed in turns (each, then each again in
    reverse; the smaller of its two times), with its parts, its HGMMA and
    HMMA lines, its error against the plain versions (which it must meet)
    and, in f32, how far it and the plain versions lie from float64
    (`from_float64`), there and on peaked scores (`peaked_scores`)."""
    from mmda_tpu_torch.ops.kernels import _build

    q, k, v, bias, seed, g = inputs

    def ms(fn):
        return device_time(fn, cuda_ms(fn))[0]

    def fwd():
        return kshort.short_attention_fwd(q, k, v, bias, seed, ATTN_RATE)

    def bwd():
        return kshort.short_attention_bwd(q, k, v, bias, seed, g, ATTN_RATE, *saved)

    def alone():
        return kshort.short_attention_bwd(q, k, v, bias, seed, g, ATTN_RATE)

    f = {"train_ms": ms(lambda: kshort.short_attention_fwd_train(q, k, v, bias, seed,
                                                                 ATTN_RATE))}
    b = {"parts_ms": bwd_parts(bwd, TILED_BWD_PARTS), "standalone_ms": ms(alone),
         "standalone_parts_ms": bwd_parts(alone, {"stats": "tiled_fwd", **TILED_BWD_PARTS})}
    tol = SHORT_BF16_TOL if q.dtype == torch.bfloat16 else SHORT_F32_TOL
    o_w = kshort.short_attention_fwd_reference(q, k, v, bias, seed, ATTN_RATE)
    grads_w = kshort.short_attention_bwd_reference(q, k, v, bias, seed, g, ATTN_RATE)
    sass = {name: tensor_core_instructions(_build.library_path(name))
            for name in kshort.ROUTE_SOURCES["tiled"]}
    designs: dict = {}
    order = list(TILED_DESIGNS[q.dtype])
    for impl in order + order[::-1]:
        name, _ = TILED_DESIGNS[q.dtype][impl]
        with replaced(kshort, "_TILED_IMPL", impl):
            row = designs.setdefault(name, {"fwd_ms": [], "bwd_ms": []})
            where = f"{tuple(q.shape)} {q.dtype}, design {name}"
            got = (fwd(), *bwd())
            row["max_abs_err"] = max_err(zip(("o", "dq", "dk", "dv"), got, (o_w, *grads_w)),
                                         tol, where)
            if q.dtype == torch.float32 and "from_float64" not in row:
                row["from_float64"] = from_float64(kshort, inputs, ATTN_RATE, got)
            del got
            row["fwd_ms"].append(ms(fwd))
            row["bwd_ms"].append(ms(bwd))
            row["parts_ms"] = bwd_parts(bwd, TILED_BWD_PARTS)
    for name, ours in TILED_DESIGNS[q.dtype].values():
        row = designs[name]
        row["fwd_ms"], row["bwd_ms"] = min(row["fwd_ms"]), min(row["bwd_ms"])
        row["sass"] = {src: {fn: n for fn, n in by_fn.items() if ours(fn) and any(n.values())}
                       for src, by_fn in sass.items()}
    keys = ("max_abs_err", "sass") + (("from_float64",) if q.dtype == torch.float32 else ())
    f["designs"] = {name: {"fwd_ms": row["fwd_ms"], **{k: row[k] for k in keys}}
                    for name, row in designs.items()}
    if q.dtype == torch.float32:
        f["peaked"] = peaked_scores(kshort, inputs)
    b["designs"] = {name: {"bwd_ms": row["bwd_ms"], "parts_ms": row["parts_ms"],
                           **{k: row[k] for k in keys}} for name, row in designs.items()}
    return f, b


def block_extras(kshort, inputs) -> tuple:
    """The f32 block rows' numbers beyond `kernel_times` at the report shape,
    (forward's, backward's): each f32 design of the block kernels
    (`BLOCK_F32_DESIGNS`) timed in turns (each, then each again in reverse;
    the smaller of its two device times), with its HGMMA and HMMA lines, its
    error against the plain versions (which it must meet) and how far it
    and the plain versions lie from float64 (`from_float64`), there and on
    peaked scores (`peaked_scores`); and, as a yardstick, the tiled route's
    kernels at the same shape (`kernel_route` replaced for the timing): the
    forward and the backward from the training forward's statistics; both
    designs at SHORT_BUCKETS in turns (`buckets_ms`)."""
    from mmda_tpu_torch.ops.kernels import _build

    q, k, v, bias, seed, g = inputs

    def ms(fn):
        return device_time(fn, cuda_ms(fn))[0]

    def fwd():
        return kshort.short_attention_fwd(q, k, v, bias, seed, ATTN_RATE)

    def bwd():
        return kshort.short_attention_bwd(q, k, v, bias, seed, g, ATTN_RATE)

    o_w = kshort.short_attention_fwd_reference(q, k, v, bias, seed, ATTN_RATE)
    grads_w = kshort.short_attention_bwd_reference(q, k, v, bias, seed, g, ATTN_RATE)
    sass = {name: tensor_core_instructions(_build.library_path(name))
            for name in kshort.ROUTE_SOURCES["block"]}
    designs: dict = {}
    order = list(BLOCK_F32_DESIGNS)
    for impl in order + order[::-1]:
        name, _ = BLOCK_F32_DESIGNS[impl]
        with replaced(kshort, "_BLOCK_IMPL", impl):
            row = designs.setdefault(name, {"fwd_ms": [], "bwd_ms": []})
            got = (fwd(), *bwd())
            row["max_abs_err"] = max_err(zip(("o", "dq", "dk", "dv"), got, (o_w, *grads_w)),
                                         SHORT_F32_TOL, f"{tuple(q.shape)} f32, design {name}")
            row.setdefault("from_float64", from_float64(kshort, inputs, ATTN_RATE, got))
            del got
            row["fwd_ms"].append(ms(fwd))
            row["bwd_ms"].append(ms(bwd))
    for name, ours in BLOCK_F32_DESIGNS.values():
        row = designs[name]
        row["fwd_ms"], row["bwd_ms"] = min(row["fwd_ms"]), min(row["bwd_ms"])
        row["sass"] = {src: {fn: n for fn, n in by_fn.items() if ours(fn) and any(n.values())}
                       for src, by_fn in sass.items()}
    with replaced(kshort, "kernel_route", lambda S, hd, dtype=torch.float32: "tiled"):
        saved = kshort.short_attention_fwd_train(q, k, v, bias, seed, ATTN_RATE)[1:]
        tiled = {"fwd_ms": ms(fwd), "bwd_ms": ms(lambda: kshort.short_attention_bwd(
            q, k, v, bias, seed, g, ATTN_RATE, *saved))}
    del saved
    keys = ("max_abs_err", "sass", "from_float64")
    f = {"designs": {name: {"fwd_ms": row["fwd_ms"], **{k: row[k] for k in keys}}
                     for name, row in designs.items()},
         "tiled_route_ms": tiled["fwd_ms"], "peaked": peaked_scores(kshort, inputs)}
    b = {"designs": {name: {"bwd_ms": row["bwd_ms"], **{k: row[k] for k in keys}}
                     for name, row in designs.items()},
         "tiled_route_ms": tiled["bwd_ms"]}
    # the serving buckets' calls (S = 66: two warpgroups a block), both designs
    for shape in SHORT_BUCKETS:
        q, k, v, g, bias = short_inputs(*shape, torch.float32, 2, q.device)
        times = {}
        for impl in order + order[::-1]:
            name = BLOCK_F32_DESIGNS[impl][0]
            with replaced(kshort, "_BLOCK_IMPL", impl):
                times.setdefault(name, []).append((ms(fwd), ms(bwd)))
        for i, row in enumerate((f, b)):
            row.setdefault("buckets_ms", {})[str(shape)] = {
                name: min(t[i] for t in ts) for name, ts in times.items()}
    return f, b


def check_short_kernels(kshort, hashes, device) -> dict:
    """The short attention kernels of both routes against their plain
    versions (mask bit for bit, outputs, gradients, two launches the same
    bits): `short_attn_fwd` / `short_attn_bwd` (one block per (b, h)) at
    SHORT_SHAPES, `short_attn_tiled_fwd` / `short_attn_tiled_bwd` (query and
    key tiles) at SHORT_TILED_SHAPES, each call launching its route's kernel
    once and no other; hd > 128 refused; then each route's times at its
    report shape (the fused flagship step's, the fused long step's) beside
    `F.scaled_dot_product_attention` with the same additive mask and
    dropout_p (forward) and its `autograd.grad` (backward).  Returns
    {kernel: result}."""
    import torch.nn.functional as F

    names = kshort.SOURCES
    for B, nh, S, seed in SHORT_MASKS:
        for dtype in (torch.float32, torch.bfloat16):
            check_short_mask(kshort, hashes, B, nh, S, seed, device, dtype)
    # the bf16 kernels run on the tensor cores: count them in the SASS
    sass = tensor_core_counts(names)
    log("3 short-sass", tensor_core_instructions=sass)
    rows = {k: [] for k in names}
    seed = torch.tensor([12345], dtype=torch.int32, device=device)
    for B, nh, S, hd in SHORT_SHAPES + SHORT_TILED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            tol = SHORT_F32_TOL if dtype == torch.float32 else SHORT_BF16_TOL
            fwd, bwd = kshort.ROUTE_SOURCES[kshort.kernel_route(S, hd, dtype)]
            if (S > kshort.MAX_S) != (fwd == "short_attn_tiled_fwd"):
                raise AssertionError(f"{(B, nh, S, hd)} {dtype} routed to {fwd}")
            q, k, v, g, bias = short_inputs(B, nh, S, hd, dtype, S + hd, device)
            for rate in (0.0, ATTN_RATE):
                where = f"(B,nh,S,hd)={(B, nh, S, hd)} {dtype} rate={rate}"
                counts_before = {n: kshort.launch_count(n) for n in names}
                o = kshort.short_attention_fwd(q, k, v, bias, seed, rate)
                grads = kshort.short_attention_bwd(q, k, v, bias, seed, g, rate)
                launched = {n: kshort.launch_count(n) - c for n, c in counts_before.items()}
                if launched != {n: int(n in (fwd, bwd)) for n in names}:
                    raise AssertionError(f"launches {launched} at {where}")
                if not torch.equal(o, kshort.short_attention_fwd(q, k, v, bias, seed, rate)):
                    raise AssertionError(f"two forward launches differ at {where}")
                again = kshort.short_attention_bwd(q, k, v, bias, seed, g, rate)
                if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                    raise AssertionError(f"two backward launches differ at {where}")
                if fwd == "short_attn_tiled_fwd":   # the training path: the same bits
                    o_t, st, o32 = kshort.short_attention_fwd_train(q, k, v, bias, seed, rate)
                    saved = kshort.short_attention_bwd(q, k, v, bias, seed, g, rate, st, o32)
                    if not (torch.equal(o_t, o) and all(map(torch.equal, saved, grads))):
                        raise AssertionError(f"the training forward or the backward from its "
                                             f"statistics differs at {where}")
                    del o_t, st, o32, saved
                o_w = kshort.short_attention_fwd_reference(q, k, v, bias, seed, rate)
                grads_w = kshort.short_attention_bwd_reference(q, k, v, bias, seed, g, rate)
                torch.cuda.synchronize()
                if any(t.dtype != dtype for t in (o, *grads)):
                    raise AssertionError(f"output dtype at {where}")
                shape = {"B": B, "nh": nh, "S": S, "hd": hd, "dtype": str(dtype)[6:],
                         "rate": rate}
                rows[fwd].append({**shape, "max_abs_err": max_err(
                    [("o", o, o_w)], tol, f"{fwd} " + where)})
                rows[bwd].append({**shape, "max_abs_err": max_err(
                    zip(("dq", "dk", "dv"), grads, grads_w), tol, f"{bwd} " + where)})
            del q, k, v, g, bias, o, grads, again, o_w, grads_w
    refused = []
    for B, nh, S, hd in SHORT_REFUSED:
        q, k, v, _, bias = short_inputs(B, nh, S, hd, torch.bfloat16, 0, device)
        try:
            kshort.short_attention_fwd(q, k, v, bias, None)
        except ValueError as e:
            refused.append({"S": S, "hd": hd, "error": str(e)[:120]})
        else:
            raise AssertionError(f"short attention took hd = {hd}")
    masked_items = check_masked_items(kshort, device)
    small_hd = f32_small_hd_times(kshort, device)
    log("3 short-tiled-f32-small-hd", designs=small_hd)

    def worst(name, dtype):
        return max(r["max_abs_err"] for r in rows[name] if r["dtype"] == dtype)

    errs = {k: {d: worst(k, d) for d in ("float32", "bfloat16")} for k in names}
    log("3 short-kernels-vs-plain", checks={k: len(r) for k, r in rows.items()},
        mask="equal bit for bit, f32 and bf16", repeat="the same bits twice, every kernel",
        max_abs_err=errs, tol={"float32": SHORT_F32_TOL, "bfloat16": SHORT_BF16_TOL},
        refused=[[r["S"], r["hd"]] for r in refused])

    timed = {k: [] for k in names}
    for (B, nh, S, hd), route in ((SHORT_REPORT, "block"), (SHORT_TILED_REPORT, "tiled")):
        fwd, bwd = kshort.ROUTE_SOURCES[route]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g, bias = short_inputs(B, nh, S, hd, dtype, 1, device)
            lq, lk, lv = (t.clone().requires_grad_(True) for t in (q, k, v))
            lmask = bias.view(B, 1, 1, S).to(dtype)

            def sdpa():
                return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask,
                                                      dropout_p=ATTN_RATE)

            lib_out = sdpa()

            def sdpa_bwd():
                return torch.autograd.grad(lib_out, [lq, lk, lv], g, retain_graph=True)

            with torch.no_grad():
                lib_err = (F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask).float()
                           - kshort.short_attention_fwd(q, k, v, bias, None).float()
                           ).abs().max().item()
            bounds = short_bounds(B, nh, S, hd, dtype)
            shape = {"B": B, "nh": nh, "S": S, "hd": hd, "dtype": str(dtype)[6:],
                     "rate": ATTN_RATE}
            # the training path's backward reads the training forward's statistics
            saved = (kshort.short_attention_fwd_train(q, k, v, bias, seed, ATTN_RATE)[1:]
                     if route == "tiled" else ())
            calls = {
                fwd: (lambda: kshort.short_attention_fwd(q, k, v, bias, seed, ATTN_RATE),
                      lambda: kshort.short_attention_fwd_reference(q, k, v, bias, seed,
                                                                   ATTN_RATE),
                      lambda: torch.no_grad()(sdpa)(),
                      "F.scaled_dot_product_attention(attn_mask, dropout_p)", "short_attn_fwd"),
                bwd: (lambda: kshort.short_attention_bwd(q, k, v, bias, seed, g, ATTN_RATE,
                                                         *saved),
                      lambda: kshort.short_attention_bwd_reference(q, k, v, bias, seed, g,
                                                                   ATTN_RATE),
                      sdpa_bwd, "autograd.grad of that call: dq, dk and dv", "short_attn_bwd")}
            extras = (tiled_extras(kshort, (q, k, v, bias, seed, g), saved)
                      if route == "tiled" else block_extras(kshort, (q, k, v, bias, seed, g))
                      if dtype == torch.float32 else ({}, {}))
            for (name, (kernel, plain, library, what, bound)), extra in zip(calls.items(),
                                                                            extras):
                timed[name].append({**shape, **kernel_times(kernel, plain, library),
                                    "library": what, "library_rate0_max_abs_err": lib_err,
                                    **bounds[bound], **extra})
                log(f"3 {name}-time", **timed[name][-1])
            del q, k, v, g, bias, lq, lk, lv, lib_out, saved
            torch.cuda.empty_cache()
    return {name: {"checks": rows[name], "timed": timed[name], "refused": refused,
                   **({"masked_items": masked_items, "f32_small_hd": small_hd}
                      if "tiled" in name else {}),
                   "max_abs_err": errs[name]["float32"],
                   "max_abs_err_bf16": errs[name]["bfloat16"], "report": timed[name][0],
                   **({"sass": sass[name]} if name in sass else {})}
            for name in names}


def multi_inputs(T, B, seed, device, klstm, hs=MULTI_HS, reverse=MULTI_REVERSE):
    """The directions' x_proj, w_hh_t, masks (each pair of directions, a
    tower, its own lengths, 1 and T among them), their saved ys and cs
    (plain version), and random incoming gradients dys and dh_fin."""
    x, w, m, lengths, dys, dh = [], [], [], [], [], []
    for d, H in enumerate(hs):
        xd, wd, md, ld = lstm_inputs(T, B, H, seed + d, device)
        rng = np.random.default_rng(seed + 100 + d)
        x.append(xd)
        w.append(wd)
        m.append(md if d % 2 == 0 else m[-1])          # a tower's two directions share it
        lengths.append(ld if d % 2 == 0 else lengths[-1])
        dys.append(torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32)).to(device))
        dh.append(torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).to(device))
    saved = [klstm.lstm_recurrence_reference(x[d], w[d], m[d], reverse[d], need_cs=True)
             for d in range(len(hs))]
    return x, w, m, lengths, [s[0] for s in saved], [s[1] for s in saved], dys, dh


def same_bits(pairs, where: str) -> None:
    """Raises unless every (name, got, want) pair is equal bit for bit."""
    for name, got, want in pairs:
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs at {where}: max |diff| "
                                 f"{(got - want).abs().max().item()}")


def multi_bounds(T, B, masks) -> tuple:
    """Least times of the two multi kernels: the sums over the four
    directions of the single-direction bounds (the forward writing cs too,
    as on the training path)."""
    out = []
    for fwd in (True, False):
        nbytes = flops = 0.0
        for H, m in zip(MULTI_HS, masks):
            if fwd:
                nbytes += 4 * (T * B * 4 * H + H * 4 * H + T * B + 2 * T * B * H + B * H)
                flops += float(m.sum()) * (8 * H * H + 19 * H)
            else:
                b = lstm_bwd_bound(T, B, H, m)
                nbytes, flops = nbytes + b["bytes"], flops + b["flops"]
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
        out.append({"bound_ms": max(t_bytes, t_ops) * 1e3,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "flops": flops, "serial_steps": T})
    return tuple(out)


@contextlib.contextmanager
def replaced(module, name, value):
    """module.name = value inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def compare_multi_plans(kmulti, klstm, T, B, x, w, m, rev, ys_w, cs_w, dys, dh) -> dict:
    """The tower pair's multi kernels (MULTI_HS: two visual, then two
    acoustic directions) under the launch plans that `lstm_multi.geometry`
    chose among, and the dW passes under three run counts, each timed in
    turns (candidates, then the same in reverse; the median of the two):
    the chosen plan; one block a row of every direction (two waves at
    B = 64); a visual row beside an acoustic one in a block (one wave, 480
    threads); two visual rows a block; the chosen plan's groups moved 96
    threads up, so that the build bounded at 480 threads runs the same rows;
    and the visual pair and the acoustic pair as two launches.  Device ms of
    the forward and the backward, and of the backward's dW passes."""
    n_sm = torch.cuda.get_device_properties(x[0].device).multi_processor_count
    v, a = kmulti.group_threads(MULTI_HS[0])[1], kmulti.group_threads(MULTI_HS[2])[1]
    chosen = kmulti.geometry(MULTI_HS, B, n_sm)
    plans = {"chosen": chosen,
             "one block a row": ((1, 1, 2 * B, 0, v), (1, 1, 3 * B, 0, v), (1, 1, 0, 0, a),
                                 (1, 1, B, 0, a)),
             "visual beside acoustic": ((1, 1, 0, a, v), (1, 1, B, a, v), (1, 1, 0, 0, a),
                                        (1, 1, B, 0, a)),
             "two visual rows a block": ((2, 1, 2 * B, 0, 288), (2, 1, 2 * B + -(-B // 2), 0, 288),
                                         (1, 1, 0, 0, a), (1, 1, B, 0, a))}
    if max(g[3] + g[4] for g in chosen) + 96 <= kmulti.MULTI_THREADS:
        plans["chosen, 480-thread build"] = tuple(g[:3] + (g[3] + 96, g[4]) for g in chosen)
    names = [n for n, p in plans.items() if n == "chosen" or p != chosen]

    def run(name, backward):
        if name == "two launches":
            halves = (slice(0, 2), slice(2, 4))
            if backward:
                return [kmulti.lstm_multi_recurrence_bwd(x[h], w[h], m[h], rev[h], ys_w[h],
                                                         cs_w[h], dys[h], dh[h]) for h in halves]
            return [kmulti.lstm_multi_recurrence(x[h], w[h], m[h], rev[h], True) for h in halves]
        with replaced(kmulti, "geometry", lambda hs, B_, n: plans[name]):
            if backward:
                return kmulti.lstm_multi_recurrence_bwd(x, w, m, rev, ys_w, cs_w, dys, dh)
            return kmulti.lstm_multi_recurrence(x, w, m, rev, True)

    times: dict = {}
    order = names + ["two launches"]
    for backward in (False, True):
        key = "bwd_ms" if backward else "fwd_ms"
        for name in order + order[::-1]:
            fn = lambda: run(name, backward)
            times.setdefault(name, {}).setdefault(key, []).append(device_time(fn, cuda_ms(fn))[0])
    splits = {"2 n_sm / D (chosen)": kmulti.dw_splits,
              "n_sm / D": lambda T_, B_, hs, n: [klstm.bwd_dw_splits(T_, B_, H, n // len(hs))
                                                 for H in hs],
              "n_sm": lambda T_, B_, hs, n: [klstm.bwd_dw_splits(T_, B_, H, n) for H in hs]}
    dw: dict = {}
    for name in list(splits) + list(splits)[::-1]:
        with replaced(kmulti, "dw_splits", splits[name]):
            part = bwd_parts(lambda: run("chosen", True), MULTI_BWD_PARTS)["dw"]
        dw.setdefault(name, {"runs": splits[name](T, B, MULTI_HS, n_sm), "dw_ms": []})
        dw[name]["dw_ms"].append(part)
    return {"plans": {n: {"plan": [list(g) for g in plans[n]] if n in plans else None,
                          **{k: statistics.median(t) for k, t in times[n].items()}}
                      for n in order},
            "dw_runs": {n: {"runs": r["runs"], "dw_ms": statistics.median(
                [t for t in r["dw_ms"] if isinstance(t, float)] or [float("nan")])}
                        for n, r in dw.items()}}


def check_multi_kernels(kmulti, klstm, device) -> tuple:
    """`lstm_multi_fwd` and `lstm_multi_bwd` at MULTI_CHECKS against their
    plain versions (KERNEL_TOL) and against four calls of `lstm_fwd` /
    `lstm_bwd`, whose passes every direction runs: ys, cs, h_fin and dx_proj
    bit for bit, dw_hh_t too where its runs of rows are the same; two
    launches give the same bits; the checks reach the serial passes' three
    instantiations.  Then, at MULTI_REPORT, their times beside those four
    calls and four cuDNN `nn.LSTM` calls (forward, or autograd.grad; no one
    PyTorch call computes the four directions, so `library_ms` is None), the
    time per serial step, the backward's parts, the launch geometry
    (registers, blocks, resident blocks an SM, waves), and the launch plans,
    which differ there, compared (`compare_multi_plans`).
    Returns (forward, backward) results."""
    from mmda_tpu_torch.ops.kernels._launch import bptt_instantiation

    rows = {"fwd": [], "bwd": []}
    timed = {"fwd": [], "bwd": []}
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    for T, B, hs, reverse in MULTI_CHECKS:
        rev, D = list(reverse), len(hs)
        x, w, m, lengths, ys_w, cs_w, dys, dh = multi_inputs(T, B, T, device, klstm, hs, rev)

        def fwd():
            return kmulti.lstm_multi_recurrence(x, w, m, rev, need_cs=True)

        def bwd():
            return kmulti.lstm_multi_recurrence_bwd(x, w, m, rev, ys_w, cs_w, dys, dh)

        (ys, cs, h_fin), (dx, dw) = fwd(), bwd()
        again = [*fwd(), *bwd()]
        want_f = kmulti.lstm_multi_recurrence_reference(x, w, m, rev, need_cs=True)
        want_b = kmulti.lstm_multi_recurrence_bwd_reference(x, w, m, rev, ys_w, cs_w, dys, dh)
        single_f = [klstm.lstm_recurrence(x[d], w[d], m[d], rev[d], need_cs=True)
                    for d in range(D)]
        single_b = [klstm.lstm_recurrence_bwd(x[d], w[d], m[d], ys_w[d], cs_w[d], dys[d], dh[d],
                                              None, rev[d]) for d in range(D)]
        torch.cuda.synchronize()
        where = f"(T,B)={(T, B)} H={hs}"
        outs = {"ys": ys, "cs": cs, "h_fin": h_fin, "dx_proj": dx, "dw_hh_t": dw}
        pairs_f = [(f"{n}[{d}]", outs[n][d], want_f[i][d])
                   for i, n in enumerate(("ys", "cs", "h_fin")) for d in range(D)]
        pairs_b = [(f"{n}[{d}]", outs[n][d], want_b[i][d])
                   for i, n in enumerate(("dx_proj", "dw_hh_t")) for d in range(D)]
        same_bits([(f"{n}[{d}] vs lstm_fwd", outs[n][d], single_f[d][i])
                   for i, n in enumerate(("ys", "cs", "h_fin")) for d in range(D)]
                  + [(f"dx_proj[{d}] vs lstm_bwd", dx[d], single_b[d][0]) for d in range(D)],
                  where)
        splits = kmulti.dw_splits(T, B, hs, n_sm)
        same_runs = [d for d, H in enumerate(hs) if splits[d] == klstm.bwd_dw_splits(T, B, H, n_sm)]
        same_bits([(f"dw_hh_t[{d}] vs lstm_bwd", dw[d], single_b[d][1]) for d in same_runs], where)
        dw_vs_single = max_err([(f"dw_hh_t[{d}] vs lstm_bwd", dw[d], single_b[d][1])
                                for d in range(D)], KERNEL_TOL, where)
        same_bits([(f"{n} twice", a[d], b[d]) for n, a, b in
                   zip(("ys", "cs", "h_fin", "dx_proj", "dw_hh_t"), (ys, cs, h_fin, dx, dw), again)
                   for d in range(D)], where)
        shape = {"T": T, "B": B, "H": list(hs)}
        rows["fwd"].append({**shape, "max_abs_err": max_err(pairs_f, KERNEL_TOL,
                                                            "lstm_multi_fwd " + where),
                            "vs_single_kernels": "bit-equal", "twice": "bit-equal"})
        rows["bwd"].append({**shape, "max_abs_err": max_err(pairs_b, KERNEL_TOL,
                                                            "lstm_multi_bwd " + where),
                            "vs_single_kernels": {"dx_proj": "bit-equal",
                                                  "dw_hh_t_bit_equal": same_runs,
                                                  "dw_hh_t_max_abs_err": dw_vs_single},
                            "twice": "bit-equal"})
        if (T, B) != MULTI_REPORT or tuple(hs) != MULTI_HS:
            continue

        packed = [dys[d] * m[d][..., None] for d in range(D)]   # no padded outputs in cuDNN's
        lib_f = [cudnn_fwd(x[d], w[d], lengths[d])[0] for d in range(D)]
        lib_b = [cudnn_bwd(x[d], w[d], lengths[d], packed[d].contiguous(), dh[d])[0]
                 for d in range(D)]
        bound_f, bound_b = multi_bounds(T, B, m)
        four_f = lambda: [klstm.lstm_recurrence(x[d], w[d], m[d], rev[d], need_cs=True)
                          for d in range(D)]
        four_b = lambda: [klstm.lstm_recurrence_bwd(x[d], w[d], m[d], ys_w[d], cs_w[d], dys[d],
                                                    dh[d], None, rev[d]) for d in range(D)]
        # the plain versions loop over T in Python: one call each
        rows_f = kernel_times(fwd, lambda: kmulti.lstm_multi_recurrence_reference(x, w, m, rev,
                                                                                  True),
                              lambda: [c() for c in lib_f], 1, 0)
        rows_b = kernel_times(bwd, lambda: kmulti.lstm_multi_recurrence_bwd_reference(
                                  x, w, m, rev, ys_w, cs_w, dys, dh),
                              lambda: [c() for c in lib_b], 1, 0)
        rows_b["parts_ms"] = bwd_parts(bwd, MULTI_BWD_PARTS)
        if isinstance(rows_b["parts_ms"]["bptt"], float):     # the serial pass alone
            rows_b["bptt_us_per_step"] = rows_b["parts_ms"]["bptt"] * 1e3 / T
        geometry = kmulti.launch_geometry(hs, B, device)
        # the plans differ here: a visual row beside an acoustic one
        plans = compare_multi_plans(kmulti, klstm, T, B, x, w, m, rev, ys_w, cs_w, dys, dh)
        log("3 lstm-multi-plans", T=T, B=B, **plans)
        for row in (rows_f, rows_b):      # no one PyTorch call computes the four directions
            row["four_cudnn_ms"] = row.pop("library_ms")
            row["four_cudnn_device_ms"] = row.pop("library_device_ms")
            row["library_ms"] = row["library_device_ms"] = None
            row["us_per_step"] = row["ms"] * 1e3 / T
        four = {}
        for k, fn in (("fwd", four_f), ("bwd", four_b)):
            call = cuda_ms(fn)
            four[f"four_lstm_{k}_ms"] = device_time(fn, call)[0]
            four[f"four_lstm_{k}_call_ms"] = call
        timed["fwd"].append({**shape, **rows_f, "four_lstm_fwd_ms": four["four_lstm_fwd_ms"],
                             "four_lstm_fwd_call_ms": four["four_lstm_fwd_call_ms"],
                             "four_cudnn": "four cuDNN nn.LSTM calls, one per direction",
                             "geometry": {"plan": geometry["plan"],
                                          **geometry["lstm_multi_fwd"]},
                             **bound_f})
        timed["bwd"].append({**shape, **rows_b, "four_lstm_bwd_ms": four["four_lstm_bwd_ms"],
                             "four_lstm_bwd_call_ms": four["four_lstm_bwd_call_ms"],
                             "four_cudnn": "autograd.grad of four cuDNN nn.LSTM calls",
                             "geometry": {"plan": geometry["plan"],
                                          "bptt": geometry["lstm_multi_bwd"]},
                             "plans_compared": plans, **bound_b})
        log("3 lstm-multi-fwd-time", **timed["fwd"][-1])
        log("3 lstm-multi-bwd-time", **timed["bwd"][-1])
    used = sorted({bptt_instantiation(H) for _, _, hs, _ in MULTI_CHECKS for H in hs})
    if used != [0, 11, 21]:
        raise AssertionError(f"MULTI_CHECKS reach the instantiations {used}, not 0, 11 and 21")
    worst = {k: max(r["max_abs_err"] for r in v) for k, v in rows.items()}
    log("3 lstm-multi-vs-plain", shapes=len(rows["fwd"]), max_abs_err=worst, tol=KERNEL_TOL,
        vs_single_kernels="bit-equal (dw_hh_t where its runs are the same)",
        twice="bit-equal", instantiations=used)

    def result(k):
        (report,) = timed[k]
        return {"checks": rows[k], "timed": timed[k], "max_abs_err": worst[k], "report": report}

    return result("fwd"), result("bwd")


# ---------------------------------------------------------------- serving


def all_launches(counts) -> dict:
    return {name: counts.launch_count(name) for name in counts.KERNELS}


def expected_launches(counts, some: dict) -> dict:
    """`some` and zero for every other kernel."""
    return {name: some.get(name, 0) for name in counts.KERNELS}


def spread_lengths(n, buckets, seed):
    """n request lengths taking every bucket in turn, random inside it."""
    rng = np.random.default_rng(seed)
    edges = [0] + sorted(buckets)
    return [int(rng.integers(edges[i % len(buckets)] + 1, edges[i % len(buckets) + 1] + 1))
            for i in range(n)]


def make_requests(lengths, cfg, seed):
    """Pre-tokenised requests of the given lengths, random ids and features."""
    rng = np.random.default_rng(seed)
    reqs = []
    for L in lengths:
        ids = np.concatenate([[101], rng.integers(1000, 30000, size=L), [102]])
        reqs.append({
            "text": rng.integers(0, cfg.vocab_size, size=L).astype(np.int32),
            "visual": rng.normal(size=(L, cfg.visual_size)).astype(np.float32),
            "acoustic": rng.normal(size=(L, cfg.acoustic_size)).astype(np.float32),
            "bert_ids": ids.astype(np.int32),
            "bert_type": np.zeros(L + 2, np.int32),
            "bert_mask": np.ones(L + 2, np.int32),
        })
    return reqs


def check_outputs(scores, labels, tcp, n, C, threshold):
    for name, a in (("scores", scores), ("labels", labels), ("tcp", tcp)):
        a = np.asarray(a)
        if a.shape != (n, C) or not np.isfinite(a).all():
            raise AssertionError(f"{name}: shape {a.shape} or non-finite values")
    scores = np.asarray(scores)
    if scores.min() < 0 or scores.max() > 1:
        raise AssertionError("scores outside [0, 1]")
    if not np.array_equal(np.asarray(labels), (scores > threshold).astype(np.float32)):
        raise AssertionError("labels are not the scores binarized at the threshold")


def post(url, req):
    body = json.dumps({k: v.tolist() for k, v in req.items()}).encode()
    with urllib.request.urlopen(urllib.request.Request(url + "/predict", data=body),
                                timeout=300) as r:
        return json.loads(r.read())


def serve_over_http(cfg, pred, requests, counts, kernel="lstm_fwd", per_call=None) -> dict:
    """The main path: requests from concurrent clients through the HTTP front
    end, the micro-batching server and the Predictor; the launch counts
    (`kernel`: the towers' forward recurrence; `per_call`: every kernel a
    Predictor call launches, by default LAUNCHES_PER_CALL of `kernel`) read
    around exactly this window."""
    from mmda_tpu_torch.cli.serve import serve

    httpd, psrv = serve(cfg, port=0, predictor=pred, timeout_s=300)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    try:
        calls0 = pred.stats["requests"]
        counts.reset_launch_count()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            replies = list(ex.map(lambda r: post(url, r), requests))
        wall = time.perf_counter() - t0
        launches = all_launches(counts)
        calls = pred.stats["requests"] - calls0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        psrv.close()
        thread.join(timeout=60)
    for rep in replies:
        check_outputs([rep["scores"]], [rep["labels"]], [rep["tcp"]], 1,
                      cfg.num_classes, cfg.threshold)
    per_call = per_call or {kernel: LAUNCHES_PER_CALL}
    if calls < 1 or launches != expected_launches(
            counts, {k: n * calls for k, n in per_call.items()}):
        raise AssertionError(f"kernel launches {launches} for {calls} Predictor calls; "
                             f"expected {per_call} per call, no other")
    return {"requests": len(requests), "predictor_calls": calls, "launches": launches[kernel],
            "launches_by_kernel": launches,
            "wall_s": wall, "requests_per_s": len(requests) / wall, "healthz": health["ok"]}


def bucket_latency(cfg, pred, device, recurrence=None) -> list:
    """Host wall time of Predictor calls (ending in the device-to-host copy)
    for a full batch of max_batch rows and for one request, per bucket, every
    request as long as the bucket: the median (min, max) of 10 calls.
    recurrence: None times the captured call, the kernel wrapper an eager
    one."""
    rows = []
    for b in sorted(cfg.bucket_sizes):
        reqs = make_requests([b] * pred.max_batch, cfg, seed=b)
        for n in (pred.max_batch, 1):
            pred(reqs[:n], recurrence=recurrence)
            t = host_ms(lambda i: pred(reqs[:n], recurrence=recurrence), 10)
            rows.append({"bucket": b, "batch": n, "ms": t["ms"], "ms_min": t["ms_min"],
                         "ms_max": t["ms_max"], "utterances_per_s": n / t["ms"] * 1e3})
    return rows


def profile_serving(cfg, pred, device, recurrence=None) -> dict:
    """Where a Predictor call's time goes (torch.profiler, 5 calls at the
    largest bucket, full batch): device busy time per call, the share of the
    wall time the card sits idle, and the kernels that take the most.
    recurrence: None profiles the captured call, the kernel wrapper an eager
    one."""
    reqs = make_requests([max(cfg.bucket_sizes)] * pred.max_batch, cfg, seed=7)
    pred(reqs, recurrence=recurrence)
    calls = 5

    def run():
        for _ in range(calls):
            pred(reqs, recurrence=recurrence)

    return {"bucket": max(cfg.bucket_sizes), "batch": pred.max_batch,
            **device_profile(run, calls, device)}


def kernel_vs_plain_recurrence(cfg, pred, reference) -> float:
    """The same batch through the same weights with the recurrence forced to
    the plain version (`reference`) by the `recurrence` argument."""
    reqs = make_requests(spread_lengths(40, cfg.bucket_sizes, 123), cfg, seed=123)
    got = pred(reqs)
    want = pred(reqs, recurrence=reference)
    check_outputs(got["scores"], got["labels"], got["tcp"], 40, cfg.num_classes,
                  cfg.threshold)
    if got["hidden"].shape != (40, 6 * cfg.hidden_size):
        raise AssertionError(f"hidden shape {got['hidden'].shape}")
    err = max(float(np.abs(got[k] - want[k]).max()) for k in ("scores", "tcp", "hidden"))
    if err > SERVE_TOL:
        raise AssertionError(f"kernel vs plain recurrence: {err} > {SERVE_TOL}")
    return err


def card_vs_cpu(device, **predictor_options) -> float:
    """A small f32 model (tiny BERT, narrow towers) gives the same outputs
    on the card, through the kernels, as on the CPU through the plain
    versions; `predictor_options` go to both Predictors (phase 13: int8
    BERT weights)."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.models import init_misa
    from mmda_tpu_torch.models.bert import BertConfig
    from mmda_tpu_torch.serving import Predictor

    cfg = Config(hidden_size=32, visual_size=35, acoustic_size=74,
                 compute_dtype="float32", bucket_sizes=(8, 16), device="cpu")
    model = init_misa(cfg, seed=1, bert_cfg=BertConfig.tiny(vocab_size=30522))
    preds = {d: Predictor(cfg, params=copy.deepcopy(model), bert_cfg=BertConfig.tiny(30522),
                          max_batch=8, device=d, **predictor_options)
             for d in ("cpu", str(device))}
    reqs = make_requests(spread_lengths(6, cfg.bucket_sizes, 5), cfg, seed=5)
    keys = ("scores", "tcp", "hidden")
    cpu = steady_on_cpu(lambda: [preds["cpu"](reqs)[k] for k in keys])
    card = preds[str(device)](reqs)
    err = max(float(np.abs(a - card[k]).max()) for a, k in zip(cpu, keys))
    if err > DEVICE_TOL:
        raise AssertionError(f"card vs CPU {predictor_options}: {err} > {DEVICE_TOL}")
    return err


# --------------------------------------------------------------- training


def full_length_split(n, seed, T=TRAIN_T, aligned=True) -> dict:
    """n synthetic MOSEI-shaped rows, every one T words long (the
    steady-state shape: the whole bucket is used); unaligned, the visual
    and acoustic streams fill their own 2T and 3T steps."""
    from mmda_tpu_torch.data.synthetic import SyntheticSpec, make_split

    split = make_split(SyntheticSpec(num_examples=n, max_len=T, seed=seed, aligned=aligned))
    split["lengths"][:] = T
    split["bert_mask"][:] = 1
    if not aligned:
        split["visual_lengths"][:] = split["visual"].shape[1]
        split["acoustic_lengths"][:] = split["acoustic"].shape[1]
    return split


def finite_losses(losses: dict, where: str) -> None:
    bad = [k for k, v in losses.items() if not np.isfinite(float(torch.as_tensor(v).detach()))]
    if bad:
        raise AssertionError(f"{where}: non-finite losses {bad}")


def train_main_path(counts, kind: str) -> tuple:
    """The main path: `Trainer.train()` for one epoch of full-length batches
    on the flagship config (with TRAIN_CONFIGS[kind]'s options, batch, length
    and step count), with dev eval, the best-on-dev export and test eval; the
    launch counts read around exactly this call.  Returns (trainer, result)."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.train.loop import Trainer
    from mmda_tpu_torch.utils.logging import MetricLogger

    spec = TRAIN_CONFIGS[kind]
    name = f"chip_smoke_train_{kind}"
    B, T, n_steps = (spec.get("batch", TRAIN_B), spec.get("T", TRAIN_T),
                     spec.get("steps", TRAIN_STEPS))
    cfg = Config(**{**dict(use_bert=True, data="mosei", batch_size=B, max_seq_len=T,
                           bucket_sizes=(T,), compute_dtype="bfloat16", n_epoch=1, seed=0,
                           name=name, ckpt_dir=str(BUILD / name)), **spec["options"]})
    aligned = spec.get("aligned", True)
    data = {"train": full_length_split(B * n_steps, 0, T, aligned),
            "dev": full_length_split(B, 1, T, aligned),
            "test": full_length_split(B, 2, T, aligned)}
    t0 = time.perf_counter()
    trainer = Trainer(cfg, data, logger=MetricLogger(("stdout",), run_name=cfg.name))
    build_s = time.perf_counter() - t0
    eval_batches = 2                                   # one dev, one test
    counts.reset_launch_count()
    t0 = time.perf_counter()
    summary = trainer.train()
    wall = time.perf_counter() - t0
    launches = all_launches(counts)
    want = expected_launches(counts, {
        k: n * n_steps + spec["per_eval"].get(k, 0) * eval_batches
        for k, n in spec["per_step"].items()})
    if launches != want:
        raise AssertionError(f"train(): kernel launches {launches}, expected {want}")
    epoch = summary["history"][0]
    finite_losses({k: v for k, v in epoch.items() if k.startswith("train_")}, "train()")
    counts = {"params_total": sum(p.numel() for p in trainer.model.parameters()),
              "params_trainable": sum(p.numel() for p in trainer.optimizer.params)}
    return trainer, {"build_s": build_s, "train_wall_s": wall, "launches": launches,
                     "steps": n_steps, "batch": B, "T": T, "epoch_time_s": epoch["epoch_time_s"],
                     "eval_time_s": epoch["eval_time_s"],
                     "post_eval_time_s": epoch["post_eval_time_s"],
                     "train_loss": epoch["train_loss"], "test_loss": summary["test_loss"],
                     **counts}


def train_timing(trainer, counts, kind: str, device, without=()) -> dict:
    """Host wall time of more steps (the configuration's "timed" count, by
    default one more epoch), each ending in a synchronize; launches per step;
    peak device memory.  without: kernels this run must not launch (the
    long-sequence step again with the dense attention core)."""
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.train.step import train_step

    cfg = trainer.cfg
    batches = list(ArrayLoader(trainer.data["train"], cfg.batch_size, shuffle=False,
                               bucket_sizes=cfg.bucket_sizes, device=device))
    n_timed = TRAIN_CONFIGS[kind].get("timed", len(batches))
    batches = [batches[i % len(batches)] for i in range(n_timed)]
    train_step(trainer.model, trainer.optimizer, batches[0], cfg, trainer.generator,
               trainer.ema)                       # warm-up: allocator, autotuned GEMMs
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    counts.reset_launch_count()
    times = []
    for batch in batches:
        t0 = time.perf_counter()
        losses = train_step(trainer.model, trainer.optimizer, batch, cfg,
                            trainer.generator, trainer.ema)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
        finite_losses(losses, "train_step")
    per_step = {k: n / len(batches) for k, n in all_launches(counts).items()}
    want = expected_launches(counts, {k: n for k, n in TRAIN_CONFIGS[kind]["per_step"].items()
                                      if k not in without})
    if per_step != want:
        raise AssertionError(f"launches per train step {per_step}, expected {want}")
    ms = statistics.median(times)
    return {"steps": len(times), "ms_per_step": ms, "ms_min": min(times),
            "ms_max": max(times), "utterances_per_s": cfg.batch_size / ms * 1e3,
            "launches_per_step": per_step,
            "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "losses": {k: float(v) for k, v in losses.items()}}


def device_profile(run, wall_calls: int, device,
                   name_filter=("lstm_fwd", "lstm_gates", "lstm_bptt", "lstm_dw")):
    """torch.profiler over `run()` (which makes wall_calls calls): device
    busy ms per call, the card's idle share of the wall time, and the
    kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        return {"device_busy_ms_per_call": "not measured"}
    by_name: dict = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"calls": wall_calls, "wall_ms_per_call": wall_ms / wall_calls,
            "device_busy_ms_per_call": busy_ms / wall_calls,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops_per_call": len(on_card) / wall_calls,
            **{f"{k}_ms_per_call": sum(v for n, v in by_name.items() if k in n) / wall_calls
               for k in name_filter},
            "top_ms_per_call": [[k[:80], v / wall_calls] for k, v in top]}


def profile_training(trainer, kind: str, device) -> dict:
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.train.step import train_step

    cfg = trainer.cfg
    batch = next(iter(ArrayLoader(trainer.data["train"], cfg.batch_size, shuffle=False,
                                  bucket_sizes=cfg.bucket_sizes, device=device)))
    steps = 3

    def run():
        for _ in range(steps):
            train_step(trainer.model, trainer.optimizer, batch, cfg, trainer.generator,
                       trainer.ema)

    run()
    return device_profile(run, steps, device, TRAIN_CONFIGS[kind]["profile"])


# The Linear layers whose outputs enter MISA's ReLU / LeakyReLU (the fusion
# layers' FFN, the shared/private projections, the discriminators): the step's
# gradient jumps where one of those inputs changes sign
KINKED_INPUTS = ("ffn1", "linear", "l1")
KINK_FLIPS_MAX = 1e-4             # a share of a layer's outputs that may change sign
KINK_GAP_MAX = 1e-3               # how far apart the two passes may put such an output


@contextlib.contextmanager
def same_relu_branches(model, recorded: dict, flips: dict, align: bool):
    """The kernel pass (align=False) records the outputs of the KINKED_INPUTS
    layers outside BERT; the plain pass (align=True) then takes, where one of
    its outputs has the other sign, the kernel pass's value (the gradient
    still flows through its own), so both passes differentiate the same
    branch of each ReLU / LeakyReLU.  Where a layer's outputs changed sign,
    flips["name[call]"] = (count, share, largest gap between the two passes);
    raises where the share or the gap exceeds KINK_FLIPS_MAX / KINK_GAP_MAX."""
    calls: dict = {}

    def hook(name):
        def on_output(module, inputs, out):
            if not align:               # a layer called more than once keeps every output
                recorded.setdefault(name, []).append(out.detach().clone())
                return None
            calls[name] = calls.get(name, -1) + 1
            key = f"{name}[{calls[name]}]"
            want = recorded[name][calls[name]]
            flip = (want > 0) != (out > 0)
            n = int(flip.sum())
            if not n:
                return None
            gap = float((want - out.detach()).abs()[flip].max())
            flips[key] = (n, n / flip.numel(), gap)
            if n / flip.numel() > KINK_FLIPS_MAX or gap > KINK_GAP_MAX:
                raise AssertionError(f"{name}: {n} outputs change sign between the kernel and "
                                     f"the plain pass, {gap} apart")
            return out + ((want - out) * flip).detach()
        return on_output

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
               if n.rsplit(".", 1)[-1] in KINKED_INPUTS and not n.startswith("bert.")]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def plain_versions(counts):
    """Inside the block BERT's fused LayerNorm sites and the attention
    kernels (flash and short) run their plain versions; the block must
    launch no kernel (the towers' recurrence is the caller's to replace)."""
    from mmda_tpu_torch.models import bert
    from mmda_tpu_torch.ops.kernels import attention as kattn
    from mmda_tpu_torch.ops.kernels import short_attention as kshort
    from mmda_tpu_torch.ops.kernels.layernorm import residual_dropout_layernorm_reference

    with contextlib.ExitStack() as stack:
        stack.enter_context(replaced(bert, "residual_dropout_layernorm",
                                     residual_dropout_layernorm_reference))
        for module, names in ((kattn, ("flash_attention_fwd", "flash_attention_bwd")),
                              (kshort, ("short_attention_fwd", "short_attention_bwd",
                                        "short_attention_fwd_train"))):
            for name in names:
                stack.enter_context(replaced(module, name, getattr(module, name + "_reference")))
        counts.reset_launch_count()
        yield
        if any(all_launches(counts).values()):
            raise AssertionError(f"the plain path made {all_launches(counts)} launches")


def grads_kernel_vs_plain(trainer, counts, kind: str, reference, device) -> tuple:
    """One step's gradients on the flagship model with the kernels against
    their plain versions: the towers' recurrence replaced by `reference`
    (autograd through its loop), the fused LayerNorm sites by their plain
    function and the attention kernels by their plain forward and explicit
    backward (flash and short).  The LSTM configuration runs with dropout
    off; the others with dropout on (the fused sites exist only then, and
    the attention kernels draw their mask only then), both passes drawing
    from the same generator state, so the seeds and every other dropout mask
    are the same.  Both passes take the same branch of every ReLU /
    LeakyReLU outside BERT (`same_relu_branches`): an input within float
    noise of 0 on which the two passes disagree would add a whole term to
    one pass's gradient and not to the other's.  Returns (max |err|, the
    sign changes aligned)."""
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.train.step import loss_and_grads

    cfg, model = trainer.cfg, trainer.model
    batch = next(iter(ArrayLoader(trainer.data["dev"], cfg.batch_size, shuffle=False,
                                  bucket_sizes=cfg.bucket_sizes, device=device)))
    model.train(TRAIN_CONFIGS[kind].get("dropout_on", False))
    params = trainer.optimizer.params
    state = trainer.generator.get_state()
    counts.reset_launch_count()
    recorded, flips = {}, {}
    with same_relu_branches(model, recorded, flips, align=False):
        got_l, got = loss_and_grads(model, batch, cfg, params, generator=trainer.generator)
    if all_launches(counts) != expected_launches(counts, TRAIN_CONFIGS[kind]["per_step"]):
        raise AssertionError(f"the kernel-path gradient made {all_launches(counts)} launches")
    trainer.generator.set_state(state)
    with plain_versions(counts):
        with same_relu_branches(model, recorded, flips, align=True):
            _, want = loss_and_grads(model, batch, cfg, params, recurrence=reference,
                                     generator=trainer.generator)
    finite_losses(got_l, "kernel-path step")
    err, excess = 0.0, 0.0
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        err = max(err, diff.max().item())
        excess = max(excess, (diff - BF16_ULP * w.float().abs()).max().item())
    if excess > TRAIN_TOL:
        raise AssertionError(f"step gradients, kernels vs plain versions: max |err| {err}, "
                             f"{excess} beyond one bf16 ulp > {TRAIN_TOL}")
    return err, flips


def train_card_vs_cpu(device, aligned=True, T=16, **options) -> float:
    """A small f32 model (tiny BERT, hidden 32; `options`: the towers' cell,
    the attention core, the model family) and one batch with ragged
    lengths up to T (unaligned: visual and acoustic on their own time axes): the
    step's gradients (dropout off) on the card, through the kernels, against
    the CPU, through the plain versions."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.data.synthetic import SyntheticSpec, make_split
    from mmda_tpu_torch.models import get_model
    from mmda_tpu_torch.models.bert import BertConfig
    from mmda_tpu_torch.train.step import loss_and_grads

    cfg = Config(hidden_size=32, compute_dtype="float32", batch_size=8, max_seq_len=T,
                 device="cpu", **options)
    split = make_split(SyntheticSpec(num_examples=8, max_len=T, seed=3, aligned=aligned))
    bert_cfg = BertConfig.tiny(vocab_size=30522)
    if cfg.moe_experts > 0:                 # the tiny BERT with a MoE in every layer
        bert_cfg = dataclasses.replace(bert_cfg, moe_experts=cfg.moe_experts,
                                       moe_capacity_factor=cfg.moe_capacity_factor,
                                       moe_top_k=cfg.moe_top_k)
    model = get_model(cfg.model)(cfg, bert_cfg=bert_cfg)
    model.reset_parameters(torch.Generator().manual_seed(1))
    model.eval()

    def run(dev):
        m = copy.deepcopy(model).to(dev)
        batch = next(iter(ArrayLoader(split, 8, shuffle=False, bucket_sizes=(T,),
                                      device=dev)))
        _, g = loss_and_grads(m, batch, cfg, list(m.parameters()))
        return [x.cpu() for x in g]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # at T = 130 some CPU op's sums follow the threads
    try:
        cpu = steady_on_cpu(lambda: run("cpu"))
    finally:
        torch.set_num_threads(threads)
    err = max((a - b).abs().max().item() for a, b in zip(cpu, run(device)))
    if err > DEVICE_TOL:
        raise AssertionError(f"step gradients, card vs CPU {options}: {err} > {DEVICE_TOL}")
    return err


def train_phases(phase, kind, reference, counts, device, small_T=16, **small_options):
    """Phase 5 (LSTM towers), 7 (GRU towers, fused LayerNorm sites), 8
    (the long-sequence step with the attention kernels), 9 (the short
    attention kernels) or 16 (the tiled short attention kernels at the long
    shape): the main path, timed and profiled steps, the kernels against
    their plain versions, a small f32 model (of length small_T) on the card
    against the CPU, then phase 11's captured steps and compiled train()."""
    trainer, path = train_main_path(counts, kind)
    log(f"{phase} train-main-path", **path)
    steps = train_timing(trainer, counts, kind, device)
    log(f"{phase} train-steps", **steps)
    prof = profile_training(trainer, kind, device)
    busy = prof["device_busy_ms_per_call"]
    if isinstance(busy, float):     # the profiler slows the host, not the card
        prof["idle_share_of_unprofiled_step"] = 1.0 - busy / steps["ms_per_step"]
    log(f"{phase} train-profile", **prof)
    err, flips = grads_kernel_vs_plain(trainer, counts, kind, reference, device)
    log(f"{phase} train-kernel-vs-plain", max_abs_err=err, tol=TRAIN_TOL,
        relu_sign_changes_aligned=flips)
    small_err = train_card_vs_cpu(device, T=small_T, **small_options)
    log(f"{phase} train-card-vs-cpu", max_abs_err=small_err, tol=DEVICE_TOL)
    captured = captured_steps(trainer, counts, kind, device)
    if isinstance(busy, float):
        captured["eager_idle_share_from_phase_profile"] = 1.0 - busy / steps["ms_per_step"]
    log("11 captured-steps", **captured)
    compiled = compiled_train(trainer, counts, kind, device)
    log("11 captured-train", **compiled)
    return trainer, {"main_path": path, "steps": steps, "profile": prof,
                     "kernel_vs_plain_err": err, "card_vs_cpu_err": small_err,
                     "captured": captured, "compiled_train": compiled}


def start_cli_train(options, per_call) -> dict:
    """Starts `python -m mmda_tpu_torch.cli.train --data synthetic --n_epoch 1`
    (and `options`) at the default widths (on the card, its default), its
    output into a log beside its checkpoint; `serve_cli_checkpoint` waits."""
    name = "chip_smoke_cli_" + "_".join(sorted(per_call))
    ckpt_dir = BUILD / name
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    args = ["--data", "synthetic", "--ckpt_dir", str(ckpt_dir), "--name", name, *options]
    log_path = ckpt_dir / "cli_train.log"
    with open(log_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "mmda_tpu_torch.cli.train", *args,
                                 "--n_epoch", "1"], cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT)
    return {"proc": proc, "args": args, "name": name, "ckpt_dir": ckpt_dir, "log": log_path,
            "per_call": per_call, "t0": time.perf_counter()}


def serve_cli_checkpoint(run: dict, device, counts) -> dict:
    """Waits for a `start_cli_train` run, then a Predictor loaded from the
    checkpoint it wrote answers a few requests in one call that launches
    the run's `per_call` kernels (by name) and no other."""
    from mmda_tpu_torch.config import get_config
    from mmda_tpu_torch.serving import Predictor

    try:
        code = run["proc"].wait(timeout=600)
    except subprocess.TimeoutExpired:
        run["proc"].kill()
        raise
    train_s = time.perf_counter() - run["t0"]
    if code != 0:
        raise RuntimeError(f"cli.train exit {code}:\n{run['log'].read_text()[-6000:]}")
    name, per_call = run["name"], run["per_call"]
    summary = json.loads((run["ckpt_dir"] / f"summary_{name}.json").read_text())
    cfg = get_config(argv=run["args"])
    pred = Predictor(cfg, visual_size=35, acoustic_size=74, max_batch=8, device=str(device))
    reqs = make_requests(spread_lengths(8, cfg.bucket_sizes, 9), cfg, seed=9)
    counts.reset_launch_count()
    got = pred(reqs)
    if all_launches(counts) != expected_launches(counts, per_call):
        raise AssertionError(f"Predictor call on the {name} checkpoint: launches "
                             f"{all_launches(counts)}")
    check_outputs(got["scores"], got["labels"], got["tcp"], 8, cfg.num_classes,
                  cfg.threshold)
    return {"train_s": train_s, "best_epoch": summary["best_epoch"],
            "test_loss": summary["test_loss"], "requests": len(reqs),
            "score_mean": float(np.mean(got["scores"]))}


def train_then_serve_all(device, counts) -> dict:
    """Every CLI_RUNS entry's `cli.train` (`start_cli_train`), the processes
    all at once on the card (nothing is timed beside them; each `train_s` is
    its process's wall time among the others), then each checkpoint's
    Predictor in turn (`serve_cli_checkpoint`); every process is ended
    before this returns.  {log line: result}, each also logged."""
    runs = {}
    out = {}
    try:
        for line, (options, per_call) in CLI_RUNS.items():
            runs[line] = start_cli_train(options, per_call)
        for line, run in runs.items():
            out[line] = serve_cli_checkpoint(run, device, counts)
            log(line, **out[line])
    finally:
        for run in runs.values():
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
    return out


def serve_long(cfg, counts, device) -> dict:
    """A `Predictor` with attn_impl="flash" on the checkpoint the
    long-sequence run wrote (one bucket of LONG_T, LONG_B rows a call) behind
    the HTTP front end: BERT_LAYERS `flash_fwd` and LAUNCHES_PER_CALL
    `lstm_fwd` launches per call, no backward kernel; then the same requests
    through the same weights with the dense core."""
    from mmda_tpu_torch.ops.kernels.lstm import lstm_recurrence
    from mmda_tpu_torch.serving import Predictor

    flash_cfg = cfg.replace(attn_impl="flash")
    pred = Predictor(flash_cfg, max_batch=LONG_B)
    rng = np.random.default_rng(3)
    lengths = [LONG_T, 1] + [int(n) for n in rng.integers(LONG_T // 4, LONG_T + 1, size=46)]
    requests = make_requests(lengths, flash_cfg, 3)
    out = serve_over_http(flash_cfg, pred, requests, counts,
                          per_call={"lstm_fwd": LAUNCHES_PER_CALL, "flash_fwd": BERT_LAYERS})
    batch = requests[:LONG_B]
    counts.reset_launch_count()
    got = pred(batch)
    if counts.launch_count("flash_fwd") != BERT_LAYERS:
        raise AssertionError(f"flash Predictor call: {all_launches(counts)}")
    times = []
    for _ in range(5):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        pred(batch)
        times.append((time.perf_counter() - t0) * 1e3)
    out["flash_ms_per_call"] = statistics.median(times)
    out["captured"] = serve_captured_vs_eager(flash_cfg, pred, lstm_recurrence, device)
    del pred
    torch.cuda.empty_cache()
    dense = Predictor(cfg.replace(attn_impl="xla"), max_batch=LONG_B)
    counts.reset_launch_count()
    want = dense(batch)
    if any(counts.launch_count(k) for k in FLASH):
        raise AssertionError(f"dense-core Predictor call: {all_launches(counts)}")
    times = []
    for _ in range(5):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dense(batch)
        times.append((time.perf_counter() - t0) * 1e3)
    out["dense_ms_per_call"] = statistics.median(times)
    check_outputs(got["scores"], got["labels"], got["tcp"], LONG_B, cfg.num_classes,
                  cfg.threshold)
    err = max(float(np.abs(got[k] - want[k]).max()) for k in ("scores", "tcp", "hidden"))
    if err > FLASH_SERVE_TOL:
        raise AssertionError(f"flash Predictor vs the dense core: {err} > {FLASH_SERVE_TOL}")
    out["flash_vs_dense_err"] = err
    return out


def serve_fused(cfg, counts, device) -> dict:
    """A `Predictor` with attn_impl="fused" on the checkpoint the fused run
    wrote, at the serving buckets 16/32/64 (B=64), behind the HTTP front end:
    BERT_LAYERS `short_attn_fwd` and LAUNCHES_PER_CALL `lstm_fwd` launches
    per call, no backward kernel; per-bucket latency; then the same requests
    through the same weights with the dense core (agreement within
    FLASH_SERVE_TOL, bf16) and its latency."""
    from mmda_tpu_torch.ops.kernels.lstm import lstm_recurrence
    from mmda_tpu_torch.serving import Predictor

    fused_cfg = cfg.replace(bucket_sizes=(16, 32, 64), max_seq_len=64)
    pred = Predictor(fused_cfg, max_batch=64)
    requests = make_requests(spread_lengths(48, fused_cfg.bucket_sizes, 11), fused_cfg, 11)
    per_call = {"lstm_fwd": LAUNCHES_PER_CALL, "short_attn_fwd": BERT_LAYERS}
    out = serve_over_http(fused_cfg, pred, requests, counts, per_call=per_call)
    batch = make_requests(spread_lengths(64, fused_cfg.bucket_sizes, 12), fused_cfg, 12)
    counts.reset_launch_count()
    got = pred(batch)
    if all_launches(counts) != expected_launches(counts, per_call):
        raise AssertionError(f"fused Predictor call: {all_launches(counts)}")
    out["latency"] = bucket_latency(fused_cfg, pred, device)
    out["captured"] = serve_captured_vs_eager(fused_cfg, pred, lstm_recurrence, device)
    del pred
    dense_cfg = fused_cfg.replace(attn_impl="xla")
    dense = Predictor(dense_cfg, max_batch=64)
    counts.reset_launch_count()
    want = dense(batch)
    if all_launches(counts) != expected_launches(counts, {"lstm_fwd": LAUNCHES_PER_CALL}):
        raise AssertionError(f"dense-core Predictor call: {all_launches(counts)}")
    out["latency_dense"] = bucket_latency(dense_cfg, dense, device)
    check_outputs(got["scores"], got["labels"], got["tcp"], 64, cfg.num_classes, cfg.threshold)
    err = max(float(np.abs(got[k] - want[k]).max()) for k in ("scores", "tcp", "hidden"))
    if err > FLASH_SERVE_TOL:
        raise AssertionError(f"fused Predictor vs the dense core: {err} > {FLASH_SERVE_TOL}")
    out["fused_vs_dense_err"] = err
    return out


def tower_pair(counts, device) -> dict:
    """The tower pair through `extract_features_pair(use_pallas_multi=True)`
    at the towers' full width (visual 35, acoustic 74), forward and
    backward, at B=64, T=48 and B=32, T=512: MULTI_LAUNCHES `lstm_multi_fwd`
    and `lstm_multi_bwd` launches per call and no other; values and the
    gradients of all four towers' parameters and both inputs against the
    per-direction path (use_pallas_multi=False: 8 + 8 single-direction
    launches) within KERNEL_TOL; each path's time (forward + backward)."""
    from mmda_tpu_torch.models.bilstm import LSTMExtractor, extract_features_pair

    towers = []
    for i, F in enumerate((35, 74)):
        t = LSTMExtractor(F, F)
        t.reset_parameters(torch.Generator().manual_seed(i))
        towers.append(t.to(device))
    leaves = [p for t in towers for p in t.parameters()]
    rows, launches = [], dict.fromkeys(counts.KERNELS, 0)
    for T, B in MULTI_SHAPES:
        rng = np.random.default_rng(T)
        xv, xa = (torch.from_numpy(rng.normal(size=(B, T, F)).astype(np.float32)).to(device)
                  .requires_grad_(True) for F in (35, 74))
        lv, la = (torch.from_numpy(rng.integers(1, T + 1, size=B)).to(device) for _ in range(2))
        lv[0], la[-1] = T, 1
        gv, ga = (torch.from_numpy(rng.normal(size=(B, 4 * F)).astype(np.float32)).to(device)
                  for F in (35, 74))

        def run(multi):
            v, a = extract_features_pair(towers[0], towers[1], xv, xa, lv, la, "lstm",
                                         use_pallas_multi=multi)
            grads = torch.autograd.grad((v * gv).sum() + (a * ga).sum(), leaves + [xv, xa])
            return [v, a, *grads]

        results = {}
        for multi, want in ((True, {"lstm_multi_fwd": MULTI_LAUNCHES,
                                    "lstm_multi_bwd": MULTI_LAUNCHES}),
                            (False, {"lstm_fwd": LAUNCHES_PER_CALL,
                                     "lstm_bwd": LAUNCHES_PER_CALL})):
            counts.reset_launch_count()
            results[multi] = run(multi)
            torch.cuda.synchronize()
            got = all_launches(counts)
            if got != expected_launches(counts, want):
                raise AssertionError(f"tower pair use_pallas_multi={multi} at (B,T)={(B, T)}: "
                                     f"launches {got}, expected {want}")
            if multi:
                launches = {k: launches[k] + n for k, n in got.items()}
        names = ["utt_v", "utt_a"] + [f"d{n}" for t in ("v", "a")
                                      for n, _ in towers["va".index(t)].named_parameters()]
        names += ["dxv", "dxa"]
        err = max_err(zip(names, results[True], results[False]), KERNEL_TOL,
                      f"tower pair (B,T)={(B, T)}")
        row = {"B": B, "T": T, "H": [35, 74], "max_abs_err": err,
               "multi_ms": cuda_ms(lambda: run(True), reps=10),
               "per_direction_ms": cuda_ms(lambda: run(False), reps=10)}
        rows.append(row)
        log("10 tower-pair", **row, tol=KERNEL_TOL)
    return {"rows": rows, "launches": launches}


def infer_long(cfg, counts) -> dict:
    """`mmda_tpu_torch.cli.infer` on the long-sequence run's checkpoint (copied
    to the name `--data synthetic` looks for), attn_impl="flash", the 128
    ragged rows of the synthetic test split in batches of LONG_B."""
    import shutil

    from mmda_tpu_torch.cli import infer
    from mmda_tpu_torch.train import checkpoint as ckpt

    synth = cfg.replace(data="synthetic")
    shutil.copyfile(pathlib.Path(cfg.ckpt_dir) / f"{ckpt.best_model_name(cfg)}.msgpack",
                    pathlib.Path(cfg.ckpt_dir) / f"{ckpt.best_model_name(synth)}.msgpack")
    counts.reset_launch_count()
    t0 = time.perf_counter()
    metrics = infer.main(["--data", "synthetic", "--mode", "test", "--attn_impl", "flash",
                          "--max_seq_len", str(LONG_T), "--batch_size", str(LONG_B),
                          "--ckpt_dir", cfg.ckpt_dir, "--name", cfg.name])
    wall = time.perf_counter() - t0
    launches = all_launches(counts)
    batches = 128 // LONG_B
    want = expected_launches(counts, {"lstm_fwd": LAUNCHES_PER_CALL * batches,
                                      "flash_fwd": BERT_LAYERS * batches})
    if launches != want:
        raise AssertionError(f"cli.infer: kernel launches {launches}, expected {want}")
    with np.load(pathlib.Path(cfg.ckpt_dir) / f"predictions_{cfg.name}_test.npz") as z:
        arrays = {k: z[k] for k in z.files}
    if set(arrays) != {"scores", "labels", "truths", "tcp", "hidden"}:
        raise AssertionError(f"cli.infer wrote {sorted(arrays)}")
    check_outputs(arrays["scores"], arrays["labels"], arrays["tcp"], 128, cfg.num_classes,
                  cfg.threshold)
    if arrays["hidden"].shape != (128, 6 * cfg.hidden_size) or not np.isfinite(
            arrays["hidden"]).all():
        raise AssertionError(f"cli.infer hidden {arrays['hidden'].shape}")
    return {"rows": 128, "batches": batches, "wall_s": wall, "launches": launches,
            "f1": float(metrics["f1"]), "acc": float(metrics["acc"])}


# ------------------------------------------------- captured steps and calls


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and values, NaN where the other has NaN."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(((a == b) | (a.isnan() & b.isnan())).all()))


def bit_diffs(want: dict, got: dict) -> dict:
    """{name: max |got - want|} of the tensors that are not bit-equal."""
    return {k: (got[k].float() - w.float()).abs().nan_to_num().max().item()
            for k, w in want.items() if not bits_equal(got[k], w)}


def host_ms(fn, n: int) -> dict:
    """Host wall time of n calls, each ended by a synchronize (median, min,
    max), and the peak device memory (allocated, and reserved: a graph's pool
    is reserved, its replays allocate nothing) over them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"n": n, "ms": statistics.median(times), "ms_min": min(times),
            "ms_max": max(times), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}


def train_state(trainer) -> dict:
    """Clones of what a training step changes, by name: every parameter, both
    moments, the accumulators (grad_accum_steps > 1), the EMA shadow; and the
    optimizer's count, mini-step and rate and the generator's state."""
    model, opt = trainer.model, trainer.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    out = {f"param {n}": p.detach().clone() for n, p in model.named_parameters()}
    for k in ("mu", "nu", "acc"):
        out.update({f"{k} {names[id(p)]}": t.clone()
                    for p, t in zip(opt.params, getattr(opt, k))})
    out.update({f"ema {n}": t.clone()
                for (n, _), t in zip(model.named_parameters(), trainer.ema or [])})
    return {"tensors": out, "count": opt.count, "mini_step": opt.mini_step, "lr": opt.lr,
            "generator": trainer.generator.get_state()}


def restore_train_state(trainer, snap: dict) -> None:
    """Back to `snap` (`train_state`), in place: a graph reads these
    tensors where they live."""
    model, opt = trainer.model, trainer.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    held = snap["tensors"]
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(held[f"param {n}"])
        for k in ("mu", "nu", "acc"):
            for p, t in zip(opt.params, getattr(opt, k)):
                t.copy_(held[f"{k} {names[id(p)]}"])
        for (n, _), t in zip(model.named_parameters(), trainer.ema or []):
            t.copy_(held[f"ema {n}"])
    opt.count, opt.mini_step, opt.lr = snap["count"], snap["mini_step"], snap["lr"]
    trainer.generator.set_state(snap["generator"])


def same_state(want, got, where: str) -> None:
    """Two `train_state`s the same bits: every tensor, count, mini-step,
    rate and generator state."""
    diffs = bit_diffs(want["tensors"], got["tensors"])
    scalars = {k: (want[k], got[k]) for k in ("count", "mini_step", "lr") if want[k] != got[k]}
    if diffs or scalars or not torch.equal(want["generator"], got["generator"]):
        raise AssertionError(f"{where}: tensors {diffs}, scalars {scalars}, generator "
                             f"{torch.equal(want['generator'], got['generator'])}")


def captured_steps(trainer, counts, kind: str, device, per_step=None, timed=None) -> dict:
    """Phase 11 for one training configuration, on the trainer its phase
    built, over the first three batches of its train split (one shape):
    (a) three eager steps from one state, twice: the same bits (the losses,
    grad_norm, every parameter, both moments, the EMA shadow); (b) three
    replays of a training graph (`make_train_graph`, warmed and captured
    by a first call) from that state against the first three eager steps: the same
    bits, or, for a tensor named in `captured_diffs`, within TRAIN_TOL plus
    one bf16 ulp; (c) the launches a replay counts equal `per_step` (default
    the configuration's); no host read-back in a warm eager step or in a
    replay (`torch.cuda.set_sync_debug_mode("error")`); (d) `timed` (default
    the configuration's count) eager steps, then as many replays: host ms
    per step (each step copies its host batch in), peak memory, and a
    profile of 3 replays (device busy ms, idle share); the memory the
    capture reserved (the graph's pool, as reserved after the warm-up and
    the capture less reserved before, the cache emptied)."""
    from mmda_tpu_torch.data.loader import ArrayLoader, to_device
    from mmda_tpu_torch.train.step import make_train_graph, train_step

    spec = TRAIN_CONFIGS.get(kind, {})
    per_step = per_step or spec["per_step"]
    cfg, model, opt = trainer.cfg, trainer.model, trainer.optimizer
    gen, ema = trainer.generator, trainer.ema
    hosts = list(ArrayLoader(trainer.data["train"], cfg.batch_size, shuffle=False,
                             bucket_sizes=cfg.bucket_sizes).host_batches())
    snap = train_state(trainer)

    def three(step) -> dict:
        restore_train_state(trainer, snap)
        out = {f"step {i} {k}": v.clone() for i, h in enumerate(hosts[:3])
               for k, v in step(h).items()}
        return {**out, **train_state(trainer)["tensors"]}

    def eager(h):
        return train_step(model, opt, to_device(h, device), cfg, gen, ema)

    first, second = three(eager), three(eager)
    eager_diffs = bit_diffs(first, second)
    graphs = make_train_graph(model, opt, cfg, device, gen, ema, trainer.pool)
    restore_train_state(trainer, snap)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    graphs(hosts[0])                        # the warm-up, eager, then the capture
    torch.cuda.synchronize(device)
    capture_s = time.perf_counter() - t0
    pool_gb = (torch.cuda.memory_reserved(device) - reserved) / 1e9
    counts.reset_launch_count()
    replayed = three(graphs)
    torch.cuda.synchronize(device)
    launches = all_launches(counts)
    (_, _, per_replay), = graphs.graphs.values()
    want = expected_launches(counts, per_step)
    if per_replay != want or launches != {k: 3 * n for k, n in want.items()}:
        raise AssertionError(f"{kind}: a replay records {per_replay}, three counted "
                             f"{launches}; expected {want} a step")
    captured_diffs = bit_diffs(first, replayed)
    for k in captured_diffs:
        excess = ((replayed[k].float() - first[k].float()).abs()
                  - BF16_ULP * first[k].float().abs()).max().item()
        if not excess <= TRAIN_TOL:
            raise AssertionError(f"{kind}: captured {k} differs from the eager step by "
                                 f"{captured_diffs[k]} ({excess} beyond one bf16 ulp)")
    compared = len(first)
    del first, second, replayed, snap
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager(hosts[2])
        graphs(hosts[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)

    n = timed or spec.get("timed", TRAIN_STEPS)
    eager_t = host_ms(lambda i: eager(hosts[i % len(hosts)]), n)
    captured_t = host_ms(lambda i: graphs(hosts[i % len(hosts)]), n)
    prof = device_profile(lambda: [graphs(hosts[i]) for i in range(3)], 3, device,
                          spec.get("profile", ()))
    busy = prof["device_busy_ms_per_call"]
    if isinstance(busy, float):
        for t in (eager_t, captured_t):
            t["idle_share"] = 1.0 - busy / t["ms"]
    return {"kind": kind, "batch": cfg.batch_size, "T": hosts[0]["text"].shape[1],
            "compared": compared, "eager_twice_diffs": eager_diffs,
            "captured_diffs": captured_diffs, "tol_for_named": TRAIN_TOL,
            "launches_per_replay": {k: v for k, v in per_replay.items() if v},
            "warmup_and_capture_s": capture_s, "graph_pool_reserved_gb": pool_gb,
            "sync_free": True,
            "eager": eager_t, "captured": captured_t,
            "captured_profile": {k: v for k, v in prof.items() if k != "top_ms_per_call"},
            "captured_top_ms_per_step": prof.get("top_ms_per_call")}


def compiled_train(trainer, counts, kind: str, device) -> dict:
    """Phase 11 (e): `Trainer.train()` again on that trainer with
    compiled_epoch=True, one epoch: the first batch is its warm-up (then the
    capture), the rest replays; the dev eval replays the eval graph the
    first run's eval captured (compiled_eval, the default), the test eval
    on the best-on-dev copy warms and captures a graph of its own.  The launch counts read around exactly this call (the
    same per step and per eval batch as the eager run); then that dev eval
    graph against `eval_step` on the same parameters and batch, bit for bit."""
    from mmda_tpu_torch.data.loader import to_device
    from mmda_tpu_torch.train.step import eval_step

    spec = TRAIN_CONFIGS[kind]
    n_steps = spec.get("steps", TRAIN_STEPS)
    trainer.cfg = trainer.cfg.replace(compiled_epoch=True)
    trainer.step = 0          # train() starts at epoch step // len(train_loader): from 0 again
    counts.reset_launch_count()
    t0 = time.perf_counter()
    summary = trainer.train()
    wall = time.perf_counter() - t0
    launches = all_launches(counts)
    want = expected_launches(counts, {
        k: n * n_steps + spec["per_eval"].get(k, 0) * 2 for k, n in spec["per_step"].items()})
    if launches != want:
        raise AssertionError(f"{kind} compiled train(): launches {launches}, expected {want}")
    epoch = summary["history"][0]
    finite_losses({k: v for k, v in epoch.items() if k.startswith("train_")}, "compiled train()")
    host = next(trainer._loader("dev", shuffle=False).host_batches())
    model = trainer.eval_model()
    graph = trainer._eval_graph(model)
    if not graph.graphs:
        raise AssertionError(f"{kind}: the dev eval was never captured")
    counts.reset_launch_count()
    got = {k: v.clone() for k, v in graph(host).items()}
    if all_launches(counts) != expected_launches(counts, spec["per_eval"]):
        raise AssertionError(f"{kind}: an eval replay counted {all_launches(counts)}")
    want_out = eval_step(model, to_device(host, device), trainer.cfg)
    diffs = bit_diffs(want_out, got)
    if diffs:
        raise AssertionError(f"{kind}: captured eval vs eager eval: {diffs}")
    if not trainer.train_graph.graphs:
        raise AssertionError(f"{kind}: compiled train() captured no training graph")
    return {"kind": kind, "train_wall_s": wall, "epoch_time_s": epoch["epoch_time_s"],
            "eval_time_s": epoch["eval_time_s"], "train_loss": epoch["train_loss"],
            "steps": n_steps, "launches": launches, "eval_bit_equal": True}


def serve_captured_vs_eager(cfg, pred, recurrence, device) -> dict:
    """Phase 11 (f) for a Predictor whose buckets are captured (its HTTP run
    called each): at each bucket, a full batch and one request, a replay
    against an eager call through the same kernels (`recurrence=` the
    kernel wrapper) on the same batch, all four outputs bit for bit; then
    both latencies (`bucket_latency`)."""
    checked = []
    for b in sorted(cfg.bucket_sizes):
        reqs = make_requests([b] * pred.max_batch, cfg, seed=b + 1)
        for n in (pred.max_batch, 1):
            got, want = pred(reqs[:n]), pred(reqs[:n], recurrence=recurrence)
            diffs = [k for k in want if not np.array_equal(got[k], want[k])]
            if diffs:
                raise AssertionError(f"captured Predictor at bucket {b}, B={n}: {diffs} "
                                     "differ from the eager call")
            checked.append([b, n])
    return {"bit_equal_at": checked, "captured": bucket_latency(cfg, pred, device),
            "eager": bucket_latency(cfg, pred, device, recurrence)}


# ------------------------------------------------- phase 12: the rest of the Trainer


ACCUM_B, ACCUM_K = 32, 2          # grad_accum_steps=2 at B=32: an update per 64 rows
RESUME_STEPS = 10                 # batches an epoch in the snapshot-and-resume run
ETL_ROWS = (512, 128, 128)        # UR_FUNNY utterances written for the ETL phase
ETL_WIDTHS = (75, 81)             # OpenFace and COVAREP feature widths


def stage_two(counts, device, stage1: dict) -> dict:
    """Phase 12, ConfidNet stage 2: `cli.train --data synthetic
    --use_confidNet True --confid_two_stage True --n_epoch 2
    --n_epoch_stage2 2` in this process, the counts read around it and,
    inside it, around stage 2, which must launch `lstm_fwd` 8 times a step
    and `lstm_bwd` never; the stage-2 export against the stage-1 best export
    (read as stage 2 starts): the `confidence` leaves changed, every other
    leaf bit-equal; a Predictor on the export; then stage-2 steps at the
    flagship shape (B=64, T=48) on that trainer, timed and profiled, beside
    `stage1` (phase 5's eager and phase 11's captured steps)."""
    from mmda_tpu_torch.cli import train as cli_train
    from mmda_tpu_torch.config import get_config
    from mmda_tpu_torch.convert import flatten_tree
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.serving import Predictor
    from mmda_tpu_torch.train import checkpoint as ckpt
    from mmda_tpu_torch.train.loop import Trainer
    from mmda_tpu_torch.train.step import train_step

    name = "chip_smoke_stage2"
    ckpt_dir = BUILD / name
    args = ["--data", "synthetic", "--use_confidNet", "True", "--confid_two_stage", "True",
            "--n_epoch", "2", "--n_epoch_stage2", "2", "--ckpt_dir", str(ckpt_dir),
            "--name", name]
    cfg = get_config(argv=args)
    best = ckpt.best_model_name(cfg)
    seen: dict = {}
    real = Trainer._train_confidnet_stage2

    def watched(self, loader):
        seen.update(trainer=self, stage1=ckpt.load_checkpoint(str(ckpt_dir), best),
                    steps=self.cfg.n_epoch_stage2 * len(loader), before=all_launches(counts))
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        real(self, loader)
        torch.cuda.synchronize(device)
        seen["s"] = time.perf_counter() - t0
        seen["launches"] = {k: n - seen["before"][k] for k, n in all_launches(counts).items()}

    Trainer._train_confidnet_stage2 = watched
    counts.reset_launch_count()
    t0 = time.perf_counter()
    try:
        summary = cli_train.main(args)
    finally:
        Trainer._train_confidnet_stage2 = real
    wall = time.perf_counter() - t0
    launches = all_launches(counts)
    if "launches" not in seen:
        raise AssertionError("cli.train never ran stage 2")
    want = expected_launches(counts, {"lstm_fwd": LAUNCHES_PER_CALL * seen["steps"]})
    if seen["launches"] != want:
        raise AssertionError(f"stage 2: launches {seen['launches']}, expected {want}")
    flat1 = flatten_tree(seen["stage1"])
    flat2 = flatten_tree(ckpt.load_checkpoint(str(ckpt_dir), best))
    changed = sorted(k for k in flat1 if not bits_equal(flat1[k], flat2[k]))
    if flat1.keys() != flat2.keys() or changed != ["confidence.bias", "confidence.kernel"]:
        raise AssertionError(f"stage 2 changed {changed} of the stage-1 export")
    finite_losses({k: summary[k] for k in ("test_loss", "conf_tcp_mse")}, "stage 2 summary")

    pred = Predictor(cfg, visual_size=35, acoustic_size=74, max_batch=8, device=str(device))
    reqs = make_requests(spread_lengths(8, cfg.bucket_sizes, 12), cfg, seed=12)
    counts.reset_launch_count()
    got = pred(reqs)
    serve_launches = all_launches(counts)
    if serve_launches != expected_launches(counts, {"lstm_fwd": LAUNCHES_PER_CALL}):
        raise AssertionError(f"Predictor on the stage-2 export: launches {serve_launches}")
    check_outputs(got["scores"], got["labels"], got["tcp"], 8, cfg.num_classes, cfg.threshold)
    del pred

    tr = seen["trainer"]
    batch = next(iter(ArrayLoader(full_length_split(TRAIN_B, 7), TRAIN_B, shuffle=False,
                                  bucket_sizes=(TRAIN_T,), device=device)))

    def step(_=None):
        return train_step(tr.model, tr.optimizer, batch, tr.cfg, tr.generator, tr.ema,
                          conf_only=True)

    step()
    counts.reset_launch_count()
    finite_losses(step(), "stage-2 step")
    per_step = all_launches(counts)
    if per_step != expected_launches(counts, {"lstm_fwd": LAUNCHES_PER_CALL}):
        raise AssertionError(f"a stage-2 step launched {per_step}")
    timed = host_ms(step, TRAIN_STEPS)
    prof = device_profile(lambda: [step() for _ in range(3)], 3, device)
    busy = prof["device_busy_ms_per_call"]
    if isinstance(busy, float):
        timed["idle_share"] = 1.0 - busy / timed["ms"]
    return {"wall_s": wall, "launches": launches, "stage2_steps": seen["steps"],
            "stage2_s": seen["s"], "stage2_launches": {k: v for k, v in seen["launches"].items()
                                                       if v},
            "changed_leaves": changed, "test_loss": summary["test_loss"],
            "conf_tcp_mse": summary["conf_tcp_mse"], "serve_launches": serve_launches,
            "score_mean": float(np.mean(got["scores"])),
            "step_B_T": [TRAIN_B, TRAIN_T], "stage2_step": timed,
            "stage2_profile": {k: v for k, v in prof.items() if k != "top_ms_per_call"},
            "stage2_top_ms_per_step": prof.get("top_ms_per_call"),
            "stage1_eager_ms": stage1["steps"]["ms_per_step"],
            "stage1_captured_ms": stage1["captured"]["captured"]["ms"],
            "stage1_busy_ms": stage1["profile"]["device_busy_ms_per_call"]}


def accumulation(counts, device) -> dict:
    """Phase 12, grad_accum_steps=2 at B=32, T=48 at full width (bert-base,
    the mosei freeze rule, bf16): four eager mini-steps from one state (two
    updates), then the training graph, warmed and captured for both kinds of
    mini-step (accumulate; accumulate and apply), replayed four times from
    that state: the same bits (losses, grad_norm, parameters, moments,
    accumulators, count, mini-step); 8 + 8 LSTM launches each; ms per
    mini-step eager and replayed."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.data.loader import ArrayLoader, to_device
    from mmda_tpu_torch.train.loop import Trainer
    from mmda_tpu_torch.train.step import make_train_graph, train_step
    from mmda_tpu_torch.utils.logging import MetricLogger

    name = "chip_smoke_accum"
    cfg = Config(use_bert=True, data="mosei", batch_size=ACCUM_B, max_seq_len=TRAIN_T,
                 bucket_sizes=(TRAIN_T,), compute_dtype="bfloat16", grad_accum_steps=ACCUM_K,
                 n_epoch=1, seed=0, name=name, ckpt_dir=str(BUILD / name))
    data = {"train": full_length_split(4 * ACCUM_B, 0), "dev": full_length_split(ACCUM_B, 1),
            "test": full_length_split(ACCUM_B, 2)}
    trainer = Trainer(cfg, data, logger=MetricLogger(("stdout",), run_name=name))
    model, opt, gen, ema = trainer.model, trainer.optimizer, trainer.generator, trainer.ema
    hosts = list(ArrayLoader(data["train"], ACCUM_B, shuffle=False,
                             bucket_sizes=(TRAIN_T,)).host_batches())
    per_step = expected_launches(counts, TRAIN_CONFIGS["lstm"]["per_step"])
    snap = train_state(trainer)

    counted = []

    def four(step) -> dict:
        restore_train_state(trainer, snap)
        counts.reset_launch_count()
        out = {f"mini-step {i} {k}": v.clone() for i, h in enumerate(hosts)
               for k, v in step(h).items()}
        torch.cuda.synchronize(device)
        counted.append(all_launches(counts))
        if counted[-1] != {k: 4 * n for k, n in per_step.items()}:
            raise AssertionError(f"four mini-steps launched {counted[-1]}")
        state = train_state(trainer)
        if (state["count"], state["mini_step"]) != (2, 0):
            raise AssertionError(f"four mini-steps left count {state['count']}, "
                                 f"mini_step {state['mini_step']}")
        return {**out, **state["tensors"]}

    def eager(h):
        return train_step(model, opt, to_device(h, device), cfg, gen, ema)

    first = four(eager)
    graphs = make_train_graph(model, opt, cfg, device, gen, ema, trainer.pool)
    restore_train_state(trainer, snap)
    graphs(hosts[0])                       # accumulate: warm-up, then capture
    graphs(hosts[1])                       # accumulate and apply: warm-up, then capture
    if len(graphs.graphs) != 2:
        raise AssertionError(f"{len(graphs.graphs)} graphs for one shape, expected 2")
    replayed = four(graphs)
    diffs = bit_diffs(first, replayed)
    if diffs:
        raise AssertionError(f"accumulating replays against eager mini-steps: {diffs}")
    per_replay = {("apply" if emit else "accumulate"): {k: v for k, v in rec.items() if v}
                  for (_, emit), (_, _, rec) in graphs.graphs.items()}
    eager_t = host_ms(lambda i: eager(hosts[i % 4]), TRAIN_STEPS)
    captured_t = host_ms(lambda i: graphs(hosts[i % 4]), TRAIN_STEPS)
    return {"batch": ACCUM_B, "T": TRAIN_T, "grad_accum_steps": ACCUM_K,
            "compared": len(first), "bit_equal": True, "launches_per_replay": per_replay,
            "eager_ms_per_mini_step": eager_t, "captured_ms_per_mini_step": captured_t,
            "launches": {k: sum(c[k] for c in counted) for k in counted[0]}}


def accumulation_card_vs_cpu(device) -> float:
    """A small f32 model (tiny BERT, hidden 32), grad_accum_steps=2, three
    mini-steps (an update, then a held mini-batch): the parameters, moments
    and accumulators on the card, through the kernels, against the CPU's
    plain versions.  The rate is 1e-5, so that Adam's unit step on a leaf
    whose gradient is rounding noise (the fusion key bias) stays below the
    tolerance."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.data.synthetic import SyntheticSpec, make_split
    from mmda_tpu_torch.models import init_misa
    from mmda_tpu_torch.models.bert import BertConfig
    from mmda_tpu_torch.train.state import Optimizer
    from mmda_tpu_torch.train.step import loss_and_grads

    cfg = Config(hidden_size=32, compute_dtype="float32", batch_size=8, max_seq_len=16,
                 grad_accum_steps=2, learning_rate=1e-5, device="cpu")
    split = make_split(SyntheticSpec(num_examples=24, max_len=16, seed=3))
    model = init_misa(cfg, seed=1, bert_cfg=BertConfig.tiny(vocab_size=30522)).eval()

    def run(dev):
        m = copy.deepcopy(model).to(dev)
        opt = Optimizer(cfg, list(m.parameters()))
        for batch in ArrayLoader(split, 8, shuffle=False, bucket_sizes=(16,), device=dev):
            _, g = loss_and_grads(m, batch, cfg, opt.params)
            opt.step(g)
        return [t.detach().cpu() for t in [*m.parameters(), *opt.mu, *opt.nu, *opt.acc]]

    cpu = steady_on_cpu(lambda: run("cpu"))
    err = max((a - b).abs().max().item() for a, b in zip(cpu, run(device)))
    if err > DEVICE_TOL:
        raise AssertionError(f"accumulating mini-steps, card vs CPU: {err} > {DEVICE_TOL}")
    return err


def snapshot_and_resume(counts, device) -> dict:
    """Phase 12, `last_*` and resume at the flagship shape: `Trainer.train()`
    with compiled_epoch=True and n_epoch=3 sends itself SIGTERM after epoch
    0's log line (the JAX test's logger hook) and must stop there with the
    incremental snapshot written (a frozen base, a delta); a new
    `Trainer(resume=True)` must hold the first one's parameters, moments,
    count and generator state bit for bit; one step from each on the same
    batch gives the same bits; then the bytes and seconds of the frozen
    base, a delta and a full snapshot, each written synchronously, and the
    host time an epoch pays to dispatch its asynchronous delta (the copies
    to the host; the thread writes the file)."""
    import os
    import shutil
    import signal

    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.data.loader import ArrayLoader, to_device
    from mmda_tpu_torch.train import checkpoint as ckpt
    from mmda_tpu_torch.train.loop import Trainer
    from mmda_tpu_torch.train.step import train_step
    from mmda_tpu_torch.utils.logging import MetricLogger

    name = "chip_smoke_resume"
    ckpt_dir = BUILD / name
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = Config(use_bert=True, data="mosei", batch_size=TRAIN_B, max_seq_len=TRAIN_T,
                 bucket_sizes=(TRAIN_T,), compute_dtype="bfloat16", n_epoch=3, seed=0,
                 name=name, ckpt_dir=str(ckpt_dir), compiled_epoch=True)
    data = {"train": full_length_split(TRAIN_B * RESUME_STEPS, 0),
            "dev": full_length_split(TRAIN_B, 1), "test": full_length_split(TRAIN_B, 2)}
    logger = MetricLogger(("stdout",), run_name=name)
    trainer = Trainer(cfg, data, logger=logger)
    log = logger.log

    def hooked(metrics, step=None):
        log(metrics, step)
        if "train_loss" in metrics:
            os.kill(os.getpid(), signal.SIGTERM)

    logger.log = hooked
    handler = signal.getsignal(signal.SIGTERM)
    counts.reset_launch_count()
    t0 = time.perf_counter()
    summary = trainer.train()
    wall = time.perf_counter() - t0
    launches = all_launches(counts)
    want = expected_launches(counts, {k: n * RESUME_STEPS + TRAIN_CONFIGS["lstm"]["per_eval"]
                                      .get(k, 0) * 2
                                      for k, n in TRAIN_CONFIGS["lstm"]["per_step"].items()})
    if launches != want:
        raise AssertionError(f"preempted train(): launches {launches}, expected {want}")
    if len(summary["history"]) != 1 or not ckpt.incremental_checkpoint_exists(
            str(ckpt_dir), f"last_{name}"):
        raise AssertionError(f"SIGTERM after epoch 0: {len(summary['history'])} epochs ran, "
                             f"files {sorted(os.listdir(ckpt_dir))}")
    if signal.getsignal(signal.SIGTERM) is not handler:
        raise AssertionError("train() left its SIGTERM handler installed")
    held = train_state(trainer)
    resumed = Trainer(cfg.replace(resume=True), data,
                      logger=MetricLogger(("stdout",), run_name=name + "_resumed"))
    same_state(held, train_state(resumed), "resumed trainer vs its snapshot")
    if resumed.step != RESUME_STEPS:
        raise AssertionError(f"resumed at step {resumed.step}, expected {RESUME_STEPS}")
    host = next(ArrayLoader(data["dev"], TRAIN_B, shuffle=False,
                            bucket_sizes=(TRAIN_T,)).host_batches())
    outs = []
    for t in (trainer, resumed):
        out = train_step(t.model, t.optimizer, to_device(host, device), t.cfg, t.generator,
                         t.ema)
        outs.append({**{k: v.clone() for k, v in out.items()}, **train_state(t)["tensors"]})
    diffs = bit_diffs(*outs)
    if diffs:
        raise AssertionError(f"a step from the loaded state vs from memory: {diffs}")
    del resumed, outs

    t0 = time.perf_counter()             # what an epoch pays for its asynchronous snapshot
    writer = trainer._save_resume_ckpt(0, 0.0)
    dispatch_s = time.perf_counter() - t0
    writer.join()
    sizes_dir = BUILD / "chip_smoke_snapshot_sizes"
    shutil.rmtree(sizes_dir, ignore_errors=True)
    state = trainer.train_state()
    timings = {}
    for label, save, nm in (("base_and_delta", ckpt.save_checkpoint_incremental, "inc"),
                            ("delta", ckpt.save_checkpoint_incremental, "inc"),
                            ("full", ckpt.save_train_state, "full")):
        t0 = time.perf_counter()
        save(str(sizes_dir), nm, state)
        timings[f"{label}_s"] = time.perf_counter() - t0
    files = {f: (sizes_dir / f).stat().st_size for f in os.listdir(sizes_dir)}
    base = [n for f, n in files.items() if f.startswith("frozen_base_")]
    epoch = summary["history"][0]
    return {"launches": launches, "train_wall_s": wall, "epochs_run": 1,
            "resumed_at_step": RESUME_STEPS, "compared": len(held["tensors"]),
            "bit_equal": True, "next_step_bit_equal": True,
            "frozen_base_bytes": base[0] if base else 0,
            "delta_bytes": files["inc.inc.msgpack"], "full_bytes": files["full.msgpack"],
            **timings, "async_delta_dispatch_s": dispatch_s,
            "post_eval_time_s": epoch["post_eval_time_s"],
            "epoch_time_s": epoch["epoch_time_s"], "eval_time_s": epoch["eval_time_s"]}


def write_urfunny(path, rows=ETL_ROWS, widths=ETL_WIDTHS, words=None, max_words=40,
                  seed=0) -> None:
    """UR_FUNNY's SDK pickles (data_folds, openface / covarep features of
    `widths`, word indexes, the word list, humor labels) for `rows`
    (train, dev, test) utterances of 2 to `max_words` words from `words`
    (default 2000 made-up ones)."""
    import os
    import pickle

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    words = words or [f"w{i}" for i in range(2000)]
    keys = [f"utt{i}" for i in range(sum(rows))]
    folds = {"train": keys[:rows[0]], "dev": keys[rows[0]:rows[0] + rows[1]],
             "test": keys[rows[0] + rows[1]:]}
    idx, openface, covarep, humor = {}, {}, {}, {}
    for k in keys:
        L = int(rng.integers(2, max_words + 1))
        idx[k] = {"punchline_embedding_indexes": rng.integers(0, len(words), L)}
        openface[k] = {"punchline_features": rng.normal(size=(L, widths[0]))}
        covarep[k] = {"punchline_features": rng.normal(size=(L, widths[1]))}
        humor[k] = int(rng.integers(0, 2))
    for name, obj in (("data_folds", folds), ("openface_features_sdk", openface),
                      ("covarep_features_sdk", covarep), ("word_embedding_indexes_sdk", idx),
                      ("word_list", words), ("humor_label_sdk", humor)):
        with open(os.path.join(path, f"{name}.pkl"), "wb") as f:
            pickle.dump(obj, f)


def etl_then_train(counts, device) -> dict:
    """Phase 12, the data path: `python -m mmda_tpu_torch.cli.etl --data
    ur_funny` on pickles written here (no h5py needed), then `cli.train
    --data ur_funny` on those splits for one epoch on the card, in this
    process, the counts read around it: 8 + 8 LSTM launches a training
    step and 8 `lstm_fwd` an eval batch."""
    import shutil

    from mmda_tpu_torch.cli import train as cli_train
    from mmda_tpu_torch.config import get_config
    from mmda_tpu_torch.data import load_splits
    from mmda_tpu_torch.data.loader import ArrayLoader

    data_dir = BUILD / "chip_smoke_etl"
    shutil.rmtree(data_dir, ignore_errors=True)
    write_urfunny(data_dir / "UR_FUNNY")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "mmda_tpu_torch.cli.etl", "--data", "ur_funny",
                          "--data_dir", str(data_dir)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    etl_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"cli.etl exit {out.returncode}:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-2000:]}")
    splits = load_splits(str(data_dir / "UR_FUNNY"))
    rows = {k: len(v["lengths"]) for k, v in splits.items()}
    if tuple(rows[k] for k in ("train", "dev", "test")) != ETL_ROWS:
        raise AssertionError(f"cli.etl wrote {rows} rows, expected {ETL_ROWS}")
    name = "chip_smoke_etl"
    args = ["--data", "ur_funny", "--data_dir", str(data_dir), "--n_epoch", "1",
            "--ckpt_dir", str(BUILD / name), "--name", name]
    cfg = get_config(argv=args)
    loaders = {k: ArrayLoader(v, cfg.batch_size, shuffle=False, drop_last=(k == "train"),
                              bucket_sizes=cfg.bucket_sizes) for k, v in splits.items()}
    steps, evals = len(loaders["train"]), len(loaders["dev"]) + len(loaders["test"])
    counts.reset_launch_count()
    t0 = time.perf_counter()
    summary = cli_train.main(args)
    train_s = time.perf_counter() - t0
    launches = all_launches(counts)
    want = expected_launches(counts, {"lstm_fwd": LAUNCHES_PER_CALL * (steps + evals),
                                      "lstm_bwd": LAUNCHES_PER_CALL * steps})
    if launches != want:
        raise AssertionError(f"cli.train on the ETL splits: launches {launches}, expected {want}")
    finite_losses({"test_loss": summary["test_loss"],
                   **{k: v for k, v in summary["history"][0].items()
                      if k.startswith("train_")}}, "cli.train on the ETL splits")
    return {"etl_s": etl_s, "rows": rows, "widths": list(ETL_WIDTHS),
            "T": int(splits["train"]["text"].shape[1]), "train_s": train_s, "steps": steps,
            "eval_batches": evals, "launches": launches, "test_loss": summary["test_loss"],
            "test_acc": summary["test_acc"], "epoch_time_s": summary["history"][0]["epoch_time_s"]}



# ------------------------------------ phase 13: HF BERT, int8 serving, the zoo, native


HF_LAYER = {"q": "attention.self.query", "k": "attention.self.key",
            "v": "attention.self.value", "attn_out": "attention.output.dense",
            "ffn_in": "intermediate.dense", "ffn_out": "output.dense",
            "attn_ln": "attention.output.LayerNorm", "ffn_ln": "output.LayerNorm"}
HF_EMBEDDINGS = {"word": "word_embeddings.weight", "position": "position_embeddings.weight",
                 "token_type": "token_type_embeddings.weight"}
SAFETENSORS_DTYPES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
                      torch.int64: "I64"}


def hf_name(name: str) -> str:
    """HuggingFace's name of a port `BertEncoder` tensor."""
    parts = name.split(".")
    if parts[0] == "embeddings":
        return "embeddings." + HF_EMBEDDINGS.get(parts[1], f"LayerNorm.{parts[-1]}")
    if parts[0] == "pooler":
        return "pooler.dense." + parts[1]
    _, i, sub, leaf = parts
    return f"encoder.layer.{i}.{HF_LAYER[sub]}.{leaf}"


def write_safetensors(path, tensors: dict) -> None:
    """A `.safetensors` file: the header's length as 8 little-endian bytes,
    the JSON header (dtype, shape, byte offsets), the raw bytes."""
    import struct

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())


def hf_checkpoint(seed: int = 0) -> dict:
    """A seeded random bert-base in HF's names with the `bert.` prefix,
    written under HF_DIR as `safetensors/model.safetensors` and
    `bin/pytorch_model.bin`; both read back by `load_hf_weights` and held
    against the written tensors leaf for leaf."""
    from mmda_tpu_torch.models.bert import BertConfig, BertEncoder, load_hf_weights

    enc = BertEncoder(BertConfig.base())
    enc.reset_parameters(torch.Generator().manual_seed(seed))
    port = {n: t.detach().clone() for n, t in enc.state_dict().items()}
    hf = {"bert." + hf_name(n): t for n, t in port.items()}
    t0 = time.perf_counter()
    for sub in ("safetensors", "bin"):
        (HF_DIR / sub).mkdir(parents=True, exist_ok=True)
    write_safetensors(HF_DIR / "safetensors" / "model.safetensors", hf)
    torch.save(hf, HF_DIR / "bin" / "pytorch_model.bin")
    write_s = time.perf_counter() - t0
    loaded = {}
    for sub in ("safetensors", "bin"):
        t0 = time.perf_counter()
        got = load_hf_weights(str(HF_DIR / sub))
        loaded[sub] = time.perf_counter() - t0
        bad = [n for n, t in port.items() if not bits_equal(got[n], t)]
        if set(got) != set(port) or bad:
            raise AssertionError(f"{sub}: loaded tensors differ from the file: {bad[:5]}")
    return {"tensors": len(port), "parameters": sum(t.numel() for t in port.values()),
            "bytes": {sub: (HF_DIR / sub / f).stat().st_size for sub, f in (
                ("safetensors", "model.safetensors"), ("bin", "pytorch_model.bin"))},
            "write_s": write_s, "load_s": loaded, "port_tensors": port}


def eager_step_host_ops(trainer, device, steps: int = 3) -> dict:
    """Where an eager flagship step's host time goes: `utils.timing.profile`
    (torch.profiler, its Chrome trace under build/) over `steps` eager
    steps; per step the wall ms, the self CPU ms of the traced ops by group
    (ATen ops, autograd's engine nodes, CUDA runtime calls, the port's
    kernel wrappers and the rest) and the untraced remainder (Python between
    ops), and the top ops by self CPU time."""
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.train.step import train_step
    from mmda_tpu_torch.utils.timing import profile

    cfg = trainer.cfg
    batch = next(iter(ArrayLoader(trainer.data["train"], cfg.batch_size, shuffle=False,
                                  bucket_sizes=cfg.bucket_sizes, device=device)))

    def step():
        train_step(trainer.model, trainer.optimizer, batch, cfg, trainer.generator, trainer.ema)

    step()
    torch.cuda.synchronize(device)
    with profile(str(BUILD / "chip_smoke_eager_profile")) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = [(e.key, e.self_cpu_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages() if e.self_cpu_time_total > 0]

    def group(key):
        if key.startswith("autograd::engine") or key.endswith("Backward0") or \
                key.endswith("Backward1"):
            return "autograd_engine"
        if key.startswith("aten::"):
            return "aten"
        if key.startswith("cuda"):
            return "cuda_runtime"
        return "other"

    groups: dict = {}
    for key, ms, _ in rows:
        groups[group(key)] = groups.get(group(key), 0.0) + ms
    traced = sum(groups.values())
    launches = sum(n for key, _, n in rows if key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                       "cudaLaunchKernelExC"))
    top = sorted(rows, key=lambda r: -r[1])[:15]
    return {"steps": steps, "wall_ms_per_step_profiled": wall,
            "self_cpu_ms_per_step_by_group": groups,
            "untraced_ms_per_step": wall - traced,
            "kernel_launch_calls_per_step": launches,
            "cuda_malloc_calls_per_step": sum(n for key, _, n in rows if key == "cudaMalloc"),
            "top_self_cpu_ms_per_step": [[k[:70], ms, n] for k, ms, n in top]}


def hf_train(counts, device, port_tensors: dict) -> tuple:
    """The flagship step from the HF checkpoint (`bert_model_dir`, mosei
    freeze rule, attn_impl "fused"), `Trainer.train()` for ZOO_STEPS steps:
    8 + 8 LSTM and 12 + 12 short-attention launches a step; encoder layers <= 8 still the file's bits after the
    epoch, a trained layer moved; then the host-side ops of an eager step."""
    trainer, path = train_main_path(counts, "hf")
    layers = trainer.model.bert.layers
    frozen_kept = all(bits_equal(p.detach().cpu(), port_tensors[f"layers.{n}"])
                      for n, p in layers.named_parameters() if int(n.split(".")[0]) <= 8)
    moved = [i for i in range(9, len(layers)) if not all(
        bits_equal(p.detach().cpu(), port_tensors[f"layers.{i}.{n}"])
        for n, p in layers[i].named_parameters())]
    if not frozen_kept or not moved:
        raise AssertionError(f"HF run: layers <= 8 kept the file's values: {frozen_kept}; "
                             f"trained layers that moved: {moved}")
    host = eager_step_host_ops(trainer, device)
    del trainer
    torch.cuda.empty_cache()
    return path, {"frozen_layers_kept": True, "trained_layers_moved": moved,
                  "eager_step_host": host}


def hf_cli_train(counts, device) -> dict:
    """`python -m mmda_tpu_torch.cli.train --data synthetic --bert_model_dir
    DIR --attn_impl fused --n_epoch 1 --profile_dir P --compiled_epoch True`
    in this process, the counts read around it (8 + 8 LSTM and 12 + 12
    short-attention launches a step, 8 `lstm_fwd` and 12 `short_attn_fwd`
    an eval batch); its Chrome trace names both kernels, counted against
    the launches (the replays' kernels included); a `Predictor` on its
    checkpoint answers with finite scores, with one eval batch's launches a
    call."""
    import glob
    import shutil

    from mmda_tpu_torch.cli import train as cli_train
    from mmda_tpu_torch.config import get_config
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.serving import Predictor

    name = "chip_smoke_hf_cli"
    prof_dir = BUILD / "chip_smoke_hf_profile"
    shutil.rmtree(prof_dir, ignore_errors=True)
    spec = TRAIN_CONFIGS["fused"]
    args = ["--data", "synthetic", "--bert_model_dir", str(HF_DIR / "bin"), "--n_epoch", "1",
            "--attn_impl", "fused", "--profile_dir", str(prof_dir), "--compiled_epoch", "True",
            "--ckpt_dir", str(BUILD / name), "--name", name]
    cfg = get_config(argv=args)
    data, _ = cli_train.load_data(cfg)
    loaders = {k: ArrayLoader(v, cfg.batch_size, shuffle=False, drop_last=(k == "train"),
                              bucket_sizes=cfg.bucket_sizes) for k, v in data.items()}
    steps, evals = len(loaders["train"]), len(loaders["dev"]) + len(loaders["test"])
    counts.reset_launch_count()
    t0 = time.perf_counter()
    summary = cli_train.main(args)
    train_s = time.perf_counter() - t0
    launches = all_launches(counts)
    want = expected_launches(counts, {k: n * steps + spec["per_eval"].get(k, 0) * evals
                                      for k, n in spec["per_step"].items()})
    if launches != want:
        raise AssertionError(f"cli.train --bert_model_dir: launches {launches}, expected {want}")
    traces = glob.glob(str(prof_dir / "trace_*.json"))
    if len(traces) != 1:
        raise AssertionError(f"--profile_dir wrote {traces}")
    events = json.loads(pathlib.Path(traces[0]).read_text())["traceEvents"]
    named = {k: sum(1 for e in events if e.get("cat") == "kernel" and k in e.get("name", ""))
             for k in ("lstm_fwd_kernel", "lstm_bptt_kernel", "short_attn_fwd",
                       "short_attn_bwd")}
    if not all(named.values()):
        raise AssertionError(f"the trace misses a kernel of the path: {named}")
    pred = Predictor(cfg, visual_size=35, acoustic_size=74, max_batch=8, device=str(device))
    reqs = make_requests(spread_lengths(8, cfg.bucket_sizes, 13), cfg, seed=13)
    counts.reset_launch_count()
    got = pred(reqs)
    serve_launches = all_launches(counts)
    if serve_launches != expected_launches(counts, spec["per_eval"]):
        raise AssertionError(f"Predictor on the HF run's checkpoint: launches {serve_launches}")
    check_outputs(got["scores"], got["labels"], got["tcp"], 8, cfg.num_classes, cfg.threshold)
    for k in launches:
        launches[k] += serve_launches[k]
    return {"train_s": train_s, "steps": steps, "eval_batches": evals,
            "launches": launches, "test_loss": summary["test_loss"],
            "trace_bytes": pathlib.Path(traces[0]).stat().st_size,
            "trace_kernel_events": named,
            "profiler_sees_every_launch": (named["lstm_fwd_kernel"] == want["lstm_fwd"] and
                                           named["short_attn_fwd"] == want["short_attn_fwd"]),
            "score_mean": float(np.mean(got["scores"]))}


def bert_weight_bytes(pred) -> dict:
    """Bytes at rest of the Predictor's BERT tower: all of it, and the six
    encoder denses' weights (int8 `weight_q` or the stored `weight`)."""
    bert = pred.model.bert
    dense = 0
    for lp in bert.layers:
        for sub in ("q", "k", "v", "attn_out", "ffn_in", "ffn_out"):
            w = getattr(getattr(lp, sub), "weight_q", None)
            w = getattr(lp, sub).weight if w is None else w
            dense += w.numel() * w.element_size()
    total = sum(t.numel() * t.element_size()
                for t in itertools.chain(bert.parameters(), bert.buffers()))
    return {"bert_bytes": total, "encoder_dense_weight_bytes": dense}


# the int8 denses of bert-base: the fused QKV, the attention output, the FFN's two
INT8_DENSES = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
INT8_ROWS = TRAIN_B * (TRAIN_T + 2)        # the flagship step's B * S tokens
INT8_MISMATCH_TOL = 1e-3    # share of outputs not bit-equal to the one-rounding reference:
                            # f32 summation order flips about 2e-5 of them, a second
                            # rounding (the product rounded to bf16, then scaled) about 0.24
INT8_ENCODE_ULPS = 1        # the int8 encoder's card-vs-CPU difference beyond the bf16 one's


def int8_dense_bf16(device, d_in: int, d_out: int, rows: int = INT8_ROWS,
                    seed: int = 0) -> dict:
    """A bf16 `dense()` on a `QuantizedDense` (random weights and bias, N(0,
    1) inputs) on the card against the same call on the CPU and against the
    float64 product scaled and rounded to bf16 once, + bias: at most one bf16
    ulp + 2^-8 apart, and at most INT8_MISMATCH_TOL of the outputs not
    bit-equal to that reference.  The product rounded to bf16 before the
    scale (two roundings) is scored the same way, to show the gate sees it."""
    from mmda_tpu_torch.models.bert import Dense, dense, quantize_dense

    g = torch.Generator().manual_seed(seed)
    d = Dense(d_in, d_out)
    d.reset_parameters(0.02, g)
    with torch.no_grad():
        d.bias.normal_(0.0, 0.02, generator=g)
    q = quantize_dense(d)
    x = torch.randn(rows, d_in, generator=g).to(torch.bfloat16)
    bf = torch.bfloat16
    card = dense(x.to(device), copy.deepcopy(q).to(device), bf).cpu()
    cpu = steady_on_cpu(lambda: [dense(x, q, bf)])[0]
    ref = ((x.double() @ q.weight_q.double().t()) * q.scale.double()).to(bf) + q.bias.to(bf)
    twice = ((x @ q.weight_q.to(bf).t()).float() * q.scale).to(bf) + q.bias.to(bf)
    err = (card.float() - cpu.float()).abs()
    over = float((err - (2.0 ** -8 + BF16_ULP * cpu.float().abs())).max())
    out = {"shape": [rows, d_in, d_out], "max_abs_err_vs_cpu": float(err.max()),
           "mismatch_vs_cpu": float((card != cpu).float().mean()),
           "mismatch_vs_one_rounding": float((card != ref).float().mean()),
           "cpu_mismatch_vs_one_rounding": float((cpu != ref).float().mean()),
           "two_roundings_mismatch": float((twice != ref).float().mean())}
    if (over > 0 or out["mismatch_vs_one_rounding"] > INT8_MISMATCH_TOL
            or out["two_roundings_mismatch"] <= INT8_MISMATCH_TOL):
        raise AssertionError(f"bf16 int8 dense on the card: {out}")
    return out


def int8_encode_bf16(counts, device, seed: int = 0) -> dict:
    """A bf16 int8 `bert_encode` at bert-base width, two layers, B=8, S=50,
    attn_impl "fused" (2 `short_attn_fwd` launches), on the card against
    the CPU on the same weights and ids, every real row; beside it the same
    encoder with its bf16 weights unquantized, card against CPU.  bf16 on
    two devices already parts by a few ulps through two layers (a value on
    a rounding boundary rounds the other way and LayerNorm carries it on),
    so int8 is held to that: its largest difference at most the bf16
    encoder's plus one bf16 ulp of the largest output (INT8_ENCODE_ULPS)."""
    from mmda_tpu_torch.models.bert import BertConfig, BertEncoder, bert_encode, \
        quantize_bert_int8

    bcfg = BertConfig(num_layers=2)
    dense_enc = BertEncoder(bcfg)
    dense_enc.reset_parameters(torch.Generator().manual_seed(seed))
    int8_enc = quantize_bert_int8(copy.deepcopy(dense_enc))
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(5, bcfg.vocab_size, size=(8, TRAIN_T + 2)))
    mask = torch.ones_like(ids)
    mask[3, 20:] = 0
    real = mask.bool()

    def run(e, dev):
        with torch.no_grad():
            return bert_encode(e, ids.to(dev), mask.to(dev), None, torch.bfloat16,
                               attn_impl="fused").float().cpu()

    out = {}
    for name, enc in (("int8", int8_enc), ("bf16", dense_enc)):
        cpu = steady_on_cpu(lambda: [run(enc, "cpu")])[0]
        card_enc = copy.deepcopy(enc).to(device)
        counts.reset_launch_count()
        card = run(card_enc, device)
        out[name] = {"max_abs_err": float((card - cpu).abs()[real].max()),
                     "mismatch": float((card != cpu)[real].float().mean()),
                     "max_abs_out": float(cpu.abs()[real].max()),
                     "short_attn_fwd": counts.launch_count("short_attn_fwd")}
    tol = out["bf16"]["max_abs_err"] + INT8_ENCODE_ULPS * BF16_ULP * out["int8"]["max_abs_out"]
    out["tol"] = tol
    if out["int8"]["max_abs_err"] > tol or out["int8"]["short_attn_fwd"] != bcfg.num_layers:
        raise AssertionError(f"bf16 int8 bert_encode, card vs CPU: {out}")
    return out


def int8_serving(counts, klstm, device) -> dict:
    """Full-width `Predictor`s on one seeded MISA with attn_impl "fused"
    and bert_weights_dtype "int8", "bfloat16" and None: 8 `lstm_fwd` and 12
    `short_attn_fwd` a call; the weight bytes; captured latency at buckets
    16/32/64, B=64 and B=1; int8's and bf16's max |score difference| from
    the f32-weight Predictor on the same requests; for int8 each bucket's
    replay against an eager call, bit for bit, and the eager latencies; then
    a small f32 int8 model on the card against the CPU (1e-4), and the bf16
    int8 path's rounding point: each bert-base dense shape on the card
    against the CPU and a one-rounding reference (`int8_dense_bf16`), and a
    two-layer bf16 int8 encoder on the card against the CPU."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.models import init_misa
    from mmda_tpu_torch.serving import Predictor

    cfg = Config(attn_impl="fused")
    model = init_misa(cfg, seed=0)
    reqs = make_requests(spread_lengths(40, cfg.bucket_sizes, 321), cfg, seed=321)
    out, scores = {}, {}
    launches = expected_launches(counts, {})
    per_call = {"lstm_fwd": LAUNCHES_PER_CALL, "short_attn_fwd": BERT_LAYERS}
    for dtype in ("int8", "bfloat16", None):
        pred = Predictor(cfg, params=copy.deepcopy(model), max_batch=64,
                         bert_weights_dtype=dtype)
        counts.reset_launch_count()
        got = pred(reqs)
        if all_launches(counts) != expected_launches(counts, per_call):
            raise AssertionError(f"int8 phase, {dtype}: launches {all_launches(counts)}")
        for k, n in per_call.items():
            launches[k] += n
        check_outputs(got["scores"], got["labels"], got["tcp"], 40, cfg.num_classes,
                      cfg.threshold)
        scores[str(dtype)] = got["scores"]
        row = bert_weight_bytes(pred)
        if dtype == "int8":
            row.update(serve_captured_vs_eager(cfg, pred, klstm.lstm_recurrence, device))
        else:
            row["captured"] = bucket_latency(cfg, pred, device)
        out[str(dtype)] = row
        del pred
        torch.cuda.empty_cache()
    for dtype in ("int8", "bfloat16"):
        out[dtype]["max_abs_score_diff_vs_f32_weights"] = float(
            np.abs(scores[dtype] - scores["None"]).max())
    out["card_vs_cpu_int8_err"] = card_vs_cpu(device, bert_weights_dtype="int8")
    out["dense_bf16"] = [int8_dense_bf16(device, *shape) for shape in INT8_DENSES]
    out["encode_bf16"] = int8_encode_bf16(counts, device)
    out["launches"] = launches
    return out


def zoo_family(counts, kind: str, device, extra=None) -> dict:
    """One zoo family at full width: `Trainer.train()` for ZOO_STEPS steps
    at B=64, T=48 (its launches a step and an eval batch), then phase 11's
    eager and captured steps on that trainer (replays bit-equal, launches a
    replay, ZOO_TIMED timed each), a `Predictor` on its best-on-dev export
    (the family's forward launches a call), and a small f32 model's
    gradients on the card against the CPU.  `extra(trainer)`, when given,
    runs after the captured steps; its dict joins the result."""
    from mmda_tpu_torch.serving import Predictor

    spec = TRAIN_CONFIGS[kind]
    trainer, path = train_main_path(counts, kind)
    captured = captured_steps(trainer, counts, kind, device)
    more = extra(trainer) if extra is not None else {}
    cfg, sizes = trainer.cfg, trainer.sizes
    del trainer
    torch.cuda.empty_cache()
    pred = Predictor(cfg, max_batch=64, **sizes)
    reqs = make_requests(spread_lengths(24, cfg.bucket_sizes, 17), cfg, seed=17)
    counts.reset_launch_count()
    got = pred(reqs)
    serve = all_launches(counts)
    if serve != expected_launches(counts, spec["per_eval"]):
        raise AssertionError(f"{kind}: a Predictor call launched {serve}, "
                             f"expected {spec['per_eval']}")
    check_outputs(got["scores"], got["labels"], got["tcp"], 24, cfg.num_classes, cfg.threshold)
    if got["hidden"].shape != (24, cfg.num_classes):
        raise AssertionError(f"{kind}: hidden output {got['hidden'].shape}")
    del pred
    torch.cuda.empty_cache()
    err = train_card_vs_cpu(device, spec.get("aligned", True),
                            **{k: v for k, v in spec["options"].items()
                               if k != "fused_ln_dropout"})
    launches = {k: path["launches"][k] + serve[k] for k in path["launches"]}
    return {"main_path": path, "captured": captured, "serve_launches": serve,
            "card_vs_cpu_err": err, "launches": launches, **more}


def native_etl() -> dict:
    """The native host library on the ETL path: it builds (`make -C
    native`: a failure fails here, nothing falls back), `cli.etl --data
    ur_funny` with a GloVe file and a WordPiece vocab prints the native
    GloVe scan's line and writes the splits and the table; the native
    `encode_batch` equals the Python one byte for byte on the corpus's
    texts and on non-ASCII rows, each timed."""
    import shutil

    from mmda_tpu_torch.data import load_splits
    from mmda_tpu_torch.data.etl import native_bridge
    from mmda_tpu_torch.data.etl.tokenizer import WordPieceTokenizer

    t0 = time.perf_counter()
    lib = native_bridge.load()
    build_s = time.perf_counter() - t0
    if lib is None:
        raise RuntimeError("the native host library did not build (make -C native)")
    data_dir = BUILD / "chip_smoke_native"
    shutil.rmtree(data_dir, ignore_errors=True)
    words = [f"w{i}" for i in range(2000)]
    write_urfunny(data_dir / "UR_FUNNY", words=words, seed=1)
    rng = np.random.default_rng(2)
    with open(data_dir / "glove.txt", "w") as f:
        for w in words[::2]:
            f.write(w + " " + " ".join(f"{v:.5f}" for v in rng.normal(size=300)) + "\n")
    pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "w"] + [f"##{d}" for d in range(10)] + \
        words[:100]
    (data_dir / "vocab.txt").write_text("\n".join(pieces) + "\n")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "mmda_tpu_torch.cli.etl", "--data", "ur_funny",
                          "--data_dir", str(data_dir), "--word_emb_path",
                          str(data_dir / "glove.txt"), "--bert_vocab",
                          str(data_dir / "vocab.txt")], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    etl_s = time.perf_counter() - t0
    if out.returncode != 0 or "(native scan)" not in out.stdout:
        raise RuntimeError(f"cli.etl exit {out.returncode}, no native scan line:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    scan = next(line for line in out.stdout.splitlines() if "(native scan)" in line)
    splits = load_splits(str(data_dir / "UR_FUNNY"))
    emb = np.load(data_dir / "UR_FUNNY" / "glove_emb.npy")
    tok = WordPieceTokenizer.from_vocab_file(str(data_dir / "vocab.txt"))
    if tok._native_handle() is None:
        raise RuntimeError("the WordPiece tokenizer holds no native handle")
    py = WordPieceTokenizer(tok.vocab, use_native=False)
    texts = [" ".join(rng.choice(words, size=int(rng.integers(2, 40)))) for _ in range(768)]
    texts += ["naïve w12 café", "w3 模型 w4", "Ünïcödé"]
    t0 = time.perf_counter()
    nat = tok.encode_batch(texts, 66)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = py.encode_batch(texts, 66)
    python_s = time.perf_counter() - t0
    if any(a.dtype != b.dtype or a.tobytes() != b.tobytes() for a, b in zip(nat, ref)):
        raise AssertionError("native encode_batch differs from the Python one")
    return {"build_or_load_s": build_s, "etl_s": etl_s, "glove_scan_line": scan,
            "rows": {k: len(v["lengths"]) for k, v in splits.items()},
            "glove_table": list(emb.shape), "texts": len(texts),
            "encode_native_s": native_s, "encode_python_s": python_s, "byte_equal": True}


def phase13(counts, klstm, device) -> dict:
    """HF BERT, int8 serving, the zoo's first four families and the native
    host library (module docstring, phase 13); each part's launches."""
    t0 = time.perf_counter()
    ckpt = hf_checkpoint()
    port_tensors = ckpt.pop("port_tensors")
    log("13 hf-checkpoint", **ckpt)
    path, hf = hf_train(counts, device, port_tensors)
    del port_tensors
    hf["main_path"] = path
    log("13 hf-train", **{k: v for k, v in hf.items() if k != "eager_step_host"})
    log("13 eager-step-host", **hf["eager_step_host"])
    cli = hf_cli_train(counts, device)
    log("13 hf-cli-train", **cli)
    torch.cuda.empty_cache()
    int8 = int8_serving(counts, klstm, device)
    for dtype in ("int8", "bfloat16", "None"):
        log("13 int8-serving", bert_weights_dtype=dtype, **int8[dtype])
    log("13 int8-card-vs-cpu", max_abs_err=int8["card_vs_cpu_int8_err"], tol=DEVICE_TOL)
    for row in int8["dense_bf16"]:
        log("13 int8-dense-bf16", **row)
    log("13 int8-encode-bf16", **int8["encode_bf16"])
    zoo = {}
    for kind in ZOO:
        torch.cuda.empty_cache()
        zoo[kind] = zoo_family(counts, kind, device)
        log("13 zoo", kind=kind, **{k: v for k, v in zoo[kind].items() if k != "captured"})
        log("13 zoo-captured", **zoo[kind]["captured"])
    native = native_etl()
    log("13 native", **native)
    launches = {name: (hf["main_path"]["launches"][name] + cli["launches"][name]
                       + int8["launches"][name]
                       + sum(z["launches"][name] for z in zoo.values()))
                for name in counts.KERNELS}
    return {"hf_checkpoint": ckpt, "hf_train": hf, "hf_cli": cli, "int8": int8, "zoo": zoo,
            "native": native, "launches": launches, "seconds": time.perf_counter() - t0}


# ------------------------------ phase 14: MULT, MAG_BERT, MMIM; the export on a thread

EXPORT_REPS = 3


def export_times(trainer) -> dict:
    """The best-on-dev export of a bert-base trainer's parameters, written
    synchronously against `save_checkpoint(async_write=True)`: the time to
    its return (the host copy) and to its join; EXPORT_REPS of each, the
    median.  Both files must be the same bytes."""
    from mmda_tpu_torch.train import checkpoint as ckpt

    where = str(BUILD / "chip_smoke_export_times")
    sync, returned, joined = [], [], []
    for _ in range(EXPORT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(where, "sync", trainer.eval_model(), {"epoch": 0})
        sync.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        thread = ckpt.save_checkpoint(where, "async", trainer.eval_model(), {"epoch": 0},
                                      async_write=True)
        returned.append(time.perf_counter() - t0)
        thread.join()
        joined.append(time.perf_counter() - t0)
    files = [pathlib.Path(where, f"{n}.msgpack").read_bytes() for n in ("sync", "async")]
    if files[0] != files[1]:
        raise AssertionError("the export written on a thread differs from the synchronous one")
    return {"export_bytes": len(files[0]), "export_sync_s": statistics.median(sync),
            "export_async_return_s": statistics.median(returned),
            "export_async_joined_s": statistics.median(joined)}


def mmim_aux(trainer) -> dict:
    """MMIM's auxiliary objective in a training-mode forward (dropout on) of
    one train batch: model_aux's total, nll and nce, and the objective's
    `model_aux` term; all finite."""
    from mmda_tpu_torch.data.loader import ArrayLoader, to_device
    from mmda_tpu_torch.train.objective import compute_losses

    cfg = trainer.cfg
    host = next(ArrayLoader(trainer.data["train"], cfg.batch_size, shuffle=False,
                            bucket_sizes=cfg.bucket_sizes).host_batches())
    batch = to_device(host, trainer.device)
    with torch.no_grad():
        out = trainer.model.train()(batch, None, None, trainer.generator)
        losses = compute_losses(cfg, out, batch)
    aux = {f"model_aux_{k}": float(v) for k, v in out.model_aux.items()}
    aux["objective_model_aux"] = float(losses["model_aux"])
    finite_losses(aux, "MMIM model_aux")
    return {"mmim_aux": aux}


def phase14(counts, device) -> dict:
    """MULT (aligned and unaligned), MAG_BERT and MMIM at full width, each
    as a phase 13 zoo family (module docstring, phase 14), every replay
    bit-equal to its eager step, the export's write times beside MULT's;
    each part's launches."""
    t0 = time.perf_counter()
    zoo = {}
    extras = {"mult": export_times, "mmim": mmim_aux}
    for kind in ZOO_REST:
        torch.cuda.empty_cache()
        zoo[kind] = zoo_family(counts, kind, device, extras.get(kind))
        if zoo[kind]["captured"]["captured_diffs"]:
            raise AssertionError(f"{kind}: replays differ from the eager steps: "
                                 f"{zoo[kind]['captured']['captured_diffs']}")
        log("14 zoo", kind=kind, **{k: v for k, v in zoo[kind].items() if k != "captured"})
        log("14 zoo-captured", **zoo[kind]["captured"])
    launches = {name: sum(z["launches"][name] for z in zoo.values())
                for name in counts.KERNELS}
    return {"zoo": zoo, "launches": launches, "seconds": time.perf_counter() - t0}


# ---------------------------- phase 15: serving artifacts, the kernels as ops; MoE BERT

EXPORT_BUCKETS = (32, 64)         # the default Config's buckets but 16 (the same graph at
                                  # a smaller shape: cut for time), max_batch 64
FLASH_EXPORT = (512, 32)          # the long bucket and its batch
EXPORT_SERVED = 6                 # requests posted one at a time to the artifact's server
ZOO_FREE = ("mmda_tpu_torch.models", "mmda_tpu_torch.serving", "mmda_tpu_torch.train")
MOE_OPTIONS = {"attn_impl": "fused", "moe_experts": 4, "moe_top_k": 1,
               "moe_capacity_factor": 1.25}
MOE_TRAINED_LAYER = 9             # the first encoder layer the mosei freeze rule trains
TRAIN_CONFIGS["moe"] = {"options": MOE_OPTIONS, "steps": ZOO_STEPS, "timed": ZOO_TIMED,
                        "per_step": TRAIN_CONFIGS["fused"]["per_step"],
                        "per_eval": TRAIN_CONFIGS["fused"]["per_eval"],
                        "profile": TRAIN_CONFIGS["fused"]["profile"]}
FUSED_CALL = {"lstm_fwd": LAUNCHES_PER_CALL, "short_attn_fwd": BERT_LAYERS}
FLASH_CALL = {"lstm_fwd": LAUNCHES_PER_CALL, "flash_fwd": BERT_LAYERS}


def direct_dispatch(klstm, kgru, kshort, kattn):
    """The four forward wrappers calling their ops' implementations
    (`_forward`) directly, without the `torch.library` dispatch: how they
    ran before they became ops (the same kernels, the same bits)."""
    def lstm(x, w, m, reverse, need_cs):
        ys, cs, h, c = klstm._forward(x, w, m, reverse, need_cs)
        return ys, x.new_empty(0) if cs is None else cs, h, c

    stack = contextlib.ExitStack()
    for module, name, fn in ((klstm, "lstm_recurrence_op", lstm),
                             (kgru, "gru_recurrence_op", kgru._forward),
                             (kshort, "short_attention_fwd_op", kshort._forward),
                             (kattn, "flash_attention_fwd_op", kattn._forward)):
        stack.enter_context(replaced(module, name, fn))
    return stack


def op_dispatch_ab(trainer, kernels, device, n: int = 5, pairs: int = 6,
                   calls: int = 400) -> dict:
    """The cost of the `torch.library` dispatch.  (a) Eager training steps
    of a trainer through the kernel ops (as shipped) and with
    `direct_dispatch`, `pairs` pairs of n steps each, the side that runs
    first alternating: host ms per step over all steps of a side (median
    and quartiles) and whether both give the same losses; (b) us per call of
    `lstm_recurrence` and `short_attention_fwd` at the smallest shapes phase
    3 checks ((T, B, H) = (7, 5, 33); (B, nh, S, hd) = (3, 4, 10, 8) f32),
    back to back, through the op and directly, `calls` each, in the order
    op, direct, direct, op."""
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.train.step import train_step

    klstm, kshort = kernels[0], kernels[2]
    cfg = trainer.cfg
    batch = next(iter(ArrayLoader(trainer.data["train"], cfg.batch_size, shuffle=False,
                                  bucket_sizes=cfg.bucket_sizes, device=device)))
    snap = train_state(trainer)
    times = {"op": [], "direct": []}
    losses = {}

    def steps(side: str) -> None:
        restore_train_state(trainer, snap)
        with (direct_dispatch(*kernels) if side == "direct" else contextlib.nullcontext()):
            for _ in range(n):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                out = train_step(trainer.model, trainer.optimizer, batch, cfg,
                                 trainer.generator, trainer.ema)
                torch.cuda.synchronize(device)
                times[side].append((time.perf_counter() - t0) * 1e3)
                losses.setdefault(side, {k: v.clone() for k, v in out.items()})

    for i in range(pairs):
        for side in (("op", "direct") if i % 2 == 0 else ("direct", "op")):
            steps(side)
    restore_train_state(trainer, snap)
    diffs = bit_diffs(losses["op"], losses["direct"])
    if diffs:
        raise AssertionError(f"eager step through the ops vs direct: {diffs}")
    x, w, m = lstm_inputs(*CHECK_SHAPES[-2], 0, device)[:3]      # the smallest checked shapes
    q, k, v, _, bias = short_inputs(*SHORT_SHAPES[-1], torch.float32, 0, device)
    per_call = {}
    for name, fn in (("lstm_recurrence", lambda: klstm.lstm_recurrence(x, w, m)),
                     ("short_attention_fwd",
                      lambda: kshort.short_attention_fwd(q, k, v, bias, None))):
        us = {"op": [], "direct": []}
        for side in ("op", "direct", "direct", "op"):
            with (direct_dispatch(*kernels) if side == "direct" else contextlib.nullcontext()):
                fn()
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize(device)
                us[side].append((time.perf_counter() - t0) * 1e6 / calls)
        per_call[name] = us

    def quartiles(v):
        q = statistics.quantiles(v, n=4)
        return {"median": statistics.median(v), "q1": q[0], "q3": q[2]}

    return {"steps_per_side": n * pairs, "op_ms": quartiles(times["op"]),
            "direct_ms": quartiles(times["direct"]), "same_losses": True,
            "host_us_per_call": per_call}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get_json(url: str, timeout: float = 60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def serve_artifact_subprocess(export_dir, requests, per_call: dict) -> dict:
    """`python -X importtime -m mmda_tpu_torch.cli.serve --export_dir` in a
    fresh process: wait for /healthz, post `requests` one at a time (one
    `ExportedPredictor` call each, after the server's warm-up captured every
    bucket), read the launches from /healthz around them (replays: `per_call`
    each, no other kernel), stop it, and read from its import log that it
    never imported the zoo, the live serving module or the trainer."""
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    logs = [BUILD / f"chip_smoke_export_served.{k}" for k in ("out", "err")]
    t0 = time.perf_counter()
    with open(logs[0], "w") as out, open(logs[1], "w") as err:  # the import log is long
        proc = subprocess.Popen([sys.executable, "-X", "importtime", "-m",
                                 "mmda_tpu_torch.cli.serve", "--export_dir", str(export_dir),
                                 "--port", str(port)], cwd=ROOT, stdout=out, stderr=err)
    try:
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"cli.serve --export_dir exited {proc.returncode}:\n"
                                   f"{logs[1].read_text()[-4000:]}")
            try:
                before = get_json(url + "/healthz", 5)
                break
            except OSError:
                if time.perf_counter() - t0 > 200:
                    raise
                time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        replies = [post(url, r) for r in requests]
        after = get_json(url + "/healthz")
    finally:
        proc.send_signal(2)                     # SIGINT: the server shuts down, then exits
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    out, err = (f.read_text() for f in logs)
    calls = after["stats"]["requests"] - before["stats"]["requests"]
    launches = {k: after["kernel_launches"][k] - before["kernel_launches"][k]
                for k in after["kernel_launches"]}
    want = {k: per_call.get(k, 0) * calls for k in launches}
    if calls != len(requests) or launches != want:
        raise AssertionError(f"artifact server: {calls} calls launched {launches}, "
                             f"expected {per_call} a call")
    imported = [line.rsplit("|", 1)[1].strip() for line in err.splitlines()
                if line.startswith("import time:") and "|" in line]
    loaded = sorted(m for m in imported if m.startswith("mmda_tpu_torch"))
    zoo = [m for m in loaded if any(m == z or m.startswith(z + ".") for z in ZOO_FREE)]
    if zoo or "mmda_tpu_torch.serving_export" not in loaded:
        raise AssertionError(f"the artifact's server imported {zoo} (loaded {loaded})")
    return {"ready_s": ready_s, "calls": calls, "launches": launches,
            "launches_per_call": {k: v // calls for k, v in launches.items() if v},
            "port_modules_loaded": loaded, "zoo_free": True,
            "scores": [r["scores"] for r in replies], "served_line": out.strip()[-300:]}


def compare_scores(want: np.ndarray, got: np.ndarray, where: str) -> dict:
    """Bit-equal share and the largest difference; raises beyond SERVE_TOL."""
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    err = float(np.abs(want - got).max())
    if not err <= SERVE_TOL:
        raise AssertionError(f"{where}: scores {err} from the live Predictor > {SERVE_TOL}")
    return {"max_abs_diff": err, "bit_equal": bool(np.array_equal(want, got)),
            "share_not_bit_equal": float(np.mean(want != got))}


def artifact_latency(cfg, live, exported, buckets, batch) -> list:
    """Host ms of a call (median of 10, each ended by the device-to-host
    copy) of the exported and the live Predictor, both captured, at each
    bucket for a full batch and one request."""
    rows = []
    for b in buckets:
        reqs = make_requests([b] * batch, cfg, seed=b + 5)
        for n in (batch, 1):
            row = {"bucket": b, "batch": n}
            for name, pred in (("exported", exported), ("live", live)):
                pred(reqs[:n])
                row[f"{name}_ms"] = host_ms(lambda i: pred(reqs[:n]), 10)["ms"]
            rows.append(row)
    return rows


def export_and_compare(cfg, model, counts, device, out_dir, per_call, buckets, batch,
                       weights_dtype=None) -> tuple:
    """Export `model` at `buckets` (max_batch `batch`), load the artifact
    in this process, and hold one call per bucket (a full batch and one
    request) against the live `Predictor` on a copy of the same weights:
    its launches a call and the scores.  Returns (result, live, exported)."""
    from mmda_tpu_torch.serving import Predictor
    from mmda_tpu_torch.serving_export import ExportedPredictor, export_model

    t0 = time.perf_counter()
    manifest = export_model(cfg, model, str(out_dir), max_batch=batch, bucket_sizes=buckets,
                            weights_dtype=weights_dtype)
    export_s = time.perf_counter() - t0
    live = Predictor(cfg, params=copy.deepcopy(model), max_batch=batch,
                     bert_weights_dtype=weights_dtype or "auto")
    t0 = time.perf_counter()
    exported = ExportedPredictor(str(out_dir))
    load_s = time.perf_counter() - t0
    compared, launches = [], {}
    for b in buckets:
        reqs = make_requests(spread_lengths(batch, (b,), b), cfg, seed=b)
        for n in (batch, 1):
            want = live(reqs[:n])
            exported(reqs[:n])                      # a bucket's first call: eager, captured
            counts.reset_launch_count()
            got = exported(reqs[:n])
            launches = all_launches(counts)
            if launches != expected_launches(counts, per_call):
                raise AssertionError(f"exported call at bucket {b}: launches {launches}, "
                                     f"expected {per_call}")
            check_outputs(got["scores"], got["labels"], got["tcp"], n, cfg.num_classes,
                          cfg.threshold)
            compared.append({"bucket": b, "batch": n,
                             **compare_scores(want["scores"], got["scores"],
                                              f"exported bucket {b}, B={n}")})
    files = {str(b): (out_dir / f"bucket_{b}.pt2").stat().st_size for b in buckets}
    return ({"buckets": list(buckets), "max_batch": batch, "weights_dtype": weights_dtype,
             "export_s": export_s, "export_s_by_bucket": manifest["export_s"],
             "pt2_bytes": files, "load_s": load_s, "launches_per_call": per_call,
             "compared": compared}, live, exported)


def moe_train(counts, device) -> dict:
    """MISA with a bert-base MoE tower (MOE_OPTIONS, grouped by example, the
    mosei freeze rule) at B=64, T=48: `Trainer.train()` for ZOO_STEPS steps
    (12 + 12 short attention and 8 + 8 LSTM a step), `moe` and `moe_drop`
    finite, an eager step moves the router of layer MOE_TRAINED_LAYER; phase
    11's eager and captured steps with every replay bit-equal; a small f32
    MoE model's gradients on the card against the CPU; then a `Predictor` on
    the best-on-dev export against an `ExportedPredictor` of it (bucket 64)."""
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.serving import Predictor
    from mmda_tpu_torch.serving_export import ExportedPredictor, export_model
    from mmda_tpu_torch.train.step import train_step

    trainer, path = train_main_path(counts, "moe")
    epoch = {k: path[k] for k in ("train_loss",)}
    moe = trainer.model.bert.layers[MOE_TRAINED_LAYER].moe
    frozen = trainer.model.bert.layers[MOE_TRAINED_LAYER - 1].moe
    if frozen.gate.requires_grad or not moe.gate.requires_grad:
        raise AssertionError("the mosei freeze rule does not cover the MoE layers by index")
    cfg = trainer.cfg
    batch = next(iter(ArrayLoader(trainer.data["train"], cfg.batch_size, shuffle=False,
                                  bucket_sizes=cfg.bucket_sizes, device=device)))
    gate0 = moe.gate.detach().clone()
    losses = train_step(trainer.model, trainer.optimizer, batch, cfg, trainer.generator,
                        trainer.ema)
    terms = {k: float(losses[k]) for k in ("moe", "moe_drop", "total")}
    finite_losses(terms, "MoE step")
    if terms["moe"] == 0.0 or torch.equal(gate0, moe.gate.detach()):
        raise AssertionError(f"the MoE step left the router unchanged ({terms})")
    epoch.update(terms)
    captured = captured_steps(trainer, counts, "moe", device)
    if captured["captured_diffs"]:
        raise AssertionError(f"MoE replays differ from the eager steps: "
                             f"{captured['captured_diffs']}")
    params = {"total": sum(p.numel() for p in trainer.model.parameters()),
              "experts": sum(p.numel() for n, p in trainer.model.named_parameters()
                             if ".moe." in n)}
    sizes = trainer.sizes
    del trainer, moe, frozen, batch
    torch.cuda.empty_cache()
    err = train_card_vs_cpu(device, **MOE_OPTIONS)
    cfg = cfg.replace(bucket_sizes=(64,))            # serving's largest bucket
    live = Predictor(cfg, max_batch=64, **sizes)
    out_dir = BUILD / "chip_smoke_export_moe"
    manifest = export_model(cfg, None, str(out_dir), visual_size=sizes["visual_size"],
                            acoustic_size=sizes["acoustic_size"], max_batch=64)
    exported = ExportedPredictor(str(out_dir))
    reqs = make_requests(spread_lengths(64, (64,), 21), cfg, seed=21)
    want = live(reqs)
    exported(reqs)
    counts.reset_launch_count()
    got = exported(reqs)
    serve = all_launches(counts)
    if serve != expected_launches(counts, FUSED_CALL):
        raise AssertionError(f"MoE artifact call: launches {serve}")
    return {"main_path": path, "step": epoch, "captured": captured, "parameters": params,
            "card_vs_cpu_err": err, "tol": DEVICE_TOL,
            "export_s": manifest["export_s"], "serve_launches": serve,
            "exported_vs_live": compare_scores(want["scores"], got["scores"], "MoE artifact"),
            "launches": {k: path["launches"][k] + serve[k] for k in path["launches"]}}


def phase15(counts, device) -> dict:
    """Serving artifacts at full width (module docstring, phase 15) and the
    MoE training step; each part's launches."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.models import init_misa

    t0 = time.perf_counter()
    cfg = Config(attn_impl="fused")
    model = init_misa(cfg, seed=0, device=device)
    fused, live, exported = export_and_compare(
        cfg, model, counts, device, BUILD / "chip_smoke_export_fused", FUSED_CALL,
        EXPORT_BUCKETS, 64)
    fused["latency"] = artifact_latency(cfg, live, exported, EXPORT_BUCKETS, 64)
    log("15 export-fused", **fused)
    reqs = make_requests(spread_lengths(EXPORT_SERVED, EXPORT_BUCKETS, 33), cfg, seed=33)
    want = [live([r])["scores"][0] for r in reqs]
    del live, exported
    torch.cuda.empty_cache()
    sub = serve_artifact_subprocess(BUILD / "chip_smoke_export_fused", reqs, FUSED_CALL)
    sub.update(compare_scores(want, sub.pop("scores"), "the artifact's server"))
    fused["subprocess"] = sub
    log("15 export-served", **sub)
    int8, live, exported = export_and_compare(
        cfg, model, counts, device, BUILD / "chip_smoke_export_int8", FUSED_CALL, (64,), 64,
        weights_dtype="int8")
    int8["latency"] = artifact_latency(cfg, live, exported, (64,), 64)
    log("15 export-int8", **int8)
    del model, live, exported
    torch.cuda.empty_cache()
    T, B = FLASH_EXPORT
    long_cfg = Config(attn_impl="flash", bucket_sizes=(T,), max_seq_len=T)
    model = init_misa(long_cfg, seed=0, device=device)
    flash, live, exported = export_and_compare(
        long_cfg, model, counts, device, BUILD / "chip_smoke_export_flash", FLASH_CALL, (T,), B)
    flash["latency"] = artifact_latency(long_cfg, live, exported, (T,), B)
    log("15 export-flash", **flash)
    del model, live, exported
    torch.cuda.empty_cache()
    moe = moe_train(counts, device)
    log("15 moe-train", **{k: v for k, v in moe.items() if k != "captured"})
    log("15 moe-captured", **moe["captured"])
    launches = {name: (sub["launches"][name] + moe["launches"][name]) for name in counts.KERNELS}
    return {"fused": fused, "int8": int8, "flash": flash, "moe": moe, "launches": launches,
            "seconds": time.perf_counter() - t0}


# ------------------------------------------ phase 16: fused attention at the long shape

FUSED_LONG_CALL = {"lstm_fwd": LAUNCHES_PER_CALL, "short_attn_tiled_fwd": BERT_LAYERS}
FUSED_LONG_CLI = ("--attn_impl", "fused", "--max_seq_len", str(LONG_T), "--batch_size",
                  str(LONG_B), "--bucket_sizes", f"64,{LONG_T}")
# the `cli.train` runs that phases 6, 7, 9 and 16 serve from (train_then_serve_all):
# log line -> (options, the kernels a Predictor call on the checkpoint launches)
CLI_RUNS = {
    "6 train-then-serve": ((), {"lstm_fwd": LAUNCHES_PER_CALL}),
    "7 gru-train-then-serve": (("--rnncell", "gru", "--fused_ln_dropout", "True"),
                               {"gru_fwd": LAUNCHES_PER_CALL}),
    "9 fused-train-then-serve": (("--attn_impl", "fused"),
                                 {"lstm_fwd": LAUNCHES_PER_CALL, "short_attn_fwd": BERT_LAYERS}),
    "16 fused-cli-train-then-serve": (FUSED_LONG_CLI, FUSED_LONG_CALL)}


def serve_fused_long(cfg, counts, device) -> dict:
    """A `Predictor(attn_impl="fused")` on the checkpoint the fused long run
    wrote, one bucket of LONG_T, LONG_B rows a call, behind the HTTP front
    end: BERT_LAYERS `short_attn_tiled_fwd` and LAUNCHES_PER_CALL `lstm_fwd`
    launches per call and no other; its captured calls at B=LONG_B and B=1
    against eager calls, bit for bit, with both latencies; then the same
    batch through the same weights with the dense core and with the flash
    kernels, each within FLASH_SERVE_TOL (dropout off: the same function)."""
    from mmda_tpu_torch.ops.kernels.lstm import lstm_recurrence
    from mmda_tpu_torch.serving import Predictor

    fused_cfg = cfg.replace(attn_impl="fused", bucket_sizes=(LONG_T,), max_seq_len=LONG_T)
    pred = Predictor(fused_cfg, max_batch=LONG_B)
    rng = np.random.default_rng(16)
    lengths = [LONG_T, 1] + [int(n) for n in rng.integers(LONG_T // 4, LONG_T + 1, size=46)]
    out = serve_over_http(fused_cfg, pred, make_requests(lengths, fused_cfg, 16), counts,
                          per_call=FUSED_LONG_CALL)
    batch = make_requests(lengths[:LONG_B], fused_cfg, 17)
    counts.reset_launch_count()
    got = pred(batch)
    if all_launches(counts) != expected_launches(counts, FUSED_LONG_CALL):
        raise AssertionError(f"fused Predictor call at bucket {LONG_T}: {all_launches(counts)}")
    out["captured"] = serve_captured_vs_eager(fused_cfg, pred, lstm_recurrence, device)
    del pred
    torch.cuda.empty_cache()
    check_outputs(got["scores"], got["labels"], got["tcp"], LONG_B, cfg.num_classes,
                  cfg.threshold)
    for core, kernels in (("xla", {}), ("flash", {"flash_fwd": BERT_LAYERS})):
        other = Predictor(fused_cfg.replace(attn_impl=core), max_batch=LONG_B)
        counts.reset_launch_count()
        want = other(batch)
        if all_launches(counts) != expected_launches(
                counts, {"lstm_fwd": LAUNCHES_PER_CALL, **kernels}):
            raise AssertionError(f"{core} Predictor call: {all_launches(counts)}")
        err = max(float(np.abs(got[k] - want[k]).max()) for k in ("scores", "tcp", "hidden"))
        if err > FLASH_SERVE_TOL:
            raise AssertionError(f"fused Predictor vs the {core} one at bucket {LONG_T}: "
                                 f"{err} > {FLASH_SERVE_TOL}")
        out[f"fused_vs_{core}_err"] = err
        out[f"{core}_latency"] = bucket_latency(fused_cfg, other, device)
        del other
        torch.cuda.empty_cache()
    return out


def step_summary(steps, captured, kind: str) -> dict:
    """One training configuration's step beside another's: captured and
    eager ms a step, busy ms of a replay, its attention kernels' device ms
    a step (by the names in the configuration's profile), peak allocated
    memory (eager timed steps, eager and captured steps of phase 11)."""
    prof = captured["captured_profile"]
    attention = [k for k in TRAIN_CONFIGS[kind]["profile"] if not k.startswith("lstm")]
    return {"captured_ms": captured["captured"]["ms"], "eager_ms": captured["eager"]["ms"],
            "busy_ms": prof["device_busy_ms_per_call"],
            "attention_ms_per_step": {k: prof.get(f"{k}_ms_per_call") for k in attention},
            "peak_allocated_gb": {"eager_timed": steps["peak_mem_gb"],
                                  "eager": captured["eager"]["peak_mem_gb"],
                                  "captured": captured["captured"]["peak_mem_gb"]}}


F32_PATHS = {   # kind: (the design constant, its designs, the profile names read a step)
    "fused_long_f32": ("_TILED_IMPL", TILED_DESIGNS[torch.float32],
                       ("tiled_fwd", "tiled_r", "tiled_dq", "tiled_dkv")),
    "fused_f32": ("_BLOCK_IMPL", BLOCK_F32_DESIGNS, ("short_attn_fwd", "short_attn_bwd"))}


def f32_path(counts, kshort, device, kind: str, designs=(0,)) -> dict:
    """Phase 11's f32 fused steps: MISA at bert-base width with
    compute_dtype="float32", attn_impl="fused" and dropout, `kind`
    "fused_long_f32" (B=32, T=512: the tiled kernels) or "fused_f32" (the
    flagship B=64, T=48: the block kernels): `Trainer.train()` for the
    configuration's steps (its launches: BERT_LAYERS forward + backward
    short-attention launches and LAUNCHES_PER_CALL `lstm_fwd` + `lstm_bwd` a
    step, BERT_LAYERS + LAUNCHES_PER_CALL an eval batch), then
    `captured_steps` (replays bit-equal to eager steps, ms a step, busy,
    idle share, peak memory, the attention kernels' device ms a step), for
    each f32 design of the route's kernels in `designs` (`F32_PATHS`: 0 on
    the tensor cores, 1 f32 FMAs), in turns on one trainer.  "fused_f32"
    also serves the trainer's export through a captured f32 `Predictor`
    (`serve_fused_f32`).  {design name: its summaries in turn}, the main
    path's, and the Predictor's."""
    constant, names, attention = F32_PATHS[kind]
    trainer, path = train_main_path(counts, kind)
    log(f"11 {kind.replace('_', '-')}-main-path", **path)
    out = {"main_path": path}
    for impl in designs:
        name = names[impl][0]
        with replaced(kshort, constant, impl):
            captured = captured_steps(trainer, counts, kind, device)
        log("11 captured-steps", design=name, **captured)
        prof = captured["captured_profile"]
        out.setdefault(name, []).append({
            "captured_ms": captured["captured"]["ms"], "eager_ms": captured["eager"]["ms"],
            "busy_ms": prof["device_busy_ms_per_call"],
            "device_ops": prof.get("device_ops_per_call"),
            "idle_share": {k: captured[k].get("idle_share") for k in ("eager", "captured")},
            "attention_ms_per_step": {k: prof.get(f"{k}_ms_per_call") for k in attention},
            "peak_allocated_gb": {k: captured[k]["peak_mem_gb"] for k in ("eager", "captured")},
            "captured_diffs": captured["captured_diffs"],
            "launches_per_replay": captured["launches_per_replay"]})
    log(f"11 {kind.replace('_', '-')}", **{k: v for k, v in out.items() if k != "main_path"})
    cfg = trainer.cfg
    del trainer
    torch.cuda.empty_cache()
    if kind == "fused_f32":
        out["serve"] = serve_fused_f32(cfg, counts, device)
        log("11 captured-serve", kind=kind, **out["serve"])
    return out


FUSED_F32_BUCKET = 64             # the f32 fused Predictor's bucket, at B = 64


def serve_fused_f32(cfg, counts, device) -> dict:
    """A captured f32 `Predictor` with attn_impl="fused" on the checkpoint the
    `fused_f32` run wrote, at bucket FUSED_F32_BUCKET, B=64: a replayed call
    launches BERT_LAYERS `short_attn_fwd` and LAUNCHES_PER_CALL `lstm_fwd`
    and nothing else; `serve_captured_vs_eager` (replays bit for bit with
    eager calls through the same kernels, both latencies); scores finite."""
    from mmda_tpu_torch.ops.kernels.lstm import lstm_recurrence
    from mmda_tpu_torch.serving import Predictor

    pred_cfg = cfg.replace(bucket_sizes=(FUSED_F32_BUCKET,), max_seq_len=FUSED_F32_BUCKET)
    pred = Predictor(pred_cfg, max_batch=64)
    batch = make_requests([FUSED_F32_BUCKET] * 64, pred_cfg, 13)
    pred(batch)                             # the warm-up, then the capture
    counts.reset_launch_count()
    got = pred(batch)
    launches = all_launches(counts)
    per_call = {"lstm_fwd": LAUNCHES_PER_CALL, "short_attn_fwd": BERT_LAYERS}
    if launches != expected_launches(counts, per_call):
        raise AssertionError(f"f32 fused Predictor replay: {launches}")
    check_outputs(got["scores"], got["labels"], got["tcp"], 64, cfg.num_classes, cfg.threshold)
    out = {"bucket": FUSED_F32_BUCKET, "batch": 64, "compute_dtype": pred_cfg.compute_dtype,
           "launches_per_call": {k: v for k, v in launches.items() if v},
           **serve_captured_vs_eager(pred_cfg, pred, lstm_recurrence, device)}
    del pred
    torch.cuda.empty_cache()
    return out


def phase16(counts, klstm, device, cli=None) -> dict:
    """The fused configuration at the long shape (module docstring, phase
    16): the training phases, phase 8's flash step timed on the same
    trainer, the same step in f32 (`fused_long_f32`), the bucket-512
    Predictor, `cli.train --attn_impl fused` at T=512 and a Predictor on
    its export (`cli`, where the caller ran it with the other CLI_RUNS);
    each part's launches."""
    from mmda_tpu_torch.ops.kernels import short_attention as kshort

    t0 = time.perf_counter()
    trainer, train = train_phases(16, "fused_long", klstm.lstm_recurrence_reference, counts,
                                  device, small_T=FUSED_LONG_SMALL_T, attn_impl="fused")
    cfg = trainer.cfg
    trainer.cfg = trainer.model.cfg = cfg.replace(attn_impl="flash", compiled_epoch=False)
    try:            # phase 8's flash step, beside the fused one on the same trainer
        flash = {"steps": train_timing(trainer, counts, "long", device),
                 "captured": captured_steps(trainer, counts, "long", device)}
    finally:
        trainer.cfg = trainer.model.cfg = cfg
    log("16 flash-steps-beside", **flash["steps"])
    log("11 captured-steps", **flash["captured"])
    train["flash_beside"] = flash
    train["fused_vs_flash"] = {kind: step_summary(t["steps"], t["captured"], kind)
                               for kind, t in (("fused_long", train), ("long", flash))}
    log("16 fused-vs-flash", **train["fused_vs_flash"])
    del trainer
    torch.cuda.empty_cache()
    f32 = f32_path(counts, kshort, device, "fused_long_f32")
    serve = serve_fused_long(cfg, counts, device)
    log("16 fused-serve-http", **{k: v for k, v in serve.items() if k != "captured"},
        tol=FLASH_SERVE_TOL)
    log("11 captured-serve", kind="fused_long", **serve["captured"])
    torch.cuda.empty_cache()
    if cli is None:
        line = "16 fused-cli-train-then-serve"
        cli = serve_cli_checkpoint(start_cli_train(*CLI_RUNS[line]), device, counts)
        log(line, **cli)
    launches = {name: train["main_path"]["launches"][name]
                + train["compiled_train"]["launches"][name]
                + f32["main_path"]["launches"][name]
                + serve["launches_by_kernel"][name] for name in counts.KERNELS}
    return {"train": train, "fused_long_f32": f32, "serve": serve, "cli": cli,
            "launches": launches, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------- phase 17

DP_STEPS = 3                      # the two gloo ranks' steps, and the one-process references
DP_TIMED = 10                     # captured replays timed in (a), each side
DP_TIMEOUT_S = 60.0               # every process group's timeout; each spawned set's deadline
# (b)'s least tolerance: about 5x the losses' and 2-3x the parameters'
# distance from the one-process step that two gloo ranks and the kernels'
# split step gave (9.5e-7; 8.1e-6 and 6.8e-6: PERF.md), a fifth of one Adam
# step (lr 1e-4), which a wrong gradient's sign moves a parameter by
DP_LOSS_FLOOR, DP_PARAM_FLOOR = 5e-6, 2e-5
# (a): cli.train's flagship fused configuration, every batch the full B x T
DP_CLI = ("--data", "synthetic", "--n_epoch", "1", "--attn_impl", "fused", "--max_seq_len",
          str(TRAIN_T), "--bucket_sizes", str(TRAIN_T), "--batch_size", str(TRAIN_B),
          "--compiled_epoch", "True", "--name", "dp")
DP_CLI_STEPS, DP_CLI_EVALS = 512 // TRAIN_B, 2 * (128 // TRAIN_B)   # cli.load_data's splits
DP_PER_STEP = TRAIN_CONFIGS["fused"]["per_step"]
DP_PER_EVAL = TRAIN_CONFIGS["fused"]["per_eval"]


def dp_cfg_and_data(name: str, **options):
    """(a) and (b)'s configuration at the flagship's full width (bert-base,
    B=64, T=48, `attn_impl="fused"`, the mosei freeze rule) and its splits:
    cli.train's under DP_CLI, or (b)'s f32 one (full-length batches)."""
    from mmda_tpu_torch.cli import train as cli_train
    from mmda_tpu_torch.config import Config, get_config

    if name == "dp":
        cfg = get_config(argv=[*DP_CLI, "--ckpt_dir", str(BUILD / "chip_smoke_dp_one")])
        return cfg, cli_train.load_data(cfg)[0]
    cfg = Config(use_bert=True, data="mosei", batch_size=TRAIN_B, max_seq_len=TRAIN_T,
                 bucket_sizes=(TRAIN_T,), attn_impl="fused", n_epoch=1, seed=0, name=name,
                 ckpt_dir=str(BUILD / f"chip_smoke_{name}"), log_sinks=(), **options)
    return cfg, {"train": full_length_split(TRAIN_B * DP_STEPS, 0),
                 "dev": full_length_split(TRAIN_B, 1), "test": full_length_split(TRAIN_B, 2)}


def replay_ms(trainer, device) -> float:
    """Median host ms of DP_TIMED replays of the trainer's training graph
    (its rows under its mesh), each ended by a synchronize, after a warm-up
    and the capture."""
    from mmda_tpu_torch.train.step import make_train_graph

    hosts = [trainer._shard(h) for h in
             itertools.islice(trainer._loader("train", shuffle=False).host_batches(), 3)]
    graph = make_train_graph(trainer.model, trainer.optimizer, trainer.cfg, device,
                             trainer.generator, trainer.ema, trainer.pool, trainer.step_mesh,
                             trainer.dropout_generator)
    times = []
    for i in range(DP_TIMED + 2):
        t0 = time.perf_counter()
        graph(hosts[i % 3])
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[2:])


def dp_cli_rank(out_path: str, argv: list) -> int:
    """(a)'s rank under torchrun: the process group over nccl, then
    `cli.train` with `argv` in this process, its launches counted; then the
    captured step of the same configuration timed on this rank's mesh."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from mmda_tpu_torch.cli import train as cli_train
    from mmda_tpu_torch.config import get_config, set_reference_numerics
    from mmda_tpu_torch.ops.kernels import _launch as counts
    from mmda_tpu_torch.parallel.mesh import init_distributed
    from mmda_tpu_torch.train.loop import Trainer

    device = init_distributed("cuda", timeout_s=DP_TIMEOUT_S)
    set_reference_numerics()
    counts.reset_launch_count()
    t0 = time.perf_counter()
    summary = cli_train.main([*argv, "--device", str(device)])
    wall = time.perf_counter() - t0
    launches = all_launches(counts)
    cfg = get_config(argv=[*argv, "--device", str(device)])
    trainer = Trainer(cfg, cli_train.load_data(cfg)[0])
    step_ms = replay_ms(trainer, device)
    if dist.get_rank() == 0:
        pathlib.Path(out_path).write_text(json.dumps({
            "backend": dist.get_backend(), "world": dist.get_world_size(),
            "dp": trainer.mesh.dp, "device": str(device), "launches": launches,
            "train_wall_s": wall, "captured_ms": step_ms, "summary": summary}, default=float))
    dist.destroy_process_group()
    return 0


def dp_nccl_rank(rank: int, store: str, out_dir: str) -> None:
    """(b)'s first check: a rank of two nccl ranks on the one card; what
    the first collective does, as text."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from mmda_tpu_torch.parallel.mesh import init_distributed

    try:
        device = init_distributed("cuda:0", init_method=f"file://{store}", rank=rank,
                                  world_size=2, timeout_s=30)
        t = torch.ones(1, device=device)
        dist.all_reduce(t)
        torch.cuda.synchronize(device)
        result = f"all_reduce gave {t.item()}"
    except Exception as e:                  # what NCCL says is the result
        result = f"{type(e).__name__}: {e}"
    pathlib.Path(out_dir, f"nccl{rank}.txt").write_text(result)
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def dp_eager_steps(trainer, device, step) -> tuple:
    """DP_STEPS steps `step(host)` over the trainer's first batches (dropout
    off: both sides run the deterministic forward); ([losses], [ms])."""
    losses, times = [], []
    for host in itertools.islice(trainer._loader("train", shuffle=False).host_batches(),
                                 DP_STEPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = step(host)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    return losses, times


def dp_gloo_trainer(device):
    from mmda_tpu_torch.train.loop import Trainer

    cfg, data = dp_cfg_and_data("dp_gloo", compute_dtype="float32", compiled_epoch=False,
                                compiled_eval=False)
    trainer = Trainer(cfg, data)
    model = trainer.model
    model.train = lambda mode=True: torch.nn.Module.train(model, False)
    return trainer


def dp_gloo_rank(rank: int, store: str, ref_path: str, out_dir: str) -> None:
    """(b)'s rank: one of two gloo ranks on the one card, DP_STEPS eager f32
    steps of the data-parallel Trainer, each on its rows; its losses, step
    times and launches, and its trained parameters' distance from the
    one-process step's at the global batch (`ref_path`)."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from mmda_tpu_torch.config import set_reference_numerics
    from mmda_tpu_torch.data.loader import to_device
    from mmda_tpu_torch.ops.kernels import _launch as counts
    from mmda_tpu_torch.parallel.mesh import init_distributed
    from mmda_tpu_torch.train.step import train_step

    device = init_distributed("cuda:0", backend="gloo", init_method=f"file://{store}",
                              rank=rank, world_size=2, timeout_s=DP_TIMEOUT_S)
    set_reference_numerics()
    trainer = dp_gloo_trainer(device)
    counts.reset_launch_count()
    losses, times = dp_eager_steps(trainer, device, lambda h: train_step(
        trainer.model, trainer.optimizer, to_device(trainer._shard(h), device), trainer.cfg,
        trainer.generator, trainer.ema, mesh=trainer.step_mesh,
        dropout_generator=trainer.dropout_generator))
    launches = all_launches(counts)
    ref = torch.load(ref_path)
    err = max((p.detach().cpu() - ref[n]).abs().max().item()
              for n, p in trainer.model.named_parameters() if p.requires_grad)
    torch.save({"losses": losses, "ms": times, "launches": launches, "param_err": err,
                "backend": dist.get_backend(), "dp": trainer.mesh.dp,
                "sharded": trainer.step_mesh is not None},
               pathlib.Path(out_dir, f"gloo{rank}.pt"))
    dist.destroy_process_group()


def spawn_ranks(fn, nprocs: int, *args, must_finish: bool = True) -> bool:
    """fn(rank, *args) in nprocs processes (spawn), joined with a deadline
    of DP_TIMEOUT_S, after which they are killed; whether they all ended in
    time.  A rank that raises, or outlives the deadline under must_finish,
    fails the phase."""
    ctx = torch.multiprocessing.start_processes(fn, args=args, nprocs=nprocs, join=False,
                                                start_method="spawn")
    end = time.perf_counter() + DP_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() > end:
                if must_finish:
                    raise TimeoutError(f"{fn.__name__}: ranks ran past {DP_TIMEOUT_S} s")
                return False
        return True
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()


def split_step(trainer, host, device, counts, parts: int = 2) -> dict:
    """One training step as two ranks take it, on one process, through the
    plain versions of the kernels (`plain_versions`, the towers' recurrence
    `lstm_recurrence_reference`): the forward on each of `parts` row
    blocks, the outputs the objective reads joined, the objective on the
    global batch, its gradient, the update."""
    from mmda_tpu_torch.data.loader import to_device
    from mmda_tpu_torch.ops.kernels import lstm as klstm
    from mmda_tpu_torch.parallel.mesh import Mesh, shard_batch
    from mmda_tpu_torch.train.objective import OUTPUT_FIELDS, compute_losses

    model, opt, cfg = trainer.model, trainer.optimizer, trainer.cfg
    model.train()
    with plain_versions(counts):
        outs = [model(to_device(shard_batch(host, Mesh(parts, r, device)), device), None,
                      klstm.lstm_recurrence_reference) for r in range(parts)]
        names = [f for f in OUTPUT_FIELDS if getattr(outs[0], f) is not None]
        out = outs[0]._replace(**{f: torch.cat([getattr(o, f) for o in outs]) for f in names})
        losses = compute_losses(cfg, out, to_device(host, device))
        grads = torch.autograd.grad(losses["total"], opt.params, allow_unused=True,
                                    materialize_grads=True)
    grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    opt.advance()
    opt.apply(grads)
    return {**{k: v.detach() for k, v in losses.items()}, "grad_norm": grad_norm}


def phase17(counts, device) -> dict:
    """Data parallelism (module docstring, phase 17): (a) `cli.train` under
    `torchrun --nproc_per_node 1` over nccl with compiled_epoch against the
    one-process Trainer, bit for bit, launches counted, and both captured
    steps timed; (b) NCCL with two ranks on the one card (refused), then two
    gloo ranks on it, eager f32 steps, against the one-process step at the
    global batch."""
    from mmda_tpu_torch.data.loader import to_device
    from mmda_tpu_torch.train.loop import Trainer
    from mmda_tpu_torch.train.step import train_step

    t0 = time.perf_counter()
    work = BUILD / "chip_smoke_dp"
    work.mkdir(parents=True, exist_ok=True)
    # (a) one nccl rank under torchrun, then the one-process Trainer
    out_json, dp_dir = work / "cli_rank0.json", BUILD / "chip_smoke_dp_nccl"
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "1", str(ROOT / "chip_smoke.py"), "--dp-cli", str(out_json), *DP_CLI,
         "--ckpt_dir", str(dp_dir)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        raise RuntimeError(f"torchrun cli.train exit {run.returncode}:\n{run.stdout[-2000:]}\n"
                           f"{run.stderr[-3000:]}")
    rank0 = json.loads(out_json.read_text())
    want = expected_launches(counts, {k: n * DP_CLI_STEPS + DP_PER_EVAL.get(k, 0) * DP_CLI_EVALS
                                      for k, n in DP_PER_STEP.items()})
    if rank0["launches"] != want or (rank0["backend"], rank0["dp"]) != ("nccl", 1):
        raise AssertionError(f"torchrun cli.train: launches {rank0['launches']} (expected "
                             f"{want}), backend {rank0['backend']}, dp {rank0['dp']}")
    cfg, data = dp_cfg_and_data("dp")
    one = Trainer(cfg, data)
    summary = one.train()
    one_ms = replay_ms(one, device)
    del one
    torch.cuda.empty_cache()
    one_dir = pathlib.Path(cfg.ckpt_dir)
    files = ["best_model_MISA_synthetic.msgpack", "last_dp.inc.msgpack", "last_dp.inc.json"]
    differ = [f for f in files if (one_dir / f).read_bytes() != (dp_dir / f).read_bytes()]
    history = [{k: v for k, v in h.items() if not k.endswith("_s")} for h in summary["history"]]
    got_history = [{k: h[k] for k in history[0]} for h in rank0["summary"]["history"]]
    same = (json.dumps(got_history, sort_keys=True, default=float)
            == json.dumps(history, sort_keys=True, default=float))
    if differ or not same or rank0["summary"]["test_loss"] != summary["test_loss"]:
        raise AssertionError(f"the nccl rank's run is not the one-process Trainer's: files "
                             f"{differ}, history {got_history} against {history}")
    nccl = {"backend": "nccl", "world": rank0["world"], "launches": rank0["launches"],
            "steps": DP_CLI_STEPS, "eval_batches": DP_CLI_EVALS, "bit_equal_files": files,
            "train_loss": history[0]["train_loss"], "train_wall_s": rank0["train_wall_s"],
            "captured_ms": rank0["captured_ms"], "one_process_captured_ms": one_ms}
    log("17 dp-nccl-one-rank", **nccl)

    # (b) two ranks on the one card: nccl refuses them, gloo runs them
    store = work / f"store_nccl_{time.monotonic_ns()}"
    for r in range(2):
        pathlib.Path(work, f"nccl{r}.txt").unlink(missing_ok=True)
    ended = spawn_ranks(dp_nccl_rank, 2, str(store), str(work), must_finish=False)
    refused = [pathlib.Path(work, f"nccl{r}.txt").read_text()
               if pathlib.Path(work, f"nccl{r}.txt").exists()
               else f"no answer in {DP_TIMEOUT_S} s (killed)" for r in range(2)]
    if any(text.startswith("all_reduce gave") for text in refused):
        raise AssertionError(f"nccl ran two ranks on one card: {refused}")
    cfg, _ = dp_cfg_and_data("dp_gloo")
    whole_t = dp_gloo_trainer(device)
    whole, whole_ms = dp_eager_steps(whole_t, device, lambda h: train_step(
        whole_t.model, whole_t.optimizer, to_device(h, device), whole_t.cfg,
        whole_t.generator, whole_t.ema))
    whole_p = {n: p.detach().cpu() for n, p in whole_t.model.named_parameters()
               if p.requires_grad}
    del whole_t
    split_t = dp_gloo_trainer(device)
    split, _ = dp_eager_steps(split_t, device, lambda h: split_step(split_t, h, device, counts))
    split_err = max((p.detach().cpu() - whole_p[n]).abs().max().item()
                    for n, p in split_t.model.named_parameters() if p.requires_grad)
    del split_t
    ref = work / "whole_params.pt"
    torch.save(whole_p, ref)
    del whole_p
    torch.cuda.empty_cache()
    counts.reset_launch_count()             # the ranks count their own launches
    spawn_ranks(dp_gloo_rank, 2, str(work / f"store_gloo_{time.monotonic_ns()}"), str(ref),
                str(work))
    ranks = [torch.load(work / f"gloo{r}.pt") for r in range(2)]
    per_rank = expected_launches(counts, {k: n * DP_STEPS for k, n in DP_PER_STEP.items()})
    loss_err = {k: max(abs(r["losses"][i][k] - whole[i][k]) for r in ranks
                       for i in range(DP_STEPS)) for k in whole[0]}
    split_loss_err = {k: max(abs(split[i][k] - whole[i][k]) for i in range(DP_STEPS))
                      for k in whole[0]}
    # the tolerance: twice what splitting the batch in two on one process, through the
    # plain versions, moves the step, or DP_LOSS_FLOOR (relative) and DP_PARAM_FLOOR where
    # that is less; the kernels at a rank's shapes are held to their plain versions in phase 3
    loss_tol = {k: max(2 * split_loss_err[k], DP_LOSS_FLOOR * max(1.0, abs(whole[0][k])))
                for k in whole[0]}
    param_tol = max(2 * split_err, DP_PARAM_FLOOR)
    bad = [k for k in whole[0] if loss_err[k] > loss_tol[k]]
    param_err = max(r["param_err"] for r in ranks)
    if (bad or param_err > param_tol or any(r["launches"] != per_rank for r in ranks)
            or any((r["backend"], r["dp"], r["sharded"]) != ("gloo", 2, True) for r in ranks)
            or ranks[0]["losses"] != ranks[1]["losses"]):
        raise AssertionError(f"two gloo ranks against the one-process step: losses {bad} "
                             f"({loss_err} against {loss_tol}), parameters "
                             f"{param_err} against {param_tol}, launches "
                             f"{[r['launches'] for r in ranks]}")
    gloo = {"backend": "gloo", "ranks": 2, "steps": DP_STEPS, "dtype": "float32",
            "nccl_two_ranks_one_card": [text[:300] for text in refused],
            "nccl_ranks_ended": ended,
            "launches_per_rank": ranks[0]["launches"], "loss_err": loss_err,
            "plain_split_loss_err": split_loss_err, "loss_tol": loss_tol,
            "param_err": param_err, "plain_split_param_err": split_err, "param_tol": param_tol,
            "step_ms": [statistics.median(r["ms"]) for r in ranks],
            "one_process_step_ms": statistics.median(whole_ms)}
    log("17 dp-gloo-two-ranks", **gloo)
    launches = {name: rank0["launches"][name] + sum(r["launches"][name] for r in ranks)
                for name in counts.KERNELS}
    return {"nccl": nccl, "gloo": gloo, "launches": launches,
            "seconds": time.perf_counter() - t0}


# ------------------------------------------------------------------- main


def first_calls(kattn, kshort, device) -> int:
    """Each attention kernel once, as the first kernel calls of a fresh
    process: the f32 flash path through autograd (its first launches equal
    to its second, bit for bit) against the same on the CPU (1e-5 + 1e-4
    |ref|; the case that once disagreed on a first call), the bf16 flash
    kernels and both instantiations of the short kernels of both routes (S =
    50 and 200) against their plain versions on the card.  One line, which also gives how far the
    process's first CPU `torch.exp` lay from its second on the same input
    (taken first, so the reference after it runs with exp warm), how far the
    CPU's first call of the reference lay from its steady result, and the
    CPU capability torch dispatches to; raises where a value disagrees."""
    out = {"cpu_capability": torch.backends.cpu.get_cpu_capability()}
    x = torch.from_numpy(-np.abs(np.random.default_rng(0).normal(size=(3, 70, 70)))
                         .astype(np.float32))   # like scores less their row max
    exp_first = torch.exp(x)
    out["cpu_first_exp_vs_second"] = (exp_first - torch.exp(x)).abs().max().item()
    cpu = attn_inputs(3, 70, 16, torch.float32, 1, "cpu")

    def run(dev):
        q, k, v, bias, g = (t.to(dev) for t in cpu)
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        s = torch.tensor([9], dtype=torch.int32, device=dev)
        o = kattn.flash_attention(*leaves, bias, s, 0.2)
        return [t.detach().cpu() for t in (o, *torch.autograd.grad(o, leaves, g))]

    first, second = run(device), run(device)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("the f32 flash path's first launches differ from its second")
    cpu_first = run("cpu")          # the process's first CPU computation of it
    cpu = steady_on_cpu(lambda: run("cpu"))
    out["cpu_first_call_vs_steady"] = max((a - b).abs().max().item()
                                          for a, b in zip(cpu_first, cpu))
    out["flash_f32_card_vs_cpu"] = max_err(zip(("o", "dq", "dk", "dv"), first, cpu),
                                           ATTN_F32_TOL, "first call, f32")
    seed = torch.tensor([5], dtype=torch.int32, device=device)
    q, k, v, bias, g = attn_inputs(4, 130, 64, torch.bfloat16, 2, device)
    o, lse = kattn.flash_attention_fwd(q, k, v, bias, seed, ATTN_RATE)
    o_w, lse_w = kattn.flash_attention_fwd_reference(q, k, v, bias, seed, ATTN_RATE)
    args = (q, k, v, bias, seed, g, lse_w, kattn.row_dsum(g, o_w), ATTN_RATE)
    dq, (dk, dv) = kattn.flash_attention_bwd_dq(*args), kattn.flash_attention_bwd_dkv(*args)
    want = (kattn.flash_attention_bwd_dq_reference(*args),
            *kattn.flash_attention_bwd_dkv_reference(*args))
    out["flash_bf16"] = max(
        max_err([("o", o, o_w), ("lse", lse, lse_w)], (ATTN_BF16_TOL[0], 0.0), "first call"),
        max_err(zip(("dq", "dk", "dv"), (dq, dk, dv), want), ATTN_BF16_TOL, "first call"))
    for (dtype, tol), S in itertools.product(
            ((torch.float32, SHORT_F32_TOL), (torch.bfloat16, SHORT_BF16_TOL)), (50, 200)):
        q, k, v, g, bias = short_inputs(4, 12, S, 64, dtype, 3, device)
        o = kshort.short_attention_fwd(q, k, v, bias, seed, ATTN_RATE)
        out[f"short_fwd_{str(dtype)[6:]}_S{S}"] = max_err(
            [("o", o, kshort.short_attention_fwd_reference(q, k, v, bias, seed, ATTN_RATE))],
            tol, "first call")
        grads = kshort.short_attention_bwd(q, k, v, bias, seed, g, ATTN_RATE)
        want = kshort.short_attention_bwd_reference(q, k, v, bias, seed, g, ATTN_RATE)
        out[f"short_bwd_{str(dtype)[6:]}_S{S}"] = max_err(
            zip(("dq", "dk", "dv"), grads, want), tol, "first call")
    torch.cuda.synchronize()
    log("first-calls", max_abs_err=out)
    return 0


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--dp-cli"] and len(args) > 1:     # phase 17 (a)'s torchrun rank
        return dp_cli_rank(args[1], args[2:])
    if args not in ([], ["--first-calls"], ["--phase15"], ["--phase16"], ["--phase17"],
                    ["--fused-long-f32"], ["--fused-f32"]):
        print(f"chip_smoke: unknown arguments {args}; see the module docstring",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "mmda_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no mmda_tpu_torch/csrc beside {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mmda_tpu_torch.config import Config, set_reference_numerics
    from mmda_tpu_torch.models import init_misa
    from mmda_tpu_torch.ops.kernels import _build
    from mmda_tpu_torch.ops.kernels import _launch as counts
    from mmda_tpu_torch.ops.kernels import attention as kattn
    from mmda_tpu_torch.ops.kernels import gru as kgru
    from mmda_tpu_torch.ops.kernels import hash_dropout as hashes
    from mmda_tpu_torch.ops.kernels import layernorm as kln
    from mmda_tpu_torch.ops.kernels import lstm as klstm
    from mmda_tpu_torch.ops.kernels import lstm_multi as kmulti
    from mmda_tpu_torch.ops.kernels import short_attention as kshort
    from mmda_tpu_torch.serving import Predictor

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    set_reference_numerics()
    smi = nvidia_smi_line()
    cap = torch.cuda.get_device_capability(device)
    log("1 environment", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, capability=cap, python=sys.version.split()[0])
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}; the kernels are built for sm_90a")

    t0 = time.perf_counter()
    _build.build_all(counts.KERNELS)
    build_s = time.perf_counter() - t0
    log("2 build", sources=list(counts.KERNELS), seconds=build_s)
    if "--first-calls" in args:
        return first_calls(kattn, kshort, device)
    if "--phase15" in args:                 # phase 15 alone, after the build
        p15 = phase15(counts, device)
        log("15 seconds", seconds=p15["seconds"])
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_phase15.log").write_text("\n".join(LOG_LINES) + "\n")
        return 0
    if "--phase16" in args:                 # phase 16 alone, after the build
        p16 = phase16(counts, klstm, device)
        log("16 seconds", seconds=p16["seconds"])
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_phase16.log").write_text("\n".join(LOG_LINES) + "\n")
        return 0
    if "--fused-long-f32" in args or "--fused-f32" in args:   # phase 11's f32 step alone
        kind = "fused_f32" if "--fused-f32" in args else "fused_long_f32"
        out = f32_path(counts, kshort, device, kind, designs=(0, 1, 1, 0))
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / f"chip_smoke_{kind}.log").write_text(
            "\n".join(LOG_LINES) + "\n")
        return 0
    if "--phase17" in args:                 # phase 17 alone, after the build
        p17 = phase17(counts, device)
        log("17 seconds", seconds=p17["seconds"])
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_phase17.log").write_text("\n".join(LOG_LINES) + "\n")
        return 0

    checks = {"lstm_fwd": check_lstm_kernel(klstm, device),
              "lstm_bwd": check_lstm_bwd_kernel(klstm, device)}
    checks["gru_fwd"], checks["gru_bwd"] = check_gru_kernels(kgru, device)
    checks["ln_dropout_fwd"], checks["ln_dropout_bwd"] = check_ln_kernels(
        kln, hashes.keep_mask, device)
    checks.update(check_attn_kernels(kattn, hashes, device))
    checks.update(check_short_kernels(kshort, hashes, device))
    checks["lstm_multi_fwd"], checks["lstm_multi_bwd"] = check_multi_kernels(kmulti, klstm,
                                                                             device)

    cfg = Config()                       # the serving default, on cuda
    t0 = time.perf_counter()
    model = init_misa(cfg, seed=0, device=device)
    pred = Predictor(cfg, params=model, max_batch=64)
    log("4 model", seconds=time.perf_counter() - t0,
        parameters=sum(p.numel() for p in model.parameters()),
        bert=[model.bert_cfg.num_layers, model.bert_cfg.hidden_size],
        towers=[cfg.visual_size, cfg.acoustic_size], hidden=cfg.hidden_size,
        compute_dtype=cfg.compute_dtype)
    torch.cuda.reset_peak_memory_stats(device)
    requests = make_requests(spread_lengths(48, cfg.bucket_sizes, 0), cfg, 0)
    main_path = serve_over_http(cfg, pred, requests, counts)
    main_path["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    log("4 serve-http", **main_path)
    latency = bucket_latency(cfg, pred, device)
    for row in latency:
        log("4 latency", **row)
    profile = profile_serving(cfg, pred, device)
    log("4 profile", **profile)
    captured_serve = {"dense": {
        **serve_captured_vs_eager(cfg, pred, klstm.lstm_recurrence, device),
        "profile_eager": profile_serving(cfg, pred, device, klstm.lstm_recurrence)}}
    log("11 captured-serve", kind="dense", **captured_serve["dense"])
    serve_err = kernel_vs_plain_recurrence(cfg, pred, klstm.lstm_recurrence_reference)
    log("4 kernel-vs-plain-serving", max_abs_err=serve_err, tol=SERVE_TOL)
    device_err = card_vs_cpu(device)
    log("4 card-vs-cpu", max_abs_err=device_err, tol=DEVICE_TOL)
    del model, pred

    lstm_trainer, train = train_phases(5, "lstm", klstm.lstm_recurrence_reference, counts, device)
    del lstm_trainer
    torch.cuda.empty_cache()
    # the cli.train runs of phases 6, 7, 9 and 16, at once
    cli_runs = train_then_serve_all(device, counts)
    train_serve = cli_runs["6 train-then-serve"]

    gru_trainer, gru_train = train_phases(7, "gru", kgru.gru_recurrence_reference, counts,
                                          device, rnncell="gru")
    gru_cfg = gru_trainer.cfg
    del gru_trainer
    torch.cuda.empty_cache()
    # serve the checkpoint that run wrote (the flagship widths, GRU towers)
    gru_pred = Predictor(gru_cfg, max_batch=64)
    gru_requests = make_requests(spread_lengths(48, gru_cfg.bucket_sizes, 1), gru_cfg, 1)
    gru_serve = serve_over_http(gru_cfg, gru_pred, gru_requests, counts, "gru_fwd")
    gru_serve["kernel_vs_plain_err"] = kernel_vs_plain_recurrence(
        gru_cfg, gru_pred, kgru.gru_recurrence_reference)
    gru_serve["latency"] = bucket_latency(gru_cfg, gru_pred, device)
    log("7 gru-serve-http", **gru_serve, tol=SERVE_TOL)
    del gru_pred
    torch.cuda.empty_cache()
    gru_train_serve = cli_runs["7 gru-train-then-serve"]

    # phase 8: the long-sequence configuration, train -> timed steps with the
    # attention kernels and with the dense core -> serve -> score
    long_trainer, long_train = train_phases(8, "long", klstm.lstm_recurrence_reference,
                                            counts, device, attn_impl="flash")
    long_cfg = long_trainer.cfg
    long_trainer.model.cfg = long_cfg.replace(attn_impl="xla")
    try:
        dense = train_timing(long_trainer, counts, "long", device, without=FLASH)
        dense_prof = profile_training(long_trainer, "long", device)
    finally:
        long_trainer.model.cfg = long_cfg
    if isinstance(dense_prof["device_busy_ms_per_call"], float):
        dense_prof["idle_share_of_unprofiled_step"] = (
            1.0 - dense_prof["device_busy_ms_per_call"] / dense["ms_per_step"])
    long_train["steps_dense"], long_train["profile_dense"] = dense, dense_prof
    log("8 train-steps-dense-core", **dense)
    log("8 train-profile-dense-core", **dense_prof)
    del long_trainer
    torch.cuda.empty_cache()
    long_serve = serve_long(long_cfg, counts, device)
    log("8 flash-serve-http", **{k: v for k, v in long_serve.items() if k != "captured"},
        tol=FLASH_SERVE_TOL)
    captured_serve["flash"] = long_serve["captured"]
    log("11 captured-serve", kind="flash", **captured_serve["flash"])
    torch.cuda.empty_cache()
    long_infer = infer_long(long_cfg, counts)
    log("8 flash-infer", **long_infer)

    # phase 9: attn_impl="fused" at the flagship shape, train -> timed steps
    # (beside phase 5's dense-core steps) -> serve over HTTP -> cli.train
    fused_trainer, fused_train = train_phases(9, "fused", klstm.lstm_recurrence_reference,
                                              counts, device, attn_impl="fused")
    fused_train["steps_dense_core_phase5"] = train["steps"]
    fused_cfg = fused_trainer.cfg
    op_ab = op_dispatch_ab(fused_trainer, (klstm, kgru, kshort, kattn), device)
    log("15 op-dispatch", **op_ab)
    del fused_trainer
    torch.cuda.empty_cache()
    fused_serve = serve_fused(fused_cfg, counts, device)
    log("9 fused-serve-http", **{k: v for k, v in fused_serve.items() if k != "captured"},
        tol=FLASH_SERVE_TOL)
    captured_serve["fused"] = fused_serve["captured"]
    log("11 captured-serve", kind="fused", **captured_serve["fused"])
    torch.cuda.empty_cache()
    fused_train_serve = cli_runs["9 fused-train-then-serve"]
    # phase 11's f32 flagship step: the f32 block kernels, then a captured f32 Predictor
    fused_f32 = f32_path(counts, kshort, device, "fused_f32")
    torch.cuda.empty_cache()

    # phase 10: the tower pair with its four directions in one launch per layer
    pair = tower_pair(counts, device)

    # phase 12: the rest of the one-card Trainer and the data path
    torch.cuda.empty_cache()
    stage2 = stage_two(counts, device, train)
    log("12 stage2", **{k: v for k, v in stage2.items() if k != "stage2_top_ms_per_step"})
    torch.cuda.empty_cache()
    accum = accumulation(counts, device)
    accum["card_vs_cpu_err"] = accumulation_card_vs_cpu(device)
    log("12 grad-accum", **accum, tol=DEVICE_TOL)
    torch.cuda.empty_cache()
    resume = snapshot_and_resume(counts, device)
    log("12 snapshot-resume", **resume)
    torch.cuda.empty_cache()
    etl = etl_then_train(counts, device)
    log("12 etl-train", **etl)
    phase12 = {"stage2": stage2, "grad_accum": accum, "resume": resume, "etl": etl}

    # phase 13: HF BERT, int8 serving, the zoo's first four families, the native library
    torch.cuda.empty_cache()
    p13 = phase13(counts, klstm, device)
    log("13 seconds", seconds=p13["seconds"])

    # phase 14: MULT, MAG_BERT and MMIM; the best-on-dev export on its thread
    torch.cuda.empty_cache()
    p14 = phase14(counts, device)
    log("14 seconds", seconds=p14["seconds"])

    # phase 15: serving artifacts (the kernels as ops) and MoE BERT
    torch.cuda.empty_cache()
    p15 = phase15(counts, device)
    p15["op_dispatch"] = op_ab
    log("15 seconds", seconds=p15["seconds"])

    # phase 16: attn_impl="fused" at the long shape (the tiled short-attention kernels)
    torch.cuda.empty_cache()
    p16 = phase16(counts, klstm, device, cli_runs["16 fused-cli-train-then-serve"])
    log("16 seconds", seconds=p16["seconds"])

    # phase 17: data parallelism (one nccl rank under torchrun; two gloo ranks)
    torch.cuda.empty_cache()
    p17 = phase17(counts, device)
    log("17 seconds", seconds=p17["seconds"])

    # launches: the main paths' runs (HTTP serving windows, Trainer.train(),
    # cli.infer, the tower pair, phase 12's, 13's and 14's runs)
    trains = {"lstm": train, "gru": gru_train, "long": long_train, "fused": fused_train}
    launches = {name: sum(t["main_path"]["launches"][name]
                          + t["compiled_train"]["launches"][name] for t in trains.values())
                + long_serve["launches_by_kernel"][name] + long_infer["launches"][name]
                + fused_serve["launches_by_kernel"][name] + pair["launches"][name]
                + stage2["launches"][name] + stage2["serve_launches"][name]
                + accum["launches"][name] + resume["launches"][name] + etl["launches"][name]
                + p13["launches"][name] + p14["launches"][name] + p15["launches"][name]
                + p16["launches"][name] + p17["launches"][name]
                + fused_f32["main_path"]["launches"][name]
                + fused_f32["serve"]["launches_per_call"].get(name, 0)
                for name in counts.KERNELS}
    launches["lstm_fwd"] += main_path["launches"]
    launches["gru_fwd"] += gru_serve["launches"]
    replaces = {"lstm_fwd": "lstm.py:97", "lstm_bwd": "lstm.py:285", "gru_fwd": "gru.py:142",
                "gru_bwd": "gru.py:194", "ln_dropout_fwd": "layernorm.py:58",
                "ln_dropout_bwd": "layernorm.py:74", "flash_fwd": "attention.py:72",
                "flash_bwd_dq": "attention.py:136", "flash_bwd_dkv": "attention.py:172",
                "short_attn_fwd": "short_attention.py:61",
                "short_attn_bwd": "short_attention.py:82",
                "short_attn_tiled_fwd": "short_attention.py:61",
                "short_attn_tiled_bwd": "short_attention.py:82",
                "lstm_multi_fwd": "lstm_multi.py:48", "lstm_multi_bwd": "lstm_multi.py:74"}
    f32_replay = {kind: out[F32_PATHS[kind][1][0][0]][0]["launches_per_replay"]
                  for kind, out in (("fused_long_f32", p16["fused_long_f32"]),
                                    ("fused_f32", fused_f32))}
    f32_design = {"block": BLOCK_F32_DESIGNS[kshort._BLOCK_IMPL][0],
                  "tiled": TILED_DESIGNS[torch.float32][kshort._TILED_IMPL][0]}
    kernels = []
    for name in counts.KERNELS:
        rep = checks[name]["report"]
        shape = ([rep["T"], rep["B"], rep["H"]] if "T" in rep
                 else [rep["BH"], rep["S"], rep["D"], rep["dtype"]] if "BH" in rep
                 else [rep["B"], rep["nh"], rep["S"], rep["hd"], rep["dtype"]] if "nh" in rep
                 else [rep["N"], rep["H"], rep["dtype"]])
        kernels.append({
            "name": name, "route": "cuda", "source": f"mmda_tpu_torch/csrc/{name}.cu",
            "replaces": "mmda_tpu/ops/pallas/" + replaces[name], "launches": launches[name],
            "max_abs_err": checks[name]["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "ms_by": rep["ms_by"], "call_ms": rep["call_ms"],
            "library_device_ms": rep["library_device_ms"], "shape": shape,
            **({"max_abs_err_bf16": checks[name]["max_abs_err_bf16"]}
               if "max_abs_err_bf16" in checks[name] else {}),
            **({"sass_tensor_core_lines": checks[name]["sass"]["bf16_kernels"]}
               if "sass" in checks[name] else {}),
            **({"sass_tensor_core_lines_f32": checks[name]["sass"]["f32_kernels"],
                "f32_design": f32_design["tiled" if "tiled" in name else "block"]}
               if name.startswith("short_attn") else {}),
            **{k: rep[k] for k in ("cold_ms", "cold_parts_ms") if k in rep},
            **({"parts_ms": rep["parts_ms"]} if "parts_ms" in rep else {}),
            **{k: rep[k] for k in ("us_per_step", "bptt_us_per_step", "geometry") if k in rep},
            "launches_per_replay": {
                **{kind: t["captured"]["launches_per_replay"].get(name, 0)
                   for kind, t in {**trains, "fused_long": p16["train"]}.items()},
                **{kind: r.get(name, 0) for kind, r in f32_replay.items()}}})
        if launches[name] < 1:
            raise AssertionError(f"the main paths never launched {name}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s,
        "checks": checks, "main_path": main_path, "latency": latency,
        "profile": profile, "serve_err": serve_err, "device_err": device_err,
        "train": train, "train_then_serve": train_serve, "gru_train": gru_train,
        "gru_serve": gru_serve, "gru_train_then_serve": gru_train_serve,
        "long_train": long_train, "long_serve": long_serve, "long_infer": long_infer,
        "fused_train": fused_train, "fused_serve": fused_serve,
        "fused_train_then_serve": fused_train_serve, "fused_f32": fused_f32, "tower_pair": pair,
        "captured_serve": captured_serve, "phase12": phase12, "phase13": p13,
        "phase14": p14, "phase15": p15, "phase16": p16, "phase17": p17,
        "kernels": kernels},
        indent=1, default=str))
    (out_dir / "chip_smoke.log").write_text("\n".join(LOG_LINES) + "\n")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
