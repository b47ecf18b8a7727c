#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmda_tpu_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero before
the result):

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; the card must be compute capability 9.0;
2. build: every CUDA kernel of the serving and training paths from
   `mmda_tpu_torch/csrc` (one nvcc per source, all started together);
3. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes and beyond (f32, |err| <= 1e-5 + 1e-5 |ref|: summation order
   only): the LSTM forward recurrence and its BPTT backward, with CUDA-event
   times of each kernel, its plain version and one cuDNN `nn.LSTM` call (its
   forward, or its backward) on the same inputs, beside the kernel's bound;
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
   `Predictor` loaded from it answers a few requests with finite scores;
7. a `kernels` JSON line, the card's name and power limit, and as the last
   line `{"ok": true, "device": {...}}`.

Imports nothing of JAX or the JAX package.  Full results also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import concurrent.futures
import copy
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
# the GloVe tower's H=300 (w_hh_t in global memory), and long T, where the
# TPU package used its time-chunked streaming kernel
CHECK_SHAPES = [(16, 64, 35), (32, 64, 35), (48, 64, 35), (64, 64, 35),
                (16, 64, 74), (32, 64, 74), (48, 64, 74), (64, 64, 74),
                (48, 64, 300), (256, 32, 74), (512, 32, 74), (7, 5, 33)]
TIMED_SHAPES = [(48, 64, 35), (64, 64, 35), (16, 64, 74), (48, 64, 74), (64, 64, 74),
                (256, 32, 74), (512, 32, 74)]
REPORT_SHAPE = (64, 64, 74)       # the kernels line: largest bucket, wider tower
REPORT_BWD_SHAPE = (48, 64, 74)   # the training step's wider tower
LAUNCHES_PER_CALL = 8             # 2 towers x 2 layers x 2 directions
TRAIN_B, TRAIN_T, TRAIN_STEPS = 64, 48, 20
TRAIN_TOL = 1e-3                  # kernel vs plain recurrence, step gradients
BUILD = ROOT / "build"            # git-ignored: checkpoints of phases 5 and 6


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


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


def cudnn_like(w_hh_t):
    """A cuDNN nn.LSTM computing the kernels' function: identity input
    weights, zero biases (x_proj already holds them), the same w_hh."""
    H, G = w_hh_t.shape
    lstm = torch.nn.LSTM(G, H).to(w_hh_t.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(G, device=w_hh_t.device))
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
        lstm.weight_hh_l0.copy_(w_hh_t.t())
    return lstm


def cudnn_lstm(x_proj, w_hh_t, lengths):
    """One cuDNN nn.LSTM call on a packed sequence computing the same
    forward function.  Returns (call, h_fin)."""
    lstm = cudnn_like(w_hh_t)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x_proj, torch.as_tensor(lengths), enforce_sorted=False)

    def call():
        with torch.no_grad():
            return lstm(packed)

    _, (h, _) = call()
    return call, h[0]


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
            err = 0.0
            for g, r in zip(list(got) + [serving[0], serving[2], serving[3]],
                            list(want) + [want[0], want[2], want[3]]):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"non-finite kernel output at {(T, B, H)}")
                excess = ((g - r).abs() - KERNEL_TOL * (1 + r.abs())).max().item()
                if excess > 0:
                    raise AssertionError(f"kernel disagrees with plain version at "
                                         f"(T,B,H)={(T, B, H)} reverse={reverse}")
                err = max(err, (g - r).abs().max().item())
            worst = max(worst, err)
            rows.append({"T": T, "B": B, "H": H, "reverse": reverse, "max_abs_err": err})
    log("3 kernel-vs-plain", shapes=len(rows), max_abs_err=worst, tol=KERNEL_TOL)

    timed = []
    for T, B, H in TIMED_SHAPES:
        x, w, m, lengths = lstm_inputs(T, B, H, seed=T * 1000 + H, device=device)
        call, h_lib = cudnn_lstm(x, w, lengths)
        h_k = klstm.lstm_recurrence(x, w, m)[2]
        row = {"T": T, "B": B, "H": H,
               "ms": cuda_ms(lambda: klstm.lstm_recurrence(x, w, m)),
               "plain_ms": cuda_ms(lambda: klstm.lstm_recurrence_reference(x, w, m), reps=5),
               "library_ms": cuda_ms(call),
               "library_max_abs_err": (h_lib - h_k).abs().max().item(),
               **lstm_bound(T, B, H, m)}
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


def cudnn_lstm_bwd(x_proj, w_hh_t, lengths, dys, dh):
    """The backward of one cuDNN nn.LSTM call on a packed sequence computing
    the same forward: autograd.grad of its outputs w.r.t. its input and
    w_hh, the forward run once outside the timed call.  Returns (call,
    dw_hh_t)."""
    lstm = cudnn_like(w_hh_t)
    x = x_proj.clone().requires_grad_(True)
    lens = torch.as_tensor(lengths)
    out, (h, _) = lstm(torch.nn.utils.rnn.pack_padded_sequence(x, lens, enforce_sorted=False))
    d_out = torch.nn.utils.rnn.pack_padded_sequence(dys, lens, enforce_sorted=False).data

    def call():
        return torch.autograd.grad([out.data, h], [x, lstm.weight_hh_l0],
                                   [d_out, dh[None]], retain_graph=True)

    return call, call()[1].t()


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
            err = 0.0
            for name, g, r in zip(("dx_proj", "dw_hh_t"), got, want):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"non-finite {name} at {(T, B, H)}")
                excess = ((g - r).abs() - KERNEL_TOL * (1 + r.abs())).max().item()
                if excess > 0:
                    raise AssertionError(f"backward kernel {name} disagrees with the plain "
                                         f"version at (T,B,H)={(T, B, H)} reverse={reverse}")
                err = max(err, (g - r).abs().max().item())
            worst = max(worst, err)
            rows.append({"T": T, "B": B, "H": H, "reverse": reverse, "max_abs_err": err})
    log("3 bwd-kernel-vs-plain", shapes=len(rows), max_abs_err=worst, tol=KERNEL_TOL)

    timed = []
    for T, B, H in TIMED_SHAPES:
        x, w, m, lengths, ys, cs, dys, dh = lstm_bwd_inputs(T, B, H, T * 1000 + H + 7,
                                                            device, klstm)
        dys = (dys * m[..., None]).contiguous()   # a packed sequence has no padded outputs
        call, dw_lib = cudnn_lstm_bwd(x, w, lengths, dys, dh)
        dw_k = klstm.lstm_recurrence_bwd(x, w, m, ys, cs, dys, dh)[1]
        row = {"T": T, "B": B, "H": H,
               "ms": cuda_ms(lambda: klstm.lstm_recurrence_bwd(x, w, m, ys, cs, dys, dh)),
               "plain_ms": cuda_ms(lambda: klstm.lstm_recurrence_bwd_reference(
                   x, w, m, ys, cs, dys, dh), reps=3, warmup=1),
               "library_ms": cuda_ms(call),
               "library_dw_max_abs_err": (dw_lib - dw_k).abs().max().item(),
               **lstm_bwd_bound(T, B, H, m)}
        timed.append(row)
        log("3 bwd-kernel-time", **row)
    report = next(r for r in timed if (r["T"], r["B"], r["H"]) == REPORT_BWD_SHAPE)
    return {"checks": rows, "timed": timed, "max_abs_err": worst, "report": report}


# ---------------------------------------------------------------- serving


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


def serve_over_http(cfg, pred, requests, klstm) -> dict:
    """The main path: requests from concurrent clients through the HTTP front
    end, the micro-batching server and the Predictor; the LSTM launch count
    read around exactly this window."""
    from mmda_tpu_torch.cli.serve import serve

    httpd, psrv = serve(cfg, port=0, predictor=pred, timeout_s=300)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    try:
        calls0 = pred.stats["requests"]
        klstm.reset_launch_count()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            replies = list(ex.map(lambda r: post(url, r), requests))
        wall = time.perf_counter() - t0
        launches = klstm.launch_count()
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
    if calls < 1 or launches != LAUNCHES_PER_CALL * calls:
        raise AssertionError(f"{launches} LSTM kernel launches for {calls} Predictor "
                             f"calls; expected {LAUNCHES_PER_CALL} per call")
    return {"requests": len(requests), "predictor_calls": calls, "launches": launches,
            "wall_s": wall, "requests_per_s": len(requests) / wall, "healthz": health["ok"]}


def bucket_latency(cfg, pred, device) -> list:
    """Host wall time of Predictor calls (ending in the device-to-host copy)
    for a full batch of max_batch rows and for one request, per bucket, every
    request as long as the bucket."""
    rows = []
    for b in sorted(cfg.bucket_sizes):
        reqs = make_requests([b] * pred.max_batch, cfg, seed=b)
        for n in (pred.max_batch, 1):
            pred(reqs[:n])
            times = []
            for _ in range(10):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                pred(reqs[:n])
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
            rows.append({"bucket": b, "batch": n, "ms": ms,
                         "utterances_per_s": n / ms * 1e3})
    return rows


def profile_serving(cfg, pred, device) -> dict:
    """Where a Predictor call's time goes (torch.profiler, 5 calls at the
    largest bucket, full batch): device busy time per call, the share of the
    wall time the card sits idle, and the kernels that take the most."""
    reqs = make_requests([max(cfg.bucket_sizes)] * pred.max_batch, cfg, seed=7)
    pred(reqs)
    calls = 5

    def run():
        for _ in range(calls):
            pred(reqs)

    return {"bucket": max(cfg.bucket_sizes), "batch": pred.max_batch,
            **device_profile(run, calls, device)}


def kernel_vs_plain_recurrence(cfg, pred, klstm) -> float:
    """The same batch through the same weights with the recurrence forced to
    the plain version by the `recurrence` argument."""
    reqs = make_requests(spread_lengths(40, cfg.bucket_sizes, 123), cfg, seed=123)
    got = pred(reqs)
    want = pred(reqs, recurrence=klstm.lstm_recurrence_reference)
    check_outputs(got["scores"], got["labels"], got["tcp"], 40, cfg.num_classes,
                  cfg.threshold)
    if got["hidden"].shape != (40, 6 * cfg.hidden_size):
        raise AssertionError(f"hidden shape {got['hidden'].shape}")
    err = max(float(np.abs(got[k] - want[k]).max()) for k in ("scores", "tcp", "hidden"))
    if err > SERVE_TOL:
        raise AssertionError(f"kernel vs plain recurrence: {err} > {SERVE_TOL}")
    return err


def card_vs_cpu(device) -> float:
    """A small f32 model (tiny BERT, narrow towers) gives the same outputs
    on the card, through the kernels, as on the CPU through the plain
    versions."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.models import init_misa
    from mmda_tpu_torch.models.bert import BertConfig
    from mmda_tpu_torch.serving import Predictor

    cfg = Config(hidden_size=32, visual_size=35, acoustic_size=74,
                 compute_dtype="float32", bucket_sizes=(8, 16), device="cpu")
    model = init_misa(cfg, seed=1, bert_cfg=BertConfig.tiny(vocab_size=30522))
    preds = {d: Predictor(cfg, params=copy.deepcopy(model), bert_cfg=BertConfig.tiny(30522),
                          max_batch=8, device=d) for d in ("cpu", str(device))}
    reqs = make_requests(spread_lengths(6, cfg.bucket_sizes, 5), cfg, seed=5)
    out = {d: p(reqs) for d, p in preds.items()}
    err = max(float(np.abs(out["cpu"][k] - out[str(device)][k]).max())
              for k in ("scores", "tcp", "hidden"))
    if err > DEVICE_TOL:
        raise AssertionError(f"card vs CPU: {err} > {DEVICE_TOL}")
    return err


# --------------------------------------------------------------- training


def full_length_split(n, seed) -> dict:
    """n synthetic MOSEI-shaped rows, every one TRAIN_T words long (the
    steady-state shape: the whole bucket is used)."""
    from mmda_tpu_torch.data.synthetic import SyntheticSpec, make_split

    split = make_split(SyntheticSpec(num_examples=n, max_len=TRAIN_T, seed=seed))
    split["lengths"][:] = TRAIN_T
    split["bert_mask"][:] = 1
    return split


def finite_losses(losses: dict, where: str) -> None:
    bad = [k for k, v in losses.items() if not np.isfinite(float(torch.as_tensor(v).detach()))]
    if bad:
        raise AssertionError(f"{where}: non-finite losses {bad}")


def train_main_path(klstm) -> tuple:
    """The main path: `Trainer.train()` for one epoch of TRAIN_STEPS
    full-length batches on the flagship config, with dev eval, the
    best-on-dev export and test eval; the launch counts read around exactly
    this call.  Returns (trainer, result)."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.train.loop import Trainer
    from mmda_tpu_torch.utils.logging import MetricLogger

    cfg = Config(use_bert=True, data="mosei", batch_size=TRAIN_B, max_seq_len=TRAIN_T,
                 bucket_sizes=(TRAIN_T,), compute_dtype="bfloat16", attn_impl="xla",
                 n_epoch=1, seed=0, name="chip_smoke_train",
                 ckpt_dir=str(BUILD / "chip_smoke_train"))
    data = {"train": full_length_split(TRAIN_B * TRAIN_STEPS, 0),
            "dev": full_length_split(TRAIN_B, 1), "test": full_length_split(TRAIN_B, 2)}
    t0 = time.perf_counter()
    trainer = Trainer(cfg, data, logger=MetricLogger(("stdout",), run_name=cfg.name))
    build_s = time.perf_counter() - t0
    eval_batches = 2                                   # one dev, one test
    klstm.reset_launch_count()
    t0 = time.perf_counter()
    summary = trainer.train()
    wall = time.perf_counter() - t0
    launches = {name: klstm.launch_count(name) for name in klstm.SOURCES}
    want = {"lstm_fwd": LAUNCHES_PER_CALL * (TRAIN_STEPS + eval_batches),
            "lstm_bwd": LAUNCHES_PER_CALL * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"train(): LSTM kernel launches {launches}, expected {want}")
    epoch = summary["history"][0]
    finite_losses({k: v for k, v in epoch.items() if k.startswith("train_")}, "train()")
    counts = {"params_total": sum(p.numel() for p in trainer.model.parameters()),
              "params_trainable": sum(p.numel() for p in trainer.optimizer.params)}
    return trainer, {"build_s": build_s, "train_wall_s": wall, "launches": launches,
                     "steps": TRAIN_STEPS, "epoch_time_s": epoch["epoch_time_s"],
                     "train_loss": epoch["train_loss"], "test_loss": summary["test_loss"],
                     **counts}


def train_timing(trainer, klstm, device) -> dict:
    """Host wall time of TRAIN_STEPS more steps, each ending in a
    synchronize; launches per step; peak device memory."""
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.train.step import train_step

    cfg = trainer.cfg
    batches = list(ArrayLoader(trainer.data["train"], cfg.batch_size, shuffle=False,
                               bucket_sizes=cfg.bucket_sizes, device=device))
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    klstm.reset_launch_count()
    times = []
    for batch in batches:
        t0 = time.perf_counter()
        losses = train_step(trainer.model, trainer.optimizer, batch, cfg,
                            trainer.generator, trainer.ema)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
        finite_losses(losses, "train_step")
    per_step = {name: klstm.launch_count(name) / len(batches) for name in klstm.SOURCES}
    if per_step != {"lstm_fwd": LAUNCHES_PER_CALL, "lstm_bwd": LAUNCHES_PER_CALL}:
        raise AssertionError(f"launches per train step {per_step}, expected "
                             f"{LAUNCHES_PER_CALL} of each")
    ms = statistics.median(times)
    return {"steps": len(times), "ms_per_step": ms, "ms_min": min(times),
            "ms_max": max(times), "utterances_per_s": cfg.batch_size / ms * 1e3,
            "launches_per_step": per_step,
            "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "losses": {k: float(v) for k, v in losses.items()}}


def device_profile(run, wall_calls: int, device,
                   name_filter=("lstm_fwd", "lstm_bptt", "lstm_dw")):
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


def profile_training(trainer, device) -> dict:
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
    return device_profile(run, steps, device)


def grads_kernel_vs_plain(trainer, klstm, device) -> float:
    """One step's gradients on the flagship model, dropout off, with the
    kernels against the plain recurrence (autograd through its loop)."""
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.train.step import loss_and_grads

    cfg, model = trainer.cfg, trainer.model
    batch = next(iter(ArrayLoader(trainer.data["dev"], cfg.batch_size, shuffle=False,
                                  bucket_sizes=cfg.bucket_sizes, device=device)))
    model.eval()
    params = trainer.optimizer.params
    klstm.reset_launch_count()
    got_l, got = loss_and_grads(model, batch, cfg, params)
    if klstm.launch_count("lstm_bwd") != LAUNCHES_PER_CALL:
        raise AssertionError("the kernel-path gradient did not run the backward kernel")
    want_l, want = loss_and_grads(model, batch, cfg, params,
                                  recurrence=klstm.lstm_recurrence_reference)
    finite_losses(got_l, "kernel-path step")
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    if err > TRAIN_TOL:
        raise AssertionError(f"step gradients, kernel vs plain recurrence: {err} > {TRAIN_TOL}")
    return err


def train_card_vs_cpu(device) -> float:
    """A small f32 model (tiny BERT, hidden 32) and one batch with ragged
    lengths: the step's gradients (dropout off) on the card, through the
    kernels, against the CPU, through the plain versions."""
    from mmda_tpu_torch.config import Config
    from mmda_tpu_torch.data.loader import ArrayLoader
    from mmda_tpu_torch.data.synthetic import SyntheticSpec, make_split
    from mmda_tpu_torch.models import init_misa
    from mmda_tpu_torch.models.bert import BertConfig
    from mmda_tpu_torch.train.step import loss_and_grads

    cfg = Config(hidden_size=32, compute_dtype="float32", batch_size=8, max_seq_len=16,
                 device="cpu")
    split = make_split(SyntheticSpec(num_examples=8, max_len=16, seed=3))
    model = init_misa(cfg, seed=1, bert_cfg=BertConfig.tiny(vocab_size=30522)).eval()
    grads = {}
    for dev in ("cpu", device):
        m = copy.deepcopy(model).to(dev)
        batch = next(iter(ArrayLoader(split, 8, shuffle=False, bucket_sizes=(16,),
                                      device=dev)))
        _, g = loss_and_grads(m, batch, cfg, list(m.parameters()))
        grads[str(dev)] = [x.cpu() for x in g]
    err = max((a - b).abs().max().item() for a, b in zip(grads["cpu"], grads[str(device)]))
    if err > DEVICE_TOL:
        raise AssertionError(f"step gradients, card vs CPU: {err} > {DEVICE_TOL}")
    return err


def train_then_serve(device) -> dict:
    """`python -m mmda_tpu_torch.cli.train --data synthetic --n_epoch 1` at
    the default widths (on the card, its default), then a Predictor loaded
    from the checkpoint it wrote answers a few requests."""
    from mmda_tpu_torch.config import get_config
    from mmda_tpu_torch.serving import Predictor

    ckpt_dir = BUILD / "chip_smoke_cli"
    args = ["--data", "synthetic", "--ckpt_dir", str(ckpt_dir), "--name", "chip_smoke_cli"]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "mmda_tpu_torch.cli.train", *args,
                          "--n_epoch", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    train_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"cli.train exit {out.returncode}:\n{out.stdout[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    summary = json.loads((ckpt_dir / "summary_chip_smoke_cli.json").read_text())
    cfg = get_config(argv=args)
    pred = Predictor(cfg, visual_size=35, acoustic_size=74, max_batch=8, device=str(device))
    reqs = make_requests(spread_lengths(8, cfg.bucket_sizes, 9), cfg, seed=9)
    got = pred(reqs)
    check_outputs(got["scores"], got["labels"], got["tcp"], 8, cfg.num_classes,
                  cfg.threshold)
    return {"train_s": train_s, "best_epoch": summary["best_epoch"],
            "test_loss": summary["test_loss"], "requests": len(reqs),
            "score_mean": float(np.mean(got["scores"]))}


# ------------------------------------------------------------------- main


def main() -> int:
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
    from mmda_tpu_torch.ops.kernels import lstm as klstm
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
    _build.build_all(klstm.SOURCES)
    log("2 build", sources=list(klstm.SOURCES), seconds=time.perf_counter() - t0)

    lstm = check_lstm_kernel(klstm, device)
    lstm_bwd = check_lstm_bwd_kernel(klstm, device)

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
    main_path = serve_over_http(cfg, pred, requests, klstm)
    main_path["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    log("4 serve-http", **main_path)
    latency = bucket_latency(cfg, pred, device)
    for row in latency:
        log("4 latency", **row)
    profile = profile_serving(cfg, pred, device)
    log("4 profile", **profile)
    serve_err = kernel_vs_plain_recurrence(cfg, pred, klstm)
    log("4 kernel-vs-plain-serving", max_abs_err=serve_err, tol=SERVE_TOL)
    device_err = card_vs_cpu(device)
    log("4 card-vs-cpu", max_abs_err=device_err, tol=DEVICE_TOL)
    del model, pred

    trainer, train_path = train_main_path(klstm)
    log("5 train-main-path", **train_path)
    train_time = train_timing(trainer, klstm, device)
    log("5 train-steps", **train_time)
    train_profile = profile_training(trainer, device)
    busy = train_profile["device_busy_ms_per_call"]
    if isinstance(busy, float):         # the profiler slows the host, not the card
        train_profile["idle_share_of_unprofiled_step"] = 1.0 - busy / train_time["ms_per_step"]
    log("5 train-profile", **train_profile)
    train_err = grads_kernel_vs_plain(trainer, klstm, device)
    log("5 train-kernel-vs-plain", max_abs_err=train_err, tol=TRAIN_TOL)
    train_device_err = train_card_vs_cpu(device)
    log("5 train-card-vs-cpu", max_abs_err=train_device_err, tol=DEVICE_TOL)
    del trainer
    torch.cuda.empty_cache()

    train_serve = train_then_serve(device)
    log("6 train-then-serve", **train_serve)

    def kernel_row(name, check, launches, replaces):
        rep = check["report"]
        return {"name": name, "route": "cuda", "source": f"mmda_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": check["max_abs_err"], "ms": rep["ms"],
                "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
                "shape": [rep["T"], rep["B"], rep["H"]]}

    # launches: the serving main path's and the training main path's runs
    kernels = [
        kernel_row("lstm_fwd", lstm,
                   main_path["launches"] + train_path["launches"]["lstm_fwd"],
                   "mmda_tpu/ops/pallas/lstm.py:97"),
        kernel_row("lstm_bwd", lstm_bwd, train_path["launches"]["lstm_bwd"],
                   "mmda_tpu/ops/pallas/lstm.py:285"),
    ]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "lstm": lstm, "lstm_bwd": lstm_bwd, "main_path": main_path, "latency": latency,
        "profile": profile, "serve_err": serve_err, "device_err": device_err,
        "train_main_path": train_path, "train_steps": train_time,
        "train_profile": train_profile, "train_err": train_err,
        "train_device_err": train_device_err, "train_then_serve": train_serve,
        "kernels": kernels},
        indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
