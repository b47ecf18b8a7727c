"""Serving artifacts: `torch.export` programs per bucket, and their loader.

Counterpart of `mmda_tpu/serving_export.py`.  `export_model` builds a live
`Predictor` on the device the artifact is for (so bf16 BERT storage, int8
and the checkpoint conversion apply as they do live), traces its
deterministic forward (`Predictor._forward`: scores, labels, tcp and the
hidden representation packed side by side) with `torch.export.export` once
per serving bucket at (max_batch, t), and saves each program with
`torch.export.save`; the weights are part of each program.  Every kernel on
the forward is one node of the program, a `torch.ops.mmda_tpu_torch.*` op
(`ops/kernels/`), so the artifact runs the hand-written kernels on CUDA and
their plain versions on the CPU, never a recurrence unrolled at trace time.

Layout of an export directory:
  manifest.json        the JAX package's keys (model, num_classes, task,
                       max_batch, bucket_sizes, visual_size, acoustic_size,
                       use_bert, weights_dtype, format, tokenizer) and the
                       port's: device, torch, output_widths, export_s
                       (seconds to trace and save each bucket)
  bucket_<t>.pt2       the program for the (max_batch, t) shape
  bert_vocab.json      the WordPiece vocab, when exported with a tokenizer
  word2id.json         the GloVe word ids, when given

An artifact serves on the device type it was exported for: the forward
takes branches on the device while it is traced (the int8 product's kernel,
bf16 storage), so `ExportedPredictor` refuses any other device instead of
running a program traced for another one.  The JAX package's StableHLO
artifact is exported on one backend and run on another.

`ExportedPredictor` keeps the live `Predictor`'s request contract
(`serving_requests.py`) and the surface `PredictionServer` and `cli.serve`
use (`max_batch`, `_bucket`, `stats`, a `cfg` shim).  It imports no model
code: only torch, the kernel ops (registered before a program is loaded),
the request module and, for an artifact that carries one, the tokenizer.
On CUDA a bucket's first call copies the padded batch into device buffers
kept for that bucket, runs the loaded program eagerly, then captures it in a
CUDA graph; later calls replay it.  Each call ends in one device-to-host
copy.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
import types
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mmda_tpu_torch.ops.kernels import _launch
from mmda_tpu_torch.ops.kernels import attention as _attention  # noqa: F401  (registers its op)
from mmda_tpu_torch.ops.kernels import gru as _gru  # noqa: F401
from mmda_tpu_torch.ops.kernels import lstm as _lstm  # noqa: F401
from mmda_tpu_torch.ops.kernels import short_attention as _short  # noqa: F401
from mmda_tpu_torch.serving_requests import (FIELDS, check_overflow, choose_bucket,
                                             pad_requests)

FORMAT = "torch.export/pt2"
OUTPUTS = ("scores", "labels", "tcp", "hidden")


class _Forward(torch.nn.Module):
    """A `Predictor`'s deterministic forward over the seven request fields
    (the label fields, which the forward does not read, as zeros)."""

    def __init__(self, pred):
        super().__init__()
        self.model = pred.model
        self._pred = pred
        self._num_classes = pred.cfg.num_classes

    def forward(self, text, visual, acoustic, lengths, bert_ids, bert_type, bert_mask):
        from mmda_tpu_torch.models import Batch

        B = text.shape[0]
        batch = Batch(text=text, visual=visual, acoustic=acoustic, lengths=lengths,
                      bert_ids=bert_ids, bert_type=bert_type, bert_mask=bert_mask,
                      sentiment=visual.new_zeros(B),
                      emo_label=visual.new_zeros(B, self._num_classes),
                      sample_weight=visual.new_ones(B))
        return self._pred._forward(batch)


def _example(max_batch: int, t: int, dv: int, da: int, device) -> tuple:
    """Zero inputs of the (max_batch, t) bucket in `FIELDS` order: a valid
    batch (every length 1, one unmasked BERT token)."""
    B = max_batch
    z = dict(device=device)
    return (torch.zeros(B, t, dtype=torch.int64, **z), torch.zeros(B, t, dv, **z),
            torch.zeros(B, t, da, **z), torch.ones(B, dtype=torch.int32, **z),
            torch.zeros(B, t + 2, dtype=torch.int64, **z),
            torch.zeros(B, t + 2, dtype=torch.int64, **z),
            torch.ones(B, t + 2, dtype=torch.int32, **z))


def export_model(cfg, params, out_dir: str, bert_cfg=None, visual_size: Optional[int] = None,
                 acoustic_size: Optional[int] = None, max_batch: int = 64,
                 bucket_sizes: Optional[Sequence[int]] = None, tokenizer=None,
                 word2id: Optional[Dict[str, int]] = None,
                 weights_dtype: Optional[str] = None, device: Optional[str] = None) -> Dict:
    """Save the deterministic forward for every serving bucket; returns the
    manifest (also written to out_dir/manifest.json).

    params: a port model (copied, not changed), a JAX parameter tree, or
    None for the best-on-dev export under cfg.ckpt_dir, as `Predictor`
    takes them.  weights_dtype: the BERT weights' storage in the artifact:
    "int8" (the encoder denses quantized from the loaded weights; a MoE
    layer's q, k, v and attn_out), a float dtype name ("bfloat16"), or None
    for the live `Predictor`'s default on `device` (bf16 on CUDA with a bf16
    compute dtype).  device: defaults to cfg.device; the artifact serves
    only on that device type.  tokenizer / word2id are baked in for
    raw-text requests, as the JAX package does."""
    from mmda_tpu_torch.serving import Predictor

    if isinstance(params, torch.nn.Module):
        params = copy.deepcopy(params)
    vocab_size = None
    if isinstance(params, dict) and "embed" in params:
        vocab_size = int(np.shape(params["embed"])[0])
    pred = Predictor(cfg, params=params, bert_cfg=bert_cfg, visual_size=visual_size,
                     acoustic_size=acoustic_size, vocab_size=vocab_size, max_batch=max_batch,
                     bert_weights_dtype=weights_dtype or "auto", device=device)
    pred.model.requires_grad_(False)
    dv = visual_size or cfg.visual_size
    da = acoustic_size or cfg.acoustic_size
    buckets = sorted(bucket_sizes or cfg.bucket_sizes)
    os.makedirs(out_dir, exist_ok=True)
    forward = _Forward(pred)
    seconds = {}
    with torch.no_grad():
        for t in buckets:
            t0 = time.perf_counter()
            program = torch.export.export(forward, _example(max_batch, t, dv, da, pred.device))
            torch.export.save(program, os.path.join(out_dir, f"bucket_{t}.pt2"))
            seconds[str(t)] = time.perf_counter() - t0
    widths = pred._widths()
    manifest = {
        "model": cfg.model, "num_classes": cfg.num_classes, "task": cfg.resolved_task(),
        "max_batch": max_batch, "bucket_sizes": list(buckets), "visual_size": dv,
        "acoustic_size": da, "use_bert": cfg.use_bert, "format": FORMAT,
        "weights_dtype": weights_dtype, "device": pred.device.type,
        "torch": torch.__version__, "output_widths": dict(zip(OUTPUTS, widths)),
        "export_s": seconds,
    }
    if tokenizer is not None:
        with open(os.path.join(out_dir, "bert_vocab.json"), "w") as f:
            json.dump(tokenizer.vocab, f)
        manifest["tokenizer"] = {"type": "wordpiece", "lowercase": tokenizer.lowercase}
    if word2id:
        with open(os.path.join(out_dir, "word2id.json"), "w") as f:
            json.dump(word2id, f)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class _BucketGraph:
    """One bucket's program on CUDA: device buffers for its inputs, an eager
    first run, then a CUDA graph replayed from then on (its launches
    recorded at capture and counted at every replay)."""

    def __init__(self, module, device: torch.device, pool):
        self.module = module
        self.device = device
        self.pool = pool
        self.inputs = None
        self.graph = None

    def __call__(self, arrays: Dict[str, np.ndarray]) -> torch.Tensor:
        host = [torch.from_numpy(arrays[k]) for k in FIELDS]
        if self.inputs is None:
            self.inputs = [h.to(self.device) for h in host]
            out = self.module(*self.inputs)
            graph = torch.cuda.CUDAGraph()
            with _launch.recording() as launches:
                with torch.cuda.graph(graph, pool=self.pool):
                    self.output = self.module(*self.inputs)
            self.graph, self.launches = graph, dict(launches)
            return out
        for buf, h in zip(self.inputs, host):
            buf.copy_(h)
        self.graph.replay()
        _launch.add_launches(self.launches)
        return self.output


class ExportedPredictor:
    """Serve an export directory with no model code: the live `Predictor`'s
    request contract (array and raw-text requests, `overflow`) and its
    server-facing surface (`max_batch`, `_bucket`, `stats`, a `cfg` shim),
    so `PredictionServer` and `python -m mmda_tpu_torch.cli.serve
    --export_dir` front it."""

    def __init__(self, export_dir: str, overflow: str = "error",
                 device: Optional[str] = None):
        from mmda_tpu_torch.config import resolve_device, set_reference_numerics

        self.overflow = check_overflow(overflow)
        with open(os.path.join(export_dir, "manifest.json")) as f:
            self.manifest = m = json.load(f)
        if m.get("format") != FORMAT:
            raise ValueError(f"{export_dir} holds a {m.get('format')!r} artifact, "
                             f"not {FORMAT!r}")
        exported_on = m["device"]
        want = torch.device(device or exported_on)
        if want.type != exported_on:
            raise ValueError(f"the artifact in {export_dir} was exported for {exported_on} "
                             f"and serves only there, not on {want.type}; export it "
                             f"again with device={want.type!r}")
        self.device = resolve_device(str(want))
        if self.device.type == "cuda":
            set_reference_numerics()        # the programs do not carry these flags
        self._programs = {
            t: torch.export.load(os.path.join(export_dir, f"bucket_{t}.pt2")).module()
            for t in m["bucket_sizes"]}
        self.max_batch = int(m["max_batch"])
        self.visual_size = int(m["visual_size"])
        self.acoustic_size = int(m["acoustic_size"])
        self.cfg = types.SimpleNamespace(         # what PredictionServer and cli.serve read
            bucket_sizes=tuple(m["bucket_sizes"]), visual_size=self.visual_size,
            acoustic_size=self.acoustic_size, model=m["model"])
        self._widths = [m["output_widths"][k] for k in OUTPUTS]
        self._graphs = None
        if self.device.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
            self._graphs = {t: _BucketGraph(p, self.device, pool)
                            for t, p in self._programs.items()}
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "utterances": 0, "seconds": 0.0}
        self.tokenizer = None
        self.word2id: Dict[str, int] = {}
        tk = m.get("tokenizer")
        vocab_path = os.path.join(export_dir, "bert_vocab.json")
        if tk and os.path.exists(vocab_path):
            from mmda_tpu_torch.data.etl.tokenizer import WordPieceTokenizer

            with open(vocab_path) as f:
                self.tokenizer = WordPieceTokenizer(json.load(f),
                                                    lowercase=tk.get("lowercase", True))
        w2_path = os.path.join(export_dir, "word2id.json")
        if os.path.exists(w2_path):
            with open(w2_path) as f:
                self.word2id = json.load(f)

    @property
    def stats(self) -> Dict[str, float]:
        s = dict(self._stats)
        if s["seconds"] > 0:
            s["utterances_per_sec"] = s["utterances"] / s["seconds"]
        return s

    def _bucket(self, n: int) -> int:
        return choose_bucket(n, self.manifest["bucket_sizes"])

    def __call__(self, requests: Sequence[Dict]) -> Dict[str, np.ndarray]:
        """The live `Predictor.__call__`'s contract: scores, labels, tcp and
        hidden, trimmed to len(requests)."""
        t0 = time.perf_counter()
        arrays, n = pad_requests(
            requests, bucket_sizes=self.manifest["bucket_sizes"], max_batch=self.max_batch,
            overflow=self.overflow, use_bert=self.manifest["use_bert"],
            tokenizer=self.tokenizer, word2id=self.word2id, visual_size=self.visual_size,
            acoustic_size=self.acoustic_size, who="ExportedPredictor")
        for k, dtype in (("visual", np.float32), ("acoustic", np.float32),
                         ("lengths", np.int32), ("bert_mask", np.int32)):
            arrays[k] = arrays[k].astype(dtype, copy=False)     # the programs' input types
        t = arrays["text"].shape[1]
        with torch.inference_mode():
            if self._graphs is None:
                packed = self._programs[t](*[torch.from_numpy(arrays[k]) for k in FIELDS])
                packed = packed.numpy()
            else:
                with self._lock:
                    packed = self._graphs[t](arrays).cpu().numpy()
        cols = np.cumsum([0] + self._widths)
        result = {k: packed[:n, cols[i]:cols[i + 1]] for i, k in enumerate(OUTPUTS)}
        self._stats["requests"] += 1
        self._stats["utterances"] += n
        self._stats["seconds"] += time.perf_counter() - t0
        return result
