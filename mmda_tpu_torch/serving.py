"""Batched serving on the card: the port's `Predictor`.

Counterpart of `mmda_tpu/serving.py` with the same request schema, bucket
padding and outputs:

  * requests are padded to the nearest bucket and to `max_batch` rows; pad
    rows get length 1 and one unmasked BERT token, and `sample_weight` marks
    the real rows;
  * returns scores, binarized labels, ConfidNet confidence and the fused
    hidden representation [private_t, private_v, private_a, shared_t,
    shared_v, shared_a] per utterance (the scores again for a family
    without that factorization), trimmed to the request count, with one
    device-to-host copy per call;
  * any registered family (`get_model(cfg.model)`).

The request contract itself (schema, raw text, bucket choice, padding) is
`serving_requests.py`, which the exported artifact's loader shares
(`serving_export.py`); `RequestTooLongError` and `validate_request` are
re-exported here.

With `compute_dtype="bfloat16"` on CUDA the BERT tower's weights of two or
more dimensions are stored in bf16 (the JAX package does so on the TPU):
every BERT product computes in bf16 anyway, so f32 storage would only double
the weight bytes read per call.  `bert_weights_dtype="int8"` quantizes the
six denses of every encoder layer from the loaded weights
(`models/bert.py::quantize_bert_int8`: int8 buffers, one f32 scale per
output channel) and, as in the JAX package, leaves every other BERT weight
as loaded.

`mesh` (`parallel/mesh.py`, tp = 1; the counterpart of the JAX Predictor's
mesh, `mmda_tpu/serving.py:142-151`, `:274-276`) serves data-parallel:
max_batch must divide by dp; every rank pads the same requests to the same
bucket batch, runs its rows [r max_batch / dp, (r + 1) max_batch / dp) and
all-gathers the packed outputs, so every rank returns the whole result.
Each call is a collective: every rank must make the same calls, with the
same requests, in the same order.  Tensor-parallel serving (tp > 1) is not
ported (ROADMAP Queue 1 item 2).

On CUDA a call runs as a CUDA graph, one per bucket shape (the counterpart
of the JAX package's jit per bucket): the padded batch (a rank's rows of it
under a mesh) is copied into device buffers kept for that shape, the graph
replays the forward and writes the four outputs into one packed tensor
(gathered over the ranks after the replay under a mesh), and one
device-to-host copy reads it.
A bucket's first call runs the forward eagerly over those buffers and then
captures it, so `PredictionServer.warmup()`, which calls every bucket,
leaves every graph captured.  An explicit `recurrence=` runs eagerly (the
plain-version yardstick); on the CPU every call is eager.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from mmda_tpu_torch.config import Config, resolve_device, set_reference_numerics
from mmda_tpu_torch.convert import load_jax_params
from mmda_tpu_torch.models import Batch, get_model
from mmda_tpu_torch.models.bert import BertConfig, bert_config_for, quantize_bert_int8
from mmda_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_batch
from mmda_tpu_torch.serving_requests import (RequestTooLongError, check_overflow, choose_bucket,
                                             pad_requests, validate_request)
from mmda_tpu_torch.train import checkpoint as ckpt
from mmda_tpu_torch.train.step import StepGraphs, graph_pool


__all__ = ["Predictor", "RequestTooLongError", "validate_request"]


class Predictor:
    def __init__(
        self,
        cfg: Config,
        params=None,
        bert_cfg: Optional[BertConfig] = None,
        visual_size: Optional[int] = None,
        acoustic_size: Optional[int] = None,
        vocab_size: Optional[int] = None,
        max_batch: int = 64,
        tokenizer=None,
        word2id: Optional[Dict[str, int]] = None,
        overflow: str = "error",
        bert_weights_dtype: Optional[str] = "auto",
        device: Optional[str] = None,
        mesh: Optional[Mesh] = None,
    ):
        """params: a port model (`nn.Module`, moved to the device and, for
        bf16 BERT storage, cast in place), a JAX parameter tree (converted
        by `mmda_tpu_torch.convert`), or None to load the best-on-dev export
        `{cfg.ckpt_dir}/best_model_...msgpack` written by the JAX trainer.

        device: defaults to cfg.device ("cuda"); "cuda" without a card
        raises.  overflow: 'error' raises RequestTooLongError for a request
        longer than the largest bucket, 'truncate' keeps its first tokens.
        bert_weights_dtype: 'auto' stores BERT in bf16 on CUDA when the
        compute dtype is bf16; 'int8' quantizes the encoder denses (in
        place, on a model passed in); None keeps the loaded dtypes.
        mesh: serve data-parallel over its ranks (module docstring); the
        device is then the mesh's."""
        check_overflow(overflow)
        if mesh is not None and max_batch % mesh.dp != 0:
            raise ValueError(f"max_batch={max_batch} must be divisible by the mesh data "
                             f"axis {mesh.dp}")
        self.mesh = mesh
        self.device = resolve_device(device or (str(mesh.device) if mesh else cfg.device))
        if self.device.type == "cuda":
            set_reference_numerics()
        self.overflow = overflow
        self.cfg = cfg
        self.bert_cfg = bert_cfg or bert_config_for(cfg)
        self.max_batch = max_batch
        self.tokenizer = tokenizer
        self.word2id = word2id or {}
        self.visual_size = visual_size
        self.acoustic_size = acoustic_size
        if not isinstance(params, nn.Module):
            tree = params
            if tree is None:
                tree = ckpt.load_checkpoint(cfg.ckpt_dir, ckpt.best_model_name(cfg))
            model = get_model(cfg.model)(
                cfg, visual_size=visual_size, acoustic_size=acoustic_size,
                vocab_size=vocab_size, bert_cfg=self.bert_cfg, device="cpu")
            params = load_jax_params(model, tree)
        self.model = params.to(self.device).eval()
        if bert_weights_dtype == "auto":
            bert_weights_dtype = (
                "bfloat16" if (self.device.type == "cuda"
                               and cfg.compute_dtype == "bfloat16") else None)
        bert = getattr(self.model, "bert", None)
        if bert_weights_dtype == "int8" and bert is not None:
            quantize_bert_int8(bert)                # from the loaded (f32) weights
            bert_weights_dtype = None
        if bert_weights_dtype and bert is not None:
            wdt = getattr(torch, bert_weights_dtype)
            for p in self.model.bert.parameters():
                if p.dim() >= 2 and p.dtype == torch.float32:
                    p.data = p.data.to(wdt)
        # MISA returns the shared/private representations; the zoo's
        # families return None there and serve their scores as `hidden`
        self._factorized = hasattr(self.model, "shared")
        self._stats = {"requests": 0, "utterances": 0, "seconds": 0.0}
        # the bucket shapes' graphs (CUDA only); one call at a time owns them
        self._graphs = (StepGraphs(lambda b: {"packed": self._forward(b)}, self.device,
                                   pool=graph_pool(self.device))
                        if self.device.type == "cuda" else None)
        self._lock = threading.Lock()

    def _bucket(self, n: int) -> int:
        return choose_bucket(n, self.cfg.bucket_sizes)

    def batch_arrays(self, requests: Sequence[Dict]) -> tuple:
        """(Batch of host numpy arrays padded to bucket x max_batch, n)
        (`serving_requests.pad_requests`)."""
        arrays, n = pad_requests(
            requests, bucket_sizes=self.cfg.bucket_sizes, max_batch=self.max_batch,
            overflow=self.overflow, use_bert=self.cfg.use_bert, tokenizer=self.tokenizer,
            word2id=self.word2id, visual_size=self.visual_size or self.cfg.visual_size,
            acoustic_size=self.acoustic_size or self.cfg.acoustic_size)
        B = self.max_batch
        batch = Batch(
            **arrays,
            sentiment=np.zeros(B, np.float32),
            emo_label=np.zeros((B, self.cfg.num_classes), np.float32),
            sample_weight=(np.arange(B) < n).astype(np.float32),
        )
        return batch, n

    def __call__(self, requests: Sequence[Dict], recurrence=None) -> Dict[str, np.ndarray]:
        """requests: per-utterance dicts with text (L,), visual (L, Dv),
        acoustic (L, Da), bert_ids/bert_type/bert_mask (L+2,), or raw
        `{"text": "a string"}` rows when a tokenizer was given.  Returns the
        stacked results trimmed to len(requests).

        recurrence: the recurrence for the RNN towers; None runs the kernel
        wrapper of cfg.rnncell's cell (`lstm_recurrence`, `gru_recurrence`),
        `lstm_recurrence_reference` / `gru_recurrence_reference` its plain
        version (a yardstick for the kernel)."""
        t0 = time.perf_counter()
        batch, n = self.batch_arrays(requests)
        if self.mesh is not None:
            batch = Batch(**shard_batch(batch._asdict(), self.mesh))
        with torch.inference_mode():
            # one device-to-host copy for all four outputs
            if recurrence is not None or self._graphs is None:
                packed = self._host(self._forward(batch.to(self.device), recurrence))
            else:
                with self._lock:
                    packed = self._host(self._graphs(batch._asdict())["packed"])
        cols = np.cumsum([0] + self._widths())
        result = {k: packed[:n, cols[i]:cols[i + 1]]
                  for i, k in enumerate(("scores", "labels", "tcp", "hidden"))}
        dt = time.perf_counter() - t0
        self._stats["requests"] += 1
        self._stats["utterances"] += n
        self._stats["seconds"] += dt
        return result

    def _host(self, packed: torch.Tensor) -> np.ndarray:
        """The packed outputs on the host: every rank's rows under a mesh."""
        if self.mesh is not None:
            (packed,) = gather_rows(self.mesh, packed)
        return packed.cpu().numpy()

    def _widths(self) -> list:
        C = self.cfg.num_classes
        return [C, C, C, 6 * self.cfg.hidden_size if self._factorized else C]

    def _forward(self, batch: Batch, recurrence=None) -> torch.Tensor:
        """scores, labels, tcp and the hidden representation, packed side by
        side as f32 (`_widths`)."""
        out = self.model(batch, recurrence=recurrence)
        hidden = ((out.private_t, out.private_v, out.private_a, out.shared_t, out.shared_v,
                   out.shared_a) if self._factorized else (out.scores,))
        return torch.cat([v.float() for v in (out.scores, out.labels, out.tcp, *hidden)],
                         dim=1)

    @property
    def stats(self) -> Dict[str, float]:
        s = dict(self._stats)
        if s["seconds"] > 0:
            s["utterances_per_sec"] = s["utterances"] / s["seconds"]
        return s
