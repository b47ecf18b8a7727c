"""HTTP serving entry: `python -m mmda_tpu_torch.cli.serve`.

Counterpart of `mmda_tpu/cli/serve.py`: a stdlib HTTP front end over
`serving_server.PredictionServer`, with the same surface.

  POST /predict   {"text": "a string"}                          (raw text)
                  or {"text": [ids...], "visual": [[...]...],
                      "acoustic": [[...]...], "bert_ids": [...],
                      "bert_type": [...], "bert_mask": [...]}    (arrays)
                  -> {"scores": [...], "labels": [...], "tcp": [...]}
  GET  /healthz   -> {"ok": true, "stats": {...}, "kernel_launches": {...}}
                  (the hand-written kernels' launches since the start,
                  by name: `ops/kernels/_launch.py`)

Requests from concurrent clients are coalesced into micro-batches by the
PredictionServer worker; one call per bucket warms the server at startup.
`--export_dir` serves an artifact of `cli/export.py` through an
`ExportedPredictor` (serving_export.py): that process imports no model code
(`mmda_tpu_torch.models`, `serving` and `train` are never loaded).

Usage (on the card; `--device cpu` for the CPU):
  python -m mmda_tpu_torch.cli.serve --data mosei --ckpt_dir checkpoints \\
      --port 8321 [--vocab_file vocab.txt]
  python -m mmda_tpu_torch.cli.serve --export_dir artifact --port 8321
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from mmda_tpu_torch.ops.kernels import _launch
from mmda_tpu_torch.serving_requests import RequestTooLongError
from mmda_tpu_torch.serving_server import PredictionServer


def _to_request(payload: dict) -> dict:
    """JSON payload -> Predictor request row (numpy arrays or raw text)."""
    if isinstance(payload.get("text"), str):
        req = {"text": payload["text"]}
        for k in ("visual", "acoustic"):
            if k in payload:
                req[k] = np.asarray(payload[k], np.float32)
        return req
    req = {}
    for k, dt in (("text", np.int32), ("bert_ids", np.int32),
                  ("bert_type", np.int32), ("bert_mask", np.int32),
                  ("visual", np.float32), ("acoustic", np.float32)):
        if k in payload:
            req[k] = np.asarray(payload[k], dt)
    return req


def make_handler(server, default_timeout_s: float):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "stats": server.stats, "kernel_launches": {
                    name: _launch.launch_count(name) for name in _launch.KERNELS}})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                result = server.predict(_to_request(payload),
                                        timeout_s=default_timeout_s)
                self._reply(200, {
                    "scores": np.asarray(result["scores"]).tolist(),
                    "labels": np.asarray(result["labels"]).tolist(),
                    "tcp": np.asarray(result["tcp"]).tolist(),
                })
            except TimeoutError:
                self._reply(504, {"error": "request timed out"})
            except Exception as e:  # surface as a 4xx, keep serving
                code = 413 if isinstance(e, RequestTooLongError) else 400
                self._reply(code, {"error": str(e)})

        def log_message(self, fmt, *args):  # quiet access log
            pass

    return Handler


def serve(cfg, params=None, port: int = 8321, host: str = "127.0.0.1",
          tokenizer=None, word2id=None, timeout_s: float = 30.0,
          warmup: bool = True, ready_event: Optional[threading.Event] = None,
          predictor=None):
    """Build Predictor + PredictionServer + HTTP front end.  Returns
    (httpd, prediction_server); run `httpd.serve_forever()` (in a thread, or
    as `main` does) and `httpd.shutdown(); prediction_server.close()` to stop.

    predictor: a pre-built Predictor (or ExportedPredictor) to front instead
    of building one from cfg and params."""
    if predictor is None:
        from mmda_tpu_torch.serving import Predictor

        predictor = Predictor(cfg, params=params, tokenizer=tokenizer, word2id=word2id)
    psrv = PredictionServer(predictor, default_timeout_s=timeout_s)
    if warmup:
        psrv.warmup()
    httpd = ThreadingHTTPServer((host, port), make_handler(psrv, timeout_s))
    if ready_event is not None:
        ready_event.set()
    return httpd, psrv


def main(argv=None):
    from mmda_tpu_torch.config import get_config

    cfg = get_config(argv=argv)
    tokenizer = None
    if cfg.vocab_file:
        from mmda_tpu_torch.data.etl.tokenizer import WordPieceTokenizer

        tokenizer = WordPieceTokenizer.from_vocab_file(cfg.vocab_file)
    predictor = None
    if cfg.export_dir:
        # an artifact of cli/export.py: no model code runs in this process
        from mmda_tpu_torch.serving_export import ExportedPredictor

        predictor = ExportedPredictor(cfg.export_dir, device=cfg.device)
        cfg = cfg.replace(model=predictor.cfg.model)
    httpd, psrv = serve(cfg, port=cfg.port, tokenizer=tokenizer, predictor=predictor)
    print(f"serving {cfg.model} ({cfg.data}) on {cfg.device} at http://"
          f"{httpd.server_address[0]}:{httpd.server_address[1]}  "
          "[POST /predict, GET /healthz]")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        psrv.close()


if __name__ == "__main__":
    main()
