"""Structured metric logging to stdout and a JSONL file.

The port's copy of `mmda_tpu/utils/logging.py::MetricLogger` with its
`stdout` and `jsonl` sinks and the same payloads (a `step` when given, a
`time` stamp; stdout rounds floats to 5 places).  The `wandb` and
`hypertune` sinks are not ported and raise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

SINKS = ("stdout", "jsonl")


class MetricLogger:
    def __init__(self, sinks: Sequence[str] = ("stdout",), run_name: str = "run",
                 log_dir: str = "logs"):
        unknown = [s for s in sinks if s not in SINKS]
        if unknown:
            raise ValueError(f"log sinks {unknown} are not ported (ROADMAP Queue 1); "
                             f"the port logs to {SINKS}")
        self.sinks = tuple(sinks)
        self.run_name = run_name
        self._jsonl = None
        if "jsonl" in self.sinks:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{run_name}.jsonl"), "a")

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        payload = {k: (float(v) if hasattr(v, "__float__") else v)
                   for k, v in metrics.items()}
        if step is not None:
            payload["step"] = step
        payload["time"] = time.time()
        if "stdout" in self.sinks:
            shown = {k: (round(v, 5) if isinstance(v, float) else v)
                     for k, v in payload.items() if k != "time"}
            print(f"[{self.run_name}] {shown}", flush=True)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(payload) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
