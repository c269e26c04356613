"""Run logging: stdout and file loggers, a JSONL metric sink.

Port of signnet_basisnet_tpu/utils/logging.py (`RunLogger`): each message
goes to stdout with the time of day and, with a `log_dir`, to
``<log_dir>/<name>.log``; `scalars` appends one JSON record a step to
``<log_dir>/<name>_metrics.jsonl``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class RunLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "run"):
        self.log_dir = log_dir
        self.name = name
        self._file = None
        self._metrics = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, f"{name}.log"), "a")
            self._metrics = open(os.path.join(log_dir,
                                              f"{name}_metrics.jsonl"), "a")

    def __call__(self, msg: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()

    def scalars(self, step: int, **values) -> None:
        if self._metrics:
            self._metrics.write(json.dumps({"step": step, **values}) + "\n")
            self._metrics.flush()

    def close(self) -> None:
        for f in (self._file, self._metrics):
            if f:
                f.close()
