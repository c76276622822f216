"""Metrics logging to a JSONL file (counterpart of
``quantized_training_tpu/utils/logging.py``): one record per call,
``{"step", "ts", **metrics}``, appended to ``save_dir/metrics.jsonl``."""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricLogger:
    def __init__(self, save_dir: str | Path | None, enabled: bool = True):
        self.enabled = enabled
        self.path = None
        if save_dir is not None and enabled:
            Path(save_dir).mkdir(parents=True, exist_ok=True)
            self.path = Path(save_dir) / "metrics.jsonl"
            self._f = open(self.path, "a")

    def log(self, metrics: dict, step: int) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "ts": time.time(), **metrics}
        if self.path is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def finish(self) -> None:
        if self.path is not None:
            self._f.close()
