"""Structured run logging (counterpart of ``gpmpc_tpu/utils/logging_utils.py``):
JSONL event logs with the JAX package's fields, and a console logger."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Optional


def get_logger(name: str = "gpmpc_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
    return logger


class RunLogger:
    """JSONL event log for campaigns and learning runs: one object a line,
    ``{"t": seconds since creation (3 decimals), "event": name, **fields}``;
    a field that JSON cannot hold is written as its ``str``. Without a path
    the lines go to standard output."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"t": round(time.time() - self._t0, 3), "event": event}
        for k, v in fields.items():
            try:
                json.dumps(v)
                rec[k] = v
            except TypeError:
                rec[k] = str(v)
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print(line)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
