"""Structured JSONL logging (``msha_gnn_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class JsonlLogger:
    """Call with a dict: one JSON line to ``path`` (appended) and, with
    ``echo``, to stderr, with the seconds since construction as ``t``."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self._fh: Optional[IO] = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.time()

    def __call__(self, record: dict):
        record = {"t": round(time.time() - self._t0, 3), **record}
        line = json.dumps(record, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
