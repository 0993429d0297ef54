"""The CLIs' logger (the part of stitchax/utils/logger.py they use).

Console lines go to stderr with the seconds since the logger started;
the logger also holds `{log_dir}/{name}_metrics.jsonl`, the metrics file
stitchax's Logger opens in the result directory.
"""

from __future__ import annotations

import os
import sys
import time


class Logger:
    def __init__(self, log_dir: str = ".", name: str = "stitchax_torch"):
        self.name = name
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, f"{name}_metrics.jsonl"),
                           "a", buffering=1)
        self._t0 = time.time()

    def info(self, msg: str):
        t = time.time() - self._t0
        print(f"[{self.name} +{t:8.1f}s] {msg}", file=sys.stderr, flush=True)

    def close(self):
        self._jsonl.close()
