"""Structured run logging (SURVEY.md C19 + §5).

The port's own copy of dynseg/utils/logging.py (dynseg_torch imports nothing of the
JAX package); tests/test_torch_data.py holds it to the original.

The reference prints loss/acc/time to stdout; this logger does the same
AND appends machine-readable JSONL records (metrics.jsonl in the output
dir) so runs are comparable without scraping stdout.

Under data parallelism (dynseg_torch.parallel) the logger of a rank other
than 0 prints and writes nothing: rank 0 speaks for the group."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from dynseg_torch import parallel


def _coerce(obj):
    """JSON fallback for numpy/jax scalars and arrays."""
    try:
        return float(obj)
    except (TypeError, ValueError):
        pass
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


class MetricLogger:
    def __init__(self, output_path: Optional[str] = None, echo=print):
        self.echo = echo if parallel.is_main() else (lambda *_: None)
        self._fh = None
        if output_path and parallel.is_main():
            os.makedirs(output_path, exist_ok=True)
            self._fh = open(
                os.path.join(output_path, "metrics.jsonl"), "a", buffering=1
            )

    def log(self, message: str, **record) -> None:
        self.echo(message)
        if self._fh is not None:
            record.setdefault("ts", time.time())
            record.setdefault("msg", message)
            # default: every metric in this codebase is a numpy/jax
            # scalar — a bare json.dumps raised TypeError mid-training on
            # the first unwrapped one (review r2, round 2). Numeric-like
            # values coerce to float, anything else to its repr string.
            self._fh.write(json.dumps(record, default=_coerce) + "\n")

    def __call__(self, message: str) -> None:  # drop-in for log=print
        self.log(message)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
