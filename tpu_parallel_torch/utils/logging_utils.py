"""Metric logging: stdout + JSONL file sink, the port of
``tpu_parallel/utils/logging_utils.py``'s :class:`MetricLogger` and
:func:`print_exception`.

The port runs one process, so it is always the main one (rank 0 in the
JAX package's ``jax.process_index() == 0`` gate).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def print_exception(exc: BaseException, *, width: int = 100) -> str:
    """Compact one-glance rendering of an exception: its type (red on a
    terminal) and its wrapped message, printed to stderr and returned;
    ``Trainer.fit`` calls this on step failures before deciding whether to
    roll back."""
    import sys
    import textwrap

    name = type(exc).__name__
    use_color = hasattr(sys.stderr, "isatty") and sys.stderr.isatty()
    title = f"\033[91m{name}\033[0m" if use_color else name
    body = textwrap.fill(str(exc), width=width) or "(no message)"
    rendered = f"{title}\n{body}"
    print(rendered, file=sys.stderr, flush=True)
    return rendered


def _to_scalar(value):
    """A JSON-native Python scalar for a metric value: 0-d tensors and
    arrays are unwrapped with ``item()``; anything else passes through."""
    if isinstance(value, (int, float, str, bool)) or value is None:
        return value
    item = getattr(value, "item", None)
    if item is not None and getattr(value, "ndim", 0) == 0:
        value = item()
        if isinstance(value, (int, float, str, bool)):
            return value
    return value


class MetricLogger:
    """Prints ``[step N] k=v ...`` lines and appends one JSON record per
    call to ``{logdir}/{name}.jsonl`` when ``logdir`` is given."""

    def __init__(self, logdir: Optional[str] = None, name: str = "train"):
        self.is_main = True
        self.file = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self.path = os.path.join(logdir, f"{name}.jsonl")
            self.file = open(self.path, "a")
        self._t0 = time.time()

    def _emit(self, record: Dict, text: str) -> None:
        print(text, flush=True)
        if self.file is not None:
            self.file.write(json.dumps(record) + "\n")
            self.file.flush()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        metrics = {k: _to_scalar(v) for k, v in metrics.items()}
        record = {"step": step, "time": round(time.time() - self._t0, 3), **metrics}
        parts = " ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items()))
        self._emit(record, f"[step {step}] {parts}")

    def log_record(self, record: Dict) -> None:
        """Append one arbitrary JSON record (end-of-run summaries)."""
        self._emit(record, json.dumps(record))

    def close(self) -> None:
        if self.file is not None:
            self.file.close()
            self.file = None
