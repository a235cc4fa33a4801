"""Structured logging (the reference has only bare ``echo``/``print`` —
SURVEY §5). ``MEMO_TPU_LOG=debug|info|warning`` controls verbosity;
``MEMO_TPU_LOG_JSON=1`` switches to JSON lines for machine consumption.

The port's own copy of :mod:`memo_tpu.utils.logging`, which stays the reference; the two
read and write the same files.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_CONFIGURED = False


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = os.environ.get("MEMO_TPU_LOG", "info").upper()
    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("MEMO_TPU_LOG_JSON"):
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname).1s %(name)s] %(message)s", "%H:%M:%S")
        )
    root = logging.getLogger("memo_tpu_torch")
    root.addHandler(handler)
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    if not name.startswith("memo_tpu_torch"):
        name = f"memo_tpu_torch.{name}"
    return logging.getLogger(name)
