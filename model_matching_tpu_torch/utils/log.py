"""Structured logging of the port: one namespaced logger, warnings with
structured fields, and one-line JSON events.

Environment:
  MM_TORCH_LOG       level name (DEBUG/INFO/WARNING/ERROR); default INFO.
  MM_TORCH_LOG_JSON  when 1, log_event() prints bare JSON lines to stdout.
  MM_TORCH_TRACE     when 0, the span and counter log (utils/trace.py) records
                     nothing; counter totals are still kept, and spans that
                     end on a device synchronize still synchronize.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_LOGGER_NAME = "model_matching_tpu_torch"


def get_logger() -> logging.Logger:
    """The package logger, given a stderr handler on first use."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        level = os.environ.get("MM_TORCH_LOG", "INFO").upper()
        logger.setLevel(getattr(logging, level, logging.INFO))
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("[mm-torch] %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def log_event(event: str, **fields) -> None:
    """Emit one machine-readable record."""
    line = json.dumps({"event": event, "ts": round(time.time(), 3), **fields},
                      default=float)
    if os.environ.get("MM_TORCH_LOG_JSON") == "1":
        print(line, flush=True)
    else:
        get_logger().info(line)


def warn(msg: str, **fields) -> None:
    """A WARNING with optional structured fields appended."""
    if fields:
        msg = msg + " " + json.dumps(fields, default=float)
    get_logger().warning(msg)
