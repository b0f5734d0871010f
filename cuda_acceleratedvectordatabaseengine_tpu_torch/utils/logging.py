"""Structured logging.

The reference logs with bare ``std::cout`` everywhere and its YAML promises
JSON file logs that nothing implements (SURVEY.md §5). One logger setup:
human-readable console by default, JSON lines with ``VDB_LOG_JSON=1``.

A copy of the JAX package's ``utils/logging.py`` (the port imports
nothing of that package).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "extra_fields", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload)


def get_logger(name: str = "vdb") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("VDB_LOG_JSON") == "1":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        ))
    logger.addHandler(handler)
    logger.setLevel(os.environ.get("VDB_LOG_LEVEL", "INFO").upper())
    logger.propagate = False
    return logger
