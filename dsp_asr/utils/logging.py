"""Structured logging + per-run JSON metrics (SURVEY.md §5 observability).

The reference logs with bare prints; here every run can emit a structured
JSON record (accuracy, throughput, compile time, config) next to ordinary
stdlib logging — no heavy dependencies.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time
from typing import Any

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "dsp_asr", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


_WARNED: set = set()


def warn_once(key: str, message: str, name: str = "dsp_asr") -> bool:
    """Emit ``message`` at WARNING level once per process per ``key``.

    Used to flag known-slow implementation selections (VERDICT round 2:
    nothing stopped a user from picking measured-slow paths silently).
    Returns True if the warning fired.
    """
    if key in _WARNED:
        return False
    _WARNED.add(key)
    get_logger(name).warning(message)
    return True


def _jsonable(v: Any):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.asdict(v)
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class RunMetrics:
    """Collects key->value metrics for one run; dumps one JSON object."""

    def __init__(self, run_name: str):
        self.data: dict = {"run": run_name, "started_unix": time.time()}

    def record(self, **kv) -> None:
        for k, v in kv.items():
            self.data[k] = _jsonable(v)

    def dump(self, path: str | None = None) -> str:
        self.data["elapsed_s"] = round(time.time() - self.data["started_unix"], 3)
        text = json.dumps(self.data, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text
