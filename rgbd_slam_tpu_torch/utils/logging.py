"""Leveled, colored, source-located logging.

Parity with reference src/outputs/logger.{hpp,cpp}: compile-time-ish level filter
(ALL/LOW/MED/HIGH/NONE), ANSI colors, file:line prefix from the call site.
"""

from __future__ import annotations

import inspect
import os
import sys
import threading

ALL, LOW, MEDIUM, HIGH, NONE = 0, 1, 2, 3, 4
_LEVEL = {"all": ALL, "low": LOW, "medium": MEDIUM, "high": HIGH,
          "none": NONE}.get(os.environ.get("RGBD_SLAM_LOG_LEVEL", "medium"), MEDIUM)
_lock = threading.Lock()

_RESET = "\033[0m"
_YELLOW = "\033[33m"
_RED = "\033[31m"


def _emit(prefix: str, color: str, message: str):
    frame = inspect.stack()[2]
    loc = f"{os.path.basename(frame.filename)}:{frame.lineno}"
    with _lock:
        sys.stdout.write(f"{color}[{prefix}] ({loc}) {message}{_RESET}\n")


def log(message: str, level: int = LOW):
    """(reference: outputs::log, logger.cpp:8-40)"""
    if level >= _LEVEL:
        _emit("INFO", "", message)


def log_warning(message: str):
    if MEDIUM >= _LEVEL:
        _emit("WARN", _YELLOW, message)


def log_error(message: str):
    if HIGH >= _LEVEL:
        _emit("ERROR", _RED, message)
