"""Leveled library logging — the SVT_LOG subsystem rebuilt for Python.

Counterpart: Source/Lib/Codec/svt_log.c (svt_log_init
reads SVT_LOG / SVT_LOG_FILE from the environment; svt_log() filters by
level and prefixes "Tag[level]: "). Same environment contract here so
scripts written against the reference keep working:

  SVT_LOG=<int>       -1 all, 0 fatal, 1 error, 2 warn, 3 info (default),
                      4 debug
  SVT_LOG_FILE=<path> append log lines to a file instead of stderr

Unlike the reference this is stdlib-logging-backed, so applications can
also attach handlers/formatters to logging.getLogger("svt_av1_psyex_tpu")
instead of (or in addition to) the env switches.
"""

from __future__ import annotations

import logging
import os
import sys
import threading

ALL = -1
FATAL = 0
ERROR = 1
WARN = 2
INFO = 3
DEBUG = 4

_TO_PY = {FATAL: logging.CRITICAL, ERROR: logging.ERROR,
          WARN: logging.WARNING, INFO: logging.INFO, DEBUG: logging.DEBUG}
_NAMES = {FATAL: "fatal", ERROR: "error", WARN: "warn",
          INFO: "info", DEBUG: "debug"}

_lock = threading.Lock()
_initialized = False


def _init() -> logging.Logger:
    """Lazy one-time init from the environment (svt_log_init analog)."""
    global _initialized
    logger = logging.getLogger("svt_av1_psyex_tpu")
    with _lock:
        if _initialized:
            return logger
        _initialized = True
        try:
            level = int(os.environ.get("SVT_LOG", str(INFO)))
        except ValueError:
            level = INFO
        logger.setLevel(logging.DEBUG if level >= DEBUG or level == ALL
                        else _TO_PY.get(level, logging.INFO))
        path = os.environ.get("SVT_LOG_FILE")
        if not logger.handlers:
            handler: logging.Handler
            if path:
                handler = logging.FileHandler(path)
            else:
                handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter("%(message)s"))
            logger.addHandler(handler)
            logger.propagate = False
    return logger


def log(level: int, tag: str | None, msg: str, *args) -> None:
    """svt_log analog: tagged, level-filtered write."""
    logger = _init()
    text = (msg % args) if args else msg
    if tag:
        text = f"{tag}[{_NAMES.get(level, 'unknown')}]: {text}"
    logger.log(_TO_PY.get(level, logging.INFO), text)


def debug(msg: str, *args, tag: str = "Svt") -> None:
    log(DEBUG, tag, msg, *args)


def info(msg: str, *args, tag: str = "Svt") -> None:
    log(INFO, tag, msg, *args)


def warn(msg: str, *args, tag: str = "Svt") -> None:
    log(WARN, tag, msg, *args)


def error(msg: str, *args, tag: str = "Svt") -> None:
    log(ERROR, tag, msg, *args)


def fatal(msg: str, *args, tag: str = "Svt") -> None:
    log(FATAL, tag, msg, *args)
