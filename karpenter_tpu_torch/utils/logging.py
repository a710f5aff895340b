"""Leveled component logger (copy of ``karpenter_tpu/utils/logging.py``).

Structured key=value logging over stdlib logging, with an env-controlled
level (``KARPENTER_TPU_LOG_LEVEL``) and per-component named loggers.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Any

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warn": logging.WARNING, "warning": logging.WARNING,
           "error": logging.ERROR}

_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    level = _LEVELS.get(os.environ.get("KARPENTER_TPU_LOG_LEVEL", "info").lower(),
                        logging.INFO)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s %(message)s"))
    root = logging.getLogger("karpenter_tpu_torch")
    root.setLevel(level)
    if not root.handlers:
        root.addHandler(handler)
    root.propagate = False
    _configured = True


class ComponentLogger:
    """logr-style structured logger: ``log.info("msg", key=value, ...)``."""

    def __init__(self, component: str):
        _configure()
        self._log = logging.getLogger(f"karpenter_tpu_torch.{component}")

    @staticmethod
    def _fmt(msg: str, kv: dict) -> str:
        if not kv:
            return msg
        pairs = " ".join(f"{k}={v!r}" for k, v in kv.items())
        return f"{msg} {pairs}"

    def debug(self, msg: str, **kv: Any) -> None:
        self._log.debug(self._fmt(msg, kv))

    def info(self, msg: str, **kv: Any) -> None:
        self._log.info(self._fmt(msg, kv))

    def warning(self, msg: str, **kv: Any) -> None:
        self._log.warning(self._fmt(msg, kv))

    def error(self, msg: str, **kv: Any) -> None:
        self._log.error(self._fmt(msg, kv))


def get_logger(component: str) -> ComponentLogger:
    return ComponentLogger(component)
