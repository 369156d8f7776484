"""Structured logging for the port's stages and serving.

Counterpart of ``rs_image_segmentation_tpu.utils.log``: stages log through
a namespaced logger (root ``rs_image_segmentation_tpu_torch``) with stage
and timing fields. Opt-in verbosity via ``configure(level)`` or the
``RS_SEG_LOG`` environment variable.
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

_LOGGER = logging.getLogger("rs_image_segmentation_tpu_torch")


def get_logger(name: str = "") -> logging.Logger:
    return _LOGGER.getChild(name) if name else _LOGGER


def configure(level: str = None) -> None:
    level = level or os.environ.get("RS_SEG_LOG", "WARNING")
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    _LOGGER.handlers[:] = [handler]
    _LOGGER.setLevel(level.upper())


@contextmanager
def stage_log(name: str, **fields):
    """Log stage start/end with wall time and optional fields."""
    log = get_logger(name)
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    log.info("start %s", extra)
    t0 = time.perf_counter()
    try:
        yield log
    except Exception:
        log.exception("failed after %.2fs", time.perf_counter() - t0)
        raise
    log.info("done in %.2fs", time.perf_counter() - t0)
