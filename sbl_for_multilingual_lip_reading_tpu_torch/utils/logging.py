"""Logging setup (a copy of the JAX package's ``utils/logging.py``; the
reference's utils.py:149-156)."""
from __future__ import annotations

import logging


def get_logger(name: str = "sbl_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s \t%(message)s"))
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger
