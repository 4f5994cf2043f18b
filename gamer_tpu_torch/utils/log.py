"""Structured logging — the GMessages analog (source/util/gmessages.{h,cpp}).

The reference keeps a timestamped ring of the last 7 messages for the GUI
list widget and silently no-ops headless; here the ring is kept for
programmatic access (status surfaces) and messages also flow through
python logging so headless runs are observable (the reference's silent
headless drop is deliberately NOT reproduced).

A copy of ``gamer_tpu.utils.log``; the port imports nothing of ``gamer_tpu``.
tests/test_torch_copies.py holds the copy equal to the original.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Deque, List

_RING_CAPACITY = 7


def get_logger(name: str = "gamer_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(asctime)s] %(name)s: %(message)s",
                                         datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class Messages:
    """Timestamped message ring (GMessages::Message/Debug parity)."""

    debug_enabled: bool = False  # gmessages.cpp:6-8 — Debug off by default
    _ring: Deque[str] = deque(maxlen=_RING_CAPACITY)

    @classmethod
    def message(cls, text: str) -> None:
        stamped = f"[{time.strftime('%H:%M:%S')}] {text}"
        cls._ring.append(stamped)
        get_logger().info(text)

    @classmethod
    def debug(cls, text: str) -> None:
        if cls.debug_enabled:
            cls.message(text)

    @classmethod
    def last(cls) -> List[str]:
        return list(cls._ring)

    @classmethod
    def clear(cls) -> None:
        cls._ring.clear()
