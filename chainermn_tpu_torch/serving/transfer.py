"""The in-process object-lane store.

Counterpart of ``chainermn_tpu/serving/transfer.py ::
InProcessLaneStore``: the one-process stand-in for a cross-process lane
store, with the same put / get / delete face.  The KV transfer plane
that JAX builds on it is ROADMAP.md's A11.
"""

from __future__ import annotations

import threading
import time
from typing import Dict


class InProcessLaneStore:
    """Loopback object-lane transport.  Faults are injected through
    ``lane_call``'s injector, not here, so tests exercise the real retry
    and classification path."""

    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._cv = threading.Condition()

    def put(self, tag: str, payload: bytes) -> None:
        with self._cv:
            self._store[str(tag)] = bytes(payload)
            self._cv.notify_all()

    def get(self, tag: str, timeout_s: float = 10.0) -> bytes:
        deadline = time.monotonic() + float(timeout_s)
        with self._cv:
            while str(tag) not in self._store:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"kv transfer tag {tag!r} not published within "
                        f"{timeout_s}s (deadline exceeded)")
                self._cv.wait(left)
            return self._store[str(tag)]

    def delete(self, tag: str) -> None:
        with self._cv:
            self._store.pop(str(tag), None)

    def tags(self):
        """Every tag published now."""
        with self._cv:
            return list(self._store)
