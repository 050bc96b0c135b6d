"""Fixed-size latency samples for the serving percentiles.

A copy of ``ReservoirSample`` (and the percentile it reports) from
``chainermn_tpu/observability/slo.py``: p50/p99 stay meaningful over an
unbounded stream at constant memory.  Pure stdlib.
"""

from __future__ import annotations

import random
from typing import List, Optional


def percentile_of(values: List[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile (numpy's default definition) over an
    unsorted list, or None when empty."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * (float(q) / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1 - frac) + vals[hi] * frac


class ReservoirSample:
    """Fixed-size uniform sample of an unbounded stream (algorithm R),
    deterministic given ``seed``."""

    def __init__(self, capacity: int = 1024, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._values: List[float] = []
        self._n = 0
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        self._n += 1
        if len(self._values) < self.capacity:
            self._values.append(float(value))
            return
        j = self._rng.randrange(self._n)
        if j < self.capacity:
            self._values[j] = float(value)

    def percentile(self, q: float) -> Optional[float]:
        """Linear-interpolated percentile over the retained sample, or None
        when empty."""
        return percentile_of(self._values, q)
