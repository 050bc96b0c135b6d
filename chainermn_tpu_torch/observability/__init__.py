"""Serving observability carried over so far: the latency reservoir."""

from .slo import ReservoirSample, percentile_of

__all__ = ["ReservoirSample", "percentile_of"]
