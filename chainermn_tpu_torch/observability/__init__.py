"""Observability carried over so far: the span tracer (``trace``) and the
serving latency reservoir (``slo``)."""

from . import trace
from .slo import ReservoirSample, percentile_of
from .trace import (Tracer, add_counter, disable, enable, enabled,
                    export_chrome_trace, get_tracer, instant, reset,
                    set_gauge, shard_path, span, traced)

__all__ = ["ReservoirSample", "Tracer", "add_counter", "disable", "enable",
           "enabled", "export_chrome_trace", "get_tracer", "instant",
           "percentile_of", "reset", "set_gauge", "shard_path", "span",
           "trace", "traced"]
