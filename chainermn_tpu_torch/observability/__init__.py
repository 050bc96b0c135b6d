"""Observability carried over so far: the span tracer (``trace``), the
flight recorder (``flight``: the event ring and the debug bundles), the
health snapshot (``export``) and the serving latency reservoir
(``slo``)."""

from . import flight, trace
from .export import health_snapshot
from .flight import (FlightRecorder, dump_bundle, find_bundles,
                     get_flight_recorder, install_signal_handlers,
                     install_tracer_tee, note, read_bundle,
                     register_provider, unregister_provider)
from .slo import ReservoirSample, percentile_of
from .trace import (Tracer, add_counter, disable, enable, enabled,
                    export_chrome_trace, get_tracer, instant, reset,
                    set_gauge, shard_path, span, traced)

__all__ = ["FlightRecorder", "ReservoirSample", "Tracer", "add_counter",
           "disable", "dump_bundle", "enable", "enabled",
           "export_chrome_trace", "find_bundles", "flight",
           "get_flight_recorder", "get_tracer", "health_snapshot", "instant",
           "install_signal_handlers", "install_tracer_tee", "note",
           "percentile_of", "read_bundle", "register_provider", "reset",
           "set_gauge", "shard_path", "span", "trace", "traced",
           "unregister_provider"]
