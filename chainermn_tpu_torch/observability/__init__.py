"""Observability carried over so far: the span tracer (``trace``), the
flight recorder (``flight``: the event ring and the debug bundles), the
causal fleet journal (``journal``: HLC-stamped per-process files, their
happens-before merge and renderings), the comm ledger (``comm``), the
Prometheus textfile and the JSONL metrics stream with the health snapshot
(``export``), and goodput, SLO burn-rate tracking and the latency
reservoir (``slo``)."""

from . import comm, flight, journal, trace
from .comm import CommAccountant, get_accountant
from .export import (SCHEMA as METRICS_SCHEMA, MetricsWriter,
                     health_snapshot, parse_prometheus_text, prometheus_text,
                     read_metrics_jsonl, write_prometheus_textfile)
from .flight import (FlightRecorder, dump_bundle, find_bundles,
                     get_flight_recorder, install_signal_handlers,
                     install_tracer_tee, note, read_bundle,
                     register_provider, set_crash_dump_dir,
                     unregister_provider)
from .slo import (GoodputLedger, RateMeter, ReservoirSample, SLOTracker,
                  percentile_of)
from .trace import (Tracer, add_counter, async_event, complete_event,
                    disable, enable, enabled, export_chrome_trace,
                    get_tracer, instant, now_us, reset, set_gauge,
                    shard_path, span, traced)


def comm_report():
    """Cumulative per-collective byte/call/latency totals."""
    return get_accountant().report()


def reset_all() -> None:
    """Clear trace events AND comm totals (tests, fresh capture)."""
    reset()
    get_accountant().reset()


__all__ = ["CommAccountant", "FlightRecorder", "GoodputLedger",
           "METRICS_SCHEMA", "MetricsWriter", "RateMeter",
           "ReservoirSample", "SLOTracker", "Tracer", "add_counter",
           "async_event", "comm", "comm_report", "complete_event",
           "disable", "dump_bundle", "enable", "enabled",
           "export_chrome_trace", "find_bundles", "flight",
           "get_accountant", "get_flight_recorder", "get_tracer",
           "health_snapshot", "install_signal_handlers",
           "install_tracer_tee", "instant", "journal", "note", "now_us",
           "parse_prometheus_text", "percentile_of", "prometheus_text",
           "read_bundle", "read_metrics_jsonl", "register_provider",
           "reset", "reset_all", "set_crash_dump_dir", "set_gauge",
           "shard_path", "span", "trace", "traced", "unregister_provider",
           "write_prometheus_textfile"]
