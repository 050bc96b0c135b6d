"""Observability: the counterpart of ``chainermn_tpu/observability/``.

* :mod:`.trace` — nested span tracer with counters / gauges and a
  Chrome-trace / Perfetto JSON exporter; no-op when disabled.
* :mod:`.comm` — the comm ledger: every collective of ``ops.collective``,
  the communicators' eager collectives and the step builders' gradient
  mean are booked (op, axis, payload bytes, dtype, host latency), with a
  per-step report bracketed by the updater.
* :mod:`.metrics` — step-time breakdown, throughput and MFU (the card's
  peak table) published through the trainer's observation.
* :mod:`.aggregate` — per-rank trace shard merge and the cross-rank skew
  report naming the straggler rank.
* :mod:`.anomaly` — rolling-window detectors (step-time spikes, loss
  NaN / divergence, comm-bytes drift, MFU drop) behind the
  :class:`HealthMonitor` trainer extension.
* :mod:`.export` — Prometheus textfile, the versioned JSONL metrics
  stream (:class:`MetricsReport`) and :func:`health_snapshot`.
* :mod:`.flight` — the flight recorder (the event ring and the debug
  bundles); :mod:`.slo` — goodput, SLO burn-rate tracking and the
  latency reservoir; :mod:`.introspect` — the live ``/statusz`` /
  ``/metricsz`` / ``/requestz`` / ``/debugz`` server; :mod:`.journal` —
  the causal fleet journal; :mod:`.conform` — replay of the journals
  through the protocol models.

Quick start::

    from chainermn_tpu_torch import observability as obs
    obs.enable()
    ... train ...
    obs.export_chrome_trace("trace.json")    # load in Perfetto
    print(obs.comm_report())                 # bytes per collective
"""

from . import comm, flight, journal, trace
from .trace import (Tracer, add_counter, async_event, complete_event,
                    disable, enable, enabled, export_chrome_trace,
                    get_tracer, instant, now_us, reset, set_gauge, span,
                    traced)
from .comm import (CommAccountant, accounted_method, collective,
                   get_accountant)
from .metrics import StepBreakdownReport, hbm_bw_for, peak_flops_for
from .aggregate import (cross_rank_report, find_shards, local_rank_summary,
                        merge_trace_shards, shard_path)
from .anomaly import (CommBytesDriftDetector, HealthMonitor,
                      LossAnomalyDetector, MFUDropDetector,
                      StepTimeSpikeDetector, default_detectors)
from .export import (SCHEMA as METRICS_SCHEMA, MetricsReport, MetricsWriter,
                     health_snapshot, parse_prometheus_text, prometheus_text,
                     read_metrics_jsonl, write_prometheus_textfile)
from .flight import (BUNDLE_SCHEMA, FlightRecorder, dump_bundle,
                     find_bundles, get_flight_recorder,
                     install_signal_handlers, install_tracer_tee, note,
                     read_bundle, register_provider, set_crash_dump_dir,
                     unregister_provider)
from .slo import (GoodputLedger, RateMeter, ReservoirSample, SLOTracker,
                  percentile_of)
from .introspect import StatusServer, start_status_server


def comm_report():
    """Cumulative per-collective byte/call/latency totals."""
    return get_accountant().report()


def reset_all() -> None:
    """Clear trace events AND comm totals (tests, fresh capture)."""
    reset()
    get_accountant().reset()


# JAX's __all__ order, then the port's own additions
__all__ = [
    "Tracer", "enable", "disable", "enabled", "reset", "reset_all", "span",
    "traced", "instant", "add_counter", "set_gauge", "get_tracer",
    "export_chrome_trace", "CommAccountant", "get_accountant", "collective",
    "accounted_method", "comm_report", "StepBreakdownReport",
    "peak_flops_for", "hbm_bw_for",
    "shard_path", "find_shards", "merge_trace_shards", "local_rank_summary",
    "cross_rank_report", "HealthMonitor", "StepTimeSpikeDetector",
    "LossAnomalyDetector", "CommBytesDriftDetector", "MFUDropDetector",
    "default_detectors", "METRICS_SCHEMA", "MetricsWriter", "MetricsReport",
    "read_metrics_jsonl", "health_snapshot", "prometheus_text",
    "parse_prometheus_text", "write_prometheus_textfile",
    "BUNDLE_SCHEMA", "FlightRecorder", "get_flight_recorder",
    "install_tracer_tee", "install_signal_handlers", "set_crash_dump_dir",
    "register_provider", "dump_bundle", "read_bundle", "find_bundles",
    "GoodputLedger", "ReservoirSample", "SLOTracker", "StatusServer",
    "start_status_server", "async_event", "complete_event", "now_us",
    # the port's own additions
    "RateMeter", "comm", "flight", "journal", "note", "percentile_of",
    "trace", "unregister_provider",
]
