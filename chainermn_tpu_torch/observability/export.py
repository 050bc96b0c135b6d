"""Machine-readable metrics export: Prometheus textfile + JSONL stream.

Counterpart of ``chainermn_tpu/observability/export.py``:

* **Prometheus textfile** (:func:`write_prometheus_textfile`) — the
  node-exporter textfile-collector contract: the tracer's counters as
  ``_total``, its gauges (and the caller's extra gauges) as-is, span
  totals and the comm ledger, all under the ``chainermn_tpu_``
  namespace, written atomically so a scrape never sees a torn file;
  :func:`parse_prometheus_text` is its strict reader.
* **JSONL metrics stream** (:class:`MetricsWriter`,
  :class:`MetricsReport`, :func:`read_metrics_jsonl`) — one JSON object
  per line, append-only, each record stamped with the versioned schema id
  (:data:`SCHEMA`), a kind, a wall-clock timestamp and optionally the
  writing rank; a killed run keeps every record up to the kill.
* :func:`health_snapshot` — the dict every debug bundle and watchdog
  dump carries, and the train CLI writes at a clean exit: counters,
  gauges, span summary, the comm ledger and its last step report, anomaly
  findings.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, IO, List, Optional

from . import trace
from .comm import get_accountant

#: The JAX package's schema stamp of its metrics records.
SCHEMA = "chainermn_tpu.metrics.v1"

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _atomic_write_text(path: str, text: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _prom_name(name: str) -> str:
    return "chainermn_tpu_" + _PROM_BAD.sub("_", name).strip("_")


def _esc_label(v) -> str:
    """Prometheus label-value escaping: backslash, quote, newline — the
    full exposition-format rule set, applied to EVERY label value."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _esc_help(v: str) -> str:
    """HELP-text escaping: backslash and newline (quotes are legal)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def prometheus_text(extra_gauges: Optional[Dict[str, float]] = None) -> str:
    """Render the tracer's counters/gauges + the comm ledger in the
    Prometheus text exposition format (version 0.0.4).

    Per-family contract (the node-exporter parser's, verified by the
    round-trip test): ONE ``# HELP`` and ONE ``# TYPE`` line per metric
    family, immediately followed by all of that family's samples; label
    values escaped per the exposition spec (backslash, quote, newline).
    """
    tr = trace.get_tracer()
    # family name -> (kind, help, [(labels-or-None, value), ...]);
    # insertion-ordered so related families stay adjacent
    families: Dict[str, list] = {}

    def add(name: str, kind: str, help_text: str, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        fam = families.setdefault(name, [kind, help_text, []])
        fam[2].append((labels, float(value)))

    for name, total in sorted(tr.counters().items()):
        add(_prom_name(name) + "_total", "counter",
            f"cumulative total of tracer counter '{name}'", total)
    # extra gauges OVERRIDE tracer gauges of the same name (the serving
    # engine publishes e.g. serving/queue_depth both ways; duplicate
    # unlabeled samples of one series are invalid exposition text)
    gauges = dict(tr.gauges())
    gauges.update(extra_gauges or {})
    for name, value in sorted(gauges.items()):
        add(_prom_name(name), "gauge",
            f"instantaneous value of gauge '{name}'", value)
    spans = tr.summary()["spans"]
    for family, field, scale, help_text in (
            ("chainermn_tpu_span_seconds_total", "total_ms", 1e-3,
             "cumulative wall seconds inside each tracer span"),
            ("chainermn_tpu_span_count_total", "count", 1.0,
             "number of closes of each tracer span")):
        for name, row in sorted(spans.items()):
            add(family, "counter", help_text, float(row[field]) * scale,
                {"name": name})
    rep = get_accountant().report()
    for family, field, help_text in (
            ("chainermn_tpu_comm_bytes_total", "bytes",
             "payload bytes moved per collective op and axis"),
            ("chainermn_tpu_comm_calls_total", "calls",
             "collective call count per op and axis"),
            ("chainermn_tpu_comm_host_seconds_total", "host_time_s",
             "host-observed seconds per collective op and axis")):
        for key, row in sorted(rep["per_op"].items()):
            op, _, axis = key.partition("@")
            add(family, "counter", help_text,
                float(row.get(field, 0.0)), {"axis": axis, "op": op})

    lines: List[str] = []
    for name, (kind, help_text, samples) in families.items():
        lines.append(f"# HELP {name} {_esc_help(help_text)}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in samples:
            lab = ""
            if labels:
                inner = ",".join(f'{k}="{_esc_label(v)}"'
                                 for k, v in sorted(labels.items()))
                lab = "{" + inner + "}"
            lines.append(f"{name}{lab} {value}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)(?:\s+\d+)?$")
_LABEL_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:\\.|[^"\\])*)"\s*(,|$)')


def parse_prometheus_text(text: str) -> Dict[str, Any]:
    """Strict parser for the exposition subset this repo emits.

    Validates the per-family contract — every sample's family has a
    ``# TYPE`` (and ``# HELP``) line ABOVE it, label syntax is legal,
    values parse as floats — raising ``ValueError`` with the offending
    line otherwise.  Returns ``{"families": {name: {"type", "help"}},
    "samples": [(name, labels, value), ...]}`` with label values
    UN-escaped (the round-trip test's oracle).
    """
    families: Dict[str, Dict[str, str]] = {}
    samples: List[tuple] = []
    seen_series: set = set()
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                raise ValueError(f"line {i}: malformed HELP: {line!r}")
            name = parts[2]
            families.setdefault(name, {})["help"] = (
                parts[3] if len(parts) > 3 else "")
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {i}: malformed TYPE: {line!r}")
            families.setdefault(parts[2], {})["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: unparseable sample: {line!r}")
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in families:
                base = name[: -len(suffix)]
        if base not in families or "type" not in families[base]:
            raise ValueError(
                f"line {i}: sample {name!r} has no preceding # TYPE line")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            pos = 0
            while pos < len(raw):
                lm = _LABEL_RE.match(raw, pos)
                if not lm:
                    raise ValueError(
                        f"line {i}: malformed labels {raw!r}")
                labels[lm.group("k")] = re.sub(
                    r"\\(.)",
                    lambda e: {"n": "\n"}.get(e.group(1), e.group(1)),
                    lm.group("v"))
                pos = lm.end()
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(
                f"line {i}: non-numeric sample value: {line!r}")
        series = (name, tuple(sorted(labels.items())))
        if series in seen_series:
            raise ValueError(
                f"line {i}: duplicate series {name}{labels!r} — "
                "Prometheus rejects scrapes with repeated samples")
        seen_series.add(series)
        samples.append((name, labels, value))
    return {"families": families, "samples": samples}


def write_prometheus_textfile(path: str,
                              extra_gauges: Optional[Dict[str, float]]
                              = None) -> str:
    """Atomically write :func:`prometheus_text` to ``path``; returns the
    rendered text."""
    text = prometheus_text(extra_gauges)
    _atomic_write_text(path, text)
    return text


def _numeric(v) -> Optional[float]:
    """Host-side numeric or None — deliberately does NOT call float() on
    device arrays: an exporter must never force a device sync."""
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    # 0-d numpy scalars (np.float32(…)) are host-side and cheap
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "shape", None) == () \
            and type(v).__module__.startswith("numpy"):
        try:
            return float(item())
        except (TypeError, ValueError):
            return None
    return None


class MetricsWriter:
    """Append-only JSONL stream with a versioned schema stamp per record.

    One writer per process; under multi-controller each rank writes its
    own file (``shard_path``-style suffix chosen by the caller) or passes
    ``rank`` so records are attributable after a cat-merge.  Lines are
    flushed as written: a SIGKILL loses at most the current line, never
    the stream.
    """

    def __init__(self, path: str, rank: Optional[int] = None):
        self.path = str(path)
        self.rank = rank
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._f: Optional[IO[str]] = open(self.path, "a")

    def write(self, record: Dict[str, Any], kind: str = "step") -> Dict[str, Any]:
        if self._f is None:
            raise ValueError(f"MetricsWriter({self.path!r}) is closed")
        rec = {"schema": SCHEMA, "kind": kind, "t": round(time.time(), 3)}
        if self.rank is not None:
            rec["rank"] = int(self.rank)
        rec.update(record)
        # the stream's stamps are authoritative: a payload carrying its
        # own schema/kind (e.g. a skew report) keeps it under payload_*
        if record.get("schema") not in (None, SCHEMA):
            rec["payload_schema"] = record["schema"]
        rec["schema"] = SCHEMA
        rec["kind"] = kind
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_metrics_jsonl(path: str, strict: bool = True) -> List[Dict[str, Any]]:
    """Parse a JSONL metrics stream, validating the schema stamp.

    ``strict`` raises ``ValueError`` on a record with a missing/unknown
    schema id (consumer contract: refuse to mis-parse); non-strict skips
    such records.  A trailing torn line (killed writer) is always
    tolerated.
    """
    records: List[Dict[str, Any]] = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            if i == len(lines) - 1:
                continue  # torn final line from a killed writer
            raise ValueError(f"{path}:{i + 1}: unparseable JSONL line")
        schema = rec.get("schema")
        if schema != SCHEMA:
            if strict:
                raise ValueError(
                    f"{path}:{i + 1}: unknown metrics schema {schema!r} "
                    f"(this reader speaks {SCHEMA!r})")
            continue
        records.append(rec)
    return records


def health_snapshot(trainer=None, monitor=None,
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """One dict answering "what was this process doing": tracer summary,
    counters and gauges, the comm ledger and its last per-step report, the
    trainer's position, anomaly findings.  Everything host-side; safe to
    call from the Watchdog's abort path."""
    tr = trace.get_tracer()
    acct = get_accountant()
    snap: Dict[str, Any] = {
        "schema": SCHEMA,
        "kind": "health_snapshot",
        "t": round(time.time(), 3),
        "tracing_enabled": tr.enabled,
        "spans": tr.summary()["spans"],
        "counters": tr.counters(),
        "gauges": tr.gauges(),
        "comm": acct.report(),
        "last_step_comm": acct.last_step_report,
    }
    if trainer is not None:
        snap["iteration"] = getattr(trainer, "iteration", None)
        snap["last_phase"] = getattr(trainer, "last_phase", None)
        snap["elapsed_time"] = getattr(trainer, "elapsed_time", None)
    if monitor is not None and hasattr(monitor, "health"):
        snap["anomalies"] = monitor.health()
    if extra:
        snap.update(extra)
    return snap


class MetricsReport:
    """Trainer extension streaming per-iteration metrics to JSONL (and,
    optionally, a Prometheus textfile refreshed every ``prom_every``
    iterations).

    Records carry every *host-side numeric* observation entry (tensors
    are skipped, not synchronised — add a LogReport/PrintReport if you
    want forced readbacks), the step-time phases, and the per-step comm
    report.  ``finalize`` appends a ``summary`` record with the full
    :func:`health_snapshot` and writes the final textfile, so a clean
    run's last line is always the roll-up.

    Priority 330: after StepBreakdownReport (350) and HealthMonitor (340)
    have produced their keys/findings, before the ObservationAggregator
    (300) replaces local values with rank means — the stream records what
    THIS rank saw, which is the whole point of a per-rank export.
    """

    trigger = (1, "iteration")
    priority = 330

    def __init__(self, path: str, every: int = 1,
                 prometheus_path: Optional[str] = None,
                 prom_every: int = 10, monitor=None,
                 rank: Optional[int] = None):
        self.writer = MetricsWriter(path, rank=rank)
        self.every = max(int(every), 1)
        self.prometheus_path = prometheus_path
        self.prom_every = max(int(prom_every), 1)
        self.monitor = monitor
        self._trainer = None

    def observe(self, trainer) -> None:
        self._trainer = trainer
        it = trainer.iteration
        if it % self.every:
            return
        rec: Dict[str, Any] = {"iteration": it}
        for key, val in trainer.observation.items():
            num = _numeric(val)
            if num is not None:
                rec[key] = num
        phases = getattr(trainer.updater, "phase_times", None)
        if phases:
            for phase, dt in phases.items():
                rec.setdefault(f"time/{phase}", float(dt))
        step_rep = get_accountant().last_step_report
        if step_rep is not None:
            rec.setdefault("comm/bytes", step_rep["bytes"])
            rec.setdefault("comm/calls", step_rep["calls"])
        self.writer.write(rec, kind="step")
        if self.prometheus_path and it % self.prom_every == 0:
            write_prometheus_textfile(self.prometheus_path)

    def __call__(self, trainer) -> None:
        pass

    def finalize(self) -> None:
        try:
            self.writer.write(
                health_snapshot(self._trainer, self.monitor),
                kind="summary")
            if self.prometheus_path:
                write_prometheus_textfile(self.prometheus_path)
        finally:
            self.writer.close()

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass
