"""Black-box flight recorder: bounded event ring + crash debug bundles.

Counterpart of ``chainermn_tpu/observability/flight.py``.  What the
tracer records lives in memory and dies with the process, so a Watchdog
abort, an uncaught exception or a SIGTERM from the scheduler would leave
nothing to explain the death.  This module is the black box that
survives it:

* **Ring buffer** (:class:`FlightRecorder`) — a bounded, lock-cheap
  deque of recent structured events.  Span closes and instants tee in
  through a tracer sink (:func:`install_tracer_tee`); the Trainer's
  phases, the lanes' retries and faults, the checkpointer, the
  preemption handler, the watchdog and the gang note into it.  At
  capacity the oldest events fall off: the ring always holds the LAST
  moments, which is the only part a postmortem needs.

* **Debug bundle** (:func:`dump_bundle`) — an atomic, versioned
  directory snapshot: ring contents, :func:`~.export.health_snapshot`,
  the trace tail, every registered state provider, and the environment
  (torch and CUDA versions, the device name and count, the process
  group's rank and size: where the JAX package reports its backend and
  jit cache).  Written to a temp dir then ``os.rename``\\ d into place,
  so a bundle either exists completely or not at all; the bundle layout
  is the JAX package's, so its ``scripts/explain_bundle.py`` renders
  these bundles too.

* **Triggers** — the Watchdog abort path, the global except hook, and
  :func:`install_signal_handlers` (SIGTERM = dump then die with the
  default disposition; SIGUSR1 = dump and keep running — the live
  "what is it doing" probe).

Stdlib only at import; safe to dump before or without a card.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from . import trace

#: Schema stamp carried by every bundle MANIFEST and ring record.
BUNDLE_SCHEMA = "chainermn_tpu.debug_bundle.v1"

#: Files a COMPLETE bundle always contains (explain_bundle checks this).
BUNDLE_REQUIRED_FILES = (
    "MANIFEST.json", "flight.jsonl", "health.json", "env.json")


class FlightRecorder:
    """Bounded ring of recent structured events (thread-safe, cheap).

    One event = one dict with a monotonically increasing ``seq``, a
    wall-clock stamp, a ``kind``, and free-form fields.  ``capacity``
    bounds memory hard; total-seen minus retained = dropped-from-head,
    reported in the bundle manifest so a reader knows how far back the
    record goes.
    """

    DEFAULT_CAPACITY = 4096

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped: Dict[str, int] = {}
        self.enabled = True

    def record(self, kind: str, **fields) -> None:
        """Append one event; never raises, never blocks beyond the one
        ring lock (the hot-path contract: emitters call this inline)."""
        if not self.enabled:
            return
        ev = {"kind": str(kind), "t": round(time.time(), 6)}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) == self.capacity:
                # the deque is about to evict its head silently: count
                # the loss PER EMITTER KIND so a postmortem knows whose
                # evidence fell off
                evicted = self._ring[0].get("kind", "?")
                self._dropped[evicted] = self._dropped.get(evicted, 0) + 1
            self._ring.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    @property
    def total_seen(self) -> int:
        with self._lock:
            return self._seq

    def dropped_counts(self) -> Dict[str, int]:
        """Events dropped from the ring head, per kind — the
        ``flight/dropped/*`` gauges and the bundle MANIFEST's loss
        accounting."""
        with self._lock:
            return dict(self._dropped)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._dropped = {}

    def last(self, kind: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Most recent event (optionally of one ``kind``), or None."""
        with self._lock:
            ring = list(self._ring)
        for ev in reversed(ring):
            if kind is None or ev.get("kind") == kind:
                return ev
        return None


_GLOBAL = FlightRecorder()

#: Named state providers: ``name -> fn() -> JSON-able`` snapshots pulled
#: into every bundle.  Subsystems register at construction (the gang
#: registers its health; the train CLI registers the trainer).
_PROVIDERS: Dict[str, Callable[[], Any]] = {}

#: Where crash-triggered dumps land (except hook / signal handlers).
_CRASH_DUMP_DIR: Optional[str] = None

_LAST_BUNDLE: Optional[str] = None
_tee_installed = False

#: A callable every module-level note tees into, when set (the JAX
#: package's causal journal registers here; the journal is ROADMAP.md's
#: A12).  note() stays one attribute load + None check without it.
_JOURNAL_TEE: Optional[Callable[[str, Dict[str, Any]], None]] = None


def set_journal_tee(fn: Optional[Callable[[str, Dict[str, Any]], None]]
                    ) -> None:
    global _JOURNAL_TEE
    _JOURNAL_TEE = fn


def get_flight_recorder() -> FlightRecorder:
    return _GLOBAL


def note(kind: str, **fields) -> None:
    """Module-level convenience over the global ring."""
    _GLOBAL.record(kind, **fields)
    tee = _JOURNAL_TEE
    if tee is not None:
        tee(kind, fields)


def register_provider(name: str, fn: Callable[[], Any]) -> None:
    """Register (or replace) a named state provider.  ``fn`` must be
    host-side, cheap, and exception-safe enough to call from a crash
    path — a raising provider is recorded as an error string, never
    propagated."""
    _PROVIDERS[str(name)] = fn


def unregister_provider(name: str) -> None:
    _PROVIDERS.pop(name, None)


def provider_snapshots() -> Dict[str, Any]:
    """Every registered provider's current snapshot (errors inline)."""
    out: Dict[str, Any] = {}
    for name, fn in list(_PROVIDERS.items()):
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": repr(e)}
    return out


def set_crash_dump_dir(path: Optional[str]) -> None:
    """Where the except hook / signal handlers drop bundles (None
    disables crash dumping)."""
    global _CRASH_DUMP_DIR
    _CRASH_DUMP_DIR = path


def crash_dump_dir() -> Optional[str]:
    return _CRASH_DUMP_DIR


def last_bundle() -> Optional[str]:
    """Path of the most recent bundle this process dumped, or None."""
    return _LAST_BUNDLE


# ---------------------------------------------------------------------------
# tees from existing emitters
# ---------------------------------------------------------------------------

def _tracer_sink(ev: Dict[str, Any]) -> None:
    kind = {"X": "span", "i": "instant"}.get(ev.get("ph"))
    if kind is None:
        return  # counters/gauges are too hot and live in the snapshot
    rec = {"name": ev.get("name"), "cat": ev.get("cat")}
    if kind == "span":
        rec["dur_us"] = ev.get("dur")
    args = ev.get("args")
    if args:
        rec["args"] = args
    _GLOBAL.record(kind, **rec)


def install_tracer_tee(tracer: Optional[trace.Tracer] = None) -> None:
    """Tee every span close / instant the tracer records into the ring
    (idempotent).  Counters are deliberately excluded: the ring holds
    *moments*; totals come from the health snapshot."""
    global _tee_installed
    tr = tracer or trace.get_tracer()
    tr.add_sink(_tracer_sink)
    _tee_installed = True


def uninstall_tracer_tee(tracer: Optional[trace.Tracer] = None) -> None:
    global _tee_installed
    (tracer or trace.get_tracer()).remove_sink(_tracer_sink)
    _tee_installed = False


# ---------------------------------------------------------------------------
# the debug bundle
# ---------------------------------------------------------------------------

def _env_snapshot() -> Dict[str, Any]:
    """Environment + topology the postmortem reader always asks for
    first.  Env vars are allowlisted by prefix — a bundle may end up in
    a bug report, so secrets must never ride along."""
    prefixes = ("CHAINERMN_", "CUDA_VISIBLE", "NCCL_", "TORCH_",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE",
                "SLURM_JOB", "HOSTNAME")
    env = {k: v for k, v in os.environ.items()
           if any(k.startswith(p) for p in prefixes)}
    snap: Dict[str, Any] = {
        "argv": list(sys.argv),
        "pid": os.getpid(),
        "python": sys.version.split()[0],
        "cwd": os.getcwd(),
        "env": env,
    }
    # Topology only from what is ALREADY initialised: a crash dump must
    # never be the thing that creates a CUDA context or a process group,
    # nor block on a wedged runtime (the Watchdog-abort case).
    torch = sys.modules.get("torch")
    if torch is not None:
        snap["torch_version"] = getattr(torch, "__version__", None)
        snap["cuda_version"] = getattr(torch.version, "cuda", None)
        try:
            if torch.cuda.is_initialized():
                n = torch.cuda.device_count()
                snap["devices"] = {
                    "count": n,
                    "kinds": sorted({torch.cuda.get_device_name(i)
                                     for i in range(n)}),
                    "platform": "gpu",
                }
            else:
                snap["cuda"] = "uninitialized (not probed)"
            dist = torch.distributed
            if dist.is_available() and dist.is_initialized():
                snap["process_index"] = dist.get_rank()
                snap["process_count"] = dist.get_world_size()
        except Exception as e:
            snap["torch_error"] = repr(e)
    return snap


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str, sort_keys=True)


def dump_bundle(out_dir: str, reason: str, *,
                trainer=None, monitor=None,
                rank: Optional[int] = None,
                trace_tail: int = 5000,
                extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Atomically write one versioned debug bundle; returns its path,
    or None when the dump failed (callers must not advertise a
    half-written ``.tmp`` dir as evidence).

    Layout (``BUNDLE_SCHEMA``)::

        <out_dir>/bundle-<utcstamp>-<reason>[-rankN]/
            MANIFEST.json     schema, reason, stamps, file list, drops
            flight.jsonl      the ring, oldest first, one event per line
            health.json       export.health_snapshot (+ monitor findings)
            trace_tail.json   last ``trace_tail`` tracer events as a
                              loadable Chrome-trace doc (when tracing on)
            providers.json    every registered state provider's snapshot
            env.json          argv, allowlisted env, torch / CUDA
                              versions, devices, process group

    The directory is assembled under a ``.tmp`` name and renamed into
    place, so a reader never sees a half-written bundle; a crashing dump
    leaves only the temp dir.  Never raises — the dump path runs inside
    abort handlers where a second failure must not mask the first.
    """
    global _LAST_BUNDLE
    t = time.time()
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(t))
    safe_reason = "".join(c if c.isalnum() or c in "-_" else "_"
                          for c in str(reason)) or "unknown"
    name = f"bundle-{stamp}-{safe_reason}"
    if rank is not None:
        name += f"-rank{int(rank):05d}"
    final = os.path.join(out_dir, name)
    # two dumps in the same second (SIGTERM races the watchdog) must not
    # collide: suffix with the pid + a counter
    n = 0
    while os.path.exists(final):
        n += 1
        final = os.path.join(out_dir, f"{name}.{n}")
    tmp = f"{final}.tmp-{os.getpid()}"
    try:
        os.makedirs(tmp, exist_ok=True)
        files: List[str] = []

        events = _GLOBAL.events()
        with open(os.path.join(tmp, "flight.jsonl"), "w") as f:
            for ev in events:
                f.write(json.dumps(ev, sort_keys=True, default=str) + "\n")
        files.append("flight.jsonl")

        from . import export as _export
        try:
            health = _export.health_snapshot(trainer, monitor=monitor)
        except Exception as e:
            health = {"error": repr(e)}
        _write_json(os.path.join(tmp, "health.json"), health)
        files.append("health.json")

        tr = trace.get_tracer()
        if tr.enabled:
            tail = tr.events()[-int(trace_tail):]
            _write_json(os.path.join(tmp, "trace_tail.json"),
                        {"traceEvents": tail, "displayTimeUnit": "ms"})
            files.append("trace_tail.json")

        providers = provider_snapshots()
        if providers:
            _write_json(os.path.join(tmp, "providers.json"), providers)
            files.append("providers.json")

        _write_json(os.path.join(tmp, "env.json"), _env_snapshot())
        files.append("env.json")

        manifest: Dict[str, Any] = {
            "schema": BUNDLE_SCHEMA,
            "reason": str(reason),
            "t": round(t, 3),
            "utc": stamp,
            "pid": os.getpid(),
            "rank": rank,
            "files": sorted(files + ["MANIFEST.json"]),
            "ring_events": len(events),
            "ring_capacity": _GLOBAL.capacity,
            "ring_dropped_from_head": max(
                _GLOBAL.total_seen - len(events), 0),
            "ring_dropped_by_kind": _GLOBAL.dropped_counts(),
        }
        if extra:
            manifest["extra"] = extra
        _write_json(os.path.join(tmp, "MANIFEST.json"), manifest)
        os.rename(tmp, final)
        _LAST_BUNDLE = final
        print(f"[chainermn_tpu_torch flight] debug bundle written: {final}",
              file=sys.stderr, flush=True)
        return final
    except Exception as e:
        print(f"[chainermn_tpu_torch flight] bundle dump FAILED: {e!r} "
              f"(partial remains at {tmp})", file=sys.stderr, flush=True)
        return None


def read_bundle(path: str) -> Dict[str, Any]:
    """Load a bundle directory back into one dict (the tests' reader).  Missing optional files are simply absent;
    missing REQUIRED files raise ``FileNotFoundError``."""
    out: Dict[str, Any] = {"path": path}
    for fname in BUNDLE_REQUIRED_FILES:
        if not os.path.exists(os.path.join(path, fname)):
            raise FileNotFoundError(
                f"bundle {path!r} is incomplete: missing {fname}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        out["manifest"] = json.load(f)
    events = []
    with open(os.path.join(path, "flight.jsonl")) as f:
        for line in f:
            if line.strip():
                try:
                    events.append(json.loads(line))
                except ValueError:
                    pass  # torn tail line: the dump was mid-crash
    out["flight"] = events
    for opt in ("health", "env", "providers", "trace_tail"):
        p = os.path.join(path, f"{opt}.json")
        if os.path.exists(p):
            with open(p) as f:
                out[opt] = json.load(f)
    return out


def find_bundles(out_dir: str) -> List[str]:
    """All complete bundle dirs under ``out_dir``, oldest first."""
    if not os.path.isdir(out_dir):
        return []
    out = []
    for entry in sorted(os.listdir(out_dir)):
        p = os.path.join(out_dir, entry)
        # ".tmp-<pid>" anywhere marks an in-flight/abandoned dump — a
        # killed dump's leftovers must never read as a complete bundle
        if (entry.startswith("bundle-") and ".tmp-" not in entry
                and os.path.isdir(p)
                and os.path.exists(os.path.join(p, "MANIFEST.json"))):
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# triggers
# ---------------------------------------------------------------------------

_prev_handlers: Dict[int, Any] = {}


def _signal_dump(signum, frame) -> None:
    sig = signal.Signals(signum).name
    out = _CRASH_DUMP_DIR
    note("signal", signal=sig)
    if out:
        # Bounded SIDE-THREAD dump (same discipline as the except hook
        # and the Watchdog): the handler may have interrupted the main
        # thread INSIDE a ring/tracer lock, and an inline dump would
        # self-deadlock on that non-reentrant lock — a hang instead of
        # a death.  The join timeout guarantees the process still dies.
        t = threading.Thread(
            target=lambda: dump_bundle(out, f"signal_{sig.lower()}"),
            daemon=True)
        t.start()
        t.join(timeout=10.0)
        if t.is_alive():
            print(f"[chainermn_tpu_torch flight] {sig} bundle dump still "
                  "running after 10s — proceeding to die",
                  file=sys.stderr, flush=True)
    if signum == signal.SIGTERM:
        # die with the default disposition so the parent sees a real
        # SIGTERM death, not a bundle-dumper exit code
        prev = _prev_handlers.get(signum)
        signal.signal(signum, prev if callable(prev)
                      else signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def install_signal_handlers(dump_dir: Optional[str] = None,
                            signals=(signal.SIGTERM,
                                     signal.SIGUSR1)) -> None:
    """SIGTERM: dump a bundle, then die with the default disposition.
    SIGUSR1: dump and keep running (the poor man's /debugz).  Main
    thread only (CPython restriction); ``dump_dir`` defaults to the
    configured crash dump dir."""
    if dump_dir is not None:
        set_crash_dump_dir(dump_dir)
    for sig in signals:
        cur = signal.getsignal(sig)
        if cur is not _signal_dump:
            # idempotent: never record OURSELVES as the previous
            # handler, or SIGTERM would re-dispatch to _signal_dump
            # forever instead of dying
            _prev_handlers[sig] = cur
        signal.signal(sig, _signal_dump)


def dump_on_crash(exc_type, exc_value) -> Optional[str]:
    """Best-effort bundle from an exception-abort path (the global
    except hook calls this before killing the gang)."""
    out = _CRASH_DUMP_DIR
    if not out:
        return None
    note("crash", exc_type=getattr(exc_type, "__name__", str(exc_type)),
         exc=repr(exc_value))
    return dump_bundle(out, "uncaught_exception")
