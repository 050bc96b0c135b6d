"""Live introspection: a stdlib HTTP thread serving /statusz et al.

Counterpart of ``chainermn_tpu/observability/introspect.py``, a copy.  The
flight recorder explains a *death*, the metrics stream a *trend*, and this
module answers "what is it doing RIGHT NOW" while the process is alive,
from ``curl``:

* ``/statusz``: JSON with uptime, pid / rank, the current phase (the
  innermost open span), tracing state, and every registered flight
  provider's snapshot (serving queue / slot state, the fleet's health and
  autoscaler view, the trainer's position, SLO status).
* ``/metricsz``: Prometheus text exposition (``export.prometheus_text``
  plus an extra-gauge callback), scrape-ready.
* ``/requestz``: JSON, the live and recently finished serving requests
  with their trace ids and phase timestamps.
* ``/debugz``: GET shows the last bundle; ``/debugz?dump=1`` dumps a fresh
  debug bundle (``flight.dump_bundle``) and returns its path.
* ``/healthz``: 200 "ok".

Wired behind ``--statusz-port`` in ``chainermn_tpu_torch.train`` and
``chainermn_tpu_torch.serve``; binds 127.0.0.1 by default.  Port 0 picks a
free port; the chosen port is on ``StatusServer.port``.  ``/metricsz``
also carries the reshard schedule profiler's ``schedule_exec/*`` counters
(``comm.schedule_exec_gauges``) once a scheduled reshard has run.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from . import flight as _flight
from . import trace


class StatusServer:
    """Background HTTP introspection endpoint (daemon thread).

    ``extra_gauges``: callable returning a flat dict merged into
    ``/metricsz`` (the serving engine passes its ``metrics()``).
    ``requests_fn``: callable returning the ``/requestz`` payload (the
    serving frontend registers its live+recent request table).
    ``dump_dir``: where ``/debugz?dump=1`` writes bundles (defaults to
    the flight module's crash dump dir at request time).
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 extra_gauges: Optional[Callable[[], Dict[str, float]]] = None,
                 requests_fn: Optional[Callable[[], Any]] = None,
                 dump_dir: Optional[str] = None,
                 rank: Optional[int] = None):
        self.extra_gauges = extra_gauges
        self.requests_fn = requests_fn
        self.dump_dir = dump_dir
        self.rank = rank
        self._t0 = time.time()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._host = host
        self._requested_port = int(port)

    # ---- payload builders (also unit-testable without a socket) ----
    def statusz(self) -> Dict[str, Any]:
        tr = trace.get_tracer()
        rec = _flight.get_flight_recorder()
        last_phase = rec.last("phase")
        payload: Dict[str, Any] = {
            "schema": "chainermn_tpu.statusz.v1",
            "t": round(time.time(), 3),
            "uptime_s": round(time.time() - self._t0, 3),
            "pid": os.getpid(),
            "rank": self.rank,
            "tracing_enabled": tr.enabled,
            "current_span": tr.current_span(),
            "last_phase": (last_phase or {}).get("name"),
            "flight_ring": {"events": len(rec.events()),
                            "capacity": rec.capacity,
                            "total_seen": rec.total_seen},
            "providers": _flight.provider_snapshots(),
        }
        return payload

    def metricsz(self) -> str:
        from .export import prometheus_text
        extra = None
        if self.extra_gauges is not None:
            try:
                extra = self.extra_gauges()
            except Exception:
                extra = None
        # flight-ring loss accounting rides every exposition: a dropped
        # event is missing evidence, and /metricsz is where a scrape
        # learns the ring overflowed
        dropped = _flight.get_flight_recorder().dropped_counts()
        if dropped:
            extra = dict(extra or {})
            for kind, n in sorted(dropped.items()):
                extra[f"flight/dropped/{kind}"] = float(n)
        # schedule-execution truth counters: per-link ops/bytes/wall
        # measured by the reshard profiler
        from .comm import schedule_exec_gauges
        sched = schedule_exec_gauges()
        if sched:
            extra = dict(extra or {})
            extra.update(sched)
        return prometheus_text(extra)

    def requestz(self) -> Any:
        if self.requests_fn is None:
            return {"requests": [], "note": "no request source registered"}
        return self.requests_fn()

    def debugz(self, dump: bool = False) -> Dict[str, Any]:
        out: Dict[str, Any] = {"last_bundle": _flight.last_bundle()}
        if dump:
            d = self.dump_dir or _flight.crash_dump_dir()
            if d is None:
                out["error"] = ("no dump dir configured (pass dump_dir "
                                "or flight.set_crash_dump_dir)")
            else:
                bundle = _flight.dump_bundle(d, "debugz", rank=self.rank)
                if bundle is None:
                    out["error"] = "bundle dump failed (see stderr)"
                else:
                    out["bundle"] = bundle
                    out["last_bundle"] = bundle
        return out

    # ---- lifecycle ----
    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def start(self) -> "StatusServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no stderr chatter per scrape
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200) -> None:
                body = json.dumps(obj, indent=2, default=str,
                                  sort_keys=True).encode()
                self._send(code, body, "application/json")

            def do_GET(self) -> None:  # noqa: N802 (stdlib contract)
                url = urlparse(self.path)
                try:
                    if url.path in ("/statusz", "/", "/statusz/"):
                        self._json(server.statusz())
                    elif url.path == "/metricsz":
                        self._send(200, server.metricsz().encode(),
                                   "text/plain; version=0.0.4")
                    elif url.path == "/requestz":
                        self._json(server.requestz())
                    elif url.path == "/debugz":
                        q = parse_qs(url.query)
                        dump = q.get("dump", ["0"])[0] in ("1", "true")
                        self._json(server.debugz(dump=dump))
                    elif url.path == "/healthz":
                        self._send(200, b"ok\n", "text/plain")
                    else:
                        self._json({"error": "not found", "endpoints": [
                            "/statusz", "/metricsz", "/requestz",
                            "/debugz", "/healthz"]}, code=404)
                except Exception as e:  # a broken provider ≠ a dead server
                    self._json({"error": repr(e)}, code=500)

        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="chainermn-tpu-torch-statusz",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def start_status_server(port: int, **kwargs) -> StatusServer:
    """One-call CLI face: build + start, log the bound port."""
    import sys
    srv = StatusServer(port, **kwargs).start()
    print(f"[chainermn_tpu_torch statusz] serving on "
          f"http://127.0.0.1:{srv.port}/statusz", file=sys.stderr,
          flush=True)
    return srv
