"""The port's live introspection server vs the JAX package's.

``observability/introspect.py`` is a copy: a ``StatusServer`` of each
package, over the same flight providers, the same extra gauges and the
same request table, is scraped over HTTP on a free port.  ``/statusz``,
``/requestz`` and ``/debugz`` (with and without a dump) answer JSON with
JAX's keys, ``/metricsz`` the Prometheus exposition with JAX's series
names, ``/healthz`` ``ok``, an unknown path 404 with JAX's endpoint list,
and a provider that raises leaves the server up (500, then the next
scrape answers).  A serving engine's ``/statusz`` carries its ``serving``
provider.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

from chainermn_tpu import observability as jobs
from chainermn_tpu.observability import flight as jflight
from chainermn_tpu_torch import observability as tobs
from chainermn_tpu_torch.observability import flight as tflight


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _series(text):
    return sorted({line.split("{")[0].split(" ")[0]
                   for line in text.splitlines()
                   if line and not line.startswith("#")})


def _scrape(obs, flight, tmp_path):
    flight.register_provider("queue", lambda: {"depth": 3, "slots": [1, 2]})
    flight.register_provider("trainer", lambda: {"iteration": 7})
    flight.note("phase", name="serve/step")
    srv = obs.StatusServer(
        0, extra_gauges=lambda: {"serving/tokens_total": 12.0,
                                 "router/dispatched_total": 4.0},
        requests_fn=lambda: {"schema": "chainermn_tpu.requestz.v1",
                             "queued": [], "running": [{"id": 1}],
                             "recent": []},
        dump_dir=str(tmp_path), rank=0).start()
    try:
        out = {path: _get(srv.port, path) for path in (
            "/statusz", "/metricsz", "/requestz", "/debugz", "/healthz",
            "/nope", "/debugz?dump=1")}
    finally:
        srv.stop()
        for name in ("queue", "trainer"):
            flight.unregister_provider(name)
    assert srv.port is None                   # stopped
    return out


def test_endpoints_payload_keys_equal_jax(tmp_path):
    got = _scrape(tobs, tflight, tmp_path / "torch")
    want = _scrape(jobs, jflight, tmp_path / "jax")
    for path in ("/statusz", "/requestz", "/debugz", "/nope",
                 "/debugz?dump=1"):
        (gs, gt, gb), (ws, wt, wb) = got[path], want[path]
        assert (gs, gt) == (ws, wt), path
        g, w = json.loads(gb), json.loads(wb)
        assert set(g) == set(w), path
        if path == "/statusz":
            assert g["schema"] == w["schema"] == "chainermn_tpu.statusz.v1"
            assert set(g["providers"]) >= {"queue", "trainer"}
            assert g["providers"]["queue"] == w["providers"]["queue"]
            assert set(g["flight_ring"]) == set(w["flight_ring"])
            assert g["rank"] == 0 and g["last_phase"] == "serve/step"
        elif path == "/requestz":
            assert g == w
        elif path == "/nope":
            assert gs == 404 and g["endpoints"] == w["endpoints"]
        elif path == "/debugz?dump=1":
            assert g["bundle"] and g["bundle"] == g["last_bundle"]
    (gs, gt, gb), (ws, wt, wb) = got["/metricsz"], want["/metricsz"]
    assert (gs, gt) == (ws, wt) == (200, "text/plain; version=0.0.4")
    names = _series(gb)
    assert {"chainermn_tpu_serving_tokens_total",
            "chainermn_tpu_router_dispatched_total"} <= set(names)
    assert set(names) & set(_series(wb)) >= {
        "chainermn_tpu_serving_tokens_total",
        "chainermn_tpu_router_dispatched_total"}
    assert got["/healthz"] == want["/healthz"] == (200, "text/plain",
                                                   "ok\n")


def test_a_raising_provider_is_a_500_not_a_dead_server():
    srv = tobs.start_status_server(0, requests_fn=lambda: 1 / 0)
    try:
        status, _, body = _get(srv.port, "/requestz")
        assert status == 500 and "ZeroDivisionError" in json.loads(
            body)["error"]
        assert _get(srv.port, "/healthz")[0] == 200
    finally:
        srv.stop()


def test_serving_engine_statusz_carries_its_provider():
    from chainermn_tpu_torch.parallel import init_tp_transformer_lm
    from chainermn_tpu_torch.serving import ServingEngine

    params = init_tp_transformer_lm(torch.Generator().manual_seed(0), 32,
                                    16, 4, 1, max_len=16, device="cpu")
    eng = ServingEngine(params, head_dim=4, n_slots=2, max_total=16,
                        device="cpu")
    srv = tobs.start_status_server(0, extra_gauges=eng.metrics,
                                   requests_fn=eng.requests_table)
    try:
        h = eng.submit([1, 2, 3], 3)
        eng.run(steps_budget=20)
        assert h.status == "done"
        st = json.loads(_get(srv.port, "/statusz")[2])
        assert "serving" in st["providers"]
        req = json.loads(_get(srv.port, "/requestz")[2])
        assert [r["trace_id"] for r in req["recent"]] == [h.trace_id]
        assert "chainermn_tpu_serving_tokens_total" in _series(
            _get(srv.port, "/metricsz")[2])
    finally:
        srv.stop()
        eng.close()
