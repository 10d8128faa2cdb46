"""HTTP service backing the four demo capabilities.

A copy of cross_modal_video_engine_tpu/service/app.py; `DEMO_DIR` holds
byte-for-byte copies of its static demo pages (service/demo/).

The reference web demo (Video-engine-web/) is static Bootstrap pages with
hard-coded results — no live backend (SURVEY §0).  This service is the
missing backend: a stdlib http.server JSON API with one endpoint per
capability:

  POST /retrieval           {"query": str, "topK": int}
  POST /composed_retrieval  {"reference_video": str, "text": str, "topK"}
  POST /caption             {"video": str}
  POST /explain             {"video": str, "topK": int}
  GET  /health

Handlers are injected as callables, so the service layer is independent
of which models are loaded (see cli/serve.py for wiring).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional


class UnknownRoute(KeyError):
    """Raised by dispatch for an unregistered route — distinct from
    KeyErrors raised INSIDE a handler (e.g. a missing payload field),
    which must surface as handler errors, not 404s."""


class EngineService:
    """Callable registry for the four capabilities, with per-route
    request counters and latency percentiles on GET /metrics (the
    observability the reference's static demo never had)."""

    def __init__(self):
        self.handlers: Dict[str, Callable[[dict], dict]] = {}
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._errors: Dict[str, int] = {}
        self._lat_ms: Dict[str, list] = {}

    def register(self, route: str, fn: Callable[[dict], dict]) -> None:
        self.handlers[route.strip("/")] = fn

    def metrics(self) -> dict:
        import numpy as np
        with self._lock:
            out = {}
            for route in sorted(self._counts):
                lat = self._lat_ms.get(route, [])
                out[route] = {
                    "requests": self._counts[route],
                    "errors": self._errors.get(route, 0),
                    "latency_ms_p50": (round(float(np.percentile(lat, 50)),
                                             2) if lat else None),
                    "latency_ms_p99": (round(float(np.percentile(lat, 99)),
                                             2) if lat else None),
                }
            return out

    def _record(self, route: str, dt_ms: float, error: bool) -> None:
        with self._lock:
            self._counts[route] = self._counts.get(route, 0) + 1
            if error:
                self._errors[route] = self._errors.get(route, 0) + 1
            buf = self._lat_ms.setdefault(route, [])
            buf.append(dt_ms)
            del buf[:-1000]          # keep the last 1000 samples

    def dispatch(self, route: str, payload: dict) -> dict:
        import time
        route = route.strip("/")
        if route == "health":
            return {"status": "ok",
                    "routes": sorted(self.handlers)}
        if route == "metrics":
            return self.metrics()
        if route not in self.handlers:
            raise UnknownRoute(route)
        t0 = time.perf_counter()
        try:
            out = self.handlers[route](payload)
        except Exception:
            self._record(route, (time.perf_counter() - t0) * 1e3, True)
            raise
        self._record(route, (time.perf_counter() - t0) * 1e3, False)
        return out


DEMO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo")
_DEMO_TYPES = {".html": "text/html; charset=utf-8",
               ".css": "text/css; charset=utf-8",
               ".js": "application/javascript; charset=utf-8"}


def create_server(service: EngineService, host: str = "127.0.0.1",
                  port: int = 8765,
                  demo_dir: Optional[str] = None) -> ThreadingHTTPServer:
    """HTTP server over the service routes.  With ``demo_dir`` set
    (cli/serve.py --demo), GET /demo/<page> serves the static UI pages
    that drive the JSON routes — the live counterpart of the
    reference's Video-engine-web/{retrieval,composed_retrieval,caption,
    explainable}.html mocks."""
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_file(self, name: str):
            # flat directory only: a separator or updir in the name is
            # a traversal attempt, not a page
            if "/" in name or "\\" in name or ".." in name:
                self._send(404, {"error": "not found"})
                return
            ext = os.path.splitext(name)[1]
            path = os.path.join(demo_dir, name)
            if ext not in _DEMO_TYPES or not os.path.isfile(path):
                self._send(404, {"error": f"no demo page {name}"})
                return
            with open(path, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", _DEMO_TYPES[ext])
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            route = self.path.split("?", 1)[0].strip("/")
            if route in ("health", "metrics"):
                self._send(200, service.dispatch(route, {}))
            elif demo_dir and route in ("", "demo"):
                self._send_file("index.html")
            elif demo_dir and route.startswith("demo/"):
                self._send_file(route[len("demo/"):])
            elif demo_dir and route.endswith((".html", ".css", ".js")):
                # pages cross-link relatively (retrieval.html etc.)
                self._send_file(route)
            else:
                self._send(404, {"error": f"unknown route {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                result = service.dispatch(self.path, payload)
                self._send(200, result)
            except UnknownRoute:
                self._send(404, {"error": f"unknown route {self.path}"})
            except KeyError as e:   # missing payload field in a handler
                self._send(400, {"error": f"missing field {e}"})
            except Exception as e:  # surface handler errors as 500 JSON
                self._send(500, {"error": str(e)})

        def log_message(self, fmt, *args):  # quiet
            pass

    class Server(ThreadingHTTPServer):
        # a micro-batched wave is max_batch concurrent connections
        # arriving within max_wait_ms; the stdlib default backlog of 5
        # resets the overflow (ConnectionResetError at the client)
        request_queue_size = 128

    return Server((host, port), Handler)


def serve_in_thread(service: EngineService, host: str = "127.0.0.1",
                    port: int = 8765, demo_dir: Optional[str] = None):
    server = create_server(service, host, port, demo_dir=demo_dir)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t
