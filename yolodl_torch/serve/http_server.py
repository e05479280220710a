"""Stdlib HTTP front-end for :class:`DetectionService` (counterpart of
``yolodl_tpu/serve/http_server.py``, same endpoints).

Endpoints:

- ``POST /detect``   — body = encoded image (JPEG/PNG/...); response
  ``{"detections": [...], "latency_ms": N}``.
- ``GET /healthz``   — liveness; ``{"ok": true}`` once warm.
- ``GET /stats``     — service counters + latency quantiles.

ThreadingHTTPServer gives one thread per in-flight request, so image
decode/letterbox parallelize on the host while the service's single
dispatcher thread owns the device.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .service import DetectionService, ServiceOverloadedError

MAX_BODY = 32 * 1024 * 1024  # 32 MB: generous for any single photograph


def make_http_server(service: DetectionService, host: str = "127.0.0.1",
                     port: int = 8650) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send_json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._send_json(200, {"ok": True})
            elif self.path == "/stats":
                self._send_json(200, service.stats.snapshot(service.batch_size))
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/detect":
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > MAX_BODY:
                self._send_json(400, {"error": "missing or oversized body"})
                return
            data = self.rfile.read(length)
            t0 = time.perf_counter()
            try:
                dets = service.submit_bytes(data)
            except ServiceOverloadedError as e:
                self._send_json(503, {"error": str(e)})
                return
            except TimeoutError as e:
                self._send_json(504, {"error": str(e)})
                return
            except (OSError, ValueError, SyntaxError) as e:
                # PIL raises these for undecodable/corrupt image bodies —
                # the client's fault
                self._send_json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:  # device/runtime fault — server's fault
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_json(200, {
                "detections": dets,
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 2),
            })

        def log_message(self, fmt, *args):  # quiet per-request stderr spam
            pass

    return ThreadingHTTPServer((host, port), Handler)
