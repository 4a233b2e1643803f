"""HTTP model server over :class:`~.serving.Predictor`
(``msha_gnn_tpu/server.py``: same routes, limits and lock).

One process owns the card; request threads funnel into the one cached
full-score matrix, and a coarse lock serialises device work so tail
latency stays predictable.  Stdlib ``ThreadingHTTPServer`` only.

Routes::

    GET  /healthz            -> {"status": "ok"}
    GET  /v1/metadata        -> model/year/shape/checkpoint info
    POST /v1/predict         -> {"nodes": [..], "k": 5} -> per-node top-k
    POST /v1/scores          -> {"nodes": [..]} -> raw [n, M] log-probs
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from .serving import Predictor

MAX_BODY = 8 << 20  # 8 MB request cap
MAX_NODES = 65536   # per-request node cap


class ModelService:
    """The servable unit: a Predictor + metadata + a device lock."""

    def __init__(self, predictor: Predictor, *, n_src: int,
                 class_names: Optional[Dict[int, str]] = None,
                 metadata: Optional[dict] = None):
        self.predictor = predictor
        self.n_src = n_src
        self.class_names = class_names
        self.metadata = dict(metadata or {})
        self.metadata.setdefault("n_src", n_src)
        self._lock = threading.Lock()
        self._requests = 0

    def _validate(self, nodes) -> np.ndarray:
        if not isinstance(nodes, list) or not nodes:
            raise ValueError("'nodes' must be a non-empty list of ints")
        if len(nodes) > MAX_NODES:
            raise ValueError(f"too many nodes (max {MAX_NODES})")
        arr = np.asarray(nodes)
        if arr.dtype.kind not in "iu":
            raise ValueError("'nodes' must be integers")
        if arr.min() < 0 or arr.max() >= self.n_src:
            raise ValueError(f"node index out of range [0, {self.n_src})")
        return arr.astype(np.int32)

    def predict(self, nodes, k: int = 5) -> list:
        arr = self._validate(nodes)
        k = max(1, min(int(k), 1024))
        with self._lock:
            self._requests += 1
            return self.predictor.top_k(arr, k=k,
                                        class_names=self.class_names)

    def scores(self, nodes) -> list:
        arr = self._validate(nodes)
        with self._lock:
            self._requests += 1
            return self.predictor.log_scores(arr).tolist()

    def info(self) -> dict:
        return {**self.metadata, "requests_served": self._requests,
                "batch_size": self.predictor.batch_size,
                "cached_full_scores": self.predictor._full is not None}


class _Handler(BaseHTTPRequestHandler):
    service: ModelService  # injected via type() subclassing in make_server()

    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _send(self, code: int, payload: dict | list) -> None:
        body = json.dumps(payload, ensure_ascii=False).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            self._send(200, {"status": "ok"})
        elif self.path == "/v1/metadata":
            self._send(200, self.service.info())
        else:
            self._send(404, {"error": f"no route {self.path!r}"})

    def do_POST(self):  # noqa: N802
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0 or length > MAX_BODY:
            return self._send(400, {"error": "missing or oversized body"})
        try:
            req = json.loads(self.rfile.read(length))
        except json.JSONDecodeError as e:
            return self._send(400, {"error": f"bad JSON: {e}"})
        if not isinstance(req, dict):
            return self._send(400, {"error": "body must be a JSON object"})
        try:
            if self.path == "/v1/predict":
                out = self.service.predict(req.get("nodes"),
                                           k=req.get("k", 5))
                return self._send(200, {"results": out})
            if self.path == "/v1/scores":
                out = self.service.scores(req.get("nodes"))
                return self._send(200, {"log_scores": out})
        except (TypeError, ValueError) as e:
            return self._send(400, {"error": str(e)})
        self._send(404, {"error": f"no route {self.path!r}"})


def make_server(service: ModelService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Bind (port=0 picks a free port) without blocking; the caller runs
    ``serve_forever`` (or a thread — see :func:`serve`)."""
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve(service: ModelService, host: str = "127.0.0.1", port: int = 8000,
          *, log=None) -> None:
    httpd = make_server(service, host, port)
    if log:
        log({"event": "serving", "host": host,
             "port": httpd.server_address[1]})
    print(f"serving on http://{host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def run_serve(cfg, host: str, port: int, batch_size: int = 1024,
              warm: bool = True, device="cuda") -> None:
    """CLI glue: restore ``cfg.checkpoint_dir`` and serve it over HTTP."""
    from .serving import recipient_names, restore_predictor

    predictor, fg, step = restore_predictor(cfg, batch_size, device)
    service = ModelService(
        predictor, n_src=fg.n_src,
        class_names=recipient_names(cfg.data_dir, cfg.year),
        metadata={"model": cfg.model, "year": cfg.year,
                  "checkpoint_step": int(step), "n_dst": fg.n_dst},
    )
    if warm:  # fill the score cache before accepting traffic
        service.predict([0], k=1)
    serve(service, host, port)
