"""Local HTTP front end for a ReconstructionEngine or a
CineReconstructionEngine (duck-typed; standard library and numpy only).

Port of inverseproblemwithdiffusionmodel_tpu/serving/server.py, with the
same protocol (binary npz in, binary npz out, no pickle anywhere):

  GET  /healthz       -> 200 JSON {"status": "ok", ...engine stats}
  GET  /spec          -> 200 JSON engine spec
  POST /reconstruct   -> body: npz with arrays
                           y_re, y_im              (required; k-space pair,
                                                    (coils, [T,] H, W))
                           mask, sens_re, sens_im  (optional overrides; a
                                                    cine mask per frame)
                           seg_label               (optional (H, W) int map,
                                                    seg-guided engines only)
                         query: ?seed=0&lr_scaled=5.0&seg_lamda=1.0
                         response: npz {mean_re, mean_im, mean_mag, std_mag,
                         x_re, x_im} + X-Latency-S / X-Chain-Steps-Per-S
                         headers
  400 on a missing array or a bad value, 404 on any other path.

Requests run on the server's threads and serialize on the engine's lock;
the threading server keeps /healthz responsive while a reconstruction
runs. This is a loopback/cluster-internal service (no TLS, no auth) that
sits behind whatever ingress the deployment provides.
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np

from .cine import CineReconstructionEngine
from .engine import ReconstructionEngine

Engine = Union[ReconstructionEngine, CineReconstructionEngine]


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        # quiet by default; the engine tracks request stats
        def log_message(self, fmt, *args):
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok", **engine.stats()})
            elif path == "/spec":
                self._json(200, engine.stats()["spec"])
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/reconstruct":
                self._json(404, {"error": f"unknown path {url.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                data = np.load(io.BytesIO(self.rfile.read(n)),
                               allow_pickle=False)
                q = parse_qs(url.query)
                kwargs = {}
                for opt in ("mask", "sens_re", "sens_im", "seg_label"):
                    if opt in data.files:
                        kwargs[opt] = data[opt]
                if "lr_scaled" in q:
                    kwargs["lr_scaled"] = float(q["lr_scaled"][0])
                if "seg_lamda" in q:
                    kwargs["seg_lamda"] = float(q["seg_lamda"][0])
                res = engine.reconstruct(
                    data["y_re"], data["y_im"],
                    seed=int(q.get("seed", ["0"])[0]), **kwargs)
            except (KeyError, ValueError) as e:
                self._json(400, {"error": str(e)})
                return
            body = _npz_bytes(**res.to_npz_dict())
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Latency-S", f"{res.latency_s:.4f}")
            self.send_header("X-Chain-Steps-Per-S",
                             f"{res.chain_steps_per_s:.2f}")
            self.end_headers()
            self.wfile.write(body)

    return Handler


def serve(engine: Engine, host: str = "127.0.0.1",
          port: int = 8471, *, background: bool = False
          ) -> Optional[ThreadingHTTPServer]:
    """Serve the engine. background=True returns the started server (tests /
    embedding; its `shutdown` and `server_close` stop it); otherwise blocks
    until KeyboardInterrupt."""
    httpd = ThreadingHTTPServer((host, port), make_handler(engine))
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    try:
        print(f"[serve] listening on http://{host}:{httpd.server_address[1]}"
              f" (spec: {engine.spec})", flush=True)
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return None
