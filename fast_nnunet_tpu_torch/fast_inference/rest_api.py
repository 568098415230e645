"""REST API for the fast-inference module — the port of
fast_nnunet_tpu/fast_inference/rest_api.py, the same endpoints, status
codes, JSON bodies and headers (stdlib http.server, no web framework).

Endpoints:
- GET  /health              -> {"status": "ok"}
- GET  /model_info          -> loaded model metadata
- POST /predict             -> {"input_file", "output_file", options...}
  (paths are server-local; medical volumes are too big for request bodies,
  the contract of the reference CLI's predict-single)
- POST /predict_batch       -> {"input_folder", "output_folder", options...}
- POST /predict_array       -> raw float32 LE volume body, X-Shape: "nx,ny,nz";
  responds with raw float32 logits (num_class * nx * ny * nz) and
  X-Num-Class. The wire format is byte-compatible with the JAX server's, so
  the C++ engine's HTTP backend (engine/src/http_backend.cpp) talks to
  either.

Handlers run in the server's threads; one lock keeps the device work (upload
to D2H, and the host steps of a file request) to one request at a time.
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .inferencer import FastnnUNetInferencer


class FastnnUNetAPI:
    def __init__(self, inferencer: FastnnUNetInferencer, host: str = "0.0.0.0",
                 port: int = 8000, debug: bool = False):
        self.inferencer = inferencer
        self.host = host
        self.port = port
        self.debug = debug
        self._server: Optional[ThreadingHTTPServer] = None
        self._lock = threading.Lock()  # one prediction at a time on the device

    def _make_handler(self):
        api = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                if api.debug:
                    super().log_message(fmt, *args)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "ok"})
                elif self.path == "/model_info":
                    self._send(200, api.inferencer.get_model_info())
                else:
                    self._send(404, {"error": f"unknown endpoint {self.path}"})

            def do_POST(self):
                if self.path == "/predict_array":
                    self._predict_array()
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": f"bad request body: {e}"})
                    return
                try:
                    if self.path == "/predict":
                        with api._lock:
                            result = api.inferencer.predict_single_image(
                                req["input_file"], req["output_file"],
                                save_probabilities=req.get("save_probabilities",
                                                           False),
                                largest_component_postprocessing=req.get(
                                    "postprocessing", False),
                                generate_vtk=req.get("generate_vtk", False),
                                vtk_output_file=req.get("vtk_output_file"),
                                smoothing_factor=req.get("smoothing_factor", 0.5),
                                decimation_factor=req.get("decimation_factor", 0.2))
                        self._send(200, result)
                    elif self.path == "/predict_batch":
                        with api._lock:
                            results = api.inferencer.predict_batch(
                                req["input_folder"], req["output_folder"])
                        self._send(200, {"results": results})
                    else:
                        self._send(404, {"error": f"unknown endpoint {self.path}"})
                except KeyError as e:
                    self._send(400, {"error": f"missing field {e}"})
                except Exception as e:  # surface prediction errors as 500s
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def _predict_array(self):
                try:
                    shape = tuple(int(x) for x in
                                  self.headers["X-Shape"].split(","))
                    length = int(self.headers["Content-Length"])
                    body = self.rfile.read(length)
                    vol = np.frombuffer(body, np.float32).reshape(shape)
                except (AttributeError, KeyError, ValueError) as e:
                    self._send(400, {"error": f"bad array request: {e}"})
                    return
                try:
                    with api._lock:
                        logits = api.inferencer.predict_logits_from_preprocessed(
                            vol[None])  # add channel dim
                    payload = np.ascontiguousarray(logits, np.float32).tobytes()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(payload)))
                    self.send_header("X-Num-Class", str(logits.shape[0]))
                    self.end_headers()
                    self.wfile.write(payload)
                except Exception as e:
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler

    def run(self, blocking: bool = True):
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self._make_handler())
        print(f"FastnnUNet API serving on {self.host}:{self.port}")
        if blocking:
            self._server.serve_forever()
        else:
            t = threading.Thread(target=self._server.serve_forever, daemon=True)
            t.start()
            return t

    def shutdown(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
