"""Serve a preprocessed dataset over HTTP, and read one back.

Port of ``rave_tpu/data/remote.py`` (the reference's Flask
``remote_dataset`` server and ``HTTPAudioDataset``), on the standard
library: ``GET /len`` answers JSON ``{"len", "n_signal", "sr"}``, ``GET
/get/<i>`` item ``i`` as raw little-endian int16 samples with its speaker
id in the ``X-Speaker`` header; anything else is 404.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def serve_dataset(dataset, host: str = "0.0.0.0", port: int = 8080
                  ) -> ThreadingHTTPServer:
    """Serve ``dataset`` (an ``AudioDataset``) from a daemon thread;
    returns the server (``shutdown()`` then ``server_close()`` it)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, ctype: str, **headers) -> None:
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/len":
                self._send(json.dumps({"len": len(dataset),
                                       "n_signal": dataset.n_signal,
                                       "sr": dataset.sr}).encode(),
                           "application/json")
                return
            if self.path.startswith("/get/"):
                try:
                    item = dataset[int(self.path.split("/")[-1])]
                except (ValueError, IndexError):
                    item = None
                if item is not None:
                    x = np.clip(item["x"], -1, 1)
                    self._send((x * 32767).astype("<i2").tobytes(),
                               "application/octet-stream",
                               **{"X-Speaker": str(int(item["speaker"]))})
                    return
            self.send_response(404)
            self.end_headers()

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


class HTTPAudioDataset:
    """A dataset read from :func:`serve_dataset` at ``host`` (a base URL
    such as ``http://localhost:8080``): items ``{"x": float32 samples,
    "speaker": int32}``, the int16 samples divided by 32768."""

    def __init__(self, host: str):
        self.host = host.rstrip("/")
        with urllib.request.urlopen(f"{self.host}/len", timeout=30) as r:
            meta = json.loads(r.read())
        self._len = meta["len"]
        self.n_signal = meta["n_signal"]
        self.sr = meta["sr"]

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i: int) -> dict:
        with urllib.request.urlopen(f"{self.host}/get/{i}", timeout=30) as r:
            raw = r.read()
            spk = int(r.headers.get("X-Speaker", 0))
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        return dict(x=x, speaker=np.int32(spk))
