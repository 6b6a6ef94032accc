"""HTTP serving front end over the micro-batching runtime (port of ``server.py``).

checkpoint -> :class:`~serving.FusionPredictor`, :class:`~serving.MMBTPredictor` or
:class:`~serving.ViltPredictor` -> :class:`~serving.MicroBatcher` ->
:class:`PredictionServer`, a stdlib ``ThreadingHTTPServer`` that turns
concurrent POSTed samples into coalesced device batches.

Endpoints:

* ``POST /v1/predict``: JSON body decoded by ``decode_request`` into one
  sample; responds ``{"probs": [...]}`` (+ any fields the encoder adds).
  400 on malformed payloads, 413 past ``max_body_bytes``, 503 after close or
  when the batcher's admission queue is full, 500 on predictor failure.
* ``GET /healthz``: liveness + request count.
* ``GET /statz``: request count, error count, mean/max wall latency ms,
  queued requests and the admission bound.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from multimodal_uncertainty_tpu_torch.batching import Overloaded

logger = logging.getLogger(__name__)


def fusion_request(payload: dict):
    """Decode a FusionPredictor sample: {"img": (L_i, D) nested lists,
    "txt": (L_t, D)} -> the (img, txt) tuple fusion_micro_batcher expects."""
    img = np.asarray(payload["img"], np.float32)
    txt = np.asarray(payload["txt"], np.float32)
    if img.ndim != 2 or txt.ndim != 2:
        raise ValueError(
            f"img/txt must be rank-2 (L, D); got {img.shape} / {txt.shape}"
        )
    return img, txt


def mmbt_request(payload: dict):
    """Decode an MMBTPredictor sample: {"token_ids": (L,), "segment": (L,),
    "image": (H, W, 3) pixels} -> the (ids, segment, float32 image) tuple
    mmbt_micro_batcher expects."""
    ids = np.asarray(payload["token_ids"], np.int64)
    segment = np.asarray(payload["segment"], np.int64)
    image = np.asarray(payload["image"], np.float32)
    if ids.ndim != 1 or segment.shape != ids.shape:
        raise ValueError(
            f"token_ids/segment must be matching rank-1; got {ids.shape} / {segment.shape}"
        )
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"image must be (H, W, 3); got {image.shape}")
    return ids, segment, image


def vilt_request(payload: dict, *, max_len: Optional[int] = None):
    """Decode a ViltPredictor sample: the processor dict (``input_ids`` and
    optional ``attention_mask`` / ``token_type_ids`` of length L,
    ``pixel_values`` (H, W, 3), optional ``pixel_mask`` (H, W)) -> the dict
    vilt_micro_batcher expects. ``max_len`` (the model's position table)
    turns a longer text into a 400 for its own request, not a failure of the
    coalesced batch it would join."""
    if "input_ids" not in payload or "pixel_values" not in payload:
        raise ValueError("vilt sample needs input_ids and pixel_values")
    sample = {"input_ids": np.asarray(payload["input_ids"], np.int64)}
    if max_len is not None and sample["input_ids"].shape[0] > max_len:
        raise ValueError(f"input_ids: {sample['input_ids'].shape[0]} tokens, at most {max_len}")
    for k in ("attention_mask", "token_type_ids"):
        if k in payload:
            sample[k] = np.asarray(payload[k], np.int64)
    pix = np.asarray(payload["pixel_values"], np.float32)
    if pix.ndim != 3 or pix.shape[-1] != 3:
        raise ValueError(f"pixel_values must be (H, W, 3); got {pix.shape}")
    sample["pixel_values"] = pix
    if "pixel_mask" in payload:
        sample["pixel_mask"] = np.asarray(payload["pixel_mask"], np.int64)
    return sample


def uncertainty_result(result):
    """encode_result for uncertainty-mode batchers: the per-sample result is
    ``(probs, diag)``; responds with probs plus the diagnostics."""
    probs, diag = result
    return {
        "probs": np.asarray(probs).tolist(),
        **{k: float(v) for k, v in diag.items()},
    }


class PredictionServer:
    """Serve one micro-batched predictor over HTTP.

    ``batcher``: a :class:`serving.MicroBatcher` (or any callable
    ``sample -> result``). ``decode_request``: JSON payload -> sample, so that
    input validation errors become 400s, not batch failures. ``port=0`` binds
    an ephemeral port (see ``.port``).
    """

    def __init__(
        self,
        batcher: Callable,
        decode_request: Callable[[dict], object] = fusion_request,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        encode_result: Optional[Callable] = None,
        max_body_bytes: int = 256 << 20,
    ):
        self.batcher = batcher
        self.decode_request = decode_request
        self.max_body_bytes = max_body_bytes
        self.encode_result = encode_result or (
            lambda r: {"probs": np.asarray(r).tolist()}
        )
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "errors": 0, "total_ms": 0.0, "max_ms": 0.0}
        self._closed = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet: route to logging
                logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    with outer._stats_lock:
                        n = outer._stats["requests"]
                    self._reply(200, {
                        "status": "closed" if outer._closed else "ok",
                        "requests": n,
                    })
                elif self.path == "/statz":
                    with outer._stats_lock:
                        s = dict(outer._stats)
                    s["mean_ms"] = (
                        s["total_ms"] / s["requests"] if s["requests"] else 0.0
                    )
                    s["pending"] = getattr(outer.batcher, "_pending", None)
                    s["max_pending"] = getattr(outer.batcher, "max_pending", None)
                    self._reply(200, s)
                else:
                    self._reply(404, {"error": f"no such path: {self.path}"})

            def do_POST(self):
                if self.path != "/v1/predict":
                    self._reply(404, {"error": f"no such path: {self.path}"})
                    return
                if outer._closed:
                    self._reply(503, {"error": "server is closing"})
                    return
                t0 = time.perf_counter()
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length > outer.max_body_bytes:
                        outer._count(t0, error=True)
                        self._reply(413, {
                            "error": f"body {length} bytes exceeds limit "
                                     f"{outer.max_body_bytes}"
                        })
                        return
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    sample = outer.decode_request(payload)
                except (ValueError, KeyError, TypeError) as e:
                    outer._count(t0, error=True)
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    result = outer.batcher(sample)
                except Overloaded as e:  # admission control, not a failure
                    outer._count(t0, error=True)
                    self._reply(503, {"error": f"overloaded: {e}"})
                    return
                except Exception as e:  # predictor/batcher failure
                    logger.exception("predict failed")
                    outer._count(t0, error=True)
                    self._reply(500, {"error": f"predict failed: {e}"})
                    return
                outer._count(t0)
                self._reply(200, outer.encode_result(result))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def _count(self, t0: float, error: bool = False) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["errors"] += int(error)
            self._stats["total_ms"] += ms
            self._stats["max_ms"] = max(self._stats["max_ms"], ms)

    def start(self) -> "PredictionServer":
        self._thread.start()
        logger.info("serving on http://%s:%d", self.host, self.port)
        return self

    def close(self) -> None:
        """Stop accepting requests, then stop the listener. The batcher is
        owned by the caller (it may back several servers)."""
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
