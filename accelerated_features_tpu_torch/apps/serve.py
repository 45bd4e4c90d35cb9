"""Batching inference server of the PyTorch port (counterpart of the JAX
package's `apps/serve.py`: the same design, endpoints and wire format).

One process owns the card; many clients submit images over HTTP.

  * stdlib only (`ThreadingHTTPServer`, with a listen backlog of 128);
  * handler threads decode and shape-normalize each image on the host
    (numpy only: no tensor, no device) and enqueue it; ONE device-owner
    thread (`InferenceService`) drains the queue, groups up to `max_batch`
    same-shape, same-dtype `/detect` requests arriving within
    `max_wait_ms`, uploads the stack and runs one `detectAndCompute` call,
    then fans the results back out. Requests of another bucket pulled
    while grouping are served first in the next round, together with the
    others of their bucket already waiting. `/match` runs one
    pair a call, on the same thread. So no two threads touch the card.
    Integer images stay integer up to the card (uint8 crosses the bus);
    the /255 runs inside the pipeline;
  * responses are npz bytes holding the arrays the Python API returns.

Endpoints:
  POST /detect      body = npz with array 'image' (H,W[,C]) uint8/float,
                    an npy array, or PNG bytes (decoded without cv2; other
                    image formats need cv2); query ?top_k=&threshold=
                    -> keypoints, scores, descriptors
  POST /match       body = npz with 'image0', 'image1' -> mkpts0, mkpts1;
                    ?mode=mnn (default) | star | lighterglue (the server
                    must have been given LighterGlue weights); ?top_k=
  GET  /healthz     {"ok", "backend": the device's name (or "cpu"),
                    "served": requests answered}

400 for a malformed request, 404 for an unknown path, 503 when inference
does not answer in time, 500 when it raised.

    python -m accelerated_features_tpu_torch.apps.serve --port 8500 \\
        --weights artifacts/run_md_ckpt13250.npz \\
        --lg_weights artifacts/lighterglue_ft_ckpt7791.npz
    curl -s -X POST --data-binary @img.png localhost:8500/detect > out.npz

It runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import queue
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..api import XFeat, parse_input_host
from ..utils.imageio import PNG_SIGNATURE, decode_png

MATCH_KINDS = {"mnn": "match_mnn", "star": "match_star",
               "lighterglue": "match_lg", "lg": "match_lg"}


class _Request:
    __slots__ = ("kind", "images", "top_k", "threshold", "event", "result",
                 "error", "abandoned")

    def __init__(self, kind, images, top_k, threshold):
        self.kind = kind              # "detect" | "match_mnn" | ...
        self.images = images          # tuple of host arrays (H,W,C)
        self.top_k = top_k
        self.threshold = threshold
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.abandoned = False

    @property
    def key(self):
        return (self.kind,
                tuple((im.shape, str(im.dtype)) for im in self.images),
                self.top_k, self.threshold)


class InferenceService:
    """The single device-owner thread, with shape- and dtype-bucketed
    batching of `/detect` requests."""

    def __init__(self, xfeat: XFeat, max_batch: int = 16,
                 max_wait_ms: float = 5.0):
        self.xfeat = xfeat
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.device_name = (torch.cuda.get_device_name(xfeat.device)
                            if xfeat.device.type == "cuda" else "cpu")
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        # requests pulled while grouping that belong to another bucket:
        # served FIRST next round (re-queued at the tail, a sustained
        # majority bucket would starve the others)
        self._backlog: collections.deque = collections.deque()
        self.served = 0
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, kind: str, images, top_k=None, threshold=None,
               timeout: float = 60.0):
        """Normalize `images` on the calling thread (host numpy only), queue
        them for the owner thread and wait for the answer: a dict of numpy
        arrays for "detect", (mkpts0, mkpts1) for a match kind. Raises
        TimeoutError after `timeout` s, or what inference raised."""
        images = tuple(parse_input_host(np.asarray(im))[0] for im in images)
        req = _Request(kind, images, top_k, threshold)
        self.queue.put(req)
        if not req.event.wait(timeout):
            req.abandoned = True      # the owner thread will skip it
            raise TimeoutError("inference timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def stop(self, timeout: float = 5.0) -> None:
        """End the owner thread (after the request it is serving)."""
        self._stop = True
        self._thread.join(timeout)

    # ---------------- the owner thread ----------------

    def _next(self, timeout):
        if self._backlog:
            return self._backlog.popleft()
        return self.queue.get(timeout=timeout)

    def _group(self, first: _Request):
        """`first` and the requests of its bucket, up to `max_batch`
        (detect only): those already waiting in the backlog, then those
        that arrive within the batching window."""
        group = [first]
        if first.kind != "detect":
            return group
        for r in list(self._backlog):
            if len(group) < self.max_batch and r.key == first.key:
                self._backlog.remove(r)
                group.append(r)
        deadline = time.monotonic() + self.max_wait
        while len(group) < self.max_batch:
            rem = deadline - time.monotonic()
            if rem <= 0:
                break
            try:
                r = self.queue.get(timeout=rem)
            except queue.Empty:
                break
            if r.abandoned:
                continue
            if r.key == first.key:
                group.append(r)
            else:
                self._backlog.append(r)  # head of the next round
        return [r for r in group if not r.abandoned]

    def _upload(self, im: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(im)).to(
            self.xfeat.device)

    def _run(self, group) -> None:
        """One device call for the group; results as numpy."""
        xf, first = self.xfeat, group[0]
        if first.kind == "detect":
            batch = self._upload(np.stack([r.images[0] for r in group]))
            outs = xf.detectAndCompute(batch, top_k=first.top_k,
                                       detection_threshold=first.threshold)
            for r, o in zip(group, outs):
                r.result = {k: v.cpu().numpy() for k, v in o.items()}
            return
        tk = first.top_k or xf.top_k
        im0, im1 = (self._upload(im) for im in first.images)
        if first.kind == "match_star":
            mk0, mk1 = xf.match_xfeat_star(im0, im1, top_k=tk)
        elif first.kind == "match_lg":
            d0 = xf.detectAndCompute(im0, top_k=tk)[0]
            d1 = xf.detectAndCompute(im1, top_k=tk)[0]
            d0["image_size"] = first.images[0].shape[1::-1]
            d1["image_size"] = first.images[1].shape[1::-1]
            mk0, mk1, _ = xf.match_lighterglue(d0, d1)
            mk0, mk1 = mk0.cpu().numpy(), mk1.cpu().numpy()
        else:
            mk0, mk1 = xf.match_xfeat(im0, im1, top_k=tk)
        first.result = (mk0, mk1)

    def _loop(self):
        while not self._stop:
            try:
                first = self._next(timeout=0.1)
            except queue.Empty:
                continue
            if first.abandoned:
                continue
            group = self._group(first)
            if not group:
                continue
            try:
                self._run(group)
                self.served += len(group)
            except Exception as e:  # an inference failure: answer 500
                traceback.print_exc(file=sys.stderr)
                for r in group:
                    r.error = e
            for r in group:
                r.event.set()


def _decode_image(body: bytes) -> np.ndarray:
    """An npy array, the 'image' of an npz, a PNG by `decode_png`, or any
    other image format by cv2 when cv2 can be imported."""
    if body[:6] == b"\x93NUMPY" or body[:2] == b"PK":   # .npy / .npz
        data = np.load(io.BytesIO(body), allow_pickle=False)
        if isinstance(data, np.ndarray):
            return data
        with data:
            return data["image"]
    if body[:8] == PNG_SIGNATURE:
        return decode_png(body)
    try:
        import cv2
    except ImportError:
        raise ValueError("the body is not .npy, .npz or PNG, and other "
                         "image formats need cv2, which is not installed")
    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("the body is neither .npy/.npz nor a decodable "
                         "image")
    return img


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):     # quiet access log
            pass

        def _send(self, code, body, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code, e):
            self._send(code, json.dumps({"error": str(e)}).encode(),
                       "application/json")

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                info = {"ok": True, "backend": service.device_name,
                        "served": service.served}
                self._send(200, json.dumps(info).encode(),
                           "application/json")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                u = urlparse(self.path)
                q = parse_qs(u.query)
                top_k = int(q["top_k"][0]) if "top_k" in q else None
                thr = float(q["threshold"][0]) if "threshold" in q else None
                if u.path == "/detect":
                    imgs = (_decode_image(body),)
                    kind = "detect"
                elif u.path == "/match":
                    mode = q.get("mode", ["mnn"])[0]
                    if mode not in MATCH_KINDS:
                        raise ValueError(f"unknown match mode {mode}")
                    kind = MATCH_KINDS[mode]
                    with np.load(io.BytesIO(body), allow_pickle=False) as d:
                        imgs = (d["image0"], d["image1"])
                else:
                    self._send(404, b"not found")
                    return
            except Exception as e:  # a malformed body or query
                self._error(400, e)
                return
            try:
                # ALL device work goes through the one owner thread
                out = service.submit(kind, imgs, top_k, thr)
            except TimeoutError as e:
                self._error(503, e)
                return
            except Exception as e:  # inference raised
                self._error(500, e)
                return
            if kind == "detect":
                self._send(200, _npz_bytes(**out))
            else:
                self._send(200, _npz_bytes(mkpts0=out[0], mkpts1=out[1]))
    return Handler


class Server(ThreadingHTTPServer):
    """`ThreadingHTTPServer` with a listen backlog of 128 connections.
    http.server's default is 5: a burst of more clients than that
    overflows it, the kernel drops their connection requests, and each
    retries a second later, after the batching window has closed."""
    request_queue_size = 128


def serve(host: str = "127.0.0.1", port: int = 8500, weights=None,
          top_k: int = 4096, max_batch: int = 16, max_wait_ms: float = 5.0,
          compute_dtype: str = "float32", lg_weights=None, device=None,
          fused_stem: bool = False) -> Server:
    """Build the extractor and the server (not started: call
    `serve_forever()`; `httpd.service` is the `InferenceService`, stop it
    with `service.stop()` beside `httpd.shutdown()`). `weights`: every
    format `XFeat` takes; None is a random extractor, as in the JAX
    server. `lg_weights`: LighterGlue weights for `/match?mode=
    lighterglue` (every format `LighterGlue` takes; "random" for a smoke
    test). `device=None` is the card, and raises without one.
    `compute_dtype` defaults to float32: with bfloat16 and the fused stem
    the card's host-bound wall was higher (`PERF.md`)."""
    xfeat = XFeat(weights=weights, top_k=top_k, device=device,
                  compute_dtype=compute_dtype, fused_stem=fused_stem)
    if lg_weights == "random":
        xfeat.set_lighterglue()
    elif lg_weights is not None:
        xfeat.set_lighterglue(weights=lg_weights)
    service = InferenceService(xfeat, max_batch, max_wait_ms)
    httpd = Server((host, port), make_handler(service))
    httpd.service = service
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", type=str, default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--weights", type=str, default=None,
                    help="extractor weights (.npz, .pt, checkpoint "
                         "directory); default: random")
    ap.add_argument("--top_k", type=int, default=4096)
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--lg_weights", type=str, default=None,
                    help="LighterGlue weights for /match?mode=lighterglue "
                         "('random' = smoke)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    httpd = serve(args.host, args.port, args.weights, args.top_k,
                  args.max_batch, args.max_wait_ms,
                  lg_weights=args.lg_weights, device=args.device)
    print(f"[serve] listening on {args.host}:{httpd.server_address[1]} "
          f"on {httpd.service.device_name} (max_batch={args.max_batch}, "
          f"wait={args.max_wait_ms}ms)", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.service.stop()
        httpd.server_close()


if __name__ == "__main__":
    main()
