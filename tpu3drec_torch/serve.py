"""HTTP inference serving for the matching stage.

Port of `tpu3drec/serve.py`, on the standard library's `http.server`:

- **One canonical shape**: every request image is resized server-side
  to one (H, W) before detection (`io.images.resize_u8`, PIL's default
  bicubic resize in numpy), so every batch has one shape.
- **One card, one stream**: device work is serialised through one lock;
  throughput comes from batching, not from interleaving.
- **Micro-batching**: concurrent SIFT `/match` requests are coalesced
  into one batched call (`MicroBatcher`): SIFT on all 2n images (the
  `ori_desc` kernel), one `knn2` `l2_int8` launch over the n pairs, the
  ratio test, 256-hypothesis homography RANSAC, then the reprojection
  error. The batch runs at its real size n: there is no padding to a
  power of two and no per-size program.

Endpoints (JSON in/out):
  GET  /health   -> {status, backend, compiled, stats, batching}
  GET  /methods  -> detector registry listing
  POST /match    -> body {image1, image2, method?, max_features?, ratio?,
                    ransac_threshold?} where imageN is a base64-encoded
                    image file (PNG/JPEG) or a nested list of floats;
                    returns match stats + homography, and `timing_s`:
                    the seconds this request spent reading and parsing
                    its body, decoding its images, waiting for the
                    device and computing (its batch's call).
  POST /detect   -> body {image, method?, max_features?}; returns
                    keypoint count and (x, y, response) triples.

Base64 files are decoded by PIL where it imports, else by the native
decoder (`io/native_decoder.py`) through a temporary file; where neither
loads, the request is answered 400 with that reason. A missing field is
also 400; any other fault (a kernel's included) is 500.

Start: ``python -m tpu3drec_torch serve --port 8765`` (or
`serve_forever()`). Every class takes `device=None`, which means CUDA.
"""

from __future__ import annotations

import base64
import io
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Tuple

import numpy as np

from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.io.converters import _host
from tpu3drec_torch.io.images import resize_u8, resize_unit

DEFAULT_SHAPE = (480, 640)   # canonical (H, W)
NUM_HYPOTHESES = 256


class BadRequest(ValueError):
    """A request the server cannot serve as sent (answered 400)."""


def _decode_file_u8(raw: bytes) -> np.ndarray:
    """An image file's bytes -> (H, W) uint8 grayscale."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        with Image.open(io.BytesIO(raw)) as im:
            return np.asarray(im.convert("L"), np.uint8)
    from tpu3drec_torch.io import native_decoder
    if not native_decoder.available():
        raise BadRequest("cannot decode a base64 image here: neither PIL "
                         "nor the native decoder loads; send the image "
                         "as a nested list of floats")
    suffix = ".png" if raw[:8] == b"\x89PNG\r\n\x1a\n" else ".jpg"
    fd, path = tempfile.mkstemp(suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(raw)
        size = native_decoder.image_size(path)
        img = (native_decoder.decode_batch([path], [size])[0]
               if size is not None else None)
    finally:
        os.unlink(path)
    if img is None:
        raise BadRequest("the native decoder cannot read the base64 image")
    # the decoder scales by x * (1/255), an ulp off PIL's x / 255: back to
    # the exact 8-bit levels before anything else
    return np.rint(img * 255.0).astype(np.uint8)


def _decode_image(payload, shape: Tuple[int, int]) -> np.ndarray:
    """base64 image file or nested list -> (H, W) f32 [0,1] at `shape`."""
    if isinstance(payload, str):
        u8 = _decode_file_u8(base64.b64decode(payload))
        if u8.shape != tuple(shape):
            u8 = resize_u8(u8, shape)
        return u8.astype(np.float32) / 255.0
    img = np.asarray(payload, np.float32)
    if img.ndim == 3:
        img = img @ np.array([0.299, 0.587, 0.114], np.float32)
    if img.max() > 2.0:
        img = img / 255.0
    if img.shape != tuple(shape):
        img = resize_unit(img, shape)
    return img


class MicroBatcher:
    """Coalesces concurrent /match requests into one batched call.

    The first request of a window becomes the leader, sleeps `window_s`
    while peers enqueue, waits for the device, then runs up to
    `max_batch` of them through one batched detect + match + RANSAC call
    (per-request ratio and RANSAC threshold ride along as per-item
    values) and drains the queue the same way. Requests that arrive while
    the device is busy wait in the queue and join the next batch. Each
    item's RANSAC draws come from a CPU generator seeded with its index
    in the batch (`_uniforms`), as the folder engine's do, so the card
    and the CPU see the same draws."""

    def __init__(self, shape: Tuple[int, int], max_features: int,
                 device_lock: threading.Lock, max_batch: int = 8,
                 window_s: float = 0.005, wait_timeout_s: float = 1800.0,
                 device=None):
        self.shape = shape
        self.max_features = max_features
        self.device_lock = device_lock
        self.max_batch = max_batch
        self.window_s = window_s
        # must exceed the first batch's time, kernel builds included
        self.wait_timeout_s = wait_timeout_s
        self.device = resolve_device(device)
        self._mutex = threading.Lock()
        self._pending: list = []
        self.stats = {"dispatches": 0, "batched_requests": 0,
                      "max_batch": 0}

    @staticmethod
    def _uniforms(n: int):
        """(n, K, 4) RANSAC uniforms, item b's seeded with b."""
        from tpu3drec_torch.pipelines.matching import _pair_uniforms
        return _pair_uniforms(n, NUM_HYPOTHESES)

    def match_rows(self, imgs, ratio):
        """SIFT on the (2n, H, W) stack `imgs` (the n first images, then
        the n second ones), one `knn2` `l2_int8` launch over the n pairs
        and the ratio test with the (n,) `ratio`: (xy, desc, mask, nn_idx,
        nn_dist, ok), each first axis 2n or n."""
        import torch
        from tpu3drec_torch.ops.match import knn2
        from tpu3drec_torch.ops.sift import detect_and_compute
        n = imgs.shape[0] // 2
        xy, _, _, _, desc, mask = detect_and_compute(imgs, self.max_features)
        nn_idx, nn_dist = knn2(desc[:n], desc[n:], mask[:n], mask[n:],
                               metric="l2_int8")
        ok = (nn_dist[..., 0] < ratio[:, None]
              * torch.clamp(nn_dist[..., 1], min=1e-12)) & mask[:n]
        return xy, desc, mask, nn_idx, nn_dist, ok

    def _compute(self, batch: list) -> Dict[str, np.ndarray]:
        """The batched pair step on the device; one host pull."""
        import torch
        from tpu3drec_torch.ops.geometry import (
            find_homography, reprojection_error_homography,
        )
        from tpu3drec_torch.pipelines.matching import _pull
        n = len(batch)
        dev = self.device
        imgs = torch.from_numpy(np.stack(
            [it["img1"] for it in batch] + [it["img2"] for it in batch]
        ).astype(np.float32)).to(dev)
        ratio = torch.tensor([it["ratio"] for it in batch],
                             dtype=torch.float32, device=dev)
        thr = torch.tensor([it["thr"] for it in batch],
                           dtype=torch.float32, device=dev)
        xy, _, _, nn_idx, _, ok = self.match_rows(imgs, ratio)
        p1 = xy[:n]
        p2 = xy[n:].gather(1, nn_idx[..., :1].long().expand(-1, -1, 2))
        rr = find_homography(p1, p2, mask=ok, threshold=thr,
                             num_hypotheses=NUM_HYPOTHESES,
                             u=self._uniforms(n))
        err = reprojection_error_homography(rr.model, p1, p2, rr.inliers)
        keys = ("raw", "inl", "ratio", "success", "H", "err")
        vals = _pull([ok.sum(-1, dtype=torch.int32), rr.num_inliers,
                      rr.inlier_ratio, rr.success, rr.model, err])
        return {k: v.numpy() for k, v in zip(keys, vals)}

    def _run_batch(self, batch: list) -> None:
        """Run `batch` (under the device lock) and hand each item its
        result."""
        n = len(batch)
        t0 = time.perf_counter()
        out = self._compute(batch)
        t1 = time.perf_counter()
        with self._mutex:
            self.stats["dispatches"] += 1
            self.stats["batched_requests"] += n
            self.stats["max_batch"] = max(self.stats["max_batch"], n)
        for j, it in enumerate(batch):
            ok = bool(out["success"][j])
            raw = int(out["raw"][j])
            inl = int(out["inl"][j]) if ok else raw
            ir = float(out["ratio"][j]) if ok else None
            err = float(out["err"][j]) if ok else None
            q = min(inl / 500.0, 1.0) * 0.4
            if ir is not None:
                q += ir * 0.4
            if err is not None:
                q += max(0.0, 1.0 - err / 10.0) * 0.2
            it["result"] = {
                "num_matches": inl,
                "num_raw_matches": raw,
                "inlier_ratio": ir,
                "reprojection_error": err,
                "quality_score": q,
                "homography": (out["H"][j].tolist() if ok else None),
                "batched_with": n,
                "timing_s": {"wait_s": t0 - it["t_submit"],
                             "compute_s": t1 - t0},
            }
            it["event"].set()

    def _fail_batch(self, batch: list, exc: Exception) -> None:
        """Hand a batch's fault to every request waiting on it."""
        for it in batch:
            it["error"] = exc
            it["event"].set()

    def _wait(self, item: Dict) -> Dict:
        if not item["event"].wait(timeout=self.wait_timeout_s):
            raise TimeoutError("batched match timed out")
        if item.get("error") is not None:
            raise item["error"]
        return item["result"]

    def submit(self, img1: np.ndarray, img2: np.ndarray,
               ratio: float, threshold: float) -> Dict:
        item = {"img1": img1, "img2": img2, "ratio": ratio,
                "thr": threshold, "event": threading.Event(),
                "result": None, "error": None,
                "t_submit": time.perf_counter()}
        with self._mutex:
            self._pending.append(item)
            leader = len(self._pending) == 1
        if not leader:
            # a later arrival past max_batch elects itself leader of the
            # next window through the queue-length check above
            return self._wait(item)
        time.sleep(self.window_s)
        while True:
            # the batch is taken once the device is free, so requests that
            # arrive while another batch runs join this one
            with self.device_lock:
                with self._mutex:
                    batch = self._pending[: self.max_batch]
                    self._pending = self._pending[self.max_batch:]
                    drained = not self._pending
                if not batch:
                    break
                try:
                    self._run_batch(batch)
                except Exception as e:
                    self._fail_batch(batch, e)
            if item["event"].is_set() and drained:
                break
        # a late arrival can elect itself leader while this one still
        # drains; if that leader took our item, wait for it like a peer
        return self._wait(item)


class MatchServer:
    """Serving wrapper: owns the device lock, the canonical shape and the
    stats; runs on `device` (None means CUDA)."""

    def __init__(self, shape: Tuple[int, int] = DEFAULT_SHAPE,
                 max_features: int = 1024,
                 max_body_bytes: int = 64 << 20,
                 enable_batching: bool = True,
                 batch_window_s: float = 0.005,
                 max_batch: int = 8,
                 device=None):
        self.shape = tuple(shape)
        self.max_features = max_features
        self.max_body_bytes = max_body_bytes
        self.device = resolve_device(device)
        self.lock = threading.Lock()          # the device's one stream
        self.stats_lock = threading.Lock()    # shared stats/compiled flag
        self.stats = {"requests": 0, "errors": 0, "total_s": 0.0}
        self.compiled = False
        self.enable_batching = enable_batching
        self.batcher = MicroBatcher(self.shape, max_features, self.lock,
                                    max_batch=max_batch,
                                    window_s=batch_window_s,
                                    device=self.device)

    def _count(self, key: str, dt: float = 0.0) -> None:
        """Thread-safe stats update (handler threads are concurrent)."""
        with self.stats_lock:
            self.stats[key] += 1
            self.stats["total_s"] += dt
            if key == "requests":
                self.compiled = True

    # -- handlers ------------------------------------------------------

    def health(self) -> Dict:
        with self.stats_lock:
            compiled, stats = self.compiled, dict(self.stats)
        with self.batcher._mutex:
            bstats = dict(self.batcher.stats)
        return {"status": "ok", "backend": self.device.type,
                "device": str(self.device),
                "canonical_shape": list(self.shape),
                "compiled": compiled, "stats": stats,
                "batching": {"enabled": self.enable_batching, **bstats}}

    def methods(self) -> Dict:
        from tpu3drec_torch.api import _get_detector_registry
        return {"methods": sorted(_get_detector_registry())}

    def match(self, body: Dict) -> Dict:
        from tpu3drec_torch.api import match_images
        t_dec = time.perf_counter()
        img1 = _decode_image(body["image1"], self.shape)
        img2 = _decode_image(body["image2"], self.shape)
        method = body.get("method", "SIFT")
        mf = int(body.get("max_features", self.max_features))
        t0 = time.perf_counter()
        decode_s = t0 - t_dec
        if (self.enable_batching and method == "SIFT"
                and mf == self.max_features):
            out = self.batcher.submit(
                img1, img2, float(body.get("ratio", 0.75)),
                float(body.get("ransac_threshold", 4.0)))
            out["timing_s"] = {"decode_s": decode_s, **out["timing_s"]}
            return {"method": method, **out,
                    "latency_s": round(time.perf_counter() - t0, 4)}
        with self.lock:
            t1 = time.perf_counter()
            r = match_images(img1, img2, method=method, max_features=mf,
                             ratio=float(body.get("ratio", 0.75)),
                             device=self.device)
        dt = time.perf_counter() - t0
        H = r.homography
        return {
            "method": method,
            "num_matches": int(r.num_matches),
            "inlier_ratio": (None if r.inlier_ratio is None
                             else float(r.inlier_ratio)),
            "reprojection_error": (None if r.reprojection_error is None
                                   else float(r.reprojection_error)),
            "quality_score": float(r.get_quality_score()),
            "homography": (None if H is None
                           else np.asarray(H).tolist()),
            "latency_s": round(dt, 4),
            "timing_s": {"decode_s": decode_s, "wait_s": t1 - t0,
                         "compute_s": t0 + dt - t1},
        }

    def detect(self, body: Dict) -> Dict:
        from tpu3drec_torch.api import detect_features
        img = _decode_image(body["image"], self.shape)
        method = body.get("method", "SIFT")
        mf = int(body.get("max_features", self.max_features))
        with self.lock:
            f = detect_features(img, method, max_features=mf,
                                device=self.device)
            m = _host(f.mask)
            xy = _host(f.xy)[m]
            resp = _host(f.response)[m]
        return {
            "method": method,
            "num_keypoints": int(m.sum()),
            "keypoints": [[float(x), float(y), float(s)]
                          for (x, y), s in zip(xy, resp)],
        }

    # -- wiring --------------------------------------------------------

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # quiet by default
                pass

            def _send(self, code: int, obj: Dict):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                try:
                    if self.path == "/health":
                        self._send(200, server.health())
                    elif self.path == "/methods":
                        self._send(200, server.methods())
                    else:
                        self._send(404, {"error": f"no route {self.path}"})
                except Exception as e:   # pragma: no cover
                    server._count("errors")
                    self._send(500, {"error": str(e)})

            def do_POST(self):
                t0 = time.perf_counter()
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    if n > server.max_body_bytes:
                        self._send(413, {
                            "error": f"body {n} B exceeds limit "
                                     f"{server.max_body_bytes} B"})
                        return
                    body = json.loads(self.rfile.read(n) or b"{}")
                    body_s = time.perf_counter() - t0
                    if self.path == "/match":
                        out = server.match(body)
                        out["timing_s"] = {"body_s": body_s,
                                           **out["timing_s"]}
                    elif self.path == "/detect":
                        out = server.detect(body)
                    else:
                        self._send(404, {"error": f"no route {self.path}"})
                        return
                    server._count("requests", time.perf_counter() - t0)
                    self._send(200, out)
                except KeyError as e:
                    server._count("errors")
                    self._send(400, {"error": f"missing field {e}"})
                except BadRequest as e:
                    server._count("errors")
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    server._count("errors")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 8765,
              warmup: bool = False) -> ThreadingHTTPServer:
        """Bind and return the server (caller runs serve_forever)."""
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        if warmup:
            self._warmup()
        return httpd

    def _warmup(self) -> None:
        """Run the canonical batch once (kernel builds included) before
        serving traffic."""
        rng = np.random.default_rng(0)
        img = rng.uniform(0.0, 1.0, self.shape).astype(np.float32)
        self.match({"image1": img.tolist(), "image2": img.tolist()})
        self.stats["requests"] = 0
        self.stats["total_s"] = 0.0
        with self.batcher._mutex:
            self.batcher.stats.update(dispatches=0, batched_requests=0,
                                      max_batch=0)


def serve_forever(host: str = "127.0.0.1", port: int = 8765,
                  shape: Tuple[int, int] = DEFAULT_SHAPE,
                  max_features: int = 1024, warmup: bool = True,
                  device=None) -> None:
    ms = MatchServer(shape=shape, max_features=max_features, device=device)
    httpd = ms.start(host, port, warmup=warmup)
    print(f"tpu3drec_torch serving on http://{host}:{port} "
          f"(canonical {shape[0]}x{shape[1]}, {ms.device}, "
          f"warmup={warmup})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
