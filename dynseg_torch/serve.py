"""Inference serving: an HTTP server over the exported `torch.export`
artifact (counterpart of dynseg/serve.py).

It serves a trained model from the `--operation export` artifact alone
(`dynseg_torch.export`): no checkpoint, no training dataset. An int8
artifact also needs `dynseg_torch` importable, for K5's operator.

  * Every forward goes through a fixed (batch, size, size) shape: the
    window estimator pads its last batch of a scale, and dense blocks go
    in groups padded to a power of two capped at dense_block_batch, so
    that `warmup` can run every shape a request will use.
  * Two estimators: `window` = the reference protocol's multi-scale
    sliding-window softmax voting (scales and stride from the manifest's
    serving hints); `dense` = halo'd blocks of a whole-raster forward on
    the mirror-padded raster.
  * Responses are raw `.npy` (labels or probabilities) or a colorized
    PNG (palette of the manifest's training dataset).

Where the host waits: a launch returns at once and the host blocks at the
copy of a result to the host (`_to_host`), so `pipeline_depth` counts
calls whose results have not been copied yet, and the request deadline
covers those copies. Inputs go up from pinned memory without waiting.

Endpoints:
    GET  /healthz             liveness + manifest summary
    GET  /manifest            full export manifest
    GET  /metrics             counters, latency quantiles, and the calls
                              and seconds of the serve.* spans
    POST /predict?mode=dense|window&output=labels|probs|png[&scales=..][&tta=1]
                              body: PNG/JPEG image bytes or .npy array
                              (H, W, bands)

Run:  python -m dynseg_torch.serve --export_dir /out/export --port 8400
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from dynseg_torch.export import ExportedPredictor
from dynseg_torch.utils.profiling import span, totals

# Upper bound on client-requested window scales: padding and probability
# buffers grow quadratically in max(scales), so this is a DoS guard, not
# a modeling limit (trained scales are 25-65 px).
MAX_WINDOW_SCALE = 512


class _DeadlineExpired(Exception):
    """An engine call outlived request_timeout_s (device busy or wedged).
    Not a TimeoutError: TimeoutError in the handler means the CLIENT
    stalled (socket timeout, 408); this maps to 503."""


def _to_host(out) -> np.ndarray:
    """A predictor's result as numpy: the copy of a device tensor to the
    host, which waits for the launches that made it."""
    with span("serve.to_host"):
        if hasattr(out, "cpu"):
            return out.cpu().numpy()
        return np.asarray(out)


def _span_totals() -> dict:
    """/metrics' `spans`: calls and seconds of this process's serve.*
    spans (queue: waits for the engine lock and the cross-batch linger;
    device: artifact calls under the lock; to_host: result copies)."""
    return {k: {"calls": v["calls"], "seconds": round(v["seconds"], 6)}
            for k, v in sorted(totals().items())
            if k.startswith("serve.")}


def _drain_capped(rfile, length: int, limit: int = 8 << 20) -> int:
    """Discard up to `limit` bytes of a request body of declared size
    `length`; returns the bytes left UNREAD. Draining before an error
    response lets a small upload's client read the status; the cap stops
    one request with a huge declared body from tying up a handler thread
    for the whole upload (the connection is closed when bytes are left)."""
    left = max(0, length)
    while left > 0 and limit > 0:
        chunk = rfile.read(min(left, limit, 1 << 20))
        if not chunk:  # client hung up mid-upload
            return 0
        left -= len(chunk)
        limit -= len(chunk)
    return left


def _mirror_pad(img: np.ndarray, pad: int) -> np.ndarray:
    """One native np.pad reflect, the call the port's tile padding makes
    (numpy >= 2 reflects repeatedly when pad >= dim and replicates 1-px
    dims), so serving matches the Inferencer on tiny rasters too."""
    return np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")


class _CrossBatcher:
    """Cross-request dynamic batching for the dense estimators.

    Concurrent small requests each contribute one dense block, so the
    engine lock would serialize batch-1 device calls; coalescing blocks
    from different requests into one launch restores the batched rate
    without changing any result (blocks are independent; grouping is a
    launch-shape choice).

    Requests submit halo'd blocks keyed by (entry point, shape, dtype); a
    dispatcher thread lingers up to `window_s` after the first pending
    block (returning early once `max_batch` accumulate), stacks the group
    padded to the power-of-two menu `warmup` runs, and launches one device
    call under the engine lock. A collector thread per in-flight batch
    copies the result to the host and resolves the requesters' futures;
    `pipeline_depth` batches may be in flight. A wedged device exhausts
    the in-flight semaphore and the waiting futures never resolve: the
    request deadline turns that into bounded 503s, as for the unbatched
    path."""

    def __init__(self, engine: "ServingEngine", window_ms: float):
        self.engine = engine
        self.window_s = max(0.0, float(window_ms)) / 1e3
        self.max_batch = engine.dense_block_batch
        self.cv = threading.Condition()
        self.pending: dict = {}  # key -> list[(block, Future)]
        self.inflight = threading.Semaphore(engine.pipeline_depth)
        threading.Thread(target=self._dispatch, daemon=True,
                         name="dynseg-cross-batcher").start()

    def submit(self, kind: str, x: np.ndarray):
        from concurrent.futures import Future

        fut = Future()
        key = (kind, x.shape, str(x.dtype))
        with self.cv:
            self.pending.setdefault(key, []).append((x, fut))
            self.cv.notify()
        return fut

    def _take_group(self):
        with self.cv:
            while not self.pending:
                self.cv.wait()
        with span("serve.queue"):
            return self._linger()

    def _linger(self):
        """The group to launch: lingers up to window_s after the first
        pending block, or until max_batch blocks of one key wait."""
        deadline = time.monotonic() + self.window_s
        while True:
            with self.cv:
                if self.pending:
                    key = max(self.pending,
                              key=lambda k: len(self.pending[k]))
                    n = len(self.pending[key])
                    if n >= self.max_batch or time.monotonic() >= deadline:
                        grp = self.pending[key][: self.max_batch]
                        rest = self.pending[key][len(grp):]
                        if rest:
                            self.pending[key] = rest
                        else:
                            del self.pending[key]
                        return key, grp
                elif time.monotonic() >= deadline:
                    return None, []  # everything was taken elsewhere
            time.sleep(min(0.001, max(self.window_s / 4, 1e-4)))

    def _dispatch(self):
        while True:
            key, grp = self._take_group()
            if not grp:
                continue
            kind = key[0]
            xs = np.stack([g[0] for g in grp])
            n = xs.shape[0]
            tgt = min(self.max_batch, 1 << (n - 1).bit_length())
            if tgt > n:  # warmup()'s pow2 menu: no unseen batch shapes
                xs = np.concatenate([xs, np.repeat(xs[-1:], tgt - n, 0)])
            self.inflight.acquire()
            try:
                entry = (self.engine.p.dense_labels_device if kind == "labels"
                         else self.engine.p.probs_device)
                dev = self.engine._launch(lambda: entry(xs))
            except BaseException as e:  # noqa: BLE001 — routed to futures
                self.inflight.release()
                for _, fut in grp:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            threading.Thread(target=self._resolve, args=(dev, grp),
                             daemon=True).start()

    def _resolve(self, dev, grp):
        try:
            out = _to_host(dev)
            for i, (_, fut) in enumerate(grp):
                fut.set_result(out[i])
        except BaseException as e:  # noqa: BLE001 — routed to futures
            for _, fut in grp:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            self.inflight.release()


class ServingEngine:
    """Raster-in, labels-out on top of an ExportedPredictor.

    Pure numpy around the artifact calls; every device forward goes
    through a fixed (batch, size, size) shape."""

    def __init__(self, predictor: ExportedPredictor, window_batch: int = 64,
                 pipeline_depth: int = 4, dense_block: int = 1024,
                 dense_block_batch: int = 8, cross_batch_ms: float = 0.0):
        self.p = predictor
        m = predictor.manifest
        self.bands = int(m["num_input_bands"])
        self.nc = int(m["num_classes"])
        inf = m.get("inference", {})
        self.scales = [int(s)
                       for s in inf.get("window_scales",
                                        m.get("train_scales", [25]))]
        self.stride_fraction = float(inf.get("stride_fraction", 0.5))
        self.window_batch = int(window_batch)
        # Default block for the dense estimators; warmup() runs this size.
        self.dense_block = int(dense_block)
        # Blocks stacked per device call. A ragged last group is padded
        # up to a power of two capped at this (_stack_group), and
        # warmup() runs every size of that menu.
        self.dense_block_batch = max(1, int(dense_block_batch))
        # Device calls whose results are not yet copied to the host: the
        # next upload and launches overlap the previous copy. Each dense
        # call holds bb*(block+2h)^2 input and probability values on the
        # device, times pipeline_depth.
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._lock = threading.Lock()  # one caller launches at a time
        # > 0 coalesces dense blocks from CONCURRENT requests into one
        # launch, lingering up to cross_batch_ms after the first block;
        # it adds up to that linger to a lone request's latency.
        self._batcher = (_CrossBatcher(self, cross_batch_ms)
                         if cross_batch_ms > 0 else None)

    def _launch(self, thunk):
        """thunk() under the engine lock: one caller launches at a time."""
        with span("serve.queue"):
            self._lock.acquire()
        try:
            with span("serve.device"):
                return thunk()
        finally:
            self._lock.release()

    def _pipelined(self, launches):
        """launches yields (meta, thunk) where thunk() returns a DEVICE
        result; yields (meta, np.ndarray) with up to pipeline_depth
        results not yet copied to the host."""
        import collections

        q = collections.deque()
        for meta, thunk in launches:
            q.append((meta, self._launch(thunk)))
            if len(q) > self.pipeline_depth:
                m, dev = q.popleft()
                yield m, _to_host(dev)
        while q:
            m, dev = q.popleft()
            yield m, _to_host(dev)

    @staticmethod
    def _block_starts(extent: int, b: int) -> List[int]:
        ss = list(range(0, max(1, extent - b + 1), b))
        if ss[-1] + b < extent:
            ss.append(extent - b)
        return ss

    def _block_groups(self, h: int, w: int, b: int):
        """Block corners grouped dense_block_batch per device call; the
        last group may be ragged (outputs are sliced by the corner list,
        so _stack_group's padding rows are discarded)."""
        starts = [(r, c) for r in self._block_starts(h, b)
                  for c in self._block_starts(w, b)]
        bb = self.dense_block_batch
        return [starts[i : i + bb] for i in range(0, len(starts), bb)]

    def _stack_group(self, big: np.ndarray, grp, ext: int) -> np.ndarray:
        """Stack one group's block inputs, padding a ragged group (by
        repeating its last block) up to the next power of two capped at
        dense_block_batch: the fixed menu of batch sizes warmup() runs."""
        x = np.stack([big[r : r + ext, c : c + ext] for r, c in grp])
        n = x.shape[0]
        tgt = min(self.dense_block_batch, 1 << (n - 1).bit_length())
        if tgt > n:
            x = np.concatenate([x, np.repeat(x[-1:], tgt - n, axis=0)])
        return x

    # -- estimators ---------------------------------------------------- #
    def dense(self, img: np.ndarray, block: Optional[int] = None) -> np.ndarray:
        """Blockwise whole-raster forward (the Inferencer's dense mode):
        halo'd fixed-shape blocks reproduce the single whole-raster
        forward where the halo covers the receptive field, with the
        device memory of one block group. uint8 rasters go up as uint8
        through the probs_u8 entry (4x fewer bytes)."""
        halo = int(self.p.manifest.get("inference", {}).get("dense_halo", 40))
        h, w = img.shape[:2]
        src = img if img.dtype == np.uint8 else img.astype(np.float32)
        big = _mirror_pad(src, halo)
        b = max(1, min(block or self.dense_block, h, w))
        probs = np.zeros((h, w, self.nc), np.float32)
        ext = b + 2 * halo

        if self._batcher is not None:
            futs = [((r, c), self._batcher.submit(
                        "probs", big[r : r + ext, c : c + ext]))
                    for grp in self._block_groups(h, w, b) for r, c in grp]
            for (r, c), fut in futs:
                out = fut.result()
                probs[r : r + b, c : c + b] = out[halo : halo + b,
                                                  halo : halo + b]
            return probs

        def launches():
            for grp in self._block_groups(h, w, b):
                x = self._stack_group(big, grp, ext)
                yield grp, lambda x=x: self.p.probs_device(x)

        for grp, out in self._pipelined(launches()):
            for k, (r, c) in enumerate(grp):
                probs[r : r + b, c : c + b] = out[k, halo : halo + b,
                                                  halo : halo + b]
        return probs

    def dense_labels(self, img: np.ndarray,
                     block: Optional[int] = None) -> np.ndarray:
        """Labels-only dense fast path for uint8 rasters: argmax and halo
        crop on the device, so each block downloads b*b uint8 labels
        instead of a float probability map."""
        halo = int(self.p.manifest.get("dense_labels_halo", 0))
        if not self.p.has("dense_labels"):
            raise ValueError("artifact has no dense_labels entry point")
        if img.dtype != np.uint8:
            raise ValueError(
                f"dense_labels is the uint8 fast path, got {img.dtype}; "
                "use dense() for float rasters")
        h, w = img.shape[:2]
        big = _mirror_pad(img, halo)
        b = max(1, min(block or self.dense_block, h, w))
        labels = np.zeros((h, w), np.uint8)
        ext = b + 2 * halo

        if self._batcher is not None:
            futs = [((r, c), self._batcher.submit(
                        "labels", big[r : r + ext, c : c + ext]))
                    for grp in self._block_groups(h, w, b) for r, c in grp]
            for (r, c), fut in futs:
                labels[r : r + b, c : c + b] = fut.result()
            return labels

        def launches():
            for grp in self._block_groups(h, w, b):
                x = self._stack_group(big, grp, ext)
                yield grp, lambda x=x: self.p.dense_labels_device(x)

        for grp, out in self._pipelined(launches()):
            for k, (r, c) in enumerate(grp):
                labels[r : r + b, c : c + b] = out[k]
        return labels

    def window(self, img: np.ndarray,
               scales: Optional[List[int]] = None) -> np.ndarray:
        """Multi-scale sliding-window softmax voting in host numpy around
        fixed-shape artifact calls, on the Inferencer's origin grid."""
        from dynseg_torch.infer import window_origins

        scales = [int(s) for s in (scales or self.scales)]
        if any(s < 1 or s > MAX_WINDOW_SCALE for s in scales):
            raise ValueError(  # for embedders; HTTP rejects earlier
                f"scales must be in [1, {MAX_WINDOW_SCALE}], got {scales}")
        h, w = img.shape[:2]
        pad = max(scales)
        src = img if img.dtype == np.uint8 else img.astype(np.float32)
        big = _mirror_pad(src, pad)
        prob = np.zeros((h + 2 * pad, w + 2 * pad, self.nc), np.float32)
        cnt = np.zeros((h + 2 * pad, w + 2 * pad, 1), np.float32)
        B = self.window_batch

        def launches():
            for s in scales:
                stride = min(s, max(1, int(round(s * self.stride_fraction))))
                rows = window_origins(pad, pad + h, s, stride, big.shape[0] - s)
                cols = window_origins(pad, pad + w, s, stride, big.shape[1] - s)
                origins = [(r, c) for r in rows for c in cols]
                for lo in range(0, len(origins), B):
                    chunk = origins[lo : lo + B]
                    # zero rows past len(chunk) are padding: forwarded
                    # (one shape per (s, B)) but never accumulated.
                    batch = np.zeros((B, s, s, self.bands), big.dtype)
                    for i, (r, c) in enumerate(chunk):
                        batch[i] = big[r : r + s, c : c + s]
                    yield ((s, chunk),
                           lambda batch=batch: self.p.probs_device(batch))

        for (s, chunk), probs in self._pipelined(launches()):
            for i, (r, c) in enumerate(chunk):
                prob[r : r + s, c : c + s] += probs[i]
                cnt[r : r + s, c : c + s] += 1.0
        valid = prob[pad : pad + h, pad : pad + w]
        cval = np.maximum(cnt[pad : pad + h, pad : pad + w], 1e-9)
        return valid / cval

    # -- request-level API ---------------------------------------------- #
    def predict(self, img: np.ndarray, mode: str = "window",
                scales: Optional[List[int]] = None,
                want_probs: bool = True, tta: bool = False,
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if mode not in ("window", "dense"):
            raise ValueError(f"mode must be 'window' or 'dense', got {mode!r}")
        if img.ndim == 2:
            img = img[..., None]
        if img.ndim != 3 or img.shape[-1] != self.bands:
            raise ValueError(
                f"expected (H, W, {self.bands}) raster, got {img.shape}"
            )
        if tta:
            # Dihedral test-time augmentation (8x compute), with the
            # on-device TTA's transforms (dynseg_torch.ops.dihedral).
            from dynseg_torch.ops.dihedral import dihedral, dihedral_inv

            acc = None
            for k in range(8):
                im_k = np.ascontiguousarray(dihedral(img, k))
                p_k = (self.dense(im_k) if mode == "dense"
                       else self.window(im_k, scales))
                p_k = dihedral_inv(p_k, k)
                acc = p_k if acc is None else acc + p_k
            probs = acc / 8.0
            return probs.argmax(-1).astype(np.int32), probs
        if (mode == "dense" and not want_probs and img.dtype == np.uint8
                and self.p.has("dense_labels")):
            # labels fast path: uint8 up, device argmax, uint8 down.
            return self.dense_labels(img).astype(np.int32), None
        probs = self.dense(img) if mode == "dense" else self.window(img, scales)
        return probs.argmax(-1).astype(np.int32), probs


class ServerStats:
    """Request observability behind GET /metrics: counters and latency
    quantiles from a bounded ring (thread-safe; ThreadingHTTPServer
    handles requests concurrently)."""

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._window = window
        self._by_mode: dict = {}
        # /predict requests accepted and not yet recorded: the drain's
        # progress gauge.
        self._inflight = 0
        # Busy vs WEDGED: `stuck_device_calls` counts engine calls whose
        # request already got its 503 (deadline expired) but whose device
        # call never returned; `_started` times live requests so
        # /metrics can show the oldest one's age.
        self._started: dict = {}
        self._next_token = 0
        self._deadline_expired = 0
        self._stuck = 0

    def begin(self) -> int:
        with self._lock:
            self._inflight += 1
            self._next_token += 1
            self._started[self._next_token] = time.monotonic()
            return self._next_token

    def deadline_expired(self) -> None:
        with self._lock:
            self._deadline_expired += 1

    def stuck_begin(self) -> None:
        with self._lock:
            self._stuck += 1

    def stuck_end(self) -> None:
        with self._lock:
            self._stuck = max(0, self._stuck - 1)

    def record(self, mode: str, seconds: float, pixels: int,
               error: bool = False, token: Optional[int] = None) -> None:
        # mode is client-controlled: bound the key space.
        if mode not in ("window", "dense"):
            mode = "invalid"
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            self._started.pop(token, None)
            m = self._by_mode.setdefault(
                mode, {"requests": 0, "errors": 0, "pixels": 0, "lat": []})
            m["requests"] += 1
            if error:
                m["errors"] += 1
            else:
                m["pixels"] += int(pixels)
                m["lat"].append(seconds)
                if len(m["lat"]) > self._window:
                    m["lat"] = m["lat"][-self._window:]

    def snapshot(self) -> dict:
        with self._lock:
            now = time.monotonic()
            oldest = (round(now - min(self._started.values()), 3)
                      if self._started else None)
            out = {"uptime_s": round(now - self._t0, 1),
                   "inflight": self._inflight,
                   # oldest_inflight_s near the request deadline with
                   # stuck_device_calls > 0: the device is WEDGED.
                   "oldest_inflight_s": oldest,
                   "deadline_expired": self._deadline_expired,
                   "stuck_device_calls": self._stuck,
                   "wedged": self._stuck > 0,
                   "modes": {}}
            for mode, m in self._by_mode.items():
                lat = sorted(m["lat"])
                q = (lambda p: round(lat[min(len(lat) - 1,
                                             int(p * len(lat)))], 4)) \
                    if lat else (lambda p: None)
                out["modes"][mode] = {
                    "requests": m["requests"],
                    "errors": m["errors"],
                    "pixels": m["pixels"],
                    "latency_s": {"p50": q(0.5), "p90": q(0.9),
                                  "p99": q(0.99)},
                }
            return out


def _decode_body(body: bytes, content_type: str) -> np.ndarray:
    """Decode a request body. Undecodable input is the CLIENT's fault:
    decoder exceptions become ValueError, which the handler maps to 400
    (server faults get 500)."""
    try:
        if (content_type.startswith("application/x-npy")
                or body[:6] == b"\x93NUMPY"):
            return np.load(io.BytesIO(body), allow_pickle=False)
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(body)))
    except (ValueError, OSError, EOFError) as e:
        raise ValueError(f"undecodable request body: {e}") from e


def _encode_png(labels: np.ndarray, dataset: Optional[str]) -> bytes:
    from PIL import Image

    from dynseg_torch.data.datasets import PALETTES

    palette = PALETTES.get(dataset or "", None)
    if palette is None or len(palette) <= int(labels.max()):
        # no (or too small a) training palette: deterministic gray ramp
        ramp = np.linspace(0, 255, max(2, int(labels.max()) + 1)).astype(np.uint8)
        rgb = np.stack([ramp[labels]] * 3, axis=-1)
    else:
        rgb = np.asarray(palette, np.uint8)[labels]
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    return buf.getvalue()


def make_server(export_dir: str, host: str = "127.0.0.1", port: int = 8400,
                window_batch: int = 64, pipeline_depth: int = 4,
                dense_block: int = 1024, max_request_mb: int = 512,
                dense_block_batch: int = 8,
                engine: Optional[ServingEngine] = None,
                request_timeout_s: float = 300.0,
                socket_timeout_s: float = 60.0,
                device: str = "cuda") -> ThreadingHTTPServer:
    """Bind the HTTP server. Pass a pre-built (and pre-warmed) engine to
    avoid accepting connections before warm-up is done: the socket starts
    queueing requests the moment this binds. Without one, the artifact is
    loaded onto `device`.

    A device call that never returns must not wedge the server:
    `request_timeout_s` bounds each engine call, copies to the host
    included. On expiry the client gets a 503, the request leaves the
    in-flight gauge (so the SIGTERM drain can complete), and the abandoned
    call is counted in /metrics `stuck_device_calls` until it returns (0
    disables). `socket_timeout_s` bounds reads from a stalled CLIENT so
    the drain's join stays bounded; such requests get a best-effort 408."""
    if engine is None:
        engine = ServingEngine(ExportedPredictor.load(export_dir, device=device),
                               window_batch=window_batch,
                               pipeline_depth=pipeline_depth,
                               dense_block=dense_block,
                               dense_block_batch=dense_block_batch)
    manifest = engine.p.manifest
    stats = ServerStats()

    class Handler(BaseHTTPRequestHandler):
        # Per-connection socket timeout: a client that sends headers but
        # never finishes its body raises TimeoutError in the body read
        # instead of blocking this thread, and the drain, forever.
        timeout = socket_timeout_s or None

        def log_message(self, *a):  # quiet: the server logs elsewhere
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "net_type": manifest["net_type"],
                    "num_classes": manifest["num_classes"],
                    "checkpoint_step": manifest.get("checkpoint_step"),
                })
            elif path == "/manifest":
                self._json(200, manifest)
            elif path == "/metrics":
                self._json(200, dict(stats.snapshot(), spans=_span_totals()))
            else:
                self._json(404, {"error": f"no route {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                return self._json(404, {"error": f"no route {url.path}"})
            tok = stats.begin()  # every exit path below ends in stats.record
            t0 = time.monotonic()
            mode = "window"

            def drain():
                try:
                    length = int(self.headers.get("Content-Length", 0) or 0)
                except ValueError:
                    length = 0
                if _drain_capped(self.rfile, length) > 0:
                    # Anything past the cap: close instead of sinking it.
                    self.close_connection = True

            def client_error(status, msg):
                drain()
                stats.record(mode, time.monotonic() - t0, 0, error=True,
                             token=tok)
                return self._json(status, {"error": msg})

            def predict_with_deadline(img, mode, scales, want_probs, tta):
                """Run the engine call on a daemon worker and wait at most
                request_timeout_s. A launch or a copy to the host cannot be
                cancelled, so on expiry the WORKER is abandoned: it stays
                counted in /metrics stuck_device_calls until the device
                returns, and its engine-lock hold makes every queued
                request expire too, each with its own 503."""
                if request_timeout_s <= 0:
                    return engine.predict(img, mode=mode, scales=scales,
                                          want_probs=want_probs, tta=tta)
                box = {}
                done = threading.Event()
                abandoned = threading.Event()

                def work():
                    try:
                        box["val"] = engine.predict(
                            img, mode=mode, scales=scales,
                            want_probs=want_probs, tta=tta)
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        box["err"] = e
                    finally:
                        done.set()
                        # Only calls abandoned past their deadline count
                        # as stuck; stuck_end's clamp at zero nets out
                        # every interleaving with the waiter below.
                        if abandoned.is_set():
                            stats.stuck_end()

                threading.Thread(target=work, daemon=True).start()
                if not done.wait(request_timeout_s):
                    abandoned.set()
                    if not done.is_set():
                        stats.deadline_expired()
                        stats.stuck_begin()
                        raise _DeadlineExpired(
                            f"device call exceeded the "
                            f"{request_timeout_s:g}s request deadline "
                            "(device busy or wedged — see /metrics "
                            "stuck_device_calls)")
                if "err" in box:
                    raise box["err"]
                return box["val"]

            try:
                q = parse_qs(url.query)
                mode = q.get("mode", ["window"])[0]
                if mode not in ("window", "dense"):
                    return client_error(
                        400, f"unknown mode {mode!r}; accepted: window, dense")
                output = q.get("output", ["labels"])[0]
                if output not in ("labels", "probs", "png"):
                    return client_error(
                        400, f"unknown output {output!r}; "
                             "accepted: labels, probs, png")
                # Validate BEFORE reading the body, so that failures go
                # through client_error's drain.
                scales = None
                if "scales" in q:
                    try:
                        scales = [int(s) for s in q["scales"][0].split(",")]
                    except ValueError:
                        return client_error(
                            400, f"malformed scales {q['scales'][0]!r}; "
                                 "expected comma-separated integers")
                    if not scales or any(s < 1 for s in scales):
                        return client_error(
                            400, f"scales must be positive, got {scales}")
                    if any(s > MAX_WINDOW_SCALE for s in scales):
                        # Host buffers grow O((H + 2*max(scales))^2) and
                        # window batches O(B*s^2): one request must not
                        # exhaust the server's memory.
                        return client_error(
                            400, f"scales capped at {MAX_WINDOW_SCALE}, "
                                 f"got {scales}")
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    return client_error(400, "malformed Content-Length")
                if n < 0:
                    # rfile.read(-1) would read to EOF past the size cap.
                    return client_error(400, "malformed Content-Length")
                if n > max_request_mb * 1024 * 1024:
                    return client_error(
                        413, f"request body {n} bytes exceeds the "
                             f"{max_request_mb} MiB limit")
                img = _decode_body(self.rfile.read(n),
                                   self.headers.get("Content-Type", ""))
                labels, probs = predict_with_deadline(
                    img, mode=mode, scales=scales,
                    want_probs=(output == "probs"),
                    tta=q.get("tta", ["0"])[0] in ("1", "true"))
                px = int(labels.size)
                if output == "png":
                    body = _encode_png(labels, manifest.get("dataset"))
                    ctype = "image/png"
                else:
                    buf = io.BytesIO()
                    np.save(buf, probs if output == "probs" else labels)
                    body, ctype = buf.getvalue(), "application/x-npy"
            except _DeadlineExpired as e:
                # Device busy or wedged past the deadline: 503, and the
                # request leaves the in-flight gauge.
                stats.record(mode, time.monotonic() - t0, 0, error=True,
                             token=tok)
                return self._json(503, {"error": str(e)})
            except TimeoutError as e:
                # The CLIENT stalled mid-read: best-effort 408, then close.
                stats.record(mode, time.monotonic() - t0, 0, error=True,
                             token=tok)
                self.close_connection = True
                try:
                    return self._json(408, {"error": f"request body read "
                                            f"timed out: {e}"})
                except OSError:
                    return None
            except ValueError as e:
                # Malformed request (bad query values, undecodable body,
                # wrong band count); a KeyError is a server fault (500).
                stats.record(mode, time.monotonic() - t0, 0, error=True,
                             token=tok)
                return self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — genuine server fault
                stats.record(mode, time.monotonic() - t0, 0, error=True,
                             token=tok)
                traceback.print_exc()
                return self._json(500, {"error": str(e)})
            stats.record(mode, time.monotonic() - t0, px, token=tok)
            self._send(200, body, ctype)

    srv = ThreadingHTTPServer((host, port), Handler)
    # Non-daemon handler threads: socketserver tracks and joins them in
    # server_close, so a SIGTERM drain waits for in-flight handlers
    # (daemon threads, ThreadingHTTPServer's default, are not joined).
    srv.daemon_threads = False
    srv.engine = engine  # exposed for warmup() and embedders
    srv.stats = stats
    return srv


def warmup(engine: ServingEngine, size: int = 0) -> None:
    """Run every shape the serving programs will see before a request
    does: the engine's own dense block size in both input dtypes, every
    batch size of the dense menu, and one window batch per dtype at the
    largest scale. On the card the first call also builds the kernel
    library an int8 artifact launches (nvcc) and lets cuDNN pick its
    algorithms and the allocator grow its pools."""
    size = size or engine.dense_block
    img8 = np.zeros((size, size, engine.bands), np.uint8)
    imgf = img8.astype(np.float32)
    if engine.p.has("dense_labels"):
        engine.dense_labels(img8)
    engine.dense(img8)
    engine.dense(imgf)
    bb = engine.dense_block_batch
    ks, k = [], 2
    while k < bb:
        ks.append(k)
        k *= 2
    if bb > 1:
        ks.append(bb)  # full groups run exactly bb, even a non-pow2 one
    for k in ks:
        # A (size, size*k) raster forms exactly one k-block group per
        # estimator: the whole menu of batch sizes runs now.
        wide8 = np.zeros((size, size * k, engine.bands), np.uint8)
        if engine.p.has("dense_labels"):
            engine.dense_labels(wide8)
        engine.dense(wide8)
        engine.dense(wide8.astype(np.float32))
    s = max(engine.scales)
    engine.window(img8[:s, :s])
    engine.window(imgf[:s, :s])


def drain(srv, grace_s: float = 20.0, log=print) -> int:
    """Bounded shutdown drain (call AFTER serve_forever returns): wait up
    to grace_s for in-flight requests to finish, then close the server.
    Returns 0 on a clean drain, 1 if the grace expired with handlers
    still in flight (the caller then exits hard instead of letting
    server_close()'s unbounded join wait on a wedged device call)."""
    deadline = time.monotonic() + max(0.0, grace_s)
    stats = srv.stats
    while stats.snapshot()["inflight"] > 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    snap = stats.snapshot()
    if snap["inflight"] == 0:
        # Every handler has recorded its response, so the join in
        # server_close returns promptly. Abandoned device calls ride on
        # daemon threads that are never joined: report them.
        srv.server_close()
        if snap["stuck_device_calls"] > 0:
            log(f"drain: clean, but {snap['stuck_device_calls']} abandoned "
                "device call(s) never returned (wedged device)")
        return 0
    log(f"drain: grace {grace_s:g}s expired with {snap['inflight']} "
        f"request(s) still in flight (oldest {snap['oldest_inflight_s']}s, "
        f"stuck_device_calls={snap['stuck_device_calls']}) — abandoning "
        "the join; exiting hard")
    return 1


def _install_sigterm_handler(srv):
    """SIGTERM = clean drain: finish in-flight requests, close the socket.
    shutdown() must run OFF the signal-handling (main) thread: it blocks
    until serve_forever exits. Returns the previous handler."""
    import signal

    return signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=srv.shutdown).start())


def _peak(predictor: ExportedPredictor) -> str:
    """The card's peak allocated memory so far, for the log line."""
    if predictor.device.type != "cuda":
        return ""
    import torch

    return f"; device peak {torch.cuda.max_memory_allocated(predictor.device)} bytes"


def _k5_launches(predictor: ExportedPredictor) -> str:
    """K5's launches in this process since the last read, for the log
    line, where the artifact calls the op; the count restarts at 0."""
    if not predictor.manifest.get("custom_ops"):
        return ""
    from dynseg_torch.ops import int8_conv

    n = int8_conv.launches
    int8_conv.reset_launches()
    return f"; K5 launches {n}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dynseg_torch.serve",
        description="Serve a dynseg_torch export over HTTP",
    )
    ap.add_argument("--export_dir", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--window_batch", type=int, default=64)
    ap.add_argument("--dense_block", type=int, default=1024,
                    help="dense-estimator block size; warmup runs it")
    ap.add_argument("--dense_block_batch", type=int, default=8,
                    help="dense blocks stacked per device call (1 disables)")
    ap.add_argument("--pipeline_depth", type=int, default=4,
                    help="device calls per request whose results are not yet "
                         "copied to the host; each dense call holds "
                         "dense_block_batch blocks, so device memory scales "
                         "with depth*batch")
    ap.add_argument("--cross_batch_ms", type=float, default=0.0,
                    help="cross-request dynamic batching for the dense "
                         "estimators: coalesce blocks from concurrent "
                         "requests into one device call, lingering up to "
                         "this many ms (adds up to the linger to a lone "
                         "request's latency; 0 = off)")
    ap.add_argument("--max_request_mb", type=int, default=512,
                    help="reject request bodies above this size (413)")
    ap.add_argument("--request_timeout_s", type=float, default=300.0,
                    help="per-request deadline on the device calls and their "
                         "copies to the host: on expiry the client gets a 503 "
                         "and the abandoned call shows in /metrics "
                         "stuck_device_calls (0 disables). Size for the "
                         "slowest real request: TTA is 8x the compute")
    ap.add_argument("--socket_timeout_s", type=float, default=60.0,
                    help="per-connection socket timeout: a client that "
                         "stalls mid-body gets a 408 instead of pinning "
                         "a handler thread and the SIGTERM drain (0 disables)")
    ap.add_argument("--drain_grace_s", type=float, default=20.0,
                    help="SIGTERM drain grace: wait at most this long "
                         "for in-flight requests, then report and exit "
                         "hard (exit code 1)")
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip warm-up (the first requests then pay for the "
                         "kernel build and the first call of each shape)")
    ap.add_argument("--warmup_size", type=int, default=0,
                    help="warmup raster size (0 = --dense_block)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on: cuda (default; exits "
                         "non-zero where no card is visible) or cpu")
    args = ap.parse_args(argv)
    try:
        predictor = ExportedPredictor.load(args.export_dir, device=args.device)
    except RuntimeError as e:
        raise SystemExit(f"dynseg_torch.serve: {e}") from None
    engine = ServingEngine(predictor,
                           window_batch=args.window_batch,
                           pipeline_depth=args.pipeline_depth,
                           dense_block=args.dense_block,
                           dense_block_batch=args.dense_block_batch,
                           cross_batch_ms=args.cross_batch_ms)
    if not args.no_warmup:
        print("warming serving programs...", flush=True)
        t0 = time.perf_counter()
        warmup(engine, args.warmup_size)
        print(f"warm-up done in {time.perf_counter() - t0:.3f} s{_peak(predictor)}"
              f"{_k5_launches(predictor)}", flush=True)
    # Bind AFTER warm-up: the OS queues connections from the moment the
    # socket exists.
    srv = make_server(args.export_dir, args.host, args.port,
                      max_request_mb=args.max_request_mb, engine=engine,
                      request_timeout_s=args.request_timeout_s,
                      socket_timeout_s=args.socket_timeout_s)
    print(f"listening: {args.export_dir} on "
          f"http://{args.host}:{srv.server_port} ({predictor.device})",
          flush=True)
    _install_sigterm_handler(srv)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    rc = drain(srv, grace_s=args.drain_grace_s)
    print(("server stopped" if rc == 0 else "server stopped (drain grace "
           "expired; in-flight requests abandoned)") + _peak(predictor)
          + _k5_launches(predictor), flush=True)
    # Exit without interpreter finalization: every request is answered
    # and the socket is closed by now, and an abandoned device call on a
    # daemon thread must not hold the exit or fault in teardown.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


if __name__ == "__main__":
    raise SystemExit(main())
