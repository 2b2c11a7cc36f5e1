"""The port's serving layer (dynseg_torch.serve) against dynseg.serve.

The numpy layer: both packages' ServingEngines take the same numpy stub
predictor and must give bitwise the same maps in every mode (dense,
window, the labels fast path, TTA, cross-request batching), and the
host helpers are held to their originals. The HTTP layer: the port's
server over the port's artifact and the reference's server over the JAX
artifact (same weights, exported on the CPU) answer the same requests
with the same status codes, bodies and /metrics, expire a hung request
with a 503 and drain on SIGTERM."""

import dataclasses
import http.client
import io
import json
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from dynseg import serve as jserve
from dynseg.config import (Config, DataConfig, InferConfig, ModelConfig,
                           SchedulerConfig, TrainConfig)
from dynseg.export import export_predictor as jax_export
from dynseg_torch import config as port_config
from dynseg_torch import serve
from dynseg_torch.bridge import flax_to_torch, init_variables_np
from dynseg_torch.export import ExportedPredictor, export_predictor


class _Stub:
    """A numpy predictor for both engines: per-pixel softmax of a fixed
    linear map of a zero-padded 3 x 3 box sum of the raw bands, so that a
    block's border and its halo change the answer, as a conv net's do."""

    def __init__(self, halo: int = 6, nc: int = 3, bands: int = 3):
        self.halo = halo
        self.manifest = {
            "num_input_bands": bands, "num_classes": nc, "net_type": "stub",
            "dense_labels_halo": halo, "dataset": "synthetic",
            "inference": {"window_scales": [9, 13], "stride_fraction": 0.5,
                          "dense_halo": halo}}
        self.w = (np.random.default_rng(0).normal(size=(bands, nc)) / 300).astype(np.float32)
        self.calls = []

    def has(self, name: str) -> bool:
        return True

    def probs_device(self, x):
        x = np.asarray(x, np.float32)
        self.calls.append((x.shape, str(np.asarray(x).dtype)))
        pad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        box = sum(pad[:, i:i + x.shape[1], j:j + x.shape[2]]
                  for i in range(3) for j in range(3))
        logits = box @ self.w
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def dense_labels_device(self, x):
        p = self.probs_device(x)
        k = self.halo
        if k:
            p = p[:, k:-k, k:-k]
        return p.argmax(-1).astype(np.uint8)


def _image(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    return rng.uniform(0, 255, size=shape).astype(np.float32)


# (engine kwargs, predict kwargs, raster dtype) per serving mode.
MODES = {
    "dense_float": ({"dense_block": 16, "dense_block_batch": 3}, {"mode": "dense"}, np.float32),
    "dense_uint8": ({"dense_block": 16, "dense_block_batch": 8}, {"mode": "dense"}, np.uint8),
    "dense_labels": ({"dense_block": 16, "dense_block_batch": 3},
                     {"mode": "dense", "want_probs": False}, np.uint8),
    "window": ({"window_batch": 8}, {"mode": "window"}, np.float32),
    "window_scales": ({"window_batch": 16}, {"mode": "window", "scales": [7, 11]}, np.uint8),
    "tta_dense": ({"dense_block": 16}, {"mode": "dense", "tta": True}, np.float32),
    "tta_window": ({"window_batch": 8}, {"mode": "window", "tta": True}, np.uint8),
    "cross_batch": ({"dense_block": 16, "dense_block_batch": 4, "cross_batch_ms": 5.0},
                    {"mode": "dense"}, np.float32),
    "cross_batch_labels": ({"dense_block": 16, "dense_block_batch": 4, "cross_batch_ms": 5.0},
                           {"mode": "dense", "want_probs": False}, np.uint8),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_is_bitwise_the_reference_on_a_stub(mode):
    """Same stub, same raster: the same labels and probabilities, bit
    for bit, and the same sequence of predictor calls (shapes, dtypes)."""
    engine_kw, predict_kw, dtype = MODES[mode]
    img = _image((37, 29, 3), dtype, seed=len(mode))
    out = {}
    for name, mod in (("ref", jserve), ("port", serve)):
        stub = _Stub()
        labels, probs = mod.ServingEngine(stub, **engine_kw).predict(img, **predict_kw)
        out[name] = (labels, probs, stub.calls)
    (lr, pr, cr), (lp, pp, cp) = out["ref"], out["port"]
    assert lp.dtype == lr.dtype == np.int32
    np.testing.assert_array_equal(lp, lr)
    if pr is None:
        assert pp is None
    else:
        assert pp.dtype == pr.dtype and pp.tobytes() == pr.tobytes()
    if "cross" not in mode:  # the batcher's grouping depends on timing
        assert cp == cr


@pytest.mark.parametrize("hw_pad", [(5, 4, 11), (2, 7, 9), (1, 6, 4), (3, 4, 3)])
def test_mirror_pad_is_the_reference(hw_pad):
    h, w, pad = hw_pad
    img = np.random.default_rng(h * w).uniform(size=(h, w, 2)).astype(np.float32)
    np.testing.assert_array_equal(serve._mirror_pad(img, pad), jserve._mirror_pad(img, pad))


def test_host_helpers_are_the_reference():
    """_drain_capped, _decode_body and _encode_png give what the
    reference's give; ServerStats snapshots agree but for the clock."""

    class _Counting:
        def __init__(self, n):
            self.n, self.given = n, 0

        def read(self, k):
            k = min(k, self.n - self.given)
            self.given += k
            return b"\0" * k

    for declared in (100 << 20, 2 << 20, 0):
        a, b = _Counting(declared), _Counting(declared)
        assert serve._drain_capped(a, declared) == jserve._drain_capped(b, declared)
        assert a.given == b.given
    img = _image((12, 10, 3), np.uint8)
    npy, png = io.BytesIO(), io.BytesIO()
    np.save(npy, img)
    Image.fromarray(img).save(png, format="PNG")
    for body, ctype in ((npy.getvalue(), "application/x-npy"), (png.getvalue(), "image/png")):
        np.testing.assert_array_equal(serve._decode_body(body, ctype),
                                      jserve._decode_body(body, ctype))
    for mod in (serve, jserve):
        with pytest.raises(ValueError, match="undecodable"):
            mod._decode_body(b"garbage", "")
    labels = np.random.default_rng(1).integers(0, 6, (9, 11))
    for dataset in ("synthetic", "vaihingen", None):
        assert serve._encode_png(labels, dataset) == jserve._encode_png(labels, dataset)
    stats = []
    for mod in (serve, jserve):
        st = mod.ServerStats()
        tok = st.begin()
        st.begin()
        st.record("dense", 0.25, 100, token=tok)
        st.record("bogus", 0.1, 0, error=True)
        st.deadline_expired()
        st.stuck_begin()
        snap = st.snapshot()
        snap.pop("uptime_s")
        stats.append(snap)
    assert stats[0] == stats[1]


def test_warmup_runs_the_dense_batch_menu():
    """warmup() runs every (batch, shape, dtype) the dense estimators can
    send, the same calls as the reference's, so that no request meets a
    first call (dense_block_batch 6: pow2 groups and the full 6)."""
    calls = []
    for mod in (jserve, serve):
        stub = _Stub(halo=4)
        eng = mod.ServingEngine(stub, dense_block=16, dense_block_batch=6, window_batch=8)
        mod.warmup(eng, size=16)
        warm = set(stub.calls)
        for w_blocks in range(1, 9):
            img = _image((16, 16 * w_blocks, 3), np.uint8, seed=w_blocks)
            eng.dense(img)
            eng.dense(img.astype(np.float32))
        assert set(stub.calls) == warm, set(stub.calls) - warm
        calls.append(sorted(warm))
    assert calls[0] == calls[1]


# --------------------------------------------------------------------- #
# the HTTP layer, over the port's and the JAX artifact
# --------------------------------------------------------------------- #
def _cfg():
    return Config(
        model=ModelConfig(net_type="dilated_grsl", num_classes=3, num_input_bands=3,
                          width_multiplier=0.125),
        sched=SchedulerConfig(distribution_type="multi_fixed", values=(9, 13)),
        train=TrainConfig(batch_size=4, seed=0),
        infer=InferConfig(scales=(9, 13), window_batch=16, dense_halo=20),
        data=DataConfig(dataset="synthetic"),
    )


def _as(mod, cfg):
    vals = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(mod, type(cfg).__name__)(**{
        k: _as(mod, v) if dataclasses.is_dataclass(v) else v for k, v in vals.items()})


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The JAX artifact and the port's of the same seeded weights."""
    cfg = _cfg()
    variables = init_variables_np(_as(port_config, cfg.model), num_input_bands=3, seed=5)
    mean = np.array([100.0, 110.0, 120.0], np.float32)
    std = np.array([40.0, 41.0, 42.0], np.float32)
    tmp = tmp_path_factory.mktemp("serve_export")
    meta = {"dataset": "synthetic", "checkpoint_step": 7}
    jax_export(cfg, variables, mean, std, str(tmp / "jax"), platforms=("cpu",),
               extra_meta=meta)
    export_predictor(_as(port_config, cfg), flax_to_torch(variables), mean, std,
                     str(tmp / "port"), platforms=(), extra_meta=meta)
    return {"ref": str(tmp / "jax"), "port": str(tmp / "port"), "cfg": cfg,
            "variables": variables, "mean": mean, "std": std}


class _Servers:
    """The reference's server and the port's, each on an ephemeral port."""

    def __init__(self, artifacts, **kw):
        self.srv = {"ref": jserve.make_server(artifacts["ref"], port=0, **kw),
                    "port": serve.make_server(artifacts["port"], port=0, device="cpu", **kw)}
        self.threads = [threading.Thread(target=s.serve_forever, daemon=True)
                        for s in self.srv.values()]
        for t in self.threads:
            t.start()

    def url(self, name):
        return f"http://127.0.0.1:{self.srv[name].server_port}"

    def close(self):
        for s in self.srv.values():
            s.shutdown()
            s.server_close()


def _request(base, path, body=None, ctype="application/x-npy"):
    """(status, content type, body) of one request; errors included."""
    req = urllib.request.Request(f"{base}{path}", data=body,
                                 headers={"Content-Type": ctype} if body is not None else {},
                                 method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _npy(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def test_http_answers_and_metrics_match_reference(artifacts):
    """The same requests to both servers: the same status codes (400 for
    bad parameters and bodies, 413 past --max_request_mb, 404 for no
    route), answers of the same shape and type (probabilities within
    1e-5, labels equal), the same /healthz and /manifest fields, and
    /metrics with the same counters."""
    servers = _Servers(artifacts, window_batch=8, max_request_mb=1)
    img = _image((20, 18, 3), np.float32, seed=3)
    png = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(png, format="PNG")
    requests = [
        ("/predict?mode=dense", _npy(img), "application/x-npy"),
        ("/predict?mode=dense&output=probs", _npy(img), "application/x-npy"),
        ("/predict?mode=window&scales=9&output=probs", _npy(img), "application/x-npy"),
        ("/predict?mode=dense&output=labels", _npy(img.astype(np.uint8)), "application/x-npy"),
        ("/predict?mode=window&scales=9&output=png", png.getvalue(), "image/png"),
        ("/predict", b"garbage", ""),
        ("/predict?mode=dense&output=prob", _npy(img), "application/x-npy"),
        ("/predict?mode=bogus", _npy(img), "application/x-npy"),
        ("/predict?mode=window&scales=abc", _npy(img), "application/x-npy"),
        ("/predict?mode=window&scales=0", _npy(img), "application/x-npy"),
        ("/predict?mode=window&scales=30000000", _npy(img), "application/x-npy"),
        ("/predict?mode=dense", _npy(np.zeros((700, 700, 3), np.float32)), "application/x-npy"),
        ("/predict?mode=dense", _npy(np.zeros((9, 9, 5), np.float32)), "application/x-npy"),
        ("/elsewhere", b"x", ""),
    ]
    try:
        answers = {}
        for name in ("ref", "port"):
            base = servers.url(name)
            got = [_request(base, *r) for r in requests]
            conn = http.client.HTTPConnection("127.0.0.1", servers.srv[name].server_port,
                                              timeout=10)
            conn.putrequest("POST", "/predict?mode=dense")
            conn.putheader("Content-Length", "-1")
            conn.endheaders()
            got.append((conn.getresponse().status, None, b""))
            conn.close()
            got += [_request(base, p) for p in ("/healthz", "/manifest", "/metrics", "/nowhere")]
            answers[name] = got
        ref, port = answers["ref"], answers["port"]
        assert [a[0] for a in port] == [a[0] for a in ref]
        assert [a[0] for a in ref[:5]] == [200] * 5
        assert [a[0] for a in ref[5:15]] == [400, 400, 400, 400, 400, 400, 413, 400, 404, 400]
        for (_, ct_p, body_p), (_, ct_r, body_r) in zip(port[:5], ref[:5]):
            assert ct_p == ct_r
            if ct_r == "image/png":
                continue
            a, b = np.load(io.BytesIO(body_p)), np.load(io.BytesIO(body_r))
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        for (_, _, body_p), (_, _, body_r) in zip(port[5:14], ref[5:14]):
            assert "error" in json.loads(body_p) and "error" in json.loads(body_r)
        hz_p, hz_r = (json.loads(a[15][2]) for a in (port, ref))
        assert hz_p == hz_r
        man_p, man_r = (json.loads(a[16][2]) for a in (port, ref))
        assert man_p["net_type"] == man_r["net_type"] and man_p["inference"] == man_r["inference"]
        met_p, met_r = (json.loads(a[17][2]) for a in (port, ref))
        # The port's /metrics adds its serve.* spans to the reference's keys.
        spans = met_p.pop("spans")
        assert {"serve.queue", "serve.device", "serve.to_host"} <= set(spans)
        assert all(v["calls"] > 0 and v["seconds"] >= 0 for v in spans.values())
        assert met_p.keys() == met_r.keys()
        for m in (met_p, met_r):
            m.pop("uptime_s")
            for mode in m["modes"].values():
                mode["latency_s"] = sorted(mode["latency_s"])
        assert met_p == met_r
        assert met_p["modes"]["dense"]["requests"] == 7
    finally:
        servers.close()


class _BlockingEngine:
    """An engine whose predict blocks until released: a hung device."""

    def __init__(self, release: threading.Event):
        from types import SimpleNamespace

        self.release = release
        self.entered = threading.Event()
        self.p = SimpleNamespace(manifest={
            "net_type": "dilated_grsl", "num_classes": 3, "num_input_bands": 3,
            "dataset": "synthetic"})

    def predict(self, img, mode="window", scales=None, want_probs=True, tta=False):
        self.entered.set()
        self.release.wait()
        return np.zeros(img.shape[:2], np.int32), None


def _post_async(base, results):
    def run():
        code = _request(base, "/predict?mode=dense&output=labels",
                        _npy(np.zeros((16, 16, 3), np.float32)))[0]
        results.append(code)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _deadline_story(mod):
    """A hung request against `mod`'s server: the metrics while it is
    inside its deadline, its status, the metrics after, and after the
    device returns."""
    release = threading.Event()
    eng = _BlockingEngine(release)
    srv = mod.make_server("unused", port=0, engine=eng, request_timeout_s=0.5)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_port}"

    def flags():
        m = json.loads(_request(base, "/metrics")[2])
        return {k: m[k] for k in ("inflight", "deadline_expired", "stuck_device_calls",
                                  "wedged")}

    try:
        results = []
        t = _post_async(base, results)
        assert eng.entered.wait(10)
        busy = flags()
        t.join(timeout=30)
        wedged = flags()
        release.set()
        for _ in range(100):
            after = flags()
            if after["stuck_device_calls"] == 0:
                break
            time.sleep(0.05)
        return busy, results, wedged, after
    finally:
        release.set()
        threading.Thread(target=srv.shutdown).start()
        srv.server_close()


def test_request_deadline_503_matches_reference():
    """A device call that never returns: busy (not wedged) within the
    deadline, then a 503, a wedged /metrics, and a recovery once the call
    returns, as the reference's server reports them."""
    port = _deadline_story(serve)
    assert port == _deadline_story(jserve)
    busy, results, wedged, after = port
    assert busy["inflight"] == 1 and not busy["wedged"]
    assert results == [503]
    assert wedged == {"inflight": 0, "deadline_expired": 1, "stuck_device_calls": 1,
                      "wedged": True}
    assert after["stuck_device_calls"] == 0 and not after["wedged"]


def test_sigterm_drains_accepted_requests(artifacts):
    """The production SIGTERM handler: a request in flight when SIGTERM
    arrives still gets its 200, serve_forever returns and drain() closes
    cleanly (0); a wedged handler makes drain() give up after its grace
    (1) instead of joining forever."""
    srv = serve.make_server(artifacts["port"], port=0, window_batch=8, device="cpu")
    assert srv.daemon_threads is False
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    gate = threading.Event()
    predict = srv.engine.predict

    def slow(*a, **k):
        gate.wait(10)
        return predict(*a, **k)

    srv.engine.predict = slow
    results = []
    t = _post_async(base, results)
    for _ in range(500):
        if json.loads(_request(base, "/metrics")[2])["inflight"] > 0:
            break
        time.sleep(0.01)
    prev = serve._install_sigterm_handler(srv)
    try:
        signal.raise_signal(signal.SIGTERM)
        time.sleep(0.2)
        gate.set()
        th.join(timeout=30)
        assert not th.is_alive()
        assert serve.drain(srv, grace_s=10, log=lambda *a: None) == 0
    finally:
        signal.signal(signal.SIGTERM, prev)
    t.join(timeout=30)
    assert results == [200]

    release = threading.Event()
    srv = serve.make_server("unused", port=0, engine=_BlockingEngine(release),
                            request_timeout_s=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        _post_async(f"http://127.0.0.1:{srv.server_port}", [])
        for _ in range(500):
            if srv.stats.snapshot()["inflight"]:
                break
            time.sleep(0.01)
        srv.shutdown()
        msgs = []
        t0 = time.monotonic()
        assert serve.drain(srv, grace_s=0.5, log=msgs.append) == 1
        assert time.monotonic() - t0 < 10 and any("grace" in m for m in msgs)
    finally:
        release.set()
        srv.server_close()


def test_window_voting_matches_the_inferencer(artifacts):
    """The port's engine over the port's artifact and the port's
    Inferencer (on-device overlap-add) are one estimator: probabilities
    within float tolerance."""
    from dynseg_torch.data.tiles import TileSet
    from dynseg_torch.infer import Inferencer

    cfg = _as(port_config, artifacts["cfg"])
    h = w = 24
    img = _image((h, w, 3), np.float32, seed=9)
    tiles = TileSet(images=img[None], masks=np.zeros((1, h, w), np.int32),
                    valid_hw=np.array([[h, w]], np.int32),
                    mean=artifacts["mean"], std=artifacts["std"])
    inf = Inferencer(cfg, tiles, "cpu")
    pred_dev, prob_dev = inf.predict_tile(flax_to_torch(artifacts["variables"]), 0)
    eng = serve.ServingEngine(ExportedPredictor.load(artifacts["port"], device="cpu"),
                              window_batch=16)
    labels, probs = eng.predict(img, mode="window")
    np.testing.assert_allclose(probs, prob_dev, atol=2e-4, rtol=1e-3)
    assert (labels == pred_dev).mean() > 0.995


def test_main_refuses_a_missing_card(artifacts, monkeypatch):
    """python -m dynseg_torch.serve --device cuda (the default) where no
    card is visible exits with a message; --operation serve without an
    export names the missing export."""
    from dynseg_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        serve.main(["--export_dir", artifacts["port"]])
    with pytest.raises(SystemExit, match="no export"):
        cli.main(["--operation", "serve", "--device", "cpu", "--output_path",
                  artifacts["port"] + "_none"])


def test_stop_line_counts_k5_launches_of_an_int8_artifact(monkeypatch):
    """The warm-up and stop lines name K5's launches (the count then
    restarts at 0) where the artifact calls the op, and not otherwise."""
    from dynseg_torch.ops import int8_conv

    monkeypatch.setattr(int8_conv, "launches", 5)
    int8 = dataclasses.make_dataclass("P", ["manifest"])(
        {"custom_ops": ["dynseg_torch::int8_block_conv"]})
    assert serve._k5_launches(dataclasses.replace(int8, manifest={})) == ""
    assert int8_conv.launches == 5
    assert serve._k5_launches(int8) == "; K5 launches 5"
    assert int8_conv.launches == 0
    assert serve._k5_launches(int8) == "; K5 launches 0"
