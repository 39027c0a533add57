"""The port's HTTP serving layer (``optimaltextures_tpu_torch/serve.py``) on
the CPU: ``serve(port=0, device="cpu")`` driven through real HTTP, the same
request parsing, config fields and pack file names as the JAX package's
``serve.py``, and tests/test_serve.py's cases on the port (64 px, 1 pass, 4
iterations, no multires, depth 2; styles from docs/samples/). Served bytes
are held against direct ``Synthesizer.run`` calls of the port: the noise is
torch's, not JAX's."""

import base64
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu import core as jcore
from optimaltextures_tpu import serve as jserve
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "docs", "samples")
STYLE = os.path.join(SAMPLES, "graffiti_cholhist_256.png")
STYLE_B = os.path.join(SAMPLES, "zebra_pattern_lava_mix3_256.png")
STYLE_C = os.path.join(SAMPLES, "graffiti_sort_512.png")
CFG = {"size": 64, "passes": 1, "iters": 4, "no_multires": True, "depth": 2}
PNG = b"\x89PNG\r\n\x1a\n"


def _b64(path):
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


def _payload(**cfg):
    return {"config": {**CFG, **cfg}, "style_b64": [_b64(STYLE)]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _serving(**kw):
    srv = serve.serve(port=0, device="cpu", **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()


@pytest.fixture(scope="module")
def served():
    with _serving() as (srv, url):
        yield srv, url


@pytest.fixture(scope="module")
def server(served):
    return served[1]


def _post(url, payload, raw=None, headers=None):
    """POST; returns (status, headers, body) for successes and refusals."""
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"{url}/v1/synthesize", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _get(url, path):
    with urllib.request.urlopen(f"{url}{path}", timeout=60) as r:
        return r.read()


def _pixels(body):
    return np.asarray(Image.open(io.BytesIO(body)))


def _metric(text, name):
    return float([ln for ln in text.splitlines()
                  if ln.startswith(name + " ") or ln.startswith(name + "{")
                  ][0].rsplit(" ", 1)[1])


def _direct(cfg_kw, styles_b64, init=None, content=None):
    """What a seeded request must return: a direct port run on the same
    decoded images and the run's noise (core.draw_noise)."""
    cfg = tconfig.OptexConfig(style=["x"] * len(styles_b64), **cfg_kw)
    styles = [serve._decode_image(b, cfg.size, True, cfg.style_scale)
              for b in styles_b64]
    synth = tcore.Synthesizer(cfg, device="cpu")
    key = synth.next_run_key()
    if init is not None:
        noise = init
    else:
        shape = content.shape if content is not None else (
            cfg.batch, cfg.size, cfg.out_width or cfg.size, 3)
        noise = tcore.draw_noise("cpu", key, shape)
    return synth.run(noise, styles, content, key=key,
                     quantize_uint8=True).numpy()


# ---------------------------------------------------------------------------
# the same request surface as the JAX package's


def test_config_fields_match_jax_and_the_dataclass():
    fields = {f.name for f in dataclasses.fields(tconfig.OptexConfig)}
    assert serve._CONFIG_FIELDS == jserve._CONFIG_FIELDS
    assert serve._IO_FIELDS == jserve._IO_FIELDS
    assert serve._CONFIG_FIELDS | serve._IO_FIELDS == fields
    assert not serve._CONFIG_FIELDS & serve._IO_FIELDS


_PARSE_CASES = {
    "single": {"config": {**CFG, "seed": 3, "style_scale": 0.5,
                          "hist_mode": "sym", "content_strength": 0.2,
                          "not_a_field": 1},
               "style_b64": [_b64(STYLE)], "content_b64": _b64(STYLE_B),
               "init_b64": _b64(STYLE_C), "format": "jpeg"},
    # the multi-device layouts: batch-parallel, spatial, the 2-D grid
    "dp": {"config": {**CFG, "seed": 3, "num_devices": 2, "batch": 4,
                      "style_scale": 0.5},
           "style_b64": [_b64(STYLE)], "format": "jpeg"},
    "spatial": {"config": {**CFG, "seed": 3, "spatial_devices": 2,
                           "style_scale": 0.5},
                "style_b64": [_b64(STYLE)], "content_b64": _b64(STYLE_B),
                "format": "jpeg"},
    "grid": {"config": {**CFG, "num_devices": 2, "spatial_devices": 2,
                        "batch": 2, "style_scale": 0.5},
             "style_b64": [_b64(STYLE), _b64(STYLE_B)], "format": "jpeg"},
}


def test_parse_request_matches_jax():
    for case, payload in _PARSE_CASES.items():
        got = serve._parse_request(payload)
        ref = jserve._parse_request(payload)
        assert dataclasses.asdict(got.cfg) == dataclasses.asdict(ref.cfg), case
        assert got.token == ref.token and got.fmt == ref.fmt == "jpeg"
        for a, b in zip(got.styles + [got.content, got.init],
                        ref.styles + [ref.content, ref.init]):
            if b is None:
                assert a is None, case
                continue
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=case)
        assert got.styles[0].shape == (1, 32, 32, 3)   # style_scale at load


def test_pack_path_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("OPTEX_PACK_DIR", str(tmp_path))
    kw = dict(size=64, passes=2, iters=4, depth=2, pca_bucket=8,
              style=["x"], fast_codec=False)
    token = serve._parse_request(_payload()).token
    got = serve._pack_path(tcore.Synthesizer(tconfig.OptexConfig(**kw),
                                             device="cpu"), token)
    ref = jserve._pack_path(jcore.Synthesizer(jconfig.OptexConfig(**kw)), token)
    assert got == ref and os.path.basename(got).startswith("pack_")


# ---------------------------------------------------------------------------
# routes and refusals


def test_healthz(server):
    body = json.loads(_get(server, "/healthz"))
    assert body["status"] == "ok" and body["devices"] == ["cpu"]
    assert body["workers"] == 1 and isinstance(body["cached"], int)


@pytest.mark.parametrize("payload,raw,headers,code,message", [
    ({"config": {}}, None, None, 400, "style_b64"),
    (_payload(batch=0), None, None, 400, "out of range"),
    ({**_payload(), "format": "webp"}, None, None, 400, "png|jpeg|npy"),
    (None, b"{not json", None, 400, ""),
    (None, b"x", {"Content-Length": str(serve._MAX_REQUEST_BYTES + 1)}, 413,
     "outside"),
    ({**_payload(), "style_parallel": True, "content_b64": _b64(STYLE)},
     None, None, 400, "synthesis-only"),
    (_payload(tileable=True, size=66, depth=3), None, None, 400, "divisible"),
    # multi-device requests: more devices than workers, a batch that does
    # not split, a pass size that does not (refused before a rank starts)
    (_payload(num_devices=3, batch=3), None, None, 400,
     "requested 3 devices, have 1"),
    (_payload(num_devices=2, batch=3), None, None, 400,
     "batch 3 not divisible by num_devices 2"),
    (_payload(spatial_devices=2, size=66), None, None, 400, "divisible"),
])
def test_refusals(served, payload, raw, headers, code, message):
    srv, url = served
    status, _, body = _post(url, payload, raw, headers)
    assert status == code
    assert message in json.loads(body)["error"]
    assert not srv.workers._groups and list(srv.workers._free) == [0]


def test_unknown_routes(server):
    for call in (lambda: _get(server, "/nope"),
                 lambda: urllib.request.urlopen(urllib.request.Request(
                     f"{server}/v1/other", data=b"{}"))):
        with pytest.raises(urllib.error.HTTPError) as e:
            call()
        assert e.value.code == 404


def test_metrics_count_every_request():
    with _serving() as (_, url):
        assert _post(url, _payload(seed=0))[0] == 200
        assert _post(url, {"config": {}})[0] == 400
        assert _post(url, _payload(num_devices=2, batch=2))[0] == 400
        text = _get(url, "/metrics").decode()
    assert _metric(text, 'optex_requests_total{outcome="ok"}') == 1
    assert _metric(text, 'optex_requests_total{outcome="client_error"}') == 2
    assert _metric(text, 'optex_requests_total{outcome="server_error"}') == 0
    assert _metric(text, "optex_request_seconds_count") == 1
    assert _metric(text, "optex_request_seconds_sum") > 0
    assert _metric(text, "optex_workers") == 1
    assert _metric(text, "optex_cached_synthesizers") == 1
    assert _metric(text, "optex_coalesced_cohorts_total") == 0


def test_body_read_deadlines():
    """A trickle client is cut off by the total deadline; a stalled upload
    gets a 408 and the server answers afterwards."""
    class Trickle:
        def read1(self, n):
            time.sleep(0.01)
            return b"x"

    with pytest.raises(TimeoutError):
        serve._read_body_deadline(Trickle(), 10_000, deadline_s=0.05)

    class Normal:
        def __init__(self, data):
            self.buf = data

        def read1(self, n):
            out, self.buf = self.buf[:n], self.buf[n:]
            return out

    assert serve._read_body_deadline(Normal(b"a" * 100), 100) == b"a" * 100

    with _serving() as (srv, url):
        srv.RequestHandlerClass.timeout = 1
        s = socket.create_connection(("127.0.0.1", srv.server_address[1]),
                                     timeout=10)
        s.sendall(b"POST /v1/synthesize HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: 1000\r\n\r\n{")
        data = s.recv(4096)
        s.close()
        assert b"408" in data.split(b"\r\n", 1)[0], data[:80]
        assert json.loads(_get(url, "/healthz"))["status"] == "ok"


def test_serve_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve(port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.SynthesizerPool().get(tconfig.OptexConfig(**CFG, style=["x"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(tcore, "full_f32_precision", lambda: None)
    with pytest.raises(ValueError, match="only 1 devices"):
        serve.WorkerSet(2)
    with pytest.raises(ValueError, match="unknown config defaults"):
        serve.serve(port=0, device="cpu", config_defaults={"nope": 1})
    # python -m optimaltextures_tpu_torch.serve asks for the GPU
    asked = {}

    class Stub:
        def serve_forever(self):
            pass

    monkeypatch.setattr(serve, "serve",
                        lambda *a, **kw: asked.update(kw) or Stub())
    monkeypatch.setattr("sys.argv", ["serve", "--port", "0"])
    serve.main()
    assert asked["device"] == "cuda"


# ---------------------------------------------------------------------------
# what a request returns


@pytest.mark.parametrize("extra", [{}, {"style_scale": 0.5},
                                   {"hist_mode": "cdf"}])
def test_seeded_requests_identical_and_equal_a_direct_run(server, extra):
    payload = _payload(seed=5, **extra)
    a, b = _post(server, payload), _post(server, payload)
    assert a[0] == b[0] == 200 and a[1]["Content-Type"] == "image/png"
    assert a[2] == b[2]
    want = _direct({**CFG, "seed": 5, **extra}, payload["style_b64"])
    np.testing.assert_array_equal(_pixels(a[2]), want[0])


def test_unseeded_requests_differ(server):
    a, b = _post(server, _payload()), _post(server, _payload())
    assert a[2][:8] == b[2][:8] == PNG and a[2] != b[2]


def test_batch_request_returns_every_image_as_json(server):
    status, headers, body = _post(server, _payload(seed=1, batch=2))
    assert status == 200 and headers["Content-Type"] == "application/json"
    images = [base64.b64decode(s) for s in json.loads(body)["images_b64"]]
    assert len(images) == 2 and all(im[:8] == PNG for im in images)
    want = _direct({**CFG, "seed": 1, "batch": 2}, [_b64(STYLE)])
    np.testing.assert_array_equal(np.stack([_pixels(im) for im in images]),
                                  want)


def test_response_formats(server):
    base = _payload(seed=5)
    png, npy, jpg = (_post(server, {**base, "format": f})
                     for f in ("png", "npy", "jpeg"))
    assert (png[1]["Content-Type"], npy[1]["Content-Type"],
            jpg[1]["Content-Type"]) == (
        "image/png", "application/octet-stream", "image/jpeg")
    arr = np.load(io.BytesIO(npy[2]))
    assert arr.dtype == np.uint8 and arr.shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(arr[0], _pixels(png[2]))
    assert jpg[2][:2] == b"\xff\xd8"
    err = np.abs(_pixels(jpg[2]).astype(np.int16) - arr[0].astype(np.int16))
    assert err.mean() < 30.0   # quality-92 JPEG of the same image


@pytest.mark.parametrize("which", ["content", "init"])
def test_content_and_init_requests(server, which):
    payload = {**_payload(seed=2, content_strength=0.2),
               f"{which}_b64": _b64(STYLE_B)}
    status, _, body = _post(server, payload)
    assert status == 200
    img = serve._decode_image(_b64(STYLE_B), 64, oversize=False)
    want = _direct({**CFG, "seed": 2, "content_strength": 0.2},
                   payload["style_b64"], **{which: img})
    np.testing.assert_array_equal(_pixels(body), want[0])


def test_three_style_mixing_request(server):
    styles = [_b64(p) for p in (STYLE, STYLE_B, STYLE_C)]
    outs = []
    for weights in ([1.0, 1.0, 1.0], [1.0, 2.0, 5.0]):
        status, _, body = _post(server, {
            "config": {**CFG, "seed": 0, "mixing_weights": weights},
            "style_b64": styles})
        assert status == 200
        outs.append(body)
    assert outs[0] != outs[1]
    want = _direct({**CFG, "seed": 0, "mixing_weights": [1.0, 2.0, 5.0]},
                   styles)
    np.testing.assert_array_equal(_pixels(outs[1]), want[0])


def test_config_defaults_applied_and_overridable():
    with _serving(config_defaults={"pca_bucket": 8, "iters": 2}) as (srv, url):
        base = {k: v for k, v in CFG.items() if k != "iters"}
        assert _post(url, {"config": {**base, "seed": 0},
                           "style_b64": [_b64(STYLE)]})[0] == 200
        ws = srv.workers
        cfgs = [s.cfg for s in ws.pools[0]._cache.values()]
        assert [(c.pca_bucket, c.iters) for c in cfgs] == [(8, 2)]
        _post(url, {"config": {**base, "seed": 0, "pca_bucket": 0},
                    "style_b64": [_b64(STYLE)]})
        assert {s.cfg.pca_bucket for s in ws.pools[0]._cache.values()} == {0, 8}


# ---------------------------------------------------------------------------
# pools and workers


def test_pool_lru_and_seed_sweep():
    pool = serve.SynthesizerPool(device=torch.device("cpu"))
    base = dict(size=64, passes=1, no_multires=True, depth=1, style=["s"])
    # seeds share one Synthesizer; a fixed seed keeps its key whatever ran
    # between; unseeded requests differ
    s1 = pool.get(tconfig.OptexConfig(seed=1, iters=2, **base))
    assert pool.get(tconfig.OptexConfig(seed=2, iters=2, **base)) is s1
    k1 = pool.get(tconfig.OptexConfig(seed=1, iters=2, **base)).next_run_key()
    pool.get(tconfig.OptexConfig(seed=2, iters=2, **base)).next_run_key()
    assert pool.get(tconfig.OptexConfig(seed=1, iters=2, **base)).next_run_key() == k1
    unseeded = pool.get(tconfig.OptexConfig(iters=2, **base))
    assert unseeded.next_run_key() != unseeded.next_run_key()
    assert len(pool) == 1
    # the LRU: the coldest entry goes
    cfgs = [tconfig.OptexConfig(seed=0, iters=3 + i, **base)
            for i in range(serve.SynthesizerPool.MAX_ENTRIES)]
    for c in cfgs:
        pool.get(c)
    assert len(pool) == serve.SynthesizerPool.MAX_ENTRIES
    assert pool.get(tconfig.OptexConfig(seed=0, iters=2, **base)) is not s1
    warm = pool.get(cfgs[-1])
    assert pool.get(cfgs[-1]) is warm


def test_two_cpu_workers_under_concurrent_load():
    with _serving(workers=2) as (_, url):
        assert json.loads(_get(url, "/healthz"))["devices"] == ["cpu", "cpu"]
        seeded = _payload(seed=0)
        r1, r2 = _post(url, seeded), _post(url, seeded)
        # sequential requests rotate over the FIFO queue; both workers give
        # the same seeded bytes
        assert {r1[1]["X-Optex-Worker"], r2[1]["X-Optex-Worker"]} == {"0", "1"}
        assert r1[2] == r2[2]
        with concurrent.futures.ThreadPoolExecutor(6) as ex:
            results = list(ex.map(lambda _: _post(url, seeded), range(6)))
        assert all(s == 200 and b == r1[2] for s, _, b in results)
        text = _get(url, "/metrics").decode()
    assert _metric(text, 'optex_requests_total{outcome="ok"}') == 8


# ---------------------------------------------------------------------------
# style-parallel requests (one texture per style)


def _sp_payload(num_devices, styles=(STYLE, STYLE_B), **cfg):
    return {"config": {**CFG, "passes": 2, "iters": 12, "seed": 4,
                       "pca_bucket": 16, "num_devices": num_devices, **cfg},
            "style_b64": [_b64(p) for p in styles], "style_parallel": True,
            "format": "npy"}


@pytest.mark.parametrize("num_devices", [1, 2])
def test_style_parallel_request_equals_a_direct_run(num_devices):
    """Two CPU workers. num_devices 1: both styles on one worker;
    num_devices 2: one style a worker, checked out together, on threads of
    their own, the widths agreed first. Either way the bytes of a direct
    style_dp.synthesize_style_batch of both styles in one process."""
    from optimaltextures_tpu_torch.parallel import style_dp

    payload = _sp_payload(num_devices)
    with _serving(workers=2) as (srv, url):
        status, headers, body = _post(url, payload)
        assert status == 200, body
        assert headers["X-Optex-Worker"] == ("0" if num_devices == 1
                                             else "0,1")
        again = _post(url, payload)[2]
        assert len(srv.workers._free) == 2      # every worker checked in
    got = np.load(io.BytesIO(body))
    assert got.shape == (2, 64, 64, 3) and again == body
    cfg = tconfig.OptexConfig(style=["x", "x"], **payload["config"])
    styles = [serve._decode_image(b, 64, True) for b in payload["style_b64"]]
    want = tcore._quant_u8(style_dp.synthesize_style_batch(
        cfg, styles, None, device="cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[0].astype(int) - got[1]).mean() > 5


@pytest.mark.parametrize("payload,code,message", [
    (_sp_payload(3, styles=(STYLE, STYLE_B, STYLE_C)), 400,
     "requested 3 devices, have 2"),
    (_sp_payload(2, styles=(STYLE,)), 400, "1 styles for num_devices=2"),
    (_sp_payload(2, batch=2), 400, "does not support: batch"),
    (_sp_payload(1, spatial_devices=2), 400,
     "does not support: spatial_devices"),
    (_sp_payload(1, mixing_alpha=0.3), 400, "does not support: mixing_alpha"),
    # not style-parallel: the multi-device route's refusal, in the same words
    (_payload(num_devices=3, batch=3), 400, "requested 3 devices, have 2"),
])
def test_style_parallel_refusals(payload, code, message):
    with _serving(workers=2) as (srv, url):
        status, _, body = _post(url, payload)
        assert len(srv.workers._free) == 2
    assert status == code and message in json.loads(body)["error"]


def test_checkout_many_takes_a_whole_set():
    """A request for two workers waits while one is busy and takes both at
    once when it frees; single checkouts keep their FIFO order."""
    ws = serve.WorkerSet(3, device="cpu")
    assert ws.checkout() == 0
    got = []
    t = threading.Thread(target=lambda: got.append(ws.checkout_many(3)))
    t.start()
    time.sleep(0.2)
    assert not got                      # two free, three wanted
    ws.checkin(0)
    t.join(10)
    assert not t.is_alive() and sorted(got[0]) == [0, 1, 2]
    for i in got[0]:
        ws.checkin(i)
    assert ws.checkout_many(2) == [1, 2]


# ---------------------------------------------------------------------------
# queue-time coalescing


def test_pad_cohort_and_batchable():
    assert [serve._pad_cohort(n) for n in (1, 2, 3, 4, 5, 7, 8)] == \
        [1, 2, 4, 4, 8, 8, 8]
    assert serve._batchable(serve._parse_request(_payload()))
    for bad in ({"seed": 3}, {"batch": 2}, {"num_devices": 2, "batch": 2},
                {"spatial_devices": 2}):
        assert not serve._batchable(serve._parse_request(_payload(**bad)))
    two = {**_payload(), "style_b64": [_b64(STYLE), _b64(STYLE_B)]}
    assert not serve._batchable(serve._parse_request(two))
    withc = {**_payload(), "content_b64": _b64(STYLE)}
    assert not serve._batchable(serve._parse_request(withc))


def _wait(cond, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        got = cond()
        if got:
            return got
        time.sleep(0.01)
    raise AssertionError("the coalescer never reached the awaited state")


def _queue(co, ex, fn, n):
    """Submit ``fn`` n times, the first alone, and wait until all n sit in
    cohorts (the first cohort's list stays with its leader when a full
    cohort rolls over, so it is counted apart)."""
    def open_lists():
        with co.lock:
            return list(co._open.values())

    futs = [ex.submit(fn)]
    first = _wait(lambda: next(iter(open_lists()), None))
    futs += [ex.submit(fn) for _ in range(n - 1)]
    _wait(lambda: len(first) + sum(len(c) for c in open_lists()
                                   if c is not first) == n)
    return futs


@pytest.mark.parametrize("max_batch,fail,calls", [
    (8, False, [3]),        # three queued requests run as one cohort
    (2, False, [1, 2]),     # past max_batch: a cohort of 2, then one of 1
    (8, True, [3])])        # a failing cohort fails every member
def test_coalescer(monkeypatch, max_batch, fail, calls):
    ws = serve.WorkerSet(1, device="cpu")
    co = serve.RequestCoalescer(ws, max_batch=max_batch)
    seen = []

    def fake_cohort(pool, members):
        seen.append(len(members))
        if fail:
            raise ValueError("bad cohort")
        return [("image/png", f"img{i}".encode()) for i in range(len(members))]

    monkeypatch.setattr(serve, "_execute_cohort", fake_cohort)
    req = serve._parse_request(_payload())
    hold = ws.checkout()          # make the only worker busy
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = _queue(co, ex, lambda: co.submit(req), 3)
        ws.checkin(hold)
        if fail:
            for f in futs:
                with pytest.raises(ValueError, match="bad cohort"):
                    f.result(timeout=30)
        else:
            results = [f.result(timeout=30) for f in futs]
    assert sorted(seen) == calls
    if not fail:
        assert sorted(n for *_, n in results) == sorted(
            n for n in calls for _ in range(n))
        big = max(calls)
        assert (co.coalesced_cohorts, co.coalesced_requests) == (1, big)
    ws.checkin(ws.checkout())     # the worker is back in the queue


def test_coalesced_http_cohort_end_to_end():
    """Three unseeded requests queued behind the busy worker run as one
    batch-4 run (padded): X-Optex-Cohort 3, three distinct images, counted
    in the metrics; an idle server's request runs alone; a seeded request
    never joins."""
    with _serving() as (srv, url):
        ws, co = srv.workers, srv.coalescer
        _, _, solo = _post(url, _payload(seed=11))
        hold = ws.checkout()
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            futs = _queue(co, ex, lambda: _post(url, _payload()), 3)
            seeded = ex.submit(_post, url, _payload(seed=11))
            ws.checkin(hold)
            results = [f.result(timeout=300) for f in futs]
            s_status, s_headers, s_body = seeded.result(timeout=300)
        assert [h["X-Optex-Cohort"] for _, h, _ in results] == ["3"] * 3
        bodies = [b for _, _, b in results]
        assert all(b[:8] == PNG for b in bodies) and len(set(bodies)) == 3
        assert s_headers["X-Optex-Cohort"] is None and s_body == solo
        assert 4 in [s.cfg.batch for s in ws.pools[0]._cache.values()]
        _, h, png = _post(url, _payload())
        assert h["X-Optex-Cohort"] is None and png[:8] == PNG
        text = _get(url, "/metrics").decode()
    assert _metric(text, "optex_coalesced_requests_total") == 3
    assert _metric(text, "optex_coalesced_cohorts_total") == 1


# ---------------------------------------------------------------------------
# style packs on disk


@pytest.mark.parametrize("corrupt", [False, True])
def test_style_pack_persistence(tmp_path, monkeypatch, corrupt):
    """The first request of a style writes its pack; a fresh pool (a
    restarted server) imports it and serves with no style prep and the same
    seeded bytes. A corrupt pack is removed, redone and written again."""
    monkeypatch.setenv("OPTEX_PACK_DIR", str(tmp_path))
    payload = _payload(seed=3)
    cpu = torch.device("cpu")
    _, a = serve.handle_synthesize(serve.SynthesizerPool(cpu), payload)
    packs = list(tmp_path.glob("pack_*.npz"))
    assert len(packs) == 1
    if corrupt:
        packs[0].write_bytes(b"not an npz")

    calls = []
    orig = tcore.Synthesizer._dispatch_style_prep
    monkeypatch.setattr(tcore.Synthesizer, "_dispatch_style_prep",
                        lambda self, *args: calls.append(1) or orig(self, *args))
    _, b = serve.handle_synthesize(serve.SynthesizerPool(cpu), payload)
    assert a == b
    assert bool(calls) == corrupt
    assert list(tmp_path.glob("pack_*.npz")) == packs
    assert packs[0].read_bytes()[:2] == b"PK"   # a pack again


def test_bake_packs_tool(tmp_path, monkeypatch):
    """tools/bake_packs.py writes the pack the serving path would: a fresh
    pool's first request for the baked style runs no style prep."""
    from optimaltextures_tpu_torch.tools import bake_packs

    # the tool sets $OPTEX_PACK_DIR for its process: unset now, it is unset
    # again after the test
    monkeypatch.delenv("OPTEX_PACK_DIR", raising=False)
    monkeypatch.setattr("sys.argv", [
        "bake_packs.py", "--styles", STYLE, "--pack_dir", str(tmp_path),
        "--size", "64", "--device", "cpu", "--config", "passes=1",
        "--config", "iters=4", "--config", "no_multires=true",
        "--config", "depth=2"])
    bake_packs.main()
    assert len(list(tmp_path.glob("pack_*.npz"))) == 1

    monkeypatch.setenv("OPTEX_PACK_DIR", str(tmp_path))
    calls = []
    orig = tcore.Synthesizer._dispatch_style_prep
    monkeypatch.setattr(tcore.Synthesizer, "_dispatch_style_prep",
                        lambda self, *args: calls.append(1) or orig(self, *args))
    serve.handle_synthesize(serve.SynthesizerPool(torch.device("cpu")),
                            _payload(seed=3))
    assert calls == []


def test_serve_loadtest_tool(monkeypatch, capsys):
    from optimaltextures_tpu_torch.tools import serve_loadtest

    monkeypatch.setattr("sys.argv", [
        "serve_loadtest.py", "--size", "64", "--clients", "2",
        "--requests", "4", "--device", "cpu", "--config", "passes=1",
        "--config", "iters=2", "--config", "no_multires=true",
        "--config", "depth=1", "--config", 'conv_dtype="float32"'])
    serve_loadtest.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 4 and out["device"] == "cpu"
    assert out["req_per_s"] > 0 and out["warm_single_latency_s"] > 0
