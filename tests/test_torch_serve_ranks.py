"""Multi-device requests in the port's HTTP server on the CPU: the
persistent rank group (``parallel.mesh.RankGroup``) alone, then
``serve(port=0, device="cpu", workers=2)`` serving batch-parallel
(``num_devices: 2``) and spatial (``spatial_devices: 2``) requests on a
2-rank gloo group through real HTTP (64 px, 1 pass, 4 iterations, no
multires, depth 2; styles from docs/samples/).

A served request is held byte for byte against one-shot ranks: a
``parallel.mesh.spawn`` of ``core.synthesize`` on the same decoded images
and seed, quantized (what ``api.run_files`` runs on its ranks), at the torch
thread count of the server's ranks (another count rounds differently on
the CPU). No parity test against JAX here: those one-shot runs are held
against the JAX package's sharded, spatial and grid runs by
tests/test_torch_parallel.py and tests/test_torch_spatial.py. Rank bodies
are in tests/torch_parallel_ranks.py."""

import base64
import dataclasses
import io
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from optimaltextures_tpu_torch import serve
from optimaltextures_tpu_torch.parallel import mesh as tmesh
import torch_parallel_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STYLE = os.path.join(REPO, "docs", "samples", "graffiti_cholhist_256.png")
CFG = {"size": 64, "passes": 1, "iters": 4, "no_multires": True, "depth": 2}
DEADLINE = 120.0
with open(STYLE, "rb") as _f:
    B64 = base64.b64encode(_f.read()).decode()


def _payload(fmt="npy", **cfg):
    return {"config": {**CFG, **cfg}, "style_b64": [B64], "format": fmt}


DP = dict(num_devices=2, batch=2, seed=3)
SPATIAL = dict(spatial_devices=2, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def no_pack_dir():
    """No $OPTEX_PACK_DIR while this module runs: the ranks would import a
    style pack found there (a pack's targets are the run's within rounding,
    not bit for bit), and the one-shot references import none."""
    pack_dir = os.environ.pop("OPTEX_PACK_DIR", None)
    yield
    if pack_dir is not None:
        os.environ["OPTEX_PACK_DIR"] = pack_dir


def _running(pid) -> bool:
    """The process exists and has not ended (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _gone(pids, timeout=5.0):
    """Every pid ended within ``timeout`` seconds."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if not any(_running(p) for p in pids):
            return True
        time.sleep(0.05)
    return False


@pytest.fixture(scope="module")
def refs():
    """One spawn of 2 gloo ranks: the collectives, and the one-shot runs of
    the seeded DP and spatial requests on their decoded images."""
    todo = [("collectives", ())]
    for cfg in (DP, SPATIAL):
        req = serve._parse_request(_payload(**cfg))
        todo.append(("one_shot_u8", (dataclasses.asdict(req.cfg),
                                     req.styles)))
    coll, dp, sp = tmesh.spawn(ranks.jobs, 2, backend="gloo", device="cpu",
                               args=(todo,), deadline_s=DEADLINE)
    return {"collectives": coll, "dp": dp, "spatial": sp}


@pytest.fixture(scope="module")
def group():
    g = tmesh.RankGroup(["cpu", "cpu"], backend="gloo")
    yield g
    g.close()


@pytest.fixture(scope="module")
def served():
    srv = serve.serve(port=0, device="cpu", workers=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()


def _post(url, payload):
    req = urllib.request.Request(
        f"{url}/v1/synthesize", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _images(headers, body):
    """A 200's (N, H, W, 3) uint8 images, whatever its format."""
    ctype = headers["Content-Type"]
    if ctype == "application/octet-stream":
        return np.load(io.BytesIO(body))
    if ctype == "application/json":
        pngs = [base64.b64decode(b) for b in json.loads(body)["images_b64"]]
    else:
        pngs = [body]
    return np.stack([np.asarray(Image.open(io.BytesIO(p))) for p in pngs])


def _metric(url, name):
    with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
        text = r.read().decode()
    return float([ln for ln in text.splitlines()
                  if ln.startswith(name + " ") or ln.startswith(name + "{")
                  ][0].rsplit(" ", 1)[1])


def _group_pids(srv):
    return [p for g in srv.workers._groups.values() for p in g.pids]


# ---------------------------------------------------------------------------
# the rank group alone


def test_rank_group_runs_jobs_on_the_same_ranks(group, refs):
    """A job run twice on the group gives spawn's result both times, on the
    same processes, and every rank's result comes back."""
    pids = group.pids
    a = group.run(ranks.collectives, deadline_s=DEADLINE)
    b = group.run(ranks.collectives, deadline_s=DEADLINE)
    assert group.pids == pids and group.alive and len(set(pids)) == 2
    want = refs["collectives"]
    for got in (a[0], b[0]):
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v), k
            else:
                assert got[k] == v, k
    assert [r["rank"] for r in a] == [0, 1]
    torch.testing.assert_close(a[1]["psum"], want["psum"])


def test_rank_group_failing_rank_ends_the_group():
    g = tmesh.RankGroup(["cpu", "cpu"], backend="gloo")
    pids = g.pids
    with pytest.raises(tmesh.RankFailed, match="rank 1: ValueError: boom") as e:
        g.run(ranks.fails, "boom", deadline_s=DEADLINE)
    assert (e.value.rank, e.value.type_name, e.value.message) == (
        1, "ValueError", "boom")
    assert "Traceback" in e.value.trace
    assert not g.alive and _gone(pids)
    with pytest.raises(RuntimeError, match="failed or closed"):
        g.run(ranks.collectives)


def test_rank_group_hung_rank_times_out():
    g = tmesh.RankGroup(["cpu", "cpu"], backend="gloo")
    pids = g.pids
    t0 = time.time()
    with pytest.raises(TimeoutError, match="within 4"):
        g.run(ranks.hangs, deadline_s=4.0)
    assert time.time() - t0 < 15.0
    assert not g.alive and _gone(pids)


def test_rank_group_close_ends_idle_ranks(group):
    pids = group.pids
    group.close()
    assert not group.alive and _gone(pids)
    group.close()   # twice is harmless


# ---------------------------------------------------------------------------
# served multi-device requests


@pytest.mark.parametrize("cfg,fmt,ref", [(DP, "npy", "dp"), (DP, "png", "dp"),
                                         (SPATIAL, "npy", "spatial")],
                         ids=["dp-npy", "dp-png", "spatial-npy"])
def test_served_request_equals_one_shot_ranks(served, refs, cfg, fmt, ref):
    srv, url = served
    status, headers, body = _post(url, _payload(fmt, **cfg))
    assert status == 200, body[:300]
    assert headers["X-Optex-Worker"] == "0,1"
    got = _images(headers, body)
    assert got.dtype == np.uint8 and got.shape == refs[ref].shape
    np.testing.assert_array_equal(got, refs[ref])
    assert sorted(srv.workers._free) == [0, 1]


def test_repeated_request_same_bytes_on_the_same_ranks(served):
    srv, url = served
    a = _post(url, _payload(**SPATIAL))
    pids = _group_pids(srv)
    b = _post(url, _payload(**SPATIAL))
    assert a[0] == b[0] == 200 and a[2] == b[2]
    assert b[1]["X-Optex-Worker"] == "0,1"
    assert _group_pids(srv) == pids and len(pids) == 2
    assert sorted(srv.workers._free) == [0, 1]


def test_unseeded_requests_differ(served):
    srv, url = served
    a = _post(url, _payload(spatial_devices=2))
    b = _post(url, _payload(spatial_devices=2))
    assert a[0] == b[0] == 200 and a[2] != b[2]
    assert sorted(srv.workers._free) == [0, 1]


def test_metrics_count_every_request(served):
    srv, url = served
    names = ('optex_requests_total{outcome="ok"}',
             'optex_requests_total{outcome="client_error"}',
             'optex_requests_total{outcome="server_error"}')
    before = [_metric(url, n) for n in names]
    assert _post(url, _payload(num_devices=2, batch=2))[0] == 200
    status, _, body = _post(url, _payload(num_devices=3, batch=3))
    assert status == 400
    assert "requested 3 devices, have 2" in json.loads(body)["error"]
    after = [_metric(url, n) for n in names]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0]


def test_killed_rank_is_replaced_at_the_next_request(served):
    srv, url = served
    assert _post(url, _payload(**SPATIAL))[0] == 200
    old = _group_pids(srv)
    (group,) = srv.workers._groups.values()
    os.kill(old[1], signal.SIGKILL)
    t0 = time.time()   # until the process has ended (every thread of it)
    while group.alive and time.time() - t0 < 5.0:
        time.sleep(0.05)
    assert not group.alive
    status, headers, body = _post(url, _payload(**SPATIAL))
    assert status == 200 and headers["X-Optex-Worker"] == "0,1", body[:300]
    new = _group_pids(srv)
    assert len(new) == 2 and not set(new) & set(old)
    assert _gone(old)   # the old group's other rank ended too


def test_server_close_ends_every_rank(served):
    srv, url = served
    assert _post(url, _payload(**DP))[0] == 200
    pids = _group_pids(srv)
    assert len(pids) == 2
    srv.shutdown()
    srv.server_close()
    assert _gone(pids) and not srv.workers._groups
