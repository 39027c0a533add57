"""The HTTP serving layer (the counterpart of
``optimaltextures_tpu/serve.py``).

Warm ``Synthesizer`` pools keyed by the config signature: the first request
of a signature builds its Synthesizer (the VGG bank, the packed codec
weights); later ones reuse it, and repeated requests with the same style
bytes reuse its ``styles_token`` prep cache. With ``$OPTEX_PACK_DIR`` set,
the first run of a style writes its style pack there and a restarted server
imports it (utils/stylepack.py). With ``--workers N`` requests run
concurrently, one per GPU, each worker single-stream behind its own lock.
Under load, unseeded same-style synthesis requests that queue behind a busy
worker coalesce into ONE batched run (``--coalesce``, RequestCoalescer).
Every run goes through ``Synthesizer.run`` and the CUDA kernels; the server
runs on the GPU unless it is given ``device="cpu"`` (tests).

A multi-device request (``num_devices`` N > 1 batch-parallel,
``spatial_devices`` S > 1, or both: the 2-D grid) takes an aligned block of
n = N * S workers, ``[k n, (k + 1) n)``, checked out together
(:meth:`WorkerSet.checkout_block`), and runs on the block's rank group: n
processes, one a card, joined once by NCCL (gloo for CPU workers) and kept
for later requests (``parallel.mesh.RankGroup``), each rank with a warm
pool of its own on its card. Every rank runs the request through the same
``Synthesizer.run`` as a one-worker request; rank 0's output is the
response. A request that ``api.run_files`` refuses is refused here with
400 before any rank is touched; a rank that fails ends its group (the next
request starts a new one) and the request gets 400 (a ValueError, TypeError
or KeyError) or 500.

    python -m optimaltextures_tpu_torch.serve --port 8700

    POST /v1/synthesize
      {"config": {"size": 256, "iters": 100, ...},
       "style_b64": ["<base64 png/jpg>", ...],   # 1-8 (2+ = mixing)
       "content_b64": "<base64 png/jpg>",        # optional
       "init_b64": "<base64 png/jpg>",           # optional starting pastiche
       "style_parallel": true,                   # optional: ONE texture per
                                                 # style, not a mix; with
                                                 # config.num_devices = N,
                                                 # style i on worker i
                                                 # (else num_devices /
                                                 # spatial_devices: a block
                                                 # of workers' ranks)
       "format": "png"}                          # png (default) | jpeg
                                                 # (quality 92) | npy (the
                                                 # raw uint8 batch)
    -> 200 image/png|image/jpeg, application/json with every image
       base64-encoded when config.batch > 1, or application/octet-stream
       (.npy, the whole (N, H, W, 3) uint8 batch) for format=npy
    -> 400 for a bad request (a tileable one whose pass sizes do not
       divide by 2^(depth-1) among them; a spatial one whose pass sizes do
       not divide by spatial_devices x 2^(depth-1); batch not divisible by
       num_devices; more devices than workers; style_parallel with
       num_devices other than the style count); 500 for a server fault

    GET /healthz -> {"status": "ok", "devices": [...], "cached": N,
                     "workers": W}
    GET /metrics -> Prometheus text (request counters, latency summary)
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .config import OptexConfig

# Every OptexConfig field is settable over HTTP except the I/O paths
# (styles, content and init arrive as base64; the output goes back in the
# response). tests/test_torch_serve.py holds this set equal to the
# dataclass fields minus _IO_FIELDS, and to the JAX package's.
_IO_FIELDS = {"style", "content", "init", "output_dir"}
_CONFIG_FIELDS = {
    "size", "passes", "iters", "hist_mode", "color_transfer",
    "content_strength", "style_scale", "mixing_alpha", "mixing_weights",
    "no_pca",
    "no_multires", "batch", "seed", "depth", "conv_dtype", "num_devices",
    "spatial_devices", "pca_bucket", "pca_traced_k", "use_pallas",
    "cov_propagation", "batch_chunk", "fast_codec",
    "compat_schedule_quirk", "content_anchor", "tileable", "out_width",
}


class SynthesizerPool:
    """Warm Synthesizer cache keyed by the config signature, on one device
    (``device``: a ``torch.device``, or None for the GPU)."""

    MAX_ENTRIES = 8   # each entry holds a VGG bank + style caches on device

    def __init__(self, device=None):
        from collections import OrderedDict

        self._cache = OrderedDict()
        self.lock = threading.Lock()
        self.device = device

    # Fields NOT in the signature: the I/O paths, mixing_weights (a run
    # input) and seed (it only keys the generators, so that clients sweeping
    # seeds share one warm Synthesizer instead of evicting each other).
    NON_SIG_FIELDS = ("style", "content", "output_dir", "mixing_weights",
                      "seed")

    def _sig(self, cfg: OptexConfig):
        d = dataclasses.asdict(cfg)
        for k in self.NON_SIG_FIELDS:
            d.pop(k)
        return tuple(sorted((k, repr(v)) for k, v in d.items()))

    def get(self, cfg: OptexConfig):
        from . import core

        sig = self._sig(cfg)
        if sig not in self._cache:
            self._cache[sig] = core.Synthesizer(cfg, device=self.device)
            while len(self._cache) > self.MAX_ENTRIES:
                self._cache.popitem(last=False)   # LRU: drop the coldest
        self._cache.move_to_end(sig)
        synth = self._cache[sig]
        # refresh only the non-signature fields (a field that feeds
        # Synthesizer.__init__ is in the signature by construction), and
        # re-key for the request's seed
        synth.cfg = dataclasses.replace(
            synth.cfg, **{k: getattr(cfg, k) for k in self.NON_SIG_FIELDS})
        synth.reseed(cfg.seed)
        return synth

    def __len__(self):
        return len(self._cache)


def _decode_image(b64: str, size: int, oversize: bool,
                  scale: float = 1.0) -> np.ndarray:
    """base64 -> (1, H, W, 3) float32, as utils.imageio.load_image loads a
    file. ``scale`` carries cfg.style_scale for styles: it applies at load
    and again at every pass's resize, as on the CLI path."""
    from PIL import Image

    from .utils import schedule

    img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    w0, h0 = img.size
    tw, th = schedule.get_size(size, scale, w0, h0, oversize)
    img = img.resize((tw, th), Image.LANCZOS)
    return (np.asarray(img, dtype=np.float32) / 255.0)[None]


def _pack_path(synth, token: str):
    """The style pack's file under $OPTEX_PACK_DIR (None: packs off). The
    config signature is part of the name, so one style served under several
    configs keeps one pack each; the name is the JAX package's."""
    d = os.environ.get("OPTEX_PACK_DIR")
    if not d:
        return None
    from .utils.stylepack import _signature

    sig = hashlib.sha256(repr(_signature(synth)).encode()).hexdigest()[:12]
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"pack_{sig}_{token}.npz")


def _maybe_import_pack(synth, token: str) -> None:
    """Warm start: load a style pack into a cold in-memory cache."""
    path = _pack_path(synth, token)
    if path is None or not os.path.exists(path):
        return
    if any(k[0][0] == token for k in synth._style_prep_cache):
        return  # already warm in memory
    from .utils.stylepack import import_style_pack

    try:
        import_style_pack(synth, token, path)
    except (ValueError, KeyError, OSError):  # corrupt or mismatched: redo
        os.remove(path)


def _maybe_export_pack(synth, token: str, n_styles: int) -> None:
    """Write the finished targets after the first run of a new style.
    Mixing (2+ styles) draws a new mask every run: nothing to keep."""
    path = _pack_path(synth, token)
    if path is None or n_styles > 1 or os.path.exists(path):
        return
    from .utils.stylepack import export_style_pack

    try:
        export_style_pack(synth, token, path)
    except ValueError:  # nothing finished (does not happen after a run)
        pass


class _Request:
    """A parsed, validated request: everything _execute needs, no device
    work done yet, so that the coalescer can inspect it (batchable? cohort
    key?) first."""

    __slots__ = ("cfg", "styles", "content", "init", "fmt", "token",
                 "style_parallel")

    def __init__(self, cfg, styles, content, init, fmt, token,
                 style_parallel=False):
        self.cfg = cfg
        self.styles = styles
        self.content = content
        self.init = init
        self.fmt = fmt
        self.token = token
        self.style_parallel = style_parallel


def handle_synthesize(pool: SynthesizerPool, payload: dict,
                      config_defaults: dict | None = None):
    """Run one single-device request; returns (content_type, body bytes).

    ``config_defaults``: operator-set config values for the fields a request
    omits (e.g. ``{"conv_dtype": "bfloat16"}``). Raises ValueError on bad
    input."""
    return _execute(pool, _parse_request(payload, config_defaults))


def _check_pass_sizes(cfg: OptexConfig) -> None:
    """``core.check_pass_sizes`` of the pass sizes a Synthesizer of ``cfg``
    would run, on the host (no VGG bank is loaded)."""
    from .core import check_pass_sizes
    from .models import weights
    from .utils import schedule

    depth = cfg.depth or max(weights.available_depths())
    _, sizes = schedule.iters_and_sizes(
        cfg.size, cfg.iters, cfg.passes, not cfg.no_multires,
        quirk=cfg.compat_schedule_quirk, num_layers=depth)
    check_pass_sizes(sizes, depth, cfg.tileable, cfg.spatial_devices)


def _parse_request(payload: dict,
                   config_defaults: dict | None = None) -> _Request:
    """Decode and validate one request body (host work only: PIL decodes,
    config validation, the style token, a multi-device request's pass
    sizes). Raises ValueError."""
    cfg_args = dict(config_defaults or {})
    cfg_args.update({k: v for k, v in payload.get("config", {}).items()
                     if k in _CONFIG_FIELDS})
    styles_b64 = payload.get("style_b64") or []
    if not 1 <= len(styles_b64) <= 8:
        raise ValueError("style_b64 must contain 1-8 images")
    # cfg.style carries only the COUNT here (images arrive as style_b64);
    # validate() cross-checks it against mixing_weights
    cfg = OptexConfig(style=["<b64>"] * len(styles_b64), **cfg_args).validate()
    styles = [_decode_image(b, cfg.size, oversize=True,
                            scale=cfg.style_scale) for b in styles_b64]
    if any(s.shape != styles[0].shape for s in styles[1:]):
        raise ValueError("style images must load to the same shape")
    content = None
    if payload.get("content_b64"):
        content = _decode_image(payload["content_b64"], cfg.size, oversize=False)
    if content is not None and cfg.out_width:
        # config.validate's refusal (the cfg here cannot see the content)
        raise ValueError("out_width applies to synthesis only (a content "
                         "image defines the output shape)")
    init = None
    if payload.get("init_b64"):
        init = _decode_image(payload["init_b64"], cfg.size, oversize=False)
        if content is not None and init.shape != content.shape:
            raise ValueError("init_b64 must load to the content's shape")
        if cfg.batch > 1:
            raise ValueError("batch > 1 with init_b64 produces identical "
                             "images; use batch=1")

    fmt = payload.get("format", "png")
    if fmt not in ("png", "jpeg", "npy"):
        raise ValueError(f"format must be png|jpeg|npy, got {fmt!r}")

    style_parallel = bool(payload.get("style_parallel"))
    if style_parallel:
        # one output texture PER style (no mixing): the JAX package's
        # refusals, each a 400
        if content is not None or init is not None:
            raise ValueError("style_parallel is synthesis-only "
                             "(no content_b64/init_b64)")
        requested = set(payload.get("config", {}))
        bad = [n for n, b in [("tileable", cfg.tileable),
                              ("out_width", cfg.out_width is not None),
                              ("batch", cfg.batch != 1),
                              ("color_transfer",
                               cfg.color_transfer is not None),
                              ("spatial_devices", cfg.spatial_devices > 1),
                              ("mixing_weights",
                               "mixing_weights" in requested),
                              ("mixing_alpha",
                               "mixing_alpha" in requested)] if b]
        if bad:
            raise ValueError("style_parallel does not support: "
                             + ", ".join(bad))
        if cfg.num_devices > 1 and len(styles) != cfg.num_devices:
            raise ValueError(f"{len(styles)} styles for num_devices="
                             f"{cfg.num_devices}: pass one style per device")
    elif cfg.num_devices * cfg.spatial_devices > 1:
        # api.run_files' and Synthesizer's refusals before their first
        # collective (the worker count is checked at checkout)
        if cfg.batch % cfg.num_devices:
            raise ValueError(f"batch {cfg.batch} not divisible by "
                             f"num_devices {cfg.num_devices}")
        _check_pass_sizes(cfg)

    # stable (process-independent) style identity: the key of the in-memory
    # prep cache and part of the style pack's file name
    token = hashlib.sha256("\x00".join(styles_b64).encode()).hexdigest()[:24]
    return _Request(cfg, styles, content, init, fmt, token, style_parallel)


def _device_cm(pool):
    """Make the worker's GPU current in this thread: CUDA's current device
    is per thread, and every request runs on a thread of its own."""
    dev = pool.device
    if dev is not None and torch.device(dev).type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _pool_run(pool: SynthesizerPool, req: _Request, write_pack: bool = True):
    """The device-touching half of a request, on ``pool`` (which the caller
    has to itself): (its (N, H, W, 3) uint8 batch, the Synthesizer that ran
    it). For a multi-device request every rank calls it with the same
    request and gets the whole batch."""
    from .core import draw_noise

    cfg = req.cfg
    synth = pool.get(cfg)
    _maybe_import_pack(synth, req.token)
    # per-request key: fresh entropy per request when no seed is given
    # (repeated identical requests differ), the same for a fixed seed
    # (identical bytes); the noise and the rotations derive from it
    run_key = synth.next_run_key()
    if req.init is not None:   # batch > 1 with init was refused
        noise = torch.as_tensor(req.init, dtype=torch.float32)
    else:
        shape = (req.content.shape if req.content is not None else
                 (cfg.batch, cfg.size, cfg.out_width or cfg.size, 3))
        noise = draw_noise(synth.device, run_key, shape)
    # the styles stay host numpy arrays: run() fingerprints them for the
    # styles_token key, a hash of host bytes
    out = synth.run(noise, req.styles, req.content, key=run_key,
                    styles_token=req.token, quantize_uint8=True)
    batch = out.cpu().numpy()   # uint8, quantized on the device
    if write_pack:
        _maybe_export_pack(synth, req.token, n_styles=len(req.styles))
    return batch, synth


def _run(pool: SynthesizerPool, req: _Request) -> np.ndarray:
    """A single-device request on one worker: its (N, H, W, 3) uint8 batch."""
    with pool.lock, _device_cm(pool):
        return _pool_run(pool, req)[0]


def _execute(pool: SynthesizerPool, req: _Request):
    """One request's (content_type, body)."""
    return _encode_batch(_run(pool, req), req.fmt)


def _style_parallel_one(pool: SynthesizerPool, req: _Request, styles,
                        **kw) -> np.ndarray:
    """``style_dp.synthesize_style_batch`` of ``styles`` on one worker, with
    the bank of its pool's single-device Synthesizer: the (n, H, W, 3) uint8
    batch."""
    from .core import _quant_u8
    from .parallel.style_dp import synthesize_style_batch

    with pool.lock, _device_cm(pool):
        synth = pool.get(dataclasses.replace(req.cfg, num_devices=1))
        out = synthesize_style_batch(req.cfg, styles, None, bank=synth.bank,
                                     device=synth.device, **kw)
        return _quant_u8(out).cpu().numpy()


def _style_widths_one(pool: SynthesizerPool, cfg, style) -> dict:
    from .parallel.style_dp import style_widths

    with pool.lock, _device_cm(pool):
        synth = pool.get(dataclasses.replace(cfg, num_devices=1))
        return style_widths(cfg, [style], bank=synth.bank, device=synth.device)


def _execute_style_parallel(workers: "WorkerSet", req: _Request):
    """A style-parallel request: (content_type, body, worker indices).

    ``num_devices`` 1: every style on one worker. ``num_devices`` N: N
    workers, checked out in one step, style i on worker i's device on a
    thread of its own. The per-style runs share no collective; what they
    must agree on (the run key and, per pass size, the PCA widths, the
    largest of every style's) is settled first, so each worker's output
    equals the same style's in one ``synthesize_style_batch`` of every
    style."""
    from concurrent.futures import ThreadPoolExecutor

    from .core import draw_noise

    cfg, n = req.cfg, req.cfg.num_devices
    if n == 1:
        idx = workers.checkout()
        try:
            batch = _style_parallel_one(workers.pools[idx], req, req.styles)
        finally:
            workers.checkin(idx)
        return (*_encode_batch(batch, req.fmt), str(idx))
    if n > len(workers.pools):
        raise ValueError(f"requested {n} devices, have {len(workers.pools)}")
    if cfg.seed is None:   # one run key for every style
        cfg = dataclasses.replace(
            cfg, seed=int(np.random.SeedSequence().entropy % (2 ** 63)))
    req = _Request(cfg, req.styles, None, None, req.fmt, req.token, True)
    idxs = workers.checkout_many(n)
    try:
        pools = [workers.pools[i] for i in idxs]
        with ThreadPoolExecutor(n) as ex:
            per_style = [f.result() for f in [
                ex.submit(_style_widths_one, pool, cfg, style)
                for pool, style in zip(pools, req.styles)]]
            widths = {ck: tuple(max(w) for w in zip(*(ws[ck]
                                                      for ws in per_style)))
                      for ck in per_style[0]}

            def one(i):
                pool = pools[i]
                with _device_cm(pool):
                    noise = draw_noise(pool.device or "cuda", cfg.seed,
                                       (n, cfg.size, cfg.size, 3))[i:i + 1]
                return _style_parallel_one(pool, req, [req.styles[i]],
                                           pastiche=noise,
                                           _force_widths=widths)

            outs = [f.result() for f in [ex.submit(one, i)
                                         for i in range(n)]]
    finally:
        for i in idxs:
            workers.checkin(i)
    return (*_encode_batch(np.concatenate(outs), req.fmt),
            ",".join(map(str, idxs)))


# a multi-device request's deadline on its ranks (parallel.mesh.spawn's
# default): past it the group is killed and the request fails
_RANK_DEADLINE_S = 900.0

# a rank's own pool (process-global: it lives as long as the rank)
_RANK_POOL = None


def _serve_rank(mesh, req: _Request, pack_dir):
    """One multi-device request on this rank of a RankGroup: the rank's
    pool (on ``mesh.device``; ``pool.get`` builds the Synthesizer from the
    rank's process group) through :func:`_pool_run`, the launch counts set
    to 0 just before the run. ``pack_dir``: the server's $OPTEX_PACK_DIR
    (every rank imports a pack, rank 0 writes one). Returns (the uint8
    batch on rank 0, else None; {"launches": this rank's kernel launches,
    "style_preps": the style preps it dispatched})."""
    from .ops import cdf, codec, rotgemm

    global _RANK_POOL
    if _RANK_POOL is None:
        _RANK_POOL = SynthesizerPool(device=mesh.device)
    if pack_dir:
        os.environ["OPTEX_PACK_DIR"] = pack_dir
    else:
        os.environ.pop("OPTEX_PACK_DIR", None)
    codec.reset_launches()
    cdf.reset_launches()
    rotgemm.reset_launches()
    batch, synth = _pool_run(_RANK_POOL, req, write_pack=mesh.rank == 0)
    report = {"launches": {**codec.LAUNCHES, **cdf.LAUNCHES, **rotgemm.LAUNCHES},
              "style_preps": synth.last_run_style_preps}
    return (batch if mesh.rank == 0 else None), report


def _run_on_group(group, req: _Request, deadline_s: float = _RANK_DEADLINE_S):
    """``req`` on every rank of ``group`` (a ``parallel.mesh.RankGroup`` of
    num_devices x spatial_devices ranks): (rank 0's uint8 batch, every
    rank's report, in rank order). A rank's ValueError, TypeError or
    KeyError is raised as a ValueError (a bad request); any other failure
    as it came. Either way the group is gone."""
    from .parallel.mesh import RankFailed

    try:
        got = group.run(_serve_rank, req, os.environ.get("OPTEX_PACK_DIR"),
                        deadline_s=deadline_s)
    except RankFailed as e:
        if e.type_name in ("ValueError", "TypeError", "KeyError"):
            raise ValueError(str(e)) from e
        raise
    return got[0][0], [report for _, report in got]


def _execute_on_ranks(workers: "WorkerSet", req: _Request):
    """A multi-device request: (content_type, body, worker indices). The
    block of n = num_devices x spatial_devices workers is checked out until
    the ranks answer, so no single-device request shares its cards
    meanwhile."""
    idxs = workers.checkout_block(req.cfg.num_devices
                                  * req.cfg.spatial_devices)
    try:
        batch, _ = _run_on_group(workers.group(idxs), req)
    finally:
        for i in idxs:
            workers.checkin(i)
    return (*_encode_batch(batch, req.fmt), ",".join(map(str, idxs)))


def _encode_batch(batch, fmt="png"):
    """(N, H, W, 3) uint8 -> response (content_type, body).

    ``fmt="png"`` (default): image/png for N == 1, else application/json
    with every image base64-encoded. ``fmt="jpeg"``: the same shapes,
    quality-92 JPEG (lossy, a faster host encode). ``fmt="npy"``: the WHOLE
    batch as one .npy (N, H, W, 3) uint8 body (application/octet-stream),
    no image encode, exact pixels."""
    from PIL import Image

    if fmt == "npy":
        buf = io.BytesIO()
        np.save(buf, batch)
        return "application/octet-stream", buf.getvalue()
    pil_fmt, mime = (("JPEG", "image/jpeg") if fmt == "jpeg"
                     else ("PNG", "image/png"))
    save_kw = {"quality": 92} if fmt == "jpeg" else {}
    imgs = []
    for arr in batch:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, pil_fmt, **save_kw)
        imgs.append(buf.getvalue())
    if len(imgs) == 1:
        return mime, imgs[0]
    return "application/json", json.dumps(
        {"images_b64": [base64.b64encode(p).decode() for p in imgs]}).encode()


def _batchable(req: _Request) -> bool:
    """Can this request join a coalesced cohort? Only unseeded single-image
    synthesis from ONE style on one device: a seeded request promises
    identical reruns (a cohort's pooled moments would break that), content
    or init define a pastiche of their own, mixing draws one mask per RUN
    (members would share a region layout), and a multi-device request runs
    on its block's ranks."""
    return (not req.style_parallel and req.content is None
            and req.init is None and req.cfg.seed is None
            and req.cfg.batch == 1 and len(req.styles) == 1
            and req.cfg.num_devices == 1 and req.cfg.spatial_devices == 1)


def _pad_cohort(n: int) -> int:
    """Round a cohort up to the next power of two, as the JAX package does
    (there each batch size is a compiled program of its own). The members
    share the batch's pooled moments, so the padding is part of what each
    member gets."""
    p = 1
    while p < n:
        p *= 2
    return p


def _execute_cohort(pool: SynthesizerPool, members: list):
    """Run a coalesced cohort as ONE batched synthesis; returns one
    (content_type, body) per member, in order.

    A cohort is a ``config.batch = N`` run: the members share the run's
    rotations and its pooled batch statistics; each gets its own noise
    image and its own response."""
    base = members[0].req
    cfg = dataclasses.replace(base.cfg, batch=_pad_cohort(len(members)))
    batch = _run(pool, _Request(cfg, base.styles, None, None, base.fmt,
                                base.token))
    return [_encode_batch(batch[i:i + 1], m.req.fmt)
            for i, m in enumerate(members)]


class _CohortMember:
    __slots__ = ("req", "event", "result", "error")

    def __init__(self, req: _Request):
        self.req = req
        self.event = threading.Event()
        self.result = None   # (content_type, body, worker_idx, cohort_n)
        self.error = None


class RequestCoalescer:
    """Queue-time dynamic batching.

    An eligible request (see _batchable) opens a cohort keyed by (config
    signature, style token) and blocks in ``workers.checkout()``;
    compatible requests that arrive meanwhile join the cohort instead of
    queueing behind it. When a worker frees, the leader closes the cohort
    and runs ALL members as one batched run on its own thread; the
    followers wait on an Event. An idle server's checkout returns at once
    and the cohort is size 1: no added latency, no arrival window."""

    WAIT_TIMEOUT_S = 3600.0   # follower safety net (covers a cold start)

    def __init__(self, workers: "WorkerSet", max_batch: int = 8):
        self.workers = workers
        self.max_batch = max_batch
        self.lock = threading.Lock()
        self._open: dict = {}          # cohort key -> list[_CohortMember]
        # metrics (read by WorkerSet.metrics_text under this lock)
        self.coalesced_cohorts = 0     # cohorts with 2+ members
        self.coalesced_requests = 0    # members served via such cohorts

    def submit(self, req: _Request):
        """Serve one batchable request; returns (content_type, body,
        worker_idx, cohort_n). Blocks until a worker runs its cohort."""
        key = (self.workers.pools[0]._sig(req.cfg), req.token)
        member = _CohortMember(req)
        with self.lock:
            cohort = self._open.get(key)
            if cohort is not None and len(cohort) < self.max_batch:
                cohort.append(member)
                leader = False
            else:
                # no open cohort, or it is full: this member leads a new one
                # (the full list stays with ITS leader, who holds it)
                cohort = [member]
                self._open[key] = cohort
                leader = True
        if not leader:
            if not member.event.wait(self.WAIT_TIMEOUT_S):
                raise RuntimeError("coalesced request timed out waiting "
                                   "for its cohort leader")
            if member.error is not None:
                raise member.error
            return member.result
        # Leader: wait for a worker (followers join the open cohort while
        # this blocks), then close the cohort under the lock, so that no
        # member joins after the snapshot, and run it.
        idx = self.workers.checkout()
        with self.lock:
            if self._open.get(key) is cohort:
                del self._open[key]
            members = list(cohort)
        try:
            bodies = _execute_cohort(self.workers.pools[idx], members)
            for m, (ctype, body) in zip(members, bodies):
                m.result = (ctype, body, idx, len(members))
        except Exception as e:
            for m in members:
                m.error = e
        finally:
            self.workers.checkin(idx)
            for m in members:
                m.event.set()
        if member.error is not None:
            raise member.error
        if len(members) > 1:
            with self.lock:
                self.coalesced_cohorts += 1
                self.coalesced_requests += len(members)
        return member.result


# 8 styles + content + init as base64 PNGs fit (8 x ~8 MB 2048-px PNGs x
# 4/3 ~ 90 MB at worst); a bigger body is a mistake or abuse. Bodies are read
# whole into memory, so concurrent reads are bounded by a semaphore in the
# handler as well: ThreadingHTTPServer starts a thread per connection.
_MAX_REQUEST_BYTES = 128 * 1024 * 1024
_MAX_CONCURRENT_BODY_READS = 4
# Total wall-clock budget for reading ONE request body: the per-recv socket
# timeout alone does not bound a client trickling one byte at a time.
_BODY_READ_DEADLINE_S = 120.0
_BODY_READ_CHUNK = 1 << 20


def _read_body_deadline(rfile, n: int, deadline_s: float = None) -> bytes:
    """Read exactly n bytes in bounded chunks under a TOTAL wall-clock
    deadline; raises TimeoutError when the budget runs out (a trickle upload
    that keeps each recv fast included)."""
    deadline_s = _BODY_READ_DEADLINE_S if deadline_s is None else deadline_s
    t0 = time.monotonic()
    # read1 returns after at most one recv, so the deadline is checked after
    # every recv; read(k) would block for as long as the client trickles
    read1 = getattr(rfile, "read1", None)
    parts, got = [], 0
    while got < n:
        if time.monotonic() - t0 > deadline_s:
            raise TimeoutError("request body read exceeded total deadline")
        want = min(_BODY_READ_CHUNK, n - got)
        chunk = read1(want) if read1 is not None else rfile.read(want)
        if not chunk:
            break  # client closed early; json.loads rejects the stub
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


class WorkerSet:
    """N serving workers, one per GPU (``cuda:0 .. cuda:N-1``), or N pools on
    the CPU with ``device="cpu"`` (tests).

    Requests check a worker out of a FIFO queue, so N requests run
    concurrently on N devices while each worker's lock keeps its device
    single-stream; sequential requests rotate across the workers. A
    style-parallel request takes several workers in one step
    (:meth:`checkout_many`). A multi-device request of n ranks takes an
    aligned block of n workers, ``[k n, (k + 1) n)`` (:meth:`checkout_block`),
    and runs on that block's rank group (:meth:`group`): n processes that
    stay between requests, each with pools of its own on its card (NCCL; gloo
    for CPU workers). One group a block, so no more groups than workers (4
    workers: blocks of 2, 3 and 4, at most 4 groups); :meth:`close` ends
    them."""

    def __init__(self, n_workers: int = 1, device=None):
        from collections import deque

        from . import core

        dev = core.resolve_device(device)
        if dev.type == "cuda":
            first, count = dev.index or 0, torch.cuda.device_count()
            if first + n_workers > count:
                raise ValueError(f"workers={n_workers} from cuda:{first} but "
                                 f"only {count} devices")
            devices = [torch.device("cuda", first + i)
                       for i in range(n_workers)]
        else:
            devices = [dev] * n_workers
        self.pools = [SynthesizerPool(device=d) for d in devices]
        self._free = deque(range(n_workers))
        self._free_cv = threading.Condition()
        # (first worker, block size) -> parallel.mesh.RankGroup
        self._groups = {}
        self._groups_lock = threading.Lock()
        self._closed = False
        # request metrics (served at /metrics, Prometheus text format)
        self.metrics_lock = threading.Lock()
        self.requests_total = {"ok": 0, "client_error": 0, "server_error": 0}
        self.request_seconds_sum = 0.0
        self.request_seconds_count = 0

    def device_names(self):
        return [torch.cuda.get_device_name(p.device)
                if p.device.type == "cuda" else p.device.type
                for p in self.pools]

    def record(self, outcome: str, seconds: float) -> None:
        with self.metrics_lock:
            self.requests_total[outcome] += 1
            if outcome == "ok":
                self.request_seconds_sum += seconds
                self.request_seconds_count += 1

    def metrics_text(self, coalescer=None) -> str:
        with self.metrics_lock:
            lines = ["# TYPE optex_requests_total counter"]
            for k, v in self.requests_total.items():
                lines.append(f'optex_requests_total{{outcome="{k}"}} {v}')
            lines += [
                "# TYPE optex_request_seconds summary",
                f"optex_request_seconds_sum {self.request_seconds_sum:.6f}",
                f"optex_request_seconds_count {self.request_seconds_count}",
                "# TYPE optex_workers gauge",
                f"optex_workers {len(self.pools)}",
                "# TYPE optex_cached_synthesizers gauge",
                f"optex_cached_synthesizers {len(self)}",
            ]
        if coalescer is not None:
            with coalescer.lock:
                lines += [
                    "# TYPE optex_coalesced_cohorts_total counter",
                    f"optex_coalesced_cohorts_total "
                    f"{coalescer.coalesced_cohorts}",
                    "# TYPE optex_coalesced_requests_total counter",
                    f"optex_coalesced_requests_total "
                    f"{coalescer.coalesced_requests}",
                ]
        return "\n".join(lines) + "\n"

    def checkout(self) -> int:
        return self.checkout_many(1)[0]

    def checkout_many(self, n: int) -> list:
        """Wait until ``n`` workers are free and take them all at once (in
        queue order): two requests that each need several workers never hold
        part of a set each."""
        with self._free_cv:
            self._free_cv.wait_for(lambda: len(self._free) >= n)
            return [self._free.popleft() for _ in range(n)]

    def checkout_block(self, n: int) -> list:
        """Wait until some aligned block of ``n`` workers, ``[k n, (k + 1)
        n)``, is wholly free and take it in one step (the lowest such k).
        More workers than there are raises ValueError."""
        if n > len(self.pools):
            raise ValueError(f"requested {n} devices, have {len(self.pools)}")

        def free_block():
            for k in range(len(self.pools) // n):
                block = list(range(k * n, (k + 1) * n))
                if all(i in self._free for i in block):
                    return block
            return None

        with self._free_cv:
            self._free_cv.wait_for(lambda: free_block() is not None)
            block = free_block()
            for i in block:
                self._free.remove(i)
            return block

    def group(self, block: list):
        """The rank group of a checked-out block (its caller holds it),
        started at its first request and again whenever it has failed.
        Before the first group on the GPUs the kernel libraries are built
        here, so that the ranks only load them."""
        from .parallel.mesh import RankGroup

        key = (block[0], len(block))
        with self._groups_lock:
            if self._closed:
                raise RuntimeError("the worker set is closed")
            old = self._groups.get(key)
            if old is not None and old.alive:
                return old
        if old is not None:
            old.close()
        devices = [self.pools[i].device for i in block]
        backend = "gloo" if devices[0].type == "cpu" else "nccl"
        if backend == "nccl":
            from .ops import cuda_build

            cuda_build.build(*cuda_build.RUN_LIBRARIES)
        group = RankGroup(devices, backend=backend)
        with self._groups_lock:
            if self._closed:
                group.close()
                raise RuntimeError("the worker set is closed")
            self._groups[key] = group
        return group

    def close(self) -> None:
        """End every rank group (the server's ``server_close``)."""
        with self._groups_lock:
            self._closed = True
            groups, self._groups = list(self._groups.values()), {}
        for g in groups:
            g.close()

    def checkin(self, idx: int) -> None:
        with self._free_cv:
            self._free.append(idx)
            self._free_cv.notify_all()

    def __len__(self):
        return sum(len(p) for p in self.pools)


def make_handler(workers: WorkerSet, config_defaults: dict | None = None,
                 coalescer: RequestCoalescer | None = None):
    body_read_sem = threading.BoundedSemaphore(
        max(_MAX_CONCURRENT_BODY_READS, 2 * len(workers.pools)))

    class Handler(BaseHTTPRequestHandler):
        # socket read timeout: a stalled upload releases its body-read
        # semaphore slot instead of blocking other clients forever
        timeout = 120

        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _refuse(self, code: int, e: Exception) -> None:
            workers.record("client_error", 0.0)
            self._json(code, {"error": str(e)})

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok",
                                 "devices": workers.device_names(),
                                 "cached": len(workers),
                                 "workers": len(workers.pools)})
            elif self.path == "/metrics":
                body = workers.metrics_text(coalescer).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/synthesize":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._refuse(400, ValueError("bad Content-Length"))
                return
            if not 0 <= n <= _MAX_REQUEST_BYTES:
                self._refuse(413, ValueError(
                    f"request body {n} bytes outside [0, {_MAX_REQUEST_BYTES}]"))
                return
            try:
                # read + parse BEFORE checking out a worker: a slow upload
                # must not hold a compute slot doing network I/O
                with body_read_sem:
                    payload = json.loads(
                        _read_body_deadline(self.rfile, n) or b"{}")
            except (TimeoutError, OSError):
                workers.record("client_error", 0.0)
                try:
                    self._json(408, {"error": "request body read timed out"})
                except OSError:
                    pass
                return
            except (ValueError, TypeError) as e:
                self._refuse(400, e)
                return
            # monotonic, started before checkout: the latency summary shows
            # the queue wait (saturation is what an operator watches for)
            t0 = time.monotonic()
            cohort_n = 1
            try:
                req = _parse_request(payload, config_defaults)
                if req.style_parallel:
                    ctype, body, idx = _execute_style_parallel(workers, req)
                elif req.cfg.num_devices * req.cfg.spatial_devices > 1:
                    ctype, body, idx = _execute_on_ranks(workers, req)
                elif coalescer is not None and _batchable(req):
                    ctype, body, idx, cohort_n = coalescer.submit(req)
                else:
                    idx = workers.checkout()
                    try:
                        ctype, body = _execute(workers.pools[idx], req)
                    finally:
                        workers.checkin(idx)
            except (ValueError, TypeError, KeyError) as e:
                self._refuse(400, e)
                return
            except Exception as e:
                workers.record("server_error", 0.0)
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            workers.record("ok", time.monotonic() - t0)
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Optex-Worker", str(idx))
            if cohort_n > 1:
                self.send_header("X-Optex-Cohort", str(cohort_n))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def serve(port: int = 8700, host: str = "127.0.0.1", workers: int = 1,
          config_defaults: dict | None = None, coalesce: int = 8,
          device=None) -> ThreadingHTTPServer:
    """A server (not yet serving: call ``serve_forever``), with its
    ``workers`` (WorkerSet) and ``coalescer`` (None when off) as attributes.
    ``device``: None for the GPUs (raises without one), "cpu" for CPU pools.
    ``coalesce``: max cohort size for queue-time request batching
    (RequestCoalescer); 1 turns it off."""
    if config_defaults:
        bad = set(config_defaults) - _CONFIG_FIELDS
        if bad:
            raise ValueError(f"unknown config defaults: {sorted(bad)}")
    if coalesce < 1:
        raise ValueError(f"coalesce must be >= 1, got {coalesce}")
    worker_set = WorkerSet(workers, device)
    coalescer = (RequestCoalescer(worker_set, coalesce) if coalesce > 1
                 else None)
    server = _HTTPServer(
        (host, port), make_handler(worker_set, config_defaults, coalescer))
    server.workers, server.coalescer = worker_set, coalescer
    return server


class _HTTPServer(ThreadingHTTPServer):
    """The server; closing it ends its workers' rank groups."""

    def server_close(self):
        super().server_close()
        self.workers.close()


def main() -> None:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--workers", type=int, default=1,
                   help="serving workers, one per GPU: N requests run "
                        "concurrently on N devices; a multi-device request "
                        "(num_devices x spatial_devices = n) takes an "
                        "aligned block of n workers and runs on that "
                        "block's rank processes")
    p.add_argument("--coalesce", type=int, default=8,
                   help="max cohort size for queue-time request batching: "
                        "unseeded single-image synthesis requests for the "
                        "same style+config that queue behind a busy worker "
                        "run as ONE batched run; 1 turns it off")
    p.add_argument("--config_default", action="append", default=[],
                   metavar="KEY=JSON",
                   help="operator default for a config field a request "
                        "omits, e.g. --config_default "
                        "conv_dtype='\"bfloat16\"' (parsed as JSON, bare "
                        "strings allowed)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args()
    defaults = {}
    for kv in args.config_default:
        k, _, v = kv.partition("=")
        try:
            defaults[k] = json.loads(v)
        except json.JSONDecodeError:
            defaults[k] = v  # bare string convenience
    server = serve(args.port, args.host, args.workers, defaults or None,
                   coalesce=args.coalesce, device=args.device)
    print(f"optex serving on http://{args.host}:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
