"""``batch_chunk``, the PCA width settings (``pca_bucket``, ``pca_traced_k``),
the ``styles_token`` prep cache, low-memory prep and ``quantize_uint8`` in the
port, on the CPU.

The chunked run is held against the JAX package's chunked run (64 px, depth
2, batch 4 in chunks of 2, no PCA, the same noise and injected rotations,
5e-4). The rest compares the port with itself: eigenvector signs differ
between torch's and JAX's eigh and the chol transform is not
basis-invariant, so PCA-on runs of the two packages cannot be compared pixel
by pixel (ROADMAP.md section 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu import core as jcore
from optimaltextures_tpu.utils import imageio as jimageio
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch import transport as ttransport
from test_torch_settings import INIT, jax_injected, one_torch_thread  # noqa: F401
from test_torch_slice import SAMPLE, RotationStream


@pytest.fixture(scope="module")
def style():
    return jimageio.load_image(SAMPLE, 64)


def _noise(shape, seed=5):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _synth(**kw):
    base = dict(size=32, passes=2, iters=24, no_multires=True, depth=2, seed=3,
                style=["graffiti.png"])
    base.update(kw)
    return tcore.Synthesizer(tconfig.OptexConfig(**base), device="cpu")


def test_chunked_matches_jax_chunked(style, monkeypatch):
    kw = dict(size=64, passes=2, iters=40, no_multires=True, depth=2, seed=0,
              no_pca=True, batch=4, batch_chunk=2, style=["graffiti.png"],
              fast_codec=False)
    noise = _noise((4, 64, 64, 3))
    stream = RotationStream(37)
    synth = jcore.Synthesizer(jconfig.OptexConfig(**kw))
    ref = jax_injected(monkeypatch, stream, 2,
                       lambda: synth.run(jnp.asarray(noise), [style]))
    got = tcore.Synthesizer(tconfig.OptexConfig(**kw), device="cpu").run(
        noise, [style], rotations=stream).numpy()
    assert got.shape == ref.shape == (4, 64, 64, 3)
    assert float(np.abs(got - ref).max()) < 5e-4
    assert float(np.abs(got[0] - got[3]).mean()) > 0.05   # four textures


CHUNK_CASES = {
    "chol": dict(no_pca=True),
    "sym": dict(no_pca=True, hist_mode="sym"),
    "pca_mode": dict(no_pca=True, hist_mode="pca"),
    "pca_on": dict(),
    "bucket16": dict(pca_bucket=16),
    "traced_k": dict(pca_traced_k=True),
    "resize_pass": dict(pastiche_px=48),
    "multires": dict(no_multires=False),     # passes at 256, then 32 px
    "plain_codec": dict(no_pca=True, fast_codec=False),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunked_matches_unchunked(style, case):
    """The same run at batch 4, in chunks of 2 and whole, on the same
    generator stream: only the covariance's summation order differs. With
    ``resize_pass`` the 48-px pastiche resizes to 32 px in the first pass;
    ``multires`` resizes in both."""
    kw = dict(CHUNK_CASES[case])
    px = kw.pop("pastiche_px", 32)
    noise = _noise((4, px, px, 3))
    whole = _synth(batch=4, **kw).run(noise, [style])
    synth = _synth(batch=4, batch_chunk=2, **kw)
    if case in ("resize_pass", "multires"):
        assert synth._plan_passes((px, px))[0][1]
    chunked = synth.run(noise, [style])
    assert chunked.shape == whole.shape == (4, 32, 32, 3)
    err = float((chunked - whole).abs().max())
    assert err <= 2e-4, err


def test_chunk_refusals(style):
    synth = _synth(batch=4, batch_chunk=2, no_pca=True)
    with pytest.raises(ValueError, match="not divisible"):
        synth.run(_noise((5, 32, 32, 3)), [style])
    with pytest.raises(ValueError, match="synthesis only"):
        synth._chunks(4, True)
    # batch <= batch_chunk runs whole
    assert synth._chunks(2, False) == 1 and synth._chunks(4, False) == 2


@pytest.mark.parametrize("with_content", [False, True])
def test_pca_bucket_one_equals_exact(style, with_content):
    """pca_bucket=1 rounds no width up: the widths are the exact ks, the
    Gaussians the same, and only the true-rank means and masks differ in
    rounding."""
    kw = dict(size=64, iters=30)
    content, noise = None, _noise((1, 64, 64, 3))
    if with_content:
        kw.update(content="c.png", content_strength=0.2)
        content = jimageio.load_image(INIT, 64, oversize=False)
        noise = _noise(content.shape)
    exact = _synth(**kw)
    bucket = _synth(pca_bucket=1, **kw)
    a = exact.run(noise, [style], content)
    b = bucket.run(noise, [style], content)
    assert exact.last_run_ks == bucket.last_run_ks
    assert float((a - b).abs().max()) <= 2e-3


def test_traced_k_equals_bucket_1024(style, monkeypatch):
    """Both run at the full width C with the true rank as a mask; traced k
    takes no host k-decision (choose_k raises if called)."""
    noise = _noise((1, 64, 64, 3))
    a = _synth(size=64, pca_bucket=1024).run(noise, [style])

    def no_host_decision(_):
        raise AssertionError("pca_traced_k took a host k-decision")

    monkeypatch.setattr(ttransport, "choose_k", no_host_decision)
    synth = _synth(size=64, pca_traced_k=True)
    b = synth.run(noise, [style])
    assert synth.last_run_ks == [(128, 64), (128, 64)]
    assert float((a - b).abs().max()) <= 1e-4


def test_pca_bucket_keeps_pads_zero(style):
    """With a bucketed width the eigvec columns past the true rank, the
    style statistics there and a stage's padded feature dims stay exactly
    zero."""
    synth = _synth(size=64, pca_bucket=16)
    spectra = synth._dispatch_style_prep([torch.from_numpy(style)], 64, False)
    widths, masks = synth._choose_widths(spectra)
    slim = synth._finish_style_prep(spectra, widths, masks)
    targets = synth._assemble_targets(slim, None, masks)
    for (eigvecs, stats, _), w, tk, tgt in zip(slim, widths, masks, targets):
        tk = int(tk)
        assert w % 16 == 0 or w == eigvecs.shape[0]
        assert tk < w, (tk, w)           # this style pads every depth
        assert not eigvecs[:, tk:].any()
        assert not stats.mu[..., tk:].any() and not stats.cov_raw[tk:].any()
        feat = torch.randn(1, 8, 8, eigvecs.shape[0],
                           generator=torch.Generator().manual_seed(0)) @ eigvecs
        assert not feat[..., tk:].any()
        gen = torch.Generator().manual_seed(1)
        out = ttransport.transport_loop(gen, feat, tgt.stats, 12, "chol",
                                        k_mask=tgt.k_mask)
        assert not out[..., tk:].any() and bool(out[..., :tk].abs().sum() > 0)
        out = ttransport.transport_loop(gen, feat, tgt.stats, 5, "chol",
                                        k_mask=tgt.k_mask, cov_prop=False)
        assert not out[..., tk:].any()


class _CountPrep:
    def __init__(self, synth):
        self.calls, self.inner = 0, synth._dispatch_style_prep
        synth._dispatch_style_prep = self

    def __call__(self, *args):
        self.calls += 1
        return self.inner(*args)


def test_styles_token_warm_hit_and_stale_token(style):
    noise = _noise((1, 32, 32, 3))
    other = _noise((1, 64, 64, 3), seed=9)
    synth = _synth(passes=3)
    count = _CountPrep(synth)
    cold = synth.run(noise, [style], styles_token="graffiti")
    assert count.calls == 1              # no_multires: one shared prep
    warm = synth.run(noise, [style], styles_token="graffiti")
    assert count.calls == 1              # the warm hit preps nothing
    assert torch.equal(cold, warm)
    assert torch.equal(cold, _synth(passes=3).run(noise, [style]))
    # the same token with another style: the fingerprint misses, it preps
    stale = synth.run(noise, [other], styles_token="graffiti")
    assert count.calls == 2
    assert torch.equal(stale, _synth(passes=3).run(noise, [other]))
    # kept entries hold their finished targets and no spectra
    assert all(e.spectra is None and e.slim is not None
               for e in synth._style_prep_cache.values())
    assert len(synth._style_prep_cache) == 2


def test_styles_token_with_mixing(style):
    noise = _noise((1, 32, 32, 3))
    pair = [style, _noise((1, 64, 64, 3), seed=9)]
    synth = _synth(style=["a", "b"])
    count = _CountPrep(synth)
    first = synth.run(noise, pair, styles_token="pair")
    second = synth.run(noise, pair, styles_token="pair")
    assert count.calls == 1 and torch.equal(first, second)


@pytest.mark.parametrize("kw", [dict(), dict(style=["a", "b"]),
                                dict(no_multires=False, passes=2, size=64)])
def test_low_memory_prep_equals_normal(style, kw):
    styles = [style] if "style" not in kw else [style, _noise((1, 64, 64, 3), 9)]
    px = kw.get("size", 32)
    noise = _noise((1, px, px, 3))
    normal = _synth(**kw).run(noise, styles)
    synth = _synth(**kw)
    synth._PREP_PREFETCH_BYTES = 0
    count = _CountPrep(synth)
    low = synth.run(noise, styles)
    assert float((low - normal).abs().max()) <= 1e-6
    # the prep was dispatched inside phase C, once per distinct pass prep
    assert count.calls == len({(s if rs else None)
                               for (s, rs, _) in synth._plan_passes((px, px))})


def test_low_memory_tokened_run_keeps_targets(style):
    noise = _noise((1, 32, 32, 3))
    synth = _synth()
    synth._PREP_PREFETCH_BYTES = 0
    count = _CountPrep(synth)
    a = synth.run(noise, [style], styles_token="t")
    b = synth.run(noise, [style], styles_token="t")
    assert count.calls == 1 and torch.equal(a, b)


def test_quantize_uint8_run(style):
    noise = _noise((2, 32, 32, 3))
    synth = _synth(batch=2)
    f = synth.run(noise, [style]).numpy()
    q = synth.run(noise, [style], quantize_uint8=True)
    assert q.dtype == torch.uint8 and q.shape == (2, 32, 32, 3)
    host = (np.clip(f, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    assert np.array_equal(q.numpy(), host)
