"""The port's style packs (``optimaltextures_tpu_torch/utils/stylepack.py``)
against the JAX package's, on the CPU: the same file format both ways.

64 px, depth 2, 2 multires passes (two cache entries), the
style ``docs/samples/graffiti_cholhist_256.png``. Without PCA a pack of
each package holds the same manifest and arrays. With PCA on, a pack baked
by one package and imported into the other carries its eigenvectors, so the
two packages run in one basis (the eigh sign difference of ROADMAP.md §3
does not enter) and their tokened runs on the same numpy noise and the same
injected rotation stacks agree within 5e-4 (tests/test_torch_slice.py's
bound); the importing side dispatches no style prep."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimaltextures_tpu import config as jconfig
from optimaltextures_tpu import core as jcore
from optimaltextures_tpu.utils import imageio as jimageio
from optimaltextures_tpu.utils import stylepack as jpack
from optimaltextures_tpu_torch import config as tconfig
from optimaltextures_tpu_torch import core as tcore
from optimaltextures_tpu_torch.utils import stylepack as tpack
from test_torch_settings import clear_jax_stage_caches, stage_order
from test_torch_slice import SAMPLE, RotationStream

OTHER = SAMPLE.replace("graffiti_cholhist_256", "zebra_pattern_lava_mix3_256")
BOUND = 5e-4
PASSES = 2


def _kw(**extra):
    kw = dict(size=64, passes=PASSES, iters=40, depth=2, seed=9,
              style=["graffiti.png"], fast_codec=False)
    kw.update(extra)
    return kw


def _jax(**extra):
    return jcore.Synthesizer(jconfig.OptexConfig(**_kw(**extra)))


def _port(**extra):
    return tcore.Synthesizer(tconfig.OptexConfig(**_kw(**extra)), device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def style():
    return jimageio.load_image(SAMPLE, 64, oversize=False)


@pytest.fixture(scope="module")
def noise():
    return np.random.default_rng(4).uniform(size=(1, 64, 64, 3)).astype(np.float32)


def _manifest(path):
    with np.load(path) as z:
        return json.loads(str(z["manifest"])), {k: z[k] for k in z.files
                                                if k != "manifest"}


def _count_preps(monkeypatch, cls):
    calls = []
    orig = cls._dispatch_style_prep
    monkeypatch.setattr(cls, "_dispatch_style_prep",
                        lambda self, *a: calls.append(1) or orig(self, *a))
    return calls


def _masked(stream, ks):
    """The stream as blockdiag(SO(k), I) stacks, k the true rank of stage
    (p, i) (``ks``), for padded PCA widths; the stream itself otherwise."""
    if ks is None:
        return stream

    def rotations(p, i, n_iters, n):
        k = ks[p][i]
        out = np.tile(np.eye(n, dtype=np.float32), (n_iters, 1, 1))
        out[:, :k, :k] = stream(p, i, n_iters, k)
        return out
    return rotations


def _true_ks(synth, token, style):
    """Per pass, each depth's true PCA rank from a port Synthesizer's
    tokened cache (None without padded widths)."""
    fp = tcore._styles_fingerprint([style])
    ks = []
    for size, rs, _ in synth._plan_passes((64, 64)):
        e = synth._style_prep_cache[((token, fp), size if rs else None)]
        if e.masks[0] is None:
            return None
        ks.append([int(m) for m in e.masks])
    return ks


def _jax_injected_run(monkeypatch, synth, noise, style, rotations):
    """A tokened JAX run with every stage's rotation stack (plain or masked)
    taken from ``rotations``, in the order its run programs trace the
    stages (pass-major, deepest first)."""
    order, calls = stage_order(PASSES), []

    def fake(key, n_iters, n, k_mask=None):
        p, i = order[len(calls)]
        calls.append((p, i))
        return jnp.asarray(rotations(p, i, n_iters, n))

    clear_jax_stage_caches()
    try:
        monkeypatch.setattr("optimaltextures_tpu.transport.stage_rotations",
                            fake)
        monkeypatch.setattr(
            "optimaltextures_tpu.transport.stage_rotations_masked", fake)
        out = np.asarray(synth.run(jnp.asarray(noise), [style],
                                   styles_token="t"))
    finally:
        clear_jax_stage_caches()
    assert calls == order
    return out


@pytest.mark.parametrize("extra", [dict(no_pca=True),
                                   dict(no_pca=True, hist_mode="cdf")])
def test_packs_of_both_packages_agree(tmp_path, style, noise, extra):
    """Without PCA the targets do not depend on an eigh basis: a port pack
    and a JAX pack of the same style and config hold the same manifest and
    the same arrays."""
    j = _jax(**extra)
    j.run(jnp.asarray(noise), [style], styles_token="t")
    jm, ja = _manifest(jpack.export_style_pack(j, "t", str(tmp_path / "j.npz")))
    t = _port(**extra)
    t.run(noise, [style], styles_token="t")
    tm, ta = _manifest(tpack.export_style_pack(t, "t", str(tmp_path / "t.npz")))
    assert tm == jm
    assert len({e["ck"] for e in tm["entries"]}) == 2
    assert sorted(ta) == sorted(ja)
    for name, ref in ja.items():
        assert ta[name].dtype == ref.dtype and ta[name].shape == ref.shape, name
        np.testing.assert_allclose(ta[name], ref, rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("extra", [dict(), dict(pca_bucket=16)])
def test_jax_pack_runs_in_the_port(tmp_path, monkeypatch, style, noise, extra):
    """A JAX-baked pack with PCA on: the port imports it, dispatches no style
    prep, and its run is JAX's own tokened run on the same noise and
    rotations (with pca_bucket the k-masks ride in the pack)."""
    donor = _jax(**extra)
    donor.run(jnp.asarray(noise), [style], styles_token="t")
    path = jpack.export_style_pack(donor, "t", str(tmp_path / "pack.npz"))

    port = _port(**extra)
    assert tpack.import_style_pack(port, "t", path) == 2
    ks = _true_ks(port, "t", style)
    assert (ks is not None) == bool(extra)
    rotations = _masked(RotationStream(23), ks)
    ref = _jax_injected_run(monkeypatch, donor, noise, style, rotations)
    preps = _count_preps(monkeypatch, tcore.Synthesizer)
    got = port.run(noise, [style], styles_token="t", rotations=rotations).numpy()
    assert preps == []
    assert port.last_run_ks == [tuple(e["widths"]) for e in
                                _manifest(path)[0]["entries"]]
    assert got.shape == ref.shape == (1, 64, 64, 3)
    assert float(np.abs(got - ref).max()) < BOUND


def test_port_pack_runs_in_jax(tmp_path, monkeypatch, style, noise):
    """A port-baked pack with PCA on imports into the JAX package, which
    dispatches no style prep and matches the port's tokened run."""
    donor = _port()
    donor.run(noise, [style], styles_token="t")
    path = tpack.export_style_pack(donor, "t", str(tmp_path / "pack.npz"))
    rotations = RotationStream(37)
    want = donor.run(noise, [style], styles_token="t",
                     rotations=rotations).numpy()

    fresh = _jax()
    assert jpack.import_style_pack(fresh, "t", path) == 2
    preps = _count_preps(monkeypatch, jcore.Synthesizer)
    got = _jax_injected_run(monkeypatch, fresh, noise, style, rotations)
    assert preps == []
    assert float(np.abs(got - want).max()) < BOUND


def test_port_pack_roundtrip_and_stale_token(tmp_path, monkeypatch, style,
                                             noise):
    """Port to port: an imported pack runs bit-equal to the donor with no
    style prep; a token reused for another style keeps two fingerprints,
    and after the import a run with the first style still gets the first
    style's targets (tests/test_stylepack.py's cases)."""
    other = jimageio.load_image(OTHER, 64, oversize=False)
    donor = _port()
    a = donor.run(noise, [style], styles_token="t", key=5).numpy()
    donor.run(noise, [other], styles_token="t", key=5)   # stale reuse
    path = tpack.export_style_pack(donor, "t", str(tmp_path / "pack.npz"))
    assert len(_manifest(path)[0]["entries"]) == 4       # 2 passes x 2 styles

    fresh = _port()
    assert tpack.import_style_pack(fresh, "t", path) == 4
    preps = _count_preps(monkeypatch, tcore.Synthesizer)
    b = fresh.run(noise, [style], styles_token="t", key=5).numpy()
    assert preps == []
    np.testing.assert_array_equal(a, b)
    assert all(e.spectra is None and e.slim is not None
               for e in fresh._style_prep_cache.values())


def test_style_pack_guards(tmp_path, style, noise):
    donor = _port()
    with pytest.raises(ValueError, match="no finished"):
        tpack.export_style_pack(donor, "t", str(tmp_path / "x.npz"))
    donor.run(noise, [style], styles_token="t")
    path = tpack.export_style_pack(donor, "t", str(tmp_path / "x.npz"))
    with pytest.raises(ValueError, match="signature"):
        tpack.import_style_pack(_port(hist_mode="sym"), "t", path)
    manifest, arrays = _manifest(path)
    manifest["version"] = 1
    bad = str(tmp_path / "v1.npz")
    np.savez(bad, manifest=np.asarray(json.dumps(manifest)), **arrays)
    with pytest.raises(ValueError, match="version"):
        tpack.import_style_pack(_port(), "t", bad)
