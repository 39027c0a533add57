"""Rank bodies for tests/test_torch_parallel.py, tests/test_torch_spatial.py
and tests/test_torch_serve_ranks.py. The ranks are processes started by
``parallel.mesh.spawn`` or ``parallel.mesh.RankGroup``, which import this
module by name: it imports torch and the port only (no jax, no test
module)."""

import sys
import time

import torch

from optimaltextures_tpu_torch import config, core
from optimaltextures_tpu_torch.models import fastcodec
from optimaltextures_tpu_torch.ops import histmatch
from optimaltextures_tpu_torch.parallel import grid as grid_mod
from optimaltextures_tpu_torch.parallel import mesh as mesh_mod
from optimaltextures_tpu_torch.parallel import shard_ot, spatial, style_dp
from optimaltextures_tpu_torch.tools.dryrun_multichip import kernel_call


class Stacks:
    """Injected rotation stacks {(pass, stage): (n_iters, C, C)} as a
    core.RotationSource."""

    def __init__(self, stacks):
        self.stacks = stacks

    def __call__(self, p, i, n_iters, n):
        return self.stacks[(p, i)]


def _shard(x, mesh):
    b = x.shape[0] // mesh.size
    return torch.as_tensor(x)[mesh.rank * b:(mesh.rank + 1) * b]


def jobs(mesh, todo):
    """Several of this module's rank bodies in one spawn: [(name, args)] ->
    their results in order."""
    here = sys.modules[__name__]
    return [getattr(here, name)(mesh, *args) for name, args in todo]


def collectives(mesh):
    """Each helper of the mesh on small tensors (rank r contributes r + 1),
    and make_mesh's refusal of another size."""
    x = torch.tensor([mesh.rank + 1.0, -(mesh.rank + 1.0)])
    try:
        mesh_mod.make_mesh(mesh.size + 1, device="cpu")
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return dict(refusal=refusal, psum=mesh.psum(x), pmin=mesh.pmin(x),
                pmax=mesh.pmax(x),
                gather0=mesh.all_gather(x[None]),
                gather1=mesh.all_gather(x[:, None], dim=1),
                bcast=mesh.broadcast(x, src=mesh.size - 1),
                bcast_int=mesh.broadcast_int(100 + mesh.rank),
                ints=mesh.psum(torch.tensor([mesh.rank], dtype=torch.int64)),
                rank=mesh.rank, size=mesh.size, device=str(mesh.device))


def steps(mesh, feature, style_mu, style_cov, samples, rots, n_iters):
    """The sharded steps and loops on this rank's shard of ``feature``
    (B, H, W, C); every result gathered back to the whole batch."""
    f = _shard(feature, mesh)
    mu, cov = torch.as_tensor(style_mu), torch.as_tensor(style_cov)
    s = torch.as_tensor(samples)
    rots = torch.as_tensor(rots)
    out = {}
    for mode in ("chol", "pca", "sym"):
        out[mode] = shard_ot._moment_step_sharded(rots[0], f, mu, cov, mode,
                                                  mesh)
        out[mode + "_loop"] = shard_ot.sharded_transport_loop(
            None, f, mu, cov, n_iters, mode, mesh=mesh,
            rotations=rots[:n_iters])
        out[mode + "_iter"] = shard_ot.sharded_transport_loop(
            None, f, mu, cov, n_iters, mode, mesh=mesh,
            rotations=rots[:n_iters], cov_prop=False)
    out["chol_gen"] = shard_ot.ot_step_moment_sharded(
        torch.Generator().manual_seed(5), f, mu, cov, "chol", mesh)
    seen = {}
    apply_rows = histmatch.cdf_apply_rows

    def capture(t, t_hist, s_hist, lo, hi, use_pallas=True):
        seen.update(t_hist=t_hist, s_hist=s_hist, lo=lo, hi=hi)
        return apply_rows(t, t_hist, s_hist, lo, hi, use_pallas)

    histmatch.cdf_apply_rows = capture
    try:
        out["cdf"] = shard_ot._cdf_step_sharded(rots[0], f, s, mesh)
    finally:
        histmatch.cdf_apply_rows = apply_rows
    out["sort"] = shard_ot._sort_step_sharded(rots[0], f, s, mesh)
    out["cdf_loop"] = shard_ot.sharded_transport_loop(
        None, f, mu, cov, n_iters, "cdf", mesh=mesh, style_samples=s,
        rotations=rots[:n_iters])
    out["sort_loop"] = shard_ot.sharded_transport_loop(
        None, f, mu, cov, n_iters, "sort", mesh=mesh, style_samples=s,
        rotations=rots[:n_iters])
    got = {k: mesh.all_gather(v).numpy() for k, v in out.items()}
    # the cdf step's global range and counts (the same on every rank)
    got.update({"cdf_" + k: v.numpy() for k, v in seen.items()})
    return got


def chunked_stage(mesh, pastiche, style_mu, style_cov, rots, depth,
                  n_chunks):
    """shard_ot._chunked_stage_local (F.conv2d codec, chol, no PCA) on this
    rank's shard, the rotations injected; gathered."""
    from optimaltextures_tpu_torch.models.vgg import VGGBank

    bank = VGGBank(depth, device="cpu")
    out = shard_ot._chunked_stage_local(
        bank.enc_params[depth], bank.dec_params[depth], _shard(pastiche, mesh),
        torch.as_tensor(style_mu), torch.as_tensor(style_cov), None, 0, None,
        depth=depth, n_iters=len(rots), mode="chol", pca_flag=False,
        n_chunks=n_chunks, mesh=mesh, rotations=Stacks({(0, 0): rots}))
    return mesh.all_gather(out).numpy()


def dp_runs(mesh, cases, styles):
    """Synthesizer(cfg, mesh=mesh).run for each case (config kwargs, noise,
    rotation stacks or None): every rank's gathered output, so that the
    caller sees that the ranks agree."""
    out = []
    for kw, noise, stacks in cases:
        synth = core.Synthesizer(config.OptexConfig(**kw), mesh=mesh)
        got = synth.run(noise, styles,
                        rotations=Stacks(stacks) if stacks else None)
        out.append(mesh.all_gather(got[None]).numpy())
    return out


def style_runs(mesh, cases, styles):
    """style_dp.synthesize_style_batch on the mesh for each case (config
    kwargs, pastiche, rotation stacks or None, force widths)."""
    return [style_dp.synthesize_style_batch(
        config.OptexConfig(**kw), styles, mesh, pastiche=pastiche,
        _force_widths=force,
        rotations=Stacks(stacks) if stacks else None).numpy()
        for kw, pastiche, stacks, force in cases]


def one_shot_u8(mesh, cfg_kw, styles):
    """``core.synthesize`` of ``cfg_kw`` on the mesh, quantized as a served
    response is (``core._quant_u8``): what ``api.run_files`` runs on its
    ranks, the reference of a served multi-device request."""
    out, _ = core.synthesize(config.OptexConfig(**cfg_kw), styles, mesh=mesh)
    return core._quant_u8(out).numpy()


def hangs(mesh):
    """Rank 0 sleeps past any deadline a test gives."""
    if mesh.rank == 0:
        time.sleep(600)
    return "unreachable"


def fails(mesh, message):
    """Rank 1 raises before a collective that the others enter."""
    if mesh.rank == 1:
        raise ValueError(message)
    mesh.psum(torch.zeros(1))
    return "unreachable"


# ---------------------------------------------------------------------------
# spatial sharding and the 2-D grid (tests/test_torch_spatial.py)


def _rows(x, space):
    return spatial.own_rows(torch.as_tensor(x), space)


def _grid_block(x, grid):
    """This grid rank's block: its data shard's images, its space rows."""
    x = torch.as_tensor(x)
    b = x.shape[0] // grid.data.size
    return _rows(x[grid.data.rank * b:(grid.data.rank + 1) * b], grid.space)


def _gather_grid(y, grid):
    return grid.data.all_gather(grid.space.all_gather(y, dim=1))


def halos(mesh, x):
    """spatial._halo_pad_h of this rank's rows in both modes, and the raw
    2-row halo_rows; gathered along H."""
    space = mesh.with_axis("space")
    xr = _rows(x, space)
    out = {}
    for mode in ("reflect", "wrap"):
        out[mode] = space.all_gather(spatial._halo_pad_h(xr, space, mode),
                                     dim=1).numpy()
        top, bottom = space.halo_rows(xr, 2, mode)
        out[mode + "_rows"] = [None if t is None else t.numpy()
                               for t in (top, bottom)]
    return out


def exchanged_kernels(mesh, cases):
    """kernel_call (tools/dryrun_multichip.py) on this rank's rows for each case (name, x, w, b, kwargs,
    dtype, pad), gathered along H."""
    space = mesh.with_axis("space")
    return [space.all_gather(
        kernel_call(name, _rows(x, space), w, b, kw, dtype, pad, space),
        dim=1).numpy() for name, x, w, b, kw, dtype, pad in cases]


def codec_rows(mesh, img, feat, depth, pad):
    """encode_head / decode_tail with the exchanger, and the F.conv2d halo
    stack (encode_spatial / decode_spatial), on this rank's rows of ``img``
    (pixels) and ``feat`` (relu{depth}_1 features); gathered along H."""
    from optimaltextures_tpu_torch.models.vgg import VGGBank

    space = mesh.with_axis("space")
    bank = VGGBank(depth, device="cpu")
    enc, dec = bank.enc_params[depth], bank.dec_params[depth]
    sc = fastcodec.pack_stage(enc, dec, depth)
    px, f = _rows(img, space), _rows(feat, space)
    got = dict(
        head=fastcodec.encode_head(sc, fastcodec.pixels_to_rgb(enc[0], px),
                                   pad, space),
        tail=fastcodec.decode_tail(sc, f, pad, space),
        encode=spatial.encode_spatial(enc, depth, px, space, pad),
        decode=spatial.decode_spatial(dec, depth, f, space, pad))
    return {k: space.all_gather(v, dim=1).numpy() for k, v in got.items()}


def _capture_cdf(seen):
    apply_rows = histmatch.cdf_apply_rows

    def capture(t, t_hist, s_hist, lo, hi, use_pallas=True):
        seen.update(t_hist=t_hist.numpy(), lo=lo.numpy(), hi=hi.numpy())
        return apply_rows(t, t_hist, s_hist, lo, hi, use_pallas)
    return apply_rows, capture


def spatial_loops(mesh, feature, style_mu, style_cov, samples, content,
                  rots, n_iters):
    """spatial_transport_loop on this rank's rows in every mode (the moment
    modes with and without the content pull, composed and per iteration),
    the first cdf step's global counts; gathered along H."""
    space = mesh.with_axis("space")
    f, cf = _rows(feature, space), _rows(content, space)
    mu, cov = torch.as_tensor(style_mu), torch.as_tensor(style_cov)
    s, rots = torch.as_tensor(samples), torch.as_tensor(rots)[:n_iters]
    kw = dict(mesh=space, rotations=rots, style_samples=s)
    out = {}
    for mode in ("chol", "pca", "sym"):
        out[mode] = spatial.spatial_transport_loop(None, f, mu, cov, n_iters,
                                                   mode, **kw)
        out[mode + "_content"] = spatial.spatial_transport_loop(
            None, f, mu, cov, n_iters, mode, content_feature=cf,
            content_strength=0.3, **kw)
        out[mode + "_iter"] = spatial.spatial_transport_loop(
            None, f, mu, cov, n_iters, mode, cov_prop=False, **kw)
    seen = {}
    apply_rows, capture = _capture_cdf(seen)
    histmatch.cdf_apply_rows = capture
    try:
        out["cdf_step"] = spatial.spatial_transport_loop(
            None, f, mu, cov, 1, "cdf", **dict(kw, rotations=rots[:1]))
    finally:
        histmatch.cdf_apply_rows = apply_rows
    out["cdf"] = spatial.spatial_transport_loop(None, f, mu, cov, n_iters,
                                                "cdf", **kw)
    out["sort"] = spatial.spatial_transport_loop(None, f, mu, cov, n_iters,
                                                 "sort", **kw)
    out["sort_content"] = spatial.spatial_transport_loop(
        None, f, mu, cov, n_iters, "sort", content_feature=cf,
        content_strength=0.3, **kw)
    got = {k: space.all_gather(v, dim=1).numpy() for k, v in out.items()}
    got.update({"cdf_" + k: v for k, v in seen.items()})
    return got


def grid_steps(mesh, n_data, n_space, feature, style_mu, style_cov, samples,
               rots, n_iters):
    """On the (n_data x n_space) grid: _sort_step_grid, and
    grid_transport_loop in chol (composed and per iteration), cdf and sort,
    on this rank's block of ``feature``; gathered."""
    g = mesh_mod.make_grid_mesh(n_data, n_space, device=mesh.device)
    f = _grid_block(feature, g)
    mu, cov = torch.as_tensor(style_mu), torch.as_tensor(style_cov)
    s, rots = torch.as_tensor(samples), torch.as_tensor(rots)[:n_iters]
    out = {"sort_step": shard_ot._sort_step_grid(rots[0], f, s, g)}
    for mode, kw in (("chol", {}), ("chol_iter", dict(cov_prop=False)),
                     ("cdf", {}), ("sort", {})):
        out[mode] = grid_mod.grid_transport_loop(
            None, f, mu, cov, n_iters, mode.split("_")[0], grid=g,
            style_samples=s, rotations=rots, **kw)
    return {k: _gather_grid(v, g).numpy() for k, v in out.items()}


def layout_runs(mesh, cases, styles):
    """Synthesizer(cfg, mesh=mesh).run for each case (config kwargs, noise,
    rotation stacks or None, content or None): every rank's output, so that
    the caller sees that the ranks agree."""
    out = []
    for kw, noise, stacks, content in cases:
        synth = core.Synthesizer(config.OptexConfig(**kw), mesh=mesh)
        got = synth.run(noise, styles, content=content,
                        rotations=Stacks(stacks) if stacks else None)
        out.append(mesh.all_gather(got[None]).numpy())
    return out


def divisibility(mesh, styles):
    """The refusals of a spatial Synthesizer on 2 ranks: a 66-px pass size
    at construction, and a run whose content (66 x 64 px) gives a pass
    height that does not split."""
    import numpy as np

    kw = dict(size=66, passes=1, iters=2, no_multires=True, depth=2, seed=0,
              spatial_devices=2, style=["s"])
    msgs = []
    try:
        core.Synthesizer(config.OptexConfig(**kw), mesh=mesh)
    except ValueError as e:
        msgs.append(str(e))
    synth = core.Synthesizer(config.OptexConfig(**dict(kw, size=64)),
                             mesh=mesh)
    content = np.zeros((1, 66, 64, 3), np.float32)
    try:
        synth.run(content, styles, content=content)
    except ValueError as e:
        msgs.append(str(e))
    return msgs
