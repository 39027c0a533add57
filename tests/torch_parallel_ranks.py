"""Rank bodies for tests/test_torch_parallel.py. The ranks are processes
started by ``parallel.mesh.spawn``, which import this module by name: it
imports torch and the port only (no jax, no test module)."""

import sys
import time

import torch

from optimaltextures_tpu_torch import config, core
from optimaltextures_tpu_torch.ops import histmatch
from optimaltextures_tpu_torch.parallel import mesh as mesh_mod
from optimaltextures_tpu_torch.parallel import shard_ot, style_dp


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
