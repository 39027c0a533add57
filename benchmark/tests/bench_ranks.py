"""Rank bodies for the spatial tests on CPU gloo ranks (imported by path
in each rank: module-level functions only)."""

import time


def tiny(name: str):
    from benchlib import cells

    c = cells.load(name)
    return c._replace(
        config=dict(c.config, passes=2, iters=30),
        traffic=dict(c.traffic, batch=1, size=256, exemplar_size=128,
                     check_among=1, trace_calls=1))


def spatial_rank(mesh, name: str, seed: int, fault: str):
    """A tiny spatial run on a CPU rank, with ``fault`` "exchange" leaving
    the halo exchange out (every rank pads its own rows)."""
    import numpy as np
    import torch

    from benchlib import session
    from optimaltextures_tpu_torch.parallel.mesh import Mesh

    # a rank sets its torch thread count, after which this CPU build's LU
    # (slogdet) does not return: take the sign and log |det| from numpy
    def slogdet(g):
        s, l = np.linalg.slogdet(g.detach().cpu().double().numpy())
        return (torch.from_numpy(s).to(g), torch.from_numpy(l).to(g))
    torch.linalg.slogdet = slogdet

    if fault == "exchange":
        Mesh.halo_rows = lambda self, x, r, mode="reflect": (None, None)
    c = tiny(name)
    c = c._replace(traffic=dict(c.traffic, spatial_devices=mesh.size))
    r = session.run(mesh, c, seed, 0.0, False, time.time(), device="cpu")
    return {k: r[k] for k in ("numbers", "calls")} if mesh.rank == 0 else r
