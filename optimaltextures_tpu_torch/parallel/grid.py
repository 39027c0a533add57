"""The 2-D (batch x height) grid: batch data parallelism and spatial
sharding composed (the counterpart of ``optimaltextures_tpu/parallel/grid.py``).

On an (n_data x n_space) grid (``parallel.mesh.make_grid_mesh``) rank
``d * n_space + s`` holds row block s of the images of batch shard d:

* the convs exchange halo rows along the space axis only (the batch is
  embarrassingly parallel): the exchange and crop of models/fastcodec.py
  and the halo stack of parallel/spatial.py on the grid's space mesh;
* the per-(image, channel) means reduce over the space axis, the pooled
  Gram (and cdf's range and target counts) over the whole grid: the joint
  statistics of the single-device batch;
* sort recovers the single-device flatten order by the two-step gather of
  ``shard_ot._sort_step_grid``.

Every rank draws the same rotations, so a grid run equals the one-process
run within float tolerance.
"""

from __future__ import annotations

from typing import Optional

from .. import transport
from .spatial import _rows_pass


def grid_transport_loop(gen, feature, style_mu, style_cov_raw, n_iters: int,
                        mode: str, *, grid, style_samples=None,
                        content_feature=None, content_strength: float = 0.0,
                        k_mask=None, cov_prop: Optional[bool] = None,
                        rotations=None, use_pallas: bool = True):
    """The OT loop on this rank's (images, rows) block of the feature map
    (``grid``: a parallel.mesh.GridMesh): the means over the space axis, the
    Gram matrices, cdf's range and counts over the whole grid, sort by the
    two-step gather. The JAX package's ``grid_transport_loop``:
    ``transport.transport_loop`` with the grid as its mesh and the grid's
    space mesh as its mean mesh."""
    return transport.transport_loop(
        gen, feature, transport.StyleStats(style_mu, style_cov_raw,
                                           style_samples), n_iters, mode,
        content_feature=content_feature, content_strength=content_strength,
        rotations=rotations, use_pallas=use_pallas, k_mask=k_mask,
        cov_prop=cov_prop, mesh=grid, mean_mesh=grid.space)


def make_grid_pass(grid, *, depths, iters, mode: str, strengths, pca_flags,
                   pad_mode: str = "reflect", cov_prop=None,
                   fast_codec: bool = False):
    """ALL of a pass's layer stages on this rank's block of the grid, as
    ``spatial.make_spatial_pass`` (the same arguments and function) with
    the halos and means on the grid's space mesh and the Gram on the whole
    grid."""
    if not grid.grid:
        raise ValueError(f"{grid!r} is not a GridMesh")
    return _rows_pass(grid, grid.space, depths=depths, iters=iters, mode=mode,
                      strengths=strengths, pca_flags=pca_flags,
                      pad_mode=pad_mode, cov_prop=cov_prop,
                      fast_codec=fast_codec)
