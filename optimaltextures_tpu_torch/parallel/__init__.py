"""Multi-device runs on ``torch.distributed`` (the counterpart of
``optimaltextures_tpu/parallel/``): one process per device.

* :mod:`.mesh`: the process group as a 1-D mesh or a 2-D grid, their
  collectives (the halo rows of an H-sharded image among them), and
  :func:`.mesh.spawn`, which starts N ranks;
* :mod:`.shard_ot`: batch data parallelism, the pastiche batch split over
  the ranks with the transport statistics reduced over them;
* :mod:`.spatial`: spatial sharding, one image's rows split over the
  ranks, every 3x3 conv on rows exchanged with the neighbours and the
  statistics global;
* :mod:`.grid`: the two composed on an (n_data x n_space) grid;
* :mod:`.style_dp`: style-parallel synthesis, one style per rank,
  collective-free.
"""
