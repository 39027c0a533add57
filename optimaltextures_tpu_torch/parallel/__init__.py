"""Multi-device runs on ``torch.distributed`` (the counterpart of
``optimaltextures_tpu/parallel/``): one process per device.

* :mod:`.mesh`: the process group as a 1-D mesh, its collectives, and
  :func:`.mesh.spawn`, which starts N ranks;
* :mod:`.shard_ot`: batch data parallelism, the pastiche batch split over
  the ranks with the transport statistics reduced over them;
* :mod:`.style_dp`: style-parallel synthesis, one style per rank,
  collective-free.

The spatial (H-axis) and 2-D grid layouts are not ported yet (ROADMAP.md,
queue 1 item 15b).
"""
