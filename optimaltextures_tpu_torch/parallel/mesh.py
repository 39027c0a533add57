"""The device mesh: one process per device on ``torch.distributed`` (the
counterpart of ``optimaltextures_tpu/parallel/mesh.py``).

A :class:`Mesh` is the 1-D view of the initialised default process group
that the sharded code needs: this rank's index, the group's size, this
rank's device and the axis name. Its :meth:`~Mesh.psum`, :meth:`~Mesh.pmin`,
:meth:`~Mesh.pmax`, :meth:`~Mesh.all_gather` and :meth:`~Mesh.broadcast` are
the only place the port calls a collective. NCCL takes CUDA tensors as they
are. gloo, the CPU tests' backend, takes host tensors: a CUDA tensor is
copied to the host and back, explicitly, in those helpers (gloo takes CUDA
tensors for only some collectives, and NCCL refuses two ranks on one GPU,
so gloo is how two ranks share one card). The backend is the caller's
choice; nothing falls back from one to the other.

Ranks come from :func:`spawn` (``spawn`` start method, a ``file://``
rendezvous in a fresh temporary directory, a group timeout and a deadline)
or from ``torchrun``, under which :func:`make_mesh` takes the group that is
already there."""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

# a collective that waits longer than this raises (gloo; NCCL's watchdog)
GROUP_TIMEOUT_S = 600.0


class Mesh:
    """The default process group as a 1-D mesh over ``axis``."""

    def __init__(self, rank: int, size: int, device, axis: str = "data"):
        self.rank, self.size, self.axis = rank, size, axis
        self.device = torch.device(device)
        self.backend = dist.get_backend()

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend}, "
                f"axis={self.axis!r})")

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` the backend takes: on the host for
        gloo when ``t`` is a CUDA tensor."""
        t = t.detach()
        if self.backend == "gloo" and t.is_cuda:
            return t.to("cpu", copy=True).contiguous()
        return t.clone(memory_format=torch.contiguous_format)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        w = self._wire(t)
        dist.all_reduce(w, op)
        return w.to(t.device)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order (the
        shapes must agree)."""
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w)
        return torch.cat(parts, dim).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (a new tensor of ``t``'s shape
        and dtype)."""
        w = self._wire(t)
        dist.broadcast(w, src)
        return w.to(t.device)

    def barrier(self) -> None:
        dist.barrier()

    def broadcast_int(self, value: int, src: int = 0) -> int:
        """Rank ``src``'s Python int (int64) on every rank."""
        dev = self.device if self.backend == "nccl" else "cpu"
        return int(self.broadcast(torch.tensor([value], dtype=torch.int64,
                                               device=dev), src)[0])


def make_mesh(n: Optional[int] = None, axis: str = "data",
              device=None) -> Mesh:
    """The mesh of the initialised default process group. ``n`` (None = the
    group's size) must equal the group's size. ``device`` None means
    ``cuda:<LOCAL_RANK>`` (torchrun's; else the rank), made the current
    CUDA device."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: start the ranks with "
            "optimaltextures_tpu_torch.parallel.mesh.spawn, or run under "
            "torchrun")
    rank, size = dist.get_rank(), dist.get_world_size()
    if n is not None and n != size:
        raise ValueError(f"requested {n} devices, the process group has "
                         f"{size} ranks")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested but no CUDA device is "
                               "available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; use gloo for "
                         "ranks on the CPU")
    return Mesh(rank, size, device, axis)


def _rank_device(device, rank: int) -> torch.device:
    """spawn's per-rank device: None or "cuda" -> cuda:<rank>; "cuda:k" ->
    cuda:k for every rank; "cpu" -> the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank)
    return device


def _rank_main(rank: int, n: int, target: Callable, args: tuple, backend: str,
               device, store: str, result: str, timeout_s: float,
               threads: int, build_dir: str) -> None:
    from ..ops import cuda_build

    torch.set_num_threads(threads)
    cuda_build.set_build_dir(build_dir)
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=dev if backend == "nccl" else None)
    # a rank that raises leaves the group as it is: the others are ended by
    # spawn (their collectives would wait for it)
    out = target(make_mesh(n, device=dev), *args)
    if rank == 0:
        torch.save(out, result + ".tmp")
        os.replace(result + ".tmp", result)
    dist.destroy_process_group()


def spawn(target: Callable, n: int, *, backend: str = "nccl", device=None,
          args: tuple = (), deadline_s: float = 900.0):
    """Run ``target(mesh, *args)`` on ``n`` new processes, one rank each, and
    return rank 0's result (``torch.save``-able; tensors come back on the
    host).

    ``device``: None or "cuda" puts rank r on ``cuda:r``; "cuda:0" puts every
    rank on that card (gloo only: NCCL refuses two ranks on one GPU); "cpu"
    runs the ranks on the CPU. ``target`` is pickled by its import path (a
    module-level function) and so are ``args``.

    The ranks start with the ``spawn`` method (never ``fork``, which is unsafe
    once CUDA or threads run), each with this process's torch thread count
    and kernel build directory, and meet through a ``file://`` store in a
    fresh temporary directory. A rank that raises ends the others and its
    traceback is raised here (``torch.multiprocessing.ProcessRaisedException``);
    after ``deadline_s`` every rank is killed and TimeoutError is raised."""
    import torch.multiprocessing as mp

    from ..ops import cuda_build

    if n < 1:
        raise ValueError(f"spawn needs n >= 1, got {n}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl|gloo, got {backend!r}")
    tmp = tempfile.mkdtemp(prefix="optex_mesh_")
    result = os.path.join(tmp, "result.pt")
    ctx = mp.start_processes(
        _rank_main,
        args=(n, target, tuple(args), backend, device,
              os.path.join(tmp, "store"), result,
              min(GROUP_TIMEOUT_S, deadline_s), torch.get_num_threads(),
              cuda_build.BUILD_DIR),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + deadline_s
    try:
        # join() raises the first failed rank's error (after ending the rest)
        while not ctx.join(timeout=max(0.05, min(1.0, deadline -
                                                 time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n} ranks did not finish within "
                                   f"{deadline_s} s")
        return torch.load(result, map_location="cpu", weights_only=False)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
