"""The device mesh: one process per device on ``torch.distributed`` (the
counterpart of ``optimaltextures_tpu/parallel/mesh.py`` and of the grid
mesh of ``parallel/grid.py``).

A :class:`Mesh` is the 1-D view of a process group (the default one, or a
subgroup) that the sharded code needs: this rank's index in it, its size,
this rank's device and the axis name. A :class:`GridMesh`
(:func:`make_grid_mesh`) is the whole group seen as a (data x space) grid,
with a :class:`Mesh` over its row and one over its column. The meshes'
:meth:`~Mesh.psum`, :meth:`~Mesh.pmin`, :meth:`~Mesh.pmax`,
:meth:`~Mesh.all_gather`, :meth:`~Mesh.broadcast` and
:meth:`~Mesh.halo_rows` (the halo rows of an H-sharded image) are the only
place the port calls a collective. NCCL takes CUDA tensors as they
are. gloo, the CPU tests' backend, takes host tensors: a CUDA tensor is
copied to the host and back, explicitly, in those helpers (gloo takes CUDA
tensors for only some collectives, and NCCL refuses two ranks on one GPU,
so gloo is how two ranks share one card). The backend is the caller's
choice; nothing falls back from one to the other.

Ranks come from :func:`spawn` (``spawn`` start method, a ``file://``
rendezvous in a fresh temporary directory, a group timeout and a deadline),
from a :class:`RankGroup` (the same start, but the ranks stay and run job
after job: the server's multi-device requests) or from ``torchrun``, under
which :func:`make_mesh` takes the group that is already there."""

from __future__ import annotations

import datetime
import io
import os
import shutil
import tempfile
import threading
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

# a collective that waits longer than this raises (gloo; NCCL's watchdog)
GROUP_TIMEOUT_S = 600.0


class Mesh:
    """A process group (``group``; None: the default one) as a 1-D mesh
    over ``axis``; ``rank`` is this process's index in the group."""

    grid = False

    def __init__(self, rank: int, size: int, device, axis: str = "data",
                 group=None):
        self.rank, self.size, self.axis = rank, size, axis
        self.device = torch.device(device)
        self.group = group
        self.backend = dist.get_backend(group)

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend}, "
                f"axis={self.axis!r})")

    def with_axis(self, axis: str) -> "Mesh":
        """The same group under another axis name."""
        return Mesh(self.rank, self.size, self.device, axis, self.group)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` the backend takes: on the host for
        gloo when ``t`` is a CUDA tensor."""
        t = t.detach()
        if self.backend == "gloo" and t.is_cuda:
            return t.to("cpu", copy=True).contiguous()
        return t.clone(memory_format=torch.contiguous_format)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        w = self._wire(t)
        dist.all_reduce(w, op, group=self.group)
        return w.to(t.device)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def _gather_parts(self, t: torch.Tensor) -> list:
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return parts

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order (the
        shapes must agree)."""
        return torch.cat(self._gather_parts(t), dim).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (a new tensor of ``t``'s shape
        and dtype); ``src`` is a rank of this mesh."""
        w = self._wire(t)
        dist.broadcast(w, group=self.group, group_src=src)
        return w.to(t.device)

    def halo_rows(self, x: torch.Tensor, r: int, mode: str = "reflect"):
        """The halo of this rank's rows of an image sharded along H (dim 1)
        in rank order: ``(top, bottom)``, the last ``r`` rows of the rank
        above and the first ``r`` of the rank below, each (B, r, W, C).
        ``mode="reflect"``: the image ends at rank 0's top and rank n-1's
        bottom, where the halo is None; ``"wrap"``: the ranks form a ring
        (tileable), rank 0's top being rank n-1's last rows. One all_gather
        of every rank's first and last ``r`` rows (4 r rows a rank for the
        ring's two neighbours), from which each rank takes its neighbours'."""
        if mode not in ("reflect", "wrap"):
            raise ValueError(f"halo mode must be reflect|wrap, got {mode!r}")
        if not 0 < r <= x.shape[1]:
            raise ValueError(f"a halo of {r} rows from a shard of "
                             f"{x.shape[1]}")
        parts = self._gather_parts(torch.cat([x[:, :r], x[:, -r:]], 1))
        ring = mode == "wrap"
        top = bottom = None
        if ring or self.rank > 0:
            top = parts[(self.rank - 1) % self.size][:, r:].to(x.device)
        if ring or self.rank < self.size - 1:
            bottom = parts[(self.rank + 1) % self.size][:, :r].to(x.device)
        return top, bottom

    def halo_pad(self, x: torch.Tensor, r: int, mode: str = "reflect"):
        """``x`` with :meth:`halo_rows` above and below: (the taller tensor,
        the rows added on top, the rows added below)."""
        top, bottom = self.halo_rows(x, r, mode)
        rows = [t for t in (top, x, bottom) if t is not None]
        return (torch.cat(rows, 1), 0 if top is None else r,
                0 if bottom is None else r)

    def barrier(self) -> None:
        dist.barrier(group=self.group)

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


class GridMesh(Mesh):
    """The whole process group as an (n_data x n_space) grid: rank
    ``d * n_space + s`` is at (d, s), as the JAX package's
    ``devices.reshape(n_data, n_space)``. Its own collectives span the whole
    group (the Gram, cdf's range and counts); :attr:`space` is the
    :class:`Mesh` over this rank's row (axis "space": its image rows, the
    halos and per-image means) and :attr:`data` the one over its column
    (axis "data": the batch)."""

    grid = True

    def __init__(self, rank: int, device, data: Mesh, space: Mesh):
        super().__init__(rank, data.size * space.size, device,
                         ("data", "space"))
        self.data, self.space = data, space

    def __repr__(self):
        return (f"GridMesh(rank={self.rank}, data={self.data.size} x "
                f"space={self.space.size}, device={self.device}, "
                f"backend={self.backend})")


_GRIDS = {}


def make_grid_mesh(n_data: int, n_space: int, device=None) -> GridMesh:
    """The default group as an (n_data x n_space) :class:`GridMesh`; its
    size must be n_data * n_space. Every rank builds every row's and every
    column's subgroup, in the same order (NCCL hangs otherwise). A group's
    grids are built once and kept: a subgroup is never freed (an NCCL one
    holds device buffers), so Synthesizers built one after another share
    them."""
    whole = make_mesh(n_data * n_space, device=device)
    key = (id(dist.group.WORLD), n_data, n_space, str(whole.device))
    if key not in _GRIDS:
        rows = [dist.new_group([d * n_space + s for s in range(n_space)])
                for d in range(n_data)]
        cols = [dist.new_group([d * n_space + s for d in range(n_data)])
                for s in range(n_space)]
        d, s = divmod(whole.rank, n_space)
        _GRIDS[key] = GridMesh(
            whole.rank, whole.device,
            Mesh(d, n_data, whole.device, "data", cols[s]),
            Mesh(s, n_space, whole.device, "space", rows[d]))
    return _GRIDS[key]


def _rank_device(device, rank: int) -> torch.device:
    """spawn's per-rank device: None or "cuda" -> cuda:<rank>; "cuda:k" ->
    cuda:k for every rank; "cpu" -> the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank)
    return device


def _rank_setup(rank: int, n: int, backend: str, device, store: str,
                timeout_s: float, threads: int, build_dir: str) -> Mesh:
    """A new rank process's start: the parent's thread count and kernel
    build directory, its device, the process group; its mesh."""
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
    return make_mesh(n, device=dev)


def _rank_main(rank: int, n: int, target: Callable, args: tuple, backend: str,
               device, store: str, result: str, timeout_s: float,
               threads: int, build_dir: str) -> None:
    mesh = _rank_setup(rank, n, backend, device, store, timeout_s, threads,
                       build_dir)
    # a rank that raises leaves the group as it is: the others are ended by
    # spawn (their collectives would wait for it)
    out = target(mesh, *args)
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


def _send(conn, obj) -> None:
    """``obj`` through a pipe, pickled by ``torch.save`` (tensors by value)."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    conn.send_bytes(buf.getvalue())


def _recv(conn):
    return torch.load(io.BytesIO(conn.recv_bytes()), map_location="cpu",
                      weights_only=False)


def _group_rank_main(rank: int, n: int, backend: str, device, store: str,
                     timeout_s: float, threads: int, build_dir: str,
                     conn) -> None:
    """A :class:`RankGroup` rank: set up once, then run every job that comes
    through ``conn`` until ``None`` or the pipe's end."""
    mesh = _rank_setup(rank, n, backend, device, store, timeout_s, threads,
                       build_dir)
    _send(conn, ("ready", os.getpid()))
    while True:
        try:
            job = _recv(conn)
        except EOFError:      # the parent is gone
            break
        if job is None:
            break
        target, args = job
        try:
            reply = ("ok", target(mesh, *args))
        except Exception as e:
            # the parent ends every rank: the others may wait in a
            # collective for this one
            reply = ("error", type(e).__name__, str(e),
                     traceback.format_exc())
        _send(conn, reply)
    dist.destroy_process_group()


class RankFailed(RuntimeError):
    """A rank of a :class:`RankGroup` raised (``type_name`` is its
    exception's type, ``message`` its text, ``trace`` its traceback) or its
    process ended (``type_name`` "ProcessExited")."""

    def __init__(self, rank: int, type_name: str, message: str,
                 trace: str = ""):
        super().__init__(f"rank {rank}: {type_name}: {message}")
        self.rank, self.type_name, self.message = rank, type_name, message
        self.trace = trace


class RankGroup:
    """The persistent counterpart of :func:`spawn`: ``len(devices)``
    processes, rank r on ``devices[r]``, joined in one process group once
    and then running job after job (:meth:`run`), each keeping what it
    built (a server's warm pools) from one job to the next.

    The ranks start as :func:`spawn`'s do (the ``spawn`` method, this
    process's torch thread count and kernel build directory, a ``file://``
    store in a fresh temporary directory, :data:`GROUP_TIMEOUT_S`); the
    constructor returns when every rank has joined the group. The backend
    is the caller's choice: nothing falls back from NCCL to gloo or from
    the card to the CPU. Jobs and results pass by ``torch.save`` (tensors
    come back on the host).

    A rank that raises, a rank process that ends and a missed deadline
    each kill EVERY process of the group (the others may sit in a
    collective) and raise here: :class:`RankFailed`, or TimeoutError. A
    group that has failed is never used again (:attr:`alive` is False). A
    rank whose pipe ends (this process died) leaves the group and exits."""

    def __init__(self, devices: Sequence, backend: str = "nccl"):
        import multiprocessing as mp

        from ..ops import cuda_build

        if not devices:
            raise ValueError("a rank group needs at least one device")
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be nccl|gloo, got {backend!r}")
        self._lock = threading.Lock()
        self._tmp = tempfile.mkdtemp(prefix="optex_group_")
        ctx = mp.get_context("spawn")
        n = len(devices)
        self._conns, self._procs = [], []
        for rank, dev in enumerate(devices):
            ours, theirs = ctx.Pipe()
            # daemonic: ended at this interpreter's exit
            p = ctx.Process(target=_group_rank_main, daemon=True, args=(
                rank, n, backend, str(dev), os.path.join(self._tmp, "store"),
                GROUP_TIMEOUT_S, torch.get_num_threads(), cuda_build.BUILD_DIR,
                theirs))
            p.start()
            theirs.close()
            self._conns.append(ours)
            self._procs.append(p)
        self._ok = True
        self._collect(GROUP_TIMEOUT_S, "start")

    @property
    def pids(self) -> list:
        return [p.pid for p in self._procs]

    @property
    def alive(self) -> bool:
        """True until the group fails or closes, while every rank runs."""
        return self._ok and all(p.is_alive() for p in self._procs)

    def run(self, target: Callable, *args, deadline_s: float = 900.0) -> list:
        """``target(mesh, *args)`` on every rank (``target`` a module-level
        function, pickled by name); the list of every rank's result, in rank
        order. One job at a time: a second caller waits."""
        with self._lock:
            if not self.alive:
                raise RuntimeError("this rank group has failed or closed")
            for rank, conn in enumerate(self._conns):
                try:
                    _send(conn, (target, args))
                except OSError as e:   # the rank's end of the pipe is gone
                    self._kill()
                    raise RankFailed(rank, "ProcessExited",
                                     f"could not send the job: {e}") from e
            return self._collect(deadline_s, "job")

    def _collect(self, deadline_s: float, what: str) -> list:
        """Every rank's reply, or the group killed and an exception."""
        from multiprocessing.connection import wait

        deadline = time.monotonic() + deadline_s
        results = [None] * len(self._conns)
        pending = {c: r for r, c in enumerate(self._conns)}
        while pending:
            left = deadline - time.monotonic()
            ready = wait(list(pending), timeout=max(0.0, left))
            if not ready and left <= 0:
                self._kill()
                raise TimeoutError(f"{len(pending)} of {len(self._conns)} "
                                   f"ranks did not finish the {what} within "
                                   f"{deadline_s} s")
            for conn in ready:
                rank = pending.pop(conn)
                try:
                    reply = _recv(conn)
                except (EOFError, OSError):   # the rank's end is gone
                    self._kill()
                    code = self._procs[rank].exitcode
                    raise RankFailed(rank, "ProcessExited",
                                     f"rank {rank}'s process (pid "
                                     f"{self._procs[rank].pid}) ended, exit "
                                     f"code {code}") from None
                if reply[0] == "error":
                    self._kill()
                    raise RankFailed(rank, *reply[1:])
                results[rank] = reply[1]
        return results

    def _kill(self) -> None:
        self._ok = False
        for p in self._procs:
            if p.is_alive():
                p.kill()
        self._reap()

    def _reap(self) -> None:
        for p in self._procs:
            p.join(10)
        for c in self._conns:
            c.close()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def close(self) -> None:
        """End the ranks: ``None`` to each (they leave the group and exit),
        a short wait, then kill whatever is left. Safe to call twice."""
        with self._lock:
            if self._ok:
                self._ok = False
                for c in self._conns:
                    try:
                        _send(c, None)
                    except OSError:
                        pass
                deadline = time.monotonic() + 10.0
                for p in self._procs:
                    p.join(max(0.0, deadline - time.monotonic()))
            for p in self._procs:
                if p.is_alive():
                    p.kill()
            self._reap()
