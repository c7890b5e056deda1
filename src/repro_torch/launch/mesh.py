"""Meshes of ranks (port of ``repro/launch/mesh.py``).

The reference's mesh is a grid of TPU devices that GSPMD partitions one
program over.  Here a mesh is a grid of *processes*, one per rank, each
running the rank-local program (``runtime/sharding.shard_model``) and
meeting the others in the collectives of ``runtime/collectives.py``.  A
:class:`Mesh` is one rank's view of that grid: the axis names and sizes
(``mesh.shape`` reads like the reference's), this rank's coordinate on
each axis, one ``torch.distributed`` process group per axis through this
rank, and the collectives over them.

The backend follows the device count, chosen once at start and printed
(:func:`choose_backend`): NCCL when every rank has a card of its own, gloo
when ranks share one card or run on the CPU.  gloo moves a card's tensors
through the host.  :func:`run_ranks` starts the ranks of a mesh from one
Python call (no ``torchrun``): ``spawn`` processes that meet at a
``tcp://127.0.0.1`` address.

The mesh constructors are functions, so importing this module starts
nothing.
"""
from __future__ import annotations

import datetime
import itertools
import math
import multiprocessing
import queue
import socket
import time
import traceback
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..runtime.collectives import Collectives


@dataclass(eq=False)
class Mesh:
    """One rank's view of a mesh of ranks.

    ``backend`` is ``"nccl"`` or ``"gloo"`` for a mesh of processes, ``None``
    for one rank (no collective is ever issued), ``"meta"`` for a rank of
    a mesh traced on the meta device (the dry-run: collectives are recorded
    and nothing is sent).
    """

    axis_names: tuple[str, ...]
    dims: tuple[int, ...]
    coords: tuple[int, ...]
    device: torch.device
    backend: str | None = None
    groups: dict = field(default_factory=dict)
    comm: Collectives = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims) or len(self.coords) != len(self.dims):
            raise ValueError(f"axes {self.axis_names}, shape {self.dims} and coordinates "
                             f"{self.coords} disagree")
        if self.comm is None:
            route = "meta" if self.backend == "meta" else "dist"
            self.comm = Collectives(self.shape, self.groups, route,
                                    stage=self.backend == "gloo" and self.device.type == "cuda",
                                    index=dict(zip(self.axis_names, self.coords)))

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def rank(self) -> int:
        """This rank's index in the row-major order of the grid."""
        return _ravel(self.coords, self.dims)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[self.axis_names.index(axis)]


def _ravel(coords, dims) -> int:
    r = 0
    for c, n in zip(coords, dims):
        r = r * n + c
    return r


def _unravel(rank: int, dims) -> tuple[int, ...]:
    out = []
    for n in reversed(dims):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def choose_backend(n_ranks: int, device: str | torch.device) -> tuple[str, str]:
    """(backend, why) for ``n_ranks`` processes on ``device``: NCCL when each
    rank gets a card of its own, else gloo (NCCL takes no two ranks on one
    card, and none on the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", f"{n_ranks} ranks on the CPU"
    cards = torch.cuda.device_count()
    if cards >= n_ranks:
        return "nccl", f"{n_ranks} ranks on {n_ranks} of {cards} cards, one card each"
    return "gloo", (f"{n_ranks} ranks sharing {dev} ({cards} card(s)); the collectives go "
                    "through the host")


def rank_device(backend: str, device: str | torch.device, rank: int) -> torch.device:
    """The device of ``rank``: its own card under NCCL, ``device`` itself
    otherwise (every rank on one card, or on the CPU)."""
    dev = torch.device(device)
    if backend == "nccl":
        return torch.device("cuda", rank)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str | torch.device | None = None, *, meta: bool = False,
              coords: tuple[int, ...] | None = None) -> Mesh:
    """This process's :class:`Mesh` of ``shape`` over ``axes``.

    One rank (every size 1) needs no process group.  More ranks need
    ``torch.distributed`` initialised with ``prod(shape)`` ranks (as
    :func:`run_ranks` does): rank ``r`` sits at the row-major coordinates
    of ``r``, as the reference's devices fill ``jax.make_mesh``, and every
    rank builds every axis's groups in the same order.  ``meta=True`` gives
    the view of the rank at ``coords`` (default: the first) without
    processes: its collectives are recorded, not sent (the dry-run).
    """
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} disagree")
    n = math.prod(shape)
    if meta:
        return Mesh(axes, shape, tuple(coords or (0,) * len(shape)), torch.device("meta"),
                    "meta")
    if n == 1:
        dev = resolve_device(device or "cuda")
        return Mesh(axes, shape, (0,) * len(shape), dev, None)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs torch.distributed initialised with {n} "
                           "ranks (launch.mesh.run_ranks starts them)")
    rank = dist.get_rank()
    me = _unravel(rank, shape)
    groups = {}
    for i, axis in enumerate(axes):
        others = [range(d) for j, d in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            members = []
            for c in range(shape[i]):
                full = list(rest)
                full.insert(i, c)
                members.append(_ravel(full, shape))
            group = dist.new_group(members) if shape[i] > 1 else None
            if rank in members:
                groups[axis] = group
    backend = dist.get_backend()
    dev = resolve_device(device or "cuda")
    return Mesh(axes, shape, me, dev, backend, groups)


def single_device_mesh(axes: tuple[str, ...] = ("data", "model"),
                       device: str | torch.device | None = None) -> Mesh:
    return make_mesh((1,) * len(axes), axes, device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None) -> Mesh:
    """The reference's production mesh: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model); 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_pipeline_mesh(n_stages: int, n_data: int,
                       device: str | torch.device | None = None) -> Mesh:
    """Mesh for the merged-pipeline runtime: (stage, data)."""
    return make_mesh((n_stages, n_data), ("stage", "data"), device)


# ------------------------------------------------------------------ ranks

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, backend, device, shape, axes, fn, args, threads, timeout_s,
               results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_mesh(shape, axes, dev)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, shape: tuple[int, ...], axes: tuple[str, ...], *args,
              device: str | torch.device = "cuda", threads: int | None = 1,
              timeout: float = 900.0, verbose: bool = True) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh over
    ``axes``, each rank a process of its own, and return the ranks' results
    in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and so is
    each result: return host tensors or plain values.  The backend is
    :func:`choose_backend`'s, printed once with ``verbose``; ``threads``
    sets each rank's ``torch.set_num_threads``.  A rank that raises makes
    the call raise with its traceback, once every rank has ended or
    ``timeout`` seconds have passed; every process started here is ended
    before the call returns.
    """
    n = math.prod(shape)
    dev = resolve_device(device)
    backend, why = choose_backend(n, dev)
    if verbose:
        print(f"mesh {tuple(shape)} over {tuple(axes)}: backend {backend} ({why})", flush=True)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, backend, str(dev), tuple(shape), tuple(axes), fn,
                               args, threads, timeout, results))
             for r in range(n)]
    for p in procs:     # spawn hands each child this process's sys.path
        p.start()
    done: dict[int, tuple[bool, object]] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < n and time.monotonic() < deadline:
            try:
                rank, ok, out = results.get(timeout=1.0)
                done[rank] = (ok, out)
                if not ok:   # the others may wait in a collective for it: a short grace
                    deadline = min(deadline, time.monotonic() + 10.0)
            except queue.Empty:
                if all(not p.is_alive() for p in procs) and results.empty():
                    break
    finally:
        for p in procs:
            p.join(timeout=5.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    failed = {r: out for r, (ok, out) in done.items() if not ok}
    missing = [r for r in range(n) if r not in done]
    if failed or missing:
        detail = "\n".join(f"rank {r}:\n{tb}" for r, tb in sorted(failed.items()))
        raise RuntimeError(f"mesh {tuple(shape)}: ranks {sorted(failed)} failed, ranks "
                           f"{missing} ended without a result\n{detail}")
    return [done[r][1] for r in range(n)]
