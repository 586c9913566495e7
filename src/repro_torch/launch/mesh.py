"""Device meshes for multi-device coadd jobs, on ``torch.distributed``.

Counterpart of ``repro.launch.mesh.make_smoke_mesh``.  A JAX mesh is one
controller's view of many devices; here every rank of a process group is
one program (SPMD), and `make_mesh` gives each rank the same named
`DeviceMesh` over the group: rank ``r`` sits at the row-major coordinate of
``r`` in ``shape``.

A job starts its ranks in one of two ways:

* `run_ranks` (tests, ``chip_smoke.py``, one host): ``world`` processes
  through ``torch.multiprocessing`` with the spawn start method, meeting
  through a ``file://`` store in a directory the caller gives;
* ``torchrun --nproc-per-node=N script.py`` with one rank per card: the
  script calls `make_mesh`, which joins the group from the environment
  torchrun sets (``env://``), and builds its engine on
  ``cuda:<LOCAL_RANK>``.

The backend is always an explicit choice: NCCL for ``cuda`` and gloo for
``cpu`` unless the caller names one (gloo also reduces CUDA tensors, which
lets several ranks share one card, which NCCL refuses).
"""

from __future__ import annotations

import datetime
import os
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

DEFAULT_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda",
              backend: Optional[str] = None):
    """A `DeviceMesh` of ``shape`` with ``mesh_dim_names`` ``axes`` over
    this process group (rank r at the row-major coordinate of r).

    Joins the default group from the environment (``env://``, as torchrun
    sets it) when it is not initialized yet, with ``backend`` (by default
    NCCL for ``cuda``, gloo for ``cpu``); an initialized group must already
    use that backend.  The world size must be the product of ``shape``.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    backend = backend or DEFAULT_BACKEND[device_type]
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group uses {dist.get_backend()}, not {backend}")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} ranks, the group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=axes)


def _rank_main(rank: int, world: int, backend: str, init_method: str, timeout_s: float,
               fn: Callable, args: tuple, results) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, store_dir: str, backend: str, args: tuple = (),
              timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned processes -> the
    ranks' return values, by rank.

    Each process joins a ``backend`` group through a ``file://`` store in
    ``store_dir`` (which must exist; the store file must not), runs ``fn``
    and leaves the group; ``fn`` and ``args`` must pickle (a module-level
    function).  Raises with the rank's traceback if a rank fails, and
    terminates every rank still running after ``timeout_s`` (also the
    group's collective timeout).  The caller's own process group, if any,
    is untouched.
    """
    import queue

    import torch.multiprocessing as mp

    store = os.path.join(os.path.abspath(store_dir), "store")
    if os.path.exists(store):
        raise FileExistsError(f"{store} exists: a store serves one group")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, f"file://{store}", timeout_s, fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    quiet = 0
    try:
        while len(out) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # A rank that exits puts its result first, so a dead rank
                # with nothing queued over two polls died without one.
                dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive()]
                quiet = quiet + 1 if dead else 0
                if quiet >= 2:
                    failure = f"ranks {dead} died without a result"
                elif time.monotonic() > deadline:
                    failure = f"ranks timed out after {timeout_s} s"
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=0.1 if failure else 10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]
