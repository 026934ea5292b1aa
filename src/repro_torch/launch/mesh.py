"""Device meshes: named axes and their sizes.

The JAX package builds ``jax.sharding.Mesh`` objects over real devices.
Here a :class:`Mesh` only *describes* a mesh — axis names and sizes, as
``jax.sharding.Mesh`` reports them (``.shape`` a name → size mapping,
``.axis_names`` a tuple) — so that the sharding rules
(:mod:`repro_torch.parallel.sharding`) and the list-of-shards forms of the
parallel layers (:mod:`repro_torch.parallel`) can read it without touching
a device.  :meth:`Mesh.device_mesh` builds the ``torch.distributed``
``DeviceMesh`` of the same shape once a process group is up, and with it
the parallel layers run their rank form, one shard a rank
(:mod:`repro_torch.parallel.dist`).  :func:`init_ranks` joins a process to
such a group, :func:`run_ranks` spawns the ranks of one.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import pickle
import queue
import time
import traceback
from typing import Callable


class Mesh:
    """Axis names and sizes of a device mesh; allocates nothing."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        if any(n < 1 for n in shape):
            raise ValueError(f"mesh sizes must be positive: {shape}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def device_mesh(self, device_type: str | None = None):
        """The ``torch.distributed`` ``DeviceMesh`` of this shape, its dims
        named after the axes.  Needs an initialised default process group
        of ``self.size`` ranks.  ``device_type`` defaults to that of the
        tensors the default group's backend takes: ``"cuda"`` for NCCL,
        ``"cpu"`` for gloo.  On one card the default group must be gloo and
        the mesh ``"cpu"``, since a ``"cuda"`` mesh opens NCCL subgroups,
        which refuse several ranks on one device."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        if device_type is None:
            device_type = ("cuda" if "nccl" in str(dist.get_backend())
                           else "cpu")
        return init_device_mesh(device_type, tuple(self.shape.values()),
                                mesh_dim_names=self.axis_names)


#: A rank waiting longer than this in a collective raises.
COLLECTIVE_TIMEOUT_S = 300.0


def init_ranks(mesh: Mesh, rank: int, store_path: str,
               backend: str = "gloo"):
    """Join this process, as ``rank``, to a default process group of
    ``mesh.size`` ranks that meet at the file ``store_path`` (a
    ``FileStore``: no port), and return ``mesh``'s ``DeviceMesh`` over it."""
    import torch.distributed as dist

    dist.init_process_group(
        backend, store=dist.FileStore(store_path, mesh.size), rank=rank,
        world_size=mesh.size,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return mesh.device_mesh()


def _rank_main(results, fn: Callable, rank: int, args: tuple) -> None:
    try:
        # pickled here, by value: the queue's own pickler would share a
        # tensor's storage with the parent through this process, which
        # exits before the parent reads it
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, timeout_s: float) -> list:
    """``[fn(rank, *args) for rank in range(world)]``, each call in a
    process of its own (``spawn``; ``fn`` and its arguments and results
    are pickled).  A rank that raises, dies or has not returned within
    ``timeout_s`` seconds fails the run with a ``RuntimeError`` (the
    rank's traceback): every process is then killed, so no rank left
    waiting in a collective can hang the caller."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(results, fn, r, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    deadline, died = time.monotonic() + timeout_s, None
    try:
        while len(got) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                now = time.monotonic()
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                died = (died or now) if dead else None
                if dead and now - died > 2.0:     # its traceback never came
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}") from None
                if now > deadline:
                    missing = sorted(set(range(world)) - set(got))
                    raise RuntimeError(f"ranks {missing} gave no result in "
                                       f"{timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(world)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single-pod (256 chips) or 2×16×16 multi-pod (512 chips)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Any mesh (elastic re-mesh path, tests)."""
    return Mesh(shape, axes)
