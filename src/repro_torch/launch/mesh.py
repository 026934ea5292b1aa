"""Device meshes: named axes and their sizes.

The JAX package builds ``jax.sharding.Mesh`` objects over real devices.
Here a :class:`Mesh` only *describes* a mesh — axis names and sizes, as
``jax.sharding.Mesh`` reports them (``.shape`` a name → size mapping,
``.axis_names`` a tuple) — so that the sharding rules
(:mod:`repro_torch.parallel.sharding`) and the list-of-shards forms of the
parallel layers (:mod:`repro_torch.parallel`) can read it without touching
a device.  :meth:`Mesh.device_mesh` builds the ``torch.distributed``
``DeviceMesh`` of the same shape once a process group is up.
"""
from __future__ import annotations

import math


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

    def device_mesh(self, device_type: str = "cuda"):
        """The ``torch.distributed`` ``DeviceMesh`` of this shape, its dims
        named after the axes.  Needs an initialised default process group
        of ``self.size`` ranks."""
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, tuple(self.shape.values()),
                                mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single-pod (256 chips) or 2×16×16 multi-pod (512 chips)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Any mesh (elastic re-mesh path, tests)."""
    return Mesh(shape, axes)
