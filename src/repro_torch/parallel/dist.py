"""The rank form of the collectives: one shard a ``torch.distributed`` rank.

The counterpart of the reference's ``shard_map`` over M devices.  Each rank
holds one shard of the mesh, its own, and the collectives of
:class:`~repro_torch.parallel.collectives.Shards` are ``torch.distributed``
calls over the process group of each mesh axis (``DeviceMesh.get_group``):

- ``all_gather``: ``dist.all_gather`` along each axis, the minor axis
  first, so the stack is in the row-major order of the list form;
- ``all_to_all``: ``dist.all_to_all_single`` over the ``[n, ...]``
  operand, block ``j`` to rank ``j``;
- ``ppermute_next``: an uneven ``all_to_all_single`` that sends the whole
  operand to rank ``i + 1`` only, so gloo (which has no ``send`` /
  ``recv`` for CUDA tensors) and NCCL take one code path;
- ``psum`` / ``pmean``: an all-gather, then the list form's sum or mean in
  shard order on every rank.  A ring all-reduce would add in another
  order; this way every rank holds the list form's bits.

A backend that cannot take a tensor on its device is staged in one place,
:meth:`RankShards._wire`: gloo takes host tensors, so a CUDA operand
crosses a gloo group through a pinned host buffer and comes back to its
device.  NCCL takes CUDA tensors only; anything else raises.  No shard's
compute leaves its device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..launch.mesh import Mesh
from .collectives import Shards


class RankShards(Shards):
    """This rank's shard of ``mesh``: ``coord`` its index along each axis,
    ``groups[axis]`` the process group of the ranks that differ from it
    only along ``axis``, ranked by their index there (None for an axis of
    one shard)."""

    def __init__(self, mesh: Mesh, groups: dict, coord: dict) -> None:
        self.mesh = mesh
        self.groups = dict(groups)
        self.coords = [dict(coord)]
        for a, n in mesh.shape.items():
            g = self.groups.get(a)
            if n > 1 and (g is None or dist.get_world_size(g) != n):
                raise ValueError(f"axis {a!r} of {n} shards needs a process "
                                 f"group of {n} ranks")

    @classmethod
    def from_device_mesh(cls, dm) -> "RankShards":
        names = tuple(dm.mesh_dim_names)
        mesh = Mesh(tuple(dm.mesh.shape), names)
        return cls(mesh, {a: dm.get_group(a) for a in names
                          if mesh.shape[a] > 1},
                   {a: dm.get_local_rank(a) for a in names})

    @classmethod
    def of_group(cls, group) -> "RankShards":
        """One axis, ``"group"``: the ranks of ``group``."""
        return cls(Mesh((dist.get_world_size(group),), ("group",)),
                   {"group": group}, {"group": dist.get_rank(group)})

    def _wire(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` as the process group of ``axis`` takes it (contiguous):
        as it is, or a CUDA tensor staged through a pinned host buffer for
        gloo.  Raises where the backend cannot take the device."""
        backend = str(dist.get_backend(self.groups[axis]))
        t = t.contiguous()
        if t.device.type == "cuda" and "nccl" in backend:
            return t
        if t.device.type == "cpu" and "gloo" in backend:
            return t
        if t.device.type == "cuda" and "gloo" in backend:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t)
        raise ValueError(f"a {backend} process group does not take "
                         f"{t.device.type} tensors")

    def _all_gather(self, xs, axes):
        (x,) = xs
        out = x
        for a in reversed(axes):            # the minor axis first
            n = self.mesh.shape[a]
            if n == 1:
                out = out[None]
                continue
            w = self._wire(out, a)
            parts = [torch.empty_like(w) for _ in range(n)]
            dist.all_gather(parts, w, group=self.groups[a])
            out = torch.stack(parts).to(x.device)
        return [out.reshape(-1, *x.shape)]

    def _all_to_all(self, xs, axis):
        (x,) = xs
        if not isinstance(x, torch.Tensor):
            x = torch.stack(list(x))
        if self.mesh.shape[axis] == 1:
            return [list(x.unbind(0))]
        w = self._wire(x, axis)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self.groups[axis])
        return [list(out.to(x.device).unbind(0))]

    def _ppermute_next(self, xs, axis):
        (x,) = xs
        n, i = self.mesh.shape[axis], self.coords[0][axis]
        if n == 1:
            return [torch.zeros_like(x)]
        w = self._wire(x, axis).reshape(1, -1)
        send, recv = [0] * n, [0] * n
        if i + 1 < n:
            send[i + 1] = 1
        if i > 0:
            recv[i - 1] = 1
        out = w.new_empty((sum(recv), w.shape[1]))
        dist.all_to_all_single(out, w[:sum(send)], recv, send,
                               group=self.groups[axis])
        if i == 0:
            return [torch.zeros_like(x)]
        return [out.reshape(x.shape).to(x.device)]
