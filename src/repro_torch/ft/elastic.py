"""Elastic scaling: re-plan the mesh when hosts join/leave.

Given the surviving host set, pick the largest usable (data, model) shape
(model axis preserved when possible — changing it would invalidate TP
sharding everywhere; dropping data-parallel rows only changes the
per-replica batch), emit the parameter-movement plan, and let the caller
restore from the last checkpoint with the new shardings
(``CheckpointManager.restore(..., shardings=new)`` reshards transparently).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ElasticPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    dropped_hosts: tuple[str, ...]
    chips_idle: int
    notes: str = ""


def plan_mesh_shape(
    n_chips_alive: int,
    model_axis: int = 16,
    pod_axis: int | None = None,
) -> tuple[int, ...]:
    """Largest (data, model) [or (pod, data, model)] mesh ≤ alive chips.

    The model axis is held fixed (TP degree is baked into layer sharding);
    data-parallel rows are dropped to fit.  Returns the new shape."""
    if pod_axis:
        per_pod = n_chips_alive // pod_axis
        data = per_pod // model_axis
        if data < 1:
            raise ValueError("not enough chips for one data row per pod")
        return (pod_axis, data, model_axis)
    data = n_chips_alive // model_axis
    if data < 1:
        raise ValueError("not enough chips for one data row")
    return (data, model_axis)


def reshard_plan(
    old_shape: tuple[int, ...],
    alive_hosts: list[str],
    all_hosts: list[str],
    chips_per_host: int,
    axis_names: tuple[str, ...] = ("data", "model"),
    model_axis: int = 16,
) -> ElasticPlan:
    dead = tuple(sorted(set(all_hosts) - set(alive_hosts)))
    n_alive_chips = len(alive_hosts) * chips_per_host
    pod_axis = old_shape[0] if len(old_shape) == 3 else None
    new_shape = plan_mesh_shape(n_alive_chips, model_axis=model_axis,
                                pod_axis=pod_axis)
    used = 1
    for s in new_shape:
        used *= s
    return ElasticPlan(
        old_shape=old_shape,
        new_shape=new_shape,
        axis_names=axis_names if pod_axis is None else ("pod",) + axis_names[-2:],
        dropped_hosts=dead,
        chips_idle=n_alive_chips - used,
        notes=(
            f"data axis {old_shape[-2]}→{new_shape[-2]}; per-replica batch "
            f"grows by {old_shape[-2] / new_shape[-2]:.2f}×; restore latest "
            f"checkpoint with new shardings"
        ),
    )
