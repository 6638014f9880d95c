"""Device-mesh helpers and the collectives the distributed paths share.

The JAX package names its mesh axes (``jax.sharding.Mesh``); the port uses
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names
(``"data"``, ``"model"``). ``mesh.shape[axis]`` becomes :func:`axis_size`,
``jax.lax.axis_index`` :func:`axis_rank`, and a collective over an axis runs
on ``mesh.get_group(axis)``. Arrays stay local tensors, so the kernels see
local shapes; a mesh axis missing from the mesh counts as size 1.

:func:`gather_units` and :func:`scatter_units` move the last (unit) axis:
gloo's ``reduce_scatter_tensor`` scatters along dim 0 only, so the unit axis
is moved to the front before it is scattered, and gathered at the front then
moved back.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def has_axis(mesh: Any, axis: str | None) -> bool:
    return axis is not None and axis in (mesh.mesh_dim_names or ())


def axis_size(mesh: Any, axis: str | None) -> int:
    """The number of ranks along ``axis`` (1 when the mesh has no such axis)."""
    return mesh.size(mesh.mesh_dim_names.index(axis)) if has_axis(mesh, axis) else 1


def axis_rank(mesh: Any, axis: str | None) -> int:
    """This rank's coordinate along ``axis`` (0 when the mesh has no such axis)."""
    return mesh.get_local_rank(axis) if has_axis(mesh, axis) else 0


def require_axis(mesh: Any, axis: str) -> None:
    if not has_axis(mesh, axis):
        raise ValueError(f"The mesh has no axis {axis!r}; its axes are {mesh.mesh_dim_names}")


def all_reduce(t: torch.Tensor, mesh: Any, axis: str | None,
               op: Any = dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` in place over ``axis`` (a no-op when the mesh has no such
    axis)."""
    if has_axis(mesh, axis):
        dist.all_reduce(t, op=op, group=mesh.get_group(axis))
    return t


def all_reduce_flat(ts: list[torch.Tensor], mesh: Any, axis: str | None) -> None:
    """Sum a list of tensors of one type in place over ``axis`` with one
    collective on their concatenation."""
    if not has_axis(mesh, axis) or not ts:
        return
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=mesh.get_group(axis))
    for t, part in zip(ts, flat.split([t.numel() for t in ts])):
        t.copy_(part.view_as(t))


def gather_rows(t: torch.Tensor, mesh: Any, axis: str | None, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` in rank order over ``axis``."""
    if not has_axis(mesh, axis):
        return t
    n = axis_size(mesh, axis)
    moved = t.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0], *moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def gather_units(t: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    """(..., K/n) on each rank -> (..., K): the ranks' unit shards side by
    side along the last axis, in rank order."""
    return gather_rows(t, mesh, axis, dim=t.dim() - 1)


def scatter_units(t: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    """(..., K) on each rank -> (..., K/n): the sum over the ranks of their
    ``t``, this rank's unit shard of it (the transpose of :func:`gather_units`)."""
    if not has_axis(mesh, axis):
        return t
    n = axis_size(mesh, axis)
    front = t.movedim(-1, 0).contiguous()  # gloo scatters dim 0 only
    out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
    dist.reduce_scatter_tensor(out, front, group=mesh.get_group(axis))
    return out.movedim(0, -1)


def local_rows(x: Any, mesh: Any, axis: str | None) -> Any:
    """This rank's contiguous block of the leading axis of ``x`` over ``axis``
    (a view, for a tensor or an array)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide over {n} ranks of axis {axis!r}")
    r = axis_rank(mesh, axis)
    m = x.shape[0] // n
    return x[r * m : (r + 1) * m]


def check_mesh(mesh: Any) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, found {type(mesh).__name__}")


def mesh_device(mesh: Any) -> torch.device:
    """The device this rank's tensors live on: its current card on a CUDA
    mesh, the CPU on a CPU mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def tree_map(fn: Any, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples (with the
    same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)
