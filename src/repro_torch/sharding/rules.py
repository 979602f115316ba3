"""The flat substrate's segment layout over a mesh of ranks.

Counterpart of the flat half of ``repro/sharding/rules.py`` (its
PartitionSpec half, the LLM round's model-parallel layout, is not ported).
The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` among ``("data",)``, ``("data", "model")`` and
``("pod", "data", "model")`` (``launch.mesh``), or None for one device.

The flat vectors x, x-hat and the momentum are cut into contiguous
segments of whole 128-element wire rows, one per rank of the flat axes,
enumerated data-major (``flat_segment_index``); each rank holds its
segment as a plain tensor. Rows are padded to a multiple of the segment
count (``flat_padded_len``), so every segment holds the same number of
rows, and the broadcast's counter-hash dither is keyed on the global row
(``flat_segment_index * local_rows``): the wire bits do not depend on the
mesh.
"""
from __future__ import annotations

from typing import Tuple

FLAT_AXIS = "data"  # the axis flat segments (and cohort members) shard over
FLAT_MODEL_AXIS = "model"  # second flat axis: shards the vector, not members


def _extents(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def flat_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the flat substrate shards over, segment-major:
    ("data",) for None or a 1-D mesh, ("data", "model") when the mesh has
    a model axis ("pod" is never a flat axis)."""
    if mesh is None:
        return (FLAT_AXIS,)
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in (FLAT_AXIS, FLAT_MODEL_AXIS) if a in names) \
        or (FLAT_AXIS,)


def mesh_extent_of(mesh, axis: str) -> int:
    """The extent of ``axis`` (1 for None or a mesh without it)."""
    if mesh is None:
        return 1
    return _extents(mesh).get(axis, 1)


def mesh_data_extent(mesh) -> int:
    """The extent of the "data" axis (1 for None or no such axis)."""
    return mesh_extent_of(mesh, FLAT_AXIS)


def mesh_model_extent(mesh) -> int:
    """The extent of the "model" axis (1 for None or no such axis)."""
    return mesh_extent_of(mesh, FLAT_MODEL_AXIS)


def mesh_flat_extent(mesh) -> int:
    """The number of flat segments: the product of the flat axes'
    extents (1 for None)."""
    extent = 1
    for a in flat_axes(mesh):
        extent *= mesh_extent_of(mesh, a)
    return extent


def flat_padded_len(n: int, ndev: int, bucket: int = 128) -> int:
    """The segment-aligned padded length of an n-element flat vector over
    ``ndev`` segments: rows of ``bucket`` elements, their count padded to
    a multiple of ``ndev``, so each segment is a whole number of rows."""
    rows = -(-n // bucket)
    rows_pad = -(-rows // ndev) * ndev
    return rows_pad * bucket


def flat_segment_index(mesh) -> int:
    """The global segment index of this rank: its coordinates on the flat
    axes folded data-major (0 for None). Times the segment's row count it
    is the global row that keys the broadcast's dither. Raises on a rank
    outside the mesh."""
    if mesh is None:
        return 0
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    at = dict(zip(mesh.mesh_dim_names, coord))
    idx = 0
    for a in flat_axes(mesh):
        idx = idx * mesh_extent_of(mesh, a) + int(at.get(a, 0))
    return idx
