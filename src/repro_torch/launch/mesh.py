"""The port's meshes, over an initialised ``torch.distributed`` group.

Counterpart of ``repro/launch/mesh.py``. The reference is one host
process driving a ``shard_map`` over its devices; the port is SPMD: each
rank is one process on one device, and every rank runs the same host
protocol from the same seeds. A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks ``0 .. size - 1``
of the default process group, with the reference's axis names: gloo's
ranks hold CPU tensors, NCCL's CUDA tensors (``mesh.device_type``). These
functions never start a group of their own: the caller runs
``torch.distributed.init_process_group`` (address, world size and rank
given explicitly) first, and a mesh larger than the group raises, naming
the world size it needs. A mesh on fewer ranks than the group is a
sub-mesh: every rank builds it (the groups are made collectively), and the
ranks outside it get ``mesh.get_coordinate() is None``.

Each mesh carries ``flat_group``, the process group of its flat segments
in segment order (``sharding.rules.flat_segment_index``), for the
collectives of the flat substrate, made here with the mesh.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.sharding.rules import FLAT_AXIS, FLAT_MODEL_AXIS


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group (backend, init_method, "
            "world_size, rank) first")
    return dist.get_world_size()


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], what: str):
    need = 1
    for s in shape:
        need *= int(s)
    world = _world()
    if need > world:
        raise ValueError(
            f"{what} needs {need} ranks but the process group has {world}: "
            f"start {need} processes (world_size={need})")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(need).reshape(tuple(int(s) for s in shape))
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=names)
    mesh.flat_group = _flat_group(ranks, names)
    return mesh


def _flat_group(ranks: torch.Tensor, names: Tuple[str, ...]):
    """The group of the ranks that share this rank's coordinates on the
    axes that are not flat, in segment order (data-major; one group a
    pod), made on every rank of the default group."""
    flat = [a for a in (FLAT_AXIS, FLAT_MODEL_AXIS) if a in names]
    other = [i for i, a in enumerate(names) if a not in flat]
    mine, me = None, dist.get_rank()
    for fixed in itertools.product(*(range(ranks.shape[i]) for i in other)):
        sub = ranks
        for i, v in sorted(zip(other, fixed), reverse=True):
            sub = sub.select(i, v)
        members = sub.reshape(-1).tolist()
        if members == list(range(dist.get_world_size())):
            group = dist.group.WORLD
        else:
            group = dist.new_group(members)
        if me in members:
            mine = group
    return mine


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes: 256 ranks as (data=16,
    model=16), or 512 as (pod=2, data=16, model=16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "make_production_mesh")


def make_host_mesh():
    """A (1, 1) ("data", "model") mesh on rank 0."""
    return _mesh((1, 1), ("data", "model"), "make_host_mesh")


def make_sim_mesh(n_dev: Optional[int] = None):
    """A 1-D ("data",) mesh for the flat substrate: the host protocol's
    server segments and cohort members both lie on "data". ``n_dev=None``
    takes every rank of the group."""
    if n_dev is None:
        n_dev = _world()
    return _mesh((int(n_dev),), ("data",), f"make_sim_mesh({n_dev})")


def make_sim_mesh2d(shape: Optional[Tuple[int, int]] = None):
    """A 2-D ("data", "model") mesh: the flat state segments over both
    axes, data-major; cohort members over "data". ``shape=None`` puts
    every rank on "data"."""
    if shape is None:
        shape = (_world(), 1)
    return _mesh(tuple(shape), ("data", "model"),
                 f"make_sim_mesh2d({tuple(shape)})")


def flat_group(mesh):
    """The mesh's flat-segment group (``make_sim_mesh`` and the others
    attach it)."""
    group = getattr(mesh, "flat_group", None)
    if group is None:
        raise ValueError("this rank has no flat group on the mesh: build "
                         "the mesh with launch.mesh and use it on its ranks")
    return group


def _all_gather(v: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(v) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, v.contiguous(), group=group)
    return torch.cat(parts)


def gather_segments(v: torch.Tensor, mesh) -> torch.Tensor:
    """Every segment's ``v`` (the same shape on each rank) concatenated
    along dim 0 in segment order: one all-gather over the flat group."""
    return _all_gather(v, flat_group(mesh))


def gather_members(v: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's ``v`` (one member slice each, the same shape)
    concatenated along dim 0 in data order: one all-gather over this
    rank's "data" group."""
    return _all_gather(v, mesh.get_group(FLAT_AXIS))
