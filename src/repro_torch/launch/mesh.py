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

**The tensor-parallel collectives** (``TensorParallel``): the dense
decoder on this rank's shards (``models``) meets the other ranks of its
"model" group only through these, each an explicit collective on the
mesh's group for that axis, with its gradient rule (Megatron's pairs):
``copy_to_model`` (identity; its backward sums over "model"),
``reduce_from_model`` (the sum of a row-parallel output; backward the
identity), ``gather_from_model`` (the all-gather a split head needs;
backward the slice), ``split_to_model`` (this rank's slice; backward the
all-gather) and ``all_reduce_model`` (a sum or max that carries no
gradient, for the sharded loss); ``copy_to_data`` / ``reduce_from_data``
do the same over "data" for a batch split over it. With an extent of 1
each returns its input and runs no collective, so a (n, 1) mesh runs the
meshless model's ops.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional, Tuple

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


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank of ``group``'s ``x`` (one shape) concatenated along
    ``dim`` in the group's rank order: one all-gather."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_segments(v: torch.Tensor, mesh) -> torch.Tensor:
    """Every segment's ``v`` (the same shape on each rank) concatenated
    along dim 0 in segment order: one all-gather over the flat group."""
    return all_gather_cat(v, 0, flat_group(mesh))


def gather_members(v: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's ``v`` (one member slice each, the same shape)
    concatenated along dim 0 in data order: one all-gather over this
    rank's "data" group."""
    return all_gather_cat(v, 0, mesh.get_group(FLAT_AXIS))


# ---------------------------------------------------------------------------
# The tensor-parallel collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on a mesh's "model" axis (``size`` ranks in
    ``group``, this one ``rank``) and "data" axis (``data_size`` ranks in
    ``data_group``, this one ``data_rank``); a group is None where its
    extent is 1."""

    size: int = 1
    rank: int = 0
    group: Any = None
    data_size: int = 1
    data_rank: int = 0
    data_group: Any = None


def tensor_parallel(mesh) -> TensorParallel:
    """The ``TensorParallel`` of this rank on ``mesh`` (a ("data",
    "model") mesh of ``launch.mesh``; None: one device)."""
    if mesh is None:
        return TensorParallel()
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    at = dict(zip(mesh.mesh_dim_names, coord))
    ext = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    m, d = ext.get(FLAT_MODEL_AXIS, 1), ext.get(FLAT_AXIS, 1)
    return TensorParallel(
        size=m, rank=int(at.get(FLAT_MODEL_AXIS, 0)),
        group=mesh.get_group(FLAT_MODEL_AXIS) if m > 1 else None,
        data_size=d, data_rank=int(at.get(FLAT_AXIS, 0)),
        data_group=mesh.get_group(FLAT_AXIS) if d > 1 else None)


def _sum(x: torch.Tensor, group, op=None) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return out


def _slice(x: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    """Identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """The sum over the group; the backward is the identity."""

    @staticmethod
    def forward(x, group):
        return _sum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """The group's pieces concatenated along ``dim`` in rank order; the
    backward is this rank's slice."""

    @staticmethod
    def forward(x, dim, group, size, rank):
        return all_gather_cat(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, _, ctx.size, ctx.rank = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.size, ctx.rank), None, None, None, None


class _SplitTo(torch.autograd.Function):
    """This rank's slice along ``dim``; the backward gathers the group's
    slices."""

    @staticmethod
    def forward(x, dim, group, size, rank):
        return _slice(x, dim, size, rank)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None, None, None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """A replicated tensor entering computation split over "model": the
    identity, whose backward sums the ranks' partial gradients."""
    return x if tp.size == 1 else _CopyTo.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over "model" of the ranks' partial results (a row-parallel
    product); the backward is the identity."""
    return x if tp.size == 1 else _ReduceFrom.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, dim: int,
                      tp: TensorParallel) -> torch.Tensor:
    """The "model" ranks' pieces of a tensor concatenated along ``dim``;
    the backward takes this rank's slice (the computation after it is
    replicated)."""
    if tp.size == 1:
        return x
    return _GatherFrom.apply(x, dim, tp.group, tp.size, tp.rank)


def split_to_model(x: torch.Tensor, dim: int,
                   tp: TensorParallel) -> torch.Tensor:
    """This rank's slice along ``dim`` of a replicated tensor; the
    backward gathers the slices' gradients."""
    if tp.size == 1:
        return x
    return _SplitTo.apply(x, dim, tp.group, tp.size, tp.rank)


def all_reduce_model(x: torch.Tensor, tp: TensorParallel,
                     op: str = "sum") -> torch.Tensor:
    """The sum or max of ``x`` over "model", carrying no gradient."""
    if tp.size == 1:
        return x
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    return _sum(x.detach(), tp.group, ops[op])


def copy_to_data(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``copy_to_model`` over "data": a parameter read by a batch split
    over "data", whose gradient then sums the ranks' parts."""
    return x if tp.data_size == 1 else _CopyTo.apply(x, tp.data_group)


def reduce_from_data(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``reduce_from_model`` over "data"."""
    return x if tp.data_size == 1 else _ReduceFrom.apply(x, tp.data_group)


def all_reduce_data(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum of ``x`` over "data", carrying no gradient."""
    if tp.data_size == 1:
        return x
    return _sum(x.detach(), tp.data_group)
