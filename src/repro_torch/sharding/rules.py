"""Sharding rules: the parameter, state, batch and cache specs of a mesh,
and the flat substrate's segment layout over it.

Counterpart of ``repro/sharding/rules.py``. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``
among ``("data",)``, ``("data", "model")`` and ``("pod", "data",
"model")`` (``launch.mesh``), or None for one device; the spec functions
take any object with ``mesh_dim_names`` and ``shape`` (a tuple of
extents, or a mapping from names), so the production meshes can be
reckoned without their ranks.

**The specs** (``ShardingRules``, ``param_pspecs``, ``state_pspecs``,
``batch_pspecs``, ``cache_pspecs``): Megatron-style tensor parallelism on
"model", optional FSDP on "data", expert parallelism on "data", entry for
entry the reference's ``PartitionSpec``s. A spec is a tuple with one entry
per dim: None, an axis name, or a tuple of names (the dim sharded over
their product, major first). The rules: column-parallel projections
(``_COL_PARALLEL``) on their output dim, row-parallel ones
(``_ROW_PARALLEL``) on their input dim, routed experts (E, d, f) on
("pod", "data") and "model", the vocabulary of ``embed`` / ``head`` /
``audio_heads`` on "model", 1-D leaves replicated; with ``fsdp`` the
other dim of every large 2-D weight on "data"; a rule whose dim the axis
extent does not divide falls back to leaving it whole. ``to_shardings``
maps specs to ``torch.distributed.tensor`` placements, and
``sharded_bytes`` is the dry run's per-rank bytes of a tree under its
specs (``repro/launch/dryrun.py``).

**The flat segments.** The flat vectors x, x-hat and the momentum are cut
into contiguous segments of whole 128-element wire rows, one per rank of
the flat axes, enumerated data-major (``flat_segment_index``); each rank
holds its segment as a plain tensor. Rows are padded to a multiple of the
segment count (``flat_padded_len``), so every segment holds the same
number of rows, and the broadcast's counter-hash dither is keyed on the
global row (``flat_segment_index * local_rows``): the wire bits do not
depend on the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

FLAT_AXIS = "data"  # the axis flat segments (and cohort members) shard over
FLAT_MODEL_AXIS = "model"  # second flat axis: shards the vector, not members


def _extents(mesh) -> dict:
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in mesh.mesh_dim_names}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in shape)))


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


# ---------------------------------------------------------------------------
# The parameter, state, batch and cache specs
# ---------------------------------------------------------------------------

# leaf-name classes (matched against the last path component)
_COL_PARALLEL = {
    "wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wk_rope", "wk_b", "wv_b",
    "w_gate", "w_up", "in_proj", "conv_w", "router",
}
_ROW_PARALLEL = {"wo", "w_down", "out_proj"}

Spec = Tuple[Any, ...]


def _spec(entries) -> Spec:
    """A spec from its entries, a one-name tuple written as the name (as
    jax's ``PartitionSpec`` normalises it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """The rules of one mesh: ``fsdp`` also shards the other dim of every
    2-D weight of at least ``fsdp_min_size`` elements on "data";
    ``cache_seq_shard`` shards a KV cache whose head count "model" does not
    divide on its sequence dim instead of replicating it."""

    mesh: Any
    fsdp: bool = False
    fsdp_min_size: int = 1 << 20
    cache_seq_shard: bool = False

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The axes of batch and expert parallelism ("pod" when present)."""
        return tuple(a for a in self.axes if a in ("pod", "data"))

    def extent(self, axis) -> int:
        """The extent of an axis, or the product over a tuple of axes."""
        ext = _extents(self.mesh)
        if isinstance(axis, tuple):
            out = 1
            for a in axis:
                out *= ext[a]
            return out
        return ext[axis]

    def fits(self, dim: int, axis) -> bool:
        return dim % self.extent(axis) == 0


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict (keys sorted, as JAX walks
    it), a path being the tuple of keys from the root."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    return fn(path, tree)


def _param_spec(rules: ShardingRules, path: Tuple[str, ...], leaf) -> Spec:
    """One leaf's spec by its name (the last path key), its shape and
    whether it is stacked over the layers (the reference's
    ``_param_spec``)."""
    name = path[-1] if path else ""
    pstr = "/".join(path)
    shape = tuple(leaf.shape)
    stacked = ("layers/" in pstr or pstr.startswith("layers")
               or "prefix_layers" in pstr) and len(shape) >= 1
    core = shape[1:] if stacked else shape
    spec: list = [None] * len(core)

    def axis_ok(i, ax):
        return spec[i] is None and rules.fits(core[i], ax)

    m = FLAT_MODEL_AXIS
    if name == "embed":
        if len(core) == 3:  # audio: (CB, V, d)
            if axis_ok(1, m):
                spec[1] = m
        elif len(core) == 2 and axis_ok(0, m):
            spec[0] = m
    elif name == "head":
        if axis_ok(1, m):
            spec[1] = m
    elif name == "audio_heads":
        if axis_ok(2, m):
            spec[2] = m
    elif name in _COL_PARALLEL:
        if len(core) == 3:  # routed experts (E, d, f): expert parallel
            if axis_ok(0, rules.data_axes):
                spec[0] = rules.data_axes
            if axis_ok(2, m):
                spec[2] = m
        elif len(core) == 2:
            if axis_ok(1, m):
                spec[1] = m
            elif axis_ok(0, m):
                spec[0] = m
    elif name in _ROW_PARALLEL:
        if len(core) == 3:  # expert w_down (E, f, d)
            if axis_ok(0, rules.data_axes):
                spec[0] = rules.data_axes
            if axis_ok(1, m):
                spec[1] = m
        elif len(core) == 2 and axis_ok(0, m):
            spec[0] = m
    # FSDP: the remaining large dim on "data" (never on "pod", the
    # federation boundary, across which weights are replicated)
    size = 1
    for s in shape:
        size *= int(s)
    if rules.fsdp and len(core) >= 2 and size >= rules.fsdp_min_size:
        used = set()
        for entry in spec:
            if entry is not None:
                used.update(entry if isinstance(entry, tuple) else (entry,))
        if FLAT_AXIS in rules.axes and FLAT_AXIS not in used:
            for i in range(len(core)):
                if spec[i] is None and rules.fits(core[i], FLAT_AXIS):
                    spec[i] = FLAT_AXIS
                    break
    if stacked:
        spec = [None] + spec
    return _spec(spec)


def param_pspecs(rules: ShardingRules, cfg, params_tree) -> Any:
    """The spec tree of a parameter tree (``meta`` or concrete)."""
    del cfg
    return tree_map_with_path(lambda p, leaf: _param_spec(rules, p, leaf),
                              params_tree)


def state_pspecs(rules: ShardingRules, cfg, state) -> Any:
    """The round state's specs: x, x-hat and m take the parameters' specs
    (``state`` a ``distributed.steps.RoundState`` or a dict of trees);
    scalars (the step ``t``) are replicated, ``()``."""
    def spec(path, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return ()
        return _param_spec(rules, path, leaf)

    if dataclasses.is_dataclass(state):
        from repro_torch.distributed.steps import RoundState
        trees = {name: getattr(state, name)
                 for name in ("x", "hidden", "momentum")}
        out = tree_map_with_path(spec, trees)
        return RoundState(**out, t=())
    del cfg
    return tree_map_with_path(spec, state)


def batch_pspecs(rules: ShardingRules, batch_tree, *,
                 batch_dim: int = 0) -> Any:
    """The batch dim on ("pod", "data") where their product divides it,
    else on "data" where that divides it, else replicated."""
    axes = rules.data_axes

    def spec(path, leaf):
        del path
        if leaf.dim() <= batch_dim:
            return ()
        dim = leaf.shape[batch_dim]
        use: Optional[Tuple[str, ...]] = None
        if rules.fits(dim, axes):
            use = axes
        elif FLAT_AXIS in axes and rules.fits(dim, (FLAT_AXIS,)):
            use = (FLAT_AXIS,)
        out: list = [None] * leaf.dim()
        if use:
            out[batch_dim] = use
        return _spec(out)

    return tree_map_with_path(spec, batch_tree)


def cache_pspecs(rules: ShardingRules, cfg, cache_tree) -> Any:
    """The serving caches' specs, stacked (L, B, W, ...): the batch on
    "data" where it divides, else (long_500k's B = 1) the window of
    ``k`` / ``v`` / ``ckv`` / ``k_rope`` / ``conv`` on "data"; KV heads,
    SSM heads and conv channels on "model" where they divide, and with
    ``cache_seq_shard`` an undivided KV cache's window on "model";
    ``slot_pos`` replicated."""
    del cfg

    def spec(path, leaf):
        name = path[-1] if path else ""
        shape = tuple(leaf.shape)
        out: list = [None] * len(shape)
        if name == "slot_pos":
            return tuple(out)
        b_dim, w_dim = 1, 2
        if rules.fits(shape[b_dim], (FLAT_AXIS,)):
            out[b_dim] = FLAT_AXIS
        elif (name in ("k", "v", "ckv", "k_rope", "conv")
              and rules.fits(shape[w_dim], (FLAT_AXIS,))):
            out[w_dim] = FLAT_AXIS
        m = (FLAT_MODEL_AXIS,)
        if name in ("k", "v", "ckv", "k_rope"):
            if rules.fits(shape[3], m):
                out[3] = FLAT_MODEL_AXIS
            elif (rules.cache_seq_shard and out[w_dim] is None
                  and rules.fits(shape[w_dim], m)):
                out[w_dim] = FLAT_MODEL_AXIS
        elif name == "ssm" and rules.fits(shape[2], m):
            out[2] = FLAT_MODEL_AXIS
        elif name == "conv" and rules.fits(shape[3], m):
            out[3] = FLAT_MODEL_AXIS
        return _spec(out)

    return tree_map_with_path(spec, cache_tree)


def spec_leaves(tree) -> list:
    """A spec tree's specs in JAX's leaf order (a spec is a tuple)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [s for name in ("hidden", "momentum", "t", "x")
                for s in spec_leaves(getattr(tree, name))]
    return [tree]


def _tensor_leaves(tree) -> list:
    """A tree's leaves in ``spec_leaves``' order; a round state's step
    ``t`` counts as the reference's int32 scalar."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _tensor_leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        step = torch.empty((), dtype=torch.int32, device="meta")
        return [s for name in ("hidden", "momentum", "t", "x")
                for s in (_tensor_leaves(getattr(tree, name)) if name != "t"
                          else [step])]
    return [tree]


def spec_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry (none for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: Spec) -> tuple:
    """A spec as ``torch.distributed.tensor`` placements, one per mesh
    dim: ``Shard(i)`` where the dim's axis shards tensor dim i, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec) if name in spec_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def to_shardings(rules: ShardingRules, pspec_tree) -> Any:
    """A spec tree as a tree of placement tuples on ``rules.mesh``
    (``placements``), for ``torch.distributed.tensor.distribute_tensor``
    on a ``DeviceMesh``."""
    if isinstance(pspec_tree, dict):
        return {k: to_shardings(rules, v) for k, v in pspec_tree.items()}
    if dataclasses.is_dataclass(pspec_tree):
        from repro_torch.distributed.steps import RoundState
        return RoundState(**{n: to_shardings(rules, getattr(pspec_tree, n))
                             for n in ("x", "hidden", "momentum")},
                          t=placements(rules.mesh, ()))
    return placements(rules.mesh, pspec_tree)


def shard_extent(mesh, spec: Spec) -> int:
    """How many pieces a spec cuts a tensor into on ``mesh``."""
    ext = _extents(mesh)
    out = 1
    for e in spec:
        for a in spec_axes(e):
            out *= ext[a]
    return out


def sharded_bytes(abstract_tree, pspec_tree, mesh) -> int:
    """The per-rank bytes of a tree under its specs, each leaf's bytes
    floor-divided by its shard count (the reference dry run's
    ``sharded_bytes``)."""
    total = 0
    for leaf, spec in zip(_tensor_leaves(abstract_tree),
                          spec_leaves(pspec_tree)):
        total += (leaf.numel() * leaf.element_size()
                  // max(shard_extent(mesh, spec), 1))
    return total
