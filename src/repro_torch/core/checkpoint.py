"""Checkpoint / resume of the async QAFeL protocol.

Counterpart of ``repro/core/checkpoint.py``, in the same format, so an
archive written by either package loads in the other. It holds everything
the server carries between uploads, so a run can stop after any upload —
mid-window included — and continue bit-identically:

* the flat ``ServerState``: x, x-hat and momentum as f32 vectors and the
  step ``t``; the ``TreeLayout`` is stored as its fingerprint (per-leaf
  shapes, dtypes and sizes) and verified on load;
* the ``UpdateBuffer``'s window: the packed uploads (uint8 codes and
  bucket norms, or sparse indices and values, ``buf_packed_a`` /
  ``buf_packed_b``; a lowrank window's rank, group and per-upload basis
  seeds, ``buf_seeds``), the staleness weights, and the flat identity and
  decoded-tier sums (``buf_flat_acc``, ``buf_acc``);
* the run's lowrank ``basis_seed`` and the clients' error-feedback
  residuals (``residual_cids``, ``residual_stack``);
* the ``TrafficMeter`` and ``StalenessMonitor``.

Format: one ``np.savez`` archive of plain arrays plus a JSON blob
(``__meta__``); nothing is pickled. The simulator's key and numpy streams
are not part of it: a resumed ``QAFeL`` fed the same messages continues
bit-identically.

The state vectors are stored at their true length n, whatever the mesh:
a run on a mesh (``QAFeL(mesh=)``) gathers its segments first, and only
the rank of the first flat segment writes (the others wait for it). The
``sharding`` entry records where the archive came from (the segment
count, the flat axes and their extents, n and the padded length), as the
reference's does; a load re-places the vectors for the target's mesh, so
an archive moves between any two meshes, and between either package. An
archive of another ``basis_seed`` is refused: the resumed run would
derive other sketch bases.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

CHECKPOINT_VERSION = 1


def _normalize_path(path) -> str:
    """``np.savez`` appends '.npz' to a path without it; save and load
    apply the same rule."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _layout_fingerprint(layout) -> dict:
    return {"shapes": [list(s) for s in layout.shapes],
            "dtypes": list(layout.dtypes),
            "sizes": [int(s) for s in layout.sizes]}


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_checkpoint(path, algo) -> None:
    """Write ``algo``'s server-side state (see the module docstring).
    Under a mesh every rank of it calls this: the gathers are
    collectives."""
    st, buf = algo.state, algo.buffer
    mesh = getattr(algo, "mesh", None)
    ndev, axes, mesh_shape = 1, None, None
    if mesh is not None:
        from repro_torch.sharding.rules import (flat_axes, mesh_extent_of,
                                                mesh_flat_extent)
        ndev = mesh_flat_extent(mesh)
        axes = list(flat_axes(mesh))
        mesh_shape = [mesh_extent_of(mesh, a) for a in axes]
    meta = {
        "version": CHECKPOINT_VERSION,
        "t": int(st.t),
        "layout": _layout_fingerprint(st.layout),
        "sharding": {"devices": ndev, "axes": axes, "mesh_shape": mesh_shape,
                     "n": int(st.n),
                     "n_padded": int(st.x_flat.shape[0]) * ndev},
        "quantizers": {"client": algo.cq.spec.label(),
                       "server": algo.sq.spec.label()},
        "basis_seed": int(algo.basis_seed),
        # ids may include null, the sequential engine's shared slot
        "residual_cids": [None if c is None else int(c)
                          for c in algo._residuals],
        "buffer": {
            "capacity": int(buf.capacity),
            "count": int(buf.count),
            "flushes": int(buf.flushes),
            "weightsum": float(buf._weightsum),
            "weights": [float(w) for w in buf._weights],
            "bits": None if buf._bits is None else int(buf._bits),
            "n": None if buf._n is None else int(buf._n),
            "n_packed": len(buf._packed),
            "rank": None if buf._rank is None else int(buf._rank),
            "group": None if buf._group is None else int(buf._group),
            "has_layout": buf._layout is not None,
            "has_acc": buf._acc is not None,
            "has_flat_acc": buf._flat_acc is not None,
        },
        "meter": dataclasses.asdict(algo.meter),
        "staleness": {"max_allowed": int(algo.staleness.max_allowed),
                      "history": list(algo.staleness.history),
                      "dropped": list(algo.staleness.dropped)},
    }
    arrays = {name: _host(st.full(name))
              for name in ("x_flat", "hidden_flat", "momentum_flat")}
    if buf._packed:
        arrays["buf_packed_a"] = np.stack([_host(a) for a, _ in buf._packed])
        arrays["buf_packed_b"] = np.stack([_host(b) for _, b in buf._packed])
    if buf._seeds:
        arrays["buf_seeds"] = np.stack(
            [_host(s) for s in buf._seeds]).astype(np.uint32)
    if buf._acc is not None:
        arrays["buf_acc"] = _host(buf._acc)
    if buf._flat_acc is not None:
        arrays["buf_flat_acc"] = _host(buf._flat_acc)
    if algo._residuals:
        arrays["residual_stack"] = np.stack(
            [_host(r) for r in algo._residuals.values()])
    group = None
    if mesh is not None:
        import torch.distributed as dist
        from repro_torch.launch.mesh import flat_group
        group = flat_group(mesh)
        if dist.get_rank(group) != 0:
            dist.barrier(group=group)
            return
    np.savez(_normalize_path(path), __meta__=np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8), **arrays)
    if group is not None:
        dist.barrier(group=group)


def _check_compatible(meta: dict, algo) -> None:
    """Raise unless the archive fits ``algo``, before any state changes."""
    if meta["version"] != CHECKPOINT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    layout = algo.state.layout
    if meta["layout"] != _layout_fingerprint(layout):
        raise ValueError(
            "checkpoint layout does not match the model: the archive was "
            "saved for a different parameter structure")
    smeta = meta.get("sharding")
    if smeta is not None and smeta["n"] != layout.total_size:
        raise ValueError(
            f"checkpoint flat layout n={smeta['n']} does not match the "
            f"model's coordinate count {layout.total_size}")
    want_q = {"client": algo.cq.spec.label(), "server": algo.sq.spec.label()}
    if meta["quantizers"] != want_q:
        raise ValueError(f"checkpoint quantizers {meta['quantizers']} != "
                         f"algo quantizers {want_q}")
    if meta.get("basis_seed", 0) != algo.basis_seed:
        raise ValueError(
            f"checkpoint basis_seed {meta.get('basis_seed', 0)} != algo "
            f"basis_seed {algo.basis_seed}: a resumed lowrank run would "
            "derive different sketch bases")
    bmeta = meta["buffer"]
    if bmeta["capacity"] != algo.buffer.capacity:
        raise ValueError(f"checkpoint buffer capacity {bmeta['capacity']} != "
                         f"algo capacity {algo.buffer.capacity}")


def load_checkpoint(path, algo):
    """Restore a ``save_checkpoint`` archive of either package into
    ``algo`` in place, on ``algo``'s device and mesh (the vectors
    re-placed as its segments). ``algo`` must be built from
    the same model and configuration: the layout fingerprint, quantizers,
    basis seed and buffer capacity are verified first, so a failed load
    leaves it intact. Returns ``algo``."""
    # avoids an import cycle
    from repro_torch.core.qafel import ServerState, place_flat_on_mesh

    with np.load(_normalize_path(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    _check_compatible(meta, algo)
    dev = algo.device

    def dev_tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    layout = algo.state.layout
    mesh = getattr(algo, "mesh", None)
    vecs = [dev_tensor(arrays[name]) for name in ("x_flat", "hidden_flat",
                                                   "momentum_flat")]
    if mesh is not None:
        vecs = [place_flat_on_mesh(v, mesh, layout.total_size)
                for v in vecs]
    algo.state = ServerState(*vecs, layout=layout, t=meta["t"], mesh=mesh)

    bmeta = meta["buffer"]
    buf = algo.buffer
    buf._acc = dev_tensor(arrays["buf_acc"]) if bmeta["has_acc"] else None
    buf._flat_acc = (dev_tensor(arrays["buf_flat_acc"])
                     if bmeta["has_flat_acc"] else None)
    if bmeta["n_packed"]:
        codes = dev_tensor(arrays["buf_packed_a"])
        norms = dev_tensor(arrays["buf_packed_b"])
        buf._packed = [(codes[i], norms[i]) for i in range(bmeta["n_packed"])]
    else:
        buf._packed = []
    buf._weights = list(bmeta["weights"])
    buf._weightsum = bmeta["weightsum"]
    buf._bits = bmeta["bits"]
    buf._n = bmeta["n"]
    buf._layout = layout if bmeta["has_layout"] else None
    buf.count = bmeta["count"]
    buf.flushes = bmeta["flushes"]
    buf._rank, buf._group = bmeta.get("rank"), bmeta.get("group")
    buf._seeds = ([torch.from_numpy(s.astype(np.int64))
                   for s in arrays["buf_seeds"]]
                  if "buf_seeds" in arrays else [])
    algo._residuals = {
        (None if c is None else int(c)):
            dev_tensor(arrays["residual_stack"][i])
        for i, c in enumerate(meta.get("residual_cids", []))}

    for field, value in meta["meter"].items():
        setattr(algo.meter, field, value)
    algo.staleness.max_allowed = meta["staleness"]["max_allowed"]
    algo.staleness.history = list(meta["staleness"]["history"])
    algo.staleness.dropped = list(meta["staleness"]["dropped"])
    return algo
