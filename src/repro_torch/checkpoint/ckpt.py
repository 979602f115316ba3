"""Checkpoints: msgpack-framed snapshots of a tree of tensors.

Counterpart of ``repro/checkpoint/ckpt.py``, in its layout, so that each
package opens the other's archives: ``<dir>/step_<n:08d>/state.msgpack``
(written to ``state.msgpack.tmp``, then renamed) holding ``{"leaves":
[{"dtype", "shape", "data"}, ...], "treedef": str}``, each leaf's raw
little-endian bytes with its dtype's numpy name (bf16 as
``"bfloat16"``), plus ``manifest.json`` with the step, the leaf count and
the caller's metadata. The leaves are in JAX's order (``common.tree``);
``"treedef"`` spells the tree as ``str`` of jax's ``PyTreeDef`` does for
nested dicts, and loading ignores it, as the reference does.

The msgpack bytes are ``msgpack.packb(payload, use_bin_type=True)``'s
(``checkpoint.mpack``), written leaf by leaf: each leaf is copied to the
host on its own and written from there, so a 5 GB state never becomes one
``bytes`` object.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import mpack
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_flatten, tree_unflatten

_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.float16: "float16", torch.bfloat16: "bfloat16",
              torch.int64: "int64", torch.int32: "int32",
              torch.int16: "int16", torch.int8: "int8",
              torch.uint8: "uint8", torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _NP_DTYPES.items()}


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A leaf's bytes as a host uint8 array (bf16 through its int16
    view)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy().reshape(-1).view(np.uint8)


def _pack_leaf(t: torch.Tensor) -> Dict[str, Any]:
    if t.dtype not in _NP_DTYPES:
        raise ValueError(f"no checkpoint dtype for {t.dtype}")
    nbytes = t.numel() * t.element_size()
    return {"dtype": _NP_DTYPES[t.dtype], "shape": list(t.shape),
            "data": mpack.Blob(nbytes, lambda write: write(
                memoryview(_host_bytes(t))))}


def _unpack_leaf(d: Dict[str, Any], device) -> torch.Tensor:
    name = d["dtype"]
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unknown checkpoint dtype {name!r}")
    dt = _TORCH_DTYPES[name]
    raw = torch.frombuffer(d["data"], dtype=torch.uint8) if len(
        d["data"]) else torch.empty(0, dtype=torch.uint8)
    host = (raw.view(torch.int16).view(dt) if dt == torch.bfloat16
            else raw.view(dt))
    return host.reshape(d["shape"]).to(device)


def treedef_str(treedef) -> str:
    """``str`` of jax's ``PyTreeDef`` for the tree ``treedef`` names
    (``common.tree``: nested dicts, keys sorted, leaves ``*``)."""
    def spell(spec):
        if spec is None:
            return "*"
        return "{" + ", ".join(f"{k!r}: {spell(sub)}" for k, sub in spec) \
            + "}"
    return f"PyTreeDef({spell(treedef)})"


def save_checkpoint(directory: str, step: int, state: Any,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write the tree ``state`` as step ``step`` under ``directory``;
    returns the step's directory."""
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    leaves, treedef = tree_flatten(state)
    payload = {"leaves": [_pack_leaf(x) for x in leaves],
               "treedef": treedef_str(treedef)}
    tmp = os.path.join(path, "state.msgpack.tmp")
    with open(tmp, "wb") as f:
        mpack.pack(payload, f.write)
    os.replace(tmp, os.path.join(path, "state.msgpack"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves),
                   **(metadata or {})}, f)
    return path


def load_checkpoint(directory: str, step: int, like: Any):
    """Restore step ``step`` into the structure of ``like`` (its leaf
    count and shapes are checked; the dtypes are the stored ones), each
    leaf on the device of ``like``'s leaf (a ``meta`` leaf: the card)."""
    path = os.path.join(directory, f"step_{step:08d}", "state.msgpack")
    with open(path, "rb") as f:
        payload = mpack.unpack(f)
    leaves_like, treedef = tree_flatten(like)
    stored = payload["leaves"]
    if len(stored) != len(leaves_like):
        raise ValueError(f"leaf count mismatch: {len(stored)} vs "
                         f"{len(leaves_like)}")
    leaves = []
    for ref, d in zip(leaves_like, stored):
        if tuple(d["shape"]) != tuple(ref.shape):
            raise ValueError(f"shape mismatch: {tuple(d['shape'])} vs "
                             f"{tuple(ref.shape)}")
        dev = resolve_device(None) if ref.is_meta else ref.device
        leaves.append(_unpack_leaf(d, dev))
    return tree_unflatten(treedef, leaves)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None
