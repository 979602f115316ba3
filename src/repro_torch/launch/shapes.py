"""The assigned input shapes and their abstract inputs.

The port of ``repro/launch/shapes.py``. The four assigned shapes:

    train_4k     seq=4096    global_batch=256   -> the QAFeL round
    prefill_32k  seq=32768   global_batch=32    -> prefill
    decode_32k   seq=32768   global_batch=128   -> decode_step (full cache)
    long_500k    seq=524288  global_batch=1     -> decode_step

long_500k's policy, as the reference's: the state-space models run
natively (their recurrent cache does not grow), and every attention layer
of the other architectures (zamba2's shared block and gemma2's global
layers among them) runs with a sliding window of ``LONG_WINDOW``, its KV
cache a ring buffer.

``input_specs`` returns the inputs of the program that matches the
shape's kind with the reference's keys; every tensor is on
``torch.device("meta")``, so nothing is allocated. Where the reference
has a ``jax.ShapeDtypeStruct``, the port has a ``meta`` tensor of the
same shape, ``jnp.int32`` / ``jnp.float32`` as ``torch.int32`` /
``torch.float32``. One type differs: the round's key, which the
reference takes as ``(2,) uint32`` key data, is a ``(2,) int64`` tensor
of the two uint32 words in the port (``common.prng.PRNGKey``, which
``distributed.steps.make_qafel_round``'s round takes), so ``key_data``
is that.

List and reckon the shapes on the CPU without memory, e.g.::

    from repro_torch import configs
    from repro_torch.launch.shapes import SHAPES, input_specs
    spec = input_specs(configs.get_config("gemma2-2b"), "decode_32k")
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.qafel import QAFeLConfig
from repro_torch.distributed.steps import abstract_round_state
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

LONG_WINDOW = 8192  # sliding window for long_500k on attention layers
_META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# the round's decomposition for train shapes: global_batch = K * P * local
TRAIN_K = 8  # buffered clients per round
TRAIN_P = 1  # local SGD steps per client


def window_override_for(cfg: ModelConfig,
                        shape: ShapeSpec) -> Optional[int]:
    """The sliding-window policy: only long_500k forces a window, and not
    on an attention-free model."""
    if shape.name != "long_500k":
        return None
    if cfg.family == "ssm":
        return None
    return LONG_WINDOW


def uses_window(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    return window_override_for(cfg, shape) is not None and cfg.family != "ssm"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def _token_inputs(cfg: ModelConfig, lead: Tuple[int, ...], seq: int,
                  with_labels: bool, decode: bool = False) -> Dict[str, Any]:
    """The abstract input dict of the arch's contract, leading dims
    ``lead``. ``decode``: one new token and no modality prefix (a VLM's
    patch embeddings exist only in the prefill prompt)."""
    out: Dict[str, Any] = {}
    if cfg.modality == "audio":
        out["tokens"] = _meta(lead + (seq, cfg.audio_codebooks), torch.int32)
        if with_labels:
            out["labels"] = _meta(lead + (seq, cfg.audio_codebooks),
                                  torch.int32)
    elif cfg.modality == "vlm" and decode:
        out["tokens"] = _meta(lead + (seq,), torch.int32)
    elif cfg.modality == "vlm":
        s_text = seq - cfg.n_prefix_embeddings
        out["tokens"] = _meta(lead + (s_text,), torch.int32)
        out["patch_embeddings"] = _meta(
            lead + (cfg.n_prefix_embeddings, cfg.d_model), torch.float32)
        if with_labels:
            out["labels"] = _meta(lead + (s_text,), torch.int32)
    else:
        out["tokens"] = _meta(lead + (seq,), torch.int32)
        if with_labels:
            out["labels"] = _meta(lead + (seq,), torch.int32)
    return out


def input_specs(cfg: ModelConfig, shape_name: str,
                qcfg: Optional[QAFeLConfig] = None) -> Dict[str, Any]:
    """Abstract (``meta``, no allocation) inputs for (arch, shape), keyed
    by kind:

      train:   state, batch (K, P, local, ...), weights (K,), key_data
      prefill: params, inputs (B, S, ...), max_len
      decode:  params, cache, inputs (B, 1, ...), pos

    and ``kind`` and ``window_override`` in each."""
    shape = SHAPES[shape_name]
    wo = window_override_for(cfg, shape)
    if shape.kind == "train":
        k = qcfg.buffer_size if qcfg else TRAIN_K
        p = qcfg.local_steps if qcfg else TRAIN_P
        local = shape.global_batch // (k * p)
        if local < 1:
            raise ValueError(f"global batch {shape.global_batch} under "
                             f"K * P = {k * p}")
        return {
            "kind": "train",
            "state": abstract_round_state(cfg),
            "batch": _token_inputs(cfg, (k, p, local), shape.seq,
                                   with_labels=True),
            "weights": _meta((k,), torch.float32),
            "key_data": _meta((2,), torch.int64),
            "window_override": wo,
        }
    if shape.kind == "prefill":
        return {
            "kind": "prefill",
            "params": T.abstract_params(cfg),
            "inputs": _token_inputs(cfg, (shape.global_batch,), shape.seq,
                                    with_labels=False),
            "max_len": shape.seq,
            "window_override": wo,
        }
    # decode: one new token against a seq-length cache
    return {
        "kind": "decode",
        "params": T.abstract_params(cfg),
        "cache": T.abstract_cache(cfg, shape.global_batch, shape.seq, wo),
        "inputs": _token_inputs(cfg, (shape.global_batch,), 1,
                                with_labels=False, decode=True),
        "pos": _meta((), torch.int32),
        "window_override": wo,
    }
