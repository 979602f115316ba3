"""Metric taps: the names of the device-computed scalars the flush and the
client step emit with taps on, and their host-side named views.

Counterpart of ``repro/obs/taps.py``. The tap math itself lives in
``kernels.taps``, re-exported here under the reference's names: two
kernels (one launch per flush, one per client-step encode) whose sums of
squares run in XLA:CPU's order for ``jnp.sum`` (``kernels.ref.xla_sum``),
which depends on a vector's length alone, so a tap is the reference's,
the same on the card and on the CPU, in the sequential and in the cohort
engine, and whatever cohort a member was batched with. A
lowrank client step's three taps take the upload kernel twice. The
reference's ``decode_qsgd_stack`` has no counterpart: the upload kernel
decodes the wire codes itself, so the decoded stack never reaches memory.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.kernels.taps import flush_taps as flush_tap_vector
from repro_torch.kernels.taps import \
    lowrank_upload_taps as cohort_tap_rows_lowrank
from repro_torch.kernels.taps import upload_taps as cohort_tap_rows

__all__ = ["COHORT_TAP_NAMES", "COHORT_TAP_NAMES_LOWRANK", "FLUSH_TAP_NAMES",
           "POPULATION_STATE_NAMES", "cohort_tap_rows",
           "cohort_tap_rows_lowrank", "flush_tap_vector",
           "named_cohort_taps", "named_flush_taps",
           "named_population_counts"]

# Flush tap layout, in order. All norms are L2 over the TRUE-n flat vector.
FLUSH_TAP_NAMES = (
    "delta_norm",        # ||Delta-bar||: the aggregated buffer delta
    "update_norm",       # ||x_new - x_old||: the applied server update
    "bcast_diff_norm",   # ||x_new - x-hat||: the broadcast diff
    "bcast_qerr_rel",    # ||diff - qdq(diff)|| / ||diff|| (0 for identity)
    "hidden_step_norm",  # ||q||: the decoded broadcast increment
    "weight_sum",        # sum of the window's normalized staleness weights
    "weight_min",        # min of the window's normalized staleness weights
)

# Per-upload tap layout (one row per member of a client step).
COHORT_TAP_NAMES = (
    "delta_norm",       # ||delta_i||: the member's local-SGD delta
    "upload_qerr_rel",  # ||delta_i - qdq(delta_i)|| / ||delta_i||
)

# Low-rank uploads report one more column, the quantization error inside
# the sketch subspace (``cohort_tap_rows_lowrank``).
COHORT_TAP_NAMES_LOWRANK = (
    "delta_norm",         # ||c_i|| = ||delta_i + residual_i||
    "upload_qerr_rel",    # ||c_i - S^T qdq(S c_i)|| / ||c_i|| (full space)
    "subspace_qerr_rel",  # ||y_i - qdq(y_i)|| / ||y_i||, y = S c (d_r space)
)

# Lifecycle states of the population engine, in int8 code order; the
# population tap on eval events (counts per state) comes with that engine.
POPULATION_STATE_NAMES = ("idle", "working", "offline", "dropped")


def _values(values) -> list:
    """The values of a tensor (any device) or array as Python numbers."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values).reshape(-1).tolist()


def _named(names: Sequence[str], values) -> Dict[str, float]:
    vals = _values(values)
    if len(vals) != len(names):
        raise ValueError(f"expected {len(names)} tap values, got {len(vals)}")
    return {name: float(v) for name, v in zip(names, vals)}


def named_flush_taps(vec) -> Dict[str, float]:
    """Host-side named view of one flush tap vector."""
    return _named(FLUSH_TAP_NAMES, vec)


def named_cohort_taps(row) -> Dict[str, float]:
    """Host-side named view of one member's upload tap row. The row length
    says its layout (low-rank rows carry the extra subspace column)."""
    vals = _values(row)
    if len(vals) == len(COHORT_TAP_NAMES_LOWRANK):
        return _named(COHORT_TAP_NAMES_LOWRANK, vals)
    return _named(COHORT_TAP_NAMES, vals)


def named_population_counts(vec) -> Dict[str, int]:
    """Host-side named view of a (4,) per-state client count vector."""
    vals = _values(vec)
    if len(vals) != len(POPULATION_STATE_NAMES):
        raise ValueError(f"expected {len(POPULATION_STATE_NAMES)} state "
                         f"counts, got {len(vals)}")
    return {name: int(v) for name, v in zip(POPULATION_STATE_NAMES, vals)}
